"""Wrappers of the decode-attention kernels (CUDA C++ in ``csrc/``).

K4 ``paged_decode`` (``csrc/paged_decode.cu``) takes the grouped layout of
the TPU kernel (``paged_decode_attention_grouped``): q (B, Hkv, G, Dh),
cur_k/cur_v (B, Hkv, Dh), pool_rows (n_blocks*chunk, token_row), page_rows
(B, P) int32, lengths (B,) int32, absolute ``k_off`` / ``v_off`` columns.
Its bf16 pair at Dh a multiple of 16 up to 128 runs the tensor-core
variant, split over the positions as K5 is (``paged_split``,
``paged_plan``); the others run the SIMT variant.

K5 ``dense_decode`` (``csrc/dense_decode.cu``) replaces
``decode_attention_grouped``: q (B, Hkv, G, Dh), one layer's dense caches
(B, T, Hkv, Dh) read where they lie (batch/token/head strides in whole
16-byte vectors, Dh contiguous), and ``kv_len`` one int32 on the device.

On CUDA tensors each wrapper launches its kernel and counts the launch; on
CPU tensors it runs the plain version.  K4 takes q and the pool in one
dtype (float32 or bfloat16) or a float32 q over a bfloat16 pool (what the
paged path makes from fp32 weights: the engine's pool is bf16), the last
on its SIMT variant; K5 also takes a float32 q over bfloat16 caches (what
the wave path makes from fp32 weights).  The plain versions take any mix.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr, sm_count
from .._guard import forbid_grad
from .ref import dense_decode_attention_ref, paged_decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K5: query heads per CTA at most; CTAs per SM the split aims at: the
# SIMT variant's 4 warps take 4 an SM at G = 1, 2 otherwise (registers);
# the tensor-core variant's 8 warps take ~3/4 of the SMs -- on the H100
# 16 pairs x 6 splits ran faster than x 8 or x 4 (clusters of a pair's
# CTAs are placed within one GPC); splits at most (a pair's CTAs are one
# cluster); positions one CTA's warps take in one round at least; the
# (q, cache) dtype pairs it takes
HEAD_CHUNK = 8
CTAS_PER_SM = {"mma": 0.75, 1: 4, "else": 2}
MAX_SPLIT = 8
MIN_SPLIT_POSITIONS = 32
# K4's tensor-core variant: warps a CTA, positions a warp stage holds,
# positions a CTA takes at the lengths' bound before the split grows,
# CTAs an SM holds (4 warps, <= 64 KB of shared memory each); its
# variants as the C entry point numbers them
PAGED_WARPS = 4
PAGED_STAGE = 16
PAGED_CTA_POSITIONS = 128
PAGED_CTAS_PER_SM = 3
_PAGED_VARIANTS = {"simt": 0, "mma": 1, "mma_plain": 2}
_DENSE_PAIRS = ((torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16))


def paged_decode(q, cur_k, cur_v, pool_rows, page_rows, lengths, *,
                 chunk: int, k_off: int, v_off: int, scale: float = None):
    forbid_grad("K4 paged_decode", q, cur_k, cur_v, pool_rows)
    b, hkv, g, dh = q.shape
    dev = q.device
    if scale is None:
        scale = dh ** -0.5
    for name, t in (("cur_k", cur_k), ("cur_v", cur_v)):
        if tuple(t.shape) != (b, hkv, dh) or t.dtype != pool_rows.dtype:
            raise ValueError(f"{name} must be (B, Hkv, Dh) in the pool dtype")
    if page_rows.dim() != 2 or page_rows.shape[0] != b \
            or page_rows.dtype != torch.int32:
        raise ValueError("page_rows must be (B, P) int32")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    if q.dtype not in _DTYPES or pool_rows.dtype not in _DTYPES:
        raise TypeError("paged_decode takes float32 or bfloat16 tensors")
    token_row = pool_rows.shape[1]
    if max(k_off, v_off) + hkv * dh > token_row or dh > 256:
        raise ValueError("K/V columns exceed the token row (or dh > 256)")
    tensors = (q, cur_k, cur_v, pool_rows, page_rows, lengths)
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if dev.type != "cuda":
        out = paged_decode_attention_ref(
            q.reshape(b, 1, hkv * g, dh), cur_k.reshape(b, 1, hkv, dh),
            cur_v.reshape(b, 1, hkv, dh), pool_rows, page_rows, lengths,
            chunk=chunk, k_off=k_off, v_off=v_off, hkv=hkv)
        return out.reshape(b, hkv, g, dh)
    if (q.dtype, pool_rows.dtype) == (torch.bfloat16, torch.float32):
        raise TypeError("the paged_decode kernel takes q and the pool in "
                        "one dtype, or a float32 q over a bfloat16 pool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode needs contiguous operands")
    p_max = page_rows.shape[1]
    variant = paged_variant(q.dtype, dh, pool_rows.data_ptr(), token_row,
                            k_off, v_off)
    n_split = 1 if variant == "simt" else paged_split(
        b * hkv * -(-g // HEAD_CHUNK), p_max * chunk, sm_count(dev))
    out = torch.empty_like(q)
    launch("tardis_paged_decode", *(ptr(t) for t in tensors), b, hkv, g, dh,
           chunk, p_max, token_row, k_off, v_off, float(scale),
           _DTYPES[q.dtype], _DTYPES[pool_rows.dtype], n_split,
           _PAGED_VARIANTS[variant], ptr(out))
    paged_decode.launches += 1
    counts = paged_decode.variants
    counts[variant] = counts.get(variant, 0) + 1
    return out


paged_decode.launches = 0
paged_decode.variants = {}    # launches per variant


def paged_variant(dtype, dh: int, pool_ptr: int, token_row: int, k_off: int,
                  v_off: int) -> str:
    """Which of K4's kernels takes a call: "mma" (the tensor-core variant
    with 16-byte asynchronous copies) for the bf16 pair at Dh a multiple
    of 16 up to 128 with the pool, the token row and the K / V columns
    16-byte aligned; "mma_plain" (the same with plain loads) where one of
    them is not; "simt" for a float32 q (over either pool) and any other
    Dh.  ``dtype`` is q's."""
    if dtype != torch.bfloat16 or dh % 16 or dh > 128:
        return "simt"
    aligned = pool_ptr % 16 == 0 and not (token_row % 8 or k_off % 8
                                          or v_off % 8)
    return "mma" if aligned else "mma_plain"


def paged_split(pairs: int, bound: int, n_sm: int) -> int:
    """K4's CTAs per (request, kv head, head chunk) pair, one thread-block
    cluster, from the lengths' bound ``bound`` = P * chunk (no host sync):
    enough that no CTA takes more than ``PAGED_CTA_POSITIONS`` positions
    at the bound, at most ``MAX_SPLIT`` and one wave of
    ``PAGED_CTAS_PER_SM`` an SM."""
    want = min(-(-bound // PAGED_CTA_POSITIONS), MAX_SPLIT,
               PAGED_CTAS_PER_SM * n_sm // max(pairs, 1))
    return max(1, want)


def paged_plan(length: int, bound: int, n_split: int):
    """The positions K4's tensor-core variant reads for a request of
    ``length`` under the bound P * chunk, as the kernel spreads them: for
    each CTA of the cluster, for each warp, the positions of its stages
    in order (``PAGED_STAGE`` a stage; stage ``it`` of warp ``w`` starts
    at ``lo + (it * PAGED_WARPS + w) * PAGED_STAGE``).  Each CTA takes
    ``ceil(n / n_split)`` of the n = min(length, bound) live positions."""
    n = max(0, min(length, bound))
    per = -(-n // n_split)
    plan = []
    for sp in range(n_split):
        lo = min(sp * per, n)
        hi = min(lo + per, n)
        n_it = -(-(hi - lo) // (PAGED_WARPS * PAGED_STAGE))
        plan.append([[pos for it in range(n_it) for pos in range(
            lo + (it * PAGED_WARPS + w) * PAGED_STAGE,
            lo + (it * PAGED_WARPS + w + 1) * PAGED_STAGE) if pos < hi]
            for w in range(PAGED_WARPS)])
    return plan


def dense_decode(q, k_cache, v_cache, kv_len, *, scale: float = None):
    """q (B, Hkv, G, Dh); k_cache, v_cache (B, T, Hkv, Dh) with equal
    strides; ``kv_len``: the valid slots, an int or a 0-d int32 tensor
    (on the card it stays there: the kernel reads it through a pointer).
    Returns (B, Hkv, G, Dh) in q's dtype."""
    forbid_grad("K5 dense_decode", q, k_cache, v_cache)
    b, hkv, g, dh = q.shape
    dev = q.device
    if scale is None:
        scale = dh ** -0.5
    if k_cache.dim() != 4 or tuple(k_cache.shape) != tuple(v_cache.shape) \
            or k_cache.shape[0] != b or k_cache.shape[2:] != (hkv, dh):
        raise ValueError("caches must both be (B, T, Hkv, Dh)")
    if k_cache.dtype != v_cache.dtype:
        raise TypeError("k_cache and v_cache must share one dtype")
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    if kv_len.dim() != 0:
        raise ValueError("dense_decode takes one scalar kv_len")
    if any(t.device != dev for t in (k_cache, v_cache)):
        raise ValueError("all operands must be on one device")
    t_max = k_cache.shape[1]
    if dev.type != "cuda":
        out = dense_decode_attention_ref(q.reshape(b, 1, hkv * g, dh),
                                         k_cache, v_cache, kv_len)
        return out.reshape(b, hkv, g, dh)
    if (q.dtype, k_cache.dtype) not in _DENSE_PAIRS:
        raise TypeError("the dense_decode kernel takes (q, caches) in "
                        "float32/float32, bfloat16/bfloat16 or "
                        "float32/bfloat16")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1:
        raise ValueError("dense_decode needs equal cache strides and a "
                         "contiguous head dim")
    vec = 16 // k_cache.element_size()    # elements in one 16-byte load
    if not q.is_contiguous() or dh > 256 or dh % vec \
            or any(s % vec for s in k_cache.stride()[:3]) \
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"dense_decode needs a contiguous q, dh <= 256, and "
                         f"dh and the cache strides in multiples of {vec} "
                         f"elements from 16-byte aligned caches")
    pairs = b * hkv * -(-g // HEAD_CHUNK)
    variant = _variant(q.dtype, k_cache.dtype, g, dh)
    n_split = dense_split(pairs, variant, t_max, sm_count(dev))
    out = torch.empty_like(q)
    sb, st, sh, _ = k_cache.stride()
    launch("tardis_dense_decode", ptr(q), ptr(k_cache), ptr(v_cache),
           ptr(kv_len), b, hkv, g, dh, t_max, n_split, sb, st, sh,
           float(scale), _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
           int(variant == "mma"), ptr(out))
    dense_decode.launches += 1
    return out


dense_decode.launches = 0


def _variant(q_dtype, kv_dtype, g: int, dh: int):
    """Which of K5's kernels takes the call (the kernel follows this
    choice), as ``CTAS_PER_SM`` keys it: "mma" for the bf16 pair at a Dh
    the tensor-core variant has an instance of (multiples of 16 up to
    128), else the SIMT variant's G."""
    if q_dtype == kv_dtype == torch.bfloat16 and dh % 16 == 0 and dh <= 128:
        return "mma"
    return g


def dense_split(pairs: int, variant, t_max: int, n_sm: int) -> int:
    """K5's splits per (b, kv head, head chunk) pair, the CTAs of one
    thread-block cluster: as many as one wave of the variant's
    ``CTAS_PER_SM`` an SM holds (no second wave), at most ``MAX_SPLIT``
    (the portable cluster size) and no more than a T-slot cache has
    rounds of ``MIN_SPLIT_POSITIONS`` positions.  The kernel spreads the
    live positions (< kv_len, on the device) over them."""
    per_sm = CTAS_PER_SM.get(variant, CTAS_PER_SM["else"])
    want = min(int(per_sm * n_sm) // pairs, MAX_SPLIT)
    return max(1, min(want, -(-t_max // MIN_SPLIT_POSITIONS)))
