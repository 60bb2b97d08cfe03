"""GQA attention: blocked-flash prefill path + cached decode path.

The port of ``repro.models.attention``.  ``flash_attention`` is the plain
blocked online-softmax schedule (it was plain jnp in the JAX package, not
Pallas), ``reference_attention`` the naive masked oracle and small-shape
path.  ``decode_attention`` is single-token attention over a dense cache:
long caches with one scalar length route to the split-KV decode kernel K5
(``kernels/decode_attention/csrc/dense_decode.cu``) under the JAX
package's conditions, with "the tensors are on CUDA" in place of "the
backend is TPU"; everything else takes the reference.  ``attend`` (the
prefill step's attention) sends CUDA calls to the flash-prefill kernel K6
and keeps the JAX dispatch rule on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pad_to(x, mult, dim):
    s = x.shape[dim]
    pad = (-s) % mult
    if pad == 0:
        return x, 0
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), pad


def flash_attention(q, k, v, *, causal: bool, q_offset=0, window: int = 0,
                    block_q: int = 512, block_k: int = 1024, kv_len=None):
    """q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh).

    ``q_offset`` places query i at kv index ``q_offset + i``; ``kv_len``
    masks cache slots >= kv_len; ``window > 0`` keeps the last ``window``
    kv positions.  Peak memory is O(block_q x block_k) per head."""
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    scale = dh ** -0.5
    block_q = min(block_q, sq)
    block_k = min(block_k, skv)
    q, _ = _pad_to(q, block_q, 1)
    k, _ = _pad_to(k, block_k, 1)
    v, _ = _pad_to(v, block_k, 1)
    nq, nk = q.shape[1] // block_q, k.shape[1] // block_k
    dev = q.device
    limit = int(kv_len) if kv_len is not None else skv
    outs = []
    for iq in range(nq):
        qi = q[:, iq * block_q:(iq + 1) * block_q].reshape(
            b, block_q, hkv, g, dh).float()
        qpos = q_offset + iq * block_q + torch.arange(block_q, device=dev)
        m = torch.full((b, block_q, hkv, g), NEG_INF, device=dev)
        l = torch.zeros((b, block_q, hkv, g), device=dev)
        acc = torch.zeros((b, block_q, hkv, g, dh), device=dev)
        for ik in range(nk):
            kj = k[:, ik * block_k:(ik + 1) * block_k].float()
            vj = v[:, ik * block_k:(ik + 1) * block_k].float()
            kpos = ik * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgd,btkd->bqkgt", qi, kj) * scale
            mask = (kpos[None, :] < limit).expand(block_q, block_k)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & (kpos[None, :] > (qpos[:, None] - window))
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgt,btkd->bqkgd", p, vj)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(b, nq * block_q, h, dh)
    return out[:, :sq].to(q.dtype)


def reference_attention(q, k, v, *, causal: bool, q_offset=0,
                        window: int = 0, kv_len=None):
    """Naive masked attention.  ``kv_len`` is a scalar or a per-request
    (B,) vector (continuous batching)."""
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqkgd,btkd->bqkgt", qg.float(), k.float()) * dh ** -0.5
    qpos = q_offset + torch.arange(sq, device=dev)
    kpos = torch.arange(skv, device=dev)
    mask = torch.ones((1, sq, skv), dtype=torch.bool, device=dev)
    if kv_len is not None:
        lim = torch.as_tensor(kv_len, dtype=torch.int32,
                              device=dev).reshape(-1, 1, 1)
        mask = mask & (kpos[None, None, :] < lim)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])[None]
    if window:
        mask = mask & (kpos[None, :] > (qpos[:, None] - window))[None]
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgt,btkd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


# Eligible GQA decode shapes (long caches, one scalar length) go through
# K5; the reference einsum stays the path for small caches, where one
# fused product beats a kernel launch and the CPU tests keep its bits.
DECODE_KERNEL_MIN_T = 2048


def _kernel_eligible(q, k_cache, cur_len, min_t: int) -> bool:
    _b, sq, h, _dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    if sq != 1 or h % hkv or t < min_t:
        return False
    if torch.as_tensor(cur_len).dim() != 0:   # per-request: paged path only
        return False
    if t % min(512, t):                # the TPU kernel's block tiles the cache
        return False
    return q.is_cuda and k_cache.is_cuda


def decode_attention(q, k_cache, v_cache, cur_len, *, use_kernel=None,
                     min_t: int = DECODE_KERNEL_MIN_T):
    """Single-token attention over a dense cache: q (B, 1, H, Dh), caches
    (B, T, Hkv, Dh), ``cur_len`` valid slots (scalar or (B,)).

    ``use_kernel=None`` routes eligible shapes to K5; True forces the
    kernel's wrapper (its plain version on CPU tensors); False forces the
    reference."""
    if use_kernel is None:
        use_kernel = _kernel_eligible(q, k_cache, cur_len, min_t)
    if use_kernel:
        from ..kernels.decode_attention.ops import \
            decode_attention as decode_kernel
        return decode_kernel(q, k_cache, v_cache, cur_len)
    return reference_attention(q, k_cache, v_cache, causal=False,
                               kv_len=cur_len)


def _flash_kernel_eligible(q, k, window: int) -> bool:
    """K6 takes the call: no window (the TPU kernel has none), whole GQA
    groups, a (q, k/v) dtype pair and head dim it takes, and CUDA tensors
    (the JAX rule's "the backend is a TPU")."""
    from ..kernels.flash_attention.kernel import takes
    return (window == 0 and q.shape[2] % k.shape[2] == 0 and q.is_cuda
            and k.is_cuda and takes(q.dtype, k.dtype, q.shape[3]))


def attend(q, k, v, *, causal: bool, q_offset=0, window: int = 0,
           kv_len=None, flash_threshold: int = 1024):
    """Prefill attention.  Eligible CUDA calls (``_flash_kernel_eligible``)
    go to the flash-prefill kernel K6 (``kernels/flash_attention/csrc/
    flash_prefill.cu``) at any length; every other call follows the JAX
    package's dispatch rule: naive for short sequences, blocked flash
    otherwise."""
    if _flash_kernel_eligible(q, k, window):
        from ..kernels.flash_attention.ops import \
            flash_attention as flash_kernel
        return flash_kernel(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    if q.shape[1] * k.shape[1] <= flash_threshold ** 2:
        return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, kv_len=kv_len)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           window=window, kv_len=kv_len)
