"""Wrappers of the causal GQA flash-prefill kernel K6 (CUDA C++ in
``csrc/flash_prefill.cu``) and of its backward K10 (``csrc/
flash_backward.cu``).

``flash_prefill`` takes q (B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh) where
the model keeps them: any batch / position / head strides with Dh
contiguous (k and v at equal strides), so a layer's slice of a cache is
read in place.  ``q_offset`` and ``kv_len`` are host ints, as in the TPU
kernel.  On CUDA tensors it launches K6 and counts the launch, and by
variant in ``flash_prefill.variants`` (:func:`pick_variant`: "tf32x3" for
an fp32 q up to Dh 128, "wgmma" for the bf16 pair where TMA maps the K/V
view, "simt" for the rest); on CPU tensors it runs the plain version.  The
kernel takes (q, k/v) in float32/float32, bfloat16/bfloat16 or
float32/bfloat16 and Dh <= 256 in multiples of 8 (:func:`takes`).

With ``return_lse=True`` it also returns each query row's log-sum-exp
of its live scaled scores, fp32 (B, H, Sq), +inf on a row with no live
key: K6 writes it from its running max and sum; the serving paths leave
it off (no write).

``flash_backward`` takes K6's operands, its output o, that LSE and the
output's gradient dout and returns (dq, dk, dv) in q's, k's and v's
dtypes, under the same contract (strides, ``causal``, ``q_offset``,
``kv_len``, the dtype pairs, Dh); on CUDA tensors it launches K10 (up to
four kernels -- D = rowsum(dO o), dq, dk/dv, the GQA partials' sum --
counted as one launch, and by variant in ``flash_backward.variants``:
"tf32x3" for an fp32 q, "bf16" for the bf16 pair), on CPU tensors it
runs the closed-form plain version (which needs no LSE).  K6 alone is
forward-only: autograd reaches it through ``ops.flash_attention``.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .._guard import forbid_grad
from .ref import (flash_attention_backward_ref, flash_attention_lse_ref,
                  flash_attention_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))
MAX_DH = 256
# K6's variants by their code in tardis_flash_prefill (flash_prefill.cu)
VARIANTS = {"simt": 0, "wgmma": 1, "tf32x3": 2}
MAX_TC_DH = 128          # the tensor-core variants' widest head dim


def takes(q_dtype, kv_dtype, dh: int) -> bool:
    """Whether the kernel takes this (q, k/v) dtype pair and head dim."""
    return (q_dtype, kv_dtype) in _PAIRS and 0 < dh <= MAX_DH and dh % 8 == 0


def _check(q, k, v):
    """The operands' shapes, dtypes and device; returns (Skv, Hkv)."""
    b, _sq, h, dh = q.shape
    if k.dim() != 4 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError("k and v must both be (B, Skv, Hkv, Dh)")
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if k.dtype != v.dtype:
        raise TypeError("k and v must share one dtype")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("all operands must be on one device")
    return skv, hkv


def _check_cuda(name, q, k, v):
    """What the kernels take on the card: the dtype pairs, Dh, strides."""
    dh = q.shape[3]
    if not takes(q.dtype, k.dtype, dh):
        raise TypeError(f"the {name} kernel takes (q, k/v) in "
                        f"float32/float32, bfloat16/bfloat16 or "
                        f"float32/bfloat16 and Dh <= {MAX_DH} in multiples "
                        f"of 8, not ({q.dtype}, {k.dtype}), Dh {dh}")
    if k.stride() != v.stride() or k.stride(3) != 1 or q.stride(3) != 1:
        raise ValueError(f"{name} needs k and v at equal strides and a "
                         f"contiguous head dim")


def pick_variant(q, k, v) -> str:
    """K6's variant for a call it takes: "tf32x3" for an fp32 q (over fp32
    or bf16 K/V) up to Dh 128, any view; "wgmma" for the bf16 pair where
    Dh is a multiple of 16 up to 128 and TMA maps the K/V view (its
    (batch, position, head) strides whole 16-byte units below 2^40 bytes,
    both bases 16-byte aligned); "simt" otherwise.  Decided on the host
    from dtypes, shapes and strides, so it holds for CPU tensors too."""
    dh = q.shape[3]
    if dh > MAX_TC_DH:
        return "simt"
    if q.dtype == torch.float32:
        return "tf32x3"
    tma = (k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
           and all(st % 8 == 0 and 0 <= st * 2 < 1 << 40
                   for st in k.stride()[:3]))
    return "wgmma" if dh % 16 == 0 and tma else "simt"


def flash_prefill(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  kv_len=None, scale: float = None, return_lse: bool = False):
    """Returns (B, Sq, H, Dh) in q's dtype; with ``return_lse`` (out,
    lse), lse fp32 (B, H, Sq)."""
    forbid_grad("K6 flash_prefill", q, k, v,
                use="ops.flash_attention is differentiable (K10)")
    b, sq, h, dh = q.shape
    skv, hkv = _check(q, k, v)
    if scale is None:
        scale = dh ** -0.5
    kv_len = skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        out = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len)
        if not return_lse:
            return out
        return out, flash_attention_lse_ref(q, k, causal=causal,
                                            q_offset=q_offset, kv_len=kv_len)
    _check_cuda("flash_prefill", q, k, v)
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    variant = pick_variant(q, k, v)
    launch("tardis_flash_prefill", ptr(q), ptr(k), ptr(v), ptr(out),
           ptr(lse), b, sq, hkv, h // hkv, dh, *q.stride()[:3],
           *k.stride()[:3], int(q_offset), max(0, min(kv_len, skv)),
           int(bool(causal)), float(scale), VARIANTS[variant],
           _DTYPES[q.dtype], _DTYPES[k.dtype])
    flash_prefill.launches += 1
    flash_prefill.variants[variant] = \
        flash_prefill.variants.get(variant, 0) + 1
    return (out, lse) if return_lse else out


flash_prefill.launches = 0
flash_prefill.variants = {}


def variant_of(q_dtype) -> str:
    """K10's variant, by q's dtype: "tf32x3" (an fp32 q, over fp32 or bf16
    K/V: every product as three TF32 products) or "bf16" (the bf16 pair:
    bf16 products)."""
    return "bf16" if q_dtype == torch.bfloat16 else "tf32x3"


def flash_backward(q, k, v, o, dout, *, lse=None, causal: bool = True,
                   q_offset: int = 0, kv_len=None, scale: float = None):
    """K10: (dq, dk, dv) of ``flash_prefill(q, k, v, ...)`` given its
    output ``o``, the gradient ``dout`` (both (B, Sq, H, Dh) in q's dtype)
    and, on the card, the forward's ``lse`` (fp32 (B, H, Sq), from
    ``flash_prefill(..., return_lse=True)``).  ``scale`` defaults to the
    forward's, Dh ** -0.5."""
    forbid_grad("K10 flash_backward", q, k, v, o, dout)
    b, sq, h, dh = q.shape
    skv, hkv = _check(q, k, v)
    for name, t in (("o", o), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.device != q.device:
            raise ValueError(f"{name} must be q's shape, on q's device")
    if lse is not None and (tuple(lse.shape) != (b, h, sq)
                            or lse.device != q.device):
        raise ValueError("lse must be (B, H, Sq), on q's device")
    if scale is None:
        scale = dh ** -0.5
    kv_len = skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        return flash_attention_backward_ref(
            q, k, v, o, dout, causal=causal, q_offset=q_offset,
            kv_len=kv_len, scale=scale)
    _check_cuda("flash_backward", q, k, v)
    if lse is None:
        raise ValueError("K10 reads the forward's LSE: pass lse= from "
                         "flash_prefill(..., return_lse=True)")
    g = h // hkv
    o = o.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    dq = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # the dk/dv partials of each query head, summed over a KV head's group
    # in head order by the last kernel (G = 1 writes dk / dv directly)
    ws = (torch.empty((2, b, skv, h, dh), dtype=torch.float32,
                      device=q.device) if g > 1 else None)
    launch("tardis_flash_backward", ptr(q), ptr(k), ptr(v), ptr(o),
           ptr(dout), ptr(lse), ptr(dq), ptr(dk), ptr(dv), ptr(delta),
           ptr(ws), b, sq, skv, hkv, g, dh, *q.stride()[:3], *k.stride()[:3],
           int(q_offset), max(0, min(kv_len, skv)), int(bool(causal)),
           float(scale), _DTYPES[q.dtype], _DTYPES[k.dtype])
    flash_backward.launches += 1
    variant = variant_of(q.dtype)
    flash_backward.variants[variant] = \
        flash_backward.variants.get(variant, 0) + 1
    return dq, dk, dv


flash_backward.launches = 0
flash_backward.variants = {}
