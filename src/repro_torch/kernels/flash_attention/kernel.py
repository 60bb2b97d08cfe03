"""Wrappers of the causal GQA flash-prefill kernel K6 (CUDA C++ in
``csrc/flash_prefill.cu``) and of its backward K10 (``csrc/
flash_backward.cu``).

``flash_prefill`` takes q (B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh) where
the model keeps them: any batch / position / head strides with Dh
contiguous (k and v at equal strides), so a layer's slice of a cache is
read in place.  ``q_offset`` and ``kv_len`` are host ints, as in the TPU
kernel.  On CUDA tensors it launches K6 and counts the launch; on CPU
tensors it runs the plain version.  The kernel takes (q, k/v) in
float32/float32, bfloat16/bfloat16 or float32/bfloat16 and Dh <= 256 in
multiples of 8 (:func:`takes`).

``flash_backward`` takes K6's operands, its output o and the output's
gradient dout and returns (dq, dk, dv) in q's, k's and v's dtypes, under
the same contract (strides, ``causal``, ``q_offset``, ``kv_len``, the
dtype pairs, Dh); on CUDA tensors it launches K10 (two kernels, counted
as one launch), on CPU tensors it runs the closed-form plain version.
K6 alone is forward-only: autograd reaches it through
``ops.flash_attention``.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .._guard import forbid_grad
from .ref import flash_attention_backward_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))
MAX_DH = 256


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


def flash_prefill(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  kv_len=None, scale: float = None):
    """Returns (B, Sq, H, Dh) in q's dtype."""
    forbid_grad("K6 flash_prefill", q, k, v,
                use="ops.flash_attention is differentiable (K10)")
    b, sq, h, dh = q.shape
    skv, hkv = _check(q, k, v)
    if scale is None:
        scale = dh ** -0.5
    kv_len = skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    _check_cuda("flash_prefill", q, k, v)
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    launch("tardis_flash_prefill", ptr(q), ptr(k), ptr(v), ptr(out), b, sq,
           hkv, h // hkv, dh, *q.stride()[:3], *k.stride()[:3],
           int(q_offset), max(0, min(kv_len, skv)), int(bool(causal)),
           float(scale), _DTYPES[q.dtype], _DTYPES[k.dtype])
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_backward(q, k, v, o, dout, *, causal: bool = True,
                   q_offset: int = 0, kv_len=None, scale: float = None):
    """K10: (dq, dk, dv) of ``flash_prefill(q, k, v, ...)`` given its
    output ``o`` and the gradient ``dout`` (both (B, Sq, H, Dh) in q's
    dtype).  ``scale`` defaults to the forward's, Dh ** -0.5."""
    forbid_grad("K10 flash_backward", q, k, v, o, dout)
    b, sq, h, dh = q.shape
    skv, hkv = _check(q, k, v)
    for name, t in (("o", o), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.device != q.device:
            raise ValueError(f"{name} must be q's shape, on q's device")
    if scale is None:
        scale = dh ** -0.5
    kv_len = skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        return flash_attention_backward_ref(
            q, k, v, o, dout, causal=causal, q_offset=q_offset,
            kv_len=kv_len, scale=scale)
    _check_cuda("flash_backward", q, k, v)
    o = o.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    launch("tardis_flash_backward", ptr(q), ptr(k), ptr(v), ptr(o),
           ptr(dout), ptr(dq), ptr(dk), ptr(dv), ptr(lse), ptr(delta), b, sq,
           skv, hkv, h // hkv, dh, *q.stride()[:3], *k.stride()[:3],
           int(q_offset), max(0, min(kv_len, skv)), int(bool(causal)),
           float(scale), _DTYPES[q.dtype], _DTYPES[k.dtype])
    flash_backward.launches += 1
    return dq, dk, dv


flash_backward.launches = 0
