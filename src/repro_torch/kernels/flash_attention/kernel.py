"""Wrapper of the causal GQA flash-prefill kernel K6 (CUDA C++ in
``csrc/flash_prefill.cu``).

``flash_prefill`` takes q (B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh) where
the model keeps them: any batch / position / head strides with Dh
contiguous (k and v at equal strides), so a layer's slice of a cache is
read in place.  ``q_offset`` and ``kv_len`` are host ints, as in the TPU
kernel.  On CUDA tensors it launches K6 and counts the launch; on CPU
tensors it runs the plain version.  The kernel takes (q, k/v) in
float32/float32, bfloat16/bfloat16 or float32/bfloat16 and Dh <= 256 in
multiples of 8 (:func:`takes`).
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))
MAX_DH = 256


def takes(q_dtype, kv_dtype, dh: int) -> bool:
    """Whether the kernel takes this (q, k/v) dtype pair and head dim."""
    return (q_dtype, kv_dtype) in _PAIRS and 0 < dh <= MAX_DH and dh % 8 == 0


def flash_prefill(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  kv_len=None, scale: float = None):
    """Returns (B, Sq, H, Dh) in q's dtype."""
    b, sq, h, dh = q.shape
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
    if scale is None:
        scale = dh ** -0.5
    kv_len = skv if kv_len is None else int(kv_len)
    if q.device.type != "cuda":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    if not takes(q.dtype, k.dtype, dh):
        raise TypeError(f"the flash_prefill kernel takes (q, k/v) in "
                        f"float32/float32, bfloat16/bfloat16 or "
                        f"float32/bfloat16 and Dh <= {MAX_DH} in multiples "
                        f"of 8, not ({q.dtype}, {k.dtype}), Dh {dh}")
    if k.stride() != v.stride() or k.stride(3) != 1 or q.stride(3) != 1:
        raise ValueError("flash_prefill needs k and v at equal strides and a "
                         "contiguous head dim")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    launch("tardis_flash_prefill", ptr(q), ptr(k), ptr(v), ptr(out), b, sq,
           hkv, h // hkv, dh, *q.stride()[:3], *k.stride()[:3],
           int(q_offset), max(0, min(kv_len, skv)), int(bool(causal)),
           float(scale), _DTYPES[q.dtype], _DTYPES[k.dtype])
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
