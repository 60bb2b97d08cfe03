"""Wrapper of K4 ``paged_decode`` (CUDA C++ in ``csrc/paged_decode.cu``).

``paged_decode`` takes the grouped layout of the TPU kernel
(``paged_decode_attention_grouped``): q (B, Hkv, G, Dh), cur_k/cur_v
(B, Hkv, Dh), pool_rows (n_blocks*chunk, token_row), page_rows (B, P)
int32, lengths (B,) int32, absolute ``k_off`` / ``v_off`` columns.  On
CUDA tensors it launches the kernel and counts the launch; on CPU tensors
it runs the plain gather-then-attend version.  The kernel takes q and the
pool in one dtype (float32 or bfloat16); the plain version also takes
them mixed.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .ref import paged_decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode(q, cur_k, cur_v, pool_rows, page_rows, lengths, *,
                 chunk: int, k_off: int, v_off: int, scale: float = None):
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
    if q.dtype != pool_rows.dtype:
        raise TypeError("the paged_decode kernel takes q and the pool in "
                        "one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode needs contiguous operands")
    out = torch.empty_like(q)
    launch("tardis_paged_decode", *(ptr(t) for t in tensors), b, hkv, g, dh,
           chunk, page_rows.shape[1], token_row, k_off, v_off, float(scale),
           _DTYPES[q.dtype], _DTYPES[pool_rows.dtype], ptr(out))
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
