"""Wrapper of the RMSNorm kernel K8 (CUDA C++ in ``csrc/rmsnorm.cu``).

``rmsnorm_2d`` takes x (R, D) whose last dim is contiguous and whose rows
lie at any stride (the kernel takes the row stride; nothing is copied),
and w (D,).  x and w may each be float32 or bfloat16.  On CUDA tensors it
launches K8 and counts the launch; on CPU tensors it runs the plain
version.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_2d(x, w, *, eps: float = 1e-5):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError("rmsnorm_2d takes x (R, D) and w (D,)")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if x.device.type != "cuda":
        return rmsnorm_ref(x, w, eps)
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError("the rmsnorm kernel takes float32 or bfloat16 x and w")
    if x.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("the rmsnorm kernel needs a contiguous last dim")
    r, d = x.shape
    out = torch.empty((r, d), dtype=x.dtype, device=x.device)
    size = x.element_size()
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
              and (x.stride(0) * size) % 16 == 0 and (d * size) % 16 == 0)
    launch("tardis_rmsnorm", ptr(x), ptr(w), ptr(out), r, d, x.stride(0), d,
           float(eps), _DTYPES[x.dtype], _DTYPES[w.dtype], vec)
    rmsnorm_2d.launches += 1
    return out


rmsnorm_2d.launches = 0
