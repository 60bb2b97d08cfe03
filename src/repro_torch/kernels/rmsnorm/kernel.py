"""Wrapper of the RMSNorm kernel K8 (CUDA C++ in ``csrc/rmsnorm.cu``).

``rmsnorm_2d`` takes x (R, D) whose last dim is contiguous and whose rows
lie at any stride (the kernel takes the row stride; nothing is copied),
and w (D,).  The row and w may each be float32 or bfloat16.  One kernel,
three variants, by the keyword given:
  * plain: ``rmsnorm_2d(x, w)`` -> y;
  * add: ``rmsnorm_2d(x, w, residual=r)`` -> (h, y), h = x + r (r in x's
    dtype and shape) written out as the new residual stream;
  * gate: ``rmsnorm_2d(y, w, gate=z)`` -> the norm of y * silu(z) in z's
    dtype, y the SSD scan's float32 output (Mamba2's gated norm).
On CUDA tensors it launches K8 and counts the launch (``launches``, and
by variant in ``variants``); on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .ref import add_rmsnorm_ref, gated_rmsnorm_ref, rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"plain": 0, "add": 1, "gate": 2}
# the kernel holds a row in registers: at most 512 threads of 4 16-byte
# vectors each
MAX_ROW_BYTES = 512 * 4 * 16


def rmsnorm_2d(x, w, *, eps: float = 1e-5, residual=None, gate=None):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError("rmsnorm_2d takes x (R, D) and w (D,)")
    if residual is not None and gate is not None:
        raise ValueError("rmsnorm_2d takes a residual or a gate, not both")
    other = residual if residual is not None else gate
    variant = ("plain" if other is None else
               "add" if residual is not None else "gate")
    if other is not None and other.shape != x.shape:
        raise ValueError(f"the {variant} operand must be x's shape")
    if any(t.device != x.device for t in (w, other) if t is not None):
        raise ValueError("all operands must be on one device")
    if x.device.type != "cuda":
        if variant == "add":
            return add_rmsnorm_ref(x, residual, w, eps)
        if variant == "gate":
            return gated_rmsnorm_ref(x, gate, w, eps)
        return rmsnorm_ref(x, w, eps)
    row_dtype = gate.dtype if variant == "gate" else x.dtype
    if row_dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError("the rmsnorm kernel takes float32 or bfloat16 rows "
                        "and weights")
    if variant == "add" and residual.dtype != x.dtype:
        raise TypeError("the add variant takes x and r in one dtype")
    if variant == "gate" and x.dtype != torch.float32:
        raise TypeError("the gate variant takes the scan's float32 output")
    operands = [t for t in (x, other) if t is not None]
    if any(t.stride(1) != 1 for t in operands) or not w.is_contiguous():
        raise ValueError("the rmsnorm kernel needs a contiguous last dim")
    r, d = x.shape
    if -(-d * row_dtype.itemsize // 16) * 16 > MAX_ROW_BYTES:
        raise ValueError(f"rows of {d} values exceed what the rmsnorm kernel "
                         f"holds ({MAX_ROW_BYTES} bytes)")
    out = torch.empty((r, d), dtype=row_dtype, device=x.device)
    h = torch.empty_like(out) if variant == "add" else None
    outs = [t for t in (out, h) if t is not None]
    vec = int(all(t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size())
                  % 16 == 0 for t in operands + outs)
              and w.data_ptr() % 16 == 0)
    launch("tardis_rmsnorm", _MODES[variant], ptr(x), x.stride(0),
           ptr(other), 0 if other is None else other.stride(0), ptr(w),
           ptr(out), d, ptr(h), d, r, d, float(eps), _DTYPES[row_dtype],
           _DTYPES[w.dtype], vec)
    rmsnorm_2d.launches += 1
    rmsnorm_2d.variants[variant] = rmsnorm_2d.variants.get(variant, 0) + 1
    return (h, out) if variant == "add" else out


rmsnorm_2d.launches = 0
rmsnorm_2d.variants = {}    # launches per variant
