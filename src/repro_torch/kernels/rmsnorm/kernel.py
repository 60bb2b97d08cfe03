"""Wrappers of the RMSNorm kernel K8 (CUDA C++ in ``csrc/rmsnorm.cu``) and
of its backward K11 (``csrc/rmsnorm_backward.cu``).

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
K8 alone is forward-only: autograd reaches its variants through
``ops.rmsnorm`` / ``ops.add_rmsnorm`` / ``ops.gated_rmsnorm``.

``rmsnorm_backward(g, w, dy, dh=None)`` is K11: (dx, dw) of the plain
variant over g = x, or of the add variant over g = h with dh the gradient
of h (dx = dr).  On CUDA tensors it launches K11 (two kernels -- the rows
with their dw partials, then the partials' sum -- counted as one launch;
``variants`` counts "plain" and "add"), on CPU tensors it runs the
closed-form plain version.  ``rmsnorm_backward_gate(y, z, w, dout)`` is
its gate variant: (dy, dz, dw) of the gate variant's norm of
y * silu(z), y fp32 and z, dout in the row dtype (z at any row stride);
it counts in ``rmsnorm_backward.launches`` and, as "gate", in
``rmsnorm_backward.variants``.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .._guard import forbid_grad
from .ref import (add_rmsnorm_ref, gated_rmsnorm_backward_ref,
                  gated_rmsnorm_ref, rmsnorm_backward_ref, rmsnorm_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"plain": 0, "add": 1, "gate": 2}
# the kernel holds a row in registers: at most 512 threads of 4 16-byte
# vectors each
MAX_ROW_BYTES = 512 * 4 * 16


def rmsnorm_2d(x, w, *, eps: float = 1e-5, residual=None, gate=None):
    forbid_grad("K8 rmsnorm_2d" + (" (gate variant)" if gate is not None
                                   else ""), x, w, residual, gate,
                use="ops.rmsnorm, ops.add_rmsnorm and ops.gated_rmsnorm are "
                    "differentiable (K11)")
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


# the backward's dw partials: one row of D fp32 a CTA, BWD_CTAS CTAs of
# bwd_threads(D) threads for rows of D <= 2048 (two CTAs on each of an
# H100's 132 SMs), proportionally more for narrower rows; fixed by D, so
# the order of dw's sums -- and its bits -- do not depend on the card
BWD_CTAS = 264


def bwd_threads(d: int) -> int:
    """Threads of a K11 row CTA: 8 columns a thread, whole warps."""
    return -(-d // 256) * 32


def bwd_ctas(rows: int, d: int) -> int:
    """K11's row CTAs for ``rows`` rows of ``d``: one CTA a row at most."""
    return min(rows, BWD_CTAS * max(1, 256 // bwd_threads(d)))


def rmsnorm_backward(g, w, dy, *, eps: float = 1e-5, dh=None,
                     variant: str = None):
    """K11: (dx, dw) for rows g (R, D) -- x, or the add variant's h --
    with dy (and dh) the gradients of the norm's output (and of h), all of
    g's shape and dtype, last dim contiguous, any row stride.  ``variant``
    names the forward's variant for the launch count ("plain" or "add";
    default: "add" where dh is given -- an add whose h has no gradient
    passes none)."""
    forbid_grad("K11 rmsnorm_backward", g, w, dy, dh)
    if g.dim() != 2 or w.dim() != 1 or w.shape[0] != g.shape[1]:
        raise ValueError("rmsnorm_backward takes g (R, D) and w (D,)")
    for name, t in (("dy", dy), ("dh", dh)):
        if t is not None and (t.shape != g.shape or t.device != g.device
                              or t.dtype != g.dtype):
            raise ValueError(f"{name} must be g's shape and dtype, on its "
                             f"device")
    if w.device != g.device:
        raise ValueError("all operands must be on one device")
    if g.device.type != "cuda":
        return rmsnorm_backward_ref(g, w, dy, eps, dh=dh)
    if g.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError("the rmsnorm backward kernel takes float32 or "
                        "bfloat16 rows and weights")
    if any(t.stride(1) != 1 for t in (g, dy, dh) if t is not None) \
            or not w.is_contiguous():
        raise ValueError("the rmsnorm backward kernel needs a contiguous "
                         "last dim")
    r, d = g.shape
    if bwd_threads(d) > 1024:
        raise ValueError(f"rows of {d} values exceed what the rmsnorm "
                         f"backward kernel holds (8192)")
    dx = torch.empty((r, d), dtype=g.dtype, device=g.device)
    dw = torch.empty_like(w)
    if r == 0:
        return dx, dw.zero_()
    n = bwd_ctas(r, d)
    partial = torch.empty((n, d), dtype=torch.float32, device=g.device)
    rows = [t for t in (g, dy, dh, dx) if t is not None]
    vec = int(d % (16 // g.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) * t.element_size() % 16 == 0
        for t in rows))
    launch("tardis_rmsnorm_backward", ptr(g), g.stride(0), ptr(dy),
           dy.stride(0), ptr(dh), 0 if dh is None else dh.stride(0), ptr(w),
           ptr(dx), d, ptr(partial), ptr(dw), r, d, n, float(eps),
           _DTYPES[g.dtype], _DTYPES[w.dtype], vec)
    variant = variant or ("plain" if dh is None else "add")
    rmsnorm_backward.launches += 1
    rmsnorm_backward.variants[variant] = \
        rmsnorm_backward.variants.get(variant, 0) + 1
    return dx, dw


rmsnorm_backward.launches = 0
rmsnorm_backward.variants = {}    # launches per variant


def rmsnorm_backward_gate(y, z, w, dout, *, eps: float = 1e-5):
    """K11's gate variant: (dy, dz, dw) of ``rmsnorm_2d(y, w, gate=z)``
    for y (R, D) the scan's fp32 output, z and dout (R, D) in the row
    dtype (z at any row stride, last dim contiguous)."""
    forbid_grad("K11 rmsnorm_backward_gate", y, z, w, dout)
    if y.dim() != 2 or w.dim() != 1 or w.shape[0] != y.shape[1]:
        raise ValueError("rmsnorm_backward_gate takes y (R, D) and w (D,)")
    for name, t in (("z", z), ("dout", dout)):
        if t.shape != y.shape or t.device != y.device:
            raise ValueError(f"{name} must be y's shape, on its device")
    if dout.dtype != z.dtype or w.device != y.device:
        raise ValueError("dout must be in z's dtype, w on y's device")
    if y.device.type != "cuda":
        return gated_rmsnorm_backward_ref(y, z, w, dout, eps)
    if y.dtype != torch.float32:
        raise TypeError("the gate variant takes the scan's float32 output")
    if z.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError("the rmsnorm backward kernel takes float32 or "
                        "bfloat16 rows and weights")
    if any(t.stride(1) != 1 for t in (y, z, dout)) or not w.is_contiguous():
        raise ValueError("the rmsnorm backward kernel needs a contiguous "
                         "last dim")
    r, d = y.shape
    if bwd_threads(d) > 1024:
        raise ValueError(f"rows of {d} values exceed what the rmsnorm "
                         f"backward kernel holds (8192)")
    dy = torch.empty((r, d), dtype=torch.float32, device=y.device)
    dz = torch.empty((r, d), dtype=z.dtype, device=y.device)
    dw = torch.empty_like(w)
    if r == 0:
        return dy, dz, dw.zero_()
    n = bwd_ctas(r, d)
    partial = torch.empty((n, d), dtype=torch.float32, device=y.device)
    rows = (y, z, dout, dy, dz)
    vec = int(d % (16 // z.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) * t.element_size() % 16 == 0
        for t in rows))
    launch("tardis_rmsnorm_backward_gate", ptr(y), y.stride(0), ptr(z),
           z.stride(0), ptr(dout), dout.stride(0), ptr(w), ptr(dy), d,
           ptr(dz), d, ptr(partial), ptr(dw), r, d, n, float(eps),
           _DTYPES[z.dtype], _DTYPES[w.dtype], vec)
    rmsnorm_backward.launches += 1
    rmsnorm_backward.variants["gate"] = \
        rmsnorm_backward.variants.get("gate", 0) + 1
    return dy, dz, dw
