"""Public wrappers: RMSNorm over the last dim with any leading dims (the
JAX ``ops.py`` contract), and its two fused forms."""
from __future__ import annotations

from .kernel import rmsnorm_2d
from .ref import add_rmsnorm_ref, gated_rmsnorm_ref, rmsnorm_ref

__all__ = ["rmsnorm", "add_rmsnorm", "gated_rmsnorm", "rmsnorm_ref",
           "add_rmsnorm_ref", "gated_rmsnorm_ref"]


def _rows(t):
    """t (..., D) as (R, D) rows: a view where the leading dims fold (the
    kernel reads the rows at their stride), else a copy."""
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def rmsnorm(x, w, eps: float = 1e-5):
    """x (..., D); w (D,)."""
    return rmsnorm_2d(_rows(x), w, eps=eps).reshape(x.shape)


def add_rmsnorm(x, r, w, eps: float = 1e-5):
    """(h, rmsnorm(h) * w) with h = x + r, both of x's shape: the residual
    add and the next norm in one launch."""
    h, y = rmsnorm_2d(_rows(x), w, eps=eps, residual=_rows(r))
    return h.reshape(x.shape), y.reshape(x.shape)


def gated_rmsnorm(y, z, w, eps: float = 1e-5):
    """rmsnorm(y * silu(z)) * w in z's dtype, rounded as Mamba2's block
    rounds it: y (..., D) the scan's float32 output, z (..., D) the gate
    (any row stride, e.g. a column slice of the input projection)."""
    return rmsnorm_2d(_rows(y), w, eps=eps, gate=_rows(z)).reshape(z.shape)
