"""Public wrapper: RMSNorm over the last dim with any leading dims (the
JAX ``ops.py`` contract)."""
from __future__ import annotations

from .kernel import rmsnorm_2d
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]


def rmsnorm(x, w, eps: float = 1e-5):
    """x (..., D); w (D,).  Leading dims fold into rows as a view where
    they can (the kernel reads the rows at their stride), else a copy."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    return rmsnorm_2d(x2, w, eps=eps).reshape(x.shape)
