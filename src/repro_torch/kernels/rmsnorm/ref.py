"""Plain versions of the RMSNorm kernel (the port of
``repro.kernels.rmsnorm.ref``): widen to fp32, mean of squares, scale by
``rsqrt`` and the fp32-widened weight, round once to x's dtype -- and the
two fused prologues, each exactly the eager composition it replaces."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm_ref(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def add_rmsnorm_ref(x, r, w, eps: float = 1e-5):
    """The residual add, then its norm: (h, rmsnorm(h)) with h = x + r."""
    h = x + r
    return h, rmsnorm_ref(h, w, eps)


def gated_rmsnorm_ref(y, z, w, eps: float = 1e-5):
    """Mamba2's gated norm (``repro.models.ssm.ssm_block``): the scan's
    output y and silu(z), computed in fp32, each rounded to z's dtype, their
    product normed."""
    dt = z.dtype
    return rmsnorm_ref(y.to(dt) * F.silu(z.float()).to(dt), w, eps)
