"""Plain version of the RMSNorm kernel (the port of
``repro.kernels.rmsnorm.ref``): widen to fp32, mean of squares, scale by
``rsqrt`` and the fp32-widened weight, round once to x's dtype."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)
