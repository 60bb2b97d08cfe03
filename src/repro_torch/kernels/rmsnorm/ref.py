"""Plain versions of the RMSNorm kernel (the port of
``repro.kernels.rmsnorm.ref``): widen to fp32, mean of squares, scale by
``rsqrt`` and the fp32-widened weight, round once to x's dtype -- and the
two fused prologues, each exactly the eager composition it replaces --
and of its backward K11 (the closed form, plain and add)."""
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


def rmsnorm_backward_ref(g, w, dy, eps: float = 1e-5, dh=None):
    """Plain version of the RMSNorm-backward kernel K11: the closed form in
    fp32 (not autograd).  ``g`` is the row that was normed (x, or the add
    variant's h), ``dy`` the gradient of the norm's output and ``dh`` that
    of the add variant's h (None: none).  With rstd = rsqrt(mean(g^2) +
    eps), xhat = g rstd, gw = dy w and c = mean(gw xhat):
    dx = rstd (gw - xhat c) (+ dh) in g's dtype, dw = sum over rows of
    dy xhat in w's dtype."""
    gf, dyf, wf = g.float(), dy.float(), w.float()
    rstd = torch.rsqrt((gf * gf).mean(dim=-1, keepdim=True) + eps)
    xh = gf * rstd
    gw = dyf * wf
    c = (gw * xh).mean(dim=-1, keepdim=True)
    dx = rstd * (gw - xh * c)
    if dh is not None:
        dx = dx + dh.float()
    dw = (dyf * xh).reshape(-1, g.shape[-1]).sum(dim=0)
    return dx.to(g.dtype), dw.to(w.dtype)


def gated_rmsnorm_backward_ref(y, z, w, dout, eps: float = 1e-5):
    """Plain version of K11's gate variant: the closed-form gradient of
    :func:`gated_rmsnorm_ref` in fp32 (not autograd).  The normed row
    u = round(round(y) * round(silu(z))) is recomputed in z's dtype; du is
    :func:`rmsnorm_backward_ref`'s dx of u, kept in fp32; then
    dy = du * silu(z) and dz = du * y * silu'(z), with silu'(z) =
    sigmoid(z) (1 + z (1 - sigmoid(z))); dw as the plain variant's.
    Returns (dy in y's dtype, dz in z's dtype, dw in w's dtype)."""
    zt = z.dtype
    zf = z.float()
    sl = F.silu(zf).to(zt).float()
    yr = y.to(zt).float()
    u = (yr * sl).to(zt).float()
    rstd = torch.rsqrt((u * u).mean(dim=-1, keepdim=True) + eps)
    xh = u * rstd
    gw = dout.float() * w.float()
    du = rstd * (gw - xh * (gw * xh).mean(dim=-1, keepdim=True))
    sig = torch.sigmoid(zf)
    dy = (du * sl).to(y.dtype)
    dz = (du * yr * sig * (1 + zf * (1 - sig))).to(zt)
    dw = (dout.float() * xh).reshape(-1, z.shape[-1]).sum(dim=0)
    return dy, dz, dw.to(w.dtype)
