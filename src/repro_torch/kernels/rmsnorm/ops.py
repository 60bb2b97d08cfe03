"""Public wrappers: RMSNorm over the last dim with any leading dims (the
JAX ``ops.py`` contract), and its two fused forms.

``rmsnorm`` and ``add_rmsnorm`` are differentiable: when autograd needs
the call (grad mode on and an operand that requires grad), each runs as a
``torch.autograd.Function`` whose forward launches K8 (plain / add
variant) and whose backward launches K11 (``kernel.rmsnorm_backward``):
the plain one saves x and w, the add one h and w, and its backward takes
(dh, dy) to dx = dr = dh + dnorm(dy) and dw.  ``gated_rmsnorm`` runs
the same way through K8's gate variant and K11's
(``kernel.rmsnorm_backward_gate``; it saves y, z and w, its backward
gives dy, dz and dw).  Otherwise each is K8's wrapper
alone."""
from __future__ import annotations

import torch

from .._guard import autograd_wants
from .kernel import rmsnorm_2d, rmsnorm_backward, rmsnorm_backward_gate
from .ref import (add_rmsnorm_ref, gated_rmsnorm_backward_ref,
                  gated_rmsnorm_ref, rmsnorm_backward_ref, rmsnorm_ref)

__all__ = ["rmsnorm", "add_rmsnorm", "gated_rmsnorm", "rmsnorm_ref",
           "add_rmsnorm_ref", "gated_rmsnorm_ref", "rmsnorm_backward_ref",
           "gated_rmsnorm_backward_ref"]


def _rows(t):
    """t (..., D) as (R, D) rows: a view where the leading dims fold (the
    kernel reads the rows at their stride), else a copy."""
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _grad_rows(t):
    """An incoming gradient as rows the backward kernel reads (None
    stays None: that output had no gradient)."""
    return None if t is None else _rows(t)


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_2d(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if dy is None:
            return None, None, None
        dx, dw = rmsnorm_backward(x, w, _grad_rows(dy), eps=ctx.eps)
        return dx, dw, None


class _AddRMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, r, w, eps):
        ctx.set_materialize_grads(False)
        h, y = rmsnorm_2d(x, w, eps=eps, residual=r)
        ctx.save_for_backward(h, w)
        ctx.eps = eps
        return h, y

    @staticmethod
    def backward(ctx, dh, dy):
        h, w = ctx.saved_tensors
        if dy is None:
            # the norm's output had no gradient: h's passes straight through
            return dh, dh, None, None
        dx, dw = rmsnorm_backward(h, w, _grad_rows(dy), eps=ctx.eps,
                                  dh=_grad_rows(dh), variant="add")
        return dx, dx, dw, None


class _GatedRMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, z, w, eps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y, z, w)
        ctx.eps = eps
        return rmsnorm_2d(y, w, eps=eps, gate=z)

    @staticmethod
    def backward(ctx, dout):
        y, z, w = ctx.saved_tensors
        if dout is None:
            return None, None, None, None
        dy, dz, dw = rmsnorm_backward_gate(y, z, w, _grad_rows(dout),
                                           eps=ctx.eps)
        return dy, dz, dw, None


def rmsnorm(x, w, eps: float = 1e-5):
    """x (..., D); w (D,)."""
    if autograd_wants(x, w):
        return _RMSNorm.apply(_rows(x), w, eps).reshape(x.shape)
    return rmsnorm_2d(_rows(x), w, eps=eps).reshape(x.shape)


def add_rmsnorm(x, r, w, eps: float = 1e-5):
    """(h, rmsnorm(h) * w) with h = x + r, both of x's shape: the residual
    add and the next norm in one launch."""
    if autograd_wants(x, r, w):
        h, y = _AddRMSNorm.apply(_rows(x), _rows(r), w, eps)
    else:
        h, y = rmsnorm_2d(_rows(x), w, eps=eps, residual=_rows(r))
    return h.reshape(x.shape), y.reshape(x.shape)


def gated_rmsnorm(y, z, w, eps: float = 1e-5):
    """rmsnorm(y * silu(z)) * w in z's dtype, rounded as Mamba2's block
    rounds it: y (..., D) the scan's float32 output, z (..., D) the gate
    (any row stride, e.g. a column slice of the input projection)."""
    if autograd_wants(y, z, w):
        out = _GatedRMSNorm.apply(_rows(y), _rows(z), w, eps)
    else:
        out = rmsnorm_2d(_rows(y), w, eps=eps, gate=_rows(z))
    return out.reshape(z.shape)
