"""Public wrapper: the full SSD scan (the JAX ``ops.py`` contract, the same
as ``models.ssm.ssd_chunked``): the intra-chunk term and chunk states in
the kernel, the inter-chunk recurrence in PyTorch, as the JAX ``ops.py``
kept it in jnp.

``ssd_scan`` is differentiable: when autograd needs the call (grad mode on
and an operand that requires grad), the intra-chunk step runs as a
``torch.autograd.Function`` whose forward launches K7 and whose backward
launches K12 (``kernel.ssd_chunk_backward``); the cumulative decay
``cum = cumsum(dt A)`` before it and the recurrence between chunks
(``models.ssm.ssd_inter_chunk``) after it stay plain PyTorch, which
autograd differentiates.  Otherwise the step is K7's wrapper alone."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .._guard import autograd_wants
from .kernel import ssd_chunk, ssd_chunk_backward
from .ref import (ssd_chunk_backward_ref, ssd_intra_chunk_ref,
                  ssd_scan_ref)

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_intra_chunk_ref",
           "ssd_chunk_backward_ref"]


class _SSDChunk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, chunk):
        ctx.save_for_backward(x, dt, cum, B, C)
        ctx.chunk = chunk
        return ssd_chunk(x, dt, cum, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, cum, B, C = ctx.saved_tensors
        dx, ddt, dcum, dB, dC = ssd_chunk_backward(
            x, dt, cum, B, C, dy, dS, chunk=ctx.chunk)
        return dx, ddt, dcum, dB, dC, None


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 64):
    """x: (b, s, h, p); dt: (b, s, h) (softplus-ed); A: (h,) negative;
    B, C: (b, s, n); D: (h,).  Returns (y fp32 (b, s, h, p), final_state
    (b, h, p, n))."""
    from ...models.ssm import ssd_inter_chunk
    b, s, h, _p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    dt = dt.float()
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    cum = torch.cumsum(dtc * A, dim=2)              # within-chunk log-decay
    if autograd_wants(x, dt, cum, B, C):
        y_intra, S = _SSDChunk.apply(x, dt, cum, B, C, chunk)
    else:
        y_intra, S = ssd_chunk(x, dt, cum, B, C, chunk=chunk)
    Cc = F.pad(C, (0, 0, 0, pad)).reshape(b, nc, chunk, n).float()
    return ssd_inter_chunk(y_intra, S, cum, Cc, x, D, s)
