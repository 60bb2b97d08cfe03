"""Public wrapper: the full SSD scan (the JAX ``ops.py`` contract, the same
as ``models.ssm.ssd_chunked``): the intra-chunk term and chunk states in
the kernel, the inter-chunk recurrence in PyTorch, as the JAX ``ops.py``
kept it in jnp."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_chunk
from .ref import ssd_intra_chunk_ref, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_intra_chunk_ref"]


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 64):
    """x: (b, s, h, p); dt: (b, s, h) (softplus-ed); A: (h,) negative;
    B, C: (b, s, n); D: (h,).  Returns (y fp32 (b, s, h, p), final_state
    (b, h, p, n))."""
    from ...models.ssm import ssd_inter_chunk
    b, s, h, _p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, chunk, h).float()
    cum = torch.cumsum(dtc * A, dim=2)              # within-chunk log-decay
    y_intra, S = ssd_chunk(x, dt.float(), cum, B, C, chunk=chunk)
    Cc = F.pad(C, (0, 0, 0, pad)).reshape(b, nc, chunk, n).float()
    return ssd_inter_chunk(y_intra, S, cum, Cc, x, D, s)
