"""Plain version of the SSD intra-chunk kernel: the TPU kernel's
per-grid-point function over its folded contract (the port of
``repro.kernels.ssd_scan.kernel._ssd_kernel``).

C, B: (G, Q, N); xdt: (G, Q, P) (x already times dt); cum: (G, Q, 1), the
within-chunk cumulative log-decay.  G folds (batch, chunk, head).  Returns
fp32 (y_intra (G, Q, P), S (G, N, P)).  ``ssd_chunk_ref`` is the plain
version of the port's kernel wrapper (the model's layout) built on it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_intra_chunk_ref(C, B, xdt, cum):
    c, b, x = C.float(), B.float(), xdt.float()
    cum = cum.float()
    q = c.shape[1]
    cb = torch.matmul(c, b.transpose(1, 2))                   # (G, Q, Q)
    seg = cum - cum.transpose(1, 2)                           # cum_i - cum_j
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=c.device))
    L = torch.where(tri, torch.exp(seg), torch.zeros((), device=c.device))
    y = torch.matmul(cb * L, x)
    decay_end = torch.exp(cum[:, -1:] - cum)                  # (G, Q, 1)
    S = torch.matmul(b.transpose(1, 2), x * decay_end)        # (G, N, P)
    return y, S


def ssd_chunk_ref(x, dt, cum, B, C, *, chunk: int):
    """The plain version of ``kernel.ssd_chunk`` on the model's layout: pad
    to whole chunks, form xdt, fold (batch, chunk, head) -- B and C copied
    to every head where one group serves them all -- run
    :func:`ssd_intra_chunk_ref`, unfold."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    pad = nc * chunk - s
    if B.dim() == 3:                        # one group: every head's copy
        B = B[:, :, None].expand(b, s, h, n)
        C = C[:, :, None].expand(b, s, h, n)
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    xdt = (x.reshape(b, nc, chunk, h, p).float()
           * dt.reshape(b, nc, chunk, h).float()[..., None])

    def fold(a):                            # (b, nc, q, h, k) -> (G, q, k)
        return a.permute(0, 1, 3, 2, 4).reshape(b * nc * h, chunk,
                                                a.shape[-1])

    y, S = ssd_intra_chunk_ref(
        fold(C.reshape(b, nc, chunk, h, n)), fold(B.reshape(b, nc, chunk, h,
                                                            n)),
        fold(xdt), fold(cum[..., None]))
    y = y.reshape(b, nc, h, chunk, p).permute(0, 1, 3, 2, 4)
    S = S.reshape(b, nc, h, n, p).transpose(-1, -2)
    return y, S
