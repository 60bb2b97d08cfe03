"""Plain version of the SSD intra-chunk kernel: the TPU kernel's
per-grid-point function over its folded contract (the port of
``repro.kernels.ssd_scan.kernel._ssd_kernel``).

C, B: (G, Q, N); xdt: (G, Q, P) (x already times dt); cum: (G, Q, 1), the
within-chunk cumulative log-decay.  G folds (batch, chunk, head).  Returns
fp32 (y_intra (G, Q, P), S (G, N, P)).  ``ssd_chunk_ref`` is the plain
version of the port's kernel wrapper (the model's layout) built on it,
``ssd_scan_ref`` that of the public ``ops.ssd_scan`` (the whole chunked
scan: ``models.ssm.ssd_chunked``'s plain code).

``ssd_intra_chunk_split_ref`` / ``ssd_chunk_split_ref`` model the
arithmetic of K7's tensor-core variant on the same contracts, with x and
dt apart: dt folded into the decayed matrix M' and into w * B, each of
those split into three bf16 parts, each part times the bf16 x summed in
fp32.  ``ssd_intra_chunk_tf32_ref`` / ``ssd_chunk_tf32_ref`` model K7's
tf32x3 variant (every product as three TF32 products of a hi / lo split,
:func:`tf32x3_matmul`), and ``ssd_chunk_backward_tf32_ref`` K12's: its
products likewise, and, where one group of B / C serves every head, the
heads' dcb summed before the n-wide products dC and dB.
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
    # exp only where i >= j: past the diagonal seg can overflow
    L = torch.exp(torch.where(tri, seg,
                              torch.full((), -torch.inf, device=c.device)))
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


def ssd_scan_ref(x, dt, A, B, C, D, *, chunk: int = 64):
    """The plain version of ``ops.ssd_scan`` (the port of
    ``repro.kernels.ssd_scan.ref.ssd_scan_ref``): the chunked SSD scan in
    plain PyTorch on any device; returns (y fp32 (b, s, h, p),
    final_state (b, h, p, n))."""
    from ...models.ssm import ssd_chunked_plain
    return ssd_chunked_plain(x, dt, A, B, C, D, chunk)


def bf16_parts(a, n: int = 3):
    """``a`` (fp32) as ``n`` bf16-valued fp32 tensors whose sum is ``a`` to
    8 significant bits a part: each rounds what the parts before it left."""
    parts = []
    for _ in range(n):
        part = a.to(torch.bfloat16).float()
        parts.append(part)
        a = a - part
    return parts


def ssd_intra_chunk_split_ref(C, B, x, dt, cum):
    """K7's tensor-core arithmetic on the folded contract: C, B (G, Q, N)
    and x (G, Q, P) bf16-valued, dt and cum (G, Q, 1).  C . B^T in fp32;
    M'_ij = cb_ij * exp(cum_i - cum_j) * dt_j for j <= i (no exponential
    past the diagonal), else 0; y = sum over M''s three bf16 parts of
    part @ x.  w_j = exp(cum_last - cum_j) * dt_j; S = sum over the parts
    of w * B of part^T @ x.  Returns fp32 (y (G, Q, P), S (G, N, P))."""
    c, b, xx = C.float(), B.float(), x.float()
    dt, cum = dt.float(), cum.float()
    q = c.shape[1]
    cb = torch.matmul(c, b.transpose(1, 2))                   # (G, Q, Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=c.device))
    seg = torch.where(tri, cum - cum.transpose(1, 2),
                      torch.full((), -torch.inf, device=c.device))
    m = cb * torch.exp(seg) * dt.transpose(1, 2)              # 0 past i
    y = sum(torch.matmul(part, xx) for part in bf16_parts(m))
    bw = b * (torch.exp(cum[:, -1:] - cum) * dt)              # (G, Q, N)
    S = sum(torch.matmul(part.transpose(1, 2), xx)
            for part in bf16_parts(bw))
    return y, S


def ssd_chunk_split_ref(x, dt, cum, B, C, *, chunk: int):
    """:func:`ssd_chunk_ref` with the tensor-core arithmetic
    (:func:`ssd_intra_chunk_split_ref`): the same layouts and results."""
    return _on_chunks(ssd_intra_chunk_split_ref, x, dt, cum, B, C, chunk)


def _on_chunks(intra, x, dt, cum, B, C, chunk):
    """A model of K7's arithmetic on the folded contract (C, B, x, dt,
    cum -> y (G, Q, P), S (G, N, P)) run on the model's layout, as
    :func:`ssd_chunk_ref` runs :func:`ssd_intra_chunk_ref`."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    pad = nc * chunk - s
    if B.dim() == 3:
        B = B[:, :, None].expand(b, s, h, n)
        C = C[:, :, None].expand(b, s, h, n)
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))

    def fold(a):                            # (b, nc, q, h, k) -> (G, q, k)
        return a.reshape(b, nc, chunk, h, a.shape[-1]).permute(
            0, 1, 3, 2, 4).reshape(b * nc * h, chunk, a.shape[-1])

    y, S = intra(fold(C), fold(B), fold(x), fold(dt[..., None]),
                 fold(cum[..., None]))
    y = y.reshape(b, nc, h, chunk, p).permute(0, 1, 3, 2, 4)
    S = S.reshape(b, nc, h, n, p).transpose(-1, -2)
    return y, S


def tf32_parts(a):
    """(hi, lo) of fp32 ``a`` as K6's, K10's, K7's and K12's tf32x3 kernels
    feed the tensor cores (``split_tf32``): hi is ``a`` rounded to TF32 (to
    nearest, ties away from zero), lo = a - hi, as the mma reads it (its
    top 19 bits: TF32, truncated)."""
    bits = a.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((a.float() - hi).contiguous().view(torch.int32)
          & -0x2000).view(torch.float32)
    return hi, lo


def tf32x3_matmul(a, b):
    """``a @ b`` as three TF32 products of the hi / lo split, the small
    ones first (lo.hi + hi.lo + hi.hi), each summed in fp32."""
    ah, al = tf32_parts(a)
    bh, bl = tf32_parts(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def ssd_intra_chunk_tf32_ref(C, B, x, dt, cum):
    """K7's tf32x3 arithmetic on the folded contract: C, B (G, Q, N), x
    (G, Q, P), dt and cum (G, Q, 1).  cb = C . B^T; M'_ij = cb_ij
    exp(cum_i - cum_j) dt_j for j <= i (no exponential past the diagonal),
    else 0; y = M' . x; w_j = exp(cum_last - cum_j) dt_j; S = B^T . (w x)
    -- each product three TF32 products (:func:`tf32x3_matmul`).  Returns
    fp32 (y (G, Q, P), S (G, N, P))."""
    c, b, xx = C.float(), B.float(), x.float()
    dt, cum = dt.float(), cum.float()
    q = c.shape[1]
    cb = tf32x3_matmul(c, b.transpose(1, 2))                  # (G, Q, Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=c.device))
    seg = torch.where(tri, cum - cum.transpose(1, 2),
                      torch.full((), -torch.inf, device=c.device))
    m = cb * torch.exp(seg) * dt.transpose(1, 2)              # 0 past i
    y = tf32x3_matmul(m, xx)
    w = torch.exp(cum[:, -1:] - cum) * dt                     # (G, Q, 1)
    S = tf32x3_matmul(b.transpose(1, 2), w * xx)
    return y, S


def ssd_chunk_tf32_ref(x, dt, cum, B, C, *, chunk: int):
    """:func:`ssd_chunk_ref` with K7's tf32x3 arithmetic
    (:func:`ssd_intra_chunk_tf32_ref`): the same layouts and results."""
    return _on_chunks(ssd_intra_chunk_tf32_ref, x, dt, cum, B, C, chunk)


def _fold_backward(x, dt, cum, B, C, dy, dS, chunk):
    """The backward's operands per (batch, chunk, head) -- G of them -- in
    fp32, zero-padded to whole chunks (B and C copied to every head where
    one group serves them all): x (G, q, p), dt (G, q, 1), B and C (G, q,
    n), cum (G, q, 1), dy (G, q, p), dS (G, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    if B.dim() == 3:
        B = B[:, :, None].expand(b, s, h, n)
        C = C[:, :, None].expand(b, s, h, n)

    def fold(a):                            # (b, nc*q, h, k) -> (G, q, k)
        a = F.pad(a.float(), (0, 0, 0, 0, 0, nc * chunk - a.shape[1]))
        return a.reshape(b, nc, chunk, h, a.shape[-1]).permute(
            0, 1, 3, 2, 4).reshape(b * nc * h, chunk, a.shape[-1])

    return (fold(x), fold(dt[..., None]), fold(B), fold(C),
            cum.float().permute(0, 1, 3, 2).reshape(b * nc * h, chunk, 1),
            dy.float().permute(0, 1, 3, 2, 4).reshape(b * nc * h, chunk, p),
            dS.float().reshape(b * nc * h, p, n))


def _unfold_heads(a, b, s, h, chunk):
    """(G, q, k) per (batch, chunk, head) -> (b, s, h, k), the padding
    dropped."""
    k = a.shape[-1]
    nc = a.shape[0] // (b * h)
    return a.reshape(b, nc, h, chunk, k).permute(0, 1, 3, 2, 4).reshape(
        b, nc * chunk, h, k)[:, :s]


def ssd_chunk_backward_ref(x, dt, cum, B, C, dy, dS, *, chunk: int):
    """Plain version of the SSD intra-chunk backward kernel K12: the
    closed-form gradient of :func:`ssd_chunk_ref` in fp32 (not autograd).
    ``dy`` (b, nc, chunk, h, p) and ``dS`` (b, nc, h, p, n) are the
    gradients of y_intra and of the chunk states.  Per (batch, chunk,
    head), with xdt = x dt, L_ij = exp(cum_i - cum_j) for i >= j (else 0),
    M = (C B^T) o L and e_j = exp(cum_last - cum_j):
      dxdt = M^T dy + e o (B dS^T);  dM = (dy xdt^T) masked to i >= j;
      dC = (dM o L) B;  dB = (dM o L)^T C + e o (xdt dS);
      dcum_i += sum_j (dM o M)_ij, dcum_j -= the same column sum, and the
      e terms de_j = xdt_j . (B dS^T)_j: dcum_last += sum_j de_j e_j,
      dcum_j -= de_j e_j.
    Returns (dx in x's dtype, ddt fp32, dcum fp32 (b, nc, chunk, h), dB
    and dC in B's dtype and shape -- summed over the heads where one
    group (b, s, n) serves them all); positions past s are padding and
    their gradients are dropped (dcum keeps every position)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    shared = B.dim() == 3
    xf, dtf, Bf, Cf, cumf, dyf, dSf = _fold_backward(x, dt, cum, B, C, dy,
                                                     dS, chunk)

    def unfold(a):                          # (G, q, k) -> (b, s, h, k)
        return _unfold_heads(a, b, s, h, chunk)

    xdt = xf * dtf
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    zero = torch.zeros((), device=x.device)
    L = torch.exp(torch.where(tri, cumf - cumf.transpose(1, 2),
                              torch.full((), -torch.inf, device=x.device)))
    M = torch.matmul(Cf, Bf.transpose(1, 2)) * L              # (G, Q, Q)
    e = torch.exp(cumf[:, -1:] - cumf)                        # (G, Q, 1)
    BdS = torch.matmul(Bf, dSf.transpose(1, 2))               # (G, Q, P)
    dxdt = torch.matmul(M.transpose(1, 2), dyf) + e * BdS
    dM = torch.where(tri, torch.matmul(dyf, xdt.transpose(1, 2)), zero)
    dcb = dM * L
    dC = torch.matmul(dcb, Bf)
    dB = torch.matmul(dcb.transpose(1, 2), Cf) + e * torch.matmul(xdt, dSf)
    dL = dM * M
    dee = (xdt * BdS).sum(-1) * e[..., 0]                     # (G, Q)
    dcum = dL.sum(2) - dL.sum(1) - dee
    dcum[:, -1] += dee.sum(1)
    dx = unfold(dxdt * dtf).to(x.dtype)
    ddt = unfold((dxdt * xf).sum(-1, keepdim=True))[..., 0]
    dcum = dcum.reshape(b, nc, h, chunk).permute(0, 1, 3, 2)
    dB, dC = unfold(dB), unfold(dC)
    if shared:
        dB, dC = dB.sum(2), dC.sum(2)
    return dx, ddt, dcum.contiguous(), dB.to(B.dtype), dC.to(C.dtype)


def ssd_chunk_backward_tf32_ref(x, dt, cum, B, C, dy, dS, *, chunk: int):
    """K12's tf32x3 arithmetic on :func:`ssd_chunk_backward_ref`'s
    contract: the same closed form, every product three TF32 products
    (:func:`tf32x3_matmul`), dt applied after the products that it scales
    (dM^T = dt_j (x_j . dy_i), the state terms), and, where one group
    (b, s, n) serves every head, the heads' dcb summed first -- dC = (sum_h
    dcb_h) B and dB = (sum_h dcb_h)^T C + sum_h e_h dt_h (x_h dS_h), the
    n-wide products once a chunk.  Returns what
    :func:`ssd_chunk_backward_ref` returns."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    q = chunk
    shared = B.dim() == 3
    xf, dtf, Bf, Cf, cumf, dyf, dSf = _fold_backward(x, dt, cum, B, C, dy,
                                                     dS, chunk)

    def unfold(a):                          # (G, q, k) -> (b, s, h, k)
        return _unfold_heads(a, b, s, h, chunk)

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    zero = torch.zeros((), device=x.device)
    L = torch.exp(torch.where(tri, cumf - cumf.transpose(1, 2),
                              torch.full((), -torch.inf, device=x.device)))
    cb = tf32x3_matmul(Cf, Bf.transpose(1, 2))                # (G, Q, Q)
    M = cb * L
    e = torch.exp(cumf[:, -1:] - cumf)                        # (G, Q, 1)
    BdS = tf32x3_matmul(Bf, dSf.transpose(1, 2))              # (G, Q, P)
    dxdt = tf32x3_matmul(M.transpose(1, 2), dyf) + e * BdS
    dM = torch.where(tri, tf32x3_matmul(dyf, xf.transpose(1, 2))
                     * dtf.transpose(1, 2), zero)
    dcb = dM * L
    dL = dcb * cb
    dee = dtf[..., 0] * (xf * BdS).sum(-1) * e[..., 0]        # (G, Q)
    dcum = dL.sum(2) - dL.sum(1) - dee
    dcum[:, -1] += dee.sum(1)
    dBe = e * dtf * tf32x3_matmul(xf, dSf)                    # (G, Q, N)
    if shared:
        def chunks(a):                      # (b, s, n) -> (b * nc, q, n)
            a = F.pad(a.float(), (0, 0, 0, nc * q - s))
            return a.reshape(b * nc, q, n)
        D = dcb.reshape(b * nc, h, q, q).sum(1)
        dC = tf32x3_matmul(D, chunks(B))
        dB = tf32x3_matmul(D.transpose(1, 2), chunks(C)) \
            + dBe.reshape(b * nc, h, q, n).sum(1)
        dB, dC = (a.reshape(b, nc * q, n)[:, :s] for a in (dB, dC))
    else:
        dC = unfold(tf32x3_matmul(dcb, Bf))
        dB = unfold(tf32x3_matmul(dcb.transpose(1, 2), Cf) + dBe)
    dx = unfold(dxdt * dtf).to(x.dtype)
    ddt = unfold((dxdt * xf).sum(-1, keepdim=True))[..., 0]
    dcum = dcum.reshape(b, nc, h, q).permute(0, 1, 3, 2)
    return dx, ddt, dcum.contiguous(), dB.to(B.dtype), dC.to(C.dtype)
