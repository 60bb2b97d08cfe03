"""Plain PyTorch versions of the lease kernels, and the protocol oracles.

``lease_pass_ref`` / ``write_advance_ref`` / ``gather_rows_ref`` /
``scatter_rows_ref`` compute exactly what K1-K3 compute (same outputs, same
int32 arithmetic); the kernel wrappers run them on CPU tensors and
``chip_smoke.py`` holds each kernel against them on the card.  The
``*_ref`` oracles below them compose the scalar Table I-III rules from
:mod:`repro_torch.core.protocol`, as ``repro.kernels.tardis_lease.ref``
does, so ops outputs must be bit-identical int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import protocol as P


def _lease_tensor(lease, like):
    if isinstance(lease, torch.Tensor):
        return lease.to(device=like.device, dtype=torch.int32)
    return torch.tensor(int(lease), dtype=torch.int32, device=like.device)


def lease_pass_ref(wts, rts, req, masks, pts_vec, lease):
    """K1's function.  wts/rts/req (N,) int32; masks (G, N) int32; pts_vec
    (G,) int32; lease a scalar or (N,) int32.  Returns (new_rts (N,),
    flags (G, N) int32 -- bit0 renew_ok, bit1 expired --, write_ts () int32
    over the union mask, new_pts (G,) int32)."""
    m = masks != 0
    pts = pts_vec.to(torch.int32).view(-1, 1)
    lease = _lease_tensor(lease, wts)
    ext = torch.maximum(torch.maximum(rts, wts + lease), pts + lease)
    new_rts = torch.where(m, ext, rts).amax(dim=0)
    flags = ((m & (req == wts)).to(torch.int32)
             | ((m & (pts > rts)).to(torch.int32) << 1))
    union = m.any(dim=0)
    # each max over the entries starts from its identity (-1, 0), which
    # also gives the answer for an empty table
    write_ts = F.pad(torch.where(union, rts, -1), (0, 1), value=-1).amax()
    write_ts = (write_ts + 1).to(torch.int32)
    consumed = F.pad(torch.where(m & (pts <= rts), wts, 0), (0, 1), value=0)
    new_pts = torch.maximum(pts_vec.to(torch.int32),
                            consumed.amax(dim=1).clamp_min(0))
    return new_rts.to(torch.int32), flags, write_ts, new_pts.to(torch.int32)


def write_advance_ref(wts, rts, mask, pts):
    """K2's function: ts = max(pts, max(masked rts, -1) + 1); wts = rts = ts
    on every masked block.  Returns (new_wts, new_rts, ts) int32."""
    m = mask != 0
    # the max starts from its identity, -1, which also gives the answer
    # for an empty table: ts = max(pts, 0)
    top = F.pad(torch.where(m, rts, -1), (0, 1), value=-1).amax()
    ts = torch.clamp_min(top + 1, int(pts)).to(torch.int32)
    return torch.where(m, ts, wts), torch.where(m, ts, rts), ts


def gather_rows_ref(pool, idx, col_lo: int, width: int):
    """K3 gather: pool[idx, col_lo:col_lo+width] as a new (n, width)."""
    return pool[idx.long(), col_lo:col_lo + width].clone()


def scatter_rows_ref(pool, idx, rows, col_lo: int):
    """K3 scatter, in place: pool[idx, col_lo:col_lo+w] = rows, the LAST
    listed row winning for a duplicate id (as the TPU's sequential grid
    gave)."""
    idx = idx.long()
    n = idx.numel()
    if not n:
        return pool
    uniq, inv = torch.unique(idx, return_inverse=True)
    last = torch.full((uniq.numel(),), -1, dtype=torch.long,
                      device=idx.device)
    last.scatter_reduce_(0, inv, torch.arange(n, device=idx.device),
                         reduce="amax")
    w = rows.shape[1]
    pool[uniq, col_lo:col_lo + w] = rows[last].to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# Protocol oracles (the JAX package's ref.py, rule for rule)
# ---------------------------------------------------------------------------

def masked_lease_check_ref(wts, rts, req_wts, mask, pts, lease):
    mask = mask != 0
    _, new_pts = P.batched_read_check(
        pts, torch.where(mask, wts, torch.zeros_like(wts)),
        torch.where(mask, rts, torch.full_like(rts, -1)))
    top = torch.where(mask, rts, torch.full_like(rts, -1)).amax()
    return {
        "new_rts": torch.where(mask, P.lease_extend(wts, rts, pts, lease),
                               rts),
        "renew_ok": mask & P.renewable(req_wts, wts),
        "expired": mask & P.shared_expired(pts, rts),
        "write_ts": torch.clamp_min(top, -1) + 1,
        "new_pts": new_pts,
    }


def masked_lease_check_many_ref(wts, rts, req_wts, masks, pts_vec, lease):
    masks = masks != 0
    union = masks.any(dim=0)
    new_rts = rts
    expired, renew_ok, new_pts = [], [], []
    for g in range(masks.shape[0]):
        m, pts = masks[g], pts_vec[g]
        expired.append(m & P.shared_expired(pts, rts))
        renew_ok.append(m & P.renewable(req_wts, wts))
        _, npts = P.batched_read_check(
            pts, torch.where(m, wts, torch.zeros_like(wts)),
            torch.where(m, rts, torch.full_like(rts, -1)))
        new_pts.append(npts)
        new_rts = torch.where(
            m, torch.maximum(new_rts, P.lease_extend(wts, rts, pts, lease)),
            new_rts)
    top = torch.where(union, rts, torch.full_like(rts, -1)).amax()
    return {
        "new_rts": new_rts,
        "renew_ok": torch.stack(renew_ok),
        "expired": torch.stack(expired),
        "write_ts": torch.clamp_min(top, -1) + 1,
        "new_pts": torch.stack(new_pts),
    }


def write_advance_oracle(wts, rts, mask, pts):
    mask = mask != 0
    new_pts, w, r = P.batched_write_advance(pts, rts, mask)
    return torch.where(mask, w, wts), torch.where(mask, r, rts), new_pts


def lease_check_ref(wts, rts, req_wts, pts, lease):
    return masked_lease_check_ref(wts, rts, req_wts, torch.ones_like(wts),
                                  pts, lease)


def append_rows_ref(pool, idx, rows, col_lo: int = 0, width: int = None):
    """Oracle for the append-KV scatter on a COPY of the pool: rows
    right-padded to the window width, the last write winning."""
    if width is None:
        width = pool.shape[1] - col_lo
    out = pool.clone()
    pad = torch.zeros(rows.shape[0], width, dtype=pool.dtype,
                      device=pool.device)
    pad[:, :rows.shape[1]] = rows.to(pool.dtype)
    return scatter_rows_ref(out, torch.as_tensor(idx), pad, col_lo)


def gather_blocks_ref(pool, idx, col_lo: int = 0, width: int = None):
    if width is None:
        width = pool.shape[1] - col_lo
    return gather_rows_ref(pool, torch.as_tensor(idx), col_lo, width)
