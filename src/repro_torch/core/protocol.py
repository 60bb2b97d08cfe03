"""Tardis protocol rules (paper Tables I-III) as branchless torch functions.

The port's copy of ``repro.core.protocol``: every rule is a direct
transcription of the timestamp-management tables, written over int32
tensors (or Python ints, where both sides are scalars).  The lease
kernels' plain versions (``kernels/tardis_lease/ref.py``) compose these
rules, so the CUDA kernels are held against them bit for bit.
"""
from __future__ import annotations

import torch

# Cache-line / block states (shared by private cache and timestamp manager).
INVALID = 0
SHARED = 1
EXCLUSIVE = 2  # paper's Exclusive == owned/modified (MSI "M" merged)


def _t(x, like=None):
    """Python ints / numpy scalars -> int32 tensors on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def _max(a, b):
    ta = _t(a, b)
    return torch.maximum(ta, _t(b, ta))


# ---------------------------------------------------------------------------
# Table I -- Tardis without private memory
# ---------------------------------------------------------------------------

def load_no_cache(pts, wts, rts):
    """Load served by the timestamp manager: (new_pts, new_rts)."""
    new_pts = _max(pts, wts)
    return new_pts, _max(new_pts, rts)


def store_no_cache(pts, wts, rts):
    """Store served by the timestamp manager: the writer jumps ahead of
    every read lease, ``pts <- max(pts, rts + 1)``; wts = rts = pts."""
    new_pts = _max(pts, _t(rts) + 1)
    return new_pts, new_pts, new_pts


# ---------------------------------------------------------------------------
# Table II -- private-cache transitions
# ---------------------------------------------------------------------------

def load_hit_shared(pts, wts):
    """L1 load hit on an unexpired Shared line: pts <- max(pts, wts)."""
    return _max(pts, wts)


def load_hit_exclusive(pts, wts, rts):
    """L1 load hit on an Exclusive line: (new_pts, new_rts)."""
    new_pts = _max(pts, wts)
    return new_pts, _max(new_pts, rts)


def store_hit_exclusive(pts, rts):
    """L1 store hit on an Exclusive line: ts = max(pts, rts + 1)."""
    ts = _max(pts, _t(rts) + 1)
    return ts, ts, ts


def store_hit_private(pts, rts):
    """Private-write optimization (paper section IV-C): ts = max(pts, rts)."""
    ts = _max(pts, rts)
    return ts, ts, ts


def shared_expired(pts, rts):
    """True when a Shared line's lease has run out for this core (pts > rts)."""
    return _t(pts, rts) > _t(rts, pts)


def writeback_rts(line_wts, line_rts, req_pts, lease):
    """Owner-side rts on WB_REQ: max(D.rts, D.wts + lease, req_pts + lease)."""
    return _max(_max(line_rts, _t(line_wts) + _t(lease, line_wts)),
                _t(req_pts) + _t(lease, line_wts))


# ---------------------------------------------------------------------------
# Table III -- timestamp-manager transitions
# ---------------------------------------------------------------------------

def lease_extend(llc_wts, llc_rts, req_pts, lease):
    """SH_REQ on a Shared LLC line:
    ``D.rts <- max(D.rts, D.wts + lease, reqM.pts + lease)``."""
    w = _t(llc_wts, llc_rts)
    lease = _t(lease, w)
    return _max(_max(llc_rts, w + lease), _t(req_pts, w) + lease)


def renewable(req_wts, llc_wts):
    """A renewal is data-less iff the requester's version matches."""
    return _t(req_wts, llc_wts) == _t(llc_wts, req_wts)


def dram_fill_ts(mts):
    """Line loaded from DRAM: wts = rts = mts (Table III, DRAM_REP column)."""
    return mts, mts


def evict_mts(mts, line_rts):
    """LLC eviction folds the line's read lease into the per-manager mts."""
    return _max(mts, line_rts)


# ---------------------------------------------------------------------------
# Derived helpers used by the batched store / kernel paths
# ---------------------------------------------------------------------------

def batched_read_check(pts, wts, rts):
    """Vectorized lease check: (readable, new_pts) where ``new_pts`` is the
    reader's program timestamp after consuming every readable block
    (``max(pts, max(consumed, initial=0))``)."""
    readable = _t(pts, rts) <= rts
    consumed = torch.where(readable, wts, torch.zeros_like(wts))
    top = consumed.max() if consumed.numel() else _t(0, wts)
    new_pts = _max(_max(pts, top), 0)
    return readable, new_pts.to(torch.int32)


def batched_write_advance(pts, rts, mask):
    """Vectorized jump-ahead: ``pts' = max(pts, max(masked rts) + 1)``;
    returns (new_pts, new_wts, new_rts) broadcast over the mask."""
    neg = torch.full_like(rts, -1)
    masked = torch.where(mask, rts, neg)
    top = masked.max() if masked.numel() else _t(-1, rts)
    top = _max(top, -1)
    new_pts = _max(pts, top + 1).to(torch.int32)
    zero = torch.zeros_like(rts)
    return (new_pts, torch.where(mask, new_pts, zero),
            torch.where(mask, new_pts, zero))


# 128-bit network flits (the simulator's unit of traffic accounting).
FLIT_BYTES = 16


def data_flits(nbytes: int) -> int:
    """Payload flits for an arbitrary-size object (a 64B line is 4 flits;
    multi-MB parameter shards round up the same way)."""
    return -(-int(nbytes) // FLIT_BYTES)


MESSAGE_FLITS = {
    # message type: header flits + timestamp flits + data flits
    # (128-bit flits; 64B line = 4 flits; one flit carries two 64b timestamps)
    "SH_REQ": 2,        # header + (pts, wts)
    "EX_REQ": 2,        # header + wts
    "FLUSH_REQ": 1,
    "WB_REQ": 2,        # header + rts
    "SH_REP": 6,        # header + (wts, rts) + data
    "EX_REP": 6,
    "UPGRADE_REP": 2,   # header + rts, no data
    "RENEW_REP": 2,     # header + rts, no data
    "FLUSH_REP": 6,
    "WB_REP": 6,
    "DRAM_ST_REQ": 5,
    "DRAM_LD_REQ": 1,
    "DRAM_LD_REP": 5,
    # directory-protocol messages
    "GETS": 1,
    "GETX": 1,
    "PUTS": 1,
    "PUTX": 5,
    "INV": 1,
    "INV_ACK": 1,
    "DOWNGRADE": 1,
    "DATA": 5,
    "UPGRADE": 1,
    "ACK": 1,
}
