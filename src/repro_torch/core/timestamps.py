"""Base-delta timestamp compression (paper section IV-B), torch port.

Callers keep *absolute* int32 timestamps plus a per-cache base ``bts``;
:func:`rebase_needed` and :func:`apply_rebase` express the hardware rebase
events: ``bts += 2**(bits-1)``, shared LLC lines clamp up to the new base,
private Shared lines whose rts falls below it are invalidated (rts cannot
grow without the timestamp manager's consent).
"""
from __future__ import annotations

import torch

from . import protocol


def delta(ts, bts):
    """Compressed representation of an absolute timestamp."""
    return ts - bts


def rebase_needed(max_ts, bts, bits):
    """True when the largest timestamp in the cache no longer fits ``bits``."""
    return (max_ts - bts) >= (1 << bits)


def rebase_amount(bits):
    """The paper rebases by half of the maximum delta."""
    return 1 << (bits - 1)


def apply_rebase(bts, wts, rts, state, is_private, bits):
    """One rebase step over a cache's absolute timestamp tensors.

    Returns (new_bts, new_wts, new_rts, new_state, invalidated_count).
    Absolute timestamps only *increase* (clamped to the new base); private
    Shared lines whose rts falls below the new base are invalidated.
    """
    new_bts = bts + rebase_amount(bits)
    nb = torch.as_tensor(new_bts, dtype=wts.dtype, device=wts.device)
    valid = state != protocol.INVALID
    wts_low = valid & (wts < nb)
    rts_low = valid & (rts < nb)
    if is_private:
        kill = rts_low & (state == protocol.SHARED)
        new_state = torch.where(kill, torch.full_like(state, protocol.INVALID),
                                state)
        new_wts = torch.where(wts_low & ~kill, nb, wts)
        new_rts = torch.where(rts_low & ~kill, nb, rts)
        return new_bts, new_wts, new_rts, new_state, kill.sum()
    sh = state == protocol.SHARED
    new_wts = torch.where(wts_low & sh, nb, wts)
    new_rts = torch.where(rts_low & sh, nb, rts)
    return (new_bts, new_wts, new_rts, state,
            torch.zeros((), dtype=torch.int64, device=wts.device))
