"""Base-delta timestamp compression (paper section IV-B), torch port.

Callers keep *absolute* int32 timestamps plus a per-cache base ``bts``;
:func:`rebase_needed`, :func:`apply_rebase` and :func:`maybe_rebase`
express the hardware rebase events: ``bts += 2**(bits-1)``, shared LLC
lines clamp up to the new base, private Shared lines whose rts falls
below it are invalidated (rts cannot grow without the timestamp
manager's consent).  :func:`storage_bits_per_line` is the paper's Table
VII.
"""
from __future__ import annotations

import math

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


def maybe_rebase(bts, wts, rts, state, *, bits, is_private):
    """Rebase iff needed: (bts, wts, rts, state, rebased?, invalidated).

    The JAX package's jitted ``lax.cond`` is a select over both branches
    here, so a CUDA tensor costs no host sync; ``invalidated`` is int32.
    """
    valid = state != protocol.INVALID
    max_ts = torch.where(valid, torch.maximum(wts, rts), 0).max()
    bts = torch.as_tensor(bts, dtype=torch.int32, device=wts.device)
    need = rebase_needed(max_ts, bts, bits)
    nb, nw, nr, ns, killed = apply_rebase(bts, wts, rts, state, is_private,
                                          bits)
    return (torch.where(need, nb, bts), torch.where(need, nw, wts),
            torch.where(need, nr, rts), torch.where(need, ns, state), need,
            torch.where(need, killed, 0).to(torch.int32))


def storage_bits_per_line(n_cores: int, scheme: str, delta_bits: int = 20,
                          ackwise_ptrs: int = 4) -> int:
    """Per-LLC-line metadata cost (paper Table VII).

    full-map MSI: one sharer bit per core.  Ackwise: k pointers of log2(N)
    bits each.  Tardis: two delta timestamps (owner id reuses the same bits
    when the line is Exclusive, so no extra cost).
    """
    logn = max(1, math.ceil(math.log2(n_cores)))
    if scheme == "full-map":
        return n_cores
    if scheme == "ackwise":
        return ackwise_ptrs * logn
    if scheme == "tardis":
        return 2 * delta_bits
    raise ValueError(f"unknown scheme {scheme!r}")
