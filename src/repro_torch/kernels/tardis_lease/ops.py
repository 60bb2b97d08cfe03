"""Public wrappers: flat block tables of any size, masked ops, jump-ahead.

The contracts of ``repro.kernels.tardis_lease.ops``, over torch tensors:
``masked_lease_check`` / ``write_advance`` are the two transitions the
:class:`repro_torch.core.lease_engine.LeaseEngine` runs on its device;
``lease_check`` is the whole-table form; ``masked_lease_check_many`` the
per-wave batched form (G mask rows, ONE K1 launch); ``gather_blocks`` and
``append_rows`` move paged-KV pool rows through K3.  The TPU version padded
tables to (rows, 128) lanes; K1/K2 run over the flat table directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import obs
from . import kernel as K
from .kernel import LANES

__all__ = ["LANES", "masked_lease_check", "masked_lease_check_many",
           "write_advance", "lease_check", "gather_blocks", "append_rows"]


def _i32(x, device, site: str):
    """``x`` as an int32 tensor on ``device``; host data is copied through
    ``obs.to_device``, one ``host.syncs`` at ``site``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return obs.to_device(np.asarray(x, np.int32), device, site)


def _lease(lease, device):
    if isinstance(lease, torch.Tensor) or np.ndim(lease):
        # per-block predicted leases
        return _i32(lease, device, "lease_check.lease")
    return int(lease)


def masked_lease_check_many(wts, rts, req_wts, masks, pts_vec, lease):
    """Per-wave batched lease check: G mask rows resolved in one pass.

    wts/rts/req_wts: (N,) int32; masks: (G, N); pts_vec: (G,); ``lease``:
    scalar or per-block (N,).  Returns ``new_rts`` (union of the per-group
    Table III extensions), per-group ``renew_ok`` / ``expired`` (G, N)
    against the pre-call table, ``write_ts`` over the union mask and the
    per-group reader timestamps ``new_pts`` (G,).
    """
    dev = wts.device
    new_rts, flags, write_ts, new_pts = K.lease_pass(
        wts, rts, _i32(req_wts, dev, "lease_check.req"),
        _i32(masks, dev, "lease_check.masks"),
        _i32(pts_vec, dev, "lease_check.pts"), _lease(lease, dev))
    return {"new_rts": new_rts,
            "renew_ok": (flags & 1).bool(),
            "expired": ((flags >> 1) & 1).bool(),
            "write_ts": write_ts,
            "new_pts": new_pts}


def masked_lease_check(wts, rts, req_wts, mask, pts, lease):
    """Lease-check / renew / extend the blocks selected by ``mask`` (the
    G == 1 case): ``renew_ok`` / ``expired`` are (N,), ``new_pts`` ()."""
    out = masked_lease_check_many(
        wts, rts, req_wts,
        _i32(mask, wts.device, "lease_check.masks").view(1, -1),
        _i32([int(pts)], wts.device, "lease_check.pts"), lease)
    return {"new_rts": out["new_rts"], "renew_ok": out["renew_ok"][0],
            "expired": out["expired"][0], "write_ts": out["write_ts"],
            "new_pts": out["new_pts"][0]}


def write_advance(wts, rts, mask, pts):
    """Writer jump-ahead over ``mask``: ``ts = max(pts, max(masked rts) +
    1)``; ``wts = rts = ts`` on every masked block.  Returns (new_wts,
    new_rts, ts), all int32, ts still on the device."""
    return K.write_advance(wts, rts, _i32(mask, wts.device,
                                          "write_advance.mask"), int(pts))


def lease_check(wts, rts, req_wts, pts, lease):
    """Whole-table form: every block selected."""
    return masked_lease_check(wts, rts, req_wts, torch.ones_like(wts), pts,
                              lease)


def gather_blocks(pool, idx, col_lo: int = 0, width: int = None):
    """Materialize pool rows for leased block ids: pool (N, W), idx (n,);
    ``col_lo``/``width`` select one stack's LANES-aligned column window."""
    return K.gather_rows(pool, _i32(idx, pool.device, "gather_blocks.ids"),
                         col_lo=col_lo, width=width)


def append_rows(pool, idx, rows, col_lo: int = 0, width: int = None):
    """Scatter rows into ``pool[idx, col_lo:...]`` IN PLACE (the append-KV
    path; the JAX version donated the buffer instead).  ``rows`` (n, w) is
    right-padded with zeros to ``width`` (default: the rest of the row) and
    cast to the pool dtype; columns outside the window keep their bits.
    Returns the pool."""
    if width is None:
        width = pool.shape[1] - col_lo
    rows = torch.as_tensor(rows, device=pool.device)
    if rows.shape[1] != width or rows.dtype != pool.dtype:
        padded = torch.zeros((rows.shape[0], width), dtype=pool.dtype,
                             device=pool.device)
        padded[:, :rows.shape[1]] = rows.to(pool.dtype)
        rows = padded
    return K.scatter_rows(pool, _i32(idx, pool.device, "append_rows.ids"),
                          rows.contiguous(), col_lo=col_lo)
