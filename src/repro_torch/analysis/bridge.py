"""Cross-validation bridge: the model checks the port's *shipped* rules.

The port of ``repro.analysis.bridge``.  Every transition the enumerator
takes records (a) the protocol-scalar calls it was built from and (b) the
manager-table operation it corresponds to.  The bridge replays each
**distinct** one:

  * protocol calls go through the port's ``core.protocol`` (torch scalars)
    -- the model's pure-int transcription must match bit for bit,
  * manager-table ops (``read`` / ``write`` / ``rebase``) go through a
    small ``LeaseEngine`` loaded with the transition's pre-state via
    :meth:`LeaseEngine.set_tables` -- the resulting ``(wts, rts)`` and
    program timestamps must be identical ints.  ``backend="numpy"`` is the
    engine's host mirror; ``backend="device"`` builds each engine on
    ``pick_device(device)``, so on the card every distinct ``read`` runs
    the lease-pass kernel K1 and every ``write`` the write-advance kernel
    K2 (on CPU tensors, their plain versions).

Replays are memoized on the operand tuple, so the cost is bounded by the
number of distinct rule applications (a few thousand for the bounded
configs), not the number of transitions.  ``counts`` tallies the distinct
replays by function, as the JAX package's bridge does; ``launches`` the K1
and K2 launches they made, read from the wrappers' launch counters.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import protocol
from ..core.lease_engine import LeaseEngine
from ..device import DeviceLike, pick_device
from ..kernels.tardis_lease import kernel as lease_kernel
from .model import TransitionInfo

BACKENDS = ("numpy", "device")
# the engine kernels a replay can launch, by their wrappers' names
KERNELS = ("lease_pass", "write_advance")


def _ints(x):
    """Flatten a scalar / tuple of torch, numpy or python scalars to a
    tuple of python ints (bools stay bools)."""
    if isinstance(x, (tuple, list)):
        return tuple(_ints(v) for v in x)
    v = x.item() if isinstance(x, (torch.Tensor, np.generic)) else x
    return bool(v) if isinstance(v, bool) else int(v)


class Bridge:
    """Memoized replay of model transitions against the port's code."""

    def __init__(self, lease: int, backend: str = "numpy",
                 device: DeviceLike = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.lease = int(lease)
        self.backend = backend
        self.device = (pick_device(device) if backend == "device"
                       else torch.device("cpu"))
        self._seen = set()
        self.counts: Dict[str, int] = {}
        self.launches: Dict[str, int] = {k: 0 for k in KERNELS}

    # -- protocol scalars ---------------------------------------------------

    def _check_call(self, fname, args, expect) -> List[str]:
        got = _ints(getattr(protocol, fname)(*args))
        want = _ints(expect)
        if got != want:
            return [f"protocol.{fname}{tuple(args)} = {got}, model "
                    f"computed {want}"]
        return []

    # -- manager-table ops through the LeaseEngine --------------------------

    def _engine(self, n_blocks: int, ts_bits: int = 30) -> LeaseEngine:
        return LeaseEngine(n_blocks, self.lease, backend=self.backend,
                           ts_bits=ts_bits, device=self.device)

    def _check_read(self, wts, rts, pts, req, exp_rts, exp_pts):
        eng = self._engine(1)
        eng.set_tables([wts], [rts])
        r = eng.read([0], pts, req_wts=[req])
        errs = []
        if int(r.rts[0]) != exp_rts or int(r.new_pts) != exp_pts:
            errs.append(
                f"engine.read(wts={wts}, rts={rts}, pts={pts}) -> "
                f"rts {int(r.rts[0])}, pts {int(r.new_pts)}; model "
                f"computed rts {exp_rts}, pts {exp_pts}")
        if int(r.wts[0]) != wts:
            errs.append(f"engine.read moved wts {wts} -> {int(r.wts[0])}")
        exp_expired = _ints(protocol.shared_expired(pts, rts))
        exp_renew = _ints(protocol.renewable(req, wts))
        if bool(r.expired[0]) != exp_expired \
                or bool(r.renew_ok[0]) != exp_renew:
            errs.append(
                f"engine.read flags (expired {bool(r.expired[0])}, renew "
                f"{bool(r.renew_ok[0])}) disagree with protocol scalars "
                f"({exp_expired}, {exp_renew})")
        return errs

    def _check_write(self, wts, rts, pts, exp_ts):
        eng = self._engine(1)
        eng.set_tables([wts], [rts])
        ts = eng.write([0], pts)
        errs = []
        if int(ts) != exp_ts:
            errs.append(f"engine.write(rts={rts}, pts={pts}) -> ts {ts}; "
                        f"model computed {exp_ts}")
        if int(eng.wts[0]) != exp_ts or int(eng.rts[0]) != exp_ts:
            errs.append(f"engine.write left (wts, rts) = "
                        f"({int(eng.wts[0])}, {int(eng.rts[0])}), "
                        f"expected ({exp_ts}, {exp_ts})")
        return errs

    def _check_rebase(self, table, ts_bits, expect):
        eng = self._engine(len(table), ts_bits=ts_bits)
        eng.set_tables([w for w, _ in table], [r for _, r in table])
        shift = eng.maybe_rebase()
        errs = []
        if shift != 1 << (ts_bits - 1):
            errs.append(f"engine.maybe_rebase applied shift {shift}, "
                        f"model expected {1 << (ts_bits - 1)}")
        got = tuple((int(w), int(r)) for w, r in zip(eng.wts, eng.rts))
        if got != tuple(expect):
            errs.append(f"engine rebase left tables {got}, model computed "
                        f"{tuple(expect)}")
        return errs

    def _replay_engine_op(self, key) -> List[str]:
        op = key[0]
        before = [getattr(lease_kernel, k).launches for k in KERNELS]
        if op == "read":
            _, w, r, p, q, er, ep = key
            errs = self._check_read(w, r, p, q, er, ep)
        elif op == "write":
            _, w, r, p, ts = key
            errs = self._check_write(w, r, p, ts)
        else:                                       # rebase
            _, table, bits, expect = key
            errs = self._check_rebase(table, bits, expect)
        for k, n0 in zip(KERNELS, before):
            self.launches[k] += getattr(lease_kernel, k).launches - n0
        return errs

    # -- entry point --------------------------------------------------------

    def validate(self, info: TransitionInfo) -> List[str]:
        """Replay the transition's recorded calls; returns mismatches."""
        errs = []
        for fname, args, expect in info.calls:
            key = (fname, args)
            if key in self._seen:
                continue
            self._seen.add(key)
            self.counts[fname] = self.counts.get(fname, 0) + 1
            errs += self._check_call(fname, args, expect)
        key = info.engine_op
        if key is not None and key not in self._seen:
            self._seen.add(key)
            self.counts[f"engine.{key[0]}"] = \
                self.counts.get(f"engine.{key[0]}", 0) + 1
            errs += self._replay_engine_op(key)
        return errs
