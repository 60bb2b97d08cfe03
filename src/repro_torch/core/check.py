"""Sequential-consistency validation of simulator op logs (numpy, host-side).

The port's copy of ``repro.core.check``.  The two SC rules of the paper
(section II-A):

  Rule 1: per core, committed operations carry non-decreasing timestamps
          (program order implies physiological order).
  Rule 2: every load returns the value (version) of the most recent store in
          the global memory order <m, where
          X <m Y := X <ts Y or (X =ts Y and X <pt Y)
          and physical time (<pt) is the simulator's global commit sequence.

The Tardis simulator logs real logical timestamps; the directory simulator
logs its commit sequence as the timestamp, which reduces <m to physical
order -- the classic directory argument.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def check_rule1(log: Dict[str, np.ndarray], n_cores: int) -> None:
    """Timestamps are monotonically non-decreasing per core."""
    for c in range(n_cores):
        ts = log["ts"][log["core"] == c]
        if len(ts) > 1:
            bad = np.where(np.diff(ts.astype(np.int64)) < 0)[0]
            assert bad.size == 0, (
                f"Rule 1 violated on core {c}: ts decreases at op {bad[0]}"
                f" ({ts[bad[0]]} -> {ts[bad[0] + 1]})")


def check_rule2(log: Dict[str, np.ndarray]) -> None:
    """Each load observes the latest store in physiological order."""
    seq = np.arange(len(log["ts"]), dtype=np.int64)
    order = log["ts"].astype(np.int64) * (len(seq) + 1) + seq  # (ts, phys) key
    for addr in np.unique(log["addr"]):
        m = log["addr"] == addr
        kinds, vers, keys = log["kind"][m], log["ver"][m], order[m]
        stores = kinds == 1
        s_keys, s_vers = keys[stores], vers[stores]
        # sort stores by physiological order
        si = np.argsort(s_keys)
        s_keys, s_vers = s_keys[si], s_vers[si]
        for k, v, key in zip(kinds, vers, keys):
            if k == 1:
                continue
            pos = np.searchsorted(s_keys, key) - 1  # last store before load
            expect = s_vers[pos] if pos >= 0 else 0
            assert v == expect, (
                f"Rule 2 violated at addr {addr}: load observed v{v}, "
                f"expected v{expect} (physiological position {pos})")


def check_store_versions(log: Dict[str, np.ndarray]) -> None:
    """Stores to an address carry strictly increasing physiological order
    consistent with their version numbers (WAW kept in physical+logical
    order -- the paper keeps WAW correlated with physical time)."""
    seq = np.arange(len(log["ts"]), dtype=np.int64)
    for addr in np.unique(log["addr"]):
        m = (log["addr"] == addr) & (log["kind"] == 1)
        ts, vs, sq = log["ts"][m].astype(np.int64), log["ver"][m], seq[m]
        vi = np.argsort(vs)
        assert np.all(np.diff(sq[vi]) > 0), f"WAW physical order broken @ {addr}"
        assert np.all(np.diff(ts[vi]) >= 0), f"WAW ts order broken @ {addr}"


def check_sc(log: Dict[str, np.ndarray], n_cores: int) -> None:
    check_rule1(log, n_cores)
    check_store_versions(log)
    check_rule2(log)
