"""The guarded-action model checker on the port: the twins of
``tests/test_model_check.py`` (closure, cross-validation, sensitivity, the
runtime sanitizer) on ``repro_torch.analysis``, plus a differential against
the JAX package's checker.

  * The bounded 2-core/1-block configuration closes with zero violations,
    every rule fired, and every distinct protocol call and engine op
    cross-validated against the port's ``core.protocol`` and its
    ``LeaseEngine`` -- on the port's numpy mirror and on its device
    backend on the CPU (the lease kernels' plain versions).
  * The port's explorer gives JAX's ``n_states``, ``n_transitions``,
    ``max_depth``, ``rule_counts`` and ``bridge_counts`` on the SC, TSO, RC
    and no-pw-opt lanes; the TSO lane closes 3159 states and 13049
    transitions (``scripts/model_check.py``'s figure), also through
    ``scripts/model_check_torch.py`` in a subprocess.
  * Seeded guard mutations are each found with a witness trace.
  * The port's runtime sanitizer trips on the same bug classes injected
    into a live engine, on both engine backends.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import Bridge as JBridge
from repro.analysis import Config as JConfig
from repro.analysis import TardisModel as JModel
from repro.analysis import explore as j_explore
from repro_torch.analysis import (Bridge, Config, Rules, SanitizeError,
                                  TardisModel, explore)
from repro_torch.core import LeaseEngine

ROOT = Path(__file__).resolve().parent.parent
CFG = Config(n_cores=2, n_blocks=1, lease=2, ts_bits=2)
BACKENDS = [dict(backend="numpy"), dict(backend="device", device="cpu")]
BACKEND_IDS = ["numpy", "device-cpu"]


# ---------------------------------------------------------------------------
# Closure + cross-validation (the fast lane's bounded config)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bkw", BACKENDS, ids=BACKEND_IDS)
def test_two_core_one_block_closes_and_cross_validates(bkw):
    model = TardisModel(CFG)
    bridge = Bridge(CFG.lease, **bkw)
    res = explore(model, bridge=bridge)
    assert res.closed, "state space did not close under the cap"
    assert res.ok, [str(v) for v in res.violations[:3]]
    assert res.n_states > 1000 and res.n_transitions > res.n_states
    fired = set(res.rule_counts)
    for rule in ("load_hit_s", "load_hit_e", "load_llc_s", "load_wb",
                 "load_dram", "store_hit_pw", "store_llc_s", "store_flush",
                 "store_dram", "evict_s", "evict_e", "self_inc",
                 "llc_evict", "llc_evict_owned", "rebase"):
        assert rule in fired, f"rule {rule} never fired"
    for fn in ("load_no_cache", "store_no_cache", "load_hit_shared",
               "load_hit_exclusive", "store_hit_private", "shared_expired",
               "renewable", "writeback_rts", "lease_extend", "dram_fill_ts",
               "evict_mts", "engine.read", "engine.write", "engine.rebase"):
        assert res.bridge_counts.get(fn, 0) > 0, \
            f"{fn} never cross-validated"
    # on CPU tensors the wrappers run their plain versions: no launch
    assert bridge.launches == {"lease_pass": 0, "write_advance": 0}


def test_no_pw_opt_lane_exercises_store_hit_exclusive():
    cfg = Config(n_cores=2, n_blocks=1, lease=2, ts_bits=2, pw_opt=False)
    res = explore(TardisModel(cfg), bridge=Bridge(cfg.lease))
    assert res.ok, [str(v) for v in res.violations[:3]]
    assert res.rule_counts.get("store_hit_e", 0) > 0
    assert res.bridge_counts.get("store_hit_exclusive", 0) > 0


def test_mutant_rejects_bridge():
    class Mutant(Rules):
        @staticmethod
        def renewable(req_wts, llc_wts):
            return True
    with pytest.raises(ValueError, match="mutant"):
        explore(TardisModel(CFG, rules=Mutant()), bridge=Bridge(CFG.lease))


def test_deadlock_is_reported():
    class Frozen(TardisModel):
        def successors(self, state):
            return iter(())
    res = explore(Frozen(CFG))
    assert not res.ok
    assert any(v.kind == "deadlock" for v in res.violations)


def test_bridge_rejects_an_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        Bridge(2, backend="pallas")


# ---------------------------------------------------------------------------
# The port's checker against JAX's
# ---------------------------------------------------------------------------

LANES = {"sc": {}, "tso": dict(consistency="tso"),
         "rc": dict(consistency="rc"), "no-pw-opt": dict(pw_opt=False)}


@pytest.mark.parametrize("lane", list(LANES))
def test_explore_matches_jax(lane):
    """Both port backends give JAX's counts, lane by lane."""
    kw = dict(n_cores=2, n_blocks=1, lease=2, ts_bits=2, **LANES[lane])
    want = j_explore(JModel(JConfig(**kw)), bridge=JBridge(2))
    assert want.ok
    for bkw in BACKENDS:
        got = explore(TardisModel(Config(**kw)), bridge=Bridge(2, **bkw))
        assert got.ok, [str(v) for v in got.violations[:3]]
        assert (got.n_states, got.n_transitions, got.max_depth) == \
            (want.n_states, want.n_transitions, want.max_depth), bkw
        assert got.rule_counts == want.rule_counts, bkw
        assert got.bridge_counts == want.bridge_counts, bkw
    if lane == "tso":
        assert (got.n_states, got.n_transitions) == (3159, 13049)


def test_model_check_script_closes_the_tso_lane():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "model_check_torch.py"),
         "--cores", "2", "--blocks", "1", "--lease", "2", "--ts-bits", "2",
         "--consistency", "tso", "--backend", "device", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "states: 3159  transitions: 13049" in out.stdout, out.stdout
    assert "closed: True" in out.stdout
    assert "bridge backend: device on cpu" in out.stdout
    assert "OK: state space closed" in out.stdout


# ---------------------------------------------------------------------------
# Sensitivity: seeded guard mutations must be detected, with witnesses
# ---------------------------------------------------------------------------

class DropRenewableCheck(Rules):
    """Renew any lease regardless of the requester's cached wts."""

    @staticmethod
    def renewable(req_wts, llc_wts):
        return True


class StoreNoJumpAhead(Rules):
    """Forget the ``rts + 1`` jump: a write lands inside read leases."""

    @staticmethod
    def store_no_cache(pts, wts, rts):
        ts = max(pts, rts)
        return ts, ts, ts


class LeaseBelowWts(Rules):
    """Drop the maxes in the lease extension: rts can fall below wts."""

    @staticmethod
    def lease_extend(llc_wts, llc_rts, req_pts, lease):
        return req_pts + lease


class OverPredictLease(Rules):
    """An uncapped Tardis 2.0 predictor: 8x the lease past the frontier."""

    @staticmethod
    def lease_extend(llc_wts, llc_rts, req_pts, lease):
        return max(llc_rts, llc_wts, req_pts) + 8 * lease


@pytest.mark.parametrize("rules,needle", [
    (DropRenewableCheck, "stale"),
    (StoreNoJumpAhead, "jump"),
    (LeaseBelowWts, "rts"),
    (OverPredictLease, "over-predicted"),
])
def test_seeded_mutation_is_detected_with_witness(rules, needle):
    res = explore(TardisModel(CFG, rules=rules()), max_violations=4)
    assert not res.ok, f"{rules.__name__} slipped through the checker"
    assert res.violations, "no violation recorded"
    assert any(needle in v.message for v in res.violations), \
        [v.message for v in res.violations]
    v = res.violations[0]
    assert v.state_repr
    assert str(v)


# ---------------------------------------------------------------------------
# The runtime sanitizer trips on the same bug classes, live
# ---------------------------------------------------------------------------

def _ids(idx):
    return torch.as_tensor(np.asarray(idx, np.int64))


class _RtsBelowWtsEngine(LeaseEngine):
    """LeaseBelowWts injected into the live engine."""

    def write(self, idx, pts):
        ts = super().write(idx, pts)
        self._rts[_ids(idx) if self.backend == "device"
                  else np.asarray(idx, np.int64)] = max(ts - 1, 0)
        return ts


class _BackwardsWtsEngine(LeaseEngine):
    """A write that time-travels: wts stamped below the previous value."""

    def write(self, idx, pts):
        ts = super().write(idx, pts)
        i = _ids(idx) if self.backend == "device" else np.asarray(idx,
                                                                  np.int64)
        self._wts[i] = 0
        self._rts[i] = 0
        return ts


class _OverPredictLeaseEngine(LeaseEngine):
    """OverPredictLease injected live: each read inflated past the cap."""

    def read(self, idx, pts, req_wts=None):
        r = super().read(idx, pts, req_wts=req_wts)
        i = _ids(idx) if self.backend == "device" else np.asarray(idx,
                                                                  np.int64)
        self._rts[i] += 64 * self.lease
        return r


@pytest.mark.parametrize("bkw", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("bad_engine", [_RtsBelowWtsEngine,
                                        _BackwardsWtsEngine])
def test_sanitizer_trips_on_injected_bug_during_litmus_history(bad_engine,
                                                               bkw):
    eng = bad_engine(2, lease=4, sanitize=True, **bkw)
    with pytest.raises(SanitizeError, match="TARDIS_SANITIZE"):
        pts = [0, 0]
        pts[0] = eng.write([0], pts[0])          # c0: st X
        pts[1] = eng.write([1], pts[1])          # c1: st Y
        r = eng.read([1], pts[0], req_wts=[-1])  # c0: ld Y
        pts[0] = r.new_pts
        r = eng.read([0], pts[1], req_wts=[-1])  # c1: ld X
        pts[1] = r.new_pts


@pytest.mark.parametrize("bkw", BACKENDS, ids=BACKEND_IDS)
def test_sanitizer_trips_on_over_predicted_lease(bkw):
    eng = _OverPredictLeaseEngine(2, lease=4, sanitize=True, **bkw)
    pts = eng.write([0], 0)
    r = eng.read([0], pts, req_wts=[-1])
    with pytest.raises(SanitizeError, match="over-predicted lease"):
        eng.read([0], int(r.new_pts), req_wts=[-1])


@pytest.mark.parametrize("bkw", BACKENDS, ids=BACKEND_IDS)
def test_sanitizer_clean_on_healthy_engine_and_zero_cost_off(bkw):
    eng = LeaseEngine(2, lease=4, sanitize=True, **bkw)
    pts = eng.write([0], 0)
    pts = eng.write([1], pts)
    eng.read([1], pts, req_wts=[-1])
    assert eng.sanitize_checks == 3
    off = LeaseEngine(2, lease=4, **bkw)
    assert off._san is None and off.sanitize_checks == 0


def test_sanitizer_env_var_toggle():
    env = dict(os.environ, TARDIS_SANITIZE="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    code = ("from repro_torch.core import LeaseEngine; "
            "e = LeaseEngine(2, lease=2, backend='numpy'); "
            "e.write([0], 0); "
            "assert e.sanitize_checks == 1, e.sanitize_checks; "
            "print('SANITIZED')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "SANITIZED" in out.stdout
