"""CoherencePolicy on the port: the twins of the 13 tests of
``tests/test_coherence_policy.py``.

The policy dataclass (defaults, predictor bounds, the grow / shrink step
rules, validation) and ``resolve_policy`` are driven with the same calls as
the JAX package's and compared; the port's serving cluster takes
``policy=`` silently and the legacy ``kv_lease=`` / ``ts_bits=`` with a
``DeprecationWarning``; its ``CoherenceReport`` keeps the flat keys beside
the typed groups.  The adaptive-lease state machine -- growth on wasted
renewals, shrink on writes, survival across ``ts_bits`` rebases, the
sharded directory against one engine, the prediction travelling with a
migrated page -- runs on the port's engines and is held number for number
to JAX's driven with the same calls; the predictor is bit-identical on the
port's device backend (on the CPU: the lease kernels' plain versions) and
its numpy mirror."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import CoherencePolicy as JPolicy
from repro.core import LeaseEngine as JEngine
from repro.core import ShardedLeaseDirectory as JDirectory
from repro.core.policy import resolve_policy as j_resolve_policy
from repro_torch.core import (CONSISTENCY_MODELS, CoherencePolicy,
                              LeaseEngine, ShardedLeaseDirectory)
from repro_torch.core.policy import resolve_policy

POOLS = {"k": (1, 2), "v": (1, 2)}


def _page(val):
    return {n: torch.full((1,) + s, float(val)) for n, s in POOLS.items()}


def _j_page(val):
    return {n: np.full((1,) + s, val, np.float32) for n, s in POOLS.items()}


def _same_policy(a, b):
    """A port policy and a JAX one carry the same fields."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# The dataclass: defaults, bounds, step rules, validation
# ---------------------------------------------------------------------------

def test_policy_static_bounds_collapse_to_lease():
    p, jp = CoherencePolicy(lease=16), JPolicy(lease=16)
    _same_policy(p, jp)
    assert (p.lease_min, p.lease_max) == (16, 16)
    assert not p.predictor and p.consistency == "sc"
    assert not p.skip_expired_renewal()
    assert p.grow(16) == jp.grow(16) == 16
    assert p.shrink(16) == jp.shrink(16) == 16


def test_policy_predictor_default_and_explicit_bounds():
    p = CoherencePolicy(lease=16, predictor=True)
    _same_policy(p, JPolicy(lease=16, predictor=True))
    assert (p.lease_min, p.lease_max) == (4, 128)
    kw = dict(lease=16, predictor=True, lease_min=2, lease_max=32)
    q, jq = CoherencePolicy(**kw), JPolicy(**kw)
    assert (q.lease_min, q.lease_max) == (2, 32)
    for cur in range(1, 40):
        assert q.grow(cur) == jq.grow(cur), cur
        assert q.shrink(cur) == jq.shrink(cur), cur
    assert q.grow(32) == 32 and q.grow(20) == 32
    assert q.shrink(2) == 2 and q.shrink(5) == 2
    r = q.with_(consistency="tso")
    _same_policy(r, jq.with_(consistency="tso"))
    assert r.skip_expired_renewal() and q.consistency == "sc"
    leg = CoherencePolicy.from_legacy(lease=8, ts_bits=12)
    _same_policy(leg, JPolicy.from_legacy(lease=8, ts_bits=12))
    assert leg.ts_bits == 12


@pytest.mark.parametrize("kw,match", [
    (dict(consistency="weak"), "consistency"),
    (dict(lease=0), "lease must be"),
    (dict(lease=4, lease_min=8, predictor=True), "lease_min <= lease"),
    (dict(lease=4, lease_max=2, predictor=True), "lease_min <= lease"),
    (dict(ts_bits=1), "ts_bits"),
])
def test_policy_validation_rejects_bad_configs(kw, match):
    with pytest.raises(ValueError, match=match):
        CoherencePolicy(**kw)
    with pytest.raises(ValueError, match=match):
        JPolicy(**kw)
    assert set(CONSISTENCY_MODELS) == {"sc", "tso", "rc"}


def test_resolve_policy_precedence():
    given = CoherencePolicy(lease=5)
    assert resolve_policy(given, lease=99, ts_bits=4) is given
    folded = resolve_policy(None, lease=7, ts_bits=9)
    _same_policy(folded, j_resolve_policy(None, lease=7, ts_bits=9))
    assert (folded.lease, folded.ts_bits) == (7, 9)
    kw = dict(lease=None, ts_bits=None, default_lease=21, default_ts_bits=11)
    defaulted = resolve_policy(None, **kw)
    _same_policy(defaulted, j_resolve_policy(None, **kw))
    assert (defaulted.lease, defaulted.ts_bits) == (21, 11)


# ---------------------------------------------------------------------------
# Serving-cluster API: policy= is first class, legacy kwargs one release out
# ---------------------------------------------------------------------------

def _tiny_cluster(**kw):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import init_params
    from repro_torch.runtime import ServingCluster

    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                  vocab=128)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    return ServingCluster(cfg, lambda: params, device="cpu", **kw)


def test_legacy_kv_lease_kwarg_deprecated_but_working():
    with pytest.warns(DeprecationWarning, match="kv_lease=/ts_bits="):
        cluster = _tiny_cluster(n_replicas=1, prefix_block_tokens=4,
                                kv_lease=32)
    assert cluster.policy.lease == 32
    assert cluster.prefix_engine.lease == 32
    with pytest.warns(DeprecationWarning):
        cluster = _tiny_cluster(n_replicas=1, prefix_block_tokens=4,
                                ts_bits=12)
    assert cluster.policy.ts_bits == 12


def test_policy_kwarg_is_silent_and_exclusive():
    pol = CoherencePolicy(consistency="tso", lease=32, predictor=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        cluster = _tiny_cluster(n_replicas=1, prefix_block_tokens=4,
                                policy=pol)
    assert cluster.policy is pol
    assert cluster.prefix_engine.policy is pol
    with pytest.raises(ValueError, match="not both"):
        _tiny_cluster(n_replicas=1, prefix_block_tokens=4,
                      policy=pol, kv_lease=16)


def test_coherence_report_typed_accessors_keep_flat_keys():
    pol = CoherencePolicy(consistency="tso", lease=16, predictor=True)
    cluster = _tiny_cluster(n_replicas=1, prefix_block_tokens=4, policy=pol)
    rep = cluster.coherence_report()
    assert isinstance(rep, dict)
    assert rep["consistency"] == "tso"
    assert rep["kv_lease"] == 16
    lease = rep.lease
    assert lease["consistency"] == "tso"
    assert {"renewals", "decode_renewals_skipped", "pred_grows",
            "pred_shrinks"} <= set(lease)
    assert all(k in rep for k in lease)
    for group in (rep.xhost, rep.role, rep.router):
        assert isinstance(group, dict)
        for k in group:
            assert not k.startswith(("xhost_", "role_", "router_"))


# ---------------------------------------------------------------------------
# Predictor state machine on one engine, held to JAX's
# ---------------------------------------------------------------------------

def _pol_kw(**kw):
    kw.setdefault("lease", 4)
    kw.setdefault("predictor", True)
    kw.setdefault("lease_min", 1)
    kw.setdefault("lease_max", 64)
    return kw


def _pol(**kw):
    return CoherencePolicy(**_pol_kw(**kw))


class Twin:
    """The port's engine and JAX's numpy engine driven with the same calls;
    every result, table and prediction compared after each."""

    def __init__(self, n, pol_kw, **bkw):
        bkw.setdefault("backend", "numpy")
        self.t = LeaseEngine(n, policy=CoherencePolicy(**pol_kw), **bkw)
        self.j = JEngine(n, policy=JPolicy(**pol_kw), backend="numpy")

    def _check(self):
        np.testing.assert_array_equal(self.t.wts, np.asarray(self.j.wts))
        np.testing.assert_array_equal(self.t.rts, np.asarray(self.j.rts))
        np.testing.assert_array_equal(self.t.pred_lease,
                                      np.asarray(self.j.pred_lease))

    def write(self, idx, pts):
        a, b = self.t.write(idx, pts), self.j.write(idx, pts)
        assert int(a) == int(b)
        self._check()
        return a

    def read(self, idx, pts, req_wts=None):
        a = self.t.read(idx, pts, req_wts=req_wts)
        b = self.j.read(idx, pts, req_wts=req_wts)
        for f in ("expired", "renew_ok", "wts", "rts"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
        assert int(a.new_pts) == int(b.new_pts)
        self._check()
        return a

    def maybe_rebase(self):
        a, b = self.t.maybe_rebase(), self.j.maybe_rebase()
        assert a == b
        self._check()
        return a


def test_predictor_grows_on_wasted_renewal_shrinks_on_write():
    tw = Twin(4, _pol_kw())
    eng = tw.t
    pts = tw.write([0], 0)
    assert int(eng.pred_lease[0]) == _pol().shrink(4) == 2
    r = tw.read([0], pts, req_wts=[-1])
    assert int(eng.pred_lease[0]) == 2
    wts = int(r.wts[0])
    expect = 2
    for _ in range(3):
        pts = int(r.rts[0]) + 1
        r = tw.read([0], pts, req_wts=[wts])
        expect = _pol().grow(expect)
        assert int(eng.pred_lease[0]) == expect
    assert eng.stats.pred_grows == tw.j.stats.pred_grows == 3
    pts = tw.write([0], int(r.new_pts))
    assert int(eng.pred_lease[0]) == _pol().shrink(expect)
    assert eng.stats.pred_shrinks == tw.j.stats.pred_shrinks == 2
    r = tw.read([0], pts, req_wts=[wts])
    assert not bool(r.renew_ok[0])
    assert int(eng.pred_lease[0]) == _pol().shrink(expect)
    rep, jrep = eng.report(), tw.j.report()
    assert rep["pred_grows"] == jrep["pred_grows"] == 3
    assert rep["pred_shrinks"] == jrep["pred_shrinks"] == 2
    assert (rep["pred_lease_lo"], rep["pred_lease_hi"]) == \
        (jrep["pred_lease_lo"], jrep["pred_lease_hi"])
    assert rep["pred_lease_lo"] <= rep["pred_lease_hi"]


def test_predictor_off_is_bit_identical_to_static():
    a = LeaseEngine(4, lease=4, backend="numpy")
    tw = Twin(4, dict(lease=4))
    b = tw.t
    pa = pb = 0
    for step in range(12):
        if step % 3 == 0:
            pa = a.write([step % 4], pa)
            pb = tw.write([step % 4], pb)
        else:
            ra = a.read([step % 4], pa, req_wts=[-1])
            rb = tw.read([step % 4], pb, req_wts=[-1])
            pa, pb = int(ra.new_pts), int(rb.new_pts)
    np.testing.assert_array_equal(a.wts, b.wts)
    np.testing.assert_array_equal(a.rts, b.rts)
    assert b.stats.pred_grows == 0 and b.stats.pred_shrinks == 0


def test_predictor_survives_ts_bits_rebase():
    tw = Twin(4, _pol_kw(ts_bits=8))
    eng = tw.t
    pts = tw.write([0], 300)
    r = tw.read([0], pts, req_wts=[-1])
    wts = int(r.wts[0])
    for _ in range(2):
        r = tw.read([0], int(r.rts[0]) + 1, req_wts=[wts])
    pred_before = eng.pred_lease.copy()
    assert int(pred_before[0]) == 8
    wts_before, rts_before = eng.wts.copy(), eng.rts.copy()
    shift = tw.maybe_rebase()
    assert shift > 0
    np.testing.assert_array_equal(eng.pred_lease, pred_before)
    np.testing.assert_array_equal(
        eng.wts, np.maximum(0, wts_before.astype(np.int64) - shift))
    np.testing.assert_array_equal(
        eng.rts, np.maximum(0, rts_before.astype(np.int64) - shift))
    tw.read([0], int(eng.rts[0]) + 1, req_wts=[int(eng.wts[0])])
    assert int(eng.pred_lease[0]) == 16


# ---------------------------------------------------------------------------
# Predictor across the sharded directory
# ---------------------------------------------------------------------------

def test_sharded_predictor_matches_single_engine_oracle():
    """Random wave streams under the predictor: the port's directory
    tracks one port engine driven with the same per-owner-shard batches,
    and JAX's directory driven with the same waves, wave by wave."""
    rng = np.random.default_rng(11)
    kw = _pol_kw(lease=4, lease_max=32)
    pol = CoherencePolicy(**kw)
    d = ShardedLeaseDirectory(16, 4, n_hosts=2, policy=pol, backend="numpy",
                              device="cpu")
    jd = JDirectory(16, 4, n_hosts=2, policy=JPolicy(**kw), backend="numpy")
    oracle = LeaseEngine(16, policy=pol, backend="numpy")
    pts = 0
    for step in range(50):
        host = step % 2
        if rng.random() < 0.3:
            bids = sorted(rng.choice(16, rng.integers(1, 4),
                                     replace=False).tolist())
            res = d.wave(host, pts, write_bids=bids, tag_writes_with_ts=True)
            jres = jd.wave(host, pts, write_bids=bids,
                           tag_writes_with_ts=True)
            for s in sorted({d.owner(b) for b in bids}):
                oracle.write([b for b in bids if d.owner(b) == s], pts)
        else:
            bids = sorted(rng.choice(16, rng.integers(1, 5),
                                     replace=False).tolist())
            req = {b: int(oracle.wts[b]) for b in bids}
            res = d.wave(host, pts, read_groups=[bids], req_wts=req)
            jres = jd.wave(host, pts, read_groups=[bids], req_wts=req)
            for s in sorted({d.owner(b) for b in bids}):
                part = [b for b in bids if d.owner(b) == s]
                oracle.read(part, pts, req_wts=[req[b] for b in part])
        assert int(res.new_pts) == int(jres.new_pts)
        pts = res.new_pts + int(rng.integers(0, 10))
        for want in (oracle, jd):
            np.testing.assert_array_equal(d.pred_lease,
                                          np.asarray(want.pred_lease))
            np.testing.assert_array_equal(d.wts, np.asarray(want.wts))
            np.testing.assert_array_equal(d.rts, np.asarray(want.rts))
    grows = sum(e.stats.pred_grows for e in d.shards)
    shrinks = sum(e.stats.pred_shrinks for e in d.shards)
    assert grows == oracle.stats.pred_grows > 0
    assert shrinks == oracle.stats.pred_shrinks > 0
    assert d.report()["xhost_pred_grows"] == grows \
        == jd.report()["xhost_pred_grows"]


def test_pred_lease_travels_with_page_migration():
    """A migrated page carries the owner's learned lease, on the port's
    directory as on JAX's driven with the same calls."""
    kw = _pol_kw(lease=4, lease_max=64)
    common = dict(n_hosts=2, backend="numpy", block_bytes=16, sanitize=True)
    d = ShardedLeaseDirectory(8, 2, policy=CoherencePolicy(**kw),
                              kv_pools=POOLS, kv_dtype=torch.float32,
                              device="cpu", **common)
    jd = JDirectory(8, 2, policy=JPolicy(**kw), kv_pools=POOLS,
                    kv_dtype=np.float32, **common)
    res = d.wave(0, 0, write_bids=[1], write_tags=[7])
    jres = jd.wave(0, 0, write_bids=[1], write_tags=[7])
    ts = res.write_ts[1]
    assert ts == jres.write_ts[1]
    d.defer_publish(0, 1, _page(ts))
    jd.defer_publish(0, 1, _j_page(float(ts)))
    d.flush_deferred(0)
    jd.flush_deferred(0)
    pts = ts
    for _ in range(3):
        r = d.wave(0, pts, read_groups=[[1]], req_wts={1: ts})
        jr = jd.wave(0, pts, read_groups=[[1]], req_wts={1: ts})
        assert r.leases[1] == tuple(int(x) for x in jr.leases[1])
        pts = r.leases[1][1] + 1
    assert int(d.pred_lease[1]) > _pol().shrink(4)
    assert int(d.pred_lease[1]) == int(np.asarray(jd.pred_lease)[1])
    res = d.wave(1, pts, fetch_bids=[1])
    jres = jd.wave(1, pts, fetch_bids=[1])
    page = res.fetched[1]
    assert page.pred_lease == int(d.pred_lease[1]) \
        == jres.fetched[1].pred_lease
    assert (page.wts, page.rts) == res.leases[1]
    dest = LeaseEngine(8, policy=_pol(lease=4, lease_max=8),
                       backend="numpy")
    dest.set_pred_lease([1], page.pred_lease)
    assert int(dest.pred_lease[1]) == min(8, page.pred_lease)


# ---------------------------------------------------------------------------
# Device backend vs mirror: the predictor is backend-invariant
# ---------------------------------------------------------------------------

def test_predictor_bit_identical_device_vs_numpy():
    """The port's device backend (on the CPU: the lease kernels' plain
    versions) and its numpy mirror, and JAX's numpy engine, on one
    script."""
    kw = _pol_kw(lease=4, lease_max=32)
    engines = {"device": LeaseEngine(8, policy=CoherencePolicy(**kw),
                                     backend="device", device="cpu"),
               "numpy": LeaseEngine(8, policy=CoherencePolicy(**kw),
                                    backend="numpy"),
               "jax": JEngine(8, policy=JPolicy(**kw), backend="numpy")}
    rng = np.random.default_rng(3)
    script = []
    pts = 0
    for step in range(16):
        idx = sorted(rng.choice(8, 2, replace=False).tolist())
        if step % 4 == 0:
            script.append(("write", idx, pts))
            pts += 5
        else:
            script.append(("read", idx, pts))
            pts += int(rng.integers(0, 9))
    for eng in engines.values():
        wts_seen = np.full(8, -1, np.int64)
        for op, idx, p in script:
            if op == "write":
                eng.write(idx, p)
                wts_seen[idx] = -1
            else:
                r = eng.read(idx, p, req_wts=wts_seen[idx].tolist())
                wts_seen[idx] = np.asarray(r.wts, np.int64)
    a = engines["device"]
    for name in ("numpy", "jax"):
        b = engines[name]
        np.testing.assert_array_equal(np.asarray(a.wts), np.asarray(b.wts))
        np.testing.assert_array_equal(np.asarray(a.rts), np.asarray(b.rts))
        np.testing.assert_array_equal(a.pred_lease, np.asarray(b.pred_lease))
        assert a.stats.pred_grows == b.stats.pred_grows > 0
        assert a.stats.pred_shrinks == b.stats.pred_shrinks > 0

