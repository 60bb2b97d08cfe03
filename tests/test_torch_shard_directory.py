"""The port's ShardedLeaseDirectory against the JAX package's, op stream for
op stream: each test of ``tests/test_shard_directory.py:52-303`` drives both
directories with the same calls (a ``Twin``) and holds every result and,
after every call, the whole state bit-identical -- the reassembled ``wts``
/ ``rts`` / ``pred_lease`` tables, content tags and versions, ``DirStats``,
each shard's ``LeaseStats``, home pools and validity bits, the wave log,
the write-behind queues and watches, and the flit sizes each wave handed
its transport -- on two lanes: JAX's ``"numpy"`` directory against the
port's ``"numpy"`` one, and JAX's ``"pallas"`` (interpret mode) against
the port's ``"device"`` one on the CPU (its kernels' plain versions).  The
two-host cluster twin holds the port's fleet (both directory backends) to
JAX's fleet and to a single-host cluster.  The numpy mirrors of the
collectives are held against JAX's.  The ``cuda`` lane holds a
``"device"`` directory on the card against one on the CPU."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitize import SanitizeError
from repro_torch.core import shard_directory as TD
from repro_torch.dist import collectives as TC

try:
    import jax
    import jax.numpy as jnp
    from repro.analysis.sanitize import SanitizeError as JSanitizeError
    from repro.core import LeaseEngine as JEngine
    from repro.core import shard_directory as JD
    from repro.dist import collectives as JC
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

N_BLOCKS = 16
N_SHARDS = 4
LEASE = 6
POOLS = {"k": (1, 2), "v": (1, 2)}
# (JAX directory backend, port directory backend)
LANES = [("numpy", "numpy"), ("pallas", "device")]
LANE_IDS = ["numpy", "device"]


def _page(val):
    return {n: np.full((1,) + s, val, np.float32) for n, s in POOLS.items()}


def _recording(base):
    """``base`` transport that also logs every exchange's (src, sizes)."""
    class Recording(base):
        def __init__(self, n_hosts):
            super().__init__(n_hosts)
            self.log = []

        def exchange(self, src, sizes):
            self.log.append((int(src), np.asarray(sizes).tolist()))
            return super().exchange(src, sizes)
    return Recording


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _same(a, b, what="result"):
    """A JAX-side value and its port-side twin, equal to the bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "dtype"):
        x, y = _np(a), _np(b)
        assert x.shape == y.shape, (what, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=what)
    else:
        assert a == b, (what, a, b)


def _same_state(j, t):
    for name in ("wts", "rts", "pred_lease", "tags", "wver"):
        _same(getattr(j, name), getattr(t, name), name)
    _same(j.stats, t.stats, "stats")
    for k in ("ts_shift", "rebases", "wave_log", "_watch", "_notify_ready",
              "_pending"):
        _same(getattr(j, k), getattr(t, k), k)
    _same(j.transport.log, t.transport.log, "transport sizes")
    assert j.transport.routes == t.transport.routes
    assert j.report() == t.report()
    for s, (je, te) in enumerate(zip(j.shards, t.shards)):
        _same(dataclasses.asdict(je.stats), dataclasses.asdict(te.stats),
              f"shard {s} stats")
        if je.has_kv:
            _same(je._kv_pool, te._kv_pool, f"shard {s} home pool")
            _same(je._kv_valid, te._kv_valid, f"shard {s} validity")


class Twin:
    """The JAX directory and the port's, driven with the same calls; every
    method call returns the port's result after holding it, and the whole
    state after it, equal to JAX's."""

    def __init__(self, lane, n_hosts=2, pools=False, **kw):
        jb, tb = lane
        kw.setdefault("lease", LEASE)
        common = dict(n_hosts=n_hosts, kv_pools=POOLS if pools else None,
                      block_bytes=16 if pools else 0, sanitize=True, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.j = JD.ShardedLeaseDirectory(
                N_BLOCKS, N_SHARDS, backend=jb, kv_dtype=np.float32,
                transport=_recording(JD.NumpyTransport)(n_hosts), **common)
        self.t = TD.ShardedLeaseDirectory(
            N_BLOCKS, N_SHARDS, backend=tb, kv_dtype=torch.float32,
            device="cpu",
            transport=_recording(TD.NumpyTransport)(n_hosts), **common)
        _same_state(self.j, self.t)

    def __getattr__(self, name):
        jf, tf = getattr(self.j, name), getattr(self.t, name)

        def call(*args, **kw):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                jr = jf(*args, **kw)
            tr = tf(*args, **kw)
            _same(jr, tr, name)
            _same_state(self.j, self.t)
            return tr
        return call


needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")
lanes = pytest.mark.parametrize("lane", LANES, ids=LANE_IDS)


# ---------------------------------------------------------------------------
# Protocol equivalence: sharding never changes the tables
# ---------------------------------------------------------------------------

@needs_jax
@lanes
def test_directory_tables_match_single_engine_oracle(lane):
    """Random wave streams: both directories agree with each other and
    with ONE engine driven with the same batches partitioned by owner
    shard."""
    rng = np.random.default_rng(7)
    d = Twin(lane, n_hosts=2)
    oracle = JEngine(N_BLOCKS, lease=LEASE, backend="numpy")
    pts = 0
    for step in range(60):
        host = step % 2
        if rng.random() < 0.35:
            bids = sorted(rng.choice(N_BLOCKS, rng.integers(1, 5),
                                     replace=False).tolist())
            res = d.wave(host, pts, write_bids=bids,
                         tag_writes_with_ts=True)
            exp_ts = {}
            for s in sorted({d.t.owner(b) for b in bids}):
                part = [b for b in bids if d.t.owner(b) == s]
                ts = oracle.write(part, pts)
                exp_ts.update({b: ts for b in part})
            assert res.write_ts == exp_ts
            pts = res.new_pts
            assert pts == max(exp_ts.values())
        else:
            groups = [sorted(rng.choice(N_BLOCKS, rng.integers(1, 6),
                                        replace=False).tolist())
                      for _ in range(rng.integers(1, 4))]
            req = {b: int(oracle.wts[b]) - int(rng.integers(0, 2))
                   for g in groups for b in g}
            res = d.wave(host, pts, read_groups=groups, req_wts=req)
            for g, bids in enumerate(groups):
                for s in sorted({d.t.owner(b) for b in bids}):
                    part = [b for b in bids if d.t.owner(b) == s]
                    r = oracle.read(part, pts,
                                    req_wts=[req[b] for b in part])
                    for j, b in enumerate(part):
                        assert res.leases[b] == (int(r.wts[j]),
                                                 int(r.rts[j]))
                    assert res.group_pts[g] >= r.new_pts
            pts = res.new_pts
        np.testing.assert_array_equal(d.t.wts, oracle.wts)
        np.testing.assert_array_equal(d.t.rts, oracle.rts)
    assert d.t.stats.multicasts == 0
    assert d.t.stats.invalidation_msgs == 0


@needs_jax
@lanes
def test_wave_message_invariant_one_pair_per_owner_shard(lane):
    d = Twin(lane, n_hosts=N_SHARDS)      # shard s lives on host s
    res = d.wave(0, 0, read_groups=[[0, 1, 2, 3]],
                 write_bids=[4, 5, 6, 7], tag_writes_with_ts=True)
    assert res.shards_contacted == 3
    assert res.msgs == 6
    assert d.t.stats.req_msgs == 3 and d.t.stats.rep_msgs == 3
    res = d.wave(0, res.new_pts, read_groups=[[0, 4, 8, 12]])
    assert res.msgs == 0 and res.shards_contacted == 0
    assert d.max_msgs_per_wave() == 6
    assert d.t.stats.flits > 0 and d.t.stats.wire_bytes > d.t.stats.flits


@needs_jax
@lanes
def test_transport_routes_every_remote_wave(lane):
    d = Twin(lane, n_hosts=2)
    assert isinstance(d.t.transport, TD.NumpyTransport)
    d.wave(0, 0, read_groups=[[1]])            # shard 1 -> host 1: remote
    d.wave(0, 1, read_groups=[[0]])            # shard 0: local, no route
    assert d.t.transport.routes == 1


# ---------------------------------------------------------------------------
# Timestamp-ordered page migration + write-behind publishing
# ---------------------------------------------------------------------------

@needs_jax
@lanes
def test_page_migration_round_trip(lane):
    d = Twin(lane, pools=True)
    res = d.wave(0, 0, write_bids=[1], write_tags=[77])
    ts = res.write_ts[1]
    assert int(d.t.tags[1]) == 77 and not d.home_ok(1)
    d.defer_publish(0, 1, _page(ts))
    assert not d.home_ok(1)
    d.flush_deferred(0)
    assert d.home_ok(1) and d.t.stats.publishes == 1
    res = d.wave(1, ts, fetch_bids=[1])        # host 1 borrows the page
    page = res.fetched[1]
    assert (page.wts, page.rts) == res.leases[1]
    assert page.tag == 77 and page.wver == int(d.t.wver[1])
    for name, arr in page.blocks.items():
        assert isinstance(arr, torch.Tensor)   # never through numpy
        np.testing.assert_array_equal(arr.numpy(), _page(ts)[name])
    assert d.t.stats.migrations == 1


@needs_jax
@lanes
def test_stale_publish_dropped_on_retag(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[2], write_tags=[5])
    d.defer_publish(0, 2, _page(1.0))
    d.wave(1, 9, write_bids=[2], write_tags=[6])   # re-tag underneath
    d.flush_deferred(0)
    assert d.t.stats.publishes_dropped == 1
    assert d.t.stats.publishes == 0 and not d.home_ok(2)


@needs_jax
@lanes
def test_publish_barrier_invalidates_home_and_drops_queued(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[1], write_tags=[3])
    d.defer_publish(0, 1, _page(1.0))
    d.flush_deferred(0)
    assert d.home_ok(1)
    d.wave(0, 5, write_bids=[5], write_tags=[4])
    d.defer_publish(0, 5, _page(2.0))
    ver = d.t.wver.copy()
    d.publish_barrier()
    assert not d.home_ok(1)
    np.testing.assert_array_equal(d.t.wver, ver + 1)
    d.flush_deferred(0)
    assert d.t.stats.publishes_dropped == 1


@needs_jax
@lanes
def test_pending_publishes_ride_the_next_wave(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[1], write_tags=[9])
    d.defer_publish(0, 1, _page(3.0))
    flits_before = d.t.stats.flits
    res = d.wave(0, 3, read_groups=[[1]])      # organic wave to shard 1
    assert d.home_ok(1)
    assert d.t.stats.publishes == 1
    assert res.msgs == 2
    assert d.t.stats.flits > flits_before + 2


@needs_jax
@lanes
def test_subscribe_notifies_on_publish_install(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[1, 2], write_tags=[9, 8])
    d.defer_publish(0, 1, _page(3.0))
    d.defer_publish(0, 2, _page(4.0))
    landed = d.subscribe(1, [1, 2], tags=[9, 8])
    assert landed == [] and d.t.stats.watches == 2
    assert d.pop_notifications(1) == []
    d.flush_deferred(0)
    assert sorted(d.pop_notifications(1)) == [1, 2]
    assert d.t.stats.notifies == 2
    assert d.pop_notifications(1) == []
    for w in d.t.wave_log:
        if w["kind"] in ("watch", "notify"):
            assert w["msgs"] <= 2 * max(1, len(w["shards"]))


@needs_jax
@lanes
def test_subscribe_returns_already_home_gids_without_watching(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[3], write_tags=[7])
    d.defer_publish(0, 3, _page(1.0))
    d.flush_deferred(0)
    watches = d.t.stats.watches
    msgs = d.t.stats.msgs
    assert d.subscribe(1, [3], tags=[7]) == [3]
    assert d.t.stats.watches == watches
    assert d.t.stats.msgs == msgs


@needs_jax
@lanes
def test_subscribe_tag_mismatch_drops_notify(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[2], write_tags=[5])
    assert d.subscribe(1, [2], tags=[4]) == []
    d.defer_publish(0, 2, _page(2.0))
    d.flush_deferred(0)
    assert d.pop_notifications(1) == []
    for side in (d.j, d.t):
        with pytest.raises(ValueError, match="align"):
            side.subscribe(1, [2], tags=[4, 5])
    _same_state(d.j, d.t)


@needs_jax
@lanes
def test_maybe_rebase_shifts_all_shards_uniformly(lane):
    d = Twin(lane, ts_bits=8)
    res = d.wave(0, 300, write_bids=list(range(N_BLOCKS)),
                 tag_writes_with_ts=True)
    assert res.new_pts >= 1 << 8
    before_w = d.t.wts.copy()
    shift = d.maybe_rebase()
    assert shift > 0 and d.t.rebases == 1
    np.testing.assert_array_equal(d.t.wts, np.maximum(before_w - shift, 0))
    assert d.t.ts_shift == shift
    assert all(e.ts_shift == shift for e in d.t.shards)


# ---------------------------------------------------------------------------
# Migration sanitizer: the three bug classes raise, with JAX's messages
# ---------------------------------------------------------------------------

@needs_jax
@lanes
def test_sanitizer_double_publish_raises(lane):
    d = Twin(lane, pools=True)
    d.wave(0, 0, write_bids=[1], write_tags=[2])
    d.defer_publish(0, 1, _page(1.0))
    for side, err in ((d.j, JSanitizeError), (d.t, SanitizeError)):
        with pytest.raises(err, match="double publish"):
            side.defer_publish(0, 1, _page(1.0))
    _same_state(d.j, d.t)


@needs_jax
@lanes
def test_sanitizer_tampered_carry_raises(lane):
    d = Twin(lane, pools=True)
    for side, mod, err in ((d.j, JD, JSanitizeError),
                           (d.t, TD, SanitizeError)):
        page = mod.FetchedPage(gid=1, wts=10, rts=20, tag=3, wver=0,
                               blocks=_page(1.0))
        with pytest.raises(err, match="migrated under"):
            side._msan.check_carried(page, (11, 20), 3)
        with pytest.raises(err, match="content tag"):
            side._msan.check_carried(page, (10, 20), 4)


@needs_jax
@lanes
def test_sanitizer_use_after_migrate_raises(lane):
    d = Twin(lane, pools=True)
    for side, err in ((d.j, JSanitizeError), (d.t, SanitizeError)):
        san = side._msan
        san.mark_installed(1, 7, tag=5)
        san.on_use(1, 7, 5)
        with pytest.raises(err, match="use-after-migrate"):
            san.on_use(1, 7, 6)
        san.on_invalidate(1, 7)
        with pytest.raises(err, match="never installed"):
            san.on_use(1, 7, 5)
    assert d.j._msan.checks == d.t._msan.checks


# ---------------------------------------------------------------------------
# Broadcast counterfactual
# ---------------------------------------------------------------------------

@needs_jax
@lanes
def test_broadcast_baseline_prices_the_multicast_tardis_never_sends(lane):
    d = Twin(lane, n_hosts=4)
    for i in range(8):
        d.wave(i % 4, i * 10, write_bids=[i], tag_writes_with_ts=True)
    base = d.broadcast_baseline()
    assert base["writes"] == 8
    assert base["bcast_inv_msgs"] == 8 * 3 * 2
    assert base["tardis_inv_msgs"] == 0
    assert base["bcast_inv_bytes"] > 0
    rep = d.report()
    assert rep["xhost_multicasts"] == 0
    assert rep["xhost_invalidation_msgs"] == 0


# ---------------------------------------------------------------------------
# End-to-end: 2 hosts serve JAX's tokens, and the same tokens as 1 host
# ---------------------------------------------------------------------------

KW = dict(n_replicas=1, prefix_block_tokens=4, kv_lease=16, cache_len=96,
          selfinc_period=4, n_decode_pages=64, max_pages=16, max_batch=2)


@functools.lru_cache(maxsize=None)
def _tiny():
    from repro.configs import get_arch, reduced
    from repro.models import init_params
    from repro_torch.configs import get_arch as t_get_arch
    from repro_torch.configs import reduced as t_reduced
    from repro_torch.convert import params_from_jax
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                  vocab=128)
    tcfg = t_reduced(t_get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                     vocab=128)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def _requests(Request, vocab, n, shared=12, tail=6, max_new=2):
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, shared).astype(np.int32)
    return [Request(i, np.concatenate(
        [system, rng.integers(1, vocab, tail).astype(np.int32)]),
        max_new=max_new) for i in range(n)]


def _int_counters(rep):
    return {k: v for k, v in rep.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)}


@functools.lru_cache(maxsize=None)
def _jax_two_host_run():
    from repro.runtime import MultiHostServingCluster as JMulti
    from repro.runtime import Request as JRequest
    cfg, _tcfg, params, _tp = _tiny()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mh = JMulti(cfg, lambda: params, n_hosts=2, sanitize=True, **KW)
        reqs = _requests(JRequest, cfg.vocab, 4)
        mh.run(reqs[:2], affinity=[0, 0])
        _, rep = mh.run(reqs[2:], affinity=[1, 1])
    return [r.output for r in reqs], rep


@needs_jax
@pytest.mark.parametrize("dir_backend", ["numpy", "device"])
def test_two_host_cluster_matches_single_host_tokens(dir_backend):
    """Host 0 prefills and publishes the shared prefix, host 1 serves it
    suffix-only from migrated pages: the port's fleet (either directory
    backend) gives JAX's fleet's tokens and every integer counter, and a
    single-host cluster's tokens."""
    from repro_torch.runtime import MultiHostServingCluster, Request
    from repro_torch.runtime import ServingCluster
    _cfg, tcfg, _p, tparams = _tiny()
    jout, jrep = _jax_two_host_run()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mh = MultiHostServingCluster(tcfg, lambda: tparams, n_hosts=2,
                                     sanitize=True, device="cpu",
                                     dir_backend=dir_backend, **KW)
    reqs = _requests(Request, tcfg.vocab, 4)
    mh.run(reqs[:2], affinity=[0, 0])
    _, rep = mh.run(reqs[2:], affinity=[1, 1])
    assert rep["host1_prefix_prefill_tokens_skipped"] > 0
    assert rep["host1_xhost_pages_fetched"] > 0
    assert rep["xhost_multicasts"] == 0
    assert rep["xhost_invalidation_msgs"] == 0
    assert rep["xhost_max_msgs_per_wave"] <= \
        2 * max(1, rep["xhost_max_shards_per_wave"])
    for a, b in zip(jout, reqs):
        np.testing.assert_array_equal(np.asarray(a), b.output,
                                      err_msg=f"request {b.rid} vs JAX")
    assert _int_counters(jrep) == _int_counters(rep)
    assert sorted(jrep) == sorted(rep)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        single = ServingCluster(tcfg, lambda: tparams, device="cpu", **KW)
    sreqs = _requests(Request, tcfg.vocab, 4)
    single.run(sreqs[:2])
    single.run(sreqs[2:])
    for a, b in zip(reqs, sreqs):
        assert a.done and b.done
        np.testing.assert_array_equal(a.output, b.output,
                                      err_msg=f"request {a.rid}")


# ---------------------------------------------------------------------------
# The numpy mirrors of the collectives
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("name", ["np_psum", "np_all_gather",
                                  "np_reduce_scatter", "np_all_to_all"])
def test_numpy_collectives_match_jax(name):
    rng = np.random.default_rng(3)
    for n, rows in ((4, 4), (4, 8), (2, 6), (1, 3)):
        shards = [rng.integers(-9, 9, (rows, 3)).astype(np.int64)
                  for _ in range(n)]
        jout = getattr(JC, name)(shards)
        tout = getattr(TC, name)(shards)
        assert len(jout) == len(tout) == n
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(a, b)
    if name in ("np_reduce_scatter", "np_all_to_all"):
        bad = [np.zeros((3, 2))] * 2
        for mod in (JC, TC):
            with pytest.raises(ValueError, match="not divisible"):
                getattr(mod, name)(bad)


# ---------------------------------------------------------------------------
# The card: a "device" directory on the card against one on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


def _card_state(d):
    out = {k: getattr(d, k) for k in ("wts", "rts", "pred_lease", "tags",
                                      "wver")}
    out["stats"] = dataclasses.asdict(d.stats)
    out["shards"] = [dataclasses.asdict(e.stats) for e in d.shards]
    out["pools"] = [e._kv_pool.cpu() for e in d.shards]
    out["valid"] = [e._kv_valid.copy() for e in d.shards]
    out["log"] = list(d.wave_log)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_directory_matches_cpu_directory(cuda, dtype):
    """Writes, reads, publishes, fetches and a forced rebase on a
    ``"device"`` directory on the card and one on the CPU: identical
    tables, stats and pool bits after every op, and every migrated page
    bit-identical (the card's through K1-K3)."""
    from repro_torch import kernels
    pools = {"dense": (16, 2, 8, 64), "moe": (16, 2, 4, 112)}
    dirs = {dev: TD.ShardedLeaseDirectory(
        64, 4, n_hosts=3, lease=5, ts_bits=4, kv_pools=pools,
        kv_dtype=dtype, block_bytes=1024, sanitize=True, device=dev)
        for dev in ("cpu", cuda)}
    rng = np.random.default_rng(11)
    kernels.reset_launch_counts()
    pts = {h: 0 for h in range(3)}
    for step in range(40):
        host = step % 3
        op = rng.choice(["write", "read", "publish", "fetch"])
        bids = sorted({int(b) for b in rng.integers(0, 64, 4)})
        res = {}
        pages = {n: torch.randn((1,) + s, generator=torch.Generator()
                                .manual_seed(step)).to(dtype)
                 for n, s in pools.items()}
        for dev, d in dirs.items():
            if op == "write":
                res[dev] = d.wave(host, pts[host], write_bids=bids,
                                  write_tags=[step * 100 + b for b in bids])
            elif op == "publish":
                b = bids[0]
                if d.tags[b] >= 0:
                    d.defer_publish(host, b, {n: p.to(dev)
                                              for n, p in pages.items()})
                d.flush_deferred(host)
            else:
                fetch = [b for b in bids if d.home_ok(b)] \
                    if op == "fetch" else []
                res[dev] = d.wave(host, pts[host], read_groups=[bids],
                                  req_wts={b: int(d.wts[b]) for b in bids},
                                  fetch_bids=fetch)
        if res:
            a, b = res["cpu"], res[cuda]
            assert (a.new_pts, a.leases, a.write_ts, a.renew_ok) == \
                (b.new_pts, b.leases, b.write_ts, b.renew_ok)
            assert sorted(a.fetched) == sorted(b.fetched)
            for g in a.fetched:
                for n in pools:
                    x, y = a.fetched[g].blocks[n], b.fetched[g].blocks[n]
                    assert y.device.type == "cuda"
                    assert torch.equal(x, y.cpu()), (step, g, n)
            pts[host] = a.new_pts
        shifts = {d.maybe_rebase() for d in dirs.values()}
        assert len(shifts) == 1
        shift = shifts.pop()
        pts = {h: max(0, p - shift) for h, p in pts.items()}
        sa, sb = _card_state(dirs["cpu"]), _card_state(dirs[cuda])
        for k in sa:
            if k in ("pools",):
                for x, y in zip(sa[k], sb[k]):
                    assert torch.equal(x, y), (step, k)
            else:
                _same(sa[k], sb[k], f"step {step} {k}")
    assert dirs[cuda].rebases > 0
    counts = kernels.launch_counts()
    for name in ("lease_pass", "write_advance", "row_copy.gather",
                 "row_copy.scatter"):
        assert counts[name] > 0, (name, counts)
