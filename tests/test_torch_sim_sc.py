"""Twins of the reference's SC tests on the port's simulator (CPU, the
plain loop of K9): ``tests/test_simulator_sc.py`` (its 8 tests, at its
own sizes), ``tests/test_sc_random.py`` (its 2 property tests, fewer
examples, each also held to JAX's final state) and
``tests/test_estate.py`` (its 3 tests).  The checks are the port's own
``repro_torch.core.check``."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _sim_twin import as_jax, assert_states_equal
from repro_torch.convert import sim_state_from_jax
from repro_torch.core import Geometry, SimConfig, make_trace, simulate
from repro_torch.core import simulator as TS
from repro_torch.core.check import check_sc
from repro_torch.core.traces import END, LOAD, STORE, Trace, _Builder
from repro_torch.kernels.coherence_sim.kernel import sim_run

from repro.core import SimConfig as JaxConfig
from repro.core import simulator as JS
from repro.core.geometry import Geometry as JaxGeometry

N = 16
CFG = dict(max_steps=1_200_000)
CPU = dict(device="cpu")


# --- tests/test_simulator_sc.py ---------------------------------------------

def _litmus_trace():
    b = _Builder(2)
    b.store(0, 0)
    b.load(0, 1)
    b.store(1, 1)
    b.load(1, 0)
    return b.build(4, "litmus")


@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_litmus_no_a0_b0(proto):
    """Paper Listing 1: printing A=B=0 violates SC and must never happen."""
    tr = _litmus_trace()
    res = simulate(tr, proto, SimConfig(**CFG), log=True, **CPU)
    assert not res.aborted and res.ops == 4
    check_sc(res.log, 2)
    loads = {(int(c), int(a)): int(v) for c, a, v, k in zip(
        res.log["core"], res.log["addr"], res.log["ver"], res.log["kind"])
        if k == 0}
    assert not (loads[(0, 1)] == 0 and loads[(1, 0)] == 0)


@pytest.mark.parametrize("name", ["fft", "volrend", "water_nsq", "barnes",
                                  "lu_c", "ocean_c"])
@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_sc_on_workloads(name, proto):
    tr = make_trace(name, N, scale=0.3)
    res = simulate(tr, proto, SimConfig(**CFG), log=True, **CPU)
    assert not res.aborted, f"{name}/{proto} did not complete"
    assert res.ops == tr.total_ops() - np.sum(tr.op_type == 3)  # barriers
    check_sc(res.log, N)


def test_sc_under_tiny_caches():
    """Small caches force evictions + DRAM mts path; SC must still hold."""
    tr = make_trace("barnes", 8, scale=0.3)
    geom = Geometry(n_cores=8, l1_sets=4, l1_ways=2, llc_sets=4, llc_ways=2)
    res = simulate(tr, "tardis", SimConfig(**CFG), geom=geom, log=True, **CPU)
    assert not res.aborted
    assert res.stats["n_dram"] > 0              # evictions actually happened
    check_sc(res.log, 8)


def test_sc_with_compression_rebase():
    """4-bit deltas roll over constantly; rebase must preserve SC."""
    tr = make_trace("volrend", 8, scale=0.4)
    res = simulate(tr, "tardis", SimConfig(ts_bits=4, **CFG), log=True, **CPU)
    assert not res.aborted
    assert res.stats["n_rebase_l1"] > 0
    check_sc(res.log, 8)


def test_sc_without_private_write_opt():
    tr = make_trace("water_sp", 8, scale=0.3)
    res = simulate(tr, "tardis", SimConfig(private_write_opt=False, **CFG),
                   log=True, **CPU)
    assert not res.aborted
    check_sc(res.log, 8)


def test_spin_consumer_observes_update():
    """Livelock avoidance: a spinning reader eventually sees the write."""
    b = _Builder(2)
    b.store(0, 5)                  # producer writes flag (version 1)
    b.lock_acquire(1, 5)
    b.ops[1][-1] = (2, 5, 1, 0)    # spin until version >= 1
    tr = b.build(8, "spin")
    res = simulate(tr, "tardis", SimConfig(selfinc_period=10, **CFG),
                   log=True, **CPU)
    assert not res.aborted
    assert res.stats["n_selfinc"] >= 0
    check_sc(res.log, 2)


def test_protocols_agree_on_final_memory():
    """Both protocols execute every store of the trace exactly once."""
    tr = make_trace("lu_c", 8, scale=0.3)
    r1 = simulate(tr, "tardis", SimConfig(**CFG), log=True, **CPU)
    r2 = simulate(tr, "directory", SimConfig(**CFG), log=True, **CPU)
    finals = []
    for log in (r1.log, r2.log):
        stores = log["kind"] == 1
        last = {}
        for a, v in zip(log["addr"][stores], log["ver"][stores]):
            last[int(a)] = max(last.get(int(a), 0), int(v))
        finals.append(last)
    assert finals[0] == finals[1]
    s1 = np.sum(r1.log["kind"] == 1)
    s2 = np.sum(r2.log["kind"] == 1)
    assert s1 == s2 == np.sum(tr.op_type == 1)


def test_ackwise_limited_directory():
    tr = make_trace("lu_c", N, scale=0.3)
    full = simulate(tr, "directory", SimConfig(**CFG), **CPU)
    ack = simulate(tr, "directory", SimConfig(ackwise_k=4, **CFG), **CPU)
    assert not ack.aborted
    # broadcast mode costs at least as much invalidation traffic
    assert ack.stats["n_inv_msgs"] >= full.stats["n_inv_msgs"]


# --- tests/test_sc_random.py -------------------------------------------------

N_CORES = 4
LEN = 24          # fixed trace length
N_ADDR = 8
# one log size for every example (the JAX runner then compiles once per
# protocol): 8 slots an op, as ``simulate`` sizes it, for the longest
# program
FUZZ_GEOM = dict(n_cores=N_CORES, trace_len=LEN,
                 log_size=N_CORES * (LEN - 1) * 8 + 4096)

op = st.tuples(st.integers(0, 1),                 # load/store
               st.integers(0, N_ADDR - 1),        # address
               st.integers(0, 3))                 # think cycles

program = st.lists(st.lists(op, min_size=1, max_size=LEN - 1),
                   min_size=N_CORES, max_size=N_CORES)


def _build(prog) -> Trace:
    t = np.full((N_CORES, LEN), END, np.int32)
    a = np.zeros((N_CORES, LEN), np.int32)
    x = np.zeros((N_CORES, LEN), np.int32)
    k = np.zeros((N_CORES, LEN), np.int32)
    for c, ops in enumerate(prog):
        for j, (kind, addr, think) in enumerate(ops):
            t[c, j] = STORE if kind else LOAD
            a[c, j] = addr
            k[c, j] = think
    return Trace(t, a, x, k, N_ADDR, "fuzz")


def _against_jax(tr, proto, **cfg):
    """The whole final state from JAX's ``init_state``: JAX's loop and the
    port's plain loop, equal."""
    jst0 = JS.init_state(JaxGeometry(**FUZZ_GEOM), as_jax(tr),
                         JaxConfig(**cfg).as_jnp(),
                         directory=proto == "directory")
    want = JS._get_runner(JaxGeometry(**FUZZ_GEOM), proto)(jst0)
    got = sim_run(sim_state_from_jax(jst0), Geometry(**FUZZ_GEOM), proto)
    assert_states_equal(sim_state_from_jax(want), got)


@given(program, st.sampled_from([1, 3, 10, 100]),
       st.sampled_from([2, 10, 50]))
@settings(max_examples=12, deadline=None)
def test_random_programs_are_sequentially_consistent(prog, lease, period):
    tr = _build(prog)
    cfg = dict(lease=lease, selfinc_period=period, max_steps=50_000)
    res = simulate(tr, "tardis", SimConfig(**cfg), log=True, **CPU)
    assert not res.aborted
    check_sc(res.log, N_CORES)
    _against_jax(tr, "tardis", **cfg)


@given(program)
@settings(max_examples=6, deadline=None)
def test_random_programs_directory_consistent(prog):
    tr = _build(prog)
    res = simulate(tr, "directory", SimConfig(max_steps=50_000), log=True,
                   **CPU)
    assert not res.aborted
    check_sc(res.log, N_CORES)
    _against_jax(tr, "directory", max_steps=50_000)


# --- tests/test_estate.py ----------------------------------------------------

ECFG = dict(max_steps=900_000)


def test_estate_preserves_sc_and_cuts_renewals():
    tr = make_trace("water_sp", 8, scale=0.3)
    base = simulate(tr, "tardis", SimConfig(**ECFG), log=True, **CPU)
    est = simulate(tr, "tardis", SimConfig(estate=True, **ECFG), log=True,
                   **CPU)
    check_sc(base.log, 8)
    check_sc(est.log, 8)
    assert est.stats["n_egrant"] > 0
    assert est.stats["n_renew"] < base.stats["n_renew"]
    assert est.stats["traffic"] < base.stats["traffic"]


def test_estate_sc_under_write_sharing():
    """E-granted lines must flush correctly when another core writes."""
    tr = make_trace("water_nsq", 8, scale=0.3)
    est = simulate(tr, "tardis", SimConfig(estate=True, **ECFG), log=True,
                   **CPU)
    assert not est.aborted
    check_sc(est.log, 8)


def test_estate_sc_spin_workload():
    tr = make_trace("volrend", 8, scale=0.3)
    est = simulate(tr, "tardis", SimConfig(estate=True, **ECFG), log=True,
                   **CPU)
    assert not est.aborted
    check_sc(est.log, 8)


def test_init_state_keys_match_jax():
    """The port's state has JAX's keys, shapes and dtypes (bools as
    torch.bool) for both protocols."""
    tr = _build([[(1, 0, 0)]] * N_CORES)
    for proto in ("tardis", "directory"):
        jst = sim_state_from_jax(JS.init_state(
            JaxGeometry(**FUZZ_GEOM), as_jax(tr), JaxConfig().as_jnp(),
            directory=proto == "directory"))
        mine = TS.init_state(Geometry(**FUZZ_GEOM), tr,
                             SimConfig().as_tensors(),
                             directory=proto == "directory")
        assert_states_equal(jst, mine)
