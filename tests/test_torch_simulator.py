"""The port's coherence simulator against the JAX package's, exactly.

``repro_torch.core.simulate(..., device="cpu")`` (the plain loop of K9)
must equal ``repro.core.simulate`` in every stat (float equality),
``cycles``, ``ops``, ``aborted``, ``pts`` and each log array: the
Listing-1 litmus, every trace generator at 4 cores, the tiny-cache
geometry, each knob, a run cut by ``max_steps``, and the whole state
after 50 steps started from JAX's own ``init_state``.  The 4-core traces
are padded to one shape and run with one ``max_steps`` (so one log size),
so the JAX runner compiles once per protocol.  A CUDA lane holds K9
against the plain loop on the card (skipped where there is no card).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _sim_twin import (as_jax, as_port, assert_states_equal, pad, twin)
from repro_torch.convert import sim_state_from_jax
from repro_torch.core import Geometry, SimConfig, simulate
from repro_torch.core import simulator as TS
from repro_torch.core import traces as TTR
from repro_torch.kernels.coherence_sim import kernel as K
from repro_torch.kernels.coherence_sim.ref import sim_run_ref

try:
    from repro.core import SimConfig as JaxConfig
    from repro.core import simulator as JS
    from repro.core.geometry import Geometry as JaxGeometry
except ImportError:      # the card's machine has no JAX: the CUDA lane only
    JaxConfig = JS = JaxGeometry = None

MAX = 6000        # every 4-core run below ends within it (log size MAX)
PAD = 336         # the longest 4-core trace at scale 0.1 is 327 columns
TINY = dict(n_cores=8, l1_sets=4, l1_ways=2, llc_sets=4, llc_ways=2)


def trace4(name, scale=0.1):
    return pad(TTR.make_trace(name, 4, scale=scale), PAD)


def litmus():
    b = TTR._Builder(2)
    b.store(0, 0)
    b.load(0, 1)
    b.store(1, 1)
    b.load(1, 0)
    return b.build(4, "litmus")


def _completed(tr, res):
    assert not res.aborted, tr.name
    n_barriers = int(np.sum(tr.op_type == TTR.BARRIER))
    assert res.ops == tr.total_ops() - n_barriers


@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_litmus(proto):
    tr = litmus()
    _jres, res = twin(tr, proto, max_steps=1000)
    _completed(tr, res)
    loads = {(int(c), int(a)): int(v) for c, a, v, k in zip(
        res.log["core"], res.log["addr"], res.log["ver"], res.log["kind"])
        if k == 0}
    assert not (loads[(0, 1)] == 0 and loads[(1, 0)] == 0)


@pytest.mark.parametrize("name", sorted(TTR.TRACE_GENERATORS))
def test_generator_tardis(name):
    tr = trace4(name)
    _jres, res = twin(tr, "tardis", max_steps=MAX)
    _completed(tr, res)


@pytest.mark.parametrize("name", ["fft", "lu_c", "volrend", "water_nsq",
                                  "cholesky", "radix"])
def test_generator_directory(name):
    tr = trace4(name)
    _jres, res = twin(tr, "directory", max_steps=MAX)
    _completed(tr, res)


@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_tiny_caches(proto):
    """Small caches force LLC evictions, DRAM fills and the mts fold."""
    tr = TTR.make_trace("barnes", 8, scale=0.1)
    _jres, res = twin(tr, proto, geom=Geometry(**TINY), max_steps=20_000)
    _completed(tr, res)
    assert res.stats["n_dram"] > 0 and res.stats["n_evict_msgs"] > 0 \
        if proto == "directory" else res.stats["n_dram"] > 0


def test_ts_bits_rebases_and_kills():
    _j, res = twin(trace4("volrend"), "tardis", ts_bits=4, max_steps=MAX)
    assert res.stats["n_rebase_l1"] > 0 and res.stats["n_rebase_l2"] > 0
    assert res.stats["n_rebase_inval"] > 0


def test_estate():
    _j, base = twin(trace4("water_sp"), "tardis", max_steps=MAX)
    _j, est = twin(trace4("water_sp"), "tardis", estate=True, max_steps=MAX)
    assert est.stats["n_egrant"] > 0
    assert est.stats["n_renew"] < base.stats["n_renew"]


def test_ackwise_broadcast():
    """k = 2 pointers, and tree nodes that 3-4 cores read before one
    writes them: those invalidations broadcast to every core."""
    _j, full = twin(trace4("barnes"), "directory", max_steps=MAX)
    _j, ack = twin(trace4("barnes"), "directory", ackwise_k=2, max_steps=MAX)
    assert ack.stats["n_inv_msgs"] > full.stats["n_inv_msgs"]


def test_no_speculation():
    _j, spec = twin(trace4("volrend"), "tardis", max_steps=MAX)
    _j, res = twin(trace4("volrend"), "tardis", speculate=False,
                   max_steps=MAX)
    assert res.stats["n_misspec"] == 0 and spec.stats["n_renew"] > 0


@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_ooo_hide(proto):
    twin(trace4("ocean_c"), proto, ooo_hide=20, max_steps=MAX)


def test_private_write_opt_off():
    twin(trace4("water_sp"), "tardis", private_write_opt=False,
         max_steps=MAX)


def test_spin_workload_selfinc_period_10():
    _j, res = twin(trace4("cholesky"), "tardis", selfinc_period=10,
                   max_steps=MAX)
    assert res.stats["n_spin_polls"] > 0 and res.stats["n_selfinc"] > 0


@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_cut_by_max_steps(proto):
    _j, res = twin(trace4("fmm"), proto, max_steps=300)
    assert res.steps == 300 and res.ops < trace4("fmm").total_ops()


def _shared_geom(tr):
    """The geometry ``simulate`` gives the padded 4-core traces."""
    return dict(n_cores=4, trace_len=tr.length, log_size=MAX,
                n_addr=max(Geometry().n_addr, int(tr.n_addr)))


@pytest.mark.parametrize("proto", ["tardis", "directory"])
@pytest.mark.parametrize("name", ["fmm", "water_nsq"])
def test_whole_state_after_50_steps(proto, name):
    """Both start from JAX's ``init_state``; after 50 steps (JAX's loop cut
    by max_steps, the port's plain loop) every array of the state is
    equal, the stats too."""
    tr = trace4(name)
    gk = _shared_geom(tr)
    cfg = JaxConfig(max_steps=50).as_jnp()
    st0 = JS.init_state(JaxGeometry(**gk), as_jax(tr), cfg,
                        directory=proto == "directory")
    want = JS._get_runner(JaxGeometry(**gk), proto)(st0)
    got = sim_state_from_jax(st0)
    out = K.sim_run(got, Geometry(**gk), proto)
    assert out is got and int(got["steps"]) == 50
    assert_states_equal({k: v for k, v in sim_state_from_jax(want).items()},
                        got)


def test_init_state_matches_jax():
    tr = trace4("fft")
    gk = _shared_geom(tr)
    for proto in ("tardis", "directory"):
        st0 = JS.init_state(JaxGeometry(**gk), as_jax(tr),
                            JaxConfig().as_jnp(),
                            directory=proto == "directory")
        mine = TS.init_state(Geometry(**gk), as_port(tr),
                             SimConfig().as_tensors("cpu"),
                             directory=proto == "directory")
        ref = sim_state_from_jax(st0)
        assert_states_equal(ref, mine)
        for k, v in ref.items():
            if isinstance(v, torch.Tensor):
                assert mine[k].dtype == v.dtype, k


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(as_port(litmus()), "tardis")


def test_cpu_path_launches_nothing():
    n0 = K.sim_run.launches
    res = simulate(as_port(litmus()), "directory", log=True, device="cpu")
    assert res.ops == 4 and K.sim_run.launches == n0
    if not torch.cuda.is_available():
        assert n0 == 0


def test_sim_run_checks_its_state():
    tr = as_port(litmus())
    geom = Geometry(n_cores=2, trace_len=tr.length, log_size=0)
    st = TS.init_state(geom, tr, SimConfig().as_tensors(), directory=False)
    with pytest.raises(ValueError, match="unknown protocol"):
        K.sim_run(st, geom, "mesi")
    st["clock"] = st["clock"].to(torch.int64)
    with pytest.raises(TypeError, match="clock"):
        K.sim_run(st, geom, "tardis")
    st = TS.init_state(geom, tr, SimConfig().as_tensors(), directory=False)
    with pytest.raises(KeyError):
        K.sim_run(st, geom, "directory")        # no sharer bitmask


# --- CUDA lane: K9 against the plain loop on the card ----------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K9 has no CPU mode); run on the "
                    "card with -m cuda")
    return torch.device("cuda")


CARD_CASES = {
    "litmus/tardis": (litmus, "tardis", None, {}),
    "litmus/directory": (litmus, "directory", None, {}),
    "fft16/tardis": (lambda: TTR.make_trace("fft", 16, scale=0.1), "tardis",
                     None, {}),
    "fft16/directory": (lambda: TTR.make_trace("fft", 16, scale=0.1),
                        "directory", None, {}),
    "tiny/tardis": (lambda: TTR.make_trace("barnes", 8, scale=0.1), "tardis",
                    TINY, {}),
    "tiny/directory": (lambda: TTR.make_trace("barnes", 8, scale=0.1),
                       "directory", TINY, {}),
    "ts_bits4": (lambda: trace4("volrend"), "tardis", None, {"ts_bits": 4}),
    "estate": (lambda: trace4("water_sp"), "tardis", None, {"estate": True}),
    "ackwise2": (lambda: trace4("barnes"), "directory", None,
                 {"ackwise_k": 2}),
    "nospec": (lambda: trace4("volrend"), "tardis", None,
               {"speculate": False}),
    "period10": (lambda: trace4("cholesky"), "tardis", None,
                 {"selfinc_period": 10}),
    "cut300": (lambda: trace4("fmm"), "directory", None, {"max_steps": 300}),
    "fmm40/tardis": (lambda: TTR.make_trace("fmm", 40, scale=0.05),
                     "tardis", None, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_sim_run_matches_plain(cuda, case):
    make, proto, geom_kw, cfg_kw = CARD_CASES[case]
    tr = make()
    cfg = SimConfig(**{"max_steps": 50_000, **cfg_kw})
    geom = dataclasses.replace(
        Geometry(**(geom_kw or {"n_cores": tr.n_cores})),
        n_cores=tr.n_cores, trace_len=tr.length, log_size=4096 + 8 *
        tr.total_ops(), n_addr=max(Geometry().n_addr, int(tr.n_addr)))

    def state():
        return TS.init_state(geom, tr, cfg.as_tensors(cuda),
                             directory=proto == "directory", device=cuda)

    got, want = state(), state()
    n0 = K.sim_run.launches
    K.sim_run(got, geom, proto)
    assert K.sim_run.launches == n0 + 1
    sim_run_ref(want, geom, proto)
    torch.cuda.synchronize()
    assert_states_equal(want, got)
