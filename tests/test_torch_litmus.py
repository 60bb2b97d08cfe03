"""The litmus suite's single-host lane on the port's ``LeaseEngine``: the
twins of ``tests/test_litmus.py:326-417`` and ``:524-572``.

The classic litmus programs (SB, MP, LB, IRIW, CoRR) run every
interleaving through paper-faithful private caches over the port's engine
-- its ``"numpy"`` mirror and its ``"device"`` backend on the CPU (the
lease kernels' plain versions) -- and must produce bit for bit the
outcomes, tables and program timestamps of the JAX package's numpy
engine and of its Table I-III scalar rules, never the forbidden outcome,
with the per-load timestamp witness holding.  The same matrix runs with
decode-time re-reads, with a dual-stack paged payload whose content
encodes the version timestamp (full-row and windowed gathers checked on
every read) and under the runtime sanitizer.  The relaxed-consistency
outcome tables (TSO / RC as program-order relaxations) are enumerated on
the same lanes.  Per-wave batching: ``read_many`` / ``write_many`` are
bit-identical to the per-request path on each port backend, and the
multi-row lease pass (``masked_lease_check_many``) matches the JAX
package's scalar-composed oracle.  Programs, interleavings, the runner and
the oracles are the litmus suite's own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import LeaseEngine as JLeaseEngine
from repro.kernels.tardis_lease import ref as j_lease_ref
from repro_torch.core import LeaseEngine
from repro_torch.kernels.tardis_lease import ops as lease_ops
from repro_torch.kernels.tardis_lease import ref as lease_ref
from test_litmus import (KV_POOLS, LITMUS, N_ADDR, RELAXED_OUTCOMES,
                         EngineManager, ScalarManager, interleavings,
                         relaxed_variants, run_litmus)

PORT_BACKENDS = [dict(backend="numpy"), dict(backend="device", device="cpu")]
PORT_IDS = ["numpy", "device-cpu"]


class PortManager:
    """The litmus suite's ``EngineManager`` on the port's engine: with
    ``pools=True`` a store publishes both stacks' payload (the version
    timestamp broadcast) in one ``write_kv`` and a read checks that both
    stacks serve exactly the version the protocol names, through the
    full-row gather and each stack's windowed gather."""

    def __init__(self, lease: int, pools: bool = False,
                 sanitize: bool = False, **bkw):
        self.eng = LeaseEngine(N_ADDR, lease=lease,
                               kv_pools=KV_POOLS if pools else None,
                               kv_dtype=torch.float32,
                               sanitize=sanitize or None, **bkw)

    def read(self, addr, pts, req):
        r = self.eng.read([addr], pts, req_wts=[req])
        w = int(r.wts[0])
        if self.eng.has_kv and self.eng.kv_ok(addr):
            got = self.eng.read_kv([addr])
            for name, arr in got.items():
                assert bool((arr == w).all()), (addr, name, w, arr)
                assert torch.equal(self.eng.read_kv([addr], pool=name), arr)
        return w, int(r.rts[0]), int(r.new_pts)

    def write(self, addr, pts):
        ts = self.eng.write([addr], pts)
        if self.eng.has_kv:
            self.eng.write_kv([addr], {n: torch.full((1,) + s, float(ts))
                                       for n, s in KV_POOLS.items()})
        return ts

    def state(self):
        return self.eng.wts.tolist(), self.eng.rts.tolist()


def _lanes(lease, pools=False, sanitize=False):
    """The port's two backends and the JAX package's two oracles."""
    lanes = {f"port-{i}": (lambda bkw=bkw: PortManager(lease, pools,
                                                       sanitize, **bkw))
             for i, bkw in zip(PORT_IDS, PORT_BACKENDS)}
    lanes["jax-mirror"] = lambda: EngineManager("numpy", lease, pools,
                                                sanitize)
    lanes["jax-scalar"] = lambda: ScalarManager(lease)
    return lanes


@pytest.mark.parametrize("shape", sorted(LITMUS))
@pytest.mark.parametrize("lease,decode_reads,pools,sanitize",
                         [(1, 0, False, False), (4, 0, False, False),
                          (4, 2, False, False), (4, 2, True, False),
                          (4, 2, True, True)])
def test_litmus_forbidden_outcomes_never_observed(shape, lease,
                                                  decode_reads, pools,
                                                  sanitize):
    progs, forbidden = LITMUS[shape]
    lanes = _lanes(lease, pools, sanitize)
    for schedule in interleavings(progs):
        results = {name: run_litmus(progs, schedule, mk, decode_reads)
                   for name, mk in lanes.items()}
        regs, loads, stores, _state, _pts = results["jax-mirror"]
        for name, res in results.items():
            assert res == results["jax-mirror"], (shape, schedule, name)
        assert not forbidden(regs), (shape, schedule, regs)
        for addr, v, t in loads:
            for addr2, ts in stores:
                assert not (addr2 == addr and v < ts <= t), \
                    (shape, schedule, loads, stores)


@pytest.mark.parametrize("model", ["sc", "tso", "rc"])
@pytest.mark.parametrize("shape", sorted(LITMUS))
def test_relaxed_consistency_outcome_tables(shape, model):
    """Each model's relaxed outcome: never seen where forbidden, witnessed
    where allowed, every lane bit-identical to JAX's engine."""
    progs, forbidden = LITMUS[shape]
    allowed = RELAXED_OUTCOMES[shape][model]
    lanes = _lanes(4)
    observed = False
    for variant in relaxed_variants(progs, model):
        variant = [list(p) for p in variant]
        for schedule in interleavings(variant):
            results = {name: run_litmus(variant, schedule, mk)
                       for name, mk in lanes.items()}
            regs = results["jax-mirror"][0]
            for name, res in results.items():
                assert res == results["jax-mirror"], \
                    (shape, model, variant, schedule, name)
            if forbidden(regs):
                assert allowed, (shape, model, variant, schedule, regs)
                observed = True
                break
        if observed:
            break
    assert observed == allowed, \
        f"{shape} under {model}: relaxed outcome " \
        f"{'never witnessed' if allowed else 'observed'}"


# ---------------------------------------------------------------------------
# Per-wave batching: bit-identical to the per-request path
# ---------------------------------------------------------------------------

N_BLOCKS = 24
LEASE = 5

wave_stream = st.lists(
    st.tuples(st.booleans(),
              st.lists(st.integers(0, N_BLOCKS - 1), min_size=1, max_size=5)),
    min_size=0, max_size=6)
wave_groups = st.lists(
    st.lists(st.integers(0, N_BLOCKS - 1), min_size=1, max_size=6),
    min_size=1, max_size=4)


def _prelude(engines, stream):
    pts = 0
    for is_write, idx in stream:
        idx = sorted(set(idx))
        if is_write:
            for e in engines:
                pts = e.write(idx, pts)
        else:
            for e in engines:
                r = e.read(idx, pts)
            pts = r.new_pts
    return pts


@pytest.mark.parametrize("bkw", PORT_BACKENDS, ids=PORT_IDS)
def test_read_many_bit_identical_to_per_request_path(bkw):
    """One ``read_many`` equals the per-request reads at the wave's shared
    pts on the port's engine, and the JAX engine's ``read_many``."""

    @given(wave_stream, wave_groups, st.integers(0, 10))
    @settings(max_examples=25, deadline=None)
    def run(stream, groups, dpts):
        ek = LeaseEngine(N_BLOCKS, lease=LEASE, **bkw)
        en = LeaseEngine(N_BLOCKS, lease=LEASE, backend="numpy")
        es = LeaseEngine(N_BLOCKS, lease=LEASE, backend="numpy")
        ej = JLeaseEngine(N_BLOCKS, lease=LEASE, backend="numpy")
        pts = _prelude([ek, en, es, ej], stream) + dpts
        groups = [sorted(set(g)) for g in groups]
        req = {b: int(ek.wts[b]) - (b % 2) for g in groups for b in g}
        rk = ek.read_many(groups, pts, req_wts=req)
        en.read_many(groups, pts, req_wts=req)
        rj = ej.read_many(groups, pts, req_wts=req)
        seq_pts = [es.read(g, pts, req_wts=[req[b] for b in g]).new_pts
                   for g in groups]
        for e in (es, ej):
            np.testing.assert_array_equal(ek.wts, np.asarray(e.wts))
            np.testing.assert_array_equal(ek.rts, np.asarray(e.rts))
        assert int(rk.new_pts.max()) == int(np.max(rj.new_pts)) \
            == max(seq_pts)
        np.testing.assert_array_equal(rk.new_pts, np.asarray(rj.new_pts))
        np.testing.assert_array_equal(rk.union_idx, np.asarray(rj.union_idx))
        np.testing.assert_array_equal(rk.expired, np.asarray(rj.expired))
        np.testing.assert_array_equal(rk.renew_ok, np.asarray(rj.renew_ok))
        assert ek.stats == en.stats

    run()


@pytest.mark.parametrize("bkw", PORT_BACKENDS, ids=PORT_IDS)
def test_write_many_bit_identical_to_union_write(bkw):
    """A wave's writes fold into ONE jump-ahead over the union of its
    blocks, bit-identical to a union write and to JAX's engine."""

    @given(wave_stream, wave_groups, st.integers(0, 10))
    @settings(max_examples=25, deadline=None)
    def run(stream, groups, dpts):
        ek = LeaseEngine(N_BLOCKS, lease=LEASE, **bkw)
        es = LeaseEngine(N_BLOCKS, lease=LEASE, backend="numpy")
        ej = JLeaseEngine(N_BLOCKS, lease=LEASE, backend="numpy")
        pts = _prelude([ek, es, ej], stream) + dpts
        ops_before = ek.stats.write_ops
        tk = ek.write_many(groups, pts)
        tj = ej.write_many(groups, pts)
        union = sorted({b for g in groups for b in g})
        ts = es.write(union, pts)
        assert tk == tj == ts
        for e in (es, ej):
            np.testing.assert_array_equal(ek.wts, np.asarray(e.wts))
            np.testing.assert_array_equal(ek.rts, np.asarray(e.rts))
        assert ek.stats.write_ops == ops_before + 1

    run()


@given(st.integers(1, 4), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_multi_row_kernel_matches_scalar_oracle(n_groups, seed):
    """K1's wrapper (its plain version on CPU tensors) with per-group
    timestamps is bit-identical to the JAX package's scalar-composed
    oracle and to the port's own."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    wts = rng.integers(0, 50, n).astype(np.int32)
    rts = np.maximum(wts, rng.integers(0, 60, n)).astype(np.int32)
    req = rng.integers(-1, 50, n).astype(np.int32)
    masks = rng.integers(0, 2, (n_groups, n)).astype(np.int32)
    pts_vec = rng.integers(0, 70, n_groups).astype(np.int32)
    args = (wts, rts, req, masks, pts_vec)
    out = lease_ops.masked_lease_check_many(
        *(torch.from_numpy(a) for a in args), LEASE)
    mine = lease_ref.masked_lease_check_many_ref(
        *(torch.from_numpy(a) for a in args), LEASE)
    exp = j_lease_ref.masked_lease_check_many_ref(
        *(jnp.asarray(a) for a in args), LEASE)
    assert set(out) == set(exp) == set(mine)
    for key in exp:
        np.testing.assert_array_equal(np.asarray(out[key]),
                                      np.asarray(exp[key]), err_msg=key)
        np.testing.assert_array_equal(np.asarray(mine[key]),
                                      np.asarray(exp[key]), err_msg=key)
