"""The port's simulator inputs and checkers against the JAX package's: the
trace generators byte for byte, ``check_sc`` on JAX's logs (clean and
corrupted), ``maybe_rebase`` and ``storage_bits_per_line``; and the
port's import isolation (no module of ``repro_torch`` imports JAX or the
JAX package)."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import SimConfig as JaxConfig
from repro.core import check as JC
from repro.core import simulate as jax_simulate
from repro.core import timestamps as JT
from repro.core import traces as JTR

from repro_torch.core import check as TC
from repro_torch.core import protocol as P
from repro_torch.core import timestamps as TT
from repro_torch.core import traces as TTR

ROOT = Path(__file__).resolve().parents[1]
TRACE_FIELDS = ("op_type", "op_addr", "op_aux", "op_think")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_cores", [4, 16, 64])
@pytest.mark.parametrize("name", sorted(JTR.TRACE_GENERATORS))
def test_generators_byte_identical(name, n_cores, seed):
    want = JTR.make_trace(name, n_cores, seed=seed)
    got = TTR.make_trace(name, n_cores, seed=seed)
    for f in TRACE_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.n_addr, got.name, got.total_ops()) == \
        (want.n_addr, want.name, want.total_ops())


def test_generator_names_and_op_codes():
    assert sorted(TTR.TRACE_GENERATORS) == sorted(JTR.TRACE_GENERATORS)
    assert (TTR.LOAD, TTR.STORE, TTR.SPIN, TTR.BARRIER, TTR.END) == \
        (JTR.LOAD, JTR.STORE, JTR.SPIN, JTR.BARRIER, JTR.END)


@pytest.fixture(scope="module")
def jax_logs():
    """JAX's op logs of a Tardis and a directory run (4-core fft)."""
    tr = JTR.make_trace("fft", 4, scale=0.1)
    return {p: jax_simulate(tr, p, JaxConfig(max_steps=20_000), log=True).log
            for p in ("tardis", "directory")}


def _raised(fn, log, *args):
    try:
        fn({k: v.copy() for k, v in log.items()}, *args)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("proto", ["tardis", "directory"])
def test_check_sc_accepts_jax_logs(jax_logs, proto):
    TC.check_sc(jax_logs[proto], 4)
    JC.check_sc(jax_logs[proto], 4)


def _corruptions(log):
    """(checker, corrupted log) pairs, each of which breaks one rule."""
    loads = np.nonzero(log["kind"] == 0)[0]
    stores = np.nonzero(log["kind"] == 1)[0]
    out = []
    bad = {k: v.copy() for k, v in log.items()}           # Rule 1
    c = int(bad["core"][loads[-1]])
    mine = np.nonzero(bad["core"] == c)[0]
    bad["ts"][mine[-1]] = int(bad["ts"][mine[0]]) - 1
    out.append(("check_rule1", bad))
    bad = {k: v.copy() for k, v in log.items()}           # Rule 2
    bad["ver"][loads[len(loads) // 2]] += 7
    out.append(("check_rule2", bad))
    bad = {k: v.copy() for k, v in log.items()}           # WAW order
    a = bad["addr"][stores]
    first = stores[np.nonzero(a == np.bincount(a).argmax())[0][:2]]
    bad["ver"][first] = bad["ver"][first[::-1]]
    out.append(("check_store_versions", bad))
    return out


@pytest.mark.parametrize("proto", ["tardis", "directory"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_check_sc_rejects_like_jax(jax_logs, proto, which):
    fn_name, bad = _corruptions(jax_logs[proto])[which]
    args = (4,) if fn_name == "check_rule1" else ()
    want = _raised(getattr(JC, fn_name), bad, *args)
    assert want is not None, "the corruption must break the JAX check"
    assert _raised(getattr(TC, fn_name), bad, *args) == want
    assert _raised(JC.check_sc, bad, 4) == _raised(TC.check_sc, bad, 4)


@pytest.mark.parametrize("is_private", [True, False])
@pytest.mark.parametrize("bits", [4, 8, 14])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maybe_rebase_matches_jax(is_private, bits, seed):
    rng = np.random.default_rng(seed)
    base = int(rng.integers(0, 1 << bits))
    wts = (base + rng.integers(0, 1 << (bits + 1), 64)).astype(np.int32)
    rts = (wts + rng.integers(0, 8, 64)).astype(np.int32)
    state = rng.integers(0, 3, 64).astype(np.int32)
    want = JT.maybe_rebase(jnp.int32(base), jnp.asarray(wts),
                           jnp.asarray(rts), jnp.asarray(state), bits=bits,
                           is_private=is_private)
    got = TT.maybe_rebase(base, torch.from_numpy(wts), torch.from_numpy(rts),
                          torch.from_numpy(state), bits=bits,
                          is_private=is_private)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    if seed == 0 and is_private:       # a rebase that kills happened
        assert bool(got[4]) and int(got[5]) >= 0


def test_maybe_rebase_skips_when_it_fits():
    wts = torch.tensor([3, 4], dtype=torch.int32)
    state = torch.tensor([P.SHARED, P.SHARED], dtype=torch.int32)
    nb, nw, nr, ns, need, killed = TT.maybe_rebase(
        0, wts, wts + 1, state, bits=8, is_private=True)
    assert not bool(need) and int(nb) == 0 and int(killed) == 0
    assert torch.equal(nw, wts) and torch.equal(ns, state)


@pytest.mark.parametrize("n_cores", [2, 16, 64, 256, 1000])
@pytest.mark.parametrize("scheme", ["full-map", "ackwise", "tardis"])
def test_storage_bits_matches_jax(n_cores, scheme):
    for kw in ({}, {"delta_bits": 14, "ackwise_ptrs": 2}):
        assert TT.storage_bits_per_line(n_cores, scheme, **kw) == \
            JT.storage_bits_per_line(n_cores, scheme, **kw)
    with pytest.raises(ValueError):
        TT.storage_bits_per_line(n_cores, "bogus")


def test_port_imports_without_jax():
    """Every module of repro_torch (the simulator's too) imports with
    ``jax`` and ``repro`` made unimportable."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(ROOT / "src")!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n = int(out.stdout.split()[-1])
    assert n >= 50, n
    for mod in ("core.simulator", "core.directory", "core.geometry",
                "core.traces", "core.check", "kernels.coherence_sim.kernel",
                "kernels.coherence_sim.ref"):
        assert (ROOT / "src" / "repro_torch" /
                (mod.replace(".", "/") + ".py")).exists(), mod
