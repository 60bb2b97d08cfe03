"""The golden record ``tests/data/torch_sim_golden.json`` (written by
``scripts/sim_golden.py`` from the JAX simulator at the paper's sizes,
and the record ``chip_smoke.py`` holds K9 to on the card) cannot drift
from the reference: its cheapest 64-core entry is re-derived here from
``repro.core.simulate`` and from the port's plain loop, each equal to the
file bit for bit, and each stored trace (``torch_sim_traces.npz``, the
inputs the card runs) equals what the JAX package's generators and the
port's build here."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import sim_golden  # noqa: E402

GOLDEN = json.loads(sim_golden.OUT.read_text())


def _cheapest():
    runs = [r for r in GOLDEN["runs"] if r["n_cores"] == 64]
    return min(runs, key=lambda r: (r["steps"], r["proto"] != "tardis",
                                    r["key"]))


def _assert_entry(entry, res):
    got = sim_golden.result_entry(res)
    for k in ("stats", "cycles", "ops", "aborted", "pts", "log_n",
              "log_sha256"):
        assert got[k] == entry[k], k


def test_golden_covers_fig4_and_fig8():
    keys = [r["key"] for r in GOLDEN["runs"]]
    assert keys == [s["key"] for s in sim_golden.run_specs()]
    assert len(keys) == 54 and GOLDEN["max_steps"] == sim_golden.MAX_STEPS
    assert not any(r["aborted"] for r in GOLDEN["runs"])


@pytest.mark.parametrize("key", sorted({sim_golden.trace_key(s)
                                         for s in sim_golden.run_specs()}))
def test_stored_trace_is_the_references(key):
    from repro.core.traces import make_trace as jax_make_trace
    from repro_torch.core.traces import Trace, make_trace
    stored = sim_golden.load_traces(Trace)[key]
    bench, n_cores, scale = key.split("/")
    for make in (jax_make_trace, make_trace):
        tr = make(bench, int(n_cores), scale=float(scale))
        assert tr.n_addr == stored.n_addr
        for f in sim_golden.TRACE_FIELDS:
            a, b = getattr(tr, f), getattr(stored, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (key, f)


def _run(make_trace, simulate, config_cls, entry, **kw):
    tr = make_trace(entry["bench"], entry["n_cores"], scale=entry["scale"])
    cfg = config_cls(max_steps=GOLDEN["max_steps"], **entry["config"])
    return simulate(tr, entry["proto"], cfg, log=True, **kw)


def test_cheapest_entry_rederived_from_jax():
    from repro.core import SimConfig, make_trace, simulate
    entry = _cheapest()
    _assert_entry(entry, _run(make_trace, simulate, SimConfig, entry))


def test_cheapest_entry_from_the_port():
    from repro_torch.core import SimConfig, make_trace, simulate
    entry = _cheapest()
    res = _run(make_trace, simulate, SimConfig, entry, device="cpu")
    _assert_entry(entry, res)
    assert res.steps == entry["steps"]
