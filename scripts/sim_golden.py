#!/usr/bin/env python3
"""Golden record of the JAX coherence simulator at the paper's sizes.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/sim_golden.py \
        [--out tests/data/torch_sim_golden.json] [--only KEY,...]

Runs the JAX package's simulator (on the CPU) as ``repro.core.simulate``
runs it, for

  * fig4: the 12 benchmarks at 64 cores and scale 1.0 (the generators'
    own length) under full-map MSI, Ackwise (k = 4), Tardis and Tardis
    without speculation -- 48 runs;
  * fig8: fmm, fft and lu_c at 256 cores and scale 0.08 under MSI and
    Tardis -- 6 runs;

all with ``max_steps=4_000_000`` and ``log=True``, and writes one JSON
entry a run: its spec (benchmark, cores, scale, protocol, config knobs),
every stat, ``cycles``, ``ops``, ``aborted``, ``pts``, the loop's
``steps``, the log's length and a sha256 of each log array (int32,
little-endian).  Beside it, ``tests/data/torch_sim_traces.npz`` keeps
the runs' 15 traces as the JAX package generated them: ``fmm`` and
``barnes`` draw from numpy's ``Generator.zipf``, whose samples differ
between numpy versions, so another machine's generators need not
rebuild these inputs.  The port's simulator is held to this file bit for bit
(``chip_smoke.py`` on the card; ``tests/test_torch_sim_golden.py``
re-derives the cheapest entry from JAX).  The whole file takes about
twenty minutes of one CPU.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "data" / "torch_sim_golden.json"
TRACES = ROOT / "tests" / "data" / "torch_sim_traces.npz"
TRACE_FIELDS = ("op_type", "op_addr", "op_aux", "op_think")
MAX_STEPS = 4_000_000
BENCHES = ("fmm", "barnes", "cholesky", "volrend", "ocean_c", "ocean_nc",
           "fft", "radix", "lu_c", "lu_nc", "water_nsq", "water_sp")
FIG4 = (("directory", {}), ("directory", {"ackwise_k": 4}),
        ("tardis", {}), ("tardis", {"speculate": False}))
FIG8 = ("fmm", "fft", "lu_c")


def run_specs():
    """Every golden run's spec, fig4's then fig8's."""
    specs = []
    for bench in BENCHES:
        for proto, knobs in FIG4:
            specs.append(dict(fig="fig4", bench=bench, n_cores=64, scale=1.0,
                              proto=proto, config=knobs))
    for bench in FIG8:
        for proto in ("directory", "tardis"):
            specs.append(dict(fig="fig8", bench=bench, n_cores=256,
                              scale=0.08, proto=proto, config={}))
    for s in specs:
        knobs = "".join(f",{k}={v}" for k, v in sorted(s["config"].items()))
        s["key"] = f"{s['fig']}/{s['bench']}/{s['proto']}{knobs}"
    return specs


def trace_key(spec):
    """The npz key prefix of a run's trace: ``bench/n_cores/scale``."""
    return f"{spec['bench']}/{spec['n_cores']}/{spec['scale']}"


def write_traces(path=TRACES):
    """Every golden run's trace, from the JAX package's generators."""
    from repro.core import make_trace
    arrays = {}
    for spec in run_specs():
        key = trace_key(spec)
        if f"{key}/n_addr" in arrays:
            continue
        tr = make_trace(spec["bench"], spec["n_cores"], scale=spec["scale"])
        for f in TRACE_FIELDS:
            arrays[f"{key}/{f}"] = getattr(tr, f)
        arrays[f"{key}/n_addr"] = np.int64(tr.n_addr)
    np.savez_compressed(path, **arrays)


def load_traces(trace_cls, path=TRACES):
    """{``trace_key``: ``trace_cls(op_type, op_addr, op_aux, op_think,
    n_addr, bench)``} of the stored traces."""
    with np.load(path) as z:
        keys = sorted({k.rsplit("/", 1)[0] for k in z.files})
        return {k: trace_cls(*[z[f"{k}/{f}"] for f in TRACE_FIELDS],
                             int(z[f"{k}/n_addr"]), k.split("/")[0])
                for k in keys}


def log_digest(log):
    """{array: sha256 of its int32 little-endian bytes}."""
    return {k: hashlib.sha256(np.asarray(v, "<i4").tobytes()).hexdigest()
            for k, v in sorted(log.items())}


def result_entry(res):
    """The comparable part of a ``SimResult`` (JAX's or the port's)."""
    return {"stats": {k: float(v) for k, v in res.stats.items()},
            "cycles": int(res.cycles), "ops": int(res.ops),
            "aborted": bool(res.aborted),
            "pts": [int(x) for x in np.asarray(res.pts)],
            "log_n": int(len(res.log["core"])),
            "log_sha256": log_digest(res.log)}


def jax_golden(spec):
    """One spec through the JAX package, as ``simulate`` runs it (the
    same state, the same jitted runner, the same read-back), keeping the
    loop's step count too; ``tests/test_torch_sim_golden.py`` holds an
    entry to ``simulate`` itself."""
    import dataclasses

    import jax

    from repro.core import SimConfig, make_trace
    from repro.core import simulator as S
    from repro.core.geometry import Geometry
    tr = make_trace(spec["bench"], spec["n_cores"], scale=spec["scale"])
    cfg = SimConfig(max_steps=MAX_STEPS, **spec["config"])
    log_size = int(min(cfg.max_steps, tr.total_ops() * 8 + 4096))
    geom = dataclasses.replace(Geometry(n_cores=tr.n_cores),
                               trace_len=tr.length, log_size=log_size,
                               n_addr=max(Geometry().n_addr, int(tr.n_addr)))
    st0 = S.init_state(geom, tr, cfg.as_jnp(),
                       directory=spec["proto"] == "directory")
    t0 = time.perf_counter()
    out = jax.device_get(S._get_runner(geom, spec["proto"])(st0))
    wall = time.perf_counter() - t0
    stats = {k: float(v) for k, v in out["stats"].items()}
    active = np.asarray(out["idx"]) > 0
    n = int(out["log"]["n"])
    res = S.SimResult(
        stats=stats,
        cycles=int(np.max(np.where(active, np.asarray(out["clock"]), 0))),
        ops=int(stats["ops_done"]), aborted=bool(out["aborted"]),
        pts=np.asarray(out["pts"]),
        log={k: np.asarray(v[:n]) for k, v in out["log"].items()
             if k != "n"})
    return dict(spec, **result_entry(res), steps=int(out["steps"]),
                total_ops=tr.total_ops()), wall


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--only", default=None,
                    help="comma-separated keys (default: every run, and "
                    "the traces' npz)")
    args = ap.parse_args()
    specs = run_specs()
    if args.only:
        keep = set(args.only.split(","))
        specs = [s for s in specs if s["key"] in keep]
    runs = []
    t0 = time.perf_counter()
    for s in specs:
        entry, wall = jax_golden(s)
        runs.append(entry)
        print(f"[{time.perf_counter() - t0:7.1f} s] {s['key']}: "
              f"{entry['steps']} steps, {entry['cycles']} cycles, "
              f"{wall:.1f} s", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    body = ",\n".join(json.dumps(r) for r in runs)   # one line a run
    out.write_text(f'{{"generator": "scripts/sim_golden.py", "max_steps": '
                   f'{MAX_STEPS}, "runs": [\n{body}]}}\n')
    print(f"wrote {len(runs)} runs to {out}")
    if not args.only:
        write_traces()
        print(f"wrote their traces to {TRACES}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
