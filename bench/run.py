"""Run one benchmark cell once on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration and its
traffic mix are looked up by name in ``BENCHMARK.json`` and under
``bench/``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks`` last: each number the
correctness check compared, beside its limit).  The checks also end
standard error.  Exits non-zero with no result where there is no card, or
fewer cards than the cell asks for.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux's
    /proc; elsewhere: now)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """Caches of builds and kernels inside the checkout, at fixed paths;
    the port's sources and the benchmark's own modules importable."""
    cache = ROOT / "build" / "bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "bench"))
    sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    import harness
    bench = harness.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"the cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START,
                           bench=bench)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"modules loaded in the run's process: {loaded}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in out["checks"].items():
        side = "at least" if c.get("at_least") else "limit"
        print(f"check {name}: {c['value']} ({side} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
