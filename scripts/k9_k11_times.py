#!/usr/bin/env python3
"""K9's and K11's times on one NVIDIA card, for this checkout or another.

    python3 scripts/k9_k11_times.py [--tree DIR]

K11 (the RMSNorm backward) at the training path's rows, (4096, 2048)
fp32, plain and add: its device time a call (a CUDA graph of 20 calls
replayed, CUDA events, median of 7) and its two kernels' device times
(``torch.profiler`` over 20 calls: the rows with their dw partials, then
the partials' sum).  K9 (the simulator's whole loop): one launch (CUDA
events, median of 5, the card kept busy while the host prepares it) on
fft at 16 cores and scale 0.1 under Tardis, fig4/fft/tardis (64 cores)
and fig8/fft/tardis (256 cores) from the stored golden traces, with the
variant each took (a tree without variants: "none"); then ``simulate``'s
wall time over all 54 golden runs (log on, as ``chip_smoke.py`` phase 3
runs them; no SC check).  ``--tree DIR`` measures the port of another
checkout (its ``src/`` first on the path; its kernels build into its own
``build/``), so that two commits compare in one call.  Prints one JSON
line.  Uses ``chip_smoke``'s timing helpers.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)


def k11_times(out):
    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    r, d = 4096, 2048

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x, dy, dh = randn(r, d), randn(r, d), randn(r, d)
    w = 1 + 0.1 * randn(d)
    for variant, h in (("plain", None), ("add", dh)):
        def call(h=h):
            return RK.rmsnorm_backward(x, w, dy, dh=h)
        split = chip_smoke.k11_kernel_times(call)
        out[f"k11_{variant}_us"] = chip_smoke.graph_ms(call) * 1e3
        out[f"k11_{variant}_rows_us"] = split["rows"] * 1e3
        out[f"k11_{variant}_dw_us"] = split["dw"] * 1e3


def k9_times(out):
    import torch
    from repro_torch.core import SimConfig, Trace, make_trace, simulate
    from repro_torch.kernels.coherence_sim import kernel as CK
    sys.path.insert(0, str(ROOT / "scripts"))
    from sim_golden import load_traces, trace_key
    has_variants = "variant" in inspect.signature(CK.sim_run).parameters
    golden = json.loads(chip_smoke.SIM_GOLDEN.read_text())
    traces = load_traces(Trace)
    runs = {"fft16": make_trace("fft", 16, scale=0.1)}
    for key in ("fig4/fft/tardis", "fig8/fft/tardis"):
        entry = next(e for e in golden["runs"] if e["key"] == key)
        runs[key] = traces[trace_key(entry)]
    for label, tr in runs.items():
        geom, state = chip_smoke._sim_case_state(tr, "tardis")
        times = []
        for _ in range(5):
            st = state()
            torch.cuda.synchronize()
            torch.cuda._sleep(chip_smoke.K9_SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            CK.sim_run(st, geom, "tardis")
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        steps = int(st["steps"])
        out[f"k9_{label}"] = dict(
            ms=sorted(times)[2], steps=steps,
            us_per_step=sorted(times)[2] / steps * 1e3,
            variant=CK.pick_variant(geom) if has_variants else "none")
    wall, steps = 0.0, 0
    for entry in golden["runs"]:
        cfg = SimConfig(max_steps=golden["max_steps"], **entry["config"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(traces[trace_key(entry)], entry["proto"], cfg,
                       log=True)
        wall += time.perf_counter() - t0
        steps += res.steps
    out["simulate_54"] = dict(wall_ms=wall * 1e3, steps=steps,
                              us_per_step=wall / steps * 1e6)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="measure the port of this checkout instead")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("k9_k11_times: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import _build
    _build.library()
    out = {"tree": str(Path(repro_torch.__file__).parents[2]),
           "card": chip_smoke.subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    k11_times(out)
    k9_times(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
