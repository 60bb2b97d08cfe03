#!/usr/bin/env python3
"""K7's fp32 forward's and K12's times on one NVIDIA card, and the ssm /
hybrid training steps they serve, for this checkout or another.

    python3 scripts/ssd_train_times.py [--tree DIR] [--no-train]

K7 (the SSD chunk scan, fp32 x: training's forward) and K12 (its
backward) at zamba2-2.7b's and mamba2-130m's training shapes
(``chip_smoke.K12_ROWS``: 2 x 1024 tokens, 80 heads, P = N = 64; 8 x
1024, 24 heads, N = 128; chunk 256; x, B and C column views of one conv
output, B / C shared by the heads), each a device time a call (a CUDA
graph of calls replayed, CUDA events, median of 7;
``chip_smoke.graph_ms``) with the variant each call took where the tree
counts variants ("none" where it does not).  Unless ``--no-train``, also
``runtime.train`` on both (``chip_smoke.SSM_TRAIN``: zamba2 at full width
and depth, 4 steps of 2 x 1024 tokens; mamba2, 3 steps of 8 x 1024): ms a
warm step (the mean of the steps after the first), tokens/s, and one warm
step under ``torch.profiler``: K7's and K12's device ms and the device's
busy ms.  ``--tree DIR`` measures the port of another checkout (its
``src/`` first on the path; its kernels build into its own ``build/``),
so that two commits compare in one call: run parent, change, change,
parent.  Prints one JSON line.  Uses ``chip_smoke``'s helpers.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)


def _variant(fn, call):
    """``call()`` and the variant it took ("none" in a tree without)."""
    if not hasattr(fn, "variants"):
        call()
        return "none"
    return chip_smoke.variant_of(fn, call)[1]


def kernel_times(out):
    import torch
    from repro_torch.kernels.ssd_scan import kernel as SK
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 40)
    for _name, path, b, s, h, p, n in chip_smoke.K12_ROWS:
        xs, dt, cum, bs, cs, dy, dS, chunk = chip_smoke._ssd_train_inputs(
            g, b, s, h, p, n)
        fwd = lambda: SK.ssd_chunk(xs, dt, cum, bs, cs, chunk=chunk)
        bwd = lambda: SK.ssd_chunk_backward(xs, dt, cum, bs, cs, dy, dS,
                                            chunk=chunk)
        out[f"k7_{path}_variant"] = _variant(SK.ssd_chunk, fwd)
        out[f"k7_{path}_us"] = chip_smoke.graph_ms(fwd, 5) * 1e3
        out[f"k12_{path}_variant"] = _variant(SK.ssd_chunk_backward, bwd)
        out[f"k12_{path}_us"] = chip_smoke.graph_ms(bwd, 5) * 1e3
        del xs, dt, cum, bs, cs, dy, dS
        torch.cuda.empty_cache()


def train_times(out):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for arch, kw in chip_smoke.SSM_TRAIN.items():
        cfg = get_arch(arch)
        tag = arch.split("-")[0]
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        params = init_params(cfg, gen, torch.float32)
        opt_state = adamw.init(params)
        tc = TrainConfig(seed=chip_smoke.SEED, **kw)
        step_fn = build_step(cfg, tc)
        batch = chip_smoke._train_batch(cfg, 0, kw["batch"], kw["seq"],
                                        "cuda")
        times = []
        for _ in range(kw["steps"]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt_state, _r, _m = step_fn(params, opt_state, None,
                                                batch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        warm = times[1:]
        out[f"{tag}_step_ms"] = times
        out[f"{tag}_warm_step_ms"] = sum(warm) / len(warm)
        out[f"{tag}_tokens_per_s"] = (kw["batch"] * kw["seq"] * len(warm)
                                      / (sum(warm) / 1e3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            params, opt_state, _r, _m = step_fn(params, opt_state, None,
                                                batch)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        out[f"{tag}_profiled_busy_ms"] = sum(
            e.self_device_time_total for e in rows) / 1e3
        for key, kernel in (("k7", "ssd_chunk"), ("k12", "ssd_bwd")):
            out[f"{tag}_profiled_{key}_ms"] = sum(
                e.self_device_time_total for e in rows
                if kernel in e.key) / 1e3
        del params, opt_state, step_fn, batch, prof, rows
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="measure the port of this checkout instead")
    ap.add_argument("--no-train", action="store_true",
                    help="leave out the training steps")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("ssd_train_times: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels import _build
    _build.library()
    chip_smoke.profiler_sees_library()     # the library before the profiler
    out = {"tree": str(Path(repro_torch.__file__).parents[2]),
           "card": chip_smoke.subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    kernel_times(out)
    if not args.no_train:
        train_times(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
