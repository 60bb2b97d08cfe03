#!/usr/bin/env python3
"""Launches per decode step of the PyTorch port, on one NVIDIA card.

    python3 scripts/step_launches.py [--tree DIR] [--dump FILE]

For each serving path at full width and depth -- paged tinyllama-1.1b
(``decode_step_paged``), and the wave path of tinyllama-1.1b and
zamba2-2.7b (``decode_step``) -- one warm decode step with random bf16
weights: the device kernels it runs (``torch.profiler``), K8's launches
by variant and the step's median time (CUDA events around 5 eager steps,
3 times: the card idles most of a step, so this is the host's time); and
the device kernels of one K1 lease pass at the serving table (4608
blocks, 4 groups).  ``--tree DIR`` measures the port of
another checkout (its ``src/`` first on the path; its kernels build into
its own ``build/``), so that two commits compare in one run.  Prints one
JSON line; ``--dump`` also writes each step's kernels by name to FILE.
Uses ``chip_smoke.decode_step_launches`` and ``chip_smoke.device_kernels``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

PATHS = (("paged", "tinyllama-1.1b"), ("wave", "tinyllama-1.1b"),
         ("wave", "zamba2-2.7b"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="measure the port of this checkout instead")
    ap.add_argument("--dump", default=None,
                    help="write each step's device kernels by name here")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("step_launches: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.tardis_lease import kernel as K
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": str(Path(repro_torch.__file__).parents[2]),
           "card": torch.cuda.get_device_name(0)}
    by_name = {}
    for path, arch in PATHS:
        cfg = get_arch(arch)
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        params = init_params(cfg, gen, torch.bfloat16)
        _counts, norms, kernels, ms = chip_smoke.decode_step_launches(
            cfg, params, path)
        out[f"{path} {arch}"] = dict(device_kernels=sum(kernels.values()),
                                     rmsnorm=norms, step_ms=ms)
        by_name[f"{path} {arch}"] = kernels
        del params
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    n, grp = 4608, 4
    wts = randint(0, 1000, (n,))
    rts = wts + randint(0, 200, (n,))
    masks = (randint(0, 8, (grp, n)) == 0).to(torch.int32)
    pts = randint(0, 1200, (grp,))
    out["lease_pass kernels"] = chip_smoke.device_kernels(
        lambda: K.lease_pass(wts, rts, wts, masks, pts, 64))
    print(json.dumps(out), flush=True)
    if args.dump:
        Path(args.dump).write_text(json.dumps(by_name, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
