#!/usr/bin/env python3
"""K6's, K10's and K3's times on one NVIDIA card, for this checkout or
another.

    python3 scripts/k6_k3_times.py [--tree DIR] [--no-train]

K6 (flash prefill) at the training shape (B 4, S 1024, 32 / 4 heads, Dh
64, fp32, causal) with and without its LSE write, and at the tinyllama
wave prompt in bf16 (B 4, S 3072); K10 (its backward) at the training
shape; K3 (the pool's row gather and scatter) at ``chip_smoke.py``'s
serving shapes (4 whole pool blocks of 16 x 11264 bf16; one decode
step's 8 token rows); the library's empty kernel where the tree has one.
Each is a device time a call (a CUDA graph of calls replayed, CUDA
events, median of 7; ``chip_smoke.graph_ms``), with the K6 variant each
call took where the tree counts variants ("none" where it does not).
Unless ``--no-train``, also ``runtime.train`` on full tinyllama-1.1b in
fp32 (4 steps of 4 x 1024 tokens, as ``chip_smoke.py`` phase 3): ms a
warm step (the mean of steps 2-4) and K6's device ms in one profiled
step.  ``--tree DIR`` measures the port of another checkout (its
``src/`` first on the path; its kernels build into its own ``build/``),
so that two commits compare in one call: run parent, change, change,
parent.  Prints one JSON line.  Uses ``chip_smoke``'s timing helpers.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)


def _variant(fk, call):
    """``call()`` and the K6 variant it took ("none" in a tree without)."""
    if not hasattr(fk.flash_prefill, "variants"):
        call()
        return "none"
    return chip_smoke.variant_of(fk.flash_prefill, call)[1]


def k6_k10_times(out):
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    b, s, h, hkv, dh = 4, 1024, 32, 4, 64
    q, k, v, do = (randn(b, s, h, dh), randn(b, s, hkv, dh),
                   randn(b, s, hkv, dh), randn(b, s, h, dh))
    out["k6_train_variant"] = _variant(
        FK, lambda: FK.flash_prefill(q, k, v, return_lse=True))
    out["k6_train_lse_us"] = chip_smoke.graph_ms(
        lambda: FK.flash_prefill(q, k, v, return_lse=True), 5) * 1e3
    out["k6_train_us"] = chip_smoke.graph_ms(
        lambda: FK.flash_prefill(q, k, v), 5) * 1e3
    o, lse = FK.flash_prefill(q, k, v, return_lse=True)
    out["k10_train_us"] = chip_smoke.graph_ms(
        lambda: FK.flash_backward(q, k, v, o, do, lse=lse), 5) * 1e3
    del q, k, v, do, o, lse
    s = 3072
    q, k, v = (randn(b, s, h, dh).bfloat16(), randn(b, s, hkv, dh).bfloat16(),
               randn(b, s, hkv, dh).bfloat16())
    out["k6_tinyllama_bf16_variant"] = _variant(
        FK, lambda: FK.flash_prefill(q, k, v))
    out["k6_tinyllama_bf16_us"] = chip_smoke.graph_ms(
        lambda: FK.flash_prefill(q, k, v), 5) * 1e3
    del q, k, v
    torch.cuda.empty_cache()


def k3_times(out):
    import torch
    from repro_torch.kernels.tardis_lease import kernel as K
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    n_blocks, chunk, token_row = 4608, 16, 11264
    pool = torch.randn((n_blocks, chunk * token_row), generator=g,
                       device="cuda").to(torch.bfloat16)
    bids = torch.randint(0, 4096, (4,), generator=g, device="cuda",
                         dtype=torch.int32)
    view = pool.view(n_blocks * chunk, token_row)
    tok = torch.randn((8, token_row), generator=g,
                      device="cuda").to(torch.bfloat16)
    sidx = torch.randperm(n_blocks * chunk, generator=g,
                          device="cuda")[:8].to(torch.int32)
    out["k3_gather_us"] = chip_smoke.graph_ms(
        lambda: K.gather_rows(pool, bids)) * 1e3
    out["k3_scatter_us"] = chip_smoke.graph_ms(
        lambda: K.scatter_rows(view, sidx, tok)) * 1e3
    out["empty_kernel_us"] = (chip_smoke.graph_ms(K.empty_probe) * 1e3
                              if hasattr(K, "empty_probe") else None)
    del pool, view
    torch.cuda.empty_cache()


def train_times(out):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.runtime import TrainConfig, train
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = get_arch(chip_smoke.TRAIN_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    params = init_params(cfg, gen, torch.float32)
    tc = TrainConfig(steps=4, batch=chip_smoke.TRAIN_BATCH,
                     seq=chip_smoke.TRAIN_SEQ, seed=chip_smoke.SEED,
                     log_every=1)
    step_s = []
    train(cfg, params, tc, device="cuda",
          on_metrics=lambda st, m: step_s.append(m["step_s"]))
    warm = step_s[1:]
    out["train_warm_step_ms"] = sum(warm) / len(warm) * 1e3
    out["train_step_ms"] = [t * 1e3 for t in step_s]
    tc1 = TrainConfig(steps=1, batch=chip_smoke.TRAIN_BATCH,
                      seq=chip_smoke.TRAIN_SEQ, seed=chip_smoke.SEED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train(cfg, params, tc1, device="cuda")
        torch.cuda.synchronize()
    out["train_k6_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and "flash_prefill" in e.key) / 1e3
    del params
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
        print("k6_k3_times: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels import _build
    _build.library()
    out = {"tree": str(Path(repro_torch.__file__).parents[2]),
           "card": chip_smoke.subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    k6_k10_times(out)
    k3_times(out)
    if not args.no_train:
        train_times(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
