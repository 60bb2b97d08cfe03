"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Starts a Tardis-coherent replica cluster (one host) on the selected
architecture -- its reduced config, or with ``--full-width`` the published
one -- with random weights from ``--seed``, serves synthetic requests
sharing a system prompt and prints the coherence report.  The dense/vlm
and moe families serve through the paged KV pool (kimi-k2's leading dense
layers and its moe layers as two cache stacks side by side in each pool
token row); the ssm and hybrid families
serve fixed waves on dense caches of ``--cache-len`` slots.  Runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS, get_arch, reduced
from ..core import CONSISTENCY_MODELS, CoherencePolicy
from ..device import pick_device
from ..models import init_params
from ..models.transformer import PORTED_FAMILIES
from ..runtime import Request, ServingCluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config instead of reduced()")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0: keep)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--lease", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="shared system-prompt tokens (prefix-KV reuse)")
    ap.add_argument("--prefix-block", type=int, default=8)
    ap.add_argument("--decode-pages", type=int, default=256,
                    help="allocator-region pool pages (admission bound)")
    ap.add_argument("--max-pages", type=int, default=32,
                    help="page-table length per request")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="continuous-batch slots per replica")
    ap.add_argument("--cache-len", type=int, default=96,
                    help="dense-cache slots per request (wave path)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="simulated hosts (only 1 is ported)")
    ap.add_argument("--consistency", choices=CONSISTENCY_MODELS,
                    default="sc")
    ap.add_argument("--kv-lease", type=int, default=16,
                    help="base prefix-KV lease (logical ticks)")
    ap.add_argument("--lease-bounds", default="",
                    help="'min:max' bounds; turns Tardis 2.0 lease "
                         "prediction on")
    args = ap.parse_args(argv)
    if args.hosts != 1:
        raise SystemExit("only --hosts 1 is ported to PyTorch so far")
    if args.lease_bounds:
        lo, _, hi = args.lease_bounds.partition(":")
        policy = CoherencePolicy(
            consistency=args.consistency, lease=args.kv_lease,
            lease_min=int(lo), lease_max=int(hi), predictor=True)
    else:
        policy = CoherencePolicy(consistency=args.consistency,
                                 lease=args.kv_lease)
    device = pick_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.family not in PORTED_FAMILIES:
        raise SystemExit(f"the port serves the {', '.join(PORTED_FAMILIES)} "
                         f"families; {args.arch} is {cfg.family}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = init_params(cfg, gen, dtype)
    cluster = ServingCluster(
        cfg, lambda: params, n_replicas=args.replicas, lease=args.lease,
        prefix_block_tokens=args.prefix_block, policy=policy,
        n_decode_pages=args.decode_pages, max_pages=args.max_pages,
        selfinc_period=4, max_batch=args.max_batch,
        cache_len=args.cache_len, device=device)
    rng = np.random.default_rng(args.seed)
    system = rng.integers(1, cfg.vocab, args.prefix_len).astype(np.int32)
    reqs = [Request(i, np.concatenate(
                [system, rng.integers(1, cfg.vocab, rng.integers(4, 16))
                 .astype(np.int32)]), max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done, report = cluster.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    width = "full width" if args.full_width else "reduced"
    print(f"served {len(done)} requests on {args.replicas} replicas "
          f"({args.arch} {width}, {cfg.n_layers} layers) on {where} in "
          f"{dt:.2f} s")
    for k, v in report.items():
        print(f"  {k:28s} {v}")
    if cluster.paged:
        print(f"paged decode: {report['kv_tokens_appended']} token rows "
              f"through pool pages, peak {report['pool_page_peak']} pages "
              f"in use, {report['pool_pages_freed']} freed")
    else:
        print(f"wave decode: dense caches of {args.cache_len} slots, "
              f"{report['prefix_block_hits']} prefix-block lease hits")
    return done, report


if __name__ == "__main__":
    main()
