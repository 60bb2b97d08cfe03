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

``--hosts K`` serves through K simulated hosts sharing one sharded lease
directory (``--shards`` owner shards, default K): host 0 first prefills
and publishes the shared prefix, then the other hosts serve the rest of
the stream round-robin, suffix-only from migrated pages.  ``--roles
prefill,decode,...`` makes a disaggregated fleet instead: ONE routed run,
cold prefixes forwarded to the prefill pods and the streams handed back
to the decode pods.  The report then carries per-host columns and the
directory's cross-host ledger (``xhost_*``).
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
from ..runtime import MultiHostServingCluster, Request, ServingCluster


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
                    help=">1: simulated hosts sharing a sharded lease "
                         "directory (cross-host prefix-KV migration)")
    ap.add_argument("--shards", type=int, default=0,
                    help="owner shards for --hosts mode (default: --hosts)")
    ap.add_argument("--roles", default="",
                    help="comma list of per-host roles (prefill|decode|"
                         "mixed), e.g. 'prefill,decode,decode'; implies "
                         "--hosts len(roles) and routes cold prefixes "
                         "through the prefill pods")
    ap.add_argument("--consistency", choices=CONSISTENCY_MODELS,
                    default="sc")
    ap.add_argument("--kv-lease", type=int, default=16,
                    help="base prefix-KV lease (logical ticks)")
    ap.add_argument("--lease-bounds", default="",
                    help="'min:max' bounds; turns Tardis 2.0 lease "
                         "prediction on")
    args = ap.parse_args(argv)
    if args.lease_bounds:
        lo, _, hi = args.lease_bounds.partition(":")
        policy = CoherencePolicy(
            consistency=args.consistency, lease=args.kv_lease,
            lease_min=int(lo), lease_max=int(hi), predictor=True)
    else:
        policy = CoherencePolicy(consistency=args.consistency,
                                 lease=args.kv_lease)
    roles = [r.strip() for r in args.roles.split(",") if r.strip()]
    if roles:
        if args.hosts > 1 and args.hosts != len(roles):
            raise SystemExit(
                f"--hosts {args.hosts} != {len(roles)} roles in --roles")
        args.hosts = len(roles)
    device = pick_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.family == "encdec":
        raise SystemExit("the serve CLI drives decoder-only archs; whisper "
                         "needs frame inputs (models.prefill / decode_step)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = init_params(cfg, gen, dtype)
    kw = dict(n_replicas=args.replicas, lease=args.lease,
              prefix_block_tokens=args.prefix_block, policy=policy,
              n_decode_pages=args.decode_pages, max_pages=args.max_pages,
              selfinc_period=4, max_batch=args.max_batch,
              cache_len=args.cache_len, device=device)
    if args.hosts > 1:
        cluster = MultiHostServingCluster(
            cfg, lambda: params, n_hosts=args.hosts,
            n_shards=args.shards or None, roles=roles or None, **kw)
    else:
        cluster = ServingCluster(cfg, lambda: params, **kw)
    rng = np.random.default_rng(args.seed)
    system = rng.integers(1, cfg.vocab, args.prefix_len).astype(np.int32)
    reqs = [Request(i, np.concatenate(
                [system, rng.integers(1, cfg.vocab, rng.integers(4, 16))
                 .astype(np.int32)]), max_new=args.max_new)
            for i in range(args.requests)]
    disagg = any(r != "mixed" for r in roles)
    t0 = time.perf_counter()
    if args.hosts == 1 or disagg:
        # one run; a disaggregated fleet's router forwards cold prefixes
        # to the prefill pods and the decode pods serve the handed-back
        # streams suffix-only (default decode affinity)
        done, report = cluster.run(reqs)
    else:
        # phase 1: host 0 prefills + publishes the shared prefix;
        # phase 2: the other hosts serve it suffix-only
        n0 = max(1, len(reqs) // args.hosts)
        cluster.run(reqs[:n0], affinity=[0] * n0)
        _, report = cluster.run(
            reqs[n0:], affinity=[1 + i % (args.hosts - 1)
                                 for i in range(len(reqs) - n0)])
        done = reqs
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    width = "full width" if args.full_width else "reduced"
    print(f"served {len(done)} requests on {args.replicas} replicas x "
          f"{args.hosts} host(s) ({args.arch} {width}, {cfg.n_layers} "
          f"layers) on {where} in {dt:.2f} s")
    for k, v in report.items():
        print(f"  {k:28s} {v}")
    if getattr(cluster, "paged", True):      # a fleet is always paged
        print(f"paged decode: {report['kv_tokens_appended']} token rows "
              f"through pool pages, peak {report['pool_page_peak']} pages "
              f"in use, {report['pool_pages_freed']} freed")
    else:
        print(f"wave decode: dense caches of {args.cache_len} slots, "
              f"{report['prefix_block_hits']} prefix-block lease hits")
    if args.hosts > 1:
        print(f"sharded directory: {report['xhost_msgs']} cross-host msgs "
              f"({report['xhost_bytes']} bytes), "
              f"{report['xhost_migrations']} pages migrated, "
              f"{report['xhost_multicasts']} multicasts, "
              f"{report['xhost_invalidation_msgs']} invalidation msgs")
    if disagg:
        ticks = sum(report.get(f"host{h}_decode_ticks", 0)
                    for h, r in enumerate(roles) if r != "prefill")
        rmsgs = sum(report.get(f"host{h}_role_renewal_msgs", 0)
                    for h, r in enumerate(roles) if r != "prefill")
        per_tick = rmsgs / ticks if ticks else 0.0
        print(f"disaggregated: roles={','.join(roles)}, "
              f"{report['router_cold_forwards']} cold forwards, "
              f"{report['router_handoffs']} handoffs, "
              f"decode-pod renewal msgs/tick {per_tick:.3f}")
    return done, report


if __name__ == "__main__":
    main()
