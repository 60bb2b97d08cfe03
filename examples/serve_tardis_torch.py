"""End-to-end serving on the PyTorch port: continuous batching through
paged pool KV (the twin of ``examples/serve_tardis.py``).

Serves a tinyllama-family model on N replicas with a stream of requests
sharing a common system-prompt prefix; every KV byte decode touches lives
in LeaseEngine pool pages (decode budgets are randomized per request, so
streams finish independently and the scheduler admits new requests into
running batches as pages free up).  Hot-swaps the weights mid-stream (no
invalidation broadcast) and prints the coherence ledger: renewals,
data-less renewal savings, prefix-KV block reuse through the LeaseEngine
(the lease kernels K1 / K2 on the card), pool occupancy / page churn, and
what a full-map directory would have done on the same stream.

Runs on the card unless ``--device cpu`` (the kernels' plain versions).
``serve``, ``print_ledger`` and ``check`` take the config and weights, so
a caller can drive them at another width.

Run:  PYTHONPATH=src python examples/serve_tardis_torch.py [--replicas 3]
      [--device cpu]
      (--check makes it a CI smoke: asserts the prefix-reuse path fired
       and a request was admitted mid-batch)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import CONSISTENCY_MODELS, CoherencePolicy
from repro_torch.device import pick_device
from repro_torch.models import init_params, param_leaves
from repro_torch.runtime import Request, ServingCluster
from repro_torch.tree import tree_map


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="shared system-prompt tokens per request")
    ap.add_argument("--prefix-block", type=int, default=8,
                    help="tokens per leased prefix-KV block")
    ap.add_argument("--no-prefix-reuse", action="store_true")
    ap.add_argument("--consistency", choices=CONSISTENCY_MODELS,
                    default="sc",
                    help="prefix-KV memory model (tso/rc skip renewals of "
                         "expired read-only leases)")
    ap.add_argument("--predictor", action="store_true",
                    help="adaptive (Tardis 2.0) per-block lease prediction")
    ap.add_argument("--check", action="store_true",
                    help="assert the LeaseEngine prefix path fired (CI)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def model_config(args):
    return reduced(get_arch("tinyllama-1.1b"), n_layers=args.layers,
                   d_model=args.d_model, d_ff=args.d_model * 4, vocab=512)


def make_requests(cfg, args):
    """The shared system prompt plus a random suffix each, with randomized
    decode budgets: streams finish independently, so the
    continuous-batching scheduler admits later requests mid-batch."""
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, cfg.vocab,
                                 args.prefix_len).astype(np.int32)
    return [Request(i, np.concatenate(
                [system_prompt,
                 rng.integers(1, cfg.vocab, rng.integers(4, 24))
                 .astype(np.int32)]),
                max_new=int(rng.integers(1, args.max_new + 1)))
            for i in range(args.requests)]


def serve(cfg, params, args, device):
    """The example's stream: the first half of the requests, the weights
    hot-swapped (x 0.999), the second half.  Returns (cluster, requests,
    the report after each half, the new version's timestamp, seconds);
    on the card the time ends in a device synchronise."""
    policy = CoherencePolicy(consistency=args.consistency, lease=16,
                             predictor=args.predictor)
    cluster = ServingCluster(cfg, lambda: params,
                             n_replicas=args.replicas, lease=8,
                             prefix_block_tokens=args.prefix_block,
                             policy=policy,
                             prefix_reuse=not args.no_prefix_reuse,
                             cache_len=96, selfinc_period=4,
                             max_batch=3, device=device)
    reqs = make_requests(cfg, args)
    t0 = time.perf_counter()
    half = len(reqs) // 2
    _, report1 = cluster.run(reqs[:half])
    report1 = dict(report1)
    # live weight hot-swap between waves: Tardis jumps ahead, nobody blocks
    new_params = tree_map(lambda p: p * 0.999, params)
    wts = cluster.publish_weights(new_params)
    print(f"published new weight version at logical time {wts} "
          "(zero invalidation messages)")
    _, report = cluster.run(reqs[half:])
    if cluster.device.type == "cuda":
        torch.cuda.synchronize(cluster.device)
    return cluster, reqs, (report1, report), wts, time.perf_counter() - t0


def print_ledger(cluster, reqs, report, seconds):
    n_tok = sum(len(r.output) for r in reqs)
    dev = cluster.device
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print(f"\nserved {len(reqs)} requests / {n_tok} tokens "
          f"on {len(cluster.replicas)} replicas in {seconds:.1f}s "
          f"({n_tok / seconds:.1f} tok/s on {where})")
    print("\ncoherence ledger (Tardis):")
    for k, v in report.items():
        print(f"  {k:28s} {v}")
    saved = report["bytes_saved_by_renewals"]
    print(f"\n=> data-less renewals avoided re-sending "
          f"{saved/1e6:.1f} MB of weights/KV;")
    print(f"=> prefix-KV reuse: {report['prefix_block_hits']} block hits "
          f"({report['prefix_tokens_reused']} tokens), "
          f"{report['prefix_data_less_renewals']} data-less renewals via "
          "the LeaseEngine kernel;")
    print(f"=> paged-KV pool: prefill skipped "
          f"{report['prefix_prefill_tokens_skipped']} prompt tokens "
          f"({report['prefix_flops_saved']/1e9:.2f} GFLOPs saved) in "
          f"{report['prefix_read_dispatches']} read + "
          f"{report['prefix_write_dispatches']} write wave-batched engine "
          "dispatches;")
    print(f"=> paged decode: {report['kv_tokens_appended']} token rows "
          f"appended into pages, {report['decode_block_reads']} decode-time "
          f"block reads ({report['decode_local_hits']} local hits / "
          f"{report['decode_renewals']} renewals), "
          f"{report['paged_mid_batch_admissions']} mid-batch admissions, "
          f"peak {report['pool_page_peak']} pages in use;")
    print(f"=> a full-map directory would have tracked "
          f"{report['directory_peak_sharers']} sharers and sent "
          f"{report['directory_would_invalidate']} invalidations.")
    print(f"\nsample completion (req 0): {reqs[0].output.tolist()}")


def check(cluster, reqs, report, args):
    """The CI smoke's assertions (``--check``)."""
    assert all(r.done for r in reqs)
    assert report["prefix_block_hits"] > 0, "prefix reuse never hit"
    assert report["prefix_data_less_renewals"] > 0, \
        "no data-less renewals on the LeaseEngine path"
    assert report["data_less_renewals"] > 0
    assert report["prefix_flops_saved"] > 0, \
        "paged-KV pool never skipped prefill on a hit"
    assert report["prefix_kv_blocks_read"] > 0
    # wave batching: never more engine read dispatches than admission
    # groups + in-flight renewal rounds
    n_waves = -(-args.requests // args.replicas)
    assert report["prefix_read_dispatches"] <= n_waves
    # continuous batching: decode runs through pool pages, a request
    # joined a running batch, and everything was released
    assert report["kv_tokens_appended"] > 0
    assert report["paged_mid_batch_admissions"] > 0, \
        "scheduler never admitted a request mid-batch"
    assert report["pool_pages_free"] == cluster.n_decode_pages, \
        "page leak: not every page returned to the free list"
    print("check: serving smoke OK (prefix reuse + data-less renewals "
          "+ paged-KV prefill skip + mid-batch admission)")


def main(argv=None):
    args = parse_args(argv)
    device = pick_device(args.device)
    cfg = model_config(args)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.float32)
    n_par = sum(p.numel() for p in param_leaves(params))
    print(f"model: {cfg.name}-reduced {args.layers}L d={args.d_model} "
          f"({n_par/1e6:.1f}M params)")
    cluster, reqs, (_, report), _wts, dt = serve(cfg, params, args, device)
    print_ledger(cluster, reqs, report, dt)
    if args.check:
        check(cluster, reqs, report, args)


if __name__ == "__main__":
    main()
