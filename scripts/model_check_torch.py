#!/usr/bin/env python
"""Exhaustively model-check the Tardis protocol against the PyTorch port.

Enumerates every reachable state of the guarded-action model of Tables
I-III (``repro_torch.analysis``), checks the proof's invariants on each
state and transition, and (by default) cross-validates every distinct rule
application against the port's ``core.protocol`` scalars and its
``LeaseEngine``: ``--backend numpy`` the host mirror, ``--backend device``
the engine's tensors on ``--device`` (on ``cuda`` every distinct read runs
the lease-pass kernel K1 and every write the write-advance kernel K2).
Exits non-zero on any violation or if the state space fails to close
under the cap.  Takes the flags of ``scripts/model_check.py``.

The fast lane runs the 2-core/1-block config (a few seconds)::

    PYTHONPATH=src python scripts/model_check_torch.py --cores 2 --blocks 1
    PYTHONPATH=src python scripts/model_check_torch.py --consistency tso \\
        --backend device --device cuda
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.analysis import Bridge, Config, TardisModel, explore  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cores", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--lease", type=int, default=2)
    ap.add_argument("--ts-bits", type=int, default=2,
                    help="rebase threshold exponent (bounds the ts domain)")
    ap.add_argument("--consistency", choices=("sc", "tso", "rc"),
                    default="sc",
                    help="forbidden-outcome predicates to enforce over the "
                    "same state graph: sc = all load checks, tso waives the "
                    "beyond-lease-end check, rc also waives the stale-"
                    "inside-newer-interval check")
    ap.add_argument("--no-self-inc", action="store_true",
                    help="disable spontaneous pts advance")
    ap.add_argument("--no-pw-opt", action="store_true",
                    help="disable the private-write optimization (IV-C), "
                    "exercising the store_hit_exclusive rule instead")
    ap.add_argument("--no-symmetry", action="store_true",
                    help="disable the core/block permutation quotient")
    ap.add_argument("--no-bridge", action="store_true",
                    help="skip cross-validation against core.protocol and "
                    "the LeaseEngine")
    ap.add_argument("--backend", choices=("numpy", "device"),
                    default="numpy",
                    help="the LeaseEngine backend the bridge replays on")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the device backend's device (default: the card)")
    ap.add_argument("--max-states", type=int, default=2_000_000)
    args = ap.parse_args(argv)

    cfg = Config(n_cores=args.cores, n_blocks=args.blocks,
                 lease=args.lease, ts_bits=args.ts_bits,
                 self_inc=not args.no_self_inc,
                 pw_opt=not args.no_pw_opt,
                 symmetry=not args.no_symmetry,
                 consistency=args.consistency)
    model = TardisModel(cfg)
    bridge = None if args.no_bridge else Bridge(
        cfg.lease, backend=args.backend, device=args.device)
    res = explore(model, bridge=bridge, max_states=args.max_states)

    print(f"config: {cfg}")
    print(f"states: {res.n_states}  transitions: {res.n_transitions}  "
          f"depth: {res.max_depth}  wall: {res.wall_time:.1f}s")
    print(f"closed: {res.closed}")
    print("rules fired: " + ", ".join(
        f"{k}={v}" for k, v in sorted(res.rule_counts.items())))
    if bridge is not None:
        print(f"bridge backend: {bridge.backend} on {bridge.device}")
        print("bridge (distinct replays): " + ", ".join(
            f"{k}={v}" for k, v in sorted(res.bridge_counts.items())))
        print("bridge kernel launches: " + ", ".join(
            f"{k}={v}" for k, v in sorted(bridge.launches.items())))
    if not res.closed:
        print(f"FAIL: state space did not close under "
              f"--max-states {args.max_states}", file=sys.stderr)
        return 2
    if res.violations:
        print(f"FAIL: {len(res.violations)} invariant violation(s):",
              file=sys.stderr)
        for v in res.violations:
            print(str(v), file=sys.stderr)
        return 1
    print("OK: state space closed, all invariants hold "
          "(wts<=rts, single owner, value-ts consistency, pts "
          "monotonicity, no deadlock)" +
          ("" if args.no_bridge else ", cross-validated against the "
           f"port's core.protocol and its {args.backend} LeaseEngine"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
