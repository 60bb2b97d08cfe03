"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the port of ``repro.launch.train``: the same flags, plus ``--device``).

Runs the reduced config of the architecture with random fp32 weights from
``--seed`` through the fault-tolerant loop (config -> params -> step ->
``runtime.train``) and prints a line every ``log_every`` steps.  Runs on
the card unless ``--device cpu``; on the card every family trains
through the kernels and their backward kernels: attention through K6 /
K10, the norms through K8 / K11 (plain, add and, for the ssm and hybrid
families, Mamba2's gated norm), the SSD scan through K7 / K12.
"""
import argparse

import torch

from ..configs import ARCHS, get_arch, reduced
from ..device import pick_device
from ..models import init_params, param_leaves
from ..runtime import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke-scale config")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = pick_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, torch.float32)
    n = sum(p.numel() for p in param_leaves(params))
    print(f"arch={args.arch} family={cfg.family} params={n/1e6:.1f}M "
          f"device={dev}")

    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     batch=args.batch, seq=args.seq, seed=args.seed,
                     grad_compression=args.grad_compression,
                     n_micro=args.n_micro)
    out = train(cfg, params, tc, device=dev,
                on_metrics=lambda s, m: print(
                    f"step {s:5d} loss {m['loss']:.4f} "
                    f"lr {m['lr']:.2e} {m['step_s']*1e3:.0f}ms"))
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(restarts={out['restarts']}, stragglers={out['stragglers']})")
    return out


if __name__ == "__main__":
    main()
