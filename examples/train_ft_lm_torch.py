"""End-to-end training on the PyTorch port (the twin of
``examples/train_ft_lm.py``): a tinyllama-family LM trained with the full
production loop -- checkpoints, an injected node failure + restart,
straggler accounting, int8 gradient compression with error feedback, and
microbatch accumulation.

Default size is CPU-friendly; ``--full`` trains the ~100M configuration
(8 layers, d_model 768) for 200 steps of 8 x 256 tokens.  Runs on the card
unless ``--device cpu``; ``train_config`` and ``run`` take the config and
weights, so a caller can drive them at another width or length.

Run:  PYTHONPATH=src python examples/train_ft_lm_torch.py [--full]
      [--device cpu]
"""
import argparse
import tempfile
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import pick_device
from repro_torch.models import init_params, param_leaves
from repro_torch.runtime import TrainConfig, train


def model_config(full=False, steps=0):
    """(config, steps, batch, seq) of the default run or of ``--full``;
    ``steps`` 0 takes the run's own."""
    if full:
        cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=8, d_model=768,
                      n_heads=12, n_kv_heads=4, d_ff=2048, d_head=64,
                      vocab=32000)
        return cfg, steps or 200, 8, 256
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=4, d_model=256,
                  n_heads=8, n_kv_heads=4, d_ff=512, d_head=32, vocab=2048)
    return cfg, steps or 60, 8, 128


def train_config(steps, batch, seq, ckpt_dir):
    return TrainConfig(
        steps=steps, ckpt_dir=ckpt_dir, ckpt_every=max(10, steps // 8),
        batch=batch, seq=seq, grad_compression=True, n_micro=2,
        fail_at_step=steps // 2,         # inject a crash mid-run
        log_every=10)


def run(cfg, params, tc, device):
    """``runtime.train`` with the example's straggler and metrics hooks.
    Returns (the loop's summary, the stragglers flagged, seconds); on the
    card the time ends in a device synchronise."""
    device = pick_device(device)
    stragglers = []
    t0 = time.perf_counter()
    out = train(cfg, params, tc,
                on_straggler=lambda s, dt: stragglers.append((s, dt)),
                on_metrics=lambda s, m: print(
                    f"  step {s:4d} loss {m['loss']:.4f} "
                    f"gnorm {m['grad_norm']:.2f} {m['step_s']*1e3:.0f} ms"),
                device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, stragglers, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 200 steps")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = pick_device(args.device)
    cfg, steps, batch, seq = model_config(args.full, args.steps)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.float32)
    n_params = sum(p.numel() for p in param_leaves(params))
    print(f"training {n_params/1e6:.1f}M params for {steps} steps "
          f"(batch={batch}, seq={seq})")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="tardis_ckpt_")
    tc = train_config(steps, batch, seq, ckpt_dir)
    out, _stragglers, dt = run(cfg, params, tc, device)

    print(f"\ndone in {dt/60:.1f} min: loss {out['losses'][0]:.3f} -> "
          f"{out['losses'][-1]:.3f}")
    print(f"recovered from {out['restarts']} injected failure(s) via "
          f"checkpoint restore; {out['stragglers']} straggler steps flagged")
    print(f"checkpoints in {ckpt_dir}")
    assert out["losses"][-1] < out["losses"][0], "did not learn!"
    return out


if __name__ == "__main__":
    main()
