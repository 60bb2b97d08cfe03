"""Elastic data-parallel training with Tardis-leased parameters, on the
PyTorch port (the twin of ``examples/elastic_dp.py``).

A learner publishes parameter versions into a TardisStore while the worker
pool grows and shrinks every few steps.  Workers read *leased* parameter
copies (bounded logical staleness -- the paper's deferred update propagation
put to work), renew on expiry (data-less when the learner hasn't published),
and need zero protocol action to leave.  Runs on the card unless
``--device cpu``; ``run`` takes the config and weights, so a caller can
drive it at another width.

Run:  PYTHONPATH=src python examples/elastic_dp_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import pick_device
from repro_torch.models import init_params, loss_fn
from repro_torch.runtime import ElasticTrainer
from repro_torch.tree import value_and_grad

# worker pool: 2 -> 4 -> 1 -> 3 (simulated preemptions / scale-ups)
SCHEDULE = [2, 2, 3, 4, 4, 1, 1, 2, 3, 3, 3, 2, 2, 2, 2, 2]


def model_config():
    return reduced(get_arch("tinyllama-1.1b"), n_layers=2, d_model=128,
                   vocab=512)


def run(cfg, params, device, lr=3e-3):
    """The example's elastic run over ``SCHEDULE`` (lease 2, AdamW at
    ``lr``): each worker's batch of 4 x 64 tokens drawn from (step, worker).
    Returns the trainer's report."""
    device = pick_device(device)

    def grad_fn(p, b):
        return value_and_grad(lambda pp, bb: loss_fn(cfg, pp, bb), p, b)

    def make_batch(step, worker):
        rng = np.random.default_rng(step * 1000 + worker)
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))
                             .astype(np.int32)).to(device)
        return {"tokens": t, "labels": t}

    et = ElasticTrainer(params, grad_fn, make_batch, lease=2, lr=lr)
    return et.run(len(SCHEDULE), schedule=lambda s: SCHEDULE[s])


def print_report(rep):
    print(f"steps: {rep.steps}, worker joins: {rep.joins}, "
          f"leaves: {rep.leaves}")
    print(f"loss: {rep.losses[0]:.3f} -> {np.mean(rep.losses[-4:]):.3f}")
    print(f"parameter renewals: {rep.renewals} "
          f"({rep.data_less} data-less)")
    print(f"max logical staleness observed: {rep.max_staleness} "
          f"(lease bound: workers can never be further behind than "
          f"lease+publish jump)")
    print("no sharer lists, no invalidation broadcasts, no barrier on "
          "scale-down: O(log N) metadata per object (the paper's claim, "
          "applied to the training control plane)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = pick_device(args.device)
    cfg = model_config()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.float32)
    print_report(run(cfg, params, device))


if __name__ == "__main__":
    main()
