"""Fault-tolerant training loop (the port of ``repro.runtime.train_loop``,
the same semantics):
  * periodic checkpoints (atomic; the manifest carries the Tardis wts of
    the published parameter version),
  * crash/restart: an injected failure restores the latest checkpoint and
    replays the deterministic data stream from that step (the
    error-feedback residual is not checkpointed: it carries over the
    crash, as in the JAX package),
  * straggler mitigation: per-step deadline = ``straggler_factor`` x
    rolling median; a breach is counted (hook: ``on_straggler``),
  * optional int8 gradient compression with error feedback,
  * optional microbatch accumulation.
A step's time includes the host's read of its loss (``float(loss)``, a
device sync), as the JAX loop's does.  The loop runs on the card unless
the caller passes ``device="cpu"`` (:func:`repro_torch.device.pick_device`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import ckpt
from ..data.pipeline import batch_to, synthetic_batch
from ..device import DeviceLike, pick_device
from ..dist.collectives import (compress_grads, decompress_grads,
                                init_residual, microbatch_grads)
from ..models import loss_fn as model_loss
from ..optim import adamw
from ..tree import tree_map


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 25
    keep: int = 2
    base_lr: float = 3e-4
    warmup: int = 20
    batch: int = 8
    seq: int = 128
    seed: int = 0
    grad_compression: bool = False
    n_micro: int = 1
    straggler_factor: float = 3.0
    fail_at_step: int = -1          # inject one crash at this step
    log_every: int = 10


def build_step(cfg_model, tc: TrainConfig):
    """step_fn(params, opt_state, residual, batch) -> (params, opt_state,
    residual, metrics), the JAX package's jitted step.  Like it (its
    ``donate_argnums``), the step takes params and opt_state over: AdamW
    writes them in place, so a caller passes tensors it does not read
    again."""
    lr_fn = adamw.cosine_schedule(tc.base_lr, tc.warmup, tc.steps)

    def step_fn(params, opt_state, residual, batch):
        loss, grads = microbatch_grads(
            lambda p, b: model_loss(cfg_model, p, b), params, batch,
            tc.n_micro)
        if tc.grad_compression:
            qs, residual = compress_grads(grads, residual)
            grads = decompress_grads(qs)     # what crosses the DP axis
        lr = lr_fn(opt_state["step"] + 1)
        params, opt_state, metrics = adamw.update(
            params, grads, opt_state, lr=lr, donate=True)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, opt_state, residual, metrics

    return step_fn


def train(cfg_model, params, tc: TrainConfig,
          on_straggler: Optional[Callable[[int, float], None]] = None,
          on_metrics: Optional[Callable[[int, Dict], None]] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Runs the loop; returns summary {losses, restarts, stragglers,
    final_step, params, opt_state}."""
    dev = pick_device(device)
    # a copy: the steps update it in place
    params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    opt_state = adamw.init(params)
    residual = init_residual(params) if tc.grad_compression else None
    step_fn = build_step(cfg_model, tc)

    start = 0
    if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
        (params, opt_state), manifest = ckpt.restore(
            tc.ckpt_dir, (params, opt_state), device=dev)
        start = manifest["step"]

    losses: List[float] = []
    durations: List[float] = []
    restarts = 0
    stragglers = 0
    injected = tc.fail_at_step
    step = start
    while step < tc.steps:
        try:
            batch = batch_to(synthetic_batch(tc.seed, step, tc.batch, tc.seq,
                                             cfg_model.vocab), dev)
            t0 = time.time()
            if step == injected:
                injected = -1            # fire once
                raise RuntimeError("injected node failure")
            params, opt_state, residual, metrics = step_fn(
                params, opt_state, residual, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            durations.append(dt)
            med = float(np.median(durations[-20:]))
            if len(durations) > 5 and dt > tc.straggler_factor * med:
                stragglers += 1
                if on_straggler:
                    on_straggler(step, dt)
            losses.append(loss)
            if on_metrics and step % tc.log_every == 0:
                on_metrics(step, {**{k: float(v) for k, v in metrics.items()},
                                  "step_s": dt})
            step += 1
            if tc.ckpt_dir and step % tc.ckpt_every == 0:
                ckpt.save(tc.ckpt_dir, step, (params, opt_state),
                          wts=step, keep=tc.keep)
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
            restarts += 1
            if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
                (params, opt_state), manifest = ckpt.restore(
                    tc.ckpt_dir, (params, opt_state), device=dev)
                step = manifest["step"]
            else:                         # no checkpoint yet: restart cold
                opt_state = adamw.init(params)
                step = 0
    if tc.ckpt_dir:
        ckpt.save(tc.ckpt_dir, step, (params, opt_state), wts=step,
                  keep=tc.keep)
    return {"losses": losses, "restarts": restarts,
            "stragglers": stragglers, "final_step": step,
            "params": params, "opt_state": opt_state}
