"""Step builders + abstract input specs for every (arch x shape) cell (the
port of ``repro.launch.steps``).

``train_step`` is loss + grad + AdamW update; ``prefill_step`` builds the
KV/SSM cache from a prompt; ``serve_step`` is one decode token against a
full-length cache.  ``input_specs`` returns meta-tensor stand-ins (the
shapes and dtypes, nothing allocated) for the dry run.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeSet
from ..models import decode_step, init_cache, loss_fn, prefill
from ..optim import adamw
from ..tree import tree_map, value_and_grad

VISION_PATCHES = 1024


def make_train_step(cfg: ArchConfig, base_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000,
                    grad_shardings=None):
    """``grad_shardings``: optional tree of ``NamedSharding``s (the
    parameters').  The gradients are redistributed to them before the
    update (the JAX step's ``with_sharding_constraint``: the DP reduction
    lands as a reduce-scatter onto the parameters' shards)."""
    lr_fn = adamw.cosine_schedule(base_lr, warmup, total)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b),
                                     params, batch)
        if grad_shardings is not None:
            grads = tree_map(
                lambda g, ns: g.redistribute(ns.mesh, ns.placements)
                if hasattr(g, "redistribute") else g, grads, grad_shardings)
        lr = lr_fn(opt_state["step"] + 1)
        params, opt_state, metrics = adamw.update(
            params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "lr": lr, **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, cache_len)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, cur_idx):
        return decode_step(cfg, params, cache, tokens, cur_idx)
    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, b: int, s: int,
                with_labels: bool) -> Dict[str, Any]:
    out = {"tokens": _sds((b, s), torch.int32)}
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = _sds((b, s, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        out["vision_embeds"] = _sds(
            (b, min(VISION_PATCHES, s), cfg.d_model), torch.bfloat16)
    return out


def cache_specs(cfg: ArchConfig, b: int, t: int, enc_len: int = 0):
    """The decode caches as meta tensors (``models.init_cache``'s shapes
    and dtypes)."""
    return init_cache(cfg, b, t, device="meta", enc_len=enc_len)


def input_specs(cfg: ArchConfig, shape: ShapeSet) -> Dict[str, Any]:
    """All abstract inputs for one cell, keyed by step-argument name."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, b, s, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, b, s, with_labels=False)}
    if shape.kind == "decode":
        enc_len = s if cfg.family == "encdec" else 0
        return {
            "cache": cache_specs(cfg, b, s, enc_len),
            "tokens": _sds((b, 1), torch.int32),
            "cur_idx": _sds((), torch.int32),
        }
    raise ValueError(shape.kind)
