"""AdamW with fp32 moments, decoupled weight decay, and global-norm clipping
(the port of ``repro.optim.adamw``, written out as it is there).

Moments are stored fp32 whatever the parameter's dtype; the update is
computed in fp32 and cast back to the parameter's dtype (no master copy),
and the learning rate is an fp32 tensor.  ``torch.optim.AdamW`` is not
this optimizer: it keeps its moments in the parameter's dtype and applies
the weight decay before the Adam step.  The update is functional: it
returns new tensors and leaves its inputs as they were (the elastic
trainer publishes each version and keeps older ones leased) -- unless the
caller donates them (``donate=True``, the JAX trainer's
``donate_argnums``): then the parameters and moments are written in place,
a leaf at a time, with the same arithmetic, so a step holds one copy of
the training state instead of two.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..tree import leaves, tree_map


def init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_init(params) -> Dict[str, Any]:
    """The optimizer state of ``params`` as meta tensors: the shapes and
    dtypes :func:`init` gives, nothing allocated."""
    def zeros(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def update(params, grads, state, *, lr, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1,
           max_grad_norm: float = 1.0, donate: bool = False):
    """Returns (new_params, new_state, metrics).  With ``donate`` the
    returned trees are ``params`` and ``state``'s moments, each leaf
    written in place as soon as it is computed (only one leaf's
    temporaries alive at a time); the numbers are the same."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(max_grad_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state["step"] + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)

    def upd(p, g, m, v):
        g = g.float() * scale                   # clip_by_global_norm's
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    metrics = {"grad_norm": gnorm}
    if donate:
        with torch.no_grad():
            for p, g, m, v in zip(leaves(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"])):
                for old, new in zip((p, m, v), upd(p, g, m, v)):
                    old.copy_(new)
        return params, {"m": state["m"], "v": state["v"], "step": step}, \
            metrics
    flat = tree_map(upd, params, grads, state["m"], state["v"])

    def part(i):
        return tree_map(lambda _p, t: t[i], params, flat)

    return part(0), {"m": part(1), "v": part(2), "step": step}, metrics


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr_fn(step):
        s = torch.as_tensor(step).float()
        warm = base_lr * s / max(1, warmup)
        prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr_fn
