"""Seeded weights for a dense decoder, drawn on the device in a few large
calls, in the type they are served in.

``draw`` returns the stacked tensors (one per kind, layers on the leading
axis) that both the program and the plain reference read; ``port_params``
lays views of them out as the port's parameter tree (a list of per-layer
dicts).  Scales follow the usual init: N(0, 1/fan_in) for projections,
N(0, 0.02^2) for the embedding, and norm gains 1 + N(0, 0.1^2) so that a
gain read from the wrong place shows.
"""
from __future__ import annotations

from typing import Dict

import torch


def _normal(g, shape, std, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=g)


def draw(run: Dict, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    """Stacked weights of the configuration's ``run`` block from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    n, d, f, v = run["n_layers"], run["d_model"], run["d_ff"], run["vocab"]
    qd = run["n_heads"] * run["head_dim"]
    kd = run["n_kv_heads"] * run["head_dim"]
    w = {
        "embed": _normal(g, (v, d), 0.02, dtype, device),
        "lm_head": _normal(g, (d, v), d ** -0.5, dtype, device),
        "final_norm": 1 + _normal(g, (d,), 0.1, torch.float32, device),
        "attn_norm": 1 + _normal(g, (n, d), 0.1, torch.float32, device),
        "mlp_norm": 1 + _normal(g, (n, d), 0.1, torch.float32, device),
        "wq": _normal(g, (n, d, qd), d ** -0.5, dtype, device),
        "wk": _normal(g, (n, d, kd), d ** -0.5, dtype, device),
        "wv": _normal(g, (n, d, kd), d ** -0.5, dtype, device),
        "wo": _normal(g, (n, qd, d), qd ** -0.5, dtype, device),
        "w_gate": _normal(g, (n, d, f), d ** -0.5, dtype, device),
        "w_up": _normal(g, (n, d, f), d ** -0.5, dtype, device),
        "w_down": _normal(g, (n, f, d), f ** -0.5, dtype, device),
    }
    for k in ("final_norm", "attn_norm", "mlp_norm"):
        w[k] = w[k].to(dtype)
    return w


def port_params(w: Dict[str, torch.Tensor]) -> Dict:
    """The port's dense parameter tree over views of ``w`` (no copies)."""
    layers = [{
        "attn": {"wq": w["wq"][i], "wk": w["wk"][i], "wv": w["wv"][i],
                 "wo": w["wo"][i], "norm": w["attn_norm"][i]},
        "mlp": {"w_gate": w["w_gate"][i], "w_up": w["w_up"][i],
                "w_down": w["w_down"][i]},
        "mlp_norm": w["mlp_norm"][i],
    } for i in range(w["wq"].shape[0])]
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "lm_head": w["lm_head"], "layers": layers}


def nbytes(w: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in w.values())
