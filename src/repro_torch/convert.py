"""Carry weights across: the JAX parameter tree -> the port's parameters.

The JAX package stacks per-layer parameters on a leading ``n_layers`` axis
(``repro.models.transformer.init_params``); the port keeps a list with one
dict per layer -- the moe family's ``dense_layers`` (kimi's leading dense
layers) too.  A moe layer's leaves come across as they are: ``router``
(D, E) in fp32, the expert stacks ``w_gate`` / ``w_up`` (E, D, F) and
``w_down`` (E, F, D), the ``shared`` expert and arctic's dense
``residual`` MLP (each a {w_gate, w_up, w_down} dict).  The hybrid
family's ``groups`` are stacked on two axes
(n_app, per) and become a list of lists; its weight-shared ``shared``
block is one dict in both packages.  Leaves arrive as numpy arrays (bf16 ones as ml_dtypes
``bfloat16``, which torch cannot wrap directly, so they travel as int16
bits).  Element counts and bytes are unchanged, so the serving cluster's
``param_bytes`` and flops-per-token charges match the JAX cluster's.
:func:`sim_state_from_jax` carries the coherence simulator's state across
the same way (its tests start both simulators from one state).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(x, device):
    if isinstance(x, Mapping):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> dict:
    """Map a dense, moe, ssm or hybrid JAX parameter tree (numpy leaves)
    to the port's parameter dict: ``layers`` and ``dense_layers``
    unstacked into per-layer lists, ``groups`` into a list (per
    application) of per-layer lists."""
    stacked = ("layers", "dense_layers", "groups")
    out = {k: _tree(v, device) for k, v in tree.items() if k not in stacked}
    for key in ("layers", "dense_layers"):
        if key in tree:
            out[key] = _unstack(_tree(tree[key], device))
    if "groups" in tree:
        out["groups"] = [_unstack(g) for g in
                         _unstack(_tree(tree["groups"], device))]
    return out


def _unstack(x):
    n = _first_leaf(x).shape[0]
    return [_index(x, i) for i in range(n)]


def _first_leaf(x):
    return _first_leaf(next(iter(x.values()))) if isinstance(x, dict) else x


def _index(x, i):
    if isinstance(x, dict):
        return {k: _index(v, i) for k, v in x.items()}
    return x[i].clone()


def sim_state_from_jax(st: Mapping[str, Any], device="cpu") -> dict:
    """The JAX simulator's state (``repro.core.simulator.init_state``, or
    a state its loop returned) as the port's: the same nested keys, each
    leaf through ``np.asarray`` to a tensor on ``device`` (int32 stays
    int32, bool becomes ``torch.bool``, the stats float32 scalars)."""
    if isinstance(st, Mapping):
        return {k: sim_state_from_jax(v, device) for k, v in st.items()}
    return tensor_from_numpy(st, device)
