"""Sharding rules for the (pod, data, model) production mesh (the port of
``repro.dist.sharding``).

One function -- :func:`param_spec` -- decides the placement of every weight
from its tree path and shape alone (configs never annotate tensors):

  * stacked per-layer weights keep their leading layer axis replicated (it is
    scanned over, never sharded),
  * 2-D+ weight bodies get tensor parallelism on their last dim over
    ``model`` and FSDP on their first dim over ``('pod', 'data')``,
  * MoE expert weights put the expert dim on ``model`` (expert parallelism)
    and FSDP on the d_model dim,
  * every placement is divisibility-guarded: a dim that does not divide the
    full axis product falls back -- ``('pod', 'data')`` degrades to ``data``
    alone (uneven-DP pod drop), and an indivisible dim replicates,
  * 1-D bodies (norms, biases, A_log/D vectors) replicate.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the dim split over those axes, the first
outermost) -- the entries of JAX's ``PartitionSpec``, which is a tuple,
so the two compare equal.  A mesh is anything that names its axes' sizes:
a ``{name: size}`` dict, a ``torch.distributed.DeviceMesh`` with
``mesh_dim_names``, or an object whose ``shape`` is such a mapping (JAX's
``Mesh``).  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``: a dim split over ``("pod", "data")`` becomes ``Shard(d)``
on both mesh dims, nested in mesh-dim order (pod outermost), which is
JAX's order on the production meshes, whose axes run (pod, data, model).

The port keeps its per-layer weights in lists (``layers``, ``groups`` --
a list of lists) where the JAX package stacks them on leading axes.
:func:`param_specs` walks the port's tree in the JAX package's layout --
``jax.tree.flatten``'s leaf order, each list stacked -- so its specs line
up with JAX's leaf for leaf; :func:`param_placements` gives each per-layer
leaf its stacked leaf's spec without the (always replicated) stack axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

# Leading stacked axes per top-level parameter collection: per-layer weights
# are stacked on an L axis (hybrid "groups" adds an application axis too).
_STACK_DEPTH = {"layers": 1, "dense_layers": 1, "enc_layers": 1,
                "dec_layers": 1, "groups": 2}

# MoE expert weights: body-relative index of the d_model dim.
# w_gate / w_up are (E, D, F); w_down is (E, F, D).
_MOE_EXPERT_DMODEL = {"w_gate": 1, "w_up": 1, "w_down": 2}


def _axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _dp_axes(mesh, dim: int) -> Axes:
    """FSDP placement for ``dim``: shard over ('pod', 'data') when divisible
    by the full product, drop the pod axis when only ``data`` divides, and
    replicate otherwise."""
    ax = _axis_sizes(mesh)
    data, pod = ax.get("data", 1), ax.get("pod", 1)
    if pod > 1 and data > 1 and dim % (pod * data) == 0:
        return ("pod", "data")
    if data > 1 and dim % data == 0:
        return "data"
    return None


def _model_axis(mesh, dim: int) -> Axes:
    model = _axis_sizes(mesh).get("model", 1)
    return "model" if model > 1 and dim % model == 0 else None


def param_spec(mesh, path: Tuple[str, ...], shape) -> Spec:
    """The spec of one weight, from its tree path (in the JAX layout:
    no list indices) and its stacked shape."""
    path = tuple(str(p) for p in path)
    stack = _STACK_DEPTH.get(path[0], 0) if path else 0
    stack = min(stack, max(0, len(shape) - 1))
    leaf = path[-1] if path else ""
    body = len(shape) - stack
    spec: list = [None] * len(shape)
    if "moe" in path and leaf in _MOE_EXPERT_DMODEL and body == 3:
        spec[stack] = _model_axis(mesh, shape[stack])        # experts -> EP
        d_idx = stack + _MOE_EXPERT_DMODEL[leaf]
        spec[d_idx] = _dp_axes(mesh, shape[d_idx])           # FSDP on d_model
    elif body >= 2:
        spec[-1] = _model_axis(mesh, shape[-1])              # TP on features
        spec[stack] = _dp_axes(mesh, shape[stack])           # FSDP on inputs
    return tuple(spec)


def jax_layout(tree, path: Tuple[str, ...] = ()) -> List[tuple]:
    """The port's tree as the JAX package lays it out: one entry per JAX
    leaf, in ``jax.tree.flatten``'s order (dict keys sorted, tuples in
    order), each (path, stacked shape, the port's leaves in stack order).
    A list stacks its elements' leaves on a leading axis."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in jax_layout(tree[k], path + (str(k),))]
    if isinstance(tree, tuple):
        return [e for i, t in enumerate(tree)
                for e in jax_layout(t, path + (str(i),))]
    if isinstance(tree, list):
        cols = [jax_layout(e, path) for e in tree]
        return [(p, (len(tree),) + s, [x for c in cols for x in c[i][2]])
                for i, (p, s, _) in enumerate(cols[0])]
    return [(path, tuple(tree.shape), [tree])]


def param_specs(mesh, params) -> List[Spec]:
    """Every weight's spec, in the JAX layout's leaf order (the specs
    ``repro.dist.sharding.param_shardings`` gives the JAX tree)."""
    return [param_spec(mesh, p, s) for p, s, _ in jax_layout(params)]


def _stack_depth(tree) -> int:
    depth = 0
    while isinstance(tree, list):
        tree, depth = tree[0], depth + 1
    return depth


def param_placements(mesh, params) -> Any:
    """A tree mirroring ``params`` (the port's layout) whose leaves are the
    per-layer specs: the stacked leaf's spec less its stack axes."""
    def walk(t, path, depth):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),), depth) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v, path + (str(i),), depth)
                         for i, v in enumerate(t))
        if isinstance(t, list):
            d = _stack_depth(t)
            return [walk(v, path, depth + d if depth == 0 else depth)
                    for v in t]
        shape = (1,) * depth + tuple(t.shape)
        return param_spec(mesh, path, shape)[depth:]
    return walk(params, (), 0)


def opt_specs(mesh, opt, pspecs) -> Dict[str, Any]:
    """Optimizer-state specs: moments mirror the parameters (ZeRO);
    everything else (step counters etc.) replicates."""
    def rep(t):
        if isinstance(t, dict):
            return {k: rep(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rep(v) for v in t)
        return (None,) * len(getattr(t, "shape", ()))
    return {key: (pspecs if key in ("m", "v") else rep(sub))
            for key, sub in opt.items()}


def opt_shardings(mesh, opt, param_shardings) -> Dict[str, Any]:
    """Optimizer-state shardings: the moments take ``param_shardings``
    (the parameters' ``NamedSharding`` tree), the rest replicates."""
    def rep(t):
        if isinstance(t, dict):
            return {k: rep(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rep(v) for v in t)
        return NamedSharding(mesh, (None,) * len(t.shape))
    return {key: (param_shardings if key in ("m", "v") else rep(sub))
            for key, sub in opt.items()}


def batch_spec(mesh, shape) -> Spec:
    """Leading (batch) dim over the DP axes, everything else replicated."""
    if len(shape) == 0:
        return ()
    spec = [None] * len(shape)
    spec[0] = _dp_axes(mesh, shape[0])
    return tuple(spec)


def activation_spec(mesh, shape) -> Spec:
    """Residual-stream placement: batch over the DP axes plus sequence
    parallelism -- a 3-D+ activation's second (sequence) dim shards over
    ``model`` when divisible.  Divisibility-guarded like every other
    placement: an indivisible sequence dim replicates."""
    if len(shape) == 0:
        return ()
    spec = [None] * len(shape)
    spec[0] = _dp_axes(mesh, shape[0])
    if len(shape) >= 3:
        spec[1] = _model_axis(mesh, shape[1])
    return tuple(spec)


def batch_specs(mesh, batch) -> Dict[str, Spec]:
    """Every batch leaf's leading (batch) dim over the DP axes."""
    return {k: batch_spec(mesh, v.shape) for k, v in batch.items()}


# Decode-cache leaves by dict key: (heads_dim_index) for the model axis.
# KV caches are (L, B, T, H, Dh); SSM state is (L, B, H, P, N); conv buffers
# are (L, B, W, C).
_CACHE_MODEL_DIM = {"k": 3, "v": 3, "ak": 3, "av": 3, "ck": 3, "cv": 3,
                    "dk": 3, "dv": 3, "state": 2, "conv": 3}


def cache_spec(mesh, name: str, shape) -> Spec:
    """Batch dim (index 1) over DP, heads/channels dim over model."""
    spec: list = [None] * len(shape)
    if len(shape) >= 2:
        spec[1] = _dp_axes(mesh, shape[1])
    mdim = _CACHE_MODEL_DIM.get(name)
    if mdim is not None and mdim < len(shape):
        spec[mdim] = _model_axis(mesh, shape[mdim])
    return tuple(spec)


def cache_specs(mesh, cache) -> Dict[str, Spec]:
    """Decode caches: batch dim over DP, heads/channels dim over model."""
    def one(name, t):
        if isinstance(t, dict):
            return {k: one(k, v) for k, v in t.items()}
        return cache_spec(mesh, name, t.shape)
    return {k: one(k, v) for k, v in cache.items()}


def placements(mesh, spec: Spec):
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: per
    mesh dim, ``Shard(d)`` where the tensor dim d names that axis (alone
    or in a tuple), else ``Replicate()``.  A mesh dim named by joining
    axes with "+" (``"pod+data"``: those dims flattened, in order) takes a
    tensor dim split over exactly those axes.  Raises ``ValueError`` for
    an axis the mesh cannot place."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = []
    for name in names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple)
                                  and (name in ax or name == "+".join(ax)))]
        out.append(Shard(dims[0]) if dims else Replicate())
    for ax in spec:
        if ax is None or (isinstance(ax, tuple) and "+".join(ax) in names):
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            if a not in names:
                raise ValueError(f"mesh {names} cannot place axis {a!r} of "
                                 f"spec {spec}")
    return out


def num_shards(mesh, spec: Spec) -> int:
    """How many pieces ``spec`` cuts a tensor into on ``mesh``."""
    sizes, n = _axis_sizes(mesh), 1
    for ax in spec:
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            n *= sizes.get(a, 1)
    return n


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def param_shardings(mesh, params) -> Any:
    """A ``NamedSharding`` tree mirroring ``params`` (the port's layout:
    each per-layer leaf its stacked leaf's spec less the stack axes)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return NamedSharding(mesh, t)
    return walk(param_placements(mesh, params))


def batch_shardings(mesh, batch) -> Dict[str, NamedSharding]:
    """Every batch leaf's leading (batch) dim over the DP axes."""
    return {k: NamedSharding(mesh, s)
            for k, s in batch_specs(mesh, batch).items()}


def cache_shardings(mesh, cache) -> Dict[str, Any]:
    """Decode caches: batch dim over DP, heads/channels dim over model."""
    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return NamedSharding(mesh, t)
    return one(cache_specs(mesh, cache))


def shard(t, sharding: NamedSharding):
    """``t`` (a full tensor, on the mesh's device) placed as a ``DTensor``
    by ``sharding`` (``torch.distributed.tensor.distribute_tensor``)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def shard_abstract(t, sharding: NamedSharding):
    """A ``DTensor`` of ``t``'s shape and dtype placed by ``sharding``
    whose local part is a fresh empty tensor of the local shape (under a
    ``FakeTensorMode``: a fake one, nothing allocated, no collective)."""
    import torch
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = sharding.placements
    with unset_fake_temporarily():        # it computes offsets in tensors
        local_shape, _off = compute_local_shape_and_global_offset(
            t.shape, sharding.mesh, pl)
    local = torch.empty(local_shape, dtype=t.dtype)
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())
