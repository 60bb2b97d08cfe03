"""Multi-pod dry run: trace every (arch x shape x mesh) cell with nothing
allocated (the port of ``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware.  A fake
process group (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once) of 256 / 512 ranks stands in for 1 or 2 pods
of 256 devices, and this process plays rank 0.  For every cell this
script
  * builds abstract params / optimizer state / batch / cache as
    ``DTensor``s placed by :mod:`repro_torch.dist.sharding` whose local
    parts are fake tensors (``FakeTensorMode``: shapes, no storage),
  * runs the step on them -- loss, gradients and AdamW for train cells,
    prefill, or one decode step -- so DTensor's sharding propagation
    inserts the collectives the mesh needs (the JAX package's ``jit``
    lower + compile),
  * records, into a JSON record per cell, the program's flops
    (``flops_total``: ``torch.utils.flop_counter.FlopCounterMode`` over
    the DTensor-level operators, the logical program's, not one device's
    as the JAX record's ``cost_analysis.flops``), each placed
    collective's count and result bytes on this rank
    (``collective_counts`` / ``collective_bytes``:
    ``torch.distributed.tensor.debug.CommDebugMode``; the step is traced
    unrolled, so every layer's are there), the operators traced
    (``op_count``), the per-device bytes of weights and optimizer state
    (``arg_bytes_per_device``, the JAX package's formula) and the local
    argument and output bytes (``memory_analysis``).

An operator DTensor cannot place -- no sharding rule, a view of a dim
sharded unevenly or strided, offsets that depend on data, a masked
partial it cannot redistribute, an in-place write of a DTensor into a
plain tensor (a cache the model allocates itself) -- runs on replicated
inputs instead (:class:`_ReplicateFallback`).  Those operators are
counted by reason in ``replicated_fallbacks`` and the gathers they imply
in ``fallback_all_gathers``, apart from the placed collectives; any other
error is raised.

Every cell runs the CPU route of the model (the kernels' plain versions):
fake tensors live on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
      --archs tinyllama-1.1b --shapes decode_32k --out /tmp/d.json
It never writes the repo's ``dryrun_multi.json`` (the JAX package's
record): ``--out`` names the file, ``dryrun_torch.json`` by default.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from collections import Counter, defaultdict
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES, SHAPE_BY_NAME, SUBQUADRATIC_FAMILIES, \
    get_arch
from ..dist import sharding as shd
from ..dist.annotate import use_mesh
from ..models import abstract_params
from ..optim import adamw
from .steps import input_specs, make_prefill_step, make_serve_step, \
    make_train_step

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# the functional collectives' names -> the JAX record's (HLO's) names
_OP_NAMES = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "broadcast": "collective-permute"}
REPO_RECORD = "dryrun_multi.json"


def should_skip(cfg, shape) -> str:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return "long_500k needs sub-quadratic attention (full-attn arch)"
    return ""


def arg_bytes_per_device(mesh, params, opt=None) -> int:
    """Exact per-device bytes of weights + optimizer given their specs (the
    JAX package's formula over its stacked leaves: each leaf's bytes
    divided, rounding up, by the product of its spec's mesh axes)."""
    sizes = shd._axis_sizes(mesh)

    def leaf_bytes(spec, shape, dtype):
        n = 1
        for d in shape:
            n *= d
        size = n * torch.empty((), dtype=dtype).element_size()
        shards = 1
        for axes in spec:
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                shards *= sizes.get(a, 1)
        return -(-size // max(1, shards))

    lay = shd.jax_layout(params)
    specs = [shd.param_spec(mesh, p, s) for p, s, _ in lay]
    total = sum(leaf_bytes(sp, s, t[0].dtype)
                for sp, (_p, s, t) in zip(specs, lay))
    if opt:
        for key in ("m", "v"):
            total += sum(leaf_bytes(sp, s, t[0].dtype) for sp, (_p, s, t)
                         in zip(specs, shd.jax_layout(opt[key])))
        total += sum(leaf_bytes((), (), t.dtype) for k, t in opt.items()
                     if k not in ("m", "v"))
    return total


def _comm_bytes_mode():
    """A CommDebugMode that also sums each collective's result bytes on
    this rank, by the JAX record's collective names."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = defaultdict(int)
            self.counts = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            op = _OP_NAMES.get(getattr(func, "_overloadpacket",
                                       func).__name__)
            if op is not None:
                self.counts[op] += 1
                self.bytes[op] += sum(
                    t.numel() * t.element_size()
                    for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            return out
    return CommBytes()


_VIEWS = frozenset({"view", "_unsafe_view", "reshape", "unflatten"})


def _unplaceable(func, args, kwargs, err) -> str:
    """Why DTensor could not place ``func`` where it raised ``err``, or
    "" where the error is not one of DTensor's placement limits (a fault
    of the program, raised)."""
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.distributed.tensor import DTensor
    msg = str(err)
    if isinstance(err, NotImplementedError) and \
            "does not have a sharding strategy" in msg:
        return "no sharding rule"
    if isinstance(err, RuntimeError) and "unevenly sharded" in msg:
        return "uneven view"
    if func.overloadpacket.__name__ in _VIEWS and \
            isinstance(err, (RuntimeError, ValueError)) and \
            ("is invalid for input of size" in msg
             or "Cannot view a tensor" in msg
             # torch 2.11's words for a view that splits a sharded dim
             or "Attempted to split the sharded dimension" in msg):
        return "view of a sharded dim"
    if isinstance(err, DataDependentOutputException):
        return "data-dependent offsets"
    if isinstance(err, IndexError) and any(
            type(p).__name__ == "_MaskPartial"
            for t in torch.utils._pytree.tree_leaves((args, kwargs))
            if isinstance(t, DTensor) for p in t.placements):
        return "masked partial"
    return ""


class _ReplicateFallback(TorchDispatchMode):
    """Runs an operator that DTensor cannot place (:func:`_unplaceable`,
    or an in-place write of a DTensor into a plain tensor) on replicated
    inputs; any other error propagates.  It sits below autograd, so it
    catches backward operators too and leaves the graph alone.  Each
    DTensor argument not already replicated counts as an all-gather of
    its bytes (``gathers`` / ``gather_bytes``, apart from the placed
    collectives) and is replaced by a fresh full-size fake tensor (the
    values do not exist: nothing to move); the operator runs on those,
    and its tensor results come back as replicated DTensors (an in-place
    operator returns its own first argument).  Counts the operators it
    sees (``ops``) and those it replicated, by reason and operator
    (``fallbacks``)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.gathers = 0
        self.gather_bytes = 0
        self.fallbacks = defaultdict(Counter)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                            TensorMeta)
        kwargs = kwargs or {}
        self.ops += 1
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        dts = [t for t in leaves if isinstance(t, DTensor)]
        if func._schema.is_mutable and args and dts and \
                isinstance(args[0], torch.Tensor) and \
                not isinstance(args[0], DTensor):
            reason = "in-place write into a plain tensor"
        else:
            try:
                return func(*args, **kwargs)
            except Exception as e:
                reason = _unplaceable(func, args, kwargs, e) if dts else ""
                if not reason:
                    raise
        mesh = dts[0].device_mesh
        self.fallbacks[reason][str(func.overloadpacket.__name__)] += 1

        def local(x):
            if not isinstance(x, DTensor):
                return x
            if not all(isinstance(p, Replicate) for p in x.placements):
                self.gathers += 1
                self.gather_bytes += x.numel() * x.element_size()
            return torch.empty(x.shape, dtype=x.dtype)
        a, k = torch.utils._pytree.tree_map(local, (args, kwargs))
        out = func(*a, **k)
        if func._schema.is_mutable and args and \
                isinstance(args[0], torch.Tensor):
            return args[0]              # in place: its own first argument

        def wrap(t):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                return t
            spec = DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                               tensor_meta=TensorMeta(t.shape, t.stride(),
                                                      t.dtype))
            return DTensor(t, spec, requires_grad=False)
        return torch.utils._pytree.tree_map(wrap, out)


@contextlib.contextmanager
def _one_attention_block():
    """The plain blocked attention with one (query, key) block while a
    cell traces: the same products and masks as its 512 x 1024 blocks (it
    computes and masks every block pair), traced as one pair instead of
    thousands."""
    from ..models import attention
    orig = attention.flash_attention

    def one_block(q, k, v, **kw):
        return orig(q, k, v, block_q=q.shape[1], block_k=k.shape[1], **kw)
    attention.flash_attention = one_block
    try:
        with _strided_offsets_on_real_tensors():
            yield
    finally:
        attention.flash_attention = orig


@contextlib.contextmanager
def _strided_offsets_on_real_tensors():
    """DTensor computes a strided shard's offsets (``_StridedShard``: the
    placement a view leaves when it merges dims sharded on two mesh dims,
    as the multi-pod mesh's ("pod", "data") dims do) from index tensors of
    a dim's length, while pricing redistributions.  Under
    ``FakeTensorMode`` those would be fake, read element by element (a
    dispatch each) and unreadable in the end: run that integer bookkeeping
    with the fake mode lifted."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    try:
        from torch.distributed.tensor.placement_types import _StridedShard
        orig = _StridedShard.local_shard_size_and_offset
    except (ImportError, AttributeError):
        yield
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)
    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _placed(tree, shardings):
    """``tree``'s meta leaves as fake DTensors placed by ``shardings``."""
    if isinstance(tree, dict):
        return {k: _placed(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placed(v, s) for v, s in zip(tree, shardings))
    return shd.shard_abstract(tree, shardings)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             collect_hlo: bool = True, cfg=None, shape=None):
    """One cell's record.  ``cfg`` / ``shape`` override the registry's (a
    reduced config or a small shape, for tests)."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPE_BY_NAME[shape_name]
    skip = should_skip(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.time()
    meta = abstract_params(cfg)
    tmesh = trace_mesh(mesh)
    pshard = _remesh(shd.param_shardings(mesh, meta), tmesh)
    specs = input_specs(cfg, shape)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            implicit_replication(), use_mesh(tmesh):
        params = _placed(meta, pshard)
        args, opt_meta = _cell_args(cfg, shape, mesh, tmesh, params, pshard,
                                    specs)
        t_lower = time.time() - t0
        t0 = time.time()
        comm = _comm_bytes_mode()
        fallback = _ReplicateFallback()
        flops = FlopCounterMode(display=False)
        with comm, flops, fallback, _one_attention_block():
            out = _run_step(cfg, shape, pshard, args)
        t_trace = time.time() - t0
        rec["memory_analysis"] = {
            "argument_size_in_bytes": _local_bytes(args),
            "output_size_in_bytes": _local_bytes(out)}
        del out, args, params
    rec["status"] = "ok"
    rec["lower_s"] = round(t_lower, 2)
    rec["compile_s"] = round(t_trace, 2)
    rec["flops_total"] = float(flops.get_total_flops())
    if collect_hlo:
        rec["collective_bytes"] = {k: comm.bytes.get(k, 0)
                                   for k in _COLLECTIVES}
        rec["collective_counts"] = {k: comm.counts.get(k, 0)
                                    for k in _COLLECTIVES}
        rec["op_count"] = fallback.ops
    rec["replicated_fallbacks"] = {r: dict(c) for r, c in
                                   fallback.fallbacks.items()}
    rec["fallback_all_gathers"] = {"count": fallback.gathers,
                                   "bytes": fallback.gather_bytes}
    rec["arg_bytes_per_device"] = arg_bytes_per_device(
        mesh, meta, None if shape.kind != "train" else opt_meta)
    return rec


def _cell_args(cfg, shape, mesh, tmesh, params, pshard, specs):
    """The step's placed arguments (specs by ``mesh``'s axis sizes,
    placed on the trace mesh ``tmesh``), and the optimizer state's meta
    tree (train cells)."""
    def placed(tree, shardings):
        return _placed(tree, _remesh(shardings, tmesh))
    if shape.kind == "train":
        opt_meta = adamw.abstract_init(abstract_params(cfg))
        opt = _placed(opt_meta, shd.opt_shardings(tmesh, opt_meta, pshard))
        batch = placed(specs["batch"],
                       shd.batch_shardings(mesh, specs["batch"]))
        return (params, opt, batch), opt_meta
    if shape.kind == "prefill":
        return (params, placed(specs["batch"], shd.batch_shardings(
            mesh, specs["batch"]))), None
    cache = placed(specs["cache"], shd.cache_shardings(mesh, specs["cache"]))
    tokens = placed({"t": specs["tokens"]},
                    shd.batch_shardings(mesh, {"t": specs["tokens"]}))["t"]
    return (params, cache, tokens, shape.seq_len - 1), None


def trace_mesh(mesh):
    """The ``DeviceMesh`` a cell traces on: ``mesh`` itself, or, where it
    has a pod axis, its (pod, data) dims flattened into one "pod+data"
    dim over the same ranks in the same order.  Every multi-pod spec puts
    pod and data on a dim together (``_dp_axes`` drops the pod only where
    the data axis alone divides, which no cell's dim does; ``placements``
    raises if one did), so the placement is the same; DTensor then moves
    a (pod, data) dim with one collective over the 32 ranks, as the JAX
    package's compiled program does, not two in turn, and prices its
    redistributions on a 2-D mesh."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    if id(mesh) not in _TRACE_MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        sizes = dict(zip(names, mesh.mesh.shape))
        _TRACE_MESHES[id(mesh)] = (mesh, init_device_mesh(
            mesh.device_type, (sizes["pod"] * sizes["data"], sizes["model"]),
            mesh_dim_names=("pod+data", "model")))
    return _TRACE_MESHES[id(mesh)][1]


_TRACE_MESHES = {}      # id(mesh) -> (mesh, its trace mesh)


def _remesh(shardings, tmesh):
    """``shardings`` (a tree of ``NamedSharding``s) on the mesh ``tmesh``,
    their specs kept."""
    if isinstance(shardings, dict):
        return {k: _remesh(v, tmesh) for k, v in shardings.items()}
    if isinstance(shardings, list):
        return [_remesh(v, tmesh) for v in shardings]
    return shd.NamedSharding(tmesh, shardings.spec)


def _run_step(cfg, shape, pshard, args):
    if shape.kind == "train":
        return make_train_step(cfg, grad_shardings=pshard)(*args)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, cache_len=shape.seq_len)(*args)
    return make_serve_step(cfg)(*args)


def start_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (any earlier default group is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None):
    from .mesh import make_production_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=sorted(ARCHS))
    ap.add_argument("--shapes", nargs="*", default=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the collectives' record")
    args = ap.parse_args(argv)
    if Path(args.out).name == REPO_RECORD:
        raise SystemExit(f"--out {args.out}: {REPO_RECORD} is the JAX "
                         f"package's record; write elsewhere")

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16", True))

    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records}

    import torch.distributed as dist
    for mesh_name, multi in meshes:
        start_fake_group(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi)
        _run_mesh(args, mesh, mesh_name, records, done)
        dist.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {args.out}")
    return 1 if n_err else 0


def _run_mesh(args, mesh, mesh_name, records, done):
    """Every requested cell of one mesh, each record appended and the
    file rewritten after it."""
    for arch in args.archs:
        for shape_name in args.shapes:
            if (arch, shape_name, mesh_name) in done:
                continue
            t0 = time.time()
            try:
                rec = run_cell(arch, shape_name, mesh, mesh_name,
                               collect_hlo=not args.no_hlo)
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": mesh_name, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            rec["wall_s"] = round(time.time() - t0, 2)
            records.append(rec)
            print(f"[{rec.get('status'):7s}] {mesh_name} {arch} "
                  f"{shape_name} ({rec['wall_s']}s)"
                  + (f" :: {rec.get('error', rec.get('reason', ''))}"
                     if rec.get("status") != "ok" else ""),
                  flush=True)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)


if __name__ == "__main__":
    raise SystemExit(main())
