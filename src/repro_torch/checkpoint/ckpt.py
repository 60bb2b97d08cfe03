"""Versioned, atomic checkpointing in the JAX package's on-disk layout (the
port of ``repro.checkpoint.ckpt``: ``save`` / ``restore`` /
``latest_step``, and ``save_sharded`` / ``restore_sharded``).

Layout:  <dir>/step_<N>/
             manifest.json    {step, wts (Tardis version), tree structure,
                               leaf shapes/dtypes, shard map}
             shard_<i>.npz    leaf arrays (chunked across files)
         <dir>/LATEST         atomic pointer (written via rename)

Leaves are stored as the JAX package stores its pytree: in
``jax.tree.flatten``'s order (dict keys sorted, tuples in order), and each
of the port's per-layer lists (``layers``, ``dense_layers``, the hybrid
``groups`` -- a list of lists) stacked on a leading axis, as the JAX
package keeps its layers.  So the port restores a checkpoint the JAX
package wrote into the port's parameter and optimizer trees, and the JAX
package restores one the port wrote.  numpy has no bfloat16 without
``ml_dtypes`` (the card's machine has none): a bf16 leaf is stored as its
uint16 bits with dtype ``"bfloat16"`` in the manifest (the JAX package
reads such a leaf back as uint16).

``save_sharded`` writes a tree whose leaves may be ``DTensor``s (placed by
:mod:`repro_torch.dist.sharding`) without gathering: each rank writes the
pieces it holds -- its local shard of each leaf, a per-layer list's
shards stacked into one piece, as the JAX package's stacked leaf splits --
each tagged with its (start, stop) box in the global (stacked) shape;
replicated copies are written once (by the ranks at coordinate 0 of the
mesh dims that replicate the leaf).  Every rank writes its own
``shard_<i>.npz`` files into one directory and rank 0 writes the manifest
of all pieces, in the layout of the JAX package's ``save_sharded``, which
reads it (and whose checkpoints :func:`restore_sharded` reads).
``restore_sharded`` rebuilds each leaf in the placement of ``tree_like``'s
leaf: a ``DTensor`` leaf reads exactly its local box from whichever
pieces overlap it (the saved mesh shape need not be the target's), a
plain one the whole leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MAX_SHARD_BYTES = 512 << 20


def _flat(tree) -> List[torch.Tensor]:
    """The leaves in the JAX layout, on the host: lists stacked."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    if isinstance(tree, list):
        cols = [_flat(e) for e in tree]
        return [torch.stack([c[i] for c in cols]) for i in range(len(cols[0]))]
    return [torch.as_tensor(tree).detach().cpu()]


def _shapes(tree) -> List[Tuple[int, ...]]:
    """The shapes :func:`_flat` would give, without moving any data."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shapes(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _shapes(t)]
    if isinstance(tree, list):
        return [(len(tree),) + s for s in _shapes(tree[0])]
    return [tuple(torch.as_tensor(tree).shape)]


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree.flatten(tree)[1])`` prints it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(x) for x in t) + \
                ("," if len(t) == 1 else "") + ")"
        if isinstance(t, list):
            return walk(t[0])
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _unflat(like, arrays):
    """``like``'s structure over ``arrays`` (an iterator in :func:`_flat`'s
    order); a list takes its elements' arrays and unstacks them."""
    if isinstance(like, dict):
        out = {k: _unflat(like[k], arrays) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple):
        return tuple(_unflat(t, arrays) for t in like)
    if isinstance(like, list):
        stacked = [next(arrays) for _ in _shapes(like[0])]
        return [_unflat(e, iter([a[i] for a in stacked]))
                for i, e in enumerate(like)]
    return next(arrays)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def save(ckpt_dir: str, step: int, tree, *, wts: int = 0,
         keep: int = 3) -> str:
    """Write one checkpoint atomically; returns the checkpoint path."""
    leaves = _flat(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest: Dict[str, Any] = {
        "step": int(step), "wts": int(wts),
        "treedef": _treedef(tree),
        "n_leaves": len(leaves),
        "leaves": [], "shards": [],
    }
    shard, shard_bytes, shard_id = {}, 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if shard:
            np.savez(os.path.join(tmp, f"shard_{shard_id}.npz"), **shard)
            manifest["shards"].append(f"shard_{shard_id}.npz")
            shard, shard_bytes = {}, 0
            shard_id += 1

    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"].append(
            {"idx": i, "shape": list(arr.shape), "dtype": dtype,
             "shard": shard_id})
        shard[f"leaf_{i}"] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _MAX_SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                           # atomic publish
    _write_latest(ckpt_dir, f"step_{step}")
    _gc(ckpt_dir, keep)
    return final


def _write_latest(ckpt_dir: str, name: str):
    tmp = os.path.join(ckpt_dir, ".LATEST_tmp")
    with open(tmp, "w") as f:
        f.write(name)
    os.rename(tmp, os.path.join(ckpt_dir, "LATEST"))


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        (int(d.split("_")[1]), d) for d in os.listdir(ckpt_dir)
        if d.startswith("step_"))
    for _, d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``tree_like`` (its leaves
    give the shapes, in the port's per-layer lists), each leaf in the
    dtype it was saved in, on ``device`` (default: the CPU).  Raises
    ``ValueError`` when the leaves' count or a shape differs.  Returns
    (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("sharded"):
        raise ValueError(f"{path} was written by save_sharded(): read it "
                         f"with restore_sharded()")
    shapes = _shapes(tree_like)
    if len(shapes) != manifest["n_leaves"]:
        raise ValueError(f"tree mismatch: {len(shapes)} leaves vs "
                         f"{manifest['n_leaves']} in {path}")
    shards = {}
    for s in manifest["shards"]:
        with np.load(os.path.join(path, s)) as z:
            shards.update({k: z[k] for k in z.files})
    arrays = []
    for i, (shape, entry) in enumerate(zip(shapes, manifest["leaves"])):
        arr = shards[f"leaf_{i}"]
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {i}: saved shape {tuple(arr.shape)}, "
                             f"want {shape}")
        arrays.append(_from_numpy(arr, entry["dtype"]).to(
            device or "cpu"))
    return _unflat(tree_like, iter(arrays)), manifest


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------

def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local_box(t) -> Tuple[Tuple[int, int], ...]:
    """The (start, stop) box of the part of ``t`` this rank holds."""
    if isinstance(t, _dtensor_cls()):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        shape, off = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        return tuple((o, o + n) for o, n in zip(off, shape))
    return tuple((0, d) for d in t.shape)


def _writes(t) -> bool:
    """Whether this rank writes its part of ``t``: it is at coordinate 0
    of every mesh dim that does not shard ``t`` (a replica is written
    once)."""
    if not isinstance(t, _dtensor_cls()):
        return _rank() == 0
    from torch.distributed.tensor import Shard
    coord = t.device_mesh.get_coordinate()
    if coord is None:
        return False
    return all(isinstance(p, Shard) or c == 0
               for p, c in zip(t.placements, coord))


def _local(t) -> torch.Tensor:
    if isinstance(t, _dtensor_cls()):
        t = t.to_local()
    return t.detach().cpu()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _gather_objects(obj) -> list:
    """``obj`` of every rank, in rank order (one process: ``[obj]``)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def save_sharded(ckpt_dir: str, step: int, tree, *, wts: int = 0,
                 keep: int = 3) -> str:
    """Write one checkpoint without gathering (see the module docstring);
    every rank of the default group calls it.  Returns the checkpoint
    path."""
    from ..dist.sharding import jax_layout
    layout = jax_layout(tree)
    rank = _rank()
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_") if rank == 0 \
        else None
    tmp = _gather_objects(tmp)[0]
    # this rank's pieces: (leaf index, box, array) in leaf order
    mine, files = [], []
    shard, shard_bytes = {}, 0

    def flush():
        nonlocal shard, shard_bytes
        if shard:
            name = f"shard_r{rank}_{len(files)}.npz"
            np.savez(os.path.join(tmp, name), **shard)
            files.append(name)
            shard, shard_bytes = {}, 0

    dtypes = []
    for i, (_path, shape, parts) in enumerate(layout):
        first = parts[0]
        dtypes.append(_to_numpy(torch.empty(0, dtype=first.dtype))[1])
        if not _writes(first):
            continue
        box = _local_box(first)
        stack = len(shape) - len(box)
        local = torch.stack([_local(t) for t in parts]) if stack else \
            _local(first)
        local = local.reshape(shape[:stack] + local.shape[1:] if stack > 1
                              else local.shape)
        arr, _dt = _to_numpy(local.contiguous())
        key = f"leaf_{i}_r{rank}"
        mine.append({"leaf": i, "key": key, "file": len(files),
                     "start": [0] * stack + [a for a, _ in box],
                     "stop": list(shape[:stack]) + [b for _, b in box]})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _MAX_SHARD_BYTES:
            flush()
    flush()
    everyone = _gather_objects((mine, files))
    final = os.path.join(ckpt_dir, f"step_{step}")
    if rank == 0:
        manifest: Dict[str, Any] = {
            "step": int(step), "wts": int(wts), "sharded": True,
            "treedef": _treedef(tree), "n_leaves": len(layout),
            "leaves": [{"idx": i, "shape": list(shape), "dtype": dtypes[i],
                        "pieces": []}
                       for i, (_p, shape, _t) in enumerate(layout)],
            "shards": []}
        for pieces, names in everyone:
            base = len(manifest["shards"])
            manifest["shards"].extend(names)
            for pc in pieces:
                manifest["leaves"][pc["leaf"]]["pieces"].append(
                    {"key": pc["key"], "shard": base + pc["file"],
                     "start": pc["start"], "stop": pc["stop"]})
        for j, entry in enumerate(manifest["leaves"]):
            if not entry["pieces"]:
                raise RuntimeError(f"leaf {j}: no rank wrote a piece")
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        _write_latest(ckpt_dir, f"step_{step}")
        _gc(ckpt_dir, keep)
    _gather_objects(None)                           # all see it published
    return final


def _read_box(entry, shards, want) -> np.ndarray:
    """Assemble the box ``want`` ((start, stop) pairs) of one leaf from
    its saved pieces (the JAX package's ``_read_box``)."""
    dtype = "uint16" if entry["dtype"] == "bfloat16" else entry["dtype"]
    out = np.empty([b - a for a, b in want], dtype)
    filled = 0
    for p in entry["pieces"]:
        box = list(zip(p["start"], p["stop"]))
        inter = [(max(a, pa), min(b, pb))
                 for (a, b), (pa, pb) in zip(want, box)]
        if any(x >= y for x, y in inter):
            continue                                # piece outside the box
        data = shards(p["key"])
        if data.dtype.itemsize == 2 and dtype == "uint16":
            data = data.view(np.uint16)             # bf16 bits
        src = tuple(slice(x - pa, y - pa)
                    for (x, y), (pa, _) in zip(inter, box))
        dst = tuple(slice(x - a, y - a)
                    for (x, y), (a, _) in zip(inter, want))
        out[dst] = data[src]
        filled += int(np.prod([y - x for x, y in inter]))
    if filled != out.size:
        raise ValueError(f"leaf {entry['idx']}: pieces cover {filled}/"
                         f"{out.size} of {want}")
    return out


def restore_sharded(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
                    device=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore a sharded checkpoint (the port's or the JAX package's) into
    ``tree_like``'s structure and placements: a ``DTensor`` leaf comes
    back a ``DTensor`` on its mesh with its placements, its local part
    read from the pieces that overlap it; any other leaf comes back whole
    on ``device`` (default: the CPU).  Returns (tree, manifest)."""
    from ..dist.sharding import jax_layout
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if not manifest.get("sharded"):
        raise ValueError(f"{path} was written by save(), not "
                         f"save_sharded()")
    layout = jax_layout(tree_like)
    if len(layout) != manifest["n_leaves"]:
        raise ValueError(f"tree mismatch: {len(layout)} leaves vs "
                         f"{manifest['n_leaves']} in {path}")
    where = {pc["key"]: manifest["shards"][pc["shard"]]
             for e in manifest["leaves"] for pc in e["pieces"]}
    opened: Dict[str, Any] = {}
    read: Dict[str, np.ndarray] = {}    # this leaf's pieces, read once

    def shards(key):
        if key not in read:
            name = where[key]
            if name not in opened:
                opened[name] = np.load(os.path.join(path, name))
            read[key] = opened[name][key]
        return read[key]

    DTensor = _dtensor_cls()
    out = []
    for (_p, shape, parts), entry in zip(layout, manifest["leaves"]):
        if tuple(entry["shape"]) != tuple(shape):
            raise ValueError(f"leaf {entry['idx']}: saved shape "
                             f"{tuple(entry['shape'])}, want {shape}")
        stack = len(shape) - parts[0].dim()
        read.clear()
        for j, like in enumerate(parts):
            idx = np.unravel_index(j, shape[:stack]) if stack else ()
            box = _local_box(like)
            want = tuple((int(i), int(i) + 1) for i in idx) + box
            arr = _read_box(entry, shards, want)
            t = _from_numpy(arr.reshape([b - a for a, b in box]),
                            entry["dtype"])
            if isinstance(like, DTensor):
                local_dev = like.to_local().device
                out.append(DTensor.from_local(
                    t.to(local_dev), like.device_mesh, like.placements,
                    run_check=False, shape=like.shape,
                    stride=like.stride()))
            else:
                out.append(t.to(device or "cpu"))
    for z in opened.values():
        z.close()
    return _unflat_parts(tree_like, iter(out)), manifest


def _unflat_parts(like, leaves):
    """``like``'s structure over ``leaves`` given one per port leaf, in
    the order :func:`repro_torch.dist.sharding.jax_layout` lists them
    (each JAX leaf's per-layer parts in stack order)."""
    from ..dist.sharding import jax_layout
    layout = jax_layout(like)
    by_id = {}
    for _p, _s, parts in layout:
        for t in parts:
            by_id[id(t)] = next(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        if isinstance(t, list):
            return [walk(v) for v in t]
        return by_id[id(t)]
    return walk(like)
