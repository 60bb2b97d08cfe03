"""Versioned, atomic checkpointing in the JAX package's on-disk layout (the
port of ``repro.checkpoint.ckpt``'s ``save`` / ``restore`` /
``latest_step``).

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
reads such a leaf back as uint16).  ``save_sharded`` / ``restore_sharded``
wait for the port's sharding layer (``ROADMAP.md`` item 6).
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
        raise ValueError(f"{path} was written by save_sharded(), which the "
                         f"port does not read yet")
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
