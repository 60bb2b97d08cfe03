"""Gradient compression and microbatching, and the deterministic numpy
mirrors of the tiled device collectives (the port of
``repro.dist.collectives``).

``compress_grads`` quantizes each gradient leaf to int8 with a per-leaf
scale and carries the quantization error forward as a residual (error
feedback), so the *cumulative* dequantized sum tracks the true gradient
sum to within one quantization step.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.  ``microbatch_grads`` accumulates gradients over
``n_micro`` equal slices of the batch in fp32, in slice order (the JAX
package's ``lax.scan``).

The device collectives ``psum`` / ``all_gather`` / ``reduce_scatter`` /
``all_to_all`` (the port of ``collectives.py:111-141``) run over a
``torch.distributed`` process group (``axis``; None: the default group)
in place of a named mesh axis, tiled on dim 0 as the JAX ones are: NCCL
on the card, gloo on the CPU.  gloo has no reduce-scatter, so there it is
an all-reduce of which each rank keeps its block -- the same result.

The numpy mirrors are the port of ``np_psum`` / ``np_all_gather`` /
``np_reduce_scatter`` / ``np_all_to_all`` (``collectives.py:144-176``):
lists of per-device arrays in, the same out, with the shapes and semantics
of the tiled ``psum`` / ``all_gather`` / ``psum_scatter`` /
``all_to_all``.  :class:`repro_torch.core.shard_directory.NumpyTransport`
routes every directory wave's per-shard flit counts through
:func:`np_all_to_all`, the one-message-per-peer exchange.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..tree import leaves, tree_map, unflatten, value_and_grad

__all__ = ["init_residual", "compress_grads", "decompress_grads",
           "microbatch_grads", "psum", "all_gather", "reduce_scatter",
           "all_to_all", "np_psum", "np_all_gather", "np_reduce_scatter",
           "np_all_to_all"]

Tree = Any


def init_residual(grads: Tree) -> Tree:
    """Zero error-feedback residual matching the gradient tree (fp32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quantize(e):
    scale = torch.max(torch.abs(e)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(e / safe), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: Tree, residual: Tree) -> Tuple[Tree, Tree]:
    """Returns ((int8_tree, scale_tree), new_residual).

    Each leaf is quantized as ``q = round((g + r) * 127 / max|g + r|)``;
    the new residual is the leftover ``(g + r) - dequant(q)``.
    """
    qs, scales, res = [], [], []
    for g, r in zip(leaves(grads), leaves(residual)):
        e = g.float() + r
        q, scale = _quantize(e)
        qs.append(q)
        scales.append(scale)
        res.append(e - q.float() * scale)
    return ((unflatten(grads, qs), unflatten(grads, scales)),
            unflatten(grads, res))


def decompress_grads(compressed) -> Tree:
    """Inverse of :func:`compress_grads`: int8 * scale -> fp32 gradients."""
    qs, scales = compressed
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def microbatch_grads(loss_fn: Callable[[Tree, Tree], torch.Tensor],
                     params: Tree, batch: Tree, n_micro: int
                     ) -> Tuple[torch.Tensor, Tree]:
    """Mean (loss, grads) over ``n_micro`` equal batch slices.

    ``loss_fn(params, microbatch)`` must be a *mean* loss; with equal slice
    sizes the accumulated mean equals the full-batch value to fp32
    rounding.  Gradients accumulate in fp32 in slice order and come back
    in the parameters' dtypes.
    """
    n_micro = int(n_micro)
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    for x in batch.values():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"n_micro={n_micro}")
    acc_loss = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    for i in range(n_micro):
        mb = {k: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i]
              for k, x in batch.items()}
        loss, grads = value_and_grad(loss_fn, params, mb)
        acc = tree_map(lambda a, g: a + g.float(), acc, grads)
        acc_loss = acc_loss + loss.float()
        del grads
    inv = 1.0 / n_micro
    return acc_loss * inv, tree_map(lambda g, p: (g * inv).to(p.dtype), acc,
                                    params)


# ---------------------------------------------------------------------------
# Device collectives over a torch.distributed group (the named mesh axis)
# ---------------------------------------------------------------------------

def _world(axis) -> int:
    import torch.distributed as dist
    return dist.get_world_size(axis)


def psum(x, axis=None):
    """All-reduce-sum over the group ``axis``; returns a new tensor."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis)
    return out


def all_gather(x, axis=None):
    """Concatenate every rank's tensor along dim 0 (tiled all-gather), in
    rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(_world(axis))]
    dist.all_gather(parts, x.contiguous(), group=axis)
    return torch.cat(parts, dim=0)


def reduce_scatter(x, axis=None):
    """Sum across the group, then split the result along dim 0: rank ``i``
    keeps rows ``[i*n/N, (i+1)*n/N)`` of the sum."""
    import torch.distributed as dist
    n = _world(axis)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter dim 0 ({x.shape[0]}) not "
                         f"divisible by group size {n}")
    rank = dist.get_rank(axis)
    if dist.get_backend(axis) == "nccl":
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(),
                                   op=dist.ReduceOp.SUM, group=axis)
        return out
    return psum(x, axis).chunk(n, dim=0)[rank].clone()


def all_to_all(x, axis=None):
    """Transpose shards across the group: row block j of rank i lands on
    rank j as row block i."""
    import torch.distributed as dist
    n = _world(axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all dim 0 ({x.shape[0]}) not divisible "
                         f"by group size {n}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=axis)
    return out


def np_psum(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    total = np.sum(np.stack([np.asarray(s) for s in shards]), axis=0)
    return [total.copy() for _ in shards]


def np_all_gather(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    full = np.concatenate([np.asarray(s) for s in shards], axis=0)
    return [full.copy() for _ in shards]


def np_reduce_scatter(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    n = len(shards)
    total = np.sum(np.stack([np.asarray(s) for s in shards]), axis=0)
    if total.shape[0] % n:
        raise ValueError(
            f"reduce_scatter dim 0 ({total.shape[0]}) not divisible by "
            f"device count {n}")
    return [p.copy() for p in np.split(total, n, axis=0)]


def np_all_to_all(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    n = len(shards)
    pieces = []
    for s in shards:
        s = np.asarray(s)
        if s.shape[0] % n:
            raise ValueError(
                f"all_to_all dim 0 ({s.shape[0]}) not divisible by "
                f"device count {n}")
        pieces.append(np.split(s, n, axis=0))
    # device j receives piece j of every device, in device order
    return [np.concatenate([pieces[i][j] for i in range(n)], axis=0)
            for j in range(n)]
