"""Nested parameter trees of the port: dicts, lists and tuples of tensors.

The JAX package's pytrees are dicts of arrays stacked on a leading layer
axis; the port keeps a list with one dict per layer
(``models.transformer``).  These helpers walk a port tree: dict keys in
sorted order (``jax.tree.flatten``'s order), lists and tuples in order.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

Tree = Any


def leaves(tree: Tree) -> List[Any]:
    """Every leaf, dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same
    structure); dicts keep ``tree``'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *[r[i] for r in rest])
               for i, t in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def unflatten(like: Tree, flat) -> Tree:
    """``like``'s structure with its leaves replaced, in :func:`leaves`'s
    order, by ``flat``."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), _sorted_view(like))
    return _restore_order(like, out)


def _sorted_view(tree):
    if isinstance(tree, dict):
        return {k: _sorted_view(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_sorted_view(t) for t in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def _restore_order(like, tree):
    if isinstance(like, dict):
        return {k: _restore_order(like[k], tree[k]) for k in like}
    if isinstance(like, (list, tuple)):
        out = [_restore_order(a, b) for a, b in zip(like, tree)]
        return tuple(out) if isinstance(like, tuple) else out
    return tree


def value_and_grad(loss_fn: Callable, params: Tree, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` -- ``jax.value_and_grad``
    over a port tree: each leaf is detached and made to require grad, and
    the gradients come back in ``params``' structure and dtypes."""
    req = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(req, *args)
    grads = torch.autograd.grad(loss, leaves(req))
    return loss.detach(), unflatten(params, grads)
