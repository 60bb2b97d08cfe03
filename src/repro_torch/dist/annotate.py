"""Activation sharding annotations bound to the ambient mesh (the port of
``repro.dist.annotate``).

Model code calls :func:`batch_activations` on residual streams and
:func:`replicate` on tiny decode activations.  Under a mesh in scope
(:func:`use_mesh`, the dry run's ``with use_mesh(mesh):``) these
redistribute a ``DTensor`` to the placements :mod:`.sharding` gives it --
``Tensor.redistribute``, which autograd differentiates, so values and
gradients are unchanged; outside any mesh, and on plain tensors, they are
exact no-ops, so the same model code runs unannotated on one device.
"""
from __future__ import annotations

import contextlib
import threading

from .sharding import activation_spec, placements

_STATE = threading.local()


def ambient_mesh():
    """The ``DeviceMesh`` in scope (:func:`use_mesh`), or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Put ``mesh`` in scope for the annotations (nested scopes restore
    the outer one)."""
    prev = ambient_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_activations(x):
    """Constrain an activation to batch-over-DP plus sequence-over-model
    (:func:`.sharding.activation_spec`).  No-op without an ambient mesh,
    on a plain tensor, or when no dim divides its axes."""
    mesh = ambient_mesh()
    if mesh is None or x is None or x.dim() == 0 or not _is_dtensor(x):
        return x
    spec = activation_spec(mesh, x.shape)
    if all(ax is None for ax in spec):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def replicate(x):
    """Constrain to fully replicated; no-op without an ambient mesh or on
    a plain tensor."""
    mesh = ambient_mesh()
    if mesh is None or x is None or not _is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh, (None,) * x.dim()))
