"""The forward-only guard of the kernel wrappers.

A wrapper whose kernel has no backward (K1-K5, K9) would hand autograd a
tensor cut from the graph: ``loss.backward()`` would run and leave every
weight before it without a gradient.  So such a wrapper raises instead,
whenever grad mode is on and one of its inputs requires grad -- on the
card, and on the CPU where a test forces the kernel route.  K6, K7 and
K8 (all three variants) have backward kernels -- K10, K12 and K11 -- and
autograd reaches each pair through its ``ops`` module
(``flash_attention.ops.flash_attention``, ``ssd_scan.ops.ssd_scan``,
``rmsnorm.ops.rmsnorm`` / ``add_rmsnorm`` / ``gated_rmsnorm``); their raw
wrappers, and the backward wrappers themselves, raise the same way when
called directly, naming that entry point.
"""
from __future__ import annotations

import torch

BACKWARD_ITEM = "ROADMAP.md §2, 'Backward kernels'"


def _needs_grad(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, dict):
        return any(_needs_grad(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_needs_grad(v) for v in x)
    return False


def autograd_wants(*inputs) -> bool:
    """Whether autograd would record a call on ``inputs`` (tensors, or
    dicts / lists of them): grad mode is on and one requires grad."""
    return torch.is_grad_enabled() and _needs_grad(inputs)


def forbid_grad(kernel: str, *inputs, use: str = "") -> None:
    """Raise ``NotImplementedError`` where :func:`autograd_wants` the call.
    ``use`` names the differentiable entry point, where there is one."""
    if not autograd_wants(*inputs):
        return
    if use:
        raise NotImplementedError(
            f"{kernel} records no autograd graph when called directly; "
            f"{use}")
    raise NotImplementedError(
        f"{kernel} is a forward-only kernel: it has no backward kernel "
        f"({BACKWARD_ITEM})")
