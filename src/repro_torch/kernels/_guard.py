"""The forward-only guard of the kernel wrappers.

A wrapper whose kernel has no backward (K1-K5, K7, K8's gate variant, K9)
would hand autograd a tensor cut from the graph: ``loss.backward()`` would
run and leave every weight before it without a gradient.  So such a
wrapper raises instead, whenever grad mode is on and one of its inputs
requires grad -- on the card, and on the CPU where a test forces the
kernel route.  K6 and K8's plain and add variants are differentiable
through ``flash_attention.ops.flash_attention`` and ``rmsnorm.ops.rmsnorm``
/ ``add_rmsnorm`` (their backward kernels K10 and K11); their wrappers
raise the same way when called directly.
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
    if autograd_wants(*inputs):
        raise NotImplementedError(
            f"{kernel} is a forward-only kernel: it has no backward "
            f"kernel ({BACKWARD_ITEM})" + (f"; {use}" if use else ""))
