"""Shared neural building blocks (plain functions over parameter dicts).

The port of ``repro.models.layers``: precision-sensitive math (norms,
activations, rotary angles) runs in fp32 and casts back, at exactly the
points the JAX package casts, so fp32 outputs agree within the kernels'
tolerance and bf16 values round at the same places.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.rmsnorm.ref import (add_rmsnorm_ref, gated_rmsnorm_ref,
                                   rmsnorm_ref)


def _rmsnorm_kernel_eligible(x) -> bool:
    return x.is_cuda


def rmsnorm(x, w, eps: float = 1e-5):
    """RMSNorm over the last dim: CUDA tensors go to K8
    (``kernels/rmsnorm/csrc/rmsnorm.cu``), CPU tensors take the plain
    code."""
    if _rmsnorm_kernel_eligible(x):
        from ..kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel
        return rmsnorm_kernel(x, w, eps)
    return rmsnorm_ref(x, w, eps)


def add_rmsnorm(x, r, w, eps: float = 1e-5):
    """The residual add and the norm after it: (h, rmsnorm(h)) with
    h = x + r.  CUDA tensors go to K8's add variant (one launch writes h
    and the norm), CPU tensors take the eager add and the plain norm."""
    if _rmsnorm_kernel_eligible(x):
        from ..kernels.rmsnorm.ops import add_rmsnorm as kernel
        return kernel(x, r, w, eps)
    return add_rmsnorm_ref(x, r, w, eps)


def gated_rmsnorm(y, z, w, eps: float = 1e-5):
    """Mamba2's gated norm, rmsnorm(y * silu(z)) in z's dtype (y the
    scan's fp32 output, each factor rounded to z's dtype as the JAX
    package rounds them).  CUDA tensors go to K8's gate variant, CPU
    tensors take the eager passes and the plain norm."""
    if _rmsnorm_kernel_eligible(y):
        from ..kernels.rmsnorm.ops import gated_rmsnorm as kernel
        return kernel(y, z, w, eps)
    return gated_rmsnorm_ref(y, z, w, eps)


class MetaGenerator:
    """A stand-in generator on the meta device: ``init_params`` given one
    builds the parameter tree's shapes and dtypes and allocates nothing
    (``transformer.abstract_params``)."""
    device = torch.device("meta")


def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None):
    """N(0, 1) * scale (default fan_in ** -0.5), drawn on the generator's
    device in fp32 and cast (on the meta device: an empty tensor)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


def swiglu_init(generator, d_model: int, d_ff: int, dtype):
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype),
        "w_up": dense_init(generator, (d_model, d_ff), dtype),
        "w_down": dense_init(generator, (d_ff, d_model), dtype),
    }


def swiglu(p, x):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Rotary embeddings (standard RoPE; M-RoPE broadcasts text positions)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, mrope: bool = False):
    """x: (..., S, H, Dh); positions: (..., S) int32 (or (..., S, 3) for
    M-RoPE; text-only positions are broadcast to all three sections, so
    M-RoPE on pure text equals RoPE)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)           # (Dh/2,)
    if mrope:
        if positions.dim() == x.dim() - 2:
            positions = positions.unsqueeze(-1).expand(
                *positions.shape, 3)
        nf = freqs.shape[0]
        sec = [nf - 2 * (nf // 3), nf // 3, nf // 3]
        sel = torch.tensor([i for i, n in enumerate(sec) for _ in range(n)],
                           device=x.device)     # section of each frequency
        pos = torch.gather(positions.float(), -1,
                           sel.expand(*positions.shape[:-1], nf))
        angles = pos * freqs
    else:
        angles = positions.float().unsqueeze(-1) * freqs
    cos = torch.cos(angles).unsqueeze(-2)                  # (..., S, 1, Dh/2)
    sin = torch.sin(angles).unsqueeze(-2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy: never materializes (B, S, V) logits
# ---------------------------------------------------------------------------

def _xent_chunk(h, w_head, lab):
    """(sum of the chunk's token losses, its live-token count), fp32."""
    logits = (h @ w_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab.clamp_min(0).long()[..., None])[
        ..., 0]
    mask = (lab >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(hidden, w_head, labels, chunk: int = 512):
    """Mean token cross-entropy over sequence chunks (the port of
    ``repro.models.layers.chunked_xent``).

    hidden: (B, S, D); w_head: (D, V); labels: (B, S) int (-1 = masked).
    Each chunk's logits run under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` of its scan body), so the backward also
    holds one chunk of logits at a time; the chunks' sums add in order,
    as the scan's carry adds them.  Positions past the last whole chunk
    are dropped, as in the JAX package.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n = s // chunk
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        loss, c = checkpoint(_xent_chunk, hidden[:, sl], w_head,
                             labels[:, sl], use_reentrant=False)
        tot = tot + loss
        cnt = cnt + c
    return tot / torch.clamp_min(cnt, 1.0)
