"""Public wrapper: causal GQA flash attention over (B, S, H, Dh) tensors
(the JAX ``ops.py`` contract), differentiable.  The TPU wrapper transposed
to (B, H, S, Dh) and padded Dh to 128; the kernels read the model's layout
in place, so nothing is copied here.

When autograd needs the call (grad mode on and an operand that requires
grad), it runs as a ``torch.autograd.Function``: the forward launches K6
(``kernel.flash_prefill``) with its LSE write on and saves q, k, v, the
output and the LSE; the backward launches K10 (``kernel.flash_backward``),
which reads that LSE instead of recomputing it.  Otherwise it is K6's
wrapper alone.  On CPU tensors both wrappers run their plain versions."""
from __future__ import annotations

import torch

from .._guard import autograd_wants
from .kernel import flash_backward, flash_prefill
from .ref import flash_attention_backward_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref",
           "flash_attention_backward_ref"]


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len):
        out, lse = flash_prefill(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, kv_len = ctx.mask
        dq, dk, dv = flash_backward(q, k, v, out, dout, lse=lse,
                                    causal=causal, q_offset=q_offset,
                                    kv_len=kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len=None):
    """q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's
    dtype; query i sits at kv position ``q_offset + i``; slots at or past
    ``kv_len`` are masked."""
    if autograd_wants(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, int(q_offset),
                                     None if kv_len is None else int(kv_len))
    return flash_prefill(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
