"""Public wrapper: causal GQA flash attention over (B, S, H, Dh) tensors
(the JAX ``ops.py`` contract).  The TPU wrapper transposed to
(B, H, S, Dh) and padded Dh to 128; the kernel reads the model's layout
in place, so nothing is copied here."""
from __future__ import annotations

from .kernel import flash_prefill
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref"]


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len=None):
    """q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's
    dtype; query i sits at kv position ``q_offset + i``; slots at or past
    ``kv_len`` are masked."""
    return flash_prefill(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
