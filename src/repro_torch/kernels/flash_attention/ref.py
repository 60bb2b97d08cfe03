"""Plain version of the flash-prefill kernel (the port of
``repro.kernels.flash_attention.ref``): naive masked softmax attention.

It differs from the kernel on a row with no live key (``kv_len`` at or
below the query's first visible position): the softmax over all-masked
scores gives the mean of V there, the kernel gives 0 (p = 0 while the
running max is still NEG_INF), as the TPU kernel does.  Prefill never
reaches such a row: the causal diagonal is always live.
"""
from __future__ import annotations

from ...models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len=None):
    return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
