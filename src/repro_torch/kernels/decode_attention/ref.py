"""Plain versions of the decode kernels (the port of
``repro.kernels.decode_attention.ref``).

``decode_attention_ref`` (also named ``dense_decode_attention_ref``):
naive attention over the valid prefix of a dense cache (K5's plain
version, the mirror of ``ops.decode_attention``).  ``paged_decode_attention_ref``:
gather-then-attend -- materialize each request's pages into a dense cache,
place the current token at slot ``lengths[b]`` and run the naive reference
over the valid prefix (kv_len = lengths + 1); ``k_off`` / ``v_off`` are
absolute columns of the token row (K4's plain version).
"""
from __future__ import annotations

import torch

from ...models.attention import reference_attention


def decode_attention_ref(q, k_cache, v_cache, kv_len):
    """q (B, 1, H, Dh); caches (B, T, Hkv, Dh); kv_len valid slots."""
    return reference_attention(q, k_cache, v_cache, causal=False,
                               kv_len=kv_len)


dense_decode_attention_ref = decode_attention_ref


def paged_decode_attention_ref(q, cur_k, cur_v, pool_rows, page_rows,
                               lengths, *, chunk, k_off, v_off, hkv):
    b, _one, h, dh = q.shape
    t = page_rows.shape[1] * chunk
    rows_idx = (page_rows.long()[:, :, None] * chunk
                + torch.arange(chunk, device=q.device)).reshape(b, t)
    gathered = pool_rows[rows_idx]                    # (B, T, token_row)
    kc = gathered[..., k_off:k_off + hkv * dh].reshape(b, t, hkv, dh)
    vc = gathered[..., v_off:v_off + hkv * dh].reshape(b, t, hkv, dh)
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    slot = torch.arange(t, device=q.device)[None, :] == lengths[:, None]
    kc = torch.where(slot[..., None, None], cur_k.to(kc.dtype), kc)
    vc = torch.where(slot[..., None, None], cur_v.to(vc.dtype), vc)
    return reference_attention(q, kc, vc, causal=False, kv_len=lengths + 1)
