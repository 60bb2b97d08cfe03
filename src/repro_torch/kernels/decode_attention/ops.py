"""Public wrappers: dense-cache and paged-pool flash decode (the JAX
``ops.py`` contracts).

``decode_attention``: (B, 1, H, Dh) query + (B, T, Hkv, Dh) caches + one
scalar ``kv_len``.  ``paged_decode_attention``: (B, 1, H, Dh) query + the
LeaseEngine pool's (n_rows, token_row) view + per-request page tables /
lengths + the current token's fresh (k, v) -- KV never leaves its pool
pages.
"""
from __future__ import annotations

from .kernel import dense_decode, paged_decode
from .ref import (decode_attention_ref, dense_decode_attention_ref,
                  paged_decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref",
           "dense_decode_attention_ref", "paged_decode_attention",
           "paged_decode_attention_ref"]


def decode_attention(q, k_cache, v_cache, kv_len):
    """q: (B, 1, H, Dh); caches: (B, T, Hkv, Dh), read in place (no
    transpose, no head-dim padding); kv_len: scalar valid slots."""
    b, _one, h, dh = q.shape
    hkv = k_cache.shape[2]
    out = dense_decode(q.reshape(b, hkv, h // hkv, dh).contiguous(),
                       k_cache, v_cache, kv_len, scale=dh ** -0.5)
    return out.reshape(b, 1, h, dh)


def paged_decode_attention(q, cur_k, cur_v, pool_rows, page_rows, lengths,
                           *, chunk: int, k_off: int, v_off: int, hkv: int,
                           pool_off: int = 0):
    """q: (B, 1, H, Dh); cur_k/cur_v: (B, 1, Hkv, Dh) already RoPE'd;
    pool_rows: (n_blocks*chunk, token_row); page_rows: (B, P) int32;
    lengths: (B,) int32.  ``k_off`` / ``v_off`` are the layer's columns
    inside its stack's segment, ``pool_off`` the segment's offset inside
    the interleaved token row."""
    b, _one, h, dh = q.shape
    g = h // hkv
    out = paged_decode(
        q.reshape(b, hkv, g, dh).contiguous(),
        cur_k.reshape(b, hkv, dh).contiguous(),
        cur_v.reshape(b, hkv, dh).contiguous(), pool_rows,
        page_rows, lengths, chunk=chunk, k_off=pool_off + k_off,
        v_off=pool_off + v_off, scale=dh ** -0.5)
    return out.reshape(b, 1, h, dh)
