"""Serving paths for the dense family: prefill, suffix prefill and the
paged single-token decode (the port of ``repro.models.decoding``).

Caches keep the JAX layout: ``{"k", "v"}`` each (L, B, T, Hkv, Dh).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.tardis_lease.kernel import scatter_rows
from .layers import rmsnorm, swiglu
from .transformer import (Params, _embed, attn_decode_paged, attn_prefill,
                          attn_prefill_cached, logits_fn)

Cache = Dict[str, Any]

# families whose decode KV can live in LeaseEngine pool pages.  The JAX
# package also pages the moe family (dual stacks); the port adds it with
# the moe slice.
PAGED_FAMILIES = ("dense", "vlm")


class StackSpec(NamedTuple):
    """One paged KV cache stack and where its segment lives inside the
    engine's interleaved pool token row."""
    pool: str           # LeaseEngine pool name
    params_key: str     # p[...] layer params
    cache_keys: Tuple[str, str]   # dense-cache (k, v) names for this stack
    n_layers: int       # layers in this stack
    kind: str           # "mlp" (the layer body after attention)
    offset: int         # element column offset of the segment in the row
    token_elems: int    # unpadded elements per token (2 * n_layers*hk*dh)


def pool_layout(cfg: ArchConfig) -> List[StackSpec]:
    """Ordered cache stacks of a paged family and their token-row layout:
    one stack's per-token segment packs all its layers' K then all its
    layers' V and is lane-padded (the serving cluster asserts the engine
    computed the same offsets)."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"no paged layout for family {cfg.family!r} in the port")
    te = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim()
    return [StackSpec("kv", "layers", ("k", "v"), cfg.n_layers, "mlp", 0, te)]


def decode_step_paged(cfg: ArchConfig, p: Params, pool_rows, page_rows,
                      lengths, tokens, *, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step where every KV byte lives in LeaseEngine pool pages.

    ``pool_rows``: the engine pool's (n_blocks*chunk, token_row) view;
    ``page_rows``: (B, P) int32 page tables; ``lengths``: (B,) int32 tokens
    already in pages (== the decode position); ``tokens``: (B, 1) int32,
    all on the pool's device.  Every layer's fresh K and V for the new
    token gather into ONE token row, which K3's scatter writes into its
    page **in place** -- the JAX version donated the pool buffer and
    returned a new one.  Returns (pool_rows, logits (B, 1, V)).
    """
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged decode supports the dense family, not {cfg.family!r}")
    x = _embed(cfg, p, {"tokens": tokens})
    b = x.shape[0]
    hkd = cfg.n_kv_heads * cfg.head_dim()
    lengths = lengths.to(torch.int32)
    page_rows = page_rows.to(torch.int32)
    row_buf = torch.zeros((b, pool_rows.shape[1]), dtype=pool_rows.dtype,
                          device=pool_rows.device)
    for spec in pool_layout(cfg):
        for li in range(spec.n_layers):
            layer = p[spec.params_key][li]
            y, kd, vd = attn_decode_paged(
                layer["attn"], cfg, x, pool_rows, page_rows, lengths,
                li * hkd, (spec.n_layers + li) * hkd, pool_off=spec.offset,
                chunk=chunk)
            x = x + y
            xn = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
            x = x + swiglu(layer["mlp"], xn)
            k_off = spec.offset + li * hkd
            v_off = spec.offset + (spec.n_layers + li) * hkd
            row_buf[:, k_off:k_off + hkd] = kd.reshape(b, hkd)
            row_buf[:, v_off:v_off + hkd] = vd.reshape(b, hkd)
    # ONE append per step: the token's whole row lands in its page
    ar = torch.arange(b, device=pool_rows.device)
    flat_idx = (page_rows[ar, (lengths // chunk).long()] * chunk
                + lengths % chunk).to(torch.int32)
    scatter_rows(pool_rows, flat_idx, row_buf)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return pool_rows, logits_fn(cfg, p, x)


# ---------------------------------------------------------------------------
# Prefill: full forward that also materializes the caches
# ---------------------------------------------------------------------------

def _last_logits(cfg, p, x, last_idx):
    """Logits at the prompt's true last position (``None``: the trailing
    one); callers right-pad prompts to a bucket and pass the real index."""
    if last_idx is None:
        return logits_fn(cfg, p, x[:, -1:])
    li = int(last_idx)
    return logits_fn(cfg, p, x[:, li:li + 1])


def prefill(cfg: ArchConfig, p: Params, batch, cache_len: int,
            dtype=torch.bfloat16, last_idx=None) -> Tuple[Cache,
                                                         torch.Tensor]:
    """Processes the prompt, returns (cache, last-token logits)."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    x = _embed(cfg, p, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    ks, vs = [], []
    for layer in p["layers"]:
        y, (kc, vc) = attn_prefill(layer["attn"], cfg, x, positions,
                                   cache_len)
        x = x + y
        xn = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(layer["mlp"], xn)
        ks.append(kc.to(dtype))
        vs.append(vc.to(dtype))
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return ({"k": torch.stack(ks), "v": torch.stack(vs)},
            _last_logits(cfg, p, x, last_idx))


def prefill_suffix(cfg: ArchConfig, p: Params, batch, cache: Cache,
                   prefix_len: int, last_idx=None) -> Tuple[Cache,
                                                            torch.Tensor]:
    """Chunked prefill that skips the prompt's leased prefix: ``cache``
    arrives with its first ``prefix_len`` slots holding the prefix KV,
    ``batch["tokens"]`` carries only the suffix."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"prefix-KV suffix prefill supports the dense family, not "
            f"{cfg.family!r}")
    x = _embed(cfg, p, batch)
    b, s, _ = x.shape
    positions = (prefix_len + torch.arange(
        s, dtype=torch.int32, device=x.device)).expand(b, s)
    out: Cache = {}
    for spec in pool_layout(cfg):
        ck, cv = spec.cache_keys
        ks, vs = [], []
        for li, layer in enumerate(p[spec.params_key]):
            y, kc, vc = attn_prefill_cached(layer["attn"], cfg, x, positions,
                                            cache[ck][li], cache[cv][li],
                                            prefix_len)
            x = x + y
            xn = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
            x = x + swiglu(layer["mlp"], xn)
            ks.append(kc)
            vs.append(vc)
        out[ck], out[cv] = torch.stack(ks), torch.stack(vs)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return out, _last_logits(cfg, p, x, last_idx)
