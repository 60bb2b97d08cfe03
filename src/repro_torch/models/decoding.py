"""Serving paths: cache init, prefill, dense-cache decode, suffix prefill
and the paged single-token decode (the port of ``repro.models.decoding``).

Caches keep the JAX layout, stacked on a leading layer axis:
  * dense/vlm: ``{"k", "v"}`` each (L, B, T, Hkv, Dh);
  * moe: ``{"k", "v"}`` for the moe layers and, with leading dense layers
    (kimi), ``{"dk", "dv"}`` for those: two cache stacks, which the paged
    path lays side by side in one pool token row (``pool_layout``);
  * ssm: ``{"state"}`` (L, B, H, P, N) fp32 and ``{"conv"}`` (L, B, K-1, C);
  * hybrid: those two plus ``{"ak", "av"}`` (n_app, B, T, Hkv, Dh) for the
    shared attention block's per-application caches;
  * encdec: ``{"k", "v"}`` for the decoder's self-attention and ``{"ck",
    "cv"}`` (L, B, S_enc, Hkv, Dh), each decoder layer's cross-attention
    K/V of the encoder output, written once by the prefill.  As in the JAX
    package, its prefill writes the cache in bf16 whatever ``dtype`` says
    (``_encdec_prefill`` takes the dtype; ``prefill`` does not pass it).
    The paged paths stay decoder-only.
``decode_step`` writes the new token's K/V row and SSM state **in place**
(the JAX version rebuilt the stacked caches every step: a whole-cache copy
per token in eager PyTorch); only the small conv buffer is rebuilt, so its
dtype follows the JAX promotion of buffer and new input.

Every layer loop carries the residual stream ``x`` and the last
sublayer's output ``r`` not yet added to it: the next norm adds it in the
same call (``residual_norm``; K8's add variant on the card), and only a
Mamba2 block, which has no norm before its input projection, reads the
sum materialised (``settle``).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.tardis_lease.kernel import LANES, scatter_rows
from .ssm import ssm_block
from .transformer import (ATTN_FAMILIES, PORTED_FAMILIES, Params,
                          _cross_after, _embed, _mlp_after, attn_decode,
                          attn_decode_paged, attn_prefill,
                          attn_prefill_cached, enc_kv_of, encode, logits_fn,
                          residual_norm, settle)

Cache = Dict[str, Any]

# families whose decode KV can live in LeaseEngine pool pages: every
# attention-cache family (an SSM state is not position-addressable
# block-wise; moe pages BOTH its cache stacks through named pools
# interleaved in one token row)
PAGED_FAMILIES = ATTN_FAMILIES


class StackSpec(NamedTuple):
    """One paged KV cache stack and where its segment lives inside the
    engine's interleaved pool token row."""
    pool: str           # LeaseEngine pool name
    params_key: str     # p[...] layer params
    cache_keys: Tuple[str, str]   # dense-cache (k, v) names for this stack
    n_layers: int       # layers in this stack
    kind: str           # "mlp" | "moe" (the layer body after attention)
    offset: int         # element column offset of the segment in the row
    token_elems: int    # unpadded elements per token (2 * n_layers*hk*dh)


def pool_layout(cfg: ArchConfig) -> List[StackSpec]:
    """Ordered cache stacks of a paged family and their token-row layout:
    one stack's per-token segment packs all its layers' K then all its
    layers' V and is lane-padded; segments lie back to back in
    forward-pass order, so the moe family's leading dense stack comes
    first (the serving cluster asserts the engine computed the same
    offsets).  The dense-cache paths walk the same stacks."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"no paged layout for family {cfg.family!r} in the port")
    if cfg.family == "moe":
        stacks = []
        if cfg.first_dense_layers:
            stacks.append(("dense", "dense_layers", ("dk", "dv"),
                           cfg.first_dense_layers, "mlp"))
        stacks.append(("moe", "layers", ("k", "v"),
                       cfg.n_layers - cfg.first_dense_layers, "moe"))
    else:
        stacks = [("kv", "layers", ("k", "v"), cfg.n_layers, "mlp")]
    hkd = cfg.n_kv_heads * cfg.head_dim()
    out, off = [], 0
    for pool, pkey, ckeys, n, kind in stacks:
        te = 2 * n * hkd
        out.append(StackSpec(pool, pkey, ckeys, n, kind, off, te))
        off += -(-te // LANES) * LANES
    return out


def _attn_cache(cfg, n, b, t, dtype, device):
    hk, dh = cfg.n_kv_heads, cfg.head_dim()
    return (torch.zeros((n, b, t, hk, dh), dtype=dtype, device=device),
            torch.zeros((n, b, t, hk, dh), dtype=dtype, device=device))


def _ssm_cache(cfg, n, b, dtype, device):
    h, pd, ns = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    c = cfg.d_inner + 2 * cfg.ssm_state
    return (torch.zeros((n, b, h, pd, ns), dtype=torch.float32, device=device),
            torch.zeros((n, b, cfg.conv_width - 1, c), dtype=dtype,
                        device=device))


def init_cache(cfg: ArchConfig, b: int, t: int, dtype=torch.bfloat16,
               device="cpu", enc_len: int = 0) -> Cache:
    """Zeroed decode caches of the ported families (``enc_len``: the
    encdec cross-attention caches' length)."""
    fam = cfg.family
    if fam in ATTN_FAMILIES:
        out = {}
        for spec in pool_layout(cfg):
            k, v = _attn_cache(cfg, spec.n_layers, b, t, dtype, device)
            out.update(zip(spec.cache_keys, (k, v)))
        return out
    if fam == "ssm":
        s, c = _ssm_cache(cfg, cfg.n_layers, b, dtype, device)
        return {"state": s, "conv": c}
    if fam == "hybrid":
        n_app = cfg.n_layers // cfg.attn_every
        s, c = _ssm_cache(cfg, cfg.n_layers, b, dtype, device)
        ak, av = _attn_cache(cfg, n_app, b, t, dtype, device)
        return {"state": s, "conv": c, "ak": ak, "av": av}
    if fam == "encdec":
        k, v = _attn_cache(cfg, cfg.n_layers, b, t, dtype, device)
        ck, cv = _attn_cache(cfg, cfg.n_layers, b, enc_len, dtype, device)
        return {"k": k, "v": v, "ck": ck, "cv": cv}
    raise NotImplementedError(f"family {fam!r} is not ported yet")


def _ssm_layers_decode(cfg, layers, x, r, cache, lo: int, convs: List):
    """Decode through Mamba2 blocks ``layers`` (cache rows lo, lo+1, ...)
    over the residual stream x + r: the fp32 state updates in place, each
    new conv tail goes to ``convs``.  Returns (x, the last block's output,
    pending)."""
    for i, layer in enumerate(layers):
        x = settle(x, r)
        state = cache["state"][lo + i]
        r, (s2, c2) = ssm_block(layer["ssm"], cfg, x,
                                decode_state=(state, cache["conv"][lo + i]))
        state.copy_(s2)
        convs.append(c2)
    return x, r


def decode_step(cfg: ArchConfig, p: Params, cache: Cache, tokens,
                cur_idx) -> Tuple[Cache, torch.Tensor]:
    """tokens: (B, 1) int32; cur_idx: the next cache slot -- an int or a
    0-d int32 tensor on the cache's device (a wave in lockstep) -- or a
    (B,) vector for the attention-cache families.

    Returns (cache, logits (B, 1, V)); ``cache`` is the argument, updated
    in place except for its rebuilt ``conv`` entry."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {fam!r} is not ported yet")
    x = p["embed"][tokens.long()]
    r = None
    new_cache = dict(cache)
    if fam in ATTN_FAMILIES:
        for spec in pool_layout(cfg):
            ck, cv = spec.cache_keys
            for li, layer in enumerate(p[spec.params_key]):
                x, xn = residual_norm(x, r, layer["attn"]["norm"],
                                      cfg.norm_eps)
                y, _kc, _vc = attn_decode(layer["attn"], cfg, xn,
                                          cache[ck][li], cache[cv][li],
                                          cur_idx)
                x, r = _mlp_after(cfg, layer, x, y)
    elif fam == "ssm":
        convs: List = []
        x, r = _ssm_layers_decode(cfg, p["layers"], x, r, cache, 0, convs)
        new_cache["conv"] = torch.stack(convs)
    elif fam == "encdec":
        for li, layer in enumerate(p["dec_layers"]):
            x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
            y, _kc, _vc = attn_decode(layer["attn"], cfg, xn, cache["k"][li],
                                      cache["v"][li], cur_idx)
            x, y = _cross_after(cfg, layer, x, y,
                                (cache["ck"][li], cache["cv"][li]))
            x, r = _mlp_after(cfg, layer, x, y)
    else:                                           # hybrid
        convs = []
        shared = p["shared"]
        for a, group in enumerate(p["groups"]):
            x, r = _ssm_layers_decode(cfg, group, x, r, cache,
                                      a * cfg.attn_every, convs)
            x, xn = residual_norm(x, r, shared["attn"]["norm"], cfg.norm_eps)
            y, _kc, _vc = attn_decode(shared["attn"], cfg, xn,
                                      cache["ak"][a], cache["av"][a], cur_idx)
            x, r = _mlp_after(cfg, shared, x, y)
        new_cache["conv"] = torch.stack(convs)
    x = residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]
    return new_cache, logits_fn(cfg, p, x)


def decode_step_paged(cfg: ArchConfig, p: Params, pool_rows, page_rows,
                      lengths, tokens, *, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step where every KV byte lives in LeaseEngine pool pages.

    ``pool_rows``: the engine pool's (n_blocks*chunk, token_row) view;
    ``page_rows``: (B, P) int32 page tables; ``lengths``: (B,) int32 tokens
    already in pages (== the decode position); ``tokens``: (B, 1) int32,
    all on the pool's device.  Every layer's fresh K and V for the new
    token -- every cache stack's, each at its segment offset -- gather
    into ONE token row, which K3's scatter writes into its page **in
    place** (the JAX version donated the pool buffer and returned a new
    one).  Returns (pool_rows, logits (B, 1, V)).
    """
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged decode supports the attention-cache families, not "
            f"{cfg.family!r}")
    x = _embed(cfg, p, {"tokens": tokens})
    b = x.shape[0]
    hkd = cfg.n_kv_heads * cfg.head_dim()
    lengths = lengths.to(torch.int32)
    page_rows = page_rows.to(torch.int32)
    row_buf = torch.zeros((b, pool_rows.shape[1]), dtype=pool_rows.dtype,
                          device=pool_rows.device)
    r = None
    for spec in pool_layout(cfg):
        for li in range(spec.n_layers):
            layer = p[spec.params_key][li]
            x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
            y, kd, vd = attn_decode_paged(
                layer["attn"], cfg, xn, pool_rows, page_rows, lengths,
                li * hkd, (spec.n_layers + li) * hkd, pool_off=spec.offset,
                chunk=chunk)
            x, r = _mlp_after(cfg, layer, x, y)
            k_off = spec.offset + li * hkd
            v_off = spec.offset + (spec.n_layers + li) * hkd
            row_buf[:, k_off:k_off + hkd] = kd.reshape(b, hkd)
            row_buf[:, v_off:v_off + hkd] = vd.reshape(b, hkd)
    # ONE append per step: the token's whole row (both stacks' segments
    # in the moe family) lands in its page
    ar = torch.arange(b, device=pool_rows.device)
    flat_idx = (page_rows[ar, (lengths // chunk).long()] * chunk
                + lengths % chunk).to(torch.int32)
    scatter_rows(pool_rows, flat_idx, row_buf)
    x = residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]
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
    """Processes the prompt, returns (cache, last-token logits).  Each
    layer's KV / state is written into a preallocated stacked cache (no
    ``torch.stack`` of per-layer copies)."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {fam!r} is not ported yet")
    if fam == "encdec":
        return _encdec_prefill(cfg, p, batch, cache_len)
    x = _embed(cfg, p, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache = init_cache(cfg, b, cache_len, dtype, x.device)

    def attn_layer(layer, x, r, kcache, vcache):
        x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
        y, (kc, vc) = attn_prefill(layer["attn"], cfg, xn, positions,
                                   cache_len)
        kcache.copy_(kc)
        vcache.copy_(vc)
        return _mlp_after(cfg, layer, x, y)

    def ssm_layers(layers, x, r, lo):
        for i, layer in enumerate(layers):
            x = settle(x, r)
            r, (st, cv) = ssm_block(layer["ssm"], cfg, x)
            cache["state"][lo + i].copy_(st)
            cache["conv"][lo + i].copy_(cv)
        return x, r

    r = None
    if fam in ATTN_FAMILIES:
        for spec in pool_layout(cfg):
            ck, cv = spec.cache_keys
            for li, layer in enumerate(p[spec.params_key]):
                x, r = attn_layer(layer, x, r, cache[ck][li], cache[cv][li])
    elif fam == "ssm":
        x, r = ssm_layers(p["layers"], x, r, 0)
    else:                                           # hybrid
        for a, group in enumerate(p["groups"]):
            x, r = ssm_layers(group, x, r, a * cfg.attn_every)
            x, r = attn_layer(p["shared"], x, r, cache["ak"][a],
                              cache["av"][a])
    x = residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]
    return cache, _last_logits(cfg, p, x, last_idx)


def _encdec_prefill(cfg, p, batch, cache_len, dtype=torch.bfloat16):
    """Whisper's prefill: the encoder over ``batch["frames"]``, then the
    decoder prompt; each decoder layer's cross-attention reads its (K, V)
    of the encoder output as computed and the cache keeps them in
    ``dtype``, as the self-attention's K/V (the JAX package's casts).
    Returns (cache, the last position's logits)."""
    enc = encode(cfg, p, batch["frames"])
    x = _embed(cfg, p, batch)
    b, sd, _ = x.shape
    dpos = torch.arange(sd, dtype=torch.int32, device=x.device).expand(b, sd)
    cache = init_cache(cfg, b, cache_len, dtype, x.device,
                       enc_len=enc.shape[1])
    r = None
    for li, layer in enumerate(p["dec_layers"]):
        x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
        y, (kc, vc) = attn_prefill(layer["attn"], cfg, xn, dpos, cache_len)
        cache["k"][li].copy_(kc)
        cache["v"][li].copy_(vc)
        ck, cv = enc_kv_of(layer["cross"], cfg, enc)
        x, y = _cross_after(cfg, layer, x, y, (ck, cv))
        cache["ck"][li].copy_(ck)
        cache["cv"][li].copy_(cv)
        x, r = _mlp_after(cfg, layer, x, y)
    x = residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]
    return cache, logits_fn(cfg, p, x[:, -1:])


def prefill_suffix(cfg: ArchConfig, p: Params, batch, cache: Cache,
                   prefix_len: int, last_idx=None) -> Tuple[Cache,
                                                            torch.Tensor]:
    """Chunked prefill that skips the prompt's leased prefix: ``cache``
    arrives with its first ``prefix_len`` slots holding the prefix KV,
    ``batch["tokens"]`` carries only the suffix."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"prefix-KV suffix prefill supports the attention-cache "
            f"families, not {cfg.family!r}")
    x = _embed(cfg, p, batch)
    b, s, _ = x.shape
    positions = (prefix_len + torch.arange(
        s, dtype=torch.int32, device=x.device)).expand(b, s)
    out: Cache = {}
    r = None
    for spec in pool_layout(cfg):
        ck, cv = spec.cache_keys
        ks, vs = [], []
        for li, layer in enumerate(p[spec.params_key]):
            x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
            y, kc, vc = attn_prefill_cached(layer["attn"], cfg, xn,
                                            positions, cache[ck][li],
                                            cache[cv][li], prefix_len)
            x, r = _mlp_after(cfg, layer, x, y)
            ks.append(kc)
            vs.append(vc)
        out[ck], out[cv] = torch.stack(ks), torch.stack(vs)
    x = residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]
    return out, _last_logits(cfg, p, x, last_idx)
