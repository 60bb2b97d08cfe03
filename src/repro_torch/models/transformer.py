"""Model assembly for the dense/vlm, moe, ssm, hybrid and encdec families
(the port of ``repro.models.transformer``).

Parameters are a plain dict: ``embed`` (V, D), ``final_norm`` (D,),
``lm_head`` (D, V) unless tied, and per family
  * dense/vlm: ``layers`` -- a list with one dict per layer (``attn``
    {wq, wk, wv, wo, norm}, ``mlp`` {w_gate, w_up, w_down}, ``mlp_norm``);
  * moe: ``layers`` -- the moe layers (``attn``, ``moe`` {router, w_gate,
    w_up, w_down, shared?, residual?}, ``mlp_norm``) -- and, where the
    config has leading dense layers (kimi), ``dense_layers`` laid out as
    the dense family's, run first;
  * ssm: ``layers`` -- a list of ``{"ssm": {...}}`` Mamba2 blocks;
  * hybrid (zamba2): ``groups`` -- ``n_layers // attn_every`` lists of
    ``attn_every`` Mamba2 blocks each -- and ``shared``, ONE attention +
    MLP block (weight-shared) applied after every group;
  * encdec (whisper): ``enc_layers`` -- laid out as the dense family's,
    their self-attention non-causal -- and ``dec_layers`` (``attn``,
    ``cross`` {wq, wk, wv, wo, norm}, ``mlp``, ``mlp_norm``).  The encoder
    reads ``batch["frames"]`` (B, S_enc, d_model), the stub frontend's
    output (the conv stem is not modelled, as in the JAX package).
The JAX package stacks layers on leading axes for ``lax.scan``; PyTorch
runs eagerly, so the port loops over lists
(:func:`repro_torch.convert.params_from_jax` unstacks).  The JAX package's
``dist.annotate.replicate`` / ``batch_activations`` sharding hints are
numerical identities on one device and are dropped here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..tree import leaves as param_leaves  # every tensor of a param tree
from .attention import attend, decode_attention
from .layers import (add_rmsnorm, apply_rope, chunked_xent, dense_init,
                     rmsnorm, swiglu, swiglu_init)
from .moe import moe_apply, moe_init
from .ssm import ssm_block, ssm_init

Params = Dict[str, Any]

DENSE_FAMILIES = ("dense", "vlm")
# families whose layers are all attention + MLP (or MoE) blocks
ATTN_FAMILIES = DENSE_FAMILIES + ("moe",)
# families whose params, forward, prefill and dense-cache decode are ported
PORTED_FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid", "encdec")


# ---------------------------------------------------------------------------
# Attention block (params + apply), GQA + RoPE
#
# Each attention function takes ``xn``, its input after the pre-norm
# (``p["norm"]``), which the layer body computes with
# :func:`residual_norm`: the residual add that precedes a norm runs fused
# into it (K8's add variant on the card), so a sublayer's output stays
# pending until the next norm adds it.
# ---------------------------------------------------------------------------

def attn_init(generator, cfg: ArchConfig, dtype):
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.head_dim()
    return {
        "wq": dense_init(generator, (d, h * dh), dtype),
        "wk": dense_init(generator, (d, hk * dh), dtype),
        "wv": dense_init(generator, (d, hk * dh), dtype),
        "wo": dense_init(generator, (h * dh, d), dtype),
        "norm": torch.ones((d,), dtype=dtype, device=generator.device),
    }


def _qkv(p, cfg: ArchConfig, x):
    b, s, _ = x.shape
    dh = cfg.head_dim()
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, dh)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def attn_apply(p, cfg: ArchConfig, xn, positions, *, causal=True):
    """Self-attention over a full sequence (train / prefill)."""
    q, k, v = _qkv(p, cfg, xn)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    out = attend(q, k, v, causal=causal, window=cfg.sliding_window)
    b, s, _ = xn.shape
    return out.reshape(b, s, -1) @ p["wo"]


def attn_prefill(p, cfg, xn, positions, cache_len: int):
    """Prefill that also returns the KV cache, zero-padded to cache_len."""
    q, k, v = _qkv(p, cfg, xn)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    out = attend(q, k, v, causal=True, window=cfg.sliding_window)
    b, s, _ = xn.shape
    pad = cache_len - s
    kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return out.reshape(b, s, -1) @ p["wo"], (kc, vc)


def attn_prefill_cached(p, cfg, xn, positions, kc, vc, prefix_len: int):
    """Chunked prefill against a cache whose first ``prefix_len`` slots
    hold leased prefix KV; returns (y, kc, vc) with the suffix KV written
    (in the cache dtype) at [prefix_len, prefix_len + s)."""
    b, s, _ = xn.shape
    q, k, v = _qkv(p, cfg, xn)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    kc = kc.clone()
    vc = vc.clone()
    kc[:, prefix_len:prefix_len + s] = k.to(kc.dtype)
    vc[:, prefix_len:prefix_len + s] = v.to(vc.dtype)
    out = attend(q, kc, vc, causal=True, q_offset=prefix_len,
                 window=cfg.sliding_window, kv_len=prefix_len + s)
    return out.reshape(b, s, -1) @ p["wo"], kc, vc


def attn_decode(p, cfg, xn, kc, vc, cur_idx):
    """One-token decode: insert k/v at ``cur_idx``, attend over the cache.

    ``cur_idx`` is a scalar (a wave decoding in lockstep; an int or a 0-d
    int tensor on the cache's device) or a (B,) vector (each request at
    its own position).  The new row is written **in place** into ``kc`` /
    ``vc`` (the JAX version returned updated copies); a scalar index is
    clamped into the cache as ``dynamic_update_slice`` clamps it.  Returns
    (y, kc, vc).
    """
    b = xn.shape[0]
    q, k, v = _qkv(p, cfg, xn)
    cur = torch.as_tensor(cur_idx, dtype=torch.int32, device=xn.device)
    pos = cur.expand(b, 1) if cur.dim() == 0 else cur[:, None]
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope)
    if cur.dim() == 0:
        slot = cur.clamp(0, kc.shape[1] - 1).long().reshape(1)
        kc.index_copy_(1, slot, k.to(kc.dtype))
        vc.index_copy_(1, slot, v.to(vc.dtype))
    else:
        ar = torch.arange(b, device=xn.device)
        kc[ar, cur.long()] = k[:, 0].to(kc.dtype)
        vc[ar, cur.long()] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, cur + 1)
    return out.reshape(b, 1, -1) @ p["wo"], kc, vc


def _paged_kernel_eligible(pool_rows) -> bool:
    return pool_rows.is_cuda


def attn_decode_paged(p, cfg, xn, pool_rows, page_rows, lengths, k_off: int,
                      v_off: int, *, pool_off: int = 0, chunk: int):
    """One-token decode where the KV cache lives in LeaseEngine pool pages.

    ``pool_rows`` is the engine pool's (n_blocks*chunk, token_row) view,
    ``page_rows`` (B, P) int32 and ``lengths`` (B,) int32 on its device.
    On CUDA tensors attention runs in the paged-decode kernel (K4); on CPU
    tensors it takes the JAX package's gather path (gather the pages, place
    the current token, attend with the reference).  Returns (y, k_cur,
    v_cur): the fresh RoPE'd KV in the pool dtype.
    """
    b = xn.shape[0]
    q, k, v = _qkv(p, cfg, xn)
    pos = lengths.to(torch.int32)[:, None]
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope)
    hk, dh = cfg.n_kv_heads, cfg.head_dim()
    kd, vd = k.to(pool_rows.dtype), v.to(pool_rows.dtype)
    if _paged_kernel_eligible(pool_rows):
        from ..kernels.decode_attention.ops import paged_decode_attention
        out = paged_decode_attention(
            q, kd, vd, pool_rows, page_rows, lengths, chunk=chunk,
            k_off=k_off, v_off=v_off, hkv=hk, pool_off=pool_off)
    else:
        t = page_rows.shape[1] * chunk
        rows_idx = (page_rows.long()[:, :, None] * chunk
                    + torch.arange(chunk, device=xn.device)).reshape(b, t)
        gathered = pool_rows[rows_idx]                # (B, T, token_row)
        lo_k, lo_v = pool_off + k_off, pool_off + v_off
        kc = gathered[..., lo_k:lo_k + hk * dh].reshape(b, t, hk, dh)
        vc = gathered[..., lo_v:lo_v + hk * dh].reshape(b, t, hk, dh)
        slot = torch.arange(t, device=xn.device)[None, :] == pos
        kc = torch.where(slot[..., None, None], kd, kc)
        vc = torch.where(slot[..., None, None], vd, vc)
        out = decode_attention(q, kc, vc, pos[:, 0] + 1)
    return out.reshape(b, 1, -1) @ p["wo"], kd, vd


def cross_apply(p, cfg, xn, enc_kv):
    """Cross-attention of ``xn`` (the stream after ``p["norm"]``) over the
    encoder's precomputed (K, V): no RoPE, non-causal, through ``attend``
    (K6 on the card)."""
    b, s, _ = xn.shape
    q = (xn @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim())
    k, v = enc_kv
    out = attend(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["wo"]


def enc_kv_of(p, cfg, enc_out):
    """The cross-attention's (K, V) of the encoder output (B, S_enc, D)."""
    b, se, _ = enc_out.shape
    dh = cfg.head_dim()
    k = (enc_out @ p["wk"]).reshape(b, se, cfg.n_kv_heads, dh)
    v = (enc_out @ p["wv"]).reshape(b, se, cfg.n_kv_heads, dh)
    return k, v


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _mlp_layer_init(generator, cfg, dtype, d_ff):
    return {"attn": attn_init(generator, cfg, dtype),
            "mlp": swiglu_init(generator, cfg.d_model, d_ff, dtype),
            "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                   device=generator.device)}


def _moe_layer_init(generator, cfg, dtype):
    return {"attn": attn_init(generator, cfg, dtype),
            "moe": moe_init(generator, cfg, dtype),
            "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                   device=generator.device)}


def _encdec_dec_layer_init(generator, cfg, dtype):
    return {"attn": attn_init(generator, cfg, dtype),
            "cross": attn_init(generator, cfg, dtype),
            "mlp": swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype),
            "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                   device=generator.device)}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16) -> Params:
    """Random weights from ``generator``, on the generator's device (the
    same shapes and scales as the JAX package's ``init_params``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the port runs the {', '.join(PORTED_FAMILIES)} families; "
            f"{cfg.family!r} is not one of them")
    p: Params = {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                            scale=0.02),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                 device=generator.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
    if cfg.family in DENSE_FAMILIES:
        p["layers"] = [_mlp_layer_init(generator, cfg, dtype, cfg.d_ff)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        p["layers"] = [_moe_layer_init(generator, cfg, dtype)
                       for _ in range(cfg.n_layers - cfg.first_dense_layers)]
        if cfg.first_dense_layers:
            dff = cfg.d_ff or cfg.d_ff_expert * max(1, cfg.top_k)
            p["dense_layers"] = [
                _mlp_layer_init(generator, cfg, dtype, dff)
                for _ in range(cfg.first_dense_layers)]
    elif cfg.family == "ssm":
        p["layers"] = [{"ssm": ssm_init(generator, cfg, dtype)}
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_app, per = cfg.n_layers // cfg.attn_every, cfg.attn_every
        p["groups"] = [[{"ssm": ssm_init(generator, cfg, dtype)}
                        for _ in range(per)] for _ in range(n_app)]
        p["shared"] = _mlp_layer_init(generator, cfg, dtype, cfg.d_ff)
    else:                                           # encdec
        p["enc_layers"] = [_mlp_layer_init(generator, cfg, dtype, cfg.d_ff)
                           for _ in range(cfg.n_enc_layers)]
        p["dec_layers"] = [_encdec_dec_layer_init(generator, cfg, dtype)
                           for _ in range(cfg.n_layers)]
    return p


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """The parameter tree as meta tensors -- the shapes and dtypes
    :func:`init_params` gives, nothing allocated (the dry run's stand-in,
    the JAX package's ``jax.eval_shape`` of ``init_params``)."""
    from .layers import MetaGenerator
    return init_params(cfg, MetaGenerator(), dtype)


def _embed(cfg, p, batch):
    x = p["embed"][batch["tokens"].long()]
    if cfg.family == "vlm" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def _head(cfg, p):
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def forward(cfg: ArchConfig, p: Params, batch) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (B, S, D)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.family == "encdec":
        return _encdec_forward(cfg, p, batch)
    x = _embed(cfg, p, batch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    r = None         # the last sublayer's output, not yet added to x
    if cfg.family in ATTN_FAMILIES:
        for layer in attn_layers(p):
            x, r = _dense_layer_fwd(cfg, layer, x, r, positions)
    elif cfg.family == "ssm":
        for layer in p["layers"]:
            x = settle(x, r)
            r = ssm_block(layer["ssm"], cfg, x)[0]
    else:                                           # hybrid
        for group in p["groups"]:
            for layer in group:
                x = settle(x, r)
                r = ssm_block(layer["ssm"], cfg, x)[0]
            x, r = _dense_layer_fwd(cfg, p["shared"], x, r, positions)
    return residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]


def settle(x, r):
    """The residual stream with the pending output ``r`` added (``None``:
    nothing pending): what a block with no norm before it reads (Mamba2's
    in_proj)."""
    return x if r is None else x + r


def residual_norm(x, r, w, eps: float):
    """The norm at the head of a sublayer, over the residual stream ``x``
    plus the output ``r`` the sublayer before left pending (``None``:
    nothing pending).  Returns (h, rmsnorm(h)) with h = x + r: on the card
    K8's add variant writes both in one launch, where the eager add was a
    launch of its own."""
    if r is None:
        return x, rmsnorm(x, w, eps)
    return add_rmsnorm(x, r, w, eps)


def attn_layers(p):
    """The attention-family layers in forward order: the moe family's
    leading dense layers (``dense_layers``, where there are any), then
    ``layers``."""
    return list(p.get("dense_layers", ())) + list(p["layers"])


def _dense_layer_fwd(cfg, layer, x, r, positions, causal=True):
    """One dense or moe layer (or an encoder layer, ``causal=False``) over
    the residual stream x + r; returns the stream and the MLP's (or
    MoE's) output, pending."""
    x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
    return _mlp_after(cfg, layer, x, attn_apply(layer["attn"], cfg, xn,
                                                positions, causal=causal))


def _mlp_after(cfg, layer, x, y):
    """The layer body after attention: h = x + y (y the attention output)
    and its norm in one call, then the MLP -- or, in a moe layer, the
    MoE.  Returns (h, swiglu(rmsnorm(h))) -- the MLP's output pending, for
    the next norm to add."""
    h, xn = add_rmsnorm(x, y, layer["mlp_norm"], cfg.norm_eps)
    if "moe" in layer:
        return h, moe_apply(layer["moe"], cfg, xn)
    return h, swiglu(layer["mlp"], xn)


def _cross_after(cfg, layer, x, y, enc_kv):
    """A decoder layer's cross-attention after its self-attention: h = x +
    y (y the self-attention's output) and the cross norm in one call,
    then cross-attention over ``enc_kv``.  Returns (h, its output
    pending)."""
    h, xn = add_rmsnorm(x, y, layer["cross"]["norm"], cfg.norm_eps)
    return h, cross_apply(layer["cross"], cfg, xn, enc_kv)


def encode(cfg, p, frames) -> torch.Tensor:
    """The encoder stack over ``frames`` (B, S_enc, D), the stub frontend's
    output cast to the weights' dtype: non-causal self-attention with RoPE
    at positions 0..S_enc-1, no final norm (the JAX package's)."""
    x = frames.to(p["embed"].dtype)
    b, se, _ = x.shape
    epos = torch.arange(se, dtype=torch.int32, device=x.device).expand(b, se)
    r = None
    for layer in p["enc_layers"]:
        x, r = _dense_layer_fwd(cfg, layer, x, r, epos, causal=False)
    return settle(x, r)


def _encdec_forward(cfg, p, batch):
    """Whisper's forward: the encoder over ``batch["frames"]``, then the
    decoder over ``batch["tokens"]`` (causal self-attention, then
    cross-attention over each layer's own K/V of the encoder output)."""
    enc = encode(cfg, p, batch["frames"])
    x = _embed(cfg, p, batch)
    b, sd, _ = x.shape
    dpos = torch.arange(sd, dtype=torch.int32, device=x.device).expand(b, sd)
    r = None
    for layer in p["dec_layers"]:
        x, xn = residual_norm(x, r, layer["attn"]["norm"], cfg.norm_eps)
        y = attn_apply(layer["attn"], cfg, xn, dpos)
        x, y = _cross_after(cfg, layer, x, y,
                            enc_kv_of(layer["cross"], cfg, enc))
        x, r = _mlp_after(cfg, layer, x, y)
    return residual_norm(x, r, p["final_norm"], cfg.norm_eps)[1]


def loss_fn(cfg: ArchConfig, p: Params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward`` (labels of -1 are
    masked).  Differentiable on the CPU (plain code) and, for every
    family, on the card: K6, K7 and K8 (plain, add, gate) carry their
    backward kernels K10, K12 and K11.  The JAX package rematerializes each layer (``jax.checkpoint``) to save
    memory; the port keeps the layers' activations (the chunked loss is
    the one checkpointed part)."""
    hidden = forward(cfg, p, batch)
    return chunked_xent(hidden, _head(cfg, p), batch["labels"])


def logits_fn(cfg, p, hidden):
    return (hidden @ _head(cfg, p)).float()
