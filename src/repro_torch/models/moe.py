"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch
(the port of ``repro.models.moe``).

Routing runs in fp32.  Assignments are sorted by expert id (a stable
sort), each one's position within its expert comes from a cumulative
count, and tokens scatter into an (E, C + 1, D) buffer whose last slot
takes the overflow and is dropped; the experts run as batched matmuls
over that buffer and the outputs gather back, weighted by the
renormalised gates.  Variants:
  * kimi-k2: 384 experts top-8, 1 shared expert, first layer dense;
  * arctic:  128 experts top-2 plus a parallel dense-residual MLP.
"""
from __future__ import annotations

import torch

from .layers import dense_init, swiglu, swiglu_init


def expert_init(generator: torch.Generator, shape, dtype):
    """An (E, ., .) expert stack drawn one expert at a time (N(0, 1) in
    fp32, then scaled and cast), so that no temporary the size of the
    whole stack in fp32 forms.  The scale is the JAX package's
    ``dense_init`` default, ``shape[0] ** -0.5``: its fan-in is the
    expert count."""
    scale = shape[0] ** -0.5
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if out.is_meta:
        return out
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=generator,
                             dtype=torch.float32,
                             device=generator.device) * scale
    return out


def moe_init(generator: torch.Generator, cfg, dtype):
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "router": dense_init(generator, (d, e), torch.float32, scale=0.02),
        "w_gate": expert_init(generator, (e, d, f), dtype),
        "w_up": expert_init(generator, (e, d, f), dtype),
        "w_down": expert_init(generator, (e, f, d), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(generator, d, f * cfg.n_shared_experts,
                                  dtype)
    if cfg.residual_ff:
        p["residual"] = swiglu_init(generator, d, cfg.residual_ff, dtype)
    return p


def _capacity(cfg, n_tokens: int) -> int:
    """Expert capacity for a dispatch of ``n_tokens`` (= B * S), a host int
    from shapes.  Paged decode calls this with the live batch (S = 1), so
    capacity -- and which tokens drop -- follows the schedule, as in the
    JAX package."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(probs, k: int):
    """The ``k`` largest entries of each row, ties broken to the lower
    index first as ``jax.lax.top_k`` breaks them (``torch.topk`` does not
    promise an order among equal values).  Returns (values, indices)."""
    idx = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    return torch.gather(probs, -1, idx), idx


def route(p, cfg, xf):
    """fp32 router: (gates renormalised over the top k, expert ids), each
    (T, k), and the softmax probabilities (T, E)."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.top_k)
    return gate_vals / gate_vals.sum(-1, keepdim=True), expert_ids, probs


def moe_apply(p, cfg, x):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    gate_vals, expert_ids, _ = route(p, cfg, xf)

    # --- sort-based dispatch -------------------------------------------
    flat_exp = expert_ids.reshape(t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_exp, stable=True)
    sorted_exp = flat_exp[order]
    sorted_tok = flat_tok[order]
    seg_start = torch.searchsorted(sorted_exp,
                                   torch.arange(e, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - seg_start[sorted_exp]
    cap = _capacity(cfg, t)
    slot = pos.clamp(max=cap)                      # cap: the overflow bin
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((sorted_exp, slot), xf[sorted_tok])
    buf = buf[:, :cap]

    # --- experts, batched over the expert axis ----------------------------
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, p["w_down"])

    # --- combine -----------------------------------------------------------
    kept = pos < cap
    gathered = y[sorted_exp, pos.clamp(max=cap - 1)]
    gathered = torch.where(kept[:, None], gathered,
                           torch.zeros((), dtype=x.dtype, device=dev))
    contrib = torch.zeros((t * k, d), dtype=x.dtype, device=dev)
    contrib[order] = gathered
    out = torch.einsum("tkd,tk->td", contrib.reshape(t, k, d).float(),
                       gate_vals).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], xf)
    if cfg.residual_ff:
        out = out + swiglu(p["residual"], xf)
    return out.reshape(b, s, d)


def aux_load_balance_loss(p, cfg, x):
    """Switch-style load-balance auxiliary loss (fraction * prob per
    expert)."""
    b, s, d = x.shape
    _, ids, probs = route(p, cfg, x.reshape(b * s, d))
    frac = torch.nn.functional.one_hot(ids, cfg.n_experts).float().mean(
        dim=(0, 1))
    return cfg.n_experts * torch.sum(frac * probs.mean(dim=0))
