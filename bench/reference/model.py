"""The plain reference: a dense pre-norm decoder in float32, TF32 off.

It follows the ``run`` block of a configuration file (the layer as the
program runs it): token embedding; per layer RMSNorm, grouped-query
attention with rotary position embedding (the rotate-half form over the
whole head), the output projection and the residual add; RMSNorm, a SwiGLU
MLP and the residual add; a final RMSNorm and an untied output head.  No
cache, no paging, no batching: each sequence is run whole, layer by
layer, with attention in blocks of queries so that an 8k-token sequence
fits beside the weights.

It reads the benchmark's stacked weights (``bench/weights.draw``) and
token ids, and nothing the program made.  ``quant="fp8"`` is the control:
the same computation with every projection weight and every key and value
row rounded to float8 (e4m3) under a per-row scale.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

Q_BLOCK = 1024
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x: (T, heads, dh) float32; pos: (T,) positions."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = (pos.to(torch.float64)[:, None] * inv[None, :]).to(torch.float32)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def _attention(q, k, v):
    """Causal GQA over one sequence: q (T, H, dh), k / v (T, Hk, dh)."""
    t, h, dh = q.shape
    hk = k.shape[1]
    g = h // hk
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                      # (Hk, dh, T)
    vt = v.permute(1, 0, 2)                      # (Hk, T, dh)
    for lo in range(0, t, Q_BLOCK):
        hi = min(t, lo + Q_BLOCK)
        qb = q[lo:hi].reshape(hi - lo, hk, g, dh).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kt[:, None, :, :hi]) * dh ** -0.5
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vt[:, None, :hi])    # (Hk, g, qb, dh)
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, h, dh)
    return out


def logits_at(run: Dict, w: Dict[str, torch.Tensor],
              seqs: Sequence[torch.Tensor], positions: Sequence[Sequence[int]],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """Float32 logits of each sequence at the given positions (each the
    next-token distribution after that position): a list of (len(pos), V).
    ``seqs`` are int token-id tensors on the weights' device."""
    if quant not in (None, "fp8"):
        raise ValueError(f"unknown quant {quant!r}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(run, w, seqs, positions, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits_at(run, w, seqs, positions, quant):
    eps, theta = run["norm_eps"], run["rope_theta"]
    h, hk, dh = run["n_heads"], run["n_kv_heads"], run["head_dim"]

    def weight(name, i=None):
        x = (w[name] if i is None else w[name][i]).to(torch.float32)
        return _fp8(x, 0) if quant == "fp8" else x

    def kv(x):
        return _fp8(x, -1) if quant == "fp8" else x

    xs = [w["embed"][s.long()].to(torch.float32) for s in seqs]
    for i in range(run["n_layers"]):
        wq, wk, wv, wo = (weight(n, i) for n in ("wq", "wk", "wv", "wo"))
        an = w["attn_norm"][i].to(torch.float32)
        mn = w["mlp_norm"][i].to(torch.float32)
        wg, wu, wd = (weight(n, i) for n in ("w_gate", "w_up", "w_down"))
        for j, x in enumerate(xs):
            t = x.shape[0]
            pos = torch.arange(t, device=x.device)
            xn = _rmsnorm(x, an, eps)
            q = _rope((xn @ wq).reshape(t, h, dh), pos, theta)
            k = kv(_rope((xn @ wk).reshape(t, hk, dh), pos, theta))
            v = kv((xn @ wv).reshape(t, hk, dh))
            x = x + _attention(q, k, v).reshape(t, h * dh) @ wo
            xn = _rmsnorm(x, mn, eps)
            x = x + (torch.nn.functional.silu(xn @ wg) * (xn @ wu)) @ wd
            xs[j] = x
        del wq, wk, wv, wo, wg, wu, wd
    head = weight("lm_head")
    fn = w["final_norm"].to(torch.float32)
    out = []
    for x, p in zip(xs, positions):
        idx = torch.as_tensor(list(p), device=x.device, dtype=torch.long)
        out.append(_rmsnorm(x[idx], fn, eps) @ head)
    return out
