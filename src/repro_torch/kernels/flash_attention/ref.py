"""Plain versions of the flash-prefill kernel K6 (the port of
``repro.kernels.flash_attention.ref``: naive masked softmax attention,
and each row's log-sum-exp, which K6 hands its backward) and of its
backward K10 (the closed-form gradient of the same softmax).

It differs from the kernel on a row with no live key (``kv_len`` at or
below the query's first visible position): the softmax over all-masked
scores gives the mean of V there, the kernel gives 0 (p = 0 while the
running max is still NEG_INF), as the TPU kernel does.  Prefill never
reaches such a row: the causal diagonal is always live.
"""
from __future__ import annotations

import torch

from ...models.attention import NEG_INF, reference_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len=None):
    return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)


def flash_attention_lse_ref(q, k, *, causal: bool = True, q_offset: int = 0,
                            kv_len=None):
    """Each query row's log-sum-exp of its live scaled scores q.k * Dh **
    -0.5, fp32 (B, H, Sq), +inf on a row with no live key: what K6 writes
    with ``return_lse`` and K10 reads."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    s = torch.einsum("bqkgd,btkd->bqkgt",
                     q.float().reshape(b, sq, hkv, h // hkv, dh),
                     k.float()) * dh ** -0.5
    mask = _live(sq, skv, causal, q_offset, kv_len, q.device)
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.full_like(s, -torch.inf))
    lse = torch.logsumexp(s, dim=-1).reshape(b, sq, h)
    lse = torch.where(mask.any(-1)[None, :, None], lse,
                      torch.full_like(lse, torch.inf))
    return lse.transpose(1, 2).contiguous()


def _live(sq, skv, causal, q_offset, kv_len, dev):
    """(Sq, Skv): whether query i sees key t (t < kv_len and, causal,
    t <= q_offset + i)."""
    qpos = q_offset + torch.arange(sq, device=dev)
    kpos = torch.arange(skv, device=dev)
    mask = (kpos[None, :] < kv_len).expand(sq, skv)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    return mask


def flash_attention_backward_ref(q, k, v, o, dout, *, causal: bool = True,
                                 q_offset: int = 0, kv_len=None,
                                 scale: float = None):
    """Plain version of the flash-backward kernel K10: the closed-form
    gradient of the naive masked softmax attention, in fp32 (not autograd).
    With P = softmax(s), dP = dO.v^T and D = rowsum(dO * o) (o the
    forward's output, as the kernel reads it): dS = P (dP - D), dq = scale
    dS.k, dk = scale dS^T.q and dv = P^T.dO, each summed over a KV head's
    query heads.  Returns (dq, dk, dv) in q's, k's and v's dtypes.  Like
    the forward, it differs from the kernel on a row with no live key
    (uniform P here, zero gradients there)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = dh ** -0.5
    kv_len = skv if kv_len is None else int(kv_len)
    qf = q.float().reshape(b, sq, hkv, g, dh)
    dof = dout.float().reshape(b, sq, hkv, g, dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,btkd->bqkgt", qf, kf) * scale
    mask = _live(sq, skv, causal, q_offset, kv_len, q.device)
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqkgd,btkd->bqkgt", dof, vf)
    delta = (dof * o.float().reshape(b, sq, hkv, g, dh)).sum(-1,
                                                             keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bqkgt,btkd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bqkgt,bqkgd->btkd", ds, qf) * scale
    dv = torch.einsum("bqkgt,bqkgd->btkd", p, dof)
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
