"""Plain versions of the flash-prefill kernel K6 (the port of
``repro.kernels.flash_attention.ref``: naive masked softmax attention) and
of its backward K10 (the closed-form gradient of the same softmax).

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
    dev = q.device
    qf = q.float().reshape(b, sq, hkv, g, dh)
    dof = dout.float().reshape(b, sq, hkv, g, dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,btkd->bqkgt", qf, kf) * scale
    qpos = q_offset + torch.arange(sq, device=dev)
    kpos = torch.arange(skv, device=dev)
    mask = (kpos[None, :] < kv_len).expand(sq, skv)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
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
