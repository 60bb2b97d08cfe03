"""Mamba2 / SSD (state-space duality) layer, chunked (arXiv:2405.21060).

The port of ``repro.models.ssm``.  Prefill runs the SSD chunked algorithm:
a within-chunk attention-like quadratic term plus an inter-chunk state
recurrence over chunk boundaries, all as batched matmuls.  Decode keeps an
(H, P, N) fp32 state plus a short conv buffer and costs O(1) per token in
sequence length.  Every cast sits where the JAX package has it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, gated_rmsnorm


def ssm_init(generator: torch.Generator, cfg, dtype):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.conv_width
    dev = generator.device
    return {
        # fused input projection -> [x(di), z(di), B(n), C(n), dt(h)]
        "in_proj": dense_init(generator, (d, 2 * di + 2 * n + h), dtype),
        "conv_w": dense_init(generator, (cw, di + 2 * n), dtype,
                             scale=cw ** -0.5),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, (di, d), dtype),
        "norm_w": torch.ones((di,), dtype=dtype, device=dev),
    }


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    x = proj[..., :di]
    z = proj[..., di:2 * di]
    bc = proj[..., 2 * di:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return x, z, bc, dt


def _causal_conv(u, w):
    """Depthwise causal conv: u (B, S, C), w (K, C)."""
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + up[:, i:i + u.shape[1]] * w[i]
    return out


def _ssd_kernel_eligible(x) -> bool:
    return x.is_cuda


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD chunk scan.

    x: (b, s, h, p); dt: (b, s, h) (softplus-ed); A: (h,) negative;
    B, C: (b, s, n); D: (h,).  Returns (y fp32 (b, s, h, p), final_state
    (b, h, p, n)).

    CUDA tensors (``_ssd_kernel_eligible``) go to ``kernels.ssd_scan.ops
    .ssd_scan`` (the intra-chunk term and chunk states in the kernel K7,
    ``kernels/ssd_scan/csrc/ssd_chunk.cu``); CPU tensors run the plain
    code, :func:`ssd_chunked_plain`.

    The JAX package's three-operand einsums are contracted pairwise here,
    in the order that keeps the intermediates at (b, nc, q, q, h): ``cb``
    times the decay mask first, then one batched matmul with ``x * dt``
    (a (b, nc, q, q, h, p) product would be p times larger).
    """
    if _ssd_kernel_eligible(x):
        from ..kernels.ssd_scan.ops import ssd_scan
        return ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    return ssd_chunked_plain(x, dt, A, B, C, D, chunk)


def ssd_chunked_plain(x, dt, A, B, C, D, chunk: int):
    """:func:`ssd_chunked`'s plain code on any device (the plain version
    of ``kernels.ssd_scan.ops.ssd_scan``)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    da = dtc * A                                    # (b, nc, q, h), negative
    cum = torch.cumsum(da, dim=2)                   # within-chunk log-decay
    # decay from step j (exclusive) to step i within a chunk
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,i,j,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # exp only where i >= j (as K7 / K12 evaluate it): past the diagonal
    # seg can overflow, and autograd through where() would take 0 * inf
    L = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                              torch.full((), -torch.inf, device=x.device)))
    del seg

    xdt = xc.float() * dtc[..., None]               # (b,nc,q,h,p)
    # intra-chunk (the "attention-like" quadratic term)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)    # (b,nc,i,j)
    M = (cb[..., None] * L).permute(0, 1, 4, 2, 3)  # (b,nc,h,i,j)
    del L
    y_intra = torch.matmul(M, xdt.permute(0, 1, 3, 2, 4))  # (b,nc,h,i,p)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)        # (b,nc,i,h,p)
    del M

    # chunk-boundary states: S_c = sum_j decay(end..j) B_j (x dt)_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,q,h)
    S = torch.einsum("bcjn,bcjhp->bchpn", Bc, decay_to_end[..., None] * xdt)
    return ssd_inter_chunk(y_intra, S, cum, Cc, x, D, s)


def ssd_inter_chunk(y_intra, S, cum, Cc, x, D, s: int):
    """The sequential part of the scan, shared by the plain code and the
    kernel's ops wrapper: y_intra (b, nc, q, h, p) and chunk states S
    (b, nc, h, p, n) in fp32, cum (b, nc, q, h), Cc (b, nc, q, n) fp32,
    x (b, >= s, h, p).  Returns (y fp32 (b, s, h, p), final state)."""
    b, nc, chunk, h, p = y_intra.shape
    n = S.shape[-1]
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    s_prev = []
    for c in range(nc):                             # emit the pre-state
        s_prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    s_prev = torch.stack(s_prev, dim=1)             # (b,nc,h,p,n)

    # inter-chunk: y_i += C_i . decay(start..i) s_prev
    decay_from_start = torch.exp(cum)               # (b,nc,q,h)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, s_prev) \
        * decay_from_start[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)
    y = y[:, :s] + x[:, :s].float() * D[:, None]
    return y, state


def ssd_decode_step(state, x, dt, A, B, C, D):
    """One-token recurrence: state (b,h,p,n); x (b,h,p); dt (b,h);
    B, C: (b, n).  Returns (y fp32 (b,h,p), new_state)."""
    da = torch.exp(dt.float() * A)                  # (b,h)
    xdt = x.float() * dt[..., None]
    new_state = state * da[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, B.float())
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y + x.float() * D[:, None], new_state


def ssm_block(p, cfg, x, *, decode_state=None):
    """Full Mamba2 block. x: (B, S, D).

    Prefill: returns (out, (ssm_state, conv_tail)).  Decode
    (``decode_state`` = (state, conv_buf) given): S == 1, uses the cached
    conv tail + state; the conv tail comes back in the promoted dtype of
    the buffer and the new input, as in the JAX package.
    """
    b, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = x @ p["in_proj"]
    xi, z, bc_in, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, bc_in], dim=-1)        # (B,S,di+2n)

    if decode_state is None:
        conv = _causal_conv(conv_in, p["conv_w"])
        conv_tail = conv_in[:, -(cfg.conv_width - 1):]
    else:
        ssm_state, conv_buf = decode_state          # buf (B,K-1,C)
        wdt = torch.promote_types(conv_buf.dtype, conv_in.dtype)
        window = torch.cat([conv_buf.to(wdt), conv_in.to(wdt)], dim=1)
        w = p["conv_w"]
        cdt = torch.promote_types(wdt, w.dtype)
        conv = torch.einsum("bkc,kc->bc", window.to(cdt), w.to(cdt))[:, None]
        conv_tail = window[:, 1:]
    conv = F.silu(conv.float()).to(x.dtype)
    xs = conv[..., :di].reshape(b, s, h, pdim)
    B_ = conv[..., di:di + n]
    C_ = conv[..., di + n:]
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))   # softplus
    A = -torch.exp(p["A_log"])

    if decode_state is None:
        y, final = ssd_chunked(xs, dt, A, B_, C_, p["D"], cfg.ssm_chunk)
    else:
        y1, final = ssd_decode_step(decode_state[0], xs[:, 0], dt[:, 0],
                                    A, B_[:, 0], C_[:, 0], p["D"])
        y = y1[:, None]
    new_state = (final, conv_tail)

    # z comes in x's dtype (in_proj's output), where the gated norm
    # rounds y and silu(z)
    y = gated_rmsnorm(y.reshape(b, s, di), z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_state
