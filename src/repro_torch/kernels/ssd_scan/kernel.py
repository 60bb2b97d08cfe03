"""Wrapper of the SSD intra-chunk kernel K7 (CUDA C++ in
``csrc/ssd_chunk.cu``).

``ssd_chunk(x, dt, cum, B, C, chunk=...)`` takes the model's tensors where
they lie: x (b, s, h, p) and B, C (b, s, n) -- one group shared by every
head, read with head stride 0 -- or (b, s, h, n), at any strides with the
last dim contiguous (B and C at equal strides); dt (b, s, h) fp32; cum
(b, nc, chunk, h) fp32, the within-chunk cumulative log-decay of the
zero-padded dt.  Positions past s count as the zero padding.  Returns fp32
y_intra (b, nc, chunk, h, p) and chunk states S (b, nc, h, p, n).  On CUDA
tensors it launches K7 and counts the launch; on CPU tensors it runs the
plain version (:func:`.ref.ssd_chunk_ref`).  K7 has three variants,
picked by :func:`ssd_variant` from the dtypes, widths and alignment (never
because a build or launch failed): "mma", the tensor-core kernel for bf16
x, B and C (the serving path's conv views; its arithmetic is
:func:`.ref.ssd_chunk_split_ref`); "tf32x3", the tensor-core kernel for an
fp32 x over fp32 or bf16 B / C (training's forward: products as three TF32
products, C.B^T formed once for a CTA's heads; its arithmetic is
:func:`.ref.ssd_chunk_tf32_ref`); and "simt", the fp32 SIMT kernel for the
rest.

``ssd_chunk_backward(x, dt, cum, B, C, dy, dS, chunk=...)`` is K12
(``csrc/ssd_chunk_backward.cu``): the gradient of K7's outputs -- dy
(b, nc, chunk, h, p) and dS (b, nc, h, p, n) -- as (dx, ddt, dcum, dB,
dC), K7's inputs' gradients (dB and dC summed over the heads where one
group serves them all).  It takes K7's inputs as K7 takes them.  On CUDA
tensors it launches K12 in one of two variants picked by
:func:`ssd_backward_variant` from the widths (counted as one launch, by
variant in ``variants``): "tf32x3" (a main kernel on the tensor cores,
C.B^T formed once for a CTA's heads and their dcb summed before the
n-wide products, then a finishing kernel; its arithmetic is
:func:`.ref.ssd_chunk_backward_tf32_ref`) and "simt" (the fp32 SIMT
kernels -- rows, columns, the finishing sums -- for the rest).  On CPU
tensors it runs the closed-form plain version
(:func:`.ref.ssd_chunk_backward_ref`).  Autograd reaches the pair through
``ops.ssd_scan``.
"""
from __future__ import annotations

import functools
import heapq

import torch

from .._build import launch, ptr, sm_count
from .._guard import forbid_grad
from .ref import ssd_chunk_backward_ref, ssd_chunk_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "mma": 1, "tf32x3": 2}
MAX_CHUNK = 256
MAX_STATE = 256
# the tensor-core variants: p and n at most, heads a CTA at most (the bf16
# variant's CTAs an SM: two at n <= 64, one at n <= 128; tf32x3's: one)
MMA_MAX_P = 64
MMA_MAX_N = 128
MMA_MAX_HEADS = 8


def _check(x, dt, cum, B, C, chunk):
    """K7's and K12's shared checks of the operands' shapes and devices."""
    b, s, h, p = x.shape
    nc = -(-s // chunk)
    if tuple(B.shape) != tuple(C.shape) or B.shape[:2] != (b, s) \
            or B.dim() not in (3, 4) or (B.dim() == 4 and B.shape[2] != h):
        raise ValueError("B and C must both be (b, s, n) or (b, s, h, n)")
    if tuple(dt.shape) != (b, s, h):
        raise ValueError("dt must be (b, s, h)")
    if tuple(cum.shape) != (b, nc, chunk, h):
        raise ValueError(f"cum must be (b, nc, chunk, h) = "
                         f"{(b, nc, chunk, h)}")
    if any(t.device != x.device for t in (dt, cum, B, C)):
        raise ValueError("all operands must be on one device")


def _check_cuda(x, dt, cum, B, C):
    """K7's and K12's shared checks of dtypes and strides on the card."""
    if x.dtype not in _DTYPES or B.dtype not in _DTYPES \
            or C.dtype != B.dtype:
        raise TypeError("the ssd_chunk kernel takes x and B/C in float32 or "
                        "bfloat16 (B and C in one dtype)")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("dt and cum must be float32")
    if x.stride(3) != 1 or B.stride() != C.stride() or B.stride(-1) != 1 \
            or dt.stride(2) != 1 or not cum.is_contiguous():
        raise ValueError("ssd_chunk needs contiguous last dims, B and C at "
                         "equal strides and a contiguous cum")


def ssd_chunk(x, dt, cum, B, C, *, chunk: int):
    forbid_grad("K7 ssd_chunk", x, dt, cum, B, C,
                use="ops.ssd_scan is differentiable (K12)")
    _check(x, dt, cum, B, C, chunk)
    if x.device.type != "cuda":
        return ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    _check_cuda(x, dt, cum, B, C)
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    if chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"the ssd_chunk kernel takes chunk <= {MAX_CHUNK} "
                         f"and state <= {MAX_STATE}")
    bsh = 0 if B.dim() == 3 else B.stride(2)
    strides = (*x.stride()[:3], B.stride(0), B.stride(1), bsh)
    variant = ssd_variant(x.dtype, B.dtype, chunk, p, n, strides,
                          (x.data_ptr(), B.data_ptr(), C.data_ptr()))
    out = _forward_launch(x, dt, cum, B, C, chunk, variant)
    ssd_chunk.launches += 1
    counts = ssd_chunk.variants
    counts[variant] = counts.get(variant, 0) + 1
    return out


def _forward_launch(x, dt, cum, B, C, chunk, variant):
    """Allocate K7's outputs on x's device and launch ``variant`` (which
    must take the call: :func:`ssd_variant`'s choice, or "simt")."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    bsh = 0 if B.dim() == 3 else B.stride(2)
    if variant == "mma":
        hpc = ssd_heads_per_cta(b * nc, h, sm_count(x.device),
                                2 if n <= 64 else 1)
    elif variant == "tf32x3":   # one CTA an SM; heads share it with B / C
        hpc = ssd_heads_per_cta(b * nc, h, sm_count(x.device), 1) \
            if bsh == 0 else 1
    else:
        hpc = 1
    y = torch.empty((b, nc, chunk, h, p), dtype=torch.float32,
                    device=x.device)
    S = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    launch("tardis_ssd_chunk", ptr(x), *x.stride()[:3], ptr(dt),
           *dt.stride()[:2], ptr(cum), ptr(B), ptr(C), B.stride(0),
           B.stride(1), bsh, b, s, nc, chunk, h, p, n, _DTYPES[x.dtype],
           _DTYPES[B.dtype], _VARIANTS[variant], hpc, ptr(y), ptr(S))
    return y, S


ssd_chunk.launches = 0
ssd_chunk.variants = {}    # launches per variant

# K12's SIMT variant holds a 64-row tile's p and n columns in registers:
# two 64-wide slices at most; its tf32x3 variant takes 64-position tiles
# (the chunk a multiple of 64), p <= 64 and n <= 128 in multiples of 16
BWD_MAX_PN = 128
BWD_TILE = 64
BWD_TC_MAX_P = 64
BWD_TC_MAX_N = 128


def ssd_chunk_backward(x, dt, cum, B, C, dy, dS, *, chunk: int):
    forbid_grad("K12 ssd_chunk_backward", x, dt, cum, B, C, dy, dS)
    _check(x, dt, cum, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    if tuple(dy.shape) != (b, nc, chunk, h, p) \
            or tuple(dS.shape) != (b, nc, h, p, n):
        raise ValueError("dy must be (b, nc, chunk, h, p) and dS "
                         "(b, nc, h, p, n)")
    if any(t.device != x.device for t in (dy, dS)):
        raise ValueError("all operands must be on one device")
    if x.device.type != "cuda":
        return ssd_chunk_backward_ref(x, dt, cum, B, C, dy, dS, chunk=chunk)
    _check_cuda(x, dt, cum, B, C)
    if chunk > MAX_CHUNK or p > BWD_MAX_PN or n > BWD_MAX_PN:
        raise ValueError(f"the ssd_chunk backward kernel takes chunk <= "
                         f"{MAX_CHUNK}, p and n <= {BWD_MAX_PN}")
    dy, dS = dy.float().contiguous(), dS.float().contiguous()
    variant = ssd_backward_variant(chunk, p, n)
    if variant == "tf32x3":
        out = _backward_launch_tf32(x, dt, cum, B, C, dy, dS, chunk)
    else:
        out = _backward_launch(x, dt, cum, B, C, dy, dS, chunk)
    ssd_chunk_backward.launches += 1
    counts = ssd_chunk_backward.variants
    counts[variant] = counts.get(variant, 0) + 1
    return out


def _backward_launch_tf32(x, dt, cum, B, C, dy, dS, chunk):
    """Allocate the tf32x3 variant's scratch and outputs on x's device and
    launch it (the main kernel and the finishing one)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    shared = B.dim() == 3
    nblk = chunk // BWD_TILE
    hpc = ssd_bwd_heads_per_cta(b * nc, nblk, h, p, n, sm_count(x.device)) \
        if shared else 1
    groups = -(-h // hpc)
    f32 = dict(dtype=torch.float32, device=x.device)
    rowp = torch.empty((b, nc, nblk, chunk, h), **f32)
    colp = torch.empty((b, nc, chunk, h), **f32)
    elast = torch.empty((b, nc, h, nblk), **f32)
    dcp = torch.empty((b, nc, groups, nblk, chunk, n), **f32)
    dbp = torch.empty((b, nc, groups, chunk, n), **f32)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dcum = torch.empty((b, nc, chunk, h), **f32)
    dB = torch.empty(B.shape, dtype=B.dtype, device=x.device)
    dC = torch.empty_like(dB)
    launch("tardis_ssd_chunk_backward_tf32", ptr(x), *x.stride()[:3],
           ptr(dt), *dt.stride()[:2], ptr(cum), ptr(B), ptr(C), B.stride(0),
           B.stride(1), 0 if shared else B.stride(2), ptr(dy), ptr(dS), b, s,
           nc, chunk, h, p, n, int(shared), _DTYPES[x.dtype],
           _DTYPES[B.dtype], hpc, ptr(rowp), ptr(colp), ptr(elast), ptr(dcp),
           ptr(dbp), ptr(dx), ptr(ddt), ptr(dcum), ptr(dB), ptr(dC))
    return dx, ddt, dcum, dB, dC


def _backward_launch(x, dt, cum, B, C, dy, dS, chunk):
    """Allocate the SIMT variant's scratch and outputs on x's device and
    launch it."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    shared = B.dim() == 3
    f32 = dict(dtype=torch.float32, device=x.device)
    dcum_row = torch.empty((b, nc, chunk, h), **f32)
    dcum_col = torch.empty_like(dcum_row)
    elast = torch.empty((b, nc, h, -(-chunk // 64)), **f32)
    dc_head = torch.empty((b, s, h, n), **f32)
    db_head = torch.empty_like(dc_head)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dcum = torch.empty_like(dcum_row)
    dB = torch.empty(B.shape, dtype=B.dtype, device=x.device)
    dC = torch.empty_like(dB)
    bsh = 0 if shared else B.stride(2)
    launch("tardis_ssd_chunk_backward", ptr(x), *x.stride()[:3], ptr(dt),
           *dt.stride()[:2], ptr(cum), ptr(B), ptr(C), B.stride(0),
           B.stride(1), bsh, ptr(dy), ptr(dS), b, s, nc, chunk, h, p, n,
           int(shared), _DTYPES[x.dtype], _DTYPES[B.dtype], ptr(dcum_row),
           ptr(dcum_col), ptr(elast), ptr(dc_head), ptr(db_head), ptr(dx),
           ptr(ddt), ptr(dcum), ptr(dB), ptr(dC))
    return dx, ddt, dcum, dB, dC


ssd_chunk_backward.launches = 0
ssd_chunk_backward.variants = {}    # launches per variant


def ssd_backward_variant(chunk: int, p: int, n: int) -> str:
    """Which of K12's variants takes a call: "tf32x3" (tensor cores) for
    the chunk a multiple of 64 (up to ``MAX_CHUNK``), p <= 64 and n <= 128
    in multiples of 16, any dtypes, strides and alignment (it stages by
    16-byte copies where it can, else by plain loads); else "simt"."""
    if chunk % BWD_TILE or p % 16 or p > BWD_TC_MAX_P or n % 16 \
            or n > BWD_TC_MAX_N:
        return "simt"
    return "tf32x3"


@functools.lru_cache(maxsize=None)
def ssd_bwd_heads_per_cta(chunks: int, nblk: int, h: int, p: int, n: int,
                          n_sm: int) -> int:
    """Heads a CTA of K12's tf32x3 variant takes where one group of B / C
    serves them all: the k whose grid -- a CTA per (j-block J, group of k
    heads, (batch, chunk) pair), J = 0 first, one an SM -- ends soonest
    when each CTA goes to the SM that frees first (the grid's order), with
    a CTA's work (multiply-adds) its nblk - J tiles of k heads' dM and
    M^T dy (2 * 64 * 64 p each) and one C.B^T, dB and dC product (3 * 64
    * 64 n), plus k heads' state terms (2 * 64 p n); the largest such k
    (fewest partial sums)."""
    def makespan(k):
        groups = -(-h // k)
        free = [0.0] * n_sm
        for J in range(nblk):
            tiles = nblk - J
            work = tiles * (k * 2 * 64 * 64 * p + 3 * 64 * 64 * n) \
                + k * 2 * 64 * p * n
            for _ in range(groups * chunks):
                heapq.heapreplace(free, free[0] + work)
        return max(free)
    best = min(makespan(k) for k in range(1, h + 1))
    return max(k for k in range(1, h + 1) if makespan(k) <= best * 1.001)


def ssd_variant(x_dtype, bc_dtype, chunk: int, p: int, n: int, strides,
                ptrs) -> str:
    """Which of K7's kernels takes a call (``strides``: x's three, then
    B's; ``ptrs``: x, B, C): for the chunk a multiple of 16, p <= 64 and
    n <= 128 in multiples of 8, "mma" (tensor cores) for bf16 x and B/C
    with every stride (in elements) a multiple of 8 and the data 16-byte
    aligned, "tf32x3" (tensor cores, three TF32 products) for an fp32 x
    over fp32 or bf16 B/C with x's strides multiples of 4 and x 16-byte
    aligned (B and C at any alignment: staged by 16-byte copies where they
    allow it, else by plain loads); else "simt"."""
    if chunk % 16 or p % 8 or p > MMA_MAX_P or n % 8 or n > MMA_MAX_N:
        return "simt"
    if x_dtype == torch.float32:
        if any(st % 4 for st in strides[:3]) or ptrs[0] % 16:
            return "simt"
        return "tf32x3"
    if x_dtype != torch.bfloat16 or bc_dtype != torch.bfloat16:
        return "simt"
    if any(st % 8 for st in strides) or any(a % 16 for a in ptrs):
        return "simt"
    return "mma"


def ssd_heads_per_cta(chunks: int, h: int, n_sm: int, per_sm: int) -> int:
    """Heads a CTA of the tensor-core variant takes, for ``chunks`` (batch,
    chunk) pairs of ``h`` heads: the k <= ``MMA_MAX_HEADS`` whose grid of
    chunks * ceil(h / k) CTAs, in waves of ``per_sm`` an SM, ends soonest
    (waves x k head-times), the largest such k (B and C staged the fewest
    times)."""
    def cost(k):
        ctas = chunks * -(-h // k)
        return -(-ctas // (per_sm * n_sm)) * k
    return min(range(min(h, MMA_MAX_HEADS), 0, -1), key=cost)
