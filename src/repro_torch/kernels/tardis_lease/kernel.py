"""Wrappers of the lease kernels K1-K3 (CUDA C++ in ``csrc/``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then -- for CUDA tensors -- launches its kernel on PyTorch's
current stream and adds one to its ``launches`` count; for CPU tensors it
runs the plain version from :mod:`.ref` and counts nothing.  There is no
fallback: a CUDA launch that fails raises.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr
from .._guard import forbid_grad
from . import ref

LANES = 128
MAX_GROUPS = 64      # K1: the groups a CTA reduces in shared memory
MAX_CLUSTER = 8      # CTAs of a thread-block cluster (the portable size)
# K2: threads a CTA, and entries a thread takes before the launch takes
# another CTA (write_advance.cu holds up to kPer = 8 in registers).  One
# a thread: on an NVIDIA H100 80GB HBM3 (700 W) a cluster of 5 CTAs ran
# the serving table (4608 blocks) as fast as one CTA holding 5 entries a
# thread (3.52 vs 3.56 us), and 70000 blocks on 8 CTAs 4x as fast as on
# one (scripts/k2_variants.py)
K2_THREADS = 1024
K2_PER_THREAD = 1


def _check_i32(name, t, shape=None, device=None):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")


def lease_pass(wts, rts, req, masks, pts_vec, lease):
    """K1.  wts/rts/req (N,) int32; masks (G, N) int32; pts_vec (G,) int32;
    lease an int (static policy) or an (N,) int32 tensor (predictor).
    Returns (new_rts (N,), flags (G, N), write_ts (), new_pts (G,)): on
    CUDA tensors ONE launch (one thread-block cluster), G <= MAX_GROUPS."""
    forbid_grad("K1 lease_pass", wts, rts, req, masks, pts_vec, lease)
    n = wts.shape[0]
    g = masks.shape[0]
    dev = wts.device
    for name, t in (("wts", wts), ("rts", rts), ("req", req)):
        _check_i32(name, t, (n,), dev)
    _check_i32("masks", masks, (g, n), dev)
    _check_i32("pts_vec", pts_vec, (g,), dev)
    if isinstance(lease, torch.Tensor):
        _check_i32("lease", lease, (n,), dev)
    if dev.type != "cuda":
        return ref.lease_pass_ref(wts, rts, req, masks, pts_vec, lease)
    if g > MAX_GROUPS:
        raise ValueError(f"the lease kernel holds at most {MAX_GROUPS} "
                         f"groups in shared memory, not {g}")
    new_rts = torch.empty_like(wts)
    flags = torch.empty_like(masks)
    write_ts = torch.empty((), dtype=torch.int32, device=dev)
    new_pts = torch.empty_like(pts_vec)
    vec = lease if isinstance(lease, torch.Tensor) else None
    launch("tardis_lease_pass", ptr(wts), ptr(rts), ptr(req), ptr(masks),
           ptr(pts_vec), ptr(vec), 0 if vec is not None else int(lease),
           n, g, ptr(new_rts), ptr(flags), ptr(write_ts), ptr(new_pts))
    lease_pass.launches += 1
    return new_rts, flags, write_ts, new_pts


def write_advance(wts, rts, mask, pts: int):
    """K2.  wts/rts/mask (N,) int32, pts a host int.  Returns (new_wts,
    new_rts, ts ()) with ts = max(pts, max(masked rts) + 1) left on the
    tables' device: on CUDA tensors ONE launch, of
    :func:`write_advance_ctas` CTAs (more than one: a thread-block
    cluster)."""
    forbid_grad("K2 write_advance", wts, rts, mask)
    n = wts.shape[0]
    dev = wts.device
    for name, t in (("wts", wts), ("rts", rts), ("mask", mask)):
        _check_i32(name, t, (n,), dev)
    if dev.type != "cuda":
        return ref.write_advance_ref(wts, rts, mask, pts)
    new_wts = torch.empty_like(wts)
    new_rts = torch.empty_like(rts)
    ts = torch.empty((), dtype=torch.int32, device=dev)
    launch("tardis_write_advance", ptr(wts), ptr(rts), ptr(mask), int(pts),
           n, write_advance_ctas(n), ptr(new_wts), ptr(new_rts), ptr(ts))
    write_advance.launches += 1
    return new_wts, new_rts, ts


def write_advance_ctas(n: int) -> int:
    """K2's CTAs for a table of ``n`` entries: enough that no thread takes
    more than ``K2_PER_THREAD`` of them, at most one cluster of
    ``MAX_CLUSTER`` (whose threads then hold up to 8 each in registers
    and read any rest twice)."""
    return max(1, min(MAX_CLUSTER, -(-n // (K2_THREADS * K2_PER_THREAD))))


def _col_blocks(col_lo: int, width: int) -> None:
    """The window [col_lo, col_lo + width) must be LANES-aligned, as the
    TPU kernels' column blocking required."""
    if col_lo % LANES or width % LANES:
        raise ValueError(f"column window ({col_lo}, {width}) is not "
                         f"{LANES}-aligned")


def _vec_layout(pool, col_lo: int, width: int):
    """(row_vecs, col_vec, width_vecs) in 16-byte units, checked."""
    es = pool.element_size()
    row_b, lo_b, w_b = pool.shape[1] * es, col_lo * es, width * es
    if row_b % 16 or lo_b % 16 or w_b % 16 or pool.data_ptr() % 16:
        raise ValueError("row_copy needs 16-byte aligned rows and windows")
    return row_b // 16, lo_b // 16, w_b // 16


def _check_pool_idx(pool, idx, col_lo, width):
    if pool.dim() != 2 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous (N, W) tensor")
    _check_i32("idx", idx, (idx.shape[0],), pool.device)
    if idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    if col_lo < 0 or col_lo + width > pool.shape[1]:
        raise ValueError(f"window ({col_lo}, {width}) exceeds the pool row "
                         f"{pool.shape[1]}")


def gather_rows(pool, idx, *, col_lo: int = 0, width: int = None):
    """K3 gather: ``pool[idx, col_lo:col_lo+width]`` -> (n, width)."""
    forbid_grad("K3 gather_rows", pool, idx)
    if width is None:
        width = pool.shape[1] - col_lo
    _col_blocks(col_lo, width)
    _check_pool_idx(pool, idx, col_lo, width)
    if pool.device.type != "cuda":
        return ref.gather_rows_ref(pool, idx, col_lo, width)
    row_v, lo_v, w_v = _vec_layout(pool, col_lo, width)
    out = torch.empty((idx.shape[0], width), dtype=pool.dtype,
                      device=pool.device)
    launch("tardis_gather_rows", ptr(pool), ptr(idx), idx.shape[0], row_v,
           lo_v, w_v, ptr(out))
    gather_rows.launches += 1
    return out


def scatter_rows(pool, idx, rows, *, col_lo: int = 0):
    """K3 scatter, IN PLACE: ``pool[idx, col_lo:col_lo+w] = rows`` (rows
    already in the pool's dtype and window width); a duplicate id keeps
    the last listed row.  Returns ``pool``."""
    forbid_grad("K3 scatter_rows", pool, idx, rows)
    n, width = rows.shape
    _col_blocks(col_lo, width)
    _check_pool_idx(pool, idx, col_lo, width)
    if idx.shape[0] != n:
        raise ValueError(f"{idx.shape[0]} ids for {n} rows")
    if rows.dtype != pool.dtype or rows.device != pool.device \
            or not rows.is_contiguous():
        raise ValueError("rows must be contiguous, in the pool's dtype and "
                         "on its device")
    if pool.device.type != "cuda":
        return ref.scatter_rows_ref(pool, idx, rows, col_lo)
    row_v, lo_v, w_v = _vec_layout(pool, col_lo, width)
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    launch("tardis_scatter_rows", ptr(pool), ptr(idx), n, row_v, lo_v, w_v,
           ptr(rows))
    scatter_rows.launches += 1
    return pool


def empty_probe() -> None:
    """Launch the library's empty kernel on the current stream: the floor
    that any kernel of one launch pays (timed beside K3's rows).  Counts
    nothing: it is a probe, not a kernel of any path."""
    launch("tardis_empty")


for _fn in (lease_pass, write_advance, gather_rows, scatter_rows):
    _fn.launches = 0
