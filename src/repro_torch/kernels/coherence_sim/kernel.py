"""Wrapper of K9 (``csrc/sim_run.cu``): the whole coherence simulation in
one launch.

:func:`sim_run` takes the simulator's state (``core.simulator.
init_state``: int32 tensors, bools as ``torch.bool``, the stats as
float32 scalars) and runs the JAX package's ``while_loop`` on it IN
PLACE: on CUDA tensors ONE launch of K9 (one warp, grid 1) that adds one
to ``sim_run.launches`` and to ``sim_run.variants[variant]``; on CPU
tensors the plain loop of :mod:`.ref`, which counts nothing.  There is no
fallback either way.

K9 holds the run's hot state in shared memory for the whole launch.  Its
two variants differ in where the L1 arrays live: ``"smem"`` in shared
memory beside the rest, ``"global"`` in global memory.  :func:`
pick_variant` takes ``"smem"`` where :func:`smem_bytes` of it fits a
block's opt-in shared memory (``SMEM_LIMIT``, an H100's) -- fig4's 64
cores -- and ``"global"`` otherwise (fig8's 256 cores); a caller may
force either, and a variant whose state does not fit raises.
:func:`l2_chase` and :func:`smem_chase` are the dependent-load probes of
the same source, which ``chip_smoke.py`` times to bound K9: a step needs
at least one shared-memory round trip, an LLC request one L2 round trip.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import launch, ptr
from .._guard import forbid_grad
from . import ref

MAX_CORES = 256        # each of the warp's 32 lanes holds at most 8 cores
MAX_L1_WAYS = 32       # an L1 set is one wave of the warp's lanes
MAX_LLC_WAYS = 16      # an LLC request's two sets are one wave
SMEM_LIMIT = 232_448   # a block's opt-in shared memory on an H100
VARIANTS = ("smem", "global")
# the state's tensors in the order of sim_run.cu's pointer table (kP*)
CORE_KEYS = ("clock", "pts", "idx", "done", "blocked", "arrived", "acc",
             "spin_iter")
L1_KEYS = ("l1_tag", "l1_st", "l1_wts", "l1_rts", "l1_ver", "l1_dirty",
           "l1_lru")
LLC_KEYS = ("llc_tag", "llc_st", "llc_wts", "llc_rts", "llc_owner",
            "llc_ver", "llc_dirty", "llc_lru", "llc_acc")
MEM_KEYS = ("mem_ver", "mts", "store_count", "bts_l1", "bts_llc",
            "maxts_l1", "maxts_llc")
TRACE_KEYS = ("op_type", "op_addr", "op_aux", "op_think")
SCALAR_KEYS = ("lru_clock", "steps", "aborted")
CFG_KEYS = ("lease", "period", "spec", "ooo_hide", "pw_opt", "ts_bits",
            "rebase_l1", "rebase_l2", "hop", "llc_lat", "dram_lat",
            "flush_pen", "ackwise_k", "estate", "backoff_cap",
            "barrier_cost", "max_steps")
STATE_KEYS = CORE_KEYS + L1_KEYS + LLC_KEYS + MEM_KEYS + TRACE_KEYS \
    + SCALAR_KEYS


def _shapes(geom):
    n, s2 = geom.n_cores, geom.llc_sets_total
    l1 = (n, geom.l1_sets, geom.l1_ways)
    llc = (s2, geom.llc_ways)
    out = {k: (n,) for k in CORE_KEYS}
    out.update({k: l1 for k in L1_KEYS})
    out.update({k: llc for k in LLC_KEYS})
    out.update({k: (geom.n_addr,) for k in ("mem_ver", "store_count")})
    out.update({k: (n,) for k in ("mts", "bts_l1", "bts_llc", "maxts_l1",
                                  "maxts_llc")})
    out.update({k: (n, geom.trace_len) for k in TRACE_KEYS})
    out.update({k: () for k in SCALAR_KEYS})
    return out


BOOL_KEYS = ("done", "blocked", "arrived", "l1_dirty", "llc_dirty",
             "llc_acc", "aborted")


def _check(name, t, shape, dtype, dev):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be contiguous on {dev}")


def _tensors(st, geom, directory):
    """(name, tensor) of every state entry K9 reads or writes, in the
    kernel's pointer order, each checked."""
    from ...core.simulator import LOG_KEYS, STAT_KEYS
    dev = st["clock"].device
    shapes = _shapes(geom)
    out = []
    for k in STATE_KEYS:
        _check(k, st[k], shapes[k], torch.bool if k in BOOL_KEYS
               else torch.int32, dev)
        out.append((k, st[k]))
    for k in STAT_KEYS:
        _check(f"stats[{k}]", st["stats"][k], (), torch.float32, dev)
        out.append((k, st["stats"][k]))
    for k in CFG_KEYS:
        _check(f"cfg[{k}]", st["cfg"][k], (), torch.int32, dev)
        out.append((k, st["cfg"][k]))
    if directory:
        s = (geom.llc_sets_total, geom.llc_ways, geom.n_cores)
        _check("sharers", st["sharers"], s, torch.bool, dev)
    out.append(("sharers", st["sharers"] if directory else None))
    if geom.log_size:
        for k in LOG_KEYS:
            _check(f"log[{k}]", st["log"][k], (geom.log_size,), torch.int32,
                   dev)
        _check("log[n]", st["log"]["n"], (), torch.int32, dev)
    log = st["log"] if geom.log_size else {}
    out += [(k, log.get(k)) for k in LOG_KEYS + ("n",)]
    return dev, out


def smem_bytes(geom, variant: str) -> int:
    """The shared memory K9's ``variant`` holds for ``geom``, as
    ``sim_run.cu``'s ``smem_bytes`` counts it (each array rounded up to
    16 bytes): 15 int32 arrays and 3 byte arrays of a core each (clock,
    pts, idx, acc, spin_iter, mts, bts_l1, bts_llc, maxts_l1, maxts_llc,
    the next op's four fields, the mesh coordinates; done, blocked,
    arrived) and, ``"smem"``, the six int32 L1 arrays and l1_dirty."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown K9 variant {variant!r}")
    n = geom.n_cores
    e = n * geom.l1_sets * geom.l1_ways

    def r16(b):
        return -(-b // 16) * 16
    core = 15 * r16(4 * n) + 3 * r16(n)
    return core + (6 * r16(4 * e) + r16(e) if variant == "smem" else 0)


def pick_variant(geom, variant: str = None) -> str:
    """``variant`` (checked), or the one K9 takes for ``geom``: "smem"
    where it fits ``SMEM_LIMIT``, else "global".  Raises where the
    variant asked for does not fit."""
    if variant is None:
        variant = ("smem" if smem_bytes(geom, "smem") <= SMEM_LIMIT
                   else "global")
    nbytes = smem_bytes(geom, variant)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"K9's {variant} variant needs {nbytes} bytes of "
                         f"shared memory for {geom.n_cores} cores, more than "
                         f"a block's {SMEM_LIMIT}")
    return variant


def sim_run(st, geom, proto: str, variant: str = None):
    """K9.  Run the simulation ``st`` (``init_state(geom, ...)``) under
    ``proto`` ("tardis" | "directory") to the end of the JAX loop, in
    place; returns ``st``.  ``variant`` ("smem" | "global") forces where
    K9 holds the L1 (default: :func:`pick_variant`); it is checked on
    either device, and the plain loop ignores it."""
    forbid_grad("K9 sim_run", st)
    if proto not in ("tardis", "directory"):
        raise ValueError(f"unknown protocol {proto!r}")
    variant = pick_variant(geom, variant)
    directory = proto == "directory"
    dev, tensors = _tensors(st, geom, directory)
    if dev.type != "cuda":
        return ref.sim_run_ref(st, geom, proto)
    for what, have, most in (("cores", geom.n_cores, MAX_CORES),
                             ("L1 ways", geom.l1_ways, MAX_L1_WAYS),
                             ("LLC ways", geom.llc_ways, MAX_LLC_WAYS)):
        if have > most:
            raise ValueError(f"K9 holds at most {most} {what}, not {have}")
    ptrs = (ctypes.c_void_p * len(tensors))(*[ptr(t).value or 0
                                              for _k, t in tensors])
    ints = [geom.n_cores, geom.l1_sets, geom.l1_ways, geom.llc_sets,
            geom.llc_ways, geom.n_addr, geom.trace_len, geom.log_size,
            geom.grid]
    cints = (ctypes.c_int * len(ints))(*ints)
    launch("tardis_sim_run", ptrs, len(tensors), cints, len(ints),
           int(directory), int(variant == "smem"),
           smem_bytes(geom, variant))
    sim_run.launches += 1
    sim_run.variants[variant] = sim_run.variants.get(variant, 0) + 1
    return st


def _chase_input(nxt):
    if nxt.dtype != torch.int32 or nxt.dim() != 1 or nxt.device.type \
            != "cuda" or not nxt.is_contiguous():
        raise ValueError("nxt must be a contiguous int32 CUDA vector")
    return torch.empty(1, dtype=torch.int32, device=nxt.device)


def l2_chase(nxt: torch.Tensor, hops: int) -> torch.Tensor:
    """Follow ``i = nxt[i]`` from 0 for ``hops`` dependent loads (L2
    only, bypassing L1) in one thread; returns the last index (a (1,)
    int32 tensor).  A timing probe, not part of the simulation."""
    out = _chase_input(nxt)
    launch("tardis_l2_chase", ptr(nxt), int(hops), ptr(out))
    return out


def smem_chase(nxt: torch.Tensor, hops: int) -> torch.Tensor:
    """Copy ``nxt`` (at most ``SMEM_LIMIT`` bytes) into one thread's
    shared memory and follow ``i = nxt[i]`` there from 0 for ``hops``
    dependent loads; returns the last index.  A timing probe."""
    out = _chase_input(nxt)
    if 4 * nxt.numel() > SMEM_LIMIT:
        raise ValueError(f"nxt exceeds {SMEM_LIMIT} bytes")
    launch("tardis_smem_chase", ptr(nxt), nxt.numel(), int(hops), ptr(out))
    return out


sim_run.launches = 0
sim_run.variants = {}    # launches per variant
