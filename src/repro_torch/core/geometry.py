"""Cache / NoC geometry shared by the Tardis and directory simulators.

The port's copy of ``repro.core.geometry``.  The simulated machine
mirrors the paper's Table V at reduced cache sizes: per-core private L1,
an address-interleaved shared-LLC slice per core ("bank"), a 2-D mesh NoC
with XY routing, and per-bank memory controllers.

The address and distance functions take Python ints or int32 tensors
alike: ``%`` and ``//`` floor on both, as ``jnp`` does, so a negative
operand (an unowned line's owner ``-1``, an empty way's tag ``-1``) maps
where it maps in the JAX package.  ``pick_way`` and ``pick_llc_victim``
choose a way of one set from its rows (sequences of ints, or 1-D
tensors) and return Python ints; CUDA kernel K9 (``kernels/
coherence_sim/csrc/sim_run.cu``) repeats them on the card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static machine shape."""
    n_cores: int = 64
    l1_sets: int = 32
    l1_ways: int = 4
    llc_sets: int = 64          # sets per bank; one bank per core
    llc_ways: int = 4
    n_addr: int = 1 << 16       # DRAM image size (lines)
    trace_len: int = 0          # filled from the trace
    log_size: int = 0           # 0 = logging disabled

    @property
    def grid(self) -> int:
        return int(math.ceil(math.sqrt(self.n_cores)))

    @property
    def llc_sets_total(self) -> int:
        return self.n_cores * self.llc_sets


def core_xy(geom: Geometry, i):
    g = geom.grid
    return i % g, i // g


def hop_dist(geom: Geometry, a, b):
    """Manhattan distance between tiles a and b on the mesh."""
    ax, ay = core_xy(geom, a)
    bx, by = core_xy(geom, b)
    return abs(ax - bx) + abs(ay - by)


def addr_bank(geom: Geometry, addr):
    """Home LLC slice (== home timestamp manager) of an address."""
    return addr % geom.n_cores


def addr_llc_set(geom: Geometry, addr):
    """Global LLC set index: bank-major so one bank is a contiguous slab."""
    bank = addr_bank(geom, addr)
    return bank * geom.llc_sets + (addr // geom.n_cores) % geom.llc_sets


def addr_l1_set(geom: Geometry, addr):
    return addr % geom.l1_sets


def _ints(row):
    return row.tolist() if isinstance(row, torch.Tensor) else list(row)


def _first_min(scores):
    """``argmin``: the first index of the smallest score."""
    best = 0
    for w in range(1, len(scores)):
        if scores[w] < scores[best]:
            best = w
    return best


def pick_way(tags, states, lrus, addr):
    """(hit, way) selection for one cache set.

    Returns the matching way on a hit, otherwise the fill victim:
    invalid ways first, then least-recently-used.  ``states`` is only used
    for validity (INVALID == 0).
    """
    tags, states, lrus = _ints(tags), _ints(states), _ints(lrus)
    addr = int(addr)
    valid = [s != 0 for s in states]
    for w, (v, t) in enumerate(zip(valid, tags)):
        if v and t == addr:
            return True, w
    if not all(valid):
        return False, valid.index(False)
    return False, _first_min([l if v else INT_MAX
                              for v, l in zip(valid, lrus)])


def pick_llc_victim(tags, states, lrus, owners, requester):
    """LLC fill-victim choice: invalid > shared-LRU > exclusive-LRU, and
    never a line exclusively owned by the requester mid-transaction."""
    states, lrus, owners = _ints(states), _ints(lrus), _ints(owners)
    valid = [s != 0 for s in states]
    if not all(valid):
        return valid.index(False)
    scores = []
    for s, l, o in zip(states, lrus, owners):
        penalty = 0
        if s == 2:
            penalty = 1 << 29 if o == requester else 1 << 20
        scores.append(wrap_i32(l + penalty))
    return _first_min(scores)


def wrap_i32(x: int) -> int:
    """A Python int wrapped to int32, as the JAX package's int32
    arithmetic wraps."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31
