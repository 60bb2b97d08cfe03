"""Synthetic SPLASH-2-like memory traces for the coherence simulator.

The port's numpy copy of ``repro.core.traces``: the same op codes, the
same generators and the same seeds, so each generator gives arrays
byte-identical to the JAX package's (``tests/test_torch_traces.py``).
Each generator synthesizes the *sharing pattern* that dominates the
corresponding paper benchmark (phase transposes for FFT, migratory
lock-protected records for WATER-NSQ, task-queue spinning for
CHOLESKY/VOLREND, ...).

Op encoding (int32 arrays of shape (n_cores, trace_len)):
  op_type : 0=load 1=store 2=spin_until 3=barrier 4=end(padding)
  op_addr : cache-line granular address
  op_aux  : spin target version (type 2) / barrier id (type 3)
  op_think: compute cycles consumed before the op issues

Determinism: ticket locks are pre-scheduled (acquisition k of lock l is
assigned to a fixed core), so a `spin_until(lock, k)` + `store(lock)` pair
models acquire/release exactly, and the global outcome is reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

LOAD, STORE, SPIN, BARRIER, END = 0, 1, 2, 3, 4


@dataclasses.dataclass
class Trace:
    """A complete multi-core trace plus its address-space size."""
    op_type: np.ndarray
    op_addr: np.ndarray
    op_aux: np.ndarray
    op_think: np.ndarray
    n_addr: int
    name: str = ""

    @property
    def n_cores(self) -> int:
        return self.op_type.shape[0]

    @property
    def length(self) -> int:
        return self.op_type.shape[1]

    def total_ops(self) -> int:
        return int((self.op_type != END).sum())


class _Builder:
    """Per-core op-list builder that pads to a rectangular trace."""

    def __init__(self, n_cores: int):
        self.n = n_cores
        self.ops = [[] for _ in range(n_cores)]
        self._n_barriers = 0
        self._lock_counts: Dict[int, int] = {}

    def load(self, c, addr, think=0):
        self.ops[c].append((LOAD, addr, 0, think))

    def store(self, c, addr, think=0):
        self.ops[c].append((STORE, addr, 0, think))

    def barrier(self, cores=None):
        bid = self._n_barriers
        self._n_barriers += 1
        for c in (cores if cores is not None else range(self.n)):
            self.ops[c].append((BARRIER, 0, bid, 0))

    def lock_acquire(self, c, lock_addr, think=0):
        """Pre-scheduled ticket acquire: spin until `k` prior releases."""
        k = self._lock_counts.get(lock_addr, 0)
        self._lock_counts[lock_addr] = k + 1
        self.ops[c].append((SPIN, lock_addr, k, think))

    def lock_release(self, c, lock_addr):
        self.ops[c].append((STORE, lock_addr, 0, 0))

    def rmw(self, c, addr, think=0):
        """Uncontended lock / atomic: load+store pair (migratory traffic
        without a pre-scheduled spin -- models locks whose arrival order is
        not serialization-critical, avoiding false trace dependencies)."""
        self.ops[c].append((LOAD, addr, 0, think))
        self.ops[c].append((STORE, addr, 0, 0))

    def build(self, n_addr: int, name: str) -> Trace:
        length = max(len(o) for o in self.ops) + 1   # +1: END sentinel column
        t = np.full((self.n, length), END, np.int32)
        a = np.zeros((self.n, length), np.int32)
        x = np.zeros((self.n, length), np.int32)
        k = np.zeros((self.n, length), np.int32)
        for c, lst in enumerate(self.ops):
            for j, (ty, ad, au, th) in enumerate(lst):
                t[c, j], a[c, j], x[c, j], k[c, j] = ty, ad, au, th
        return Trace(t, a, x, k, n_addr, name)


def _zipf_idx(rng, n, size, a=1.2):
    z = rng.zipf(a, size=size)
    return np.minimum(z - 1, n - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# Generators.  `scale` multiplies per-core op counts (1.0 = benchmark size).
# ---------------------------------------------------------------------------

def gen_fft(n_cores, seed=0, scale=1.0):
    """Phase-parallel all-to-all transpose: little steady-state sharing, most
    pts advance comes from self-increment (paper Table VI: 88.5%)."""
    rng = np.random.default_rng(seed)
    b = _Builder(n_cores)
    part = 64                      # lines per core per phase
    phases = max(2, int(6 * scale))
    base = 0
    for p in range(phases):
        for c in range(n_cores):
            own = base + c * part
            for i in range(part // 2):
                b.load(c, own + rng.integers(part), think=3)
                b.store(c, own + rng.integers(part), think=3)
        b.barrier()
        # transpose read: core c reads lines owned by (c+p+1)%N last phase
        for c in range(n_cores):
            src = base + ((c + p + 1) % n_cores) * part
            for i in range(part // 4):
                b.load(c, src + rng.integers(part), think=2)
        b.barrier()
    return b.build(n_cores * part + 8, "fft")


def gen_radix(n_cores, seed=0, scale=1.0):
    """Scattered permutation writes into a global array + histogram reads."""
    rng = np.random.default_rng(seed + 1)
    b = _Builder(n_cores)
    glob = 2048
    priv = 32
    phases = max(2, int(4 * scale))
    for p in range(phases):
        for c in range(n_cores):
            pbase = glob + c * priv
            for i in range(24):
                b.load(c, pbase + rng.integers(priv), think=2)
                b.store(c, int(rng.integers(glob)), think=4)
        b.barrier()
        for c in range(n_cores):
            for i in range(16):
                b.load(c, int(rng.integers(glob)), think=2)
        b.barrier()
    return b.build(glob + n_cores * priv + 8, "radix")


def gen_lu(n_cores, seed=0, scale=1.0, contiguous=True):
    """Panel factorization: one producer writes a block, all consumers read it
    (wide read sharing), plus private trailing updates."""
    rng = np.random.default_rng(seed + 2)
    b = _Builder(n_cores)
    blk = 48
    steps = max(3, int(8 * scale))
    stride = 1 if contiguous else 17      # NC variant: conflict-miss prone
    panel0 = 0
    priv0 = blk * steps * stride + 16
    for s in range(steps):
        owner = s % n_cores
        pan = panel0 + s * blk * stride
        for i in range(blk):
            b.store(owner, pan + i * stride, think=2)
        b.barrier()
        for c in range(n_cores):
            for i in range(blk // 2):
                b.load(c, pan + int(rng.integers(blk)) * stride, think=1)
            pb = priv0 + c * 64
            for i in range(32):
                b.load(c, pb + rng.integers(64), think=1)
                b.store(c, pb + rng.integers(64), think=1)
        b.barrier()
    return b.build(priv0 + n_cores * 64 + 8, "lu_c" if contiguous else "lu_nc")


def gen_ocean(n_cores, seed=0, scale=1.0, contiguous=True):
    """Nearest-neighbour grid relaxation: boundary rows are point-to-point
    read-shared; interiors are private and large."""
    rng = np.random.default_rng(seed + 3)
    b = _Builder(n_cores)
    rows = 24
    stride = 1 if contiguous else 13
    iters = max(2, int(5 * scale))
    row0 = 0
    for it in range(iters):
        for c in range(n_cores):
            mine = row0 + c * rows * stride
            left = row0 + ((c - 1) % n_cores) * rows * stride
            right = row0 + ((c + 1) % n_cores) * rows * stride
            for i in range(6):          # neighbour boundary reads
                b.load(c, left + (rows - 1) * stride, think=1)
                b.load(c, right, think=1)
            for i in range(40):         # private interior sweep
                r = int(rng.integers(rows))
                b.load(c, mine + r * stride, think=1)
                b.store(c, mine + r * stride, think=1)
        b.barrier()
    return b.build(row0 + n_cores * rows * stride + 8,
                   "ocean_c" if contiguous else "ocean_nc")


def gen_barnes(n_cores, seed=0, scale=1.0):
    """Tree walk: zipf read-shared nodes, occasional node writes, per-body
    private updates and a few node locks."""
    rng = np.random.default_rng(seed + 4)
    b = _Builder(n_cores)
    nodes = 512
    locks0 = nodes
    nlocks = 16
    priv0 = nodes + nlocks
    steps = max(2, int(3 * scale))
    for s in range(steps):
        for c in range(n_cores):
            pb = priv0 + c * 32
            for i in range(60):
                b.load(c, int(_zipf_idx(rng, nodes, 1)[0]), think=2)
                if i % 10 == 9:
                    b.load(c, pb + rng.integers(32), think=1)
                    b.store(c, pb + rng.integers(32), think=1)
        # tree update phase: low-contention node locks (migratory RMW)
        order = rng.permutation(n_cores)
        for c in order:
            lk = locks0 + int(rng.integers(nlocks))
            b.rmw(int(c), lk, think=2)
            nd = int(_zipf_idx(rng, nodes, 1)[0])
            b.load(int(c), nd, think=1)
            b.store(int(c), nd, think=1)
        b.barrier()
    return b.build(priv0 + n_cores * 32 + 8, "barnes")


def gen_fmm(n_cores, seed=0, scale=1.0):
    """Like barnes but with heavier spin synchronization (paper: FMM is
    spin-sensitive at large self-increment periods)."""
    rng = np.random.default_rng(seed + 5)
    b = _Builder(n_cores)
    cells = 256
    flag0 = cells
    nflags = n_cores
    priv0 = cells + nflags
    steps = max(2, int(3 * scale))
    for s in range(steps):
        for c in range(n_cores):
            for i in range(40):
                b.load(c, int(_zipf_idx(rng, cells, 1)[0]), think=2)
            pb = priv0 + c * 16
            for i in range(10):
                b.store(c, pb + rng.integers(16), think=1)
        # producer-consumer flags: core c waits for c-1's flag (wavefront)
        for c in range(n_cores):
            b.store(c, flag0 + c, think=1)           # publish my result
        for c in range(n_cores):
            b.lock_acquire(c, flag0 + (c + 1) % n_cores, think=0)
            # spin until the neighbour's flag reaches this step's version;
            # lock_acquire pre-schedules exactly that count.
            b.lock_release(c, flag0 + (c + 1) % n_cores)
        b.barrier()
    return b.build(priv0 + n_cores * 16 + 8, "fmm")


def gen_water_nsq(n_cores, seed=0, scale=1.0):
    """Migratory sharing: lock-protected read-modify-write of molecule
    records that pass from core to core."""
    rng = np.random.default_rng(seed + 6)
    b = _Builder(n_cores)
    nmol = 64
    mol0 = 0
    lock0 = nmol * 4
    priv0 = lock0 + nmol
    rounds = max(2, int(4 * scale))
    for r in range(rounds):
        for c in range(n_cores):
            for i in range(6):
                m = int(rng.integers(nmol))
                b.rmw(c, lock0 + m, think=2)   # low-contention molecule lock
                base = mol0 + m * 4
                for w in range(3):
                    b.load(c, base + w, think=1)
                    b.store(c, base + w, think=1)
            pb = priv0 + c * 24
            for i in range(20):
                b.load(c, pb + rng.integers(24), think=1)
                b.store(c, pb + rng.integers(24), think=1)
        b.barrier()
    return b.build(priv0 + n_cores * 24 + 8, "water_nsq")


def gen_water_sp(n_cores, seed=0, scale=1.0):
    """Almost entirely private working set (paper's 3x-traffic outlier with a
    tiny absolute traffic level): very low miss rate, rare shared reads."""
    rng = np.random.default_rng(seed + 7)
    b = _Builder(n_cores)
    shared = 32
    priv0 = shared
    steps = max(2, int(4 * scale))
    for s in range(steps):
        for c in range(n_cores):
            pb = priv0 + c * 16       # fits in L1 -> near-zero misses
            for i in range(120):
                b.load(c, pb + rng.integers(16), think=1)
                if i % 3 == 0:
                    b.store(c, pb + rng.integers(16), think=1)
            for i in range(2):
                b.load(c, int(rng.integers(shared)), think=2)
        b.barrier()
    return b.build(priv0 + n_cores * 16 + 8, "water_sp")


def gen_cholesky(n_cores, seed=0, scale=1.0):
    """Task-queue heavy: a ticket-locked global counter feeds tasks; tasks
    read a shared panel and update private columns.  Spin-heavy."""
    rng = np.random.default_rng(seed + 8)
    b = _Builder(n_cores)
    nlocks = 8                           # per-column-group ticket locks
    locks0, head = 0, nlocks
    panel0 = nlocks + 2
    panel = 256
    priv0 = panel0 + panel
    ntasks = max(n_cores * 2, int(n_cores * 6 * scale))
    # column-group ticket locks + an atomic head counter: spin-heavy (the
    # paper's period-sensitive benchmark, Figs 7-8) but handoffs parallelize
    # across 8 locks, so 64 cores stay near parity while 256 cores (or
    # period=1000) saturate the spins -- matching the paper's behaviour.
    for t in range(ntasks):
        c = t % n_cores
        b.rmw(c, head, think=1)          # atomic task fetch
        lk = locks0 + (t % nlocks)
        b.lock_acquire(c, lk, think=1)
        # supernodal panel update under the column lock
        for i in range(24):
            b.load(c, panel0 + int(rng.integers(panel)), think=6)
        b.lock_release(c, lk)
        pb = priv0 + c * 24
        for i in range(30):
            b.load(c, pb + rng.integers(24), think=3)
            b.store(c, pb + rng.integers(24), think=3)
    b.barrier()
    return b.build(priv0 + n_cores * 24 + 8, "cholesky")


def gen_volrend(n_cores, seed=0, scale=1.0):
    """Read-mostly shared scene + work-stealing counters: the paper's most
    renewal-heavy benchmark (65.8% of LLC requests are renewals)."""
    rng = np.random.default_rng(seed + 9)
    b = _Builder(n_cores)
    qlock = 0
    scene0 = 4
    scene = 96        # fits L1: scene reads *hit but expire* -> renewals
    priv0 = scene0 + scene
    ntasks = max(n_cores * 2, int(n_cores * 5 * scale))
    # Work-stealing counters are *atomics*, not serialization points: each
    # task bumps the shared counter (rmw), which races every reader's pts
    # forward and expires the big read-only scene footprint -> the paper's
    # most renewal-heavy benchmark (65.8% of LLC requests are renewals).
    for t in range(ntasks):
        c = t % n_cores
        b.rmw(c, qlock, think=1)
        for i in range(30):              # big read-only scene footprint
            b.load(c, scene0 + int(rng.integers(scene)), think=1)
        pb = priv0 + c * 8
        for i in range(4):
            b.store(c, pb + rng.integers(8), think=1)
    b.barrier()
    return b.build(priv0 + n_cores * 8 + 8, "volrend")


TRACE_GENERATORS: Dict[str, Callable[..., Trace]] = {
    "fmm": gen_fmm,
    "barnes": gen_barnes,
    "cholesky": gen_cholesky,
    "volrend": gen_volrend,
    "ocean_c": lambda n, seed=0, scale=1.0: gen_ocean(n, seed, scale, True),
    "ocean_nc": lambda n, seed=0, scale=1.0: gen_ocean(n, seed, scale, False),
    "fft": gen_fft,
    "radix": gen_radix,
    "lu_c": lambda n, seed=0, scale=1.0: gen_lu(n, seed, scale, True),
    "lu_nc": lambda n, seed=0, scale=1.0: gen_lu(n, seed, scale, False),
    "water_nsq": gen_water_nsq,
    "water_sp": gen_water_sp,
}


def make_trace(name: str, n_cores: int, seed: int = 0, scale: float = 1.0) -> Trace:
    tr = TRACE_GENERATORS[name](n_cores, seed=seed, scale=scale)
    tr.name = name
    return tr
