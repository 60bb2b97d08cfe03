"""TardisStore: lease-coherent distributed object store (the framework layer).

This is the paper's protocol applied where a DSM protocol lives in an ML
system: coherence of *runtime objects* -- parameter versions, paged KV-cache
blocks, router/balance tables -- shared by many replicas:

  * readers take time-bounded leases (wts/rts per block, O(log N) metadata;
    no sharer lists anywhere),
  * a writer never broadcasts invalidations: it jumps ahead of every
    outstanding lease (``pts' = max(pts, rts+1)``) and publishes the new
    version instantly,
  * an expired reader *renews*; if its cached version still matches the
    manager's wts the renewal is data-less (RENEW_REP) -- for multi-GB
    parameter shards this is the difference between a header RPC and a full
    retransfer,
  * livelock is avoided exactly as in the paper: replicas self-increment
    their pts every ``selfinc_period`` operations.

The port of ``repro.core.store`` (pure Python and numpy).  Block-table
metadata lives in :class:`repro_torch.core.lease_engine.LeaseEngine` (the
lease kernels execute the transitions on the card); :class:`BlockTable`
below is a thin adapter over it.  The store tracks the
same message statistics the simulator does -- including per-message flits
from :data:`repro_torch.core.protocol.MESSAGE_FLITS` -- so the serving/elastic
examples can report renewal/traffic savings vs. a directory-style
invalidation broadcast.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import protocol
from .lease_engine import LeaseEngine


@dataclasses.dataclass
class StoreStats:
    reads: int = 0
    writes: int = 0
    renews: int = 0
    renew_data_less: int = 0
    payload_transfers: int = 0
    bytes_transferred: int = 0
    flits: int = 0                 # message flits incl. headers (SH_REQ/...)
    # what a full-map directory would have done for the same op stream
    dir_invalidations: int = 0
    dir_sharer_bits: int = 0

    @property
    def wire_bytes(self) -> int:
        """On-wire bytes including metadata headers (128-bit flits)."""
        return self.flits * protocol.FLIT_BYTES


class TardisStore:
    """Timestamp manager for a keyed set of versioned objects."""

    def __init__(self, lease: int = 10):
        self.lease = int(lease)
        self._lock = threading.Lock()
        self._wts: Dict[str, int] = {}
        self._rts: Dict[str, int] = {}
        self._val: Dict[str, Any] = {}
        self._nbytes: Dict[str, int] = {}
        # directory-comparison accounting only (Tardis never stores this):
        self._sharers: Dict[str, set] = {}
        self.stats = StoreStats()

    # -- manager-side protocol ops -----------------------------------------

    def publish(self, key: str, value: Any, pts: int, nbytes: int = 0) -> int:
        """Store: jump ahead of every lease (Table I store rule).

        Returns the writer's new pts.  No invalidation is sent; existing
        readers keep using their leased (older) versions legally.
        """
        with self._lock:
            rts = self._rts.get(key, 0)
            ts = max(pts, rts + 1)
            self._wts[key] = ts
            self._rts[key] = ts
            self._val[key] = value
            self._nbytes[key] = int(nbytes)
            self.stats.writes += 1
            # publish: EX_REQ header/ts flits + the new version's payload.
            self.stats.flits += (protocol.MESSAGE_FLITS["EX_REQ"]
                                 + protocol.data_flits(nbytes))
            # directory bookkeeping for comparison
            self.stats.dir_invalidations += len(self._sharers.get(key, ()))
            self._sharers[key] = set()
            return ts

    def acquire(self, key: str, pts: int, have_wts: Optional[int] = None,
                reader: str = "") -> Tuple[Any, int, int, bool]:
        """Load / renew: returns (value_or_None, wts, rts_lease, data_less).

        ``have_wts`` is the reader's cached version; when it matches, the
        renewal succeeds without a payload (value None, data_less=True).
        """
        with self._lock:
            if key not in self._wts:
                raise KeyError(key)
            wts = self._wts[key]
            new_rts = max(self._rts[key], wts + self.lease, pts + self.lease)
            self._rts[key] = new_rts
            self.stats.reads += 1
            self.stats.flits += protocol.MESSAGE_FLITS["SH_REQ"]
            self._sharers.setdefault(key, set()).add(reader)
            self.stats.dir_sharer_bits = max(
                self.stats.dir_sharer_bits,
                sum(len(s) for s in self._sharers.values()))
            if have_wts is not None:
                self.stats.renews += 1
                if have_wts == wts:
                    self.stats.renew_data_less += 1
                    self.stats.flits += protocol.MESSAGE_FLITS["RENEW_REP"]
                    return None, wts, new_rts, True
            nbytes = self._nbytes.get(key, 0)
            self.stats.payload_transfers += 1
            self.stats.bytes_transferred += nbytes
            # SH_REP: header + timestamp flits, plus the object payload.
            self.stats.flits += (protocol.MESSAGE_FLITS["RENEW_REP"]
                                 + protocol.data_flits(nbytes))
            return self._val[key], wts, new_rts, False

    def versions(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._wts)


class Replica:
    """A reader node: private lease cache + program timestamp.

    Mirrors the paper's private cache: reads hit locally while the lease
    covers ``pts``; expiry triggers a renewal (usually data-less); the
    replica's pts self-increments every ``selfinc_period`` local ops so
    remote updates become visible in bounded logical time.
    """

    def __init__(self, store: TardisStore, name: str = "",
                 selfinc_period: int = 100):
        self.store = store
        self.name = name
        self.pts = 1
        self.selfinc_period = int(selfinc_period)
        self._ops = 0
        self._cache: Dict[str, Tuple[Any, int, int]] = {}  # key -> (v, wts, rts)
        self.local_hits = 0
        self.renewals = 0
        self.refetches = 0

    def _tick(self):
        self._ops += 1
        if self._ops % self.selfinc_period == 0:
            self.pts += 1

    def read(self, key: str) -> Any:
        self._tick()
        ent = self._cache.get(key)
        if ent is not None:
            val, wts, rts = ent
            if self.pts <= rts:                      # unexpired lease: hit
                self.pts = max(self.pts, wts)
                self.local_hits += 1
                return val
            # expired: renew (data-less when version unchanged)
            self.renewals += 1
            nv, nwts, nrts, data_less = self.store.acquire(
                key, self.pts, have_wts=wts, reader=self.name)
            if data_less:
                self._cache[key] = (val, nwts, nrts)
                self.pts = max(self.pts, nwts)
                return val
            self.refetches += 1
            self._cache[key] = (nv, nwts, nrts)
            self.pts = max(self.pts, nwts)
            return nv
        nv, wts, rts, _ = self.store.acquire(key, self.pts, reader=self.name)
        self.refetches += 1
        self._cache[key] = (nv, wts, rts)
        self.pts = max(self.pts, wts)
        return nv

    def write(self, key: str, value: Any, nbytes: int = 0) -> None:
        self._tick()
        self.pts = self.store.publish(key, value, self.pts, nbytes)
        self._cache[key] = (value, self.pts, self.pts)

    def cached_version(self, key: str) -> Optional[int]:
        """The wts of this replica's cached copy (None when not cached)."""
        ent = self._cache.get(key)
        return ent[1] if ent is not None else None


class BlockTable:
    """Vectorized lease metadata for paged KV blocks.

    Thin adapter over :class:`repro_torch.core.lease_engine.LeaseEngine`:
    the lease kernels are the single source of truth for the Table I-III
    transitions; pass ``backend="numpy"`` to run the engine's host mirror
    instead (kept for differential tests).
    """

    def __init__(self, n_blocks: int, lease: int = 64, *,
                 backend: str = "device", kv_block_shape=None,
                 device=None):
        self.engine = LeaseEngine(n_blocks, lease=lease, backend=backend,
                                  kv_block_shape=kv_block_shape,
                                  device=device)
        self.lease = int(lease)

    @property
    def wts(self) -> np.ndarray:
        return self.engine.wts

    @property
    def rts(self) -> np.ndarray:
        return self.engine.rts

    def read_blocks(self, idx: np.ndarray, pts: int) -> Tuple[np.ndarray, int]:
        """Lease-extend a batch of blocks; returns (expired_mask, new_pts)."""
        res = self.engine.read(idx, pts)
        return res.expired, res.new_pts

    def write_blocks(self, idx: np.ndarray, pts: int) -> int:
        """Writer jump-ahead over every block in ``idx``."""
        return self.engine.write(idx, pts)

    def read_blocks_many(self, groups, pts: int) -> Tuple[np.ndarray, int]:
        """Per-wave batched form: G overlapping groups, one kernel dispatch.
        Returns (per-group expired flags over the union, the wave's pts)."""
        res = self.engine.read_many(groups, pts)
        return res.expired, int(res.new_pts.max(initial=pts))

    def write_blocks_many(self, groups, pts: int) -> int:
        """One jump-ahead over the union of the groups' blocks."""
        return self.engine.write_many(groups, pts)
