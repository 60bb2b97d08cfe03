"""LeaseEngine: the device-backed implementation of the lease rules.

The port of ``repro.core.lease_engine``.  The int32 ``(wts, rts)`` block
tables and the paged KV payload pool are torch tensors on the engine's
device; every read / renew / write-jump-ahead transition runs through
:mod:`repro_torch.kernels.tardis_lease.ops` -- on CUDA tensors the
hand-written kernels (K1 ``lease_pass``, K2 ``write_advance``, K3
``row_copy``), on CPU tensors their plain versions.  ``backend="numpy"``
keeps the bit-identical host mirror for differential tests (its tables
are numpy; its pool a CPU tensor, since numpy has no bfloat16).

Semantics are the JAX engine's, op for op: the 128-lane token-row padding
of the paged pool (so pools compare bit for bit), the duplicate-row
collapse of ``read_many``, the page allocator, the validity bitmap, the
``ts_bits`` rebase guard, flit-charged traffic accounting and the host
sync points ``int(ts)`` / ``int(new_pts)``.  Timestamps are int32 logical
counters; when any reaches ``2**ts_bits`` the tables shift down by
``2**(ts_bits-1)``, clamped at zero.

Paged KV pool(s): with ``kv_block_shape`` (serving: ``(chunk, 2,
L*kv_heads, head_dim)``) or named ``kv_pools`` the engine owns an
``(n_blocks, chunk * token_row)`` pool; each token row interleaves every
stack's lane-padded segment, so one block id leases every stack's payload.
``write_kv`` scatters whole block rows and ``append_kv`` token rows
through K3 in place, ``read_kv`` gathers through K3, and
``kv_rows_view`` is the (n_blocks*chunk, token_row) view the paged decode
step reads and appends to (in place, so ``set_kv_rows`` only keeps the
ledger).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, pick_device
from ..kernels.tardis_lease import ops as lease_ops
from . import protocol, timestamps
from .policy import CoherencePolicy


@dataclasses.dataclass
class LeaseStats:
    reads: int = 0               # blocks served through read()/renew
    writes: int = 0              # blocks written through write()
    read_ops: int = 0
    write_ops: int = 0
    expired: int = 0             # blocks whose lease had run out at read
    renewals: int = 0            # reads where the requester held a copy
    data_less: int = 0           # renewals answered RENEW_REP (no payload)
    payload_transfers: int = 0   # blocks answered SH_REP with data
    payload_bytes: int = 0
    flits: int = 0               # total message flits incl. headers
    rebases: int = 0
    kv_blocks_written: int = 0   # payload blocks scattered into the pool
    kv_blocks_read: int = 0      # payload blocks gathered out of the pool
    kv_evictions: int = 0        # pool slots freed by invalidate_kv
    kv_tokens_appended: int = 0  # single token rows appended into pages
    pages_allocated: int = 0     # free-list pops (decode page churn)
    pages_freed: int = 0         # free-list pushes
    pred_grows: int = 0          # predictor: leases grown (wasted renewal)
    pred_shrinks: int = 0        # predictor: leases shrunk (write hit)
    kv_pool_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def wire_bytes(self) -> int:
        return self.flits * protocol.FLIT_BYTES


@dataclasses.dataclass
class ReadResult:
    """Per-block outcome of a batched read/renew, aligned with ``idx``."""
    expired: np.ndarray          # bool: lease had run out (renewal happened)
    renew_ok: np.ndarray         # bool: requester's version matched (no data)
    wts: np.ndarray              # int32 block versions (unchanged by a read)
    rts: np.ndarray              # int32 extended leases
    new_pts: int                 # reader's program ts after consuming blocks


@dataclasses.dataclass
class ReadManyResult:
    """Outcome of a per-wave batched read: one lease pass for G groups.
    ``union_idx`` is the sorted union of the groups' block ids; ``wts`` /
    ``rts`` align with it; ``expired`` / ``renew_ok`` are (G, len(union))
    against the pre-call snapshot; ``new_pts`` is (G,)."""
    union_idx: np.ndarray
    expired: np.ndarray
    renew_ok: np.ndarray
    wts: np.ndarray
    rts: np.ndarray
    new_pts: np.ndarray


def _as_np_ids(idx) -> np.ndarray:
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    return np.atleast_1d(np.asarray(idx, np.int64))


class LeaseEngine:
    """Timestamp manager for a table of ``n_blocks`` leased blocks.

    ``backend="device"`` keeps tables and pool as tensors on ``device``
    (default: the card; ``device="cpu"`` runs the kernels' plain versions);
    ``backend="numpy"`` is the host mirror.
    """

    def __init__(self, n_blocks: int, lease: int = 64, *,
                 policy: Optional[CoherencePolicy] = None,
                 backend: str = "device", ts_bits: int = 30,
                 block_bytes: int = 0,
                 kv_block_shape: Optional[Sequence[int]] = None,
                 kv_pools: Optional[Mapping[str, Sequence[int]]] = None,
                 kv_dtype=torch.bfloat16, alloc_reserve: int = 0,
                 sanitize: Optional[bool] = None,
                 device: DeviceLike = None):
        if backend not in ("device", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        if policy is None:
            policy = CoherencePolicy(lease=int(lease), ts_bits=int(ts_bits))
        self.policy = policy
        self.n_blocks = int(n_blocks)
        self.lease = int(policy.lease)
        self.backend = backend
        self.device = (pick_device(device) if backend == "device"
                       else torch.device("cpu"))
        self.ts_bits = int(policy.ts_bits)
        self.block_bytes = int(block_bytes)
        # Tardis 2.0 per-block predicted leases (ts DELTAS: rebases never
        # touch them); pinned at the static lease with the predictor off
        self._pred_lease = np.full(self.n_blocks, policy.lease, np.int32)
        if backend == "device":
            self._wts = torch.zeros(self.n_blocks, dtype=torch.int32,
                                    device=self.device)
            self._rts = torch.zeros_like(self._wts)
        else:
            self._wts = np.zeros(self.n_blocks, np.int32)
            self._rts = np.zeros(self.n_blocks, np.int32)
        self.ts_shift = 0            # cumulative rebase amount
        self.stats = LeaseStats()
        # page allocator: ids in [alloc_reserve, n_blocks) are decode
        # pages, handed out lowest-id-first; ids below stay content-addressed
        self.alloc_reserve = int(alloc_reserve)
        self._free_pages = list(range(self.n_blocks - 1,
                                      self.alloc_reserve - 1, -1))
        self._free_set = set(self._free_pages)
        if kv_pools is not None and kv_block_shape is not None:
            raise ValueError("pass kv_block_shape or kv_pools, not both")
        if kv_pools is None and kv_block_shape is not None:
            kv_pools = {"kv": kv_block_shape}
        self.kv_pools: Optional[Dict[str, tuple]] = (
            {str(k): tuple(int(s) for s in v) for k, v in kv_pools.items()}
            if kv_pools else None)
        self.kv_block_shape = (next(iter(self.kv_pools.values()))
                               if self.kv_pools and len(self.kv_pools) == 1
                               else None)
        if self.kv_pools:
            chunks = {s[0] for s in self.kv_pools.values()}
            if len(chunks) != 1:
                raise ValueError(
                    f"all pools must share the chunk (token) dim, got "
                    f"{self.kv_pools}")
            self.kv_chunk = int(next(iter(chunks)))
            lanes = lease_ops.LANES
            self._pool_meta: Dict[str, Dict[str, int]] = {}
            off = 0
            for name, shape in self.kv_pools.items():
                te = int(np.prod(shape[1:]))
                row = -(-te // lanes) * lanes
                self._pool_meta[name] = {"offset": off, "token_elems": te,
                                         "token_row": row}
                off += row
            self.kv_token_row = off
            self._kv_row = self.kv_chunk * self.kv_token_row
            self._kv_pool = torch.zeros((self.n_blocks, self._kv_row),
                                        dtype=kv_dtype, device=self.device)
            self._kv_valid = np.zeros(self.n_blocks, bool)
            self.stats.kv_pool_tokens = {n: 0 for n in self.kv_pools}
        if sanitize is None:
            sanitize = os.environ.get("TARDIS_SANITIZE", "0").lower() \
                not in ("", "0", "false", "off")
        self._san = None
        if sanitize:
            from ..analysis.sanitize import LeaseSanitizer
            self._san = LeaseSanitizer(self)

    @property
    def sanitize_checks(self) -> int:
        return self._san.checks if self._san is not None else 0

    @property
    def lease_max(self) -> int:
        return self.policy.lease_max

    @property
    def pred_lease(self) -> np.ndarray:
        return self._pred_lease

    def set_pred_lease(self, idx, values) -> None:
        idx = _as_np_ids(idx)
        vals = np.broadcast_to(np.asarray(values, np.int32), idx.shape)
        self._pred_lease[idx] = np.clip(vals, self.policy.lease_min,
                                        self.policy.lease_max)

    def _lease_arg(self):
        """The per-block predicted vector under the predictor, else the
        static scalar (K1 takes either)."""
        if self.policy.predictor:
            return self._pred_lease
        return np.int32(self.lease)

    def _dev(self, a, site: str) -> torch.Tensor:
        """Host data onto the engine's device, one ``host.syncs`` at
        ``site``."""
        return obs.to_device(np.asarray(a), self.device, site)

    def set_tables(self, wts, rts) -> None:
        """Load externally computed ``(wts, rts)`` tables (resets the
        sanitizer's monotonicity baseline)."""
        wts = np.asarray(wts, np.int32).reshape(self.n_blocks)
        rts = np.asarray(rts, np.int32).reshape(self.n_blocks)
        if (wts > rts).any():
            raise ValueError("set_tables: wts > rts")
        if self.backend == "device":
            self._wts = self._dev(wts, "lease.set_tables")
            self._rts = self._dev(rts, "lease.set_tables")
        else:
            self._wts = wts.copy()
            self._rts = rts.copy()
        if self._san is not None:
            self._san.rebaseline(self)

    # -- table views --------------------------------------------------------

    @property
    def wts(self) -> np.ndarray:
        if self.backend == "device":
            return self._wts.cpu().numpy()
        return np.asarray(self._wts)

    @property
    def rts(self) -> np.ndarray:
        if self.backend == "device":
            return self._rts.cpu().numpy()
        return np.asarray(self._rts)

    # -- paged KV pool ------------------------------------------------------

    @property
    def has_kv(self) -> bool:
        return self.kv_pools is not None

    @property
    def pool_names(self) -> List[str]:
        return list(self.kv_pools) if self.kv_pools else []

    @property
    def kv_dtype(self) -> torch.dtype:
        return self._kv_pool.dtype

    def pool_offset(self, pool: str) -> int:
        return self._pool_meta[pool]["offset"]

    def pool_token_row(self, pool: str) -> int:
        return self._pool_meta[pool]["token_row"]

    def pool_token_elems(self, pool: str) -> int:
        return self._pool_meta[pool]["token_elems"]

    def _single_pool(self) -> str:
        if len(self.kv_pools) != 1:
            raise ValueError(
                f"engine has pools {self.pool_names}: name one explicitly")
        return next(iter(self.kv_pools))

    def kv_ok(self, bid: int) -> bool:
        return bool(self.has_kv and self._kv_valid[bid])

    def kv_valid_count(self) -> int:
        return int(self._kv_valid.sum()) if self.has_kv else 0

    def _pack_rows(self, blocks, n: int, pool: str):
        """(n, *pool_shape) payloads -> (n, chunk, row_p) token-padded."""
        meta = self._pool_meta[pool]
        x = torch.as_tensor(blocks, device=self.device).reshape(
            n, self.kv_chunk, meta["token_elems"]).to(self._kv_pool.dtype)
        return torch.nn.functional.pad(
            x, (0, meta["token_row"] - meta["token_elems"]))

    def write_kv(self, idx, blocks) -> None:
        """Publish block payloads into the pool(s): whole block rows
        through K3's scatter on the device backend (the JAX package stored
        them with an XLA scatter; the sharded directory's home installs
        and migrated-page installs are these calls)."""
        idx = _as_np_ids(idx)
        if not idx.size:
            return
        if not isinstance(blocks, Mapping):
            blocks = {self._single_pool(): blocks}
        if set(blocks) != set(self.kv_pools):
            raise ValueError(f"write_kv needs every pool "
                             f"{self.pool_names}, got {sorted(blocks)}")
        flat = torch.cat([self._pack_rows(blocks[name], idx.size, name)
                          for name in self.kv_pools], dim=-1
                         ).reshape(idx.size, self._kv_row)
        if self.backend == "device":
            lease_ops.append_rows(self._kv_pool, idx, flat)
        else:
            self._kv_pool[torch.as_tensor(idx)] = flat
        self._kv_valid[idx] = True
        self.stats.kv_blocks_written += int(idx.size)
        if self._san is not None:
            self._san.after(self, "write_kv", blocks=idx)

    def _rows_to_blocks(self, rows, n: int, pool: str):
        meta = self._pool_meta[pool]
        return rows[:, :, :meta["token_elems"]].reshape(
            (n,) + self.kv_pools[pool])

    def read_kv(self, idx, pool: Optional[str] = None):
        """Materialize pool payloads for leased block ids through K3's
        gather: (n, *kv_block_shape) for a single pool, a dict of them for
        several, or one stack's column window with ``pool=``."""
        idx = _as_np_ids(idx)
        dtype = self._kv_pool.dtype
        if not idx.size:
            if pool is not None or self.kv_block_shape:
                shape = self.kv_pools[pool] if pool else self.kv_block_shape
                return torch.zeros((0,) + shape, dtype=dtype,
                                   device=self.device)
            return {n_: torch.zeros((0,) + s, dtype=dtype,
                                    device=self.device)
                    for n_, s in self.kv_pools.items()}
        if pool is not None:
            meta = self._pool_meta[pool]
            rows_idx = (idx[:, None] * self.kv_chunk
                        + np.arange(self.kv_chunk)).reshape(-1)
            if self.backend == "device":
                rows = lease_ops.gather_blocks(
                    self.kv_rows_view(), rows_idx, col_lo=meta["offset"],
                    width=meta["token_row"])
            else:
                rows = self.kv_rows_view()[
                    torch.as_tensor(rows_idx),
                    meta["offset"]:meta["offset"] + meta["token_row"]]
            self.stats.kv_blocks_read += int(idx.size)
            rows = rows.reshape(idx.size, self.kv_chunk, meta["token_row"])
            return self._rows_to_blocks(rows, idx.size, pool)
        if self.backend == "device":
            rows = lease_ops.gather_blocks(self._kv_pool, idx)
        else:
            rows = self._kv_pool[torch.as_tensor(idx)]
        self.stats.kv_blocks_read += int(idx.size)
        rows = rows.reshape(idx.size, self.kv_chunk, self.kv_token_row)
        out = {}
        for name, meta in self._pool_meta.items():
            seg = rows[:, :, meta["offset"]:meta["offset"]
                       + meta["token_row"]]
            out[name] = self._rows_to_blocks(seg, idx.size, name)
        if self.kv_block_shape:
            return out[self._single_pool()]
        return out

    def invalidate_kv(self, idx) -> None:
        """Free pool slots on collision eviction: zero messages."""
        idx = _as_np_ids(idx)
        freed = int(self._kv_valid[idx].sum())
        self._kv_valid[idx] = False
        self.stats.kv_evictions += freed
        if self._san is not None:
            self._san.after(self, "invalidate_kv", blocks=idx)

    # -- decode pages: allocator + token-granular append --------------------

    def free_page_count(self) -> int:
        return len(self._free_pages)

    def alloc_pages(self, n: int) -> np.ndarray:
        """Pop ``n`` pages off the free list (lowest ids first)."""
        if n > len(self._free_pages):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free_pages)}")
        ids = np.asarray([self._free_pages.pop() for _ in range(n)],
                         np.int64)
        self._free_set.difference_update(int(b) for b in ids)
        self.stats.pages_allocated += int(n)
        if self._san is not None:
            self._san.after(self, "alloc_pages", idx=ids)
        return ids

    def free_pages(self, idx) -> None:
        """Return pages to the free list; their slots are invalidated.
        Double frees, never-allocated and out-of-region ids raise before
        any state changes."""
        idx = _as_np_ids(idx)
        if not idx.size:
            return
        ids = [int(b) for b in idx]
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"free_pages: duplicate page ids in one call: {sorted(ids)}")
        for b in ids:
            if not self.alloc_reserve <= b < self.n_blocks:
                raise ValueError(
                    f"free_pages: page {b} outside the allocatable region "
                    f"[{self.alloc_reserve}, {self.n_blocks})")
            if b in self._free_set:
                raise ValueError(
                    f"free_pages: page {b} is already free (double free, "
                    f"or never allocated) -- freeing again would hand it "
                    f"to two requests")
        if self.has_kv:
            self._kv_valid[idx] = False
        for b in sorted(ids, reverse=True):
            self._free_pages.append(b)
            self._free_set.add(b)
        self.stats.pages_freed += int(idx.size)
        if self._san is not None:
            self._san.after(self, "free_pages", blocks=idx)

    def kv_rows_view(self) -> torch.Tensor:
        """The pool as (n_blocks*chunk, token_row) rows -- a VIEW: the paged
        decode step appends into it in place."""
        return self._kv_pool.view(self.n_blocks * self.kv_chunk,
                                  self.kv_token_row)

    def set_kv_rows(self, rows, tokens_appended: int = 0) -> None:
        """Ledger a decode step's in-place token appends (``rows`` is the
        view the step wrote; a full-row append feeds every stack)."""
        pool = rows.reshape(self.n_blocks, self._kv_row)
        if pool.data_ptr() != self._kv_pool.data_ptr():
            self._kv_pool.copy_(pool)
        self.stats.kv_tokens_appended += int(tokens_appended)
        for name in self.kv_pools:
            self.stats.kv_pool_tokens[name] = (
                self.stats.kv_pool_tokens.get(name, 0)
                + int(tokens_appended))
        if self._san is not None:
            self._san.after(self, "set_kv_rows")

    def append_kv(self, rows_idx, token_rows,
                  pool: Optional[str] = None) -> None:
        """Scatter token rows into flat token slots ``rows_idx`` (= block_id
        * chunk + slot) through K3, in place.

        ``pool=None`` appends FULL token rows (n, kv_token_row) -- or, on a
        single-pool engine, unpadded (n, token_elems) rows -- and marks the
        touched blocks valid.  ``pool=name`` appends one stack's (n,
        token_elems) rows into its lane-padded column window only (zeros in
        the padding, neighbours' bits kept) and leaves validity alone.
        """
        rows_idx = _as_np_ids(rows_idx)
        if not rows_idx.size:
            return
        rows = torch.as_tensor(token_rows, device=self.device)
        view = self.kv_rows_view()
        if pool is not None:
            meta = self._pool_meta[pool]
            rows = rows.reshape(rows_idx.size, meta["token_elems"])
            if self.backend == "device":
                lease_ops.append_rows(view, rows_idx, rows,
                                      col_lo=meta["offset"],
                                      width=meta["token_row"])
            else:
                flat = torch.zeros((rows_idx.size, meta["token_row"]),
                                   dtype=view.dtype)
                flat[:, :meta["token_elems"]] = rows.to(view.dtype)
                view[torch.as_tensor(rows_idx),
                     meta["offset"]:meta["offset"] + meta["token_row"]] \
                    = flat
            self.stats.kv_tokens_appended += int(rows_idx.size)
            self.stats.kv_pool_tokens[pool] = (
                self.stats.kv_pool_tokens.get(pool, 0) + int(rows_idx.size))
            if self._san is not None:
                self._san.after(self, "append_kv",
                                blocks=np.zeros(0, np.int64))
            return
        rows = rows.reshape(rows_idx.size, -1)
        if rows.shape[1] != self.kv_token_row:
            meta = self._pool_meta[self._single_pool()]
            rows = rows.reshape(rows_idx.size, meta["token_elems"])
        if self.backend == "device":
            lease_ops.append_rows(view, rows_idx, rows)
        else:
            flat = torch.zeros((rows_idx.size, self.kv_token_row),
                               dtype=view.dtype)
            flat[:, :rows.shape[1]] = rows.to(view.dtype)
            view[torch.as_tensor(rows_idx)] = flat
        blocks = np.unique(rows_idx // self.kv_chunk)
        self._kv_valid[blocks] = True
        self.stats.kv_tokens_appended += int(rows_idx.size)
        for name in self.kv_pools:
            self.stats.kv_pool_tokens[name] = (
                self.stats.kv_pool_tokens.get(name, 0) + int(rows_idx.size))
        if self._san is not None:
            self._san.after(self, "append_kv", blocks=blocks)

    # -- protocol transitions ----------------------------------------------

    def _charge_reads(self, n: int, had_copy, renew_ok) -> None:
        data_less = int(np.sum(renew_ok & had_copy))
        payload = n - data_less
        st = self.stats
        st.read_ops += 1
        st.reads += n
        st.renewals += int(np.sum(had_copy))
        st.data_less += data_less
        st.payload_transfers += payload
        st.payload_bytes += payload * self.block_bytes
        st.flits += n * protocol.MESSAGE_FLITS["SH_REQ"]
        st.flits += data_less * protocol.MESSAGE_FLITS["RENEW_REP"]
        # SH_REP: header + timestamp flits, plus the block payload.
        st.flits += payload * (protocol.MESSAGE_FLITS["RENEW_REP"]
                               + protocol.data_flits(self.block_bytes))

    def _grow(self, idx, grow) -> None:
        """Predictor: every data-less renewal of a held copy is waste --
        grow the block's next lease."""
        if self.policy.predictor and np.any(grow):
            b = idx[grow]
            self._pred_lease[b] = np.minimum(self.policy.lease_max,
                                             self._pred_lease[b] * 2)
            self.stats.pred_grows += int(np.sum(grow))

    def read(self, idx, pts: int, req_wts=None) -> ReadResult:
        """Serve loads/renewals for ``idx`` at reader ``pts`` (Table III
        SH_REQ extension, Table I load pts advance); ``req_wts`` holds the
        requester's cached versions (None / -1: no copy)."""
        idx = _as_np_ids(idx)
        if idx.size == 0:
            return ReadResult(np.zeros(0, bool), np.zeros(0, bool),
                              np.zeros(0, np.int32), np.zeros(0, np.int32),
                              int(pts))
        mask = np.zeros(self.n_blocks, np.int32)
        mask[idx] = 1
        req = np.full(self.n_blocks, -1, np.int32)
        if req_wts is not None:
            req[idx] = np.asarray([-1 if r is None else r
                                   for r in np.ravel(req_wts)], np.int32)
        if self.backend == "device":
            out = lease_ops.masked_lease_check(
                self._wts, self._rts, self._dev(req, "lease.read.req"),
                self._dev(mask, "lease.read.mask"), np.int32(pts),
                self._lease_arg())
            self._rts = out["new_rts"]
            ti = self._dev(idx, "lease.read.ids")
            expired, renew_ok, wts_at, rts_at = (
                obs.to_host(x[ti], site).numpy() for x, site in (
                    (out["expired"], "lease.read.expired"),
                    (out["renew_ok"], "lease.read.renew_ok"),
                    (self._wts, "lease.read.wts"),
                    (self._rts, "lease.read.rts")))
            new_pts = int(obs.to_host(out["new_pts"], "lease.read.new_pts"))
        else:
            m = mask.astype(bool)
            lv = self._lease_arg()
            expired_f = m & (pts > self._rts)
            renew_f = m & (req == self._wts)
            ext = np.maximum(np.maximum(self._rts, self._wts + lv),
                             np.int32(pts) + lv)
            consumed = np.where(m & (pts <= self._rts), self._wts, 0)
            self._rts = np.where(m, ext, self._rts).astype(np.int32)
            expired = expired_f[idx]
            renew_ok = renew_f[idx]
            wts_at = self._wts[idx]
            rts_at = self._rts[idx]
            new_pts = int(max(pts, consumed.max(initial=0)))
        had_copy = req[idx] >= 0
        self._charge_reads(int(idx.size), had_copy, renew_ok)
        self.stats.expired += int(np.sum(expired))
        self._grow(idx, renew_ok & had_copy)
        if self._san is not None:
            self._san.after(self, "read", pts=int(pts), new_pts=new_pts)
        return ReadResult(expired, renew_ok, wts_at, rts_at, new_pts)

    def read_many(self, groups: Sequence, pts,
                  req_wts: Optional[Union[Dict[int, int], Sequence]] = None
                  ) -> ReadManyResult:
        """Per-wave batched read: G requester groups, ONE lease pass.

        Duplicate (blocks, pts) rows collapse to one mask row per DISTINCT
        requester and fan back out.  With a shared ``pts`` the table state
        and ``max(new_pts)`` equal issuing the G reads back to back.
        """
        with obs.span("lease.read_many"):
            return self._read_many(groups, pts, req_wts)

    def _read_many(self, groups, pts, req_wts) -> ReadManyResult:
        groups = [_as_np_ids(g) for g in groups]
        n_groups = len(groups)
        pts_vec = np.broadcast_to(np.asarray(pts, np.int32),
                                  (n_groups,)).copy()
        union = sorted({int(b) for g in groups for b in g})
        if not union:
            return ReadManyResult(
                np.zeros(0, np.int64), np.zeros((n_groups, 0), bool),
                np.zeros((n_groups, 0), bool), np.zeros(0, np.int32),
                np.zeros(0, np.int32), pts_vec)
        union_idx = np.asarray(union, np.int64)
        row_of, ukeys = [], {}
        for g, idx in enumerate(groups):
            key = (tuple(sorted({int(b) for b in idx})), int(pts_vec[g]))
            row_of.append(ukeys.setdefault(key, len(ukeys)))
        row_of = np.asarray(row_of)
        n_rows = len(ukeys)
        pts_rows = np.asarray([k[1] for k in ukeys], np.int32)
        masks = np.zeros((n_rows, self.n_blocks), np.int32)
        for key, row in ukeys.items():
            masks[row, list(key[0])] = 1
        req = np.full(self.n_blocks, -1, np.int32)
        if req_wts is not None:
            if isinstance(req_wts, dict):
                for bid, w in req_wts.items():
                    req[bid] = -1 if w is None else int(w)
            else:
                req[union_idx] = np.asarray(
                    [-1 if r is None else r for r in np.ravel(req_wts)],
                    np.int32)
        if self.backend == "device":
            out = lease_ops.masked_lease_check_many(
                self._wts, self._rts, self._dev(req, "lease.read_many.req"),
                self._dev(masks, "lease.read_many.masks"), pts_rows,
                self._lease_arg())
            self._rts = out["new_rts"]
            tu = self._dev(union_idx, "lease.read_many.ids")
            expired = obs.to_host(out["expired"][:, tu],
                                  "lease.read_many.expired").numpy()
            renew_ok = obs.to_host(out["renew_ok"][:, tu],
                                   "lease.read_many.renew_ok").numpy()
            wts_at = obs.to_host(self._wts[tu], "lease.read_many.wts").numpy()
            rts_at = obs.to_host(self._rts[tu], "lease.read_many.rts").numpy()
            new_pts = obs.to_host(out["new_pts"],
                                  "lease.read_many.new_pts").numpy()
        else:
            m = masks.astype(bool)
            lv = self._lease_arg()
            rts0 = self._rts
            expired_f = m & (pts_rows[:, None] > rts0[None, :])
            renew_f = m & (req[None, :] == self._wts[None, :])
            new_rts = rts0
            new_pts = pts_rows.copy()
            for g in range(n_rows):
                ext = np.maximum(np.maximum(rts0, self._wts + lv),
                                 np.int32(pts_rows[g]) + lv)
                new_rts = np.where(m[g], np.maximum(new_rts, ext), new_rts)
                consumed = np.where(m[g] & (pts_rows[g] <= rts0),
                                    self._wts, 0)
                new_pts[g] = max(int(pts_rows[g]),
                                 int(consumed.max(initial=0)))
            self._rts = new_rts.astype(np.int32)
            expired = expired_f[:, union_idx]
            renew_ok = renew_f[:, union_idx]
            wts_at = self._wts[union_idx]
            rts_at = self._rts[union_idx]
        expired = expired[row_of]              # fan the distinct-row results
        renew_ok = renew_ok[row_of]            # back out to the G groups
        new_pts = new_pts[row_of]
        had_copy = req[union_idx] >= 0
        renew_u = renew_ok.any(axis=0)
        self._charge_reads(int(union_idx.size), had_copy, renew_u)
        self.stats.expired += int(np.sum(expired.any(axis=0)))
        self._grow(union_idx, renew_u & had_copy)
        if self._san is not None:
            self._san.after(self, "read_many", pts=pts_vec, new_pts=new_pts)
        return ReadManyResult(union_idx, expired, renew_ok, wts_at, rts_at,
                              new_pts)

    def write_many(self, groups: Sequence, pts: int) -> int:
        """One jump-ahead over the union of the groups' blocks."""
        union = sorted({int(b) for g in groups for b in _as_np_ids(g)})
        if not union:
            return int(pts)
        with obs.span("lease.write_many"):
            return self.write(np.asarray(union, np.int64), pts)

    def write(self, idx, pts: int) -> int:
        """Writer jump-ahead (Table I store): ``ts = max(pts, max(rts[idx])
        + 1)``; each block gets wts = rts = ts.  Returns the writer's pts."""
        idx = _as_np_ids(idx)
        if idx.size == 0:
            return int(pts)
        mask = np.zeros(self.n_blocks, np.int32)
        mask[idx] = 1
        if self.backend == "device":
            self._wts, self._rts, ts = lease_ops.write_advance(
                self._wts, self._rts, self._dev(mask, "lease.write.mask"),
                int(pts))
            ts = int(obs.to_host(ts, "lease.write.ts"))
        else:
            m = mask.astype(bool)
            top = int(np.where(m, self._rts, -1).max(initial=-1))
            ts = max(int(pts), top + 1)
            self._wts = np.where(m, np.int32(ts), self._wts).astype(np.int32)
            self._rts = np.where(m, np.int32(ts), self._rts).astype(np.int32)
        n = int(idx.size)
        st = self.stats
        st.write_ops += 1
        st.writes += n
        st.payload_bytes += n * self.block_bytes
        # publish: one header flit + payload per block (DRAM_ST_REQ shape).
        st.flits += n * (1 + protocol.data_flits(self.block_bytes))
        if self.policy.predictor:
            self._pred_lease[idx] = np.maximum(
                self.policy.lease_min, self._pred_lease[idx] // 2)
            st.pred_shrinks += n
        if self._san is not None:
            self._san.after(self, "write", idx=idx, pts=int(pts), ts=ts)
        return ts

    # -- wraparound guard ---------------------------------------------------

    def maybe_rebase(self) -> int:
        """Shift the whole table down when timestamps approach
        2**ts_bits; returns the shift (0 when none was needed)."""
        if self.backend == "device":
            max_ts = (int(obs.to_host(self._rts.max(), "rebase.max_ts"))
                      if self.n_blocks else 0)
        else:
            max_ts = int(np.max(self._rts, initial=0))
        if not timestamps.rebase_needed(max_ts, 0, self.ts_bits):
            return 0
        return self.force_rebase(timestamps.rebase_amount(self.ts_bits))

    def force_rebase(self, shift: int) -> int:
        """Apply a given downward shift unconditionally (clamped at 0)."""
        shift = int(shift)
        if shift <= 0:
            return 0
        if self.backend == "device":
            self._wts = torch.clamp_min(self._wts - shift, 0)
            self._rts = torch.clamp_min(self._rts - shift, 0)
        else:
            self._wts = np.maximum(self._wts - shift, 0).astype(np.int32)
            self._rts = np.maximum(self._rts - shift, 0).astype(np.int32)
        self.ts_shift += shift
        self.stats.rebases += 1
        if self._san is not None:
            self._san.after(self, "rebase")
        return shift

    @staticmethod
    def rebase_pts(pts: int, shift: int) -> int:
        return max(0, int(pts) - int(shift))

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        st = self.stats
        per_pool = {}
        if self.has_kv:
            for name in self.kv_pools:
                per_pool[f"kv_pool_tokens_{name}"] = \
                    st.kv_pool_tokens.get(name, 0)
        return {
            **per_pool,
            "blocks_read": st.reads,
            "blocks_written": st.writes,
            "read_ops": st.read_ops,
            "write_ops": st.write_ops,
            "kv_blocks_written": st.kv_blocks_written,
            "kv_blocks_read": st.kv_blocks_read,
            "kv_evictions": st.kv_evictions,
            "kv_tokens_appended": st.kv_tokens_appended,
            "pages_allocated": st.pages_allocated,
            "pages_freed": st.pages_freed,
            "free_pages": self.free_page_count(),
            "expired_leases": st.expired,
            "renewals": st.renewals,
            "data_less_renewals": st.data_less,
            "payload_transfers": st.payload_transfers,
            "payload_bytes": st.payload_bytes,
            "wire_flits": st.flits,
            "wire_bytes": st.wire_bytes,
            "rebases": st.rebases,
            "pred_grows": st.pred_grows,
            "pred_shrinks": st.pred_shrinks,
            "pred_lease_lo": int(self._pred_lease.min(initial=self.lease)),
            "pred_lease_hi": int(self._pred_lease.max(initial=self.lease)),
            "sanitize_checks": self.sanitize_checks,
        }
