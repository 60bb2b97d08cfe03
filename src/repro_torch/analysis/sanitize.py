"""Runtime lease sanitizer: vectorized invariants after every engine op.

The port of ``repro.analysis.sanitize``: :class:`LeaseSanitizer` checks
one engine, :class:`MigrationSanitizer` the sharded directory's page
migration and write-behind publishes (``sanitize.py:204-283``).

Enabled with ``TARDIS_SANITIZE=1`` or ``LeaseEngine(sanitize=True)``.  The
engine calls :meth:`LeaseSanitizer.after` at the end of every mutating
transition; the sanitizer keeps a host-side shadow of the previous table
state and asserts, in numpy (one vectorized pass, no per-block Python):

  * tables stay int32, non-negative, and ``wts <= rts`` everywhere,
  * table monotonicity: timestamps never move backwards except under a
    rebase, which must be exactly ``max(prev - shift, 0)`` on every block
    (the uniform shift+clamp preserves relative order by construction --
    anything else is flagged),
  * a reader's program timestamp never decreases,
  * a read's lease extension never grants past ``max(wts, pts) +
    lease_max`` (the Tardis 2.0 predictor's hard cap -- an over-predicting
    predictor trips here),
  * a write stamps ``wts = rts = ts`` with the exact Table I jump-ahead
    ``ts = max(pts, max(masked rts) + 1)``,
  * the KV validity bitmap equals the shadow of published-minus-evicted
    blocks (so validity never leaks onto blocks that were neither leased
    nor written),
  * the free list holds no duplicates, only ids from the allocatable
    region, and no freed page still holds valid KV content (use-after-free
    / double-free guards on top of the engine's own raising checks),
  * the interleaved pool layout keeps every stack's column window
    LANES-aligned and disjoint (checked once at attach).

When off the engine pays a single ``is None`` branch per op.  Failures
raise :class:`SanitizeError` (an ``AssertionError`` subclass) with the op
name and the offending block ids.
"""
from __future__ import annotations

import numpy as np

from ..kernels.tardis_lease.kernel import LANES


class SanitizeError(AssertionError):
    """A lease-engine invariant was violated at runtime."""


class LeaseSanitizer:
    """Shadow-state checker attached to one :class:`LeaseEngine`."""

    def __init__(self, engine):
        self.checks = 0
        self._check_layout(engine)
        self.rebaseline(engine)

    # -- baselines ----------------------------------------------------------

    def rebaseline(self, engine) -> None:
        """Reset the monotonicity shadow (engine init and ``set_tables``)."""
        self.prev_wts = np.array(engine.wts, copy=True)
        self.prev_rts = np.array(engine.rts, copy=True)
        self.prev_shift = int(engine.ts_shift)
        self.freed = set()            # pages freed and not re-allocated
        if engine.has_kv:
            self.written = np.array(engine._kv_valid, copy=True)
        else:
            self.written = None

    def _check_layout(self, engine) -> None:
        if not engine.has_kv:
            return
        windows = sorted((m["offset"], m["token_row"], name)
                         for name, m in engine._pool_meta.items())
        end = 0
        for off, width, name in windows:
            if off % LANES or width % LANES:
                self._fail("layout", f"pool {name!r} window [{off}, "
                           f"{off + width}) is not LANES-aligned")
            if off < end:
                self._fail("layout", f"pool {name!r} window [{off}, "
                           f"{off + width}) overlaps the previous stack "
                           f"(ends at {end})")
            end = off + width
        if end != engine.kv_token_row:
            self._fail("layout", f"pool windows end at {end} but the token "
                       f"row is {engine.kv_token_row} wide")

    # -- the per-op check ---------------------------------------------------

    def after(self, engine, op: str, **info) -> None:
        self.checks += 1
        wts = np.asarray(engine.wts)
        rts = np.asarray(engine.rts)
        if wts.dtype != np.int32 or rts.dtype != np.int32:
            self._fail(op, f"tables left int32: {wts.dtype}/{rts.dtype}")
        bad = np.flatnonzero(wts > rts)
        if bad.size:
            self._fail(op, f"wts > rts at blocks {bad[:8].tolist()}")
        if (wts < 0).any() or (rts < 0).any():
            self._fail(op, "negative timestamp in the table")

        shift = int(engine.ts_shift) - self.prev_shift
        if shift == 0:
            bad = np.flatnonzero((wts < self.prev_wts)
                                 | (rts < self.prev_rts))
            if bad.size:
                self._fail(op, f"timestamp moved backwards without a "
                           f"rebase at blocks {bad[:8].tolist()}")
        else:
            if shift < 0:
                self._fail(op, f"ts_shift decreased by {-shift}")
            want_w = np.maximum(self.prev_wts - shift, 0)
            want_r = np.maximum(self.prev_rts - shift, 0)
            bad = np.flatnonzero((wts != want_w) | (rts != want_r))
            if bad.size:
                self._fail(op, f"rebase by {shift} is not the uniform "
                           f"shift+clamp at blocks {bad[:8].tolist()} "
                           f"(relative order not preserved)")

        if op in ("read", "read_many"):
            pts = np.asarray(info["pts"])
            new_pts = np.asarray(info["new_pts"])
            if (new_pts < pts).any():
                self._fail(op, f"reader pts decreased: {pts} -> {new_pts}")
            if (wts != self.prev_wts).any():
                self._fail(op, "a read moved wts")
            # Tardis 2.0 lease cap: no extension (predicted or static) may
            # grant past max(wts, pts) + lease_max -- an over-predicted
            # lease would let stale reads linger arbitrarily long
            cap = int(getattr(engine, "lease_max", engine.lease))
            bound = np.maximum(self.prev_rts,
                               np.maximum(wts, int(pts.max())) + cap)
            bad = np.flatnonzero(rts > bound)
            if bad.size:
                self._fail(op, f"over-predicted lease: rts exceeds "
                           f"max(prev_rts, max(wts, pts) + lease_max "
                           f"= {cap}) at blocks {bad[:8].tolist()}")
        elif op == "write":
            idx = np.asarray(info["idx"])
            ts = int(info["ts"])
            want = max(int(info["pts"]),
                       int(self.prev_rts[idx].max(initial=-1)) + 1)
            if ts != want:
                self._fail(op, f"jump-ahead ts {ts} != max(pts, "
                           f"max(rts)+1) = {want}")
            if (wts[idx] != ts).any() or (rts[idx] != ts).any():
                self._fail(op, f"written blocks not stamped wts=rts={ts}")

        self._check_pages(engine, op, info)
        self._check_validity(engine, op, info)
        self.prev_wts = wts.copy()
        self.prev_rts = rts.copy()
        self.prev_shift = int(engine.ts_shift)

    # -- page allocator -----------------------------------------------------

    def _check_pages(self, engine, op, info) -> None:
        free = engine._free_pages
        if len(set(free)) != len(free):
            self._fail(op, "free list holds duplicate page ids")
        if free and not all(engine.alloc_reserve <= b < engine.n_blocks
                            for b in free):
            self._fail(op, "free list holds ids outside the allocatable "
                       "region")
        if op == "alloc_pages":
            ids = set(int(b) for b in np.asarray(info["idx"]).ravel())
            if ids & set(free):
                self._fail(op, f"allocated pages still on the free list: "
                           f"{sorted(ids & set(free))}")
            self.freed.difference_update(ids)
        elif op == "free_pages":
            self.freed.update(int(b)
                              for b in np.asarray(info["blocks"]).ravel())
        # use-after-free: a page that went through free_pages (and was not
        # re-allocated) must never regain valid KV content.  Blocks that
        # were simply never allocated are fair game -- with alloc_reserve=0
        # the whole table sits on the free list while callers address it
        # content-wise.
        if engine.has_kv and self.freed:
            stale = sorted(b for b in self.freed if engine._kv_valid[b])
            if stale:
                self._fail(op, f"freed pages regained valid KV content "
                           f"(use-after-free): {stale[:8]}")

    # -- KV validity bitmap -------------------------------------------------

    def _check_validity(self, engine, op, info) -> None:
        if not engine.has_kv:
            return
        # mirror the ops that publish / retract content
        if op in ("write_kv", "append_kv"):
            self.written[np.asarray(info["blocks"], np.int64)] = True
        elif op in ("invalidate_kv", "free_pages"):
            self.written[np.asarray(info["blocks"], np.int64)] = False
        valid = np.asarray(engine._kv_valid)
        extra = np.flatnonzero(valid & ~self.written)
        if extra.size:
            self._fail(op, f"validity bitmap marks blocks that were never "
                       f"written (or were evicted): {extra[:8].tolist()}")
        lost = np.flatnonzero(self.written & ~valid)
        if lost.size:
            self._fail(op, f"published blocks lost their validity bit "
                       f"outside invalidate/free: {lost[:8].tolist()}")

    def _fail(self, op, message):
        raise SanitizeError(f"TARDIS_SANITIZE[{op}]: {message}")


class MigrationSanitizer:
    """Invariant checks for cross-host page migration and write-behind
    publishing (:class:`repro_torch.core.shard_directory
    .ShardedLeaseDirectory`).

    Three classes of bug it turns into hard failures:

      * **double publish** -- the same host queues the identical
        ``(gid, tag, version)`` payload twice without a flush in between
        (two hosts racing to repair the same block is NOT a bug: the
        owner installs the first and drops the second by version),
      * **tampered carry** -- a migrated page must arrive under exactly
        the ``(wts, rts)`` lease the same wave's read extended and the
        directory's current content tag,
      * **use-after-migrate** -- a borrower serving a locally installed
        migrated page after the block was re-tagged underneath it.
    """

    def __init__(self):
        self.checks = 0
        self._pending = set()       # (host, gid, tag, wver) queued un-flushed
        self._installed = {}        # (host, gid) -> tag installed locally

    # -- write-behind publishes ---------------------------------------------

    def on_defer(self, host: int, gid: int, tag: int, wver: int) -> None:
        key = (int(host), int(gid), int(tag), int(wver))
        if key in self._pending:
            raise SanitizeError(
                f"TARDIS_SANITIZE[migrate]: double publish: host {host} "
                f"queued gid {gid} (tag {tag}, version {wver}) twice "
                f"without a flush")
        self._pending.add(key)
        self.checks += 1

    def on_flush(self, host: int, gid: int, tag: int, wver: int) -> None:
        self._pending.discard((int(host), int(gid), int(tag), int(wver)))
        self.checks += 1

    # -- migration carries ---------------------------------------------------

    def check_carried(self, page, lease, dir_tag: int) -> None:
        """``page`` is a FetchedPage; ``lease`` the (wts, rts) this wave's
        read returned for the gid; ``dir_tag`` the directory's current
        content tag."""
        w, r = int(lease[0]), int(lease[1])
        if (int(page.wts), int(page.rts)) != (w, r):
            raise SanitizeError(
                f"TARDIS_SANITIZE[migrate]: gid {page.gid} migrated under "
                f"(wts={page.wts}, rts={page.rts}) but the wave's lease is "
                f"({w}, {r})")
        if int(page.tag) != int(dir_tag):
            raise SanitizeError(
                f"TARDIS_SANITIZE[migrate]: gid {page.gid} migrated with "
                f"content tag {page.tag} != directory tag {dir_tag}")
        self.checks += 1

    # -- borrower-side installed copies --------------------------------------

    def mark_installed(self, host: int, gid: int, tag: int) -> None:
        self._installed[(int(host), int(gid))] = int(tag)
        self.checks += 1

    def on_invalidate(self, host: int, gid: int) -> None:
        self._installed.pop((int(host), int(gid)), None)
        self.checks += 1

    def on_use(self, host: int, gid: int, dir_tag: int) -> None:
        """A host is about to serve from its installed migrated copy."""
        got = self._installed.get((int(host), int(gid)))
        if got is None:
            raise SanitizeError(
                f"TARDIS_SANITIZE[migrate]: host {host} used gid {gid} "
                f"which was never installed (or already invalidated)")
        if got != int(dir_tag):
            raise SanitizeError(
                f"TARDIS_SANITIZE[migrate]: use-after-migrate: host {host} "
                f"serving gid {gid} tagged {got} but the directory moved "
                f"to {dir_tag}")
        self.checks += 1
