"""ShardedLeaseDirectory: ONE logical lease table + KV pool across N hosts.

The port of ``repro.core.shard_directory`` (``shard_directory.py:1-664``).
Block ids hash to an **owner shard** (``owner(gid) = gid % n_shards``,
``slot(gid) = gid // n_shards``) and each shard is a private
:class:`~repro_torch.core.lease_engine.LeaseEngine` holding its slice of
the ``(wts, rts)`` tables plus the *home* copy of its blocks' KV pool
pages.  Hosts keep private caches of remotely-owned payloads; coherence
between them is pure Tardis -- leases expire by timestamp comparison,
writers jump ahead, and **nobody ever sends an invalidation or
multicast**.

The unit of communication is the **wave**: a host's lease traffic for one
scheduling tick -- reads/renewals, tag re-writes, payload fetches, and any
write-behind publishes it has queued -- is partitioned by owner shard and
exchanged as AT MOST one request + one response message per contacted
shard (shards the host itself owns are local and free).  Inside a shard
the wave applies writes first, then pending publishes, then reads, then
fetches, so a same-wave re-tag drops a stale queued publish and a fetch
always rides a fresh read lease.

Payload movement is **timestamp-ordered page migration**: the owner
returns a ``(wts, rts, version)``-tagged page whose lease was extended by
the same wave's read.  Writers publish **write-behind**: a write re-tags
the directory and invalidates the home slot at once (metadata only), the
payload rides a later wave's request message (:meth:`defer_publish` /
:meth:`flush_deferred`), and a publish whose tag or version no longer
matches is dropped.  :meth:`maybe_rebase` shifts every shard by one
uniform amount, so cross-shard timestamp order survives.

On a ``"device"`` directory (the reference's ``"pallas"``) every shard's
tables and home pool live on ``device``: a read is K1, a write K2, a fetch
K3's gather out of the owner's home pool and a flushed publish K3's
scatter into it.  A migrated page is a tensor on the owner shard's device
and never passes through numpy (numpy has no bfloat16); it moves to
another device only by an explicit ``.to``.  ``"numpy"`` is the host
mirror (tables in numpy, pools as CPU tensors).  Traffic is flit-charged
(:data:`repro_torch.core.protocol.FLIT_BYTES`) and :class:`NumpyTransport`
routes every wave's per-shard flit counts through the deterministic
:func:`repro_torch.dist.collectives.np_all_to_all`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import protocol, timestamps
from ..device import DeviceLike
from ..dist import collectives
from .lease_engine import LeaseEngine
from .policy import CoherencePolicy


@dataclasses.dataclass
class DirStats:
    """Cross-host ledger.  Local-shard operations charge nothing here."""
    waves: int = 0
    req_msgs: int = 0
    rep_msgs: int = 0
    flits: int = 0
    migrations: int = 0          # payload pages moved host-to-host
    publishes: int = 0           # write-behind payloads installed at home
    publishes_dropped: int = 0   # stale (re-tagged before the flush landed)
    watches: int = 0             # publish-then-notify subscriptions taken
    notifies: int = 0            # landed-page notifications delivered
    multicasts: int = 0          # stays 0: Tardis sends none
    invalidation_msgs: int = 0   # stays 0: expiry is a timestamp compare

    @property
    def msgs(self) -> int:
        return self.req_msgs + self.rep_msgs

    @property
    def wire_bytes(self) -> int:
        return self.flits * protocol.FLIT_BYTES


@dataclasses.dataclass
class FetchedPage:
    """A migrated page: payload + the exact lease/content tags it carries."""
    gid: int
    wts: int
    rts: int
    tag: int
    wver: int
    blocks: Mapping[str, torch.Tensor]   # {pool: (1, *pool_shape)}
    pred_lease: int = 0                  # owner's predicted lease travels too


@dataclasses.dataclass
class DirWaveResult:
    new_pts: int                         # max over reads + writes
    group_pts: np.ndarray                # (G,) per-read-group new pts
    leases: Dict[int, Tuple[int, int]]   # gid -> (wts, rts) post-extension
    renew_ok: Dict[int, bool]            # requester's cached wts still current
    expired: Dict[int, bool]             # pts > rts at wave entry
    write_ts: Dict[int, int]             # gid -> jump-ahead ts from this wave
    fetched: Dict[int, FetchedPage]      # gid -> migrated page
    msgs: int                            # cross-host messages this wave
    shards_contacted: int                # remote owner shards exchanged with


def page_on(blocks: Mapping, device) -> Dict[str, torch.Tensor]:
    """A page's ``{pool: payload}`` as tensors on ``device``: the explicit
    move of a page between a shard's device and a host's (numpy payloads
    become tensors first)."""
    return {k: torch.as_tensor(v).to(device) for k, v in blocks.items()}


class NumpyTransport:
    """Deterministic host mirror of the device shard exchange.

    Every wave's per-destination-host flit counts are routed through
    :func:`repro_torch.dist.collectives.np_all_to_all`: only the source
    host's row block is populated, the transpose lands block ``src`` of
    destination ``dst`` on host ``dst``, and the round-trip is asserted
    bit-for-bit before the wave proceeds.
    """

    def __init__(self, n_hosts: int):
        self.n_hosts = int(n_hosts)
        self.routes = 0

    def exchange(self, src: int, sizes: np.ndarray) -> np.ndarray:
        """Route ``sizes`` ((n_hosts, k) int64, row = payload for that
        destination host) from host ``src``; returns what ``src`` would
        see after the response leg (its own row of the transpose)."""
        n = self.n_hosts
        sizes = np.asarray(sizes, np.int64).reshape(n, -1)
        per_host = [np.zeros_like(sizes) for _ in range(n)]
        per_host[src] = sizes
        out = collectives.np_all_to_all(per_host)
        for dst in range(n):
            got = out[dst].reshape(n, -1)
            if not np.array_equal(got[src], sizes[dst]):
                raise AssertionError(
                    f"transport route {src}->{dst} corrupted: "
                    f"{got[src]} != {sizes[dst]}")
            rest = np.delete(got, src, axis=0)
            if rest.any():
                raise AssertionError(
                    f"transport leaked data onto host {dst} from a host "
                    f"that sent nothing")
        self.routes += int((sizes != 0).any(axis=1).sum())
        return out[src].reshape(n, -1)


class ShardedLeaseDirectory:
    """N-shard lease directory over one global block-id space.

    ``n_hosts`` defaults to ``n_shards`` (shard ``s`` lives on host
    ``s % n_hosts``).  ``backend`` ("device" or "numpy"), ``device``,
    ``kv_pools``, ``kv_dtype`` and ``block_bytes`` configure each shard's
    :class:`LeaseEngine` (home pools are directory-managed: the per-shard
    free list is empty, slots are addressed by ownership).
    """

    def __init__(self, n_blocks: int, n_shards: int, *,
                 policy: Optional[CoherencePolicy] = None,
                 n_hosts: Optional[int] = None, lease: int = 64,
                 backend: str = "device", ts_bits: int = 30,
                 block_bytes: int = 0,
                 kv_pools: Optional[Mapping[str, Sequence[int]]] = None,
                 kv_dtype=torch.bfloat16, sanitize: Optional[bool] = None,
                 transport: Optional[NumpyTransport] = None,
                 device: DeviceLike = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if policy is None:
            policy = CoherencePolicy(lease=int(lease), ts_bits=int(ts_bits))
        self.policy = policy
        self.n_blocks = int(n_blocks)
        self.n_shards = int(n_shards)
        self.n_hosts = int(n_hosts) if n_hosts is not None else self.n_shards
        self.lease = int(policy.lease)
        self.ts_bits = int(policy.ts_bits)
        self.block_bytes = int(block_bytes)
        self.n_slots = -(-self.n_blocks // self.n_shards)
        # each shard engine carries its slots' predictor state, so a
        # prediction lives at (and travels with) the block's owner
        self.shards: List[LeaseEngine] = [
            LeaseEngine(self.n_slots, policy=policy, backend=backend,
                        block_bytes=block_bytes, kv_pools=kv_pools,
                        kv_dtype=kv_dtype, alloc_reserve=self.n_slots,
                        sanitize=sanitize, device=device)
            for _ in range(self.n_shards)]
        self.device = self.shards[0].device
        # content truth: directory-global tag + monotone version per block
        self.tags = np.full(self.n_blocks, -1, np.int64)
        self.wver = np.zeros(self.n_blocks, np.int64)
        self.ts_shift = 0
        self.rebases = 0
        self.stats = DirStats()
        self.wave_log: List[dict] = []
        # write-behind queues: host -> shard -> [(gid, blocks, tag, wver)]
        self._pending: Dict[int, Dict[int, list]] = {}
        # publish-then-notify: gid -> {watcher host: expected tag or None};
        # a successful home install delivers a notification message (one
        # pair per (owner shard, watcher host) per wave)
        self._watch: Dict[int, Dict[int, Optional[int]]] = {}
        self._notify_ready: Dict[int, List[int]] = {}
        self.transport = transport if transport is not None else \
            NumpyTransport(self.n_hosts)
        if sanitize is None:
            sanitize = os.environ.get("TARDIS_SANITIZE", "0").lower() \
                not in ("", "0", "false", "off")
        self._msan = None
        if sanitize:
            from ..analysis.sanitize import MigrationSanitizer
            self._msan = MigrationSanitizer()

    # -- id space ------------------------------------------------------------

    def owner(self, gid: int) -> int:
        return int(gid) % self.n_shards

    def slot(self, gid: int) -> int:
        return int(gid) // self.n_shards

    def shard_host(self, shard: int) -> int:
        return int(shard) % self.n_hosts

    def gid_of(self, shard: int, slot: int) -> int:
        return int(slot) * self.n_shards + int(shard)

    def _global(self, per_shard, fill) -> np.ndarray:
        out = np.full(self.n_blocks, fill, np.int32)
        for s, vals in enumerate(per_shard):
            gids = np.arange(s, self.n_blocks, self.n_shards)
            out[gids] = vals[:gids.size]
        return out

    @property
    def wts(self) -> np.ndarray:
        """Reassembled global wts table (verification view)."""
        return self._global((e.wts for e in self.shards), 0)

    @property
    def rts(self) -> np.ndarray:
        return self._global((e.rts for e in self.shards), 0)

    @property
    def pred_lease(self) -> np.ndarray:
        """Reassembled global predicted-lease view (owner-side state)."""
        return self._global((e.pred_lease for e in self.shards), self.lease)

    def home_ok(self, gid: int) -> bool:
        """Does the owner shard hold valid home content for ``gid``'s
        current tag?  (False between a re-tag and its publish flush.)"""
        return self.shards[self.owner(gid)].kv_ok(self.slot(gid))

    def home_rows(self, gid: int) -> torch.Tensor:
        """The owner shard's home pool row of ``gid`` (a view, for bit
        comparisons of migrated pages)."""
        return self.shards[self.owner(gid)]._kv_pool[self.slot(gid)]

    @property
    def sanitize_checks(self) -> int:
        eng = sum(e.sanitize_checks for e in self.shards)
        return eng + (self._msan.checks if self._msan is not None else 0)

    # -- write-behind publishes ---------------------------------------------

    def defer_publish(self, host: int, gid: int, blocks,
                      tag: Optional[int] = None,
                      wver: Optional[int] = None) -> None:
        """Queue ``gid``'s new payload for its home shard; it rides the
        next wave ``host`` sends (or :meth:`flush_deferred`).  ``tag`` /
        ``wver`` default to the directory's current values -- the writer
        publishes the content it just re-tagged."""
        gid = int(gid)
        tag = int(self.tags[gid]) if tag is None else int(tag)
        wver = int(self.wver[gid]) if wver is None else int(wver)
        if self._msan is not None:
            self._msan.on_defer(host, gid, tag, wver)
        shard = self.owner(gid)
        self._pending.setdefault(int(host), {}).setdefault(
            shard, []).append((gid, blocks, tag, wver))

    def _apply_pends(self, host: int, shard: int) -> int:
        """Install this host's queued publishes at ``shard``; returns the
        number of payload blocks that rode the request message.  Installed
        blocks with watchers trigger a publish-then-notify exchange."""
        pends = self._pending.get(int(host), {}).pop(shard, [])
        eng = self.shards[shard]
        landed: List[int] = []
        for gid, blocks, tag, wver in pends:
            if self._msan is not None:
                self._msan.on_flush(host, gid, tag, wver)
            if self.tags[gid] != tag or self.wver[gid] != wver:
                self.stats.publishes_dropped += 1   # re-tagged underneath
                continue
            if not isinstance(blocks, Mapping):
                blocks = {eng._single_pool(): blocks}
            eng.write_kv(np.asarray([self.slot(gid)], np.int64),
                         page_on(blocks, eng.device))
            self.stats.publishes += 1
            landed.append(gid)
        if landed:
            self._emit_notifies(shard, landed)
        return len(pends)

    # -- publish-then-notify --------------------------------------------------

    def subscribe(self, host: int, gids: Sequence,
                  tags: Optional[Sequence] = None) -> List[int]:
        """Register ``host`` to be told when each gid's home payload lands
        (the disaggregated hand-off: a decode pod subscribes to the pages a
        prefill pod will publish, instead of polling the directory).

        Returns the gids that are ALREADY home (under the expected ``tags``
        when given) -- no watch is taken for those.  The remaining watches
        ride one request + one ack message per contacted remote owner
        shard; the matching notification is delivered by
        :meth:`_apply_pends` when the publish installs, and drained with
        :meth:`pop_notifications`.
        """
        host = int(host)
        gids = list(gids)
        if tags is not None and len(tags) != len(gids):
            raise ValueError("tags must align with gids")
        want: Dict[int, Optional[int]] = {}
        for i, g in enumerate(gids):
            want.setdefault(int(g), None if tags is None else int(tags[i]))
        landed, by_shard = [], {}
        for g, tag in want.items():
            if self.home_ok(g) and (tag is None or int(self.tags[g]) == tag):
                landed.append(g)
                continue
            self._watch.setdefault(g, {})[host] = tag
            by_shard.setdefault(self.owner(g), []).append(g)
            self.stats.watches += 1
        if not by_shard:
            return landed
        sizes = np.zeros((self.n_hosts, 2), np.int64)
        log = {"host": host, "kind": "watch", "shards": sorted(by_shard),
               "msgs": 0, "flits": 0}
        for s, watched in sorted(by_shard.items()):
            if self.shard_host(s) == host:
                continue                            # local shard: free
            req = 1 + protocol.data_flits(4 * len(watched))
            rep = 1                                 # bare ack
            self.stats.req_msgs += 1
            self.stats.rep_msgs += 1
            self.stats.flits += req + rep
            sizes[self.shard_host(s)] += (req, rep)
            log["msgs"] += 2
            log["flits"] += req + rep
        if self.transport is not None and sizes.any():
            self.transport.exchange(host % self.n_hosts, sizes)
        self.wave_log.append(log)
        return landed

    def _emit_notifies(self, shard: int, gids: Sequence[int]) -> None:
        """A publish landed at ``shard`` for ``gids``: deliver one
        notification message pair per watcher host (all of a watcher's
        landed gids in this wave batch into ONE pair)."""
        by_watcher: Dict[int, List[int]] = {}
        for g in gids:
            for w, tag in self._watch.pop(int(g), {}).items():
                if tag is not None and int(self.tags[g]) != tag:
                    continue            # landed under a different content
                by_watcher.setdefault(w, []).append(int(g))
        src = self.shard_host(shard)
        for w, got in sorted(by_watcher.items()):
            self._notify_ready.setdefault(w, []).extend(got)
            self.stats.notifies += len(got)
            if w == src:
                continue                            # watcher is home: free
            req = 1 + protocol.data_flits(4 * len(got))
            rep = 1                                 # bare ack
            self.stats.req_msgs += 1
            self.stats.rep_msgs += 1
            self.stats.flits += req + rep
            sizes = np.zeros((self.n_hosts, 2), np.int64)
            sizes[w] = (req, rep)
            if self.transport is not None:
                self.transport.exchange(src, sizes)
            self.wave_log.append(
                {"host": src, "kind": "notify", "shards": [shard],
                 "watcher": w, "gids": list(got), "msgs": 2,
                 "flits": req + rep})

    def pop_notifications(self, host: int) -> List[int]:
        """Drain the landed-page notifications delivered to ``host``."""
        return self._notify_ready.pop(int(host), [])

    def flush_deferred(self, host: Optional[int] = None) -> int:
        """Drain write-behind queues (end of run / host drain) as
        publish-only waves: one request message per (host, owner shard)
        still holding payloads.  Returns the number of flush messages."""
        hosts = [int(host)] if host is not None else \
            sorted(self._pending.keys())
        sent = 0
        for h in hosts:
            shards = sorted(self._pending.get(h, {}).keys())
            if not shards:
                continue
            sizes = np.zeros((self.n_hosts, 2), np.int64)
            log = {"host": h, "kind": "flush", "shards": shards, "msgs": 0,
                   "flits": 0}
            for s in shards:
                n_pend = self._apply_pends(h, s)
                if self.shard_host(s) == h:
                    continue                        # local: free
                req = 1 + n_pend * protocol.data_flits(self.block_bytes)
                rep = 1                             # bare ack
                self.stats.req_msgs += 1
                self.stats.rep_msgs += 1
                self.stats.flits += req + rep
                log["msgs"] += 2
                log["flits"] += req + rep
                sizes[self.shard_host(s)] += (req, rep)
                sent += 1
            if self.transport is not None and sizes.any():
                self.transport.exchange(h % self.n_hosts, sizes)
            self.wave_log.append(log)
        return sent

    # -- the wave ------------------------------------------------------------

    def wave(self, host: int, pts: int, read_groups: Sequence = (),
             req_wts: Optional[Mapping[int, int]] = None,
             write_bids: Sequence = (), write_tags: Sequence = (),
             fetch_bids: Sequence = (),
             tag_writes_with_ts: bool = False) -> DirWaveResult:
        """Resolve one host's lease traffic for a tick.

        ``read_groups`` holds per-requester global block-id lists (the
        serving wave: one group per request).  ``write_bids`` get the
        jump-ahead plus a directory re-tag to the aligned ``write_tags``
        (or to the jump-ahead ts itself with ``tag_writes_with_ts`` -- the
        litmus stores, whose value IS the timestamp).  ``fetch_bids`` ask
        for page migration; each is implicitly read too, so the page
        carries the lease this wave just extended.  Pending publishes for
        every contacted shard ride the request message; shards holding
        only pends are contacted too.
        """
        host = int(host)
        pts = int(pts)
        groups = [list(dict.fromkeys(int(b) for b in g))
                  for g in read_groups]
        write_bids = [int(b) for b in write_bids]
        fetch_bids = list(dict.fromkeys(int(b) for b in fetch_bids))
        if not tag_writes_with_ts and len(write_bids) != len(write_tags):
            raise ValueError("write_tags must align with write_bids")
        read_union = {b for g in groups for b in g}
        orphan_fetches = [b for b in fetch_bids if b not in read_union]
        if orphan_fetches:       # a migrated page always rides a fresh read
            groups.append(orphan_fetches)
        n_groups = len(groups)

        by_shard: Dict[int, dict] = {}

        def shard_entry(s: int) -> dict:
            return by_shard.setdefault(
                s, {"groups": [[] for _ in range(n_groups)], "writes": [],
                    "tags": [], "fetches": []})

        for g, bids in enumerate(groups):
            for b in bids:
                shard_entry(self.owner(b))["groups"][g].append(b)
        for i, b in enumerate(write_bids):
            e = shard_entry(self.owner(b))
            e["writes"].append(b)
            if not tag_writes_with_ts:
                e["tags"].append(int(write_tags[i]))
        for b in fetch_bids:
            shard_entry(self.owner(b))["fetches"].append(b)
        for s in self._pending.get(host, {}):
            shard_entry(s)
        contacted = sorted(by_shard)

        leases: Dict[int, Tuple[int, int]] = {}
        renew_ok: Dict[int, bool] = {}
        expired: Dict[int, bool] = {}
        write_ts: Dict[int, int] = {}
        fetched: Dict[int, FetchedPage] = {}
        group_pts = np.full(n_groups, pts, np.int64)
        new_pts = pts
        sizes = np.zeros((self.n_hosts, 2), np.int64)
        log = {"host": host, "kind": "wave", "shards": contacted,
               "remote_shards": 0, "msgs": 0, "flits": 0}

        for s in contacted:
            e = by_shard[s]
            eng = self.shards[s]
            n_ids = (len({b for g in e["groups"] for b in g})
                     + len(e["writes"]) + len(e["fetches"]))

            # 1) writes: jump-ahead + re-tag; home content is now stale
            if e["writes"]:
                slots = np.asarray([self.slot(b) for b in e["writes"]],
                                   np.int64)
                ts = eng.write(slots, pts)
                new_pts = max(new_pts, ts)
                for i, b in enumerate(e["writes"]):
                    write_ts[b] = ts
                    self.tags[b] = ts if tag_writes_with_ts \
                        else e["tags"][i]
                    self.wver[b] += 1
                if eng.has_kv:
                    eng.invalidate_kv(slots)

            # 2) pending publishes (after writes: a same-wave re-tag
            #    drops the stale payload instead of installing it)
            n_pend = self._apply_pends(host, s)

            # 3) reads/renewals: one batched read_many per shard
            slot_groups = [[self.slot(b) for b in g] for g in e["groups"]]
            have_reads = any(slot_groups)
            if have_reads:
                req = None
                if req_wts:
                    req = {self.slot(b): w for b, w in req_wts.items()
                           if self.owner(b) == s and w is not None}
                rm = eng.read_many(slot_groups, pts, req_wts=req or None)
                for j, sl in enumerate(rm.union_idx):
                    b = self.gid_of(s, sl)
                    leases[b] = (int(rm.wts[j]), int(rm.rts[j]))
                    renew_ok[b] = bool(rm.renew_ok[:, j].any())
                    expired[b] = bool(rm.expired[:, j].any())
                for g in range(n_groups):
                    group_pts[g] = max(group_pts[g], int(rm.new_pts[g]))
                    new_pts = max(new_pts, int(rm.new_pts[g]))

            # 4) fetches: migrate home pages under the lease just taken
            #    (a K3 gather out of the owner's home pool on the device)
            for b in e["fetches"]:
                sl = self.slot(b)
                if not eng.kv_ok(sl):
                    continue                      # no home copy: repair
                blocks = eng.read_kv(np.asarray([sl], np.int64))
                if not isinstance(blocks, Mapping):
                    blocks = {eng._single_pool(): blocks}
                w, r = leases[b]
                fetched[b] = FetchedPage(
                    gid=b, wts=w, rts=r, tag=int(self.tags[b]),
                    wver=int(self.wver[b]), blocks=dict(blocks),
                    pred_lease=int(eng.pred_lease[sl]))
                self.stats.migrations += 1

            # 5) charge the exchange (remote shards only)
            if self.shard_host(s) == host:
                continue
            n_read = sum(len(set(g)) for g in slot_groups if g) \
                if have_reads else 0
            n_fetch = sum(1 for b in e["fetches"] if b in fetched)
            # the predicted lease piggybacks on the existing reply (4 more
            # bytes per read entry); the static path charges as before
            read_entry = 12 if self.policy.predictor else 8
            req_flits = (1 + protocol.data_flits(4 * n_ids + 8)
                         + n_pend * protocol.data_flits(self.block_bytes))
            rep_flits = (1 + protocol.data_flits(read_entry * n_read + 8)
                         + n_fetch
                         * (1 + protocol.data_flits(self.block_bytes)))
            self.stats.req_msgs += 1
            self.stats.rep_msgs += 1
            self.stats.flits += req_flits + rep_flits
            sizes[self.shard_host(s)] += (req_flits, rep_flits)
            log["remote_shards"] += 1
            log["msgs"] += 2
            log["flits"] += req_flits + rep_flits

        if self._msan is not None:
            for b, page in fetched.items():
                self._msan.check_carried(page, leases[b],
                                         int(self.tags[b]))
        if self.transport is not None and sizes.any():
            self.transport.exchange(host % self.n_hosts, sizes)
        self.stats.waves += 1
        self.wave_log.append(log)
        return DirWaveResult(
            new_pts=new_pts, group_pts=group_pts[:len(read_groups)]
            if len(read_groups) else group_pts,
            leases=leases, renew_ok=renew_ok, expired=expired,
            write_ts=write_ts, fetched=fetched, msgs=log["msgs"],
            shards_contacted=log["remote_shards"])

    def publish_barrier(self) -> None:
        """A weight publish swept the fleet: every home payload was
        computed under the OLD weights.  Invalidate every home slot (a
        manager-side bitmap clear per shard -- zero messages, tags and
        lease metadata stay) and bump every content version so queued
        write-behind publishes of old-weight payloads drop at flush."""
        for eng in self.shards:
            if eng.has_kv:
                eng.invalidate_kv(np.arange(eng.n_blocks))
        self.wver += 1

    # -- wraparound guard ----------------------------------------------------

    def maybe_rebase(self) -> int:
        """One uniform shift for every shard: cross-shard timestamp order
        is protocol state, so shards never rebase independently."""
        max_ts = max((int(np.max(e.rts, initial=0)) for e in self.shards),
                     default=0)
        if not timestamps.rebase_needed(max_ts, 0, self.ts_bits):
            return 0
        shift = timestamps.rebase_amount(self.ts_bits)
        for eng in self.shards:
            eng.force_rebase(shift)
        self.ts_shift += shift
        self.rebases += 1
        return shift

    # -- reporting -----------------------------------------------------------

    def max_msgs_per_wave(self) -> int:
        return max((w["msgs"] for w in self.wave_log), default=0)

    def report(self) -> dict:
        st = self.stats
        waves = [w for w in self.wave_log if w["kind"] == "wave"]
        return {
            "xhost_shards": self.n_shards,
            "xhost_hosts": self.n_hosts,
            "xhost_waves": st.waves,
            "xhost_msgs": st.msgs,
            "xhost_req_msgs": st.req_msgs,
            "xhost_rep_msgs": st.rep_msgs,
            "xhost_flits": st.flits,
            "xhost_bytes": st.wire_bytes,
            "xhost_migrations": st.migrations,
            "xhost_publishes": st.publishes,
            "xhost_publishes_dropped": st.publishes_dropped,
            "xhost_watches": st.watches,
            "xhost_notifies": st.notifies,
            "xhost_multicasts": st.multicasts,
            "xhost_invalidation_msgs": st.invalidation_msgs,
            "xhost_max_msgs_per_wave": self.max_msgs_per_wave(),
            "xhost_max_shards_per_wave": max(
                (w["remote_shards"] for w in waves), default=0),
            "xhost_transport_routes": (self.transport.routes
                                       if self.transport else 0),
            "xhost_rebases": self.rebases,
            "xhost_pred_grows": sum(e.stats.pred_grows
                                    for e in self.shards),
            "xhost_pred_shrinks": sum(e.stats.pred_shrinks
                                      for e in self.shards),
            "xhost_sanitize_checks": self.sanitize_checks,
        }

    def broadcast_baseline(self, n_hosts: Optional[int] = None) -> dict:
        """Counterfactual: a conventional full-map directory multicasting
        INV to every sharer on each write and collecting INV_ACKs, priced
        with every other host a sharer (the shared-prefix serving case)."""
        n_hosts = self.n_hosts if n_hosts is None else int(n_hosts)
        writes = sum(e.stats.writes for e in self.shards)
        sharers = max(0, n_hosts - 1)
        inv = writes * sharers
        flits = inv * (protocol.MESSAGE_FLITS["INV"]
                       + protocol.MESSAGE_FLITS["INV_ACK"])
        return {
            "hosts": n_hosts,
            "writes": writes,
            "bcast_inv_msgs": inv * 2,           # INV out + INV_ACK back
            "bcast_inv_flits": flits,
            "bcast_inv_bytes": flits * protocol.FLIT_BYTES,
            "tardis_inv_msgs": 0,
            "tardis_msgs": self.stats.msgs,
            "tardis_flits": self.stats.flits,
        }
