"""Tardis-coherent serving: continuous batching over paged pool KV.

The single-host paged path of ``repro.runtime.serve_loop``, in PyTorch.
Replicas serve requests against a shared *weight version* (a
:class:`~repro_torch.core.store.TardisStore` lease: a publish never
broadcasts, readers renew on expiry, data-less when unchanged) and a
shared paged KV pool owned by a :class:`~repro_torch.core.lease_engine
.LeaseEngine` on the card, whose lease transitions, pool gathers and token
appends run in the hand-written kernels.

Every KV byte a decode step touches lives in pool pages.  The pool is a
content-addressed region (prompt-prefix chunks chain-hashed to block ids,
shared under leases) plus an allocator region (private decode pages).  A
request's page table names its covered shared-prefix blocks followed by its
own pages; prefill scatters the prompt suffix's KV into its own pages and
each decode step appends the new token's row in place
(:func:`repro_torch.models.decode_step_paged`).  Requests join a replica's
running batch as soon as a slot and enough free pages exist, finish
independently and release their pages at once; covered prefix blocks stay
pinned and leased for the whole decode, and expired leases renew in one
batched ``read_many`` per tick.  A collision eviction hitting a pinned
block relocates its payload into a fresh page (zero messages).

The lease protocol is batched per admission group: one logical tick, one
``read_many`` for every renewal and at most one jump-ahead write over the
union of the misses.  Host sync points (``int(ts)``, argmax tokens) are
kept where the JAX package has them.

**Fixed-wave dense-cache path.**  A cluster whose engine holds no KV pool
(the ssm and hybrid families always, any family with
``prefix_reuse=False``) serves fixed waves of ``n_replicas`` requests
instead: per wave one batched prefix-lease interaction (metadata only)
and the rebase guard, then :meth:`DecodeReplica.serve` prefills the wave
into dense caches and decodes it in lockstep at one scalar position kept
on the device (:func:`repro_torch.models.decode_step`).  Attention over
caches of 2048+ slots runs in the split-KV decode kernel K5.

**Multi-host serving.**  :class:`MultiHostServingCluster` runs K hosts --
each a full ``ServingCluster`` -- in lockstep against ONE
:class:`~repro_torch.core.shard_directory.ShardedLeaseDirectory`
(``attach_directory``): the directory's shards own the prefix region's
``(wts, rts)`` tables and home pages, a prefix one host prefilled is
published write-behind and served on another by timestamp-ordered page
migration (a K3 gather out of the owner's home pool, a K3 scatter into the
borrower's; the page never leaves the device), and every wave costs at
most one message pair per remote owner shard, with zero invalidations and
zero multicasts.  With prefill / decode roles an admission router forwards
cold prefixes to prefill pods (``prefill_only_tick``) and hands streams
back to decode pods by publish-then-notify.  All hosts and shards share
one device (the reference's model of a fleet: ``serve_loop.py:1292-1609``).
"""
from __future__ import annotations

import dataclasses
import warnings
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.lease_engine import LeaseEngine
from ..core.policy import CoherencePolicy, resolve_policy
from ..core.shard_directory import ShardedLeaseDirectory, page_on
from ..core.store import Replica, TardisStore
from ..device import DeviceLike, pick_device
from ..models import (PAGED_FAMILIES, decode_step, decode_step_paged,
                      param_leaves, pool_layout, prefill, prefill_suffix)

KV_POOL_FAMILIES = PAGED_FAMILIES


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 8
    done: bool = False
    output: Optional[np.ndarray] = None


@dataclasses.dataclass
class WavePlan:
    """Outcome of the per-wave batched lease protocol: each request's
    prefix block ids, how many leading blocks are pool-backed (clamped so
    one token is left for prefill), and which request/chunk writes back
    each missed (``miss_writers``) or invalid-slot (``repair_writers``)
    block."""
    groups: List[List[int]]
    covered: List[int]
    miss_writers: Dict[int, Tuple[int, int]]
    repair_writers: Dict[int, Tuple[int, int]]


@dataclasses.dataclass
class Stream:
    """One in-flight request on the paged path: its page table and nothing
    else -- the KV itself lives in the engine's pool pages."""
    req: Request
    page_row: np.ndarray             # (max_pages,) int32 block ids
    own_pages: List[int]             # allocator-region pages (freed at end)
    shared_bids: List[int]           # pinned content blocks (leased)
    reloc_pages: List[int]           # eviction-relocated private copies
    length: int                      # tokens currently in pages
    emitted: List[int]

    @property
    def finished(self) -> bool:
        return len(self.emitted) >= self.req.max_new


class DecodeReplica:
    """One model replica: leased weights, its own program timestamp
    ``kv_pts`` and cached ``(wts, rts, content_tag)`` prefix-KV leases."""

    def __init__(self, cfg, store: TardisStore, name: str,
                 max_batch: int = 4, cache_len: int = 256,
                 selfinc_period: int = 8):
        self.cfg = cfg
        self.name = name
        self.reader = Replica(store, name, selfinc_period=selfinc_period)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.kv_pts = 0
        self.kv_leases: Dict[int, Tuple[int, int, int]] = {}
        self.trace: Optional[List[Dict]] = None   # the cluster's debug hook

    def params(self):
        """Weight access through the lease (renewal-on-expiry)."""
        return self.reader.read("params")

    def rebase_kv(self, shift: int) -> None:
        """Apply an engine rebase: shift pts/leases; drop leases whose rts
        would fall below the new base (cannot be raised unilaterally)."""
        if not shift:
            return
        self.kv_pts = max(0, self.kv_pts - shift)
        self.kv_leases = {
            bid: (max(0, w - shift), r - shift, t)
            for bid, (w, r, t) in self.kv_leases.items() if r >= shift}

    def serve(self, reqs: List[Request], params=None) -> List[Request]:
        """Dense-cache wave: greedy-decode a fixed wave of requests on the
        weights' device.  Kept exactly as the JAX package has it: prompts
        are right-padded with token 0 to the wave's longest, every
        request's first token comes from the logits at position s - 1, and
        the wave decodes in lockstep at one position ``cur`` (a device
        scalar), re-reading the weights through the lease every step."""
        if not reqs:
            return reqs
        if params is None:
            params = self.params()
        dev = params["embed"].device
        s = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt)] = r.prompt
        cache, logits = prefill(self.cfg, params,
                                {"tokens": torch.as_tensor(toks, device=dev)},
                                self.cache_len)
        self._trace("wave_prefill", reqs, logits)
        outs = [[] for _ in reqs]
        cur = torch.tensor(s, dtype=torch.int32, device=dev)
        next_tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        max_new = max(r.max_new for r in reqs)
        for _step in range(max_new):
            for o, t in zip(outs, next_tok[:, 0].tolist()):
                o.append(int(t))
            params = self.params()           # lease check per decode step
            cache, logits = decode_step(self.cfg, params, cache, next_tok,
                                        cur)
            self._trace("wave_step", reqs, logits)
            next_tok = torch.argmax(logits[:, -1], -1).to(
                torch.int32)[:, None]
            cur = cur + 1
        for r, o in zip(reqs, outs):
            r.output = np.asarray(o[:r.max_new], np.int32)
            r.done = True
        return reqs

    def _trace(self, ev: str, reqs: List[Request], logits) -> None:
        if self.trace is not None:
            self.trace.append({"ev": ev, "rep": self.name,
                               "rids": [r.rid for r in reqs],
                               "logits": logits.float().cpu().numpy()})


def _prefix_cache(stacks, pkv, batch: int, cache_len: int, skip: int,
                  dtype=torch.bfloat16):
    """Leased prefix KV -> a prefill cache with the prefix pre-filled (in
    bf16, where the JAX package rounds it), one (k, v) pair per stack."""
    cache = {}
    for s in stacks:
        kp, vp = pkv[s.pool]
        shape = (kp.shape[0], batch, cache_len) + tuple(kp.shape[2:])
        kc = torch.zeros(shape, dtype=dtype, device=kp.device)
        vc = torch.zeros(shape, dtype=dtype, device=kp.device)
        kc[:, :, :skip] = kp[:, None].to(dtype)
        vc[:, :, :skip] = vp[:, None].to(dtype)
        cache[s.cache_keys[0]] = kc
        cache[s.cache_keys[1]] = vc
    return cache


class CoherenceReport(dict):
    """The coherence ledger: the flat counter dict plus typed group
    accessors over the same entries."""

    _LEASE_KEYS = (
        "kv_lease", "consistency", "renewals", "data_less_renewals",
        "prefix_renewals", "prefix_local_hits",
        "prefix_data_less_renewals", "decode_renewals",
        "decode_renewals_skipped", "decode_local_hits", "pred_grows",
        "pred_shrinks", "pred_lease_lo", "pred_lease_hi")

    def _ns(self, prefix: str) -> Dict[str, Any]:
        return {k[len(prefix):]: self[k]
                for k in self if k.startswith(prefix)}

    @property
    def lease(self) -> Dict[str, Any]:
        return {k: self[k] for k in self._LEASE_KEYS if k in self}

    @property
    def xhost(self) -> Dict[str, Any]:
        return self._ns("xhost_")

    @property
    def role(self) -> Dict[str, Any]:
        return self._ns("role_")

    @property
    def router(self) -> Dict[str, Any]:
        return self._ns("router_")


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return [_to_device(v, device) for v in tree]


class ServingCluster:
    """N replicas + weight publisher + shared paged-KV LeaseEngine pool,
    on ``device`` (default: the card)."""

    def __init__(self, cfg, init_params_fn: Callable[[], Any],
                 n_replicas: int = 2, lease: int = 10,
                 n_prefix_blocks: int = 4096, prefix_block_tokens: int = 16,
                 kv_lease: Optional[int] = None, prefix_reuse: bool = True,
                 ts_bits: Optional[int] = None,
                 prefix_backend: str = "device",
                 n_decode_pages: int = 512, max_pages: int = 32,
                 sanitize: Optional[bool] = None,
                 policy: Optional[CoherencePolicy] = None,
                 device: DeviceLike = None,
                 **replica_kw):
        self.cfg = cfg
        self.device = pick_device(device)
        if kv_lease is not None or ts_bits is not None:
            if policy is not None:
                raise ValueError(
                    "pass either policy= or the legacy kv_lease=/ts_bits= "
                    "kwargs, not both")
            warnings.warn(
                "kv_lease=/ts_bits= are deprecated; pass policy="
                "CoherencePolicy(lease=..., ts_bits=...) instead",
                DeprecationWarning, stacklevel=2)
        self.policy = resolve_policy(policy, lease=kv_lease, ts_bits=ts_bits)
        self.store = TardisStore(lease=lease)
        p0 = _to_device(init_params_fn(), self.device)
        leaves = param_leaves(p0)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        self.publisher = Replica(self.store, "trainer")
        self.publisher.write("params", p0, nbytes=nbytes)
        self.param_bytes = nbytes
        # forward-pass cost of one prompt token (2 flops per weight): what
        # a prefix-pool hit saves prefill per skipped token
        self._flops_per_token = 2 * int(sum(t.numel() for t in leaves))
        self.replicas = [
            DecodeReplica(cfg, self.store, f"replica{i}", **replica_kw)
            for i in range(n_replicas)]
        self.prefix_block_tokens = int(prefix_block_tokens)
        self.prefix_reuse = bool(prefix_reuse)
        self.n_prefix_blocks = int(n_prefix_blocks)
        self.n_decode_pages = int(n_decode_pages)
        self.max_pages = int(max_pages)
        kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim()
                    * 4 * self.prefix_block_tokens)
        kv_pools = None
        self._stacks = []
        if self.prefix_reuse and cfg.family in KV_POOL_FAMILIES:
            self._stacks = pool_layout(cfg)
            hk, dh = cfg.n_kv_heads, cfg.head_dim()
            kv_pools = {s.pool: (self.prefix_block_tokens, 2,
                                 s.n_layers * hk, dh)
                        for s in self._stacks}
        n_blocks = self.n_prefix_blocks + (self.n_decode_pages
                                           if kv_pools else 0)
        self.prefix_engine = LeaseEngine(
            n_blocks, policy=self.policy, block_bytes=kv_bytes,
            backend=prefix_backend, kv_pools=kv_pools,
            alloc_reserve=self.n_prefix_blocks, sanitize=sanitize,
            device=self.device)
        if kv_pools:
            for s in self._stacks:
                assert self.prefix_engine.pool_offset(s.pool) == s.offset, \
                    (s, self.prefix_engine.pool_offset(s.pool))
        self._tags = np.full(n_blocks, -1, np.int64)       # content hashes
        # weight version each pool slot's KV was computed under
        self._pool_wver = np.full(n_blocks, -1, np.int64)
        self._pins: Dict[int, int] = {}
        self._reloc_refs: Dict[int, int] = {}
        self._admit_reserved = 0
        self._active: List[List[Stream]] = [[] for _ in self.replicas]
        self.trace: Optional[List[Dict]] = None   # test/debug hook
        self.prefix_stats = {
            "prefix_block_hits": 0, "prefix_local_hits": 0,
            "prefix_renewals": 0, "prefix_block_misses": 0,
            "prefix_evictions": 0, "prefix_evictions_deferred": 0,
            "prefix_tokens_reused": 0,
            "prefix_prefill_tokens_skipped": 0, "prefix_flops_saved": 0,
            "decode_renewals": 0, "decode_local_hits": 0,
            "decode_renewals_skipped": 0, "decode_block_reads": 0,
            "pinned_relocations": 0, "paged_mid_batch_admissions": 0,
            "paged_admission_deferrals": 0, "pool_page_peak": 0,
            "xhost_pages_fetched": 0, "xhost_pages_published": 0,
            "role_cold_prefills": 0, "role_suffix_admissions": 0,
            "role_pages_published": 0, "role_prefill_jobs": 0,
            "role_renewal_msgs": 0, "decode_ticks": 0,
        }
        # disaggregated serving role: "mixed" (serves everything),
        # "prefill" (only admits cold prefixes, publishes, never decodes)
        # or "decode" (never prefills a cold prefix)
        self.role = "mixed"
        # multi-host mode: with a ShardedLeaseDirectory attached, its
        # shards own the prefix region's (wts, rts) tables and home
        # payloads; the local engine keeps this host's payload cache and
        # decode pages.  Single-host behaviour is unchanged.
        self.directory = None
        self.host_id = 0
        self._migrated: set = set()       # bids installed by page migration
        self.paged = self.prefix_engine.has_kv

    def attach_directory(self, directory, host_id: int) -> None:
        """Join a sharded lease directory as host ``host_id``.

        The directory must cover exactly this cluster's prefix region with
        the same pool layout; from here on every prefix lease transition
        (classification, renewal, miss write, decode renewal) goes through
        :meth:`ShardedLeaseDirectory.wave` -- at most one message per owner
        shard per wave -- instead of the local engine's tables.
        """
        if not self.paged:
            raise ValueError("multi-host serving requires a paged family")
        eng = self.prefix_engine
        if directory.n_blocks != self.n_prefix_blocks:
            raise ValueError(
                f"directory covers {directory.n_blocks} blocks, host has "
                f"{self.n_prefix_blocks} prefix blocks")
        if directory.block_bytes != eng.block_bytes:
            raise ValueError("directory/host block_bytes mismatch")
        self.directory = directory
        self.host_id = int(host_id)

    def publish_weights(self, params) -> int:
        """Hot-swap: no invalidation broadcast; replicas renew on expiry.
        Pool payloads computed under the old weights are freed locally
        (a bitmap clear, zero messages); later admissions repair them."""
        self.publisher.write("params", _to_device(params, self.device),
                             nbytes=self.param_bytes)
        if self.prefix_engine.has_kv:
            self.prefix_engine.invalidate_kv(
                np.arange(self.prefix_engine.n_blocks))
        if self.directory is not None:
            msan = self.directory._msan
            if msan is not None:
                for bid in self._migrated:
                    msan.on_invalidate(self.host_id, bid)
            self._migrated.clear()
        return self.publisher.pts

    # -- prefix-KV content addressing ---------------------------------------

    def _prefix_blocks_of(self, prompt: np.ndarray) -> Tuple[List[int],
                                                             List[int]]:
        """Chain-hash whole prompt prefixes into (block_ids, content_tags)."""
        bt = self.prefix_block_tokens
        bids, tags = [], []
        h = 0
        for c in range(len(prompt) // bt):
            h = zlib.crc32(np.ascontiguousarray(
                prompt[c * bt:(c + 1) * bt]).tobytes(), h)
            bids.append(h % self.n_prefix_blocks)
            tags.append(h)
        return bids, tags

    def _evict_block(self, bid: int) -> bool:
        """Collision eviction of a content block about to be re-tagged; a
        pinned block first relocates into a fresh private page and the
        active streams remap (zero messages).  False when pinned and no
        free page exists."""
        eng = self.prefix_engine
        if eng.has_kv and self._pins.get(bid, 0):
            if eng.free_page_count() - self._admit_reserved < 1:
                return False
            new = int(eng.alloc_pages(1)[0])
            eng.write_kv([new], eng.read_kv([bid]))
            self._pool_wver[new] = self._pool_wver[bid]
            self._reloc_refs[new] = self._pins.pop(bid)
            for act in self._active:
                for s in act:
                    if bid in s.shared_bids:
                        s.shared_bids.remove(bid)
                        s.reloc_pages.append(new)
                        s.page_row = np.where(s.page_row == bid, new,
                                              s.page_row).astype(np.int32)
            self.prefix_stats["pinned_relocations"] += 1
        if eng.has_kv:
            eng.invalidate_kv([bid])
        if self.directory is not None and bid in self._migrated:
            self._migrated.discard(bid)
            if self.directory._msan is not None:
                self.directory._msan.on_invalidate(self.host_id, bid)
        return True

    def _lease_prefix_wave(self, rep: DecodeReplica,
                           prompts: List[np.ndarray]) -> WavePlan:
        """Per-wave batched prefix leasing for one replica: ONE logical
        tick, every request classified against the same table snapshot,
        all renewals in a single ``read_many`` and all misses in at most
        one jump-ahead write over their union."""
        if self.directory is not None:
            return self._lease_prefix_wave_dir(rep, prompts)
        rep.kv_pts += 1
        ps = self.prefix_stats
        bt = self.prefix_block_tokens
        groups, tags_by_req = [], []
        for prompt in prompts:
            bids, tags = self._prefix_blocks_of(prompt)
            groups.append(bids)
            tags_by_req.append(tags)
        covered = []
        for prompt, bids, tags in zip(prompts, groups, tags_by_req):
            c = 0
            for bid, tag in zip(bids, tags):
                if self._tags[bid] != tag or not self.prefix_engine.kv_ok(bid):
                    break
                c += 1
            covered.append(min(c, (len(prompt) - 1) // bt))

        local_wts: List[int] = []
        renew_groups: List[List[int]] = [[] for _ in prompts]
        renew_req: Dict[int, int] = {}
        miss_writers: Dict[int, Tuple[int, int]] = {}
        repair_writers: Dict[int, Tuple[int, int]] = {}
        for ri, (bids, tags) in enumerate(zip(groups, tags_by_req)):
            for c, (bid, tag) in enumerate(zip(bids, tags)):
                if self._tags[bid] == tag:
                    ps["prefix_block_hits"] += 1
                    ps["prefix_tokens_reused"] += bt
                    if (self.prefix_engine.has_kv
                            and not self.prefix_engine.kv_ok(bid)
                            and bid not in repair_writers):
                        repair_writers[bid] = (ri, c)
                    ent = rep.kv_leases.get(bid)
                    cached_ok = ent is not None and ent[2] == tag
                    if cached_ok and rep.kv_pts <= ent[1]:
                        ps["prefix_local_hits"] += 1   # unexpired lease
                        local_wts.append(ent[0])
                    else:
                        renew_groups[ri].append(bid)
                        if bid not in renew_req:
                            renew_req[bid] = ent[0] if cached_ok else -1
                else:
                    if self._tags[bid] != -1:
                        if not self._evict_block(bid):
                            ps["prefix_evictions_deferred"] += 1
                            continue
                        ps["prefix_evictions"] += 1    # collision: re-tag
                    ps["prefix_block_misses"] += 1
                    self._tags[bid] = tag
                    miss_writers[bid] = (ri, c)        # last writer wins
        if local_wts:                                  # Table II local hits
            rep.kv_pts = max(rep.kv_pts, max(local_wts))
        active = [g for g in renew_groups if g]
        if active:                                     # ONE lease pass
            res = self.prefix_engine.read_many(active, rep.kv_pts,
                                               req_wts=renew_req)
            rep.kv_pts = int(res.new_pts.max())
            ps["prefix_renewals"] += sum(
                1 for b in res.union_idx if renew_req[int(b)] >= 0)
            for i, bid in enumerate(res.union_idx):
                bid = int(bid)
                rep.kv_leases[bid] = (int(res.wts[i]), int(res.rts[i]),
                                      int(self._tags[bid]))
        if miss_writers:                               # one wave jump-ahead
            ts = self.prefix_engine.write_many([list(miss_writers)],
                                               rep.kv_pts)
            rep.kv_pts = ts
            for bid in miss_writers:
                rep.kv_leases[bid] = (ts, ts, int(self._tags[bid]))
        repair_writers = {b: rc for b, rc in repair_writers.items()
                          if b not in miss_writers}
        return WavePlan(groups, covered, miss_writers, repair_writers)

    def _lease_prefix_wave_dir(self, rep: DecodeReplica,
                               prompts: List[np.ndarray]) -> WavePlan:
        """Directory-mode prefix leasing: the same wave protocol, but the
        (wts, rts) truth for the prefix region lives in the sharded
        directory, so classification runs against the directory's content
        tags and ALL lease traffic -- renewals, miss re-tags and payload
        fetches of remotely-prefilled blocks -- resolves in ONE
        :meth:`ShardedLeaseDirectory.wave` (at most one message per owner
        shard).  A block whose payload another host published serves this
        wave by page migration instead of being recomputed: it counts as
        covered, and `_install_fetched` lands it in the local pool before
        the admission prefill reads it."""
        dirx = self.directory
        eng = self.prefix_engine
        rep.kv_pts += 1
        ps = self.prefix_stats
        bt = self.prefix_block_tokens
        groups, tags_by_req = [], []
        for prompt in prompts:
            bids, tags = self._prefix_blocks_of(prompt)
            groups.append(bids)
            tags_by_req.append(tags)

        local_wts: List[int] = []
        renew_groups: List[List[int]] = [[] for _ in prompts]
        renew_req: Dict[int, int] = {}
        write_bids: List[int] = []
        write_tags: List[int] = []
        fetch_bids: List[int] = []
        miss_writers: Dict[int, Tuple[int, int]] = {}
        repair_writers: Dict[int, Tuple[int, int]] = {}
        pending_tags: Dict[int, int] = {}    # re-tags queued for this wave
        covered: List[int] = []
        for ri, (prompt, bids, tags) in enumerate(
                zip(prompts, groups, tags_by_req)):
            run_ok = True                    # still in the leading run
            c_cov = 0
            for c, (bid, tag) in enumerate(zip(bids, tags)):
                eff_tag = pending_tags.get(bid, int(dirx.tags[bid]))
                if eff_tag == tag:
                    ps["prefix_block_hits"] += 1
                    ps["prefix_tokens_reused"] += bt
                    will_cover = (self._tags[bid] == tag
                                  and eng.kv_ok(bid))
                    if not will_cover:
                        if (run_ok and bid not in pending_tags
                                and dirx.home_ok(bid)):
                            # another host prefilled it: migrate the page
                            if bid not in fetch_bids:
                                fetch_bids.append(bid)
                            will_cover = True
                        elif (bid not in repair_writers
                              and bid not in miss_writers
                              and bid not in fetch_bids):
                            repair_writers[bid] = (ri, c)
                    ent = rep.kv_leases.get(bid)
                    cached_ok = ent is not None and ent[2] == tag
                    if cached_ok and rep.kv_pts <= ent[1]:
                        ps["prefix_local_hits"] += 1
                        local_wts.append(ent[0])
                    else:
                        renew_groups[ri].append(bid)
                        if bid not in renew_req:
                            renew_req[bid] = ent[0] if cached_ok else -1
                    if run_ok and will_cover:
                        c_cov += 1
                    else:
                        run_ok = False
                else:
                    if eff_tag != -1 or self._tags[bid] != -1:
                        if not self._evict_block(bid):
                            ps["prefix_evictions_deferred"] += 1
                            run_ok = False
                            continue
                        ps["prefix_evictions"] += 1
                    ps["prefix_block_misses"] += 1
                    self._tags[bid] = tag
                    pending_tags[bid] = tag
                    write_bids.append(bid)
                    write_tags.append(tag)
                    miss_writers[bid] = (ri, c)
                    run_ok = False
            covered.append(min(c_cov, (len(prompt) - 1) // bt))
        if local_wts:                                  # Table II local hits
            rep.kv_pts = max(rep.kv_pts, max(local_wts))
        active = [g for g in renew_groups if g]
        if active or write_bids or fetch_bids or \
                self.host_id in dirx._pending:
            res = dirx.wave(self.host_id, rep.kv_pts, read_groups=active,
                            req_wts=renew_req or None,
                            write_bids=write_bids, write_tags=write_tags,
                            fetch_bids=fetch_bids)
            rep.kv_pts = int(res.new_pts)
            ps["prefix_renewals"] += sum(
                1 for w in renew_req.values() if w >= 0)
            for bid, (w, r) in res.leases.items():
                rep.kv_leases[bid] = (w, r, int(dirx.tags[bid]))
            for bid in miss_writers:
                ts = res.write_ts.get(bid)
                if ts is not None:
                    rep.kv_leases[bid] = (ts, ts, int(self._tags[bid]))
            self._install_fetched(res, rep)
        repair_writers = {b: rc for b, rc in repair_writers.items()
                          if b not in miss_writers}
        return WavePlan(groups, covered, miss_writers, repair_writers)

    def _install_fetched(self, res, rep: DecodeReplica) -> None:
        """Land migrated pages in the local pool under exactly the carried
        ``(wts, rts, version)``: the lease the wave's read extended becomes
        the local cached lease, the content tag carries over, and the slot
        joins the host's payload cache (evicting-relocating any pinned
        different-content local copy first).  The page moves device to
        device (a K3 scatter into this host's pool on the card)."""
        eng = self.prefix_engine
        dirx = self.directory
        wver = rep.reader.cached_version("params")
        for bid, page in res.fetched.items():
            if self._tags[bid] not in (-1, page.tag):
                if not self._evict_block(bid):
                    continue     # pinned + no free page: skip the install
            eng.write_kv([bid], page_on(page.blocks, eng.device))
            self._tags[bid] = page.tag
            self._pool_wver[bid] = -1 if wver is None else int(wver)
            rep.kv_leases[bid] = (page.wts, page.rts, page.tag)
            if self.policy.predictor:
                # Tardis 2.0: the owner's learned lease travels with the page
                eng.set_pred_lease([bid], page.pred_lease)
            self._migrated.add(bid)
            self.prefix_stats["xhost_pages_fetched"] += 1
            if dirx._msan is not None:
                dirx._msan.mark_installed(self.host_id, bid, page.tag)

    def _maybe_rebase(self) -> None:
        if self.directory is not None:
            return        # the multi-host coordinator drives rebases
        shift = self.prefix_engine.maybe_rebase()
        if shift:
            for rep in self.replicas:
                rep.rebase_kv(shift)

    # -- paged-KV pool <-> per-stack cache layout ---------------------------

    def _read_kv_stacks(self, bids) -> Dict[str, Any]:
        out = self.prefix_engine.read_kv(bids)
        if not isinstance(out, dict):
            out = {self._stacks[0].pool: out}
        return out

    def _pool_to_stack_kv(self, pooled: Dict[str, Any]) -> Dict[str, Tuple]:
        """{pool: (nb, chunk, 2, L*hk, dh)} -> {pool: (k, v)}, each
        (L, nb*chunk, hk, dh)."""
        bt = self.prefix_block_tokens
        hk, dh = self.cfg.n_kv_heads, self.cfg.head_dim()
        out = {}
        for s in self._stacks:
            nb = pooled[s.pool].shape[0]
            kv = pooled[s.pool].reshape(nb, bt, 2, s.n_layers, hk, dh)
            kv = kv.permute(2, 3, 0, 1, 4, 5).reshape(
                2, s.n_layers, nb * bt, hk, dh)
            out[s.pool] = (kv[0], kv[1])
        return out

    def _cache_block_kv(self, cache, ri: int, chunk: int) -> Dict[str, Any]:
        """One request's prefix chunk out of a prefill cache, per stack in
        the pool's (chunk, 2, L*hk, dh) block layout."""
        bt = self.prefix_block_tokens
        lo = chunk * bt
        hk, dh = self.cfg.n_kv_heads, self.cfg.head_dim()
        out = {}
        for s in self._stacks:
            kv = torch.stack([cache[s.cache_keys[0]][:, ri, lo:lo + bt],
                              cache[s.cache_keys[1]][:, ri, lo:lo + bt]])
            out[s.pool] = kv.permute(2, 0, 1, 3, 4).reshape(
                bt, 2, s.n_layers * hk, dh)
        return out

    def _cache_token_rows(self, cache, lo: int, hi: int) -> torch.Tensor:
        """Positions [lo, hi) of a B=1 prefill cache as (hi-lo,
        kv_token_row) FULL pool token rows (each stack's layers' K then V
        at its pool offset, zeros in the lane padding)."""
        m = hi - lo
        rows = torch.zeros((m, self.prefix_engine.kv_token_row),
                           dtype=self.prefix_engine.kv_dtype,
                           device=self.device)
        for s in self._stacks:
            k = cache[s.cache_keys[0]][:, 0, lo:hi]
            v = cache[s.cache_keys[1]][:, 0, lo:hi]
            kr = k.permute(1, 0, 2, 3).reshape(m, -1)
            vr = v.permute(1, 0, 2, 3).reshape(m, -1)
            rows[:, s.offset:s.offset + s.token_elems] = torch.cat(
                [kr, vr], dim=1).to(rows.dtype)
        return rows

    # -- continuous-batching paged scheduler --------------------------------

    def _pages_needed(self, req: Request, covered: int = 0) -> int:
        bt = self.prefix_block_tokens
        total = -(-(len(req.prompt) + req.max_new) // bt)
        return total - covered

    def _admit(self, r: int, rep: DecodeReplica, queue: deque,
               act: List[Stream], tick: int) -> None:
        """Admit queued requests while a batch slot and enough free pool
        pages exist (worst case: no prefix coverage); one lease interaction
        covers the whole joiner group."""
        eng = self.prefix_engine
        joiners: List[Request] = []
        budget = eng.free_page_count()
        while queue and len(act) + len(joiners) < rep.max_batch:
            req = queue[0]
            need = self._pages_needed(req)
            if need > self.max_pages:
                raise ValueError(
                    f"request {req.rid} needs {need} pages > max_pages="
                    f"{self.max_pages}")
            if need > budget:
                if not act and not joiners and need > self.n_decode_pages:
                    raise RuntimeError(
                        f"request {req.rid} needs {need} pages; pool has "
                        f"{self.n_decode_pages}")
                self.prefix_stats["paged_admission_deferrals"] += 1
                break                       # head-of-line: wait for pages
            budget -= need
            joiners.append(queue.popleft())
        if not joiners:
            return
        if act:
            self.prefix_stats["paged_mid_batch_admissions"] += len(joiners)
        self._admit_reserved = sum(self._pages_needed(j) for j in joiners)
        # weight lease first: reuse only KV computed under the SAME weight
        # version this admission's prefill will use
        params = rep.params()
        wver = rep.reader.cached_version("params")
        plan = self._lease_prefix_wave(rep, [j.prompt for j in joiners])
        mat_cache: Dict[Tuple[int, ...], Tuple] = {}
        for ji, req in enumerate(joiners):
            self._admit_reserved -= self._pages_needed(req)
            s = self._admit_one(rep, req, plan, ji, params, wver, mat_cache,
                                tick)
            if s is not None:
                act.append(s)
        self._admit_reserved = 0

    def _admit_one(self, rep: DecodeReplica, req: Request, plan: WavePlan,
                   ji: int, params, wver, mat_cache: Dict,
                   tick: int) -> Optional[Stream]:
        eng = self.prefix_engine
        ps = self.prefix_stats
        bt = self.prefix_block_tokens
        bids = plan.groups[ji]
        plen = len(req.prompt)
        # re-check coverage against wver and current validity
        n_ok = 0
        for bid in bids[:plan.covered[ji]]:
            if self._pool_wver[bid] != wver or not eng.kv_ok(bid):
                break
            n_ok += 1
        stale = [b for b in bids[n_ok:plan.covered[ji]]
                 if self._pool_wver[b] != wver and eng.kv_ok(b)]
        if stale:
            # cross-version KV never mixes into one forward pass
            eng.invalidate_kv(stale)
            for b in stale:
                plan.repair_writers.setdefault(b, (ji, bids.index(b)))
        covered, skip = n_ok, n_ok * bt
        if bids:
            if skip:
                ps["role_suffix_admissions"] += 1
            else:
                ps["role_cold_prefills"] += 1
        cache_len = max(bt, -(-plen // bt) * bt)
        suffix = req.prompt[skip:]
        toks = torch.as_tensor(
            np.pad(suffix, (0, cache_len - skip - len(suffix)))[None],
            device=self.device)
        last = len(suffix) - 1
        if skip:
            key = tuple(bids[:covered])
            if self.directory is not None and self.directory._msan is not None:
                for bid in key:
                    if bid in self._migrated:   # serving a migrated page:
                        self.directory._msan.on_use(     # tag must still
                            self.host_id, bid,           # be current
                            int(self.directory.tags[bid]))
            if key not in mat_cache:
                mat_cache[key] = self._pool_to_stack_kv(
                    self._read_kv_stacks(list(key)))
            cache, logits = prefill_suffix(
                self.cfg, params, {"tokens": toks},
                _prefix_cache(self._stacks, mat_cache[key], 1, cache_len,
                              skip),
                skip, last_idx=last)
            ps["prefix_prefill_tokens_skipped"] += skip
            ps["prefix_flops_saved"] += skip * self._flops_per_token
        else:
            cache, logits = prefill(self.cfg, params, {"tokens": toks},
                                    cache_len, last_idx=last)
        # payload write-back: the blocks this request owns per the plan
        wb = [(bid, c) for bid, (ri, c) in plan.miss_writers.items()
              if ri == ji]
        wb += [(bid, c) for bid, (ri, c) in plan.repair_writers.items()
               if ri == ji and bid not in plan.miss_writers]
        if wb:
            per_block = [self._cache_block_kv(cache, 0, c) for _, c in wb]
            blocks = {s.pool: torch.stack([d[s.pool] for d in per_block])
                      for s in self._stacks}
            eng.write_kv([bid for bid, _ in wb], blocks)
            self._pool_wver[[bid for bid, _ in wb]] = \
                -1 if wver is None else int(wver)
            if self.directory is not None:
                # write-behind home publish: the payload rides the NEXT
                # wave's request message to the owner shard; a stale
                # publish (re-tagged first) is dropped owner-side.  Each
                # payload is a slice of ``blocks``, a fresh stack that no
                # later prefill writes into, so it needs no copy
                for i_wb, (bid, _c) in enumerate(wb):
                    if self.directory.tags[bid] != self._tags[bid]:
                        continue
                    self.directory.defer_publish(
                        self.host_id, bid,
                        {p: a[i_wb:i_wb + 1] for p, a in blocks.items()})
                    ps["xhost_pages_published"] += 1
                    ps["role_pages_published"] += 1
        # page table: covered shared blocks (pinned + leased for the whole
        # decode) then private pages for suffix + decode KV
        total_pages = -(-(plen + req.max_new) // bt)
        own = [int(b) for b in eng.alloc_pages(total_pages - covered)]
        page_row = np.zeros(self.max_pages, np.int32)
        page_row[:covered] = bids[:covered]
        page_row[covered:total_pages] = own
        for bid in bids[:covered]:
            self._pins[bid] = self._pins.get(bid, 0) + 1
        if own:
            self._pool_wver[own] = -1 if wver is None else int(wver)
        # the prompt's suffix KV lands in the own pages, token-granular
        rows = self._cache_token_rows(cache, skip, plen)
        pos = np.arange(skip, plen)
        flat_idx = (page_row[pos // bt].astype(np.int64) * bt + pos % bt)
        eng.append_kv(flat_idx, rows)
        t0 = int(torch.argmax(logits[0, -1]))      # first index on a tie
        stream = Stream(req=req, page_row=page_row, own_pages=own,
                        shared_bids=list(bids[:covered]), reloc_pages=[],
                        length=plen, emitted=[t0])
        in_use = self.n_decode_pages - eng.free_page_count()
        ps["pool_page_peak"] = max(ps["pool_page_peak"], in_use)
        if self.trace is not None:
            self.trace.append({
                "ev": "admit", "tick": tick, "rep": rep.name,
                "rid": req.rid, "prompt_len": plen, "skip": skip,
                "page_row": page_row.copy(), "pages": total_pages,
                "logits": logits.float().cpu().numpy().copy(),
                "rows": eng.kv_rows_view().cpu().clone()})
        if stream.finished:
            self._finalize(stream)
            return None
        return stream

    def prefill_only_tick(self, queue: deque, tick: int) -> List[Request]:
        """One prefill-pod tick: admit up to ``max_batch`` forwarded jobs
        per replica, run the full prefill over each prompt's block-aligned
        head, and queue the prefix pages write-behind (the coordinator
        flushes after the tick, which fires the publish-then-notify wave a
        waiting decode pod subscribed to).  Nothing decodes here: each job
        admits as a zero-token SHADOW request over the aligned head, so its
        pages allocate, publish and free inside the tick, and the caller's
        Request objects are never touched.  Returns the jobs completed this
        tick (including pass-throughs too short to have an aligned head).
        """
        ps = self.prefix_stats
        bt = self.prefix_block_tokens
        done: List[Request] = []
        for r, rep in enumerate(self.replicas):
            jobs: List[Request] = []
            shadows: List[Request] = []
            budget = self.prefix_engine.free_page_count()
            while queue and len(jobs) < rep.max_batch:
                req = queue[0]
                cut = (len(req.prompt) // bt) * bt
                if cut == 0:
                    # no block-aligned head to publish: hand it straight back
                    done.append(queue.popleft())
                    continue
                shadow = Request(req.rid, req.prompt[:cut], max_new=0)
                need = self._pages_needed(shadow)
                if need > self.max_pages:
                    raise ValueError(
                        f"prefill job {req.rid} needs {need} pages > "
                        f"max_pages={self.max_pages}")
                if need > budget:
                    if not jobs and need > self.n_decode_pages:
                        raise RuntimeError(
                            f"prefill job {req.rid} needs {need} pages; "
                            f"pool has {self.n_decode_pages}")
                    ps["paged_admission_deferrals"] += 1
                    break
                budget -= need
                jobs.append(queue.popleft())
                shadows.append(shadow)
            if not shadows:
                continue
            self._admit_reserved = sum(self._pages_needed(s)
                                       for s in shadows)
            params = rep.params()
            wver = rep.reader.cached_version("params")
            plan = self._lease_prefix_wave(rep, [s.prompt for s in shadows])
            mat_cache: Dict[Tuple[int, ...], Tuple] = {}
            for ji, shadow in enumerate(shadows):
                self._admit_reserved -= self._pages_needed(shadow)
                s = self._admit_one(rep, shadow, plan, ji, params, wver,
                                    mat_cache, tick)
                assert s is None, "max_new=0 shadow must finalize inline"
            self._admit_reserved = 0
            ps["role_prefill_jobs"] += len(jobs)
            done.extend(jobs)
        return done

    def _finalize(self, s: Stream) -> None:
        """A finished request releases everything immediately: pins drop,
        relocated copies refcount down, private pages go back on the free
        list -- zero coherence messages."""
        eng = self.prefix_engine
        for bid in s.shared_bids:
            n = self._pins.get(bid, 0) - 1
            if n > 0:
                self._pins[bid] = n
            else:
                self._pins.pop(bid, None)
        for pg in s.reloc_pages:
            n = self._reloc_refs.get(pg, 0) - 1
            if n > 0:
                self._reloc_refs[pg] = n
            else:
                self._reloc_refs.pop(pg, None)
                eng.free_pages([pg])
        if s.own_pages:
            eng.free_pages(s.own_pages)
        s.req.output = np.asarray(s.emitted[:s.req.max_new], np.int32)
        s.req.done = True

    def _renew_decode_leases(self, rep: DecodeReplica,
                             act: List[Stream]) -> None:
        """Decode-time re-reads of shared prefix blocks: unexpired leases
        are local hits; expired ones renew (data-less) in ONE batched
        ``read_many``; TSO/RC skip the renewal of a tag-checked read-only
        block."""
        if self.directory is not None:
            return self._renew_decode_leases_dir(rep, act)
        expired: Dict[int, int] = {}
        for s in act:
            for bid in s.shared_bids:
                ent = rep.kv_leases.get(bid)
                if ent is None or ent[2] != self._tags[bid]:
                    continue          # relocated/re-tagged: private copy
                if rep.kv_pts <= ent[1]:
                    self.prefix_stats["prefix_local_hits"] += 1
                    self.prefix_stats["decode_local_hits"] += 1
                    rep.kv_pts = max(rep.kv_pts, ent[0])   # Table I load
                elif self.policy.skip_expired_renewal():
                    self.prefix_stats["decode_renewals_skipped"] += 1
                elif bid not in expired:
                    expired[bid] = ent[0]
        if not expired:
            return
        res = self.prefix_engine.read_many([list(expired)], rep.kv_pts,
                                           req_wts=expired)
        rep.kv_pts = int(res.new_pts.max())
        for i, bid in enumerate(res.union_idx):
            bid = int(bid)
            rep.kv_leases[bid] = (int(res.wts[i]), int(res.rts[i]),
                                  int(self._tags[bid]))
        self.prefix_stats["decode_renewals"] += len(expired)

    def _renew_decode_leases_dir(self, rep: DecodeReplica,
                                 act: List[Stream]) -> None:
        """Directory-mode decode renewals: one
        :meth:`ShardedLeaseDirectory.wave` for every expired lease (<=1
        message per owner shard, data-less when the cached version
        matches).  A renewal that comes back with a NEWER version means
        another host re-tagged the block underneath this decode: the local
        copy keeps serving its bits as a frozen private copy, so the cached
        lease is dropped rather than refreshed."""
        dirx = self.directory
        ps = self.prefix_stats
        expired: Dict[int, int] = {}
        for s in act:
            for bid in s.shared_bids:
                ent = rep.kv_leases.get(bid)
                if ent is None or ent[2] != int(dirx.tags[bid]):
                    continue          # re-tagged/migrated: private copy
                if rep.kv_pts <= ent[1]:
                    ps["prefix_local_hits"] += 1
                    ps["decode_local_hits"] += 1
                    rep.kv_pts = max(rep.kv_pts, ent[0])   # Table I load
                elif self.policy.skip_expired_renewal():
                    ps["decode_renewals_skipped"] += 1
                elif bid not in expired:
                    expired[bid] = ent[0]
        if not expired:
            return
        res = dirx.wave(self.host_id, rep.kv_pts,
                        read_groups=[list(expired)], req_wts=expired)
        rep.kv_pts = int(res.new_pts)
        ps["role_renewal_msgs"] += res.msgs
        for bid, (w, r) in res.leases.items():
            if w == expired.get(bid, w):
                rep.kv_leases[bid] = (w, r, int(dirx.tags[bid]))
            else:
                rep.kv_leases.pop(bid, None)   # superseded: private copy
        ps["decode_renewals"] += len(expired)

    def _decode_tick(self, rep: DecodeReplica, act: List[Stream],
                     tick: int) -> None:
        """One continuous-batch decode step: every active stream advances a
        token, all KV traffic through pool pages."""
        eng = self.prefix_engine
        rep.kv_pts += 1                   # the tick is one logical step
        self.prefix_stats["decode_ticks"] += 1
        self._renew_decode_leases(rep, act)
        bt = self.prefix_block_tokens
        page_rows = np.stack([s.page_row for s in act])
        lengths = np.asarray([s.length for s in act], np.int32)
        tokens = np.asarray([[s.emitted[-1]] for s in act], np.int32)
        params = rep.params()             # weight lease check per tick
        dev = self.device
        pool, logits = decode_step_paged(
            self.cfg, params, eng.kv_rows_view(),
            torch.as_tensor(page_rows, device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(tokens, device=dev),
            chunk=self.prefix_block_tokens)
        eng.set_kv_rows(pool, tokens_appended=len(act))
        self.prefix_stats["decode_block_reads"] += int(
            sum(-(-(int(n) + 1) // bt) for n in lengths))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        if self.trace is not None:
            self.trace.append({
                "ev": "tick", "tick": tick, "rep": rep.name,
                "rids": [s.req.rid for s in act],
                "lengths": lengths.copy(), "tokens": tokens.copy(),
                "logits": logits.float().cpu().numpy().copy()})
        done = []
        for s, t in zip(act, nxt):
            s.length += 1
            s.emitted.append(int(t))
            if s.finished:
                done.append(s)
        for s in done:
            self._finalize(s)
            act.remove(s)

    def _mk_queues(self, requests: List[Request]) -> List[deque]:
        """Arrival-order groups of ``n_replicas`` requests affined to
        replicas round-robin."""
        nr = len(self.replicas)
        queues: List[deque] = [deque() for _ in range(nr)]
        for k in range(0, len(requests), nr):
            queues[(k // nr) % nr].extend(requests[k:k + nr])
        return queues

    def _busy(self, queues: List[deque]) -> bool:
        return any(queues) or any(self._active)

    def _paged_tick(self, queues: List[deque], tick: int) -> None:
        """One scheduler tick: admissions then decode steps on every
        replica, then the rebase guard.  The multi-host coordinator calls
        this per host to run K clusters in lockstep."""
        for r, rep in enumerate(self.replicas):
            self._admit(r, rep, queues[r], self._active[r], tick)
        for r, rep in enumerate(self.replicas):
            if self._active[r]:
                self._decode_tick(rep, self._active[r], tick)
        self._maybe_rebase()

    def _run_paged(self, requests: List[Request]) -> None:
        queues = self._mk_queues(requests)
        tick = 0
        while self._busy(queues):
            self._paged_tick(queues, tick)
            tick += 1

    # -- fixed-wave dense-cache path ----------------------------------------

    def _serve_wave(self, rep: DecodeReplica, wave: List[Request],
                    plan: Optional[WavePlan]) -> None:
        """One wave on the dense-cache path: the lease protocol already ran
        for it (prefix metadata sharing); decode stays on the wave's own
        dense caches."""
        del plan
        rep.trace = self.trace
        rep.serve(wave, params=rep.params())

    def run(self, requests: List[Request]) -> Tuple[List[Request], Dict]:
        if self.paged:
            self._run_paged(requests)
            return requests, self.coherence_report()
        waves: List[List[Request]] = []
        for i, r in enumerate(requests):
            if i % len(self.replicas) == 0:
                waves.append([])
            waves[-1].append(r)
        for i, wave in enumerate(waves):
            rep = self.replicas[i % len(self.replicas)]
            plan = None
            if self.prefix_reuse:
                plan = self._lease_prefix_wave(rep, [r.prompt for r in wave])
                self._maybe_rebase()
            self._serve_wave(rep, wave, plan)
        return requests, self.coherence_report()

    def coherence_report(self) -> Dict[str, Any]:
        s = self.store.stats
        e = self.prefix_engine.stats
        saved = s.renew_data_less * self.param_bytes
        kv_saved = e.data_less * self.prefix_engine.block_bytes
        local_saved = (self.prefix_stats["prefix_local_hits"]
                       * self.prefix_engine.block_bytes)
        return CoherenceReport({
            "reads": s.reads, "writes": s.writes,
            "renewals": s.renews + e.renewals,
            "data_less_renewals": s.renew_data_less + e.data_less,
            "payload_transfers": s.payload_transfers + e.payload_transfers,
            "bytes_transferred": s.bytes_transferred + e.payload_bytes,
            "bytes_saved_by_renewals": saved + kv_saved,
            "bytes_saved_by_local_hits": local_saved,
            "wire_flits": s.flits + e.flits,
            "wire_bytes": s.wire_bytes + e.wire_bytes,
            "directory_would_invalidate": s.dir_invalidations,
            "directory_peak_sharers": s.dir_sharer_bits,
            "sanitize_checks": self.prefix_engine.sanitize_checks,
            "replica_local_hits": sum(r.reader.local_hits
                                      for r in self.replicas),
            **self.prefix_stats,
            "prefix_data_less_renewals": e.data_less,
            "prefix_payload_transfers": e.payload_transfers,
            "prefix_blocks_written": e.writes,
            "prefix_rebases": e.rebases,
            "prefix_read_dispatches": e.read_ops,
            "prefix_write_dispatches": e.write_ops,
            "prefix_kv_blocks_written": e.kv_blocks_written,
            "prefix_kv_blocks_read": e.kv_blocks_read,
            "prefix_kv_evictions": e.kv_evictions,
            "pred_grows": e.pred_grows,
            "pred_shrinks": e.pred_shrinks,
            "kv_tokens_appended": e.kv_tokens_appended,
            "pool_pages_allocated": e.pages_allocated,
            "pool_pages_freed": e.pages_freed,
            "pool_pages_free": self.prefix_engine.free_page_count(),
            **{f"pool_tokens_appended_{s.pool}":
               e.kv_pool_tokens.get(s.pool, 0) for s in self._stacks},
            **({"kv_pool_stacks": ",".join(s.pool for s in self._stacks)}
               if self._stacks else {}),
            "ts_bits": self.prefix_engine.ts_bits,
            "kv_lease": self.prefix_engine.lease,
            "consistency": self.policy.consistency,
            "n_prefix_blocks": self.n_prefix_blocks,
            "role": self.role,
        })


class MultiHostServingCluster:
    """K serving hosts sharing ONE sharded lease directory.

    Each host is a full :class:`ServingCluster` (replicas, local payload
    cache, decode pages, its own weight store -- weight publishes sweep
    every host, so version sequences align); the
    :class:`~repro_torch.core.shard_directory.ShardedLeaseDirectory` owns
    the prefix region's ``(wts, rts)`` tables and home KV pages, hashed
    across owner shards.  A prefix prefilled on host 0 is published
    write-behind to its home shards and served on host K-1 by
    timestamp-ordered page migration -- suffix-only prefill, no
    recomputation -- with each wave's cross-host lease traffic batched
    into at most one message per owner shard and ZERO invalidations or
    multicasts.  Hosts tick in lockstep and the coordinator drives one
    uniform timestamp rebase across every shard and replica.

    Every host and every shard sits on ``device`` (default: the card;
    ``device="cpu"`` runs the plain versions).  ``dir_backend`` defaults
    to ``"device"``, which keeps the directory's tables and home pages on
    that device and runs its shards' lease passes, writes and page moves
    in K1-K3; ``"numpy"`` is the host mirror.  (The reference's default
    is ``"numpy"``; both are bit-identical by its own tests.)
    """

    ROLES = ("prefill", "decode", "mixed")

    def __init__(self, cfg, init_params_fn: Callable[[], Any],
                 n_hosts: int = 2, n_shards: Optional[int] = None,
                 dir_backend: str = "device",
                 sanitize: Optional[bool] = None,
                 roles: Optional[List[str]] = None,
                 spill_depth: int = 4, device: DeviceLike = None, **kw):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if roles is None:
            roles = ["mixed"] * n_hosts
        roles = [str(r) for r in roles]
        if len(roles) != n_hosts:
            raise ValueError(
                f"roles has {len(roles)} entries for {n_hosts} hosts")
        bad = sorted(set(roles) - set(self.ROLES))
        if bad:
            raise ValueError(
                f"unknown roles {bad}; each must be one of {self.ROLES}")
        if "decode" in roles and not any(
                r in ("prefill", "mixed") for r in roles):
            raise ValueError(
                "decode pods need at least one prefill or mixed host to "
                "forward cold prefixes to")
        if "prefill" in roles and not any(
                r in ("decode", "mixed") for r in roles):
            raise ValueError(
                "prefill pods need at least one decode or mixed host to "
                "hand streams back to")
        self.device = pick_device(device)
        self.roles = roles
        self.spill_depth = int(spill_depth)
        # how many routed ticks a forwarded stream may wait on its
        # publish-then-notify wake before the decode pod force-admits it
        # (a dropped publish then surfaces as a ledgered cold prefill
        # instead of a hang)
        self.handoff_patience = 16
        self.hosts = [ServingCluster(cfg, init_params_fn,
                                     sanitize=sanitize, device=self.device,
                                     **kw)
                      for _ in range(n_hosts)]
        for host, role in zip(self.hosts, roles):
            host.role = role
        # cold-prefix work chain-hashes onto pure prefill pods; a fleet
        # with no pure prefill pod prefills on the mixed hosts
        self._prefill_pool = ([h for h, r in enumerate(roles)
                               if r == "prefill"]
                              or [h for h, r in enumerate(roles)
                                  if r == "mixed"])
        self._route_stats = {
            "router_warm_direct": 0, "router_cold_forwards": 0,
            "router_spills": 0, "router_handoffs": 0,
            "router_forced_admissions": 0,
        }
        h0 = self.hosts[0]
        if not h0.paged:
            raise ValueError(
                "multi-host serving requires a paged family (dense/vlm/moe)")
        eng = h0.prefix_engine
        self.directory = ShardedLeaseDirectory(
            h0.n_prefix_blocks, int(n_shards or n_hosts), n_hosts=n_hosts,
            policy=h0.policy, backend=dir_backend,
            block_bytes=eng.block_bytes, kv_pools=eng.kv_pools,
            kv_dtype=eng.kv_dtype, sanitize=sanitize, device=self.device)
        for h, host in enumerate(self.hosts):
            host.attach_directory(self.directory, h)

    def publish_weights(self, params) -> int:
        """Hot-swap on every host + the directory's home-payload barrier:
        still zero invalidation MESSAGES anywhere.  Returns the max publish
        timestamp across hosts and asserts the fleet agrees on the
        post-publish weight version."""
        pts = 0
        for host in self.hosts:
            pts = max(pts, host.publish_weights(params))
        self.directory.publish_barrier()
        vers = {host.store.versions().get("params")
                for host in self.hosts}
        if len(vers) != 1:
            raise RuntimeError(
                f"hosts disagree on post-publish weight version: "
                f"{sorted(vers)}")
        return pts

    def _maybe_rebase_all(self) -> None:
        """One uniform shift across every directory shard and every
        host's replicas: cross-shard timestamp order is protocol state."""
        shift = self.directory.maybe_rebase()
        if shift:
            for host in self.hosts:
                for rep in host.replicas:
                    rep.rebase_kv(shift)

    def run(self, requests: List[Request],
            affinity: Optional[List[int]] = None
            ) -> Tuple[List[Request], Dict]:
        """Serve ``requests`` across the hosts.  ``affinity[i]`` pins
        request i to a (decode-capable) host -- default round-robin over
        the decode/mixed hosts.  A symmetric fleet (all mixed) runs every
        host's scheduler directly; a fleet with prefill/decode roles
        routes each request through the admission router first (see
        :meth:`_run_routed`)."""
        serve_pool = [h for h, r in enumerate(self.roles)
                      if r != "prefill"]
        if affinity is None:
            affinity = [serve_pool[i % len(serve_pool)]
                        for i in range(len(requests))]
        if len(affinity) != len(requests):
            raise ValueError(
                f"affinity has {len(affinity)} entries for "
                f"{len(requests)} requests")
        for i, a in enumerate(affinity):
            a = int(a)
            if not 0 <= a < len(self.hosts):
                raise ValueError(
                    f"affinity[{i}] = {a} is out of range for "
                    f"{len(self.hosts)} hosts (negative ids do not wrap)")
            if self.hosts[a].role == "prefill":
                raise ValueError(
                    f"affinity[{i}] = {a} pins a stream to a prefill-only "
                    f"pod; pin it to a decode or mixed host")
        affinity = [int(a) for a in affinity]
        if all(r == "mixed" for r in self.roles):
            self._run_symmetric(requests, affinity)
        else:
            self._run_routed(requests, affinity)
        return requests, self.coherence_report()

    def _run_symmetric(self, requests: List[Request],
                       affinity: List[int]) -> None:
        per_host: List[List[Request]] = [[] for _ in self.hosts]
        for req, a in zip(requests, affinity):
            per_host[a].append(req)
        queues = [h._mk_queues(reqs)
                  for h, reqs in zip(self.hosts, per_host)]
        tick = 0
        while any(h._busy(q) for h, q in zip(self.hosts, queues)):
            for h, host in enumerate(self.hosts):
                host._paged_tick(queues[h], tick)
            self._maybe_rebase_all()
            tick += 1
        self.directory.flush_deferred()    # drain write-behind payloads

    # -- disaggregated prefill/decode routing -------------------------------

    def _enqueue(self, queues: List[List[deque]], arrivals: List[int],
                 h: int, req: Request) -> None:
        """Hand a stream to host ``h``'s scheduler, replica-affined in the
        same round-robin-by-group layout ``_mk_queues`` produces."""
        nr = len(self.hosts[h].replicas)
        queues[h][(arrivals[h] // nr) % nr].append(req)
        arrivals[h] += 1

    def _route(self, requests: List[Request], affinity: List[int],
               queues: List[List[deque]], arrivals: List[int],
               pq: List[deque], waiting: List[List]) -> None:
        """The admission router.  A request whose LEADING prefix block is
        warm (directory tag matches and the page is home, or the decode
        host already caches that content) goes straight to its decode
        host.  A cold leading block means full-prefix prefill: the stream
        is forwarded to the prefill pod its chain hash names (spilling to
        a less-loaded pod past ``spill_depth``), the decode host
        subscribes to the prefix gids, and the stream parks in
        ``waiting`` until the publish-then-notify wake hands it back."""
        dirx = self.directory
        rs = self._route_stats
        pool = self._prefill_pool
        for req, d in zip(requests, affinity):
            host = self.hosts[d]
            bids, tags = host._prefix_blocks_of(req.prompt)
            warm = not bids or (
                int(dirx.tags[bids[0]]) == tags[0]
                and (dirx.home_ok(bids[0])
                     or (host._tags[bids[0]] == tags[0]
                         and host.prefix_engine.kv_ok(bids[0]))))
            if warm:
                rs["router_warm_direct"] += 1
                self._enqueue(queues, arrivals, d, req)
                continue
            landed = dirx.subscribe(d, bids, tags)
            pending = {int(b) for b in bids} - {int(b) for b in landed}
            if not pending:
                # raced warm: everything is already home
                rs["router_warm_direct"] += 1
                self._enqueue(queues, arrivals, d, req)
                continue
            p = pool[tags[0] % len(pool)]
            if len(pq[p]) >= self.spill_depth:
                for off in range(1, len(pool)):
                    q = pool[(tags[0] % len(pool) + off) % len(pool)]
                    if len(pq[q]) < len(pq[p]):
                        p = q
                        rs["router_spills"] += 1
                        break
            rs["router_cold_forwards"] += 1
            pq[p].append(req)
            waiting.append([req, d, pending, 0])

    def _run_routed(self, requests: List[Request],
                    affinity: List[int]) -> None:
        """The disaggregated serving loop: prefill pods burn down their
        forwarded cold-prefix queues and flush write-behind publishes
        (firing the notify waves), woken streams hand off to their decode
        hosts, and the decode/mixed hosts run the ordinary paged
        scheduler -- all in lockstep ticks on the one directory."""
        queues = [h._mk_queues([]) for h in self.hosts]
        arrivals = [0] * len(self.hosts)
        pq: List[deque] = [deque() for _ in self.hosts]
        waiting: List[List] = []      # [req, decode_host, pending_gids, age]
        self._route(requests, affinity, queues, arrivals, pq, waiting)
        rs = self._route_stats
        tick = 0
        while (waiting or any(pq)
               or any(h._busy(q) for h, q in zip(self.hosts, queues))):
            for p in self._prefill_pool:
                if pq[p]:
                    self.hosts[p].prefill_only_tick(pq[p], tick)
                    # flush NOW so this tick's notify waves fire and the
                    # decode pods can admit next tick
                    self.directory.flush_deferred(p)
            for d in {w[1] for w in waiting}:
                got = set(self.directory.pop_notifications(d))
                if got:
                    for w in waiting:
                        if w[1] == d:
                            w[2] -= got
            for w in list(waiting):
                req, d, pending, age = w
                if pending and age < self.handoff_patience:
                    w[3] += 1
                    continue
                if pending:
                    # a publish was dropped (collision re-tag, version
                    # race): force the admission rather than hang; any
                    # cold prefill it causes lands in the decode pod's
                    # role ledger
                    rs["router_forced_admissions"] += 1
                else:
                    rs["router_handoffs"] += 1
                waiting.remove(w)
                self._enqueue(queues, arrivals, d, req)
            for h, host in enumerate(self.hosts):
                if host.role != "prefill":
                    host._paged_tick(queues[h], tick)
            self._maybe_rebase_all()
            tick += 1
        self.directory.flush_deferred()    # drain write-behind payloads

    # config-like report keys: identical on every host by construction,
    # so the aggregate reports them ONCE (and asserts the fleet agrees)
    _CONFIG_KEYS = ("ts_bits", "kv_lease", "consistency",
                    "n_prefix_blocks", "kv_pool_stacks")
    # high-water marks: the fleet-wide value is the max, not the sum
    _MAX_KEYS = ("pool_page_peak", "directory_peak_sharers")
    # per-host breakout columns (host{h}_*)
    _PER_HOST_KEYS = ("prefix_prefill_tokens_skipped", "prefix_flops_saved",
                      "prefix_block_hits", "xhost_pages_fetched",
                      "xhost_pages_published", "role_cold_prefills",
                      "role_suffix_admissions", "role_pages_published",
                      "role_prefill_jobs", "role_renewal_msgs",
                      "decode_renewals", "decode_ticks")

    def coherence_report(self) -> Dict[str, Any]:
        """Per-host traffic counters summed, config scalars reported once,
        high-water marks maxed, per-role/per-host counters broken out, and
        the directory's cross-host ledger merged in."""
        agg: Dict[str, Any] = {}
        reports = [host.coherence_report() for host in self.hosts]
        for k in self._CONFIG_KEYS:
            vals = {rep[k] for rep in reports if k in rep}
            if len(vals) > 1:
                raise RuntimeError(
                    f"hosts disagree on config scalar {k!r}: {sorted(vals)}")
            if vals:
                agg[k] = vals.pop()
        for h, rep in enumerate(reports):
            for k, v in rep.items():
                if k in self._CONFIG_KEYS or k == "role":
                    continue
                if k in self._MAX_KEYS:
                    agg[k] = max(agg.get(k, 0), int(v))
                elif isinstance(v, (int, np.integer)) \
                        and not isinstance(v, bool):
                    agg[k] = agg.get(k, 0) + int(v)
                elif k not in agg:
                    agg[k] = v
            agg[f"host{h}_role"] = rep["role"]
            for k in self._PER_HOST_KEYS:
                agg[f"host{h}_{k}"] = rep[k]
        agg["roles"] = ",".join(rep["role"] for rep in reports)
        agg["n_hosts"] = len(self.hosts)
        agg.update(self._route_stats)
        agg.update(self.directory.report())
        return CoherenceReport(agg)
