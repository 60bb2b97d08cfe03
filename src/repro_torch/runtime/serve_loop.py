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

Not ported yet (each raises ``NotImplementedError``): the sharded-directory
multi-host path (``attach_directory``, ``MultiHostServingCluster``) and the
prefill-pod ``prefill_only_tick``.
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
        self.role = "mixed"
        self.paged = self.prefix_engine.has_kv

    def attach_directory(self, directory, host_id: int) -> None:
        raise NotImplementedError(
            "multi-host serving (sharded lease directory) is not ported yet")

    def prefill_only_tick(self, queue: deque, tick: int) -> List[Request]:
        raise NotImplementedError(
            "prefill-pod ticks (disaggregated serving) are not ported yet")

    def publish_weights(self, params) -> int:
        """Hot-swap: no invalidation broadcast; replicas renew on expiry.
        Pool payloads computed under the old weights are freed locally
        (a bitmap clear, zero messages); later admissions repair them."""
        self.publisher.write("params", _to_device(params, self.device),
                             nbytes=self.param_bytes)
        if self.prefix_engine.has_kv:
            self.prefix_engine.invalidate_kv(
                np.arange(self.prefix_engine.n_blocks))
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
        return True

    def _lease_prefix_wave(self, rep: DecodeReplica,
                           prompts: List[np.ndarray]) -> WavePlan:
        """Per-wave batched prefix leasing for one replica: ONE logical
        tick, every request classified against the same table snapshot,
        all renewals in a single ``read_many`` and all misses in at most
        one jump-ahead write over their union."""
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

    def _maybe_rebase(self) -> None:
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
        replica, then the rebase guard."""
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
    """K serving hosts sharing one sharded lease directory: not ported in
    this slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiHostServingCluster (sharded lease directory) is not "
            "ported yet")
