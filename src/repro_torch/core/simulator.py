"""Multi-core coherence simulator (Tardis + directory baselines), torch port.

The port of ``repro.core.simulator``.  An event-level model of the paper's
Graphite setup: cores execute their trace in program order; the global
interleaving is produced by always stepping the core with the smallest
local clock (ties to the lowest id).  Each memory operation is an
*atomic transaction* against the cache hierarchy -- the protocol
transition, its latency, and its NoC traffic are computed in one
simulator step.

The JAX package runs the whole simulation as one jitted
``lax.while_loop`` over a dict of arrays; here the same dict holds torch
tensors (bools as ``torch.bool``, the stats as float32 scalars) and
:func:`simulate` hands it to K9 (``kernels/coherence_sim``), which on the
card runs the whole loop in ONE kernel launch and on the CPU runs the
plain step below until the loop's condition fails.  The plain step is
the JAX step written for one transaction at a time: it reads its operands
out of the tensors, computes the transaction on Python ints wrapped to
int32, and writes back, in the JAX package's order, exactly the entries
the JAX step changes (its masked-off writes store the value already
there, and an inactive transaction changes nothing).  The stats are
float32 sums, added in the order of the JAX package's ``_bump``.

Approximations (as in the JAX package; EXPERIMENTS.md documents them):
spin loops poll with exponential backoff, speculation / OoO are modelled
through effective latency, and base-delta compression is an accounting
model over absolute timestamps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, pick_device
from .geometry import (Geometry, INT_MAX, addr_bank, addr_l1_set,
                       addr_llc_set, hop_dist, pick_llc_victim, pick_way,
                       wrap_i32 as _i32)
from .protocol import EXCLUSIVE, INVALID, SHARED
from .traces import BARRIER, END, LOAD, SPIN, STORE, Trace

I32 = torch.int32


@dataclasses.dataclass
class SimConfig:
    """Dynamic simulation parameters.  Defaults = paper Table V."""
    lease: int = 10
    selfinc_period: int = 100
    speculate: bool = True
    ooo_hide: int = 0            # >0 models an OoO window hiding miss latency
    private_write_opt: bool = True
    ts_bits: int = 20            # 0 disables compression accounting (64-bit)
    rebase_l1: int = 128         # cycles (128 ns @ 1 GHz)
    rebase_l2: int = 1024
    hop_cycles: int = 2
    llc_lat: int = 8
    dram_lat: int = 100
    flush_penalty: int = 8       # misspeculation rollback
    ackwise_k: int = 0           # directory only: 0 = full-map MSI
    estate: bool = False         # paper section IV-D: E-state extension
    spin_backoff_cap: int = 32
    barrier_cost: int = 4
    max_steps: int = 2_000_000

    def as_tensors(self, device: DeviceLike = "cpu"
                   ) -> Dict[str, torch.Tensor]:
        """The state's ``cfg`` entries (the JAX package's ``as_jnp`` keys,
        in its order) as int32 scalars filled on ``device``, so a CUDA
        device costs no host-to-device copy."""
        vals = {
            "lease": self.lease, "period": self.selfinc_period,
            "spec": int(bool(self.speculate)), "ooo_hide": self.ooo_hide,
            "pw_opt": int(bool(self.private_write_opt)),
            "ts_bits": self.ts_bits, "rebase_l1": self.rebase_l1,
            "rebase_l2": self.rebase_l2, "hop": self.hop_cycles,
            "llc_lat": self.llc_lat, "dram_lat": self.dram_lat,
            "flush_pen": self.flush_penalty, "ackwise_k": self.ackwise_k,
            "estate": int(bool(self.estate)),
            "backoff_cap": self.spin_backoff_cap,
            "barrier_cost": self.barrier_cost, "max_steps": self.max_steps,
        }
        return {k: torch.full((), v, dtype=I32, device=device)
                for k, v in vals.items()}


STAT_KEYS = (
    "ops_done", "traffic", "msgs", "n_renew", "n_renew_ok", "n_misspec",
    "n_upgrade_ok", "n_llc_req", "n_dram", "n_ts_incr", "n_selfinc",
    "n_rebase_l1", "n_rebase_l2", "n_rebase_inval", "n_inv_msgs",
    "n_spin_polls", "n_l1_miss", "n_evict_msgs", "n_egrant",
)
LOG_KEYS = ("core", "kind", "addr", "ts", "ver")


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    if device.type == "cuda":       # pinned and asynchronous: no host sync
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def init_state(geom: Geometry, trace: Trace, cfg: Dict[str, torch.Tensor],
               directory: bool, device: DeviceLike = "cpu"):
    """The simulation state: the JAX package's ``init_state`` keys, shapes
    and dtypes, as tensors on ``device``."""
    dev = torch.device(device)
    n, s1, w1 = geom.n_cores, geom.l1_sets, geom.l1_ways
    s2, w2 = geom.llc_sets_total, geom.llc_ways

    def zeros(*sh, dtype=I32):
        return torch.zeros(sh, dtype=dtype, device=dev)

    def full(sh, v, dtype=I32):
        return torch.full(sh, v, dtype=dtype, device=dev)

    b = torch.bool
    st = {
        "cfg": cfg,
        # core state
        "clock": zeros(n), "pts": full((n,), 1), "idx": zeros(n),
        "done": zeros(n, dtype=b), "blocked": zeros(n, dtype=b),
        "arrived": zeros(n, dtype=b), "acc": zeros(n),
        "spin_iter": zeros(n),
        # private L1
        "l1_tag": full((n, s1, w1), -1), "l1_st": zeros(n, s1, w1),
        "l1_wts": zeros(n, s1, w1), "l1_rts": zeros(n, s1, w1),
        "l1_ver": zeros(n, s1, w1), "l1_dirty": zeros(n, s1, w1, dtype=b),
        "l1_lru": zeros(n, s1, w1),
        # shared LLC (banked)
        "llc_tag": full((s2, w2), -1), "llc_st": zeros(s2, w2),
        "llc_wts": zeros(s2, w2), "llc_rts": zeros(s2, w2),
        "llc_owner": full((s2, w2), -1), "llc_ver": zeros(s2, w2),
        "llc_dirty": zeros(s2, w2, dtype=b), "llc_lru": zeros(s2, w2),
        "llc_acc": zeros(s2, w2, dtype=b),   # accessed-since-fill (E ext.)
        # DRAM image + per-bank memory timestamp + global store counters
        "mem_ver": zeros(geom.n_addr), "mts": full((n,), 1),
        "store_count": zeros(geom.n_addr),
        # timestamp-compression accounting
        "bts_l1": zeros(n), "bts_llc": zeros(n),
        "maxts_l1": zeros(n), "maxts_llc": zeros(n),
        # traces
        "op_type": _upload(trace.op_type, dev),
        "op_addr": _upload(trace.op_addr, dev),
        "op_aux": _upload(trace.op_aux, dev),
        "op_think": _upload(trace.op_think, dev),
        "lru_clock": zeros(), "steps": zeros(), "aborted": zeros(dtype=b),
        "stats": {k: zeros(dtype=torch.float32) for k in STAT_KEYS},
    }
    if directory:
        st["sharers"] = zeros(s2, w2, n, dtype=b)
    if geom.log_size:
        st["log"] = {k: zeros(geom.log_size) for k in LOG_KEYS}
        st["log"]["n"] = zeros()
    return st


def host_cfg(st) -> Dict[str, int]:
    """The state's ``cfg`` scalars as Python ints (the plain loop reads
    them once a run)."""
    return {k: int(v) for k, v in st["cfg"].items()}


def _bump(stats, **deltas):
    """Add each delta to its float32 stat, in the order given (a zero
    delta leaves the sum as it is, as ``x + 0.0`` does)."""
    for k, v in deltas.items():
        v = int(v)
        if v:
            stats[k].add_(v)


def _row(t, *idx):
    return t[idx].tolist()


# ---------------------------------------------------------------------------
# Tardis memory transaction (Tables II & III)
# ---------------------------------------------------------------------------

def tardis_mem(geom: Geometry, st, i, addr, is_store, active, cfg, now,
               steps):
    """One load/store transaction under Tardis, in place on ``st``.

    ``cfg`` is :func:`host_cfg`'s dict, ``now`` the step's LRU stamp.
    Returns (latency, op_ts, observed_version); an inactive transaction
    changes nothing.
    """
    pts = int(st["pts"][i])
    if not active:
        return 0, pts, 0
    lease, spec = cfg["lease"], cfg["spec"]
    n, is_load = geom.n_cores, not is_store

    # ---- L1 lookup -------------------------------------------------------
    set1 = addr_l1_set(geom, addr)
    tags1 = _row(st["l1_tag"], i, set1)
    sts1 = _row(st["l1_st"], i, set1)
    hit1, way1 = pick_way(tags1, sts1, _row(st["l1_lru"], i, set1), addr)
    line_st = sts1[way1]
    line_wts = int(st["l1_wts"][i, set1, way1])
    line_rts = int(st["l1_rts"][i, set1, way1])
    line_ver = int(st["l1_ver"][i, set1, way1])
    line_dirty = bool(st["l1_dirty"][i, set1, way1])

    expired = hit1 and line_st == SHARED and pts > line_rts
    if is_store:
        l1_ok = hit1 and line_st == EXCLUSIVE
    else:
        l1_ok = hit1 and (line_st == EXCLUSIVE
                          or (line_st == SHARED and pts <= line_rts))
    needs_llc = not l1_ok
    renewal = needs_llc and is_load and expired

    renew_ok = upgrade_ok = grant_e = missL = False
    g_wts = g_rts_raw = g_ver = new_llc_rts = 0
    traffic = msgs = 0
    lat = 1
    bank = addr_bank(geom, addr)
    if needs_llc:
        # ---- LLC lookup (every read of the pre-step state first) --------
        gset = addr_llc_set(geom, addr)
        tagsL = _row(st["llc_tag"], gset)
        stsL = _row(st["llc_st"], gset)
        lrusL = _row(st["llc_lru"], gset)
        ownersL = _row(st["llc_owner"], gset)
        hitL, wayL = pick_way(tagsL, stsL, lrusL, addr)
        if not hitL:
            wayL = pick_llc_victim(tagsL, stsL, lrusL, ownersL, i)
        L_st, L_tag, owner = stsL[wayL], tagsL[wayL], ownersL[wayL]
        L_wts = int(st["llc_wts"][gset, wayL])
        L_rts = int(st["llc_rts"][gset, wayL])
        L_ver = int(st["llc_ver"][gset, wayL])
        L_dirty = bool(st["llc_dirty"][gset, wayL])
        L_acc = bool(st["llc_acc"][gset, wayL])
        owned = hitL and L_st == EXCLUSIVE
        missL = not hitL
        # E-state extension (paper IV-D): a load on a line nobody has
        # touched since it entered the LLC is granted exclusively.
        grant_e = (is_load and cfg["estate"] == 1
                   and (missL or (L_st == SHARED and not L_acc)))
        v_valid = missL and L_st != INVALID      # wayL is the victim slot
        v_owned = v_valid and L_st == EXCLUSIVE
        v_owner = owner if v_owned else 0
        vset1 = addr_l1_set(geom, L_tag)
        vo_flush = False
        if v_owned:
            vo = v_owner % n                      # JAX wraps -1 to n - 1
            vo_hit, vo_way = pick_way(_row(st["l1_tag"], vo, vset1),
                                      _row(st["l1_st"], vo, vset1),
                                      _row(st["l1_lru"], vo, vset1), L_tag)
            vo_flush = vo_hit
            vo_rts = int(st["l1_rts"][vo, vset1, vo_way])
            vo_ver = int(st["l1_ver"][vo, vset1, vo_way])
            vo_dirty = bool(st["l1_dirty"][vo, vset1, vo_way])
        o_act = False
        if owned:
            ow = owner % n
            o_hit, o_way = pick_way(_row(st["l1_tag"], ow, set1),
                                    _row(st["l1_st"], ow, set1),
                                    _row(st["l1_lru"], ow, set1), addr)
            o_act = o_hit                          # invariant when owned
            o_wts = int(st["l1_wts"][ow, set1, o_way])
            o_rts = int(st["l1_rts"][ow, set1, o_way])
            o_ver = int(st["l1_ver"][ow, set1, o_way])
        mem_ver_addr = int(st["mem_ver"][addr])
        mts_bank = int(st["mts"][bank])

        # ---- LLC victim eviction (fill path only) ------------------------
        victim_rts = vo_rts if vo_flush else L_rts
        victim_ver = vo_ver if vo_flush else L_ver
        victim_dirty = (vo_dirty or L_dirty) if vo_flush else L_dirty
        if vo_flush:                  # flush the victim-owner's L1 copy
            st["l1_st"][vo, vset1, vo_way] = INVALID
        if v_valid and victim_dirty:  # DRAM writeback
            st["mem_ver"][L_tag] = victim_ver
        if v_valid:                   # mts fold
            mts_bank = max(mts_bank, victim_rts)
            st["mts"][bank] = mts_bank

        # ---- owner write-back / flush for the requested line -------------
        if owned:
            wb_rts = _i32(max(max(o_rts, _i32(o_wts + lease)),
                              _i32(pts + lease)))
        if o_act:
            # load -> WB_REQ: owner downgrades to Shared, rts extended;
            # store -> FLUSH_REQ: owner invalidates
            st["l1_st"][ow, set1, o_way] = INVALID if is_store else SHARED
            if is_load:
                st["l1_rts"][ow, set1, o_way] = wb_rts

        # ---- grant values the manager serves ------------------------------
        if owned:
            g_wts, g_ver, g_dirty = o_wts, o_ver, True
            g_rts_raw = wb_rts if is_load else o_rts
        elif hitL:
            g_wts, g_rts_raw, g_ver, g_dirty = L_wts, L_rts, L_ver, L_dirty
        else:
            g_wts = g_rts_raw = mts_bank
            g_ver, g_dirty = mem_ver_addr, False
        new_llc_rts = _i32(max(max(g_rts_raw, _i32(g_wts + lease)),
                               _i32(pts + lease)))
        renew_ok = renewal and line_wts == g_wts
        upgrade_ok = (is_store and hit1 and line_wts == g_wts and not owned
                      and hitL)

        # ---- LLC line update ----------------------------------------------
        excl_grant = is_store or grant_e
        st["llc_tag"][gset, wayL] = addr
        st["llc_st"][gset, wayL] = EXCLUSIVE if excl_grant else SHARED
        st["llc_wts"][gset, wayL] = g_wts
        st["llc_rts"][gset, wayL] = new_llc_rts if is_load else g_rts_raw
        st["llc_owner"][gset, wayL] = i if excl_grant else -1
        st["llc_acc"][gset, wayL] = True
        st["llc_ver"][gset, wayL] = g_ver
        st["llc_dirty"][gset, wayL] = g_dirty and is_load
        st["llc_lru"][gset, wayL] = now

        # ---- L1 victim write-back (Exclusive lines flush to their LLC) ----
        v1_excl = (not hit1) and sts1[way1] == EXCLUSIVE
        v1_to_llc = v1_to_dram = False
        d_ibv1 = 0
        if v1_excl:
            v1_tag = tags1[way1]
            gsetv1 = addr_llc_set(geom, v1_tag)
            bankv1 = addr_bank(geom, v1_tag)
            hv1, wv1 = pick_way(_row(st["llc_tag"], gsetv1),
                                _row(st["llc_st"], gsetv1),
                                _row(st["llc_lru"], gsetv1), v1_tag)
            v1_to_llc, v1_to_dram = hv1, not hv1
            d_ibv1 = hop_dist(geom, i, bankv1)
            if v1_to_llc:
                st["llc_st"][gsetv1, wv1] = SHARED
                st["llc_wts"][gsetv1, wv1] = line_wts
                st["llc_rts"][gsetv1, wv1] = line_rts
                st["llc_ver"][gsetv1, wv1] = line_ver
                st["llc_dirty"][gsetv1, wv1] = True
                # a written-back line has no sharers left: next toucher
                # may take it E
                st["llc_acc"][gsetv1, wv1] = False
            else:
                st["mem_ver"][v1_tag] = line_ver
                st["mts"][bankv1] = max(int(st["mts"][bankv1]), line_rts)

        # ---- latency & traffic (the LLC legs) -----------------------------
        hop = cfg["hop"]
        d_ib = hop_dist(geom, i, bank)
        d_bo = hop_dist(geom, bank, owner)
        d_bvo = hop_dist(geom, bank, v_owner)
        llc_leg = 2 * hop * d_ib + cfg["llc_lat"]
        owner_leg = 2 * hop * d_bo + 1 if owned else 0
        vflush_leg = 2 * hop * d_bvo + 1 if vo_flush else 0
        dram_leg = cfg["dram_lat"] + vflush_leg if missL else 0
        lat_exposed = max(1, _i32(llc_leg + owner_leg + dram_leg
                                  - cfg["ooo_hide"]))
        if renewal and renew_ok and spec == 1:
            lat = 1
        elif renewal and not renew_ok:
            lat = _i32(lat_exposed + spec * cfg["flush_pen"])
        else:
            lat = lat_exposed
        # paper section VI-B-2: a successful renewal is a single-flit message
        if is_load:
            reply_flits = 1 if renew_ok else 6
        else:
            reply_flits = 1 if upgrade_ok else 6
        traffic = (2 + reply_flits) * d_ib
        if o_act:
            traffic += (2 + 6) * d_bo if is_load else (1 + 6) * d_bo
        traffic += (1 + 5 if missL else 0)                     # DRAM ld
        traffic += (5 if v_valid and victim_dirty else 0)      # DRAM st
        traffic += ((1 + 6) * d_bvo if vo_flush else 0)
        traffic += (6 * d_ibv1 if v1_to_llc else 0)
        traffic += (6 * d_ibv1 + 5 if v1_to_dram else 0)
        msgs = (2 + (2 if o_act else 0) + (2 if missL else 0)
                + (2 if vo_flush else 0) + (1 if v1_excl else 0)
                + (1 if v_valid and victim_dirty else 0))

    # ---- requester L1 + timestamps ----------------------------------------
    new_ver = _i32(int(st["store_count"][addr]) + 1) if is_store else 0
    pw = cfg["pw_opt"] == 1 and line_dirty
    ts_hitE = max(pts, line_rts) if pw else max(pts, _i32(line_rts + 1))
    ts_fill = max(pts, _i32(g_rts_raw + 1))
    store_ts = ts_hitE if l1_ok else ts_fill
    obs_wts = line_wts if (l1_ok or renew_ok) else g_wts
    load_pts = max(pts, obs_wts)
    new_pts = store_ts if is_store else load_pts

    # final L1 line (requester)
    f_st = (EXCLUSIVE if is_store or grant_e
            else (line_st if l1_ok else SHARED))
    f_wts = store_ts if is_store else (line_wts if l1_ok else g_wts)
    # loads: E-hit tracks own last read; S keeps lease / takes the new lease
    if l1_ok and line_st == EXCLUSIVE:
        f_rts_load = max(load_pts, line_rts)
    elif l1_ok:
        f_rts_load = line_rts
    elif grant_e:
        f_rts_load = max(load_pts, g_rts_raw)
    else:
        f_rts_load = new_llc_rts
    f_rts = store_ts if is_store else f_rts_load
    keep = l1_ok or renew_ok
    f_ver = new_ver if is_store else (line_ver if keep else g_ver)
    f_dirty = True if is_store else (line_dirty if keep else False)
    st["l1_tag"][i, set1, way1] = addr
    st["l1_st"][i, set1, way1] = f_st
    st["l1_wts"][i, set1, way1] = f_wts
    st["l1_rts"][i, set1, way1] = f_rts
    st["l1_ver"][i, set1, way1] = f_ver
    st["l1_dirty"][i, set1, way1] = f_dirty
    st["l1_lru"][i, set1, way1] = now
    if is_store:
        st["store_count"][addr] = new_ver

    # ---- timestamp-compression accounting ----------------------------------
    ts_bits = cfg["ts_bits"]
    use_comp = ts_bits > 0
    thr = 1 << min(ts_bits, 30) if ts_bits >= 0 else 0
    maxts_l1 = max(int(st["maxts_l1"][i]), max(f_wts, f_rts))
    st["maxts_l1"][i] = maxts_l1
    reb1 = reb2 = False
    n_kill = 0
    if use_comp:
        half = thr // 2
        bts_l1 = int(st["bts_l1"][i])
        reb1 = _i32(maxts_l1 - bts_l1) >= thr
        if needs_llc:
            maxts_llc = max(int(st["maxts_llc"][bank]),
                            max(g_wts, new_llc_rts))
            st["maxts_llc"][bank] = maxts_llc
            bts_llc = int(st["bts_llc"][bank])
            reb2 = _i32(maxts_llc - bts_llc) >= thr
        if reb1:
            new_bts1 = _i32(bts_l1 + half)
            st["bts_l1"][i] = new_bts1
        if reb2:
            st["bts_llc"][bank] = _i32(bts_llc + half)
        if reb1:
            # invalidate long-expired private Shared lines (delta < 0)
            kill = (st["l1_st"][i] == SHARED) & (st["l1_rts"][i] < new_bts1)
            n_kill = int(kill.sum())
            st["l1_st"][i][kill] = INVALID
    elif needs_llc:
        st["maxts_llc"][bank] = max(int(st["maxts_llc"][bank]),
                                    max(g_wts, new_llc_rts))
    lat = _i32(lat + (cfg["rebase_l1"] if reb1 else 0)
               + (cfg["rebase_l2"] if reb2 else 0))

    _bump(st["stats"],
          traffic=traffic, msgs=msgs,
          n_renew=renewal, n_renew_ok=renew_ok,
          n_misspec=renewal and not renew_ok and spec == 1,
          n_upgrade_ok=upgrade_ok,
          n_llc_req=needs_llc, n_dram=missL,
          n_ts_incr=_i32(new_pts - pts),
          n_rebase_l1=reb1, n_rebase_l2=reb2,
          n_rebase_inval=n_kill,
          n_l1_miss=needs_llc and not renewal,
          n_egrant=grant_e)
    st["pts"][i] = new_pts
    return lat, new_pts, f_ver


# ---------------------------------------------------------------------------
# Scheduler harness: min-clock interleaving, barriers, spins, self-increment
# ---------------------------------------------------------------------------

def _shl1(k: int) -> int:
    """``int32(1) << k`` as XLA shifts: 0 for a shift outside [0, 32)."""
    return _i32(1 << k) if 0 <= k < 32 else 0


def _make_step(geom: Geometry, mem_fn):
    """``step(st, cfg)``: one iteration of the JAX package's loop body, in
    place on ``st`` (``cfg``: :func:`host_cfg`'s dict)."""
    trace_last = geom.trace_len - 1

    def step(st, cfg):
        runnable = ~st["done"] & ~st["blocked"]
        none_runnable = not bool(runnable.any())
        i = int(torch.where(runnable, st["clock"], INT_MAX).argmin())
        idx_i = int(st["idx"][i])
        j = min(max(idx_i, 0), trace_last)
        ty = int(st["op_type"][i, j])
        addr = min(max(int(st["op_addr"][i, j]), 0), geom.n_addr - 1)
        aux = int(st["op_aux"][i, j])
        think = int(st["op_think"][i, j])

        live = not none_runnable
        is_end = ty == END or none_runnable
        is_barrier = ty == BARRIER and live
        is_spin = ty == SPIN and live
        is_store = ty == STORE and live
        is_mem = (ty == LOAD or ty == STORE or ty == SPIN) and live

        steps = int(st["steps"])
        now = _i32(int(st["lru_clock"]) + 1)
        clock_i = int(st["clock"][i])
        lat = op_ts = ver_obs = 0
        if is_mem:
            lat, op_ts, ver_obs = mem_fn(geom, st, i, addr, is_store, True,
                                         cfg, now, steps)

        # ---- spin resolution with exponential poll backoff ----------------
        spin_fail = is_spin and not ver_obs >= aux
        spin_iter = int(st["spin_iter"][i])
        backoff = min(cfg["backoff_cap"], _shl1(min(spin_iter, 8)))
        st["spin_iter"][i] = _i32(spin_iter + 1) if spin_fail else 0

        # ---- self-increment (livelock avoidance, paper III-E) -------------
        # A backed-off poll stands in for `backoff` single-cycle polls, so
        # it credits the access counter accordingly.
        credit = (1 if is_mem else 0) + (backoff if spin_fail else 0)
        acc1 = _i32(int(st["acc"][i]) + credit)
        period = max(cfg["period"], 1)
        n_inc = acc1 // period
        selfinc = is_mem and n_inc > 0
        st["acc"][i] = acc1 % period if selfinc else acc1
        if selfinc:
            st["pts"][i] = _i32(int(st["pts"][i]) + n_inc)

        # ---- clock / idx advance -------------------------------------------
        st["clock"][i] = _i32(clock_i + think + (lat if is_mem else 0)
                              + (backoff if spin_fail else 0))
        advance = (is_mem and not spin_fail) or is_end
        if advance and live:
            st["idx"][i] = _i32(idx_i + 1)
        if is_end and live:
            st["done"][i] = True
        if none_runnable:
            st["done"].fill_(True)

        # ---- barrier -------------------------------------------------------
        if is_barrier:
            st["arrived"][i] = True
            st["blocked"][i] = True
            arrived = st["arrived"]
            if bool((arrived | st["done"]).all()):       # release
                rel = torch.where(arrived, st["clock"], 0).max()
                rel = _i32(int(rel) + cfg["barrier_cost"])
                st["clock"][arrived] = rel
                st["idx"][arrived] += 1
                st["blocked"].fill_(False)
                arrived.fill_(False)

        _bump(st["stats"],
              ops_done=advance and is_mem,
              n_selfinc=n_inc if selfinc else 0,
              n_ts_incr=n_inc if selfinc else 0,
              n_spin_polls=is_spin)
        st["steps"].fill_(_i32(steps + 1))
        st["lru_clock"].fill_(now)
        if none_runnable:
            st["aborted"].fill_(True)

        if geom.log_size:
            log = st["log"]
            n = int(log["n"])
            if is_mem and n < geom.log_size:
                w = max(n, 0)
                for k, v in zip(LOG_KEYS, (i, 1 if is_store else 0, addr,
                                           op_ts, ver_obs)):
                    log[k][w] = v
                log["n"].fill_(n + 1)

    return step


def running(st) -> bool:
    """The JAX loop's condition: some core not done, under max_steps."""
    return (not bool(st["done"].all())
            and int(st["steps"]) < int(st["cfg"]["max_steps"]))


def mem_fn_of(proto: str):
    if proto == "tardis":
        return tardis_mem
    if proto == "directory":
        from .directory import directory_mem
        return directory_mem
    raise ValueError(f"unknown protocol {proto!r}")


@dataclasses.dataclass
class SimResult:
    stats: Dict[str, float]
    cycles: int
    ops: int
    aborted: bool
    pts: np.ndarray
    log: Optional[Dict[str, np.ndarray]]
    steps: int = 0        # the loop's iterations (not in the JAX result)

    @property
    def throughput(self) -> float:
        return self.ops / max(1, self.cycles)

    @property
    def traffic(self) -> float:
        return self.stats["traffic"]


def read_result(st, geom: Geometry) -> SimResult:
    """The run's result from its final state, with ONE device-to-host
    copy (on the card: the run's one host sync)."""
    n = geom.n_cores
    stats = torch.stack([st["stats"][k] for k in STAT_KEYS]).view(I32)
    scalars = torch.stack([st["aborted"].to(I32), st["steps"]])
    parts = [stats, scalars, st["idx"], st["clock"], st["pts"]]
    if geom.log_size:
        parts += [st["log"]["n"].view(1)] + [st["log"][k] for k in LOG_KEYS]
    flat = torch.cat(parts).cpu().numpy()
    s = len(STAT_KEYS)
    stat_vals = flat[:s].view(np.float32)
    aborted, steps = int(flat[s]), int(flat[s + 1])
    o = s + 2
    idx, clock, pts = (flat[o:o + n], flat[o + n:o + 2 * n],
                       flat[o + 2 * n:o + 3 * n].copy())
    log = None
    if geom.log_size:
        o += 3 * n
        m = int(flat[o])
        arrays = flat[o + 1:].reshape(len(LOG_KEYS), geom.log_size)
        log = {k: arrays[r, :m].copy() for r, k in enumerate(LOG_KEYS)}
    stats = {k: float(v) for k, v in zip(STAT_KEYS, stat_vals)}
    cycles = int(np.max(np.where(idx > 0, clock, 0)))
    return SimResult(stats=stats, cycles=cycles, ops=int(stats["ops_done"]),
                     aborted=bool(aborted), pts=pts, log=log, steps=steps)


def simulate(trace: Trace, proto: str = "tardis",
             config: SimConfig | None = None,
             geom: Geometry | None = None,
             log: bool = False, device: DeviceLike = None) -> SimResult:
    """Run one trace under one protocol; returns stats (+ optional op log).

    ``device`` None means the card (raises without one): the whole run is
    one launch of K9 and one host sync; ``"cpu"`` runs the plain loop.
    """
    from ..kernels.coherence_sim.kernel import sim_run
    mem_fn_of(proto)
    dev = pick_device(device)
    config = config or SimConfig()
    if geom is None:
        geom = Geometry(n_cores=trace.n_cores)
    log_size = 0
    if log:
        # spin polls can multiply the op count; leave generous headroom
        log_size = int(min(config.max_steps, trace.total_ops() * 8 + 4096))
    geom = dataclasses.replace(
        geom, n_cores=trace.n_cores, trace_len=trace.length,
        n_addr=max(geom.n_addr, int(trace.n_addr)), log_size=log_size)
    st = init_state(geom, trace, config.as_tensors(dev),
                    directory=(proto == "directory"), device=dev)
    sim_run(st, geom, proto)
    return read_result(st, geom)
