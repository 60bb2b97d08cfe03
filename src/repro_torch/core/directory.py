"""Full-map MSI and Ackwise-style limited directory baselines, torch port.

The port of ``repro.core.directory``: the same event-level transaction
model as :func:`repro_torch.core.simulator.tardis_mem`, with
physical-time coherence: stores invalidate every sharer (and wait for
acknowledgements -- latency is the farthest sharer's round trip, traffic
is per-sharer), loads downgrade exclusive owners, and L1 evictions notify
the directory (PUTS/PUTX) so the sharer list stays precise.

``ackwise_k > 0`` switches the *cost model* to a limited directory with k
sharer pointers: once a line has more than k sharers, invalidations are
broadcast to every core (all N cores ack), as in ATAC/Ackwise.  Semantics
are tracked with a precise bitmask either way; only traffic/latency
differ.  The directory's logical timestamp for SC checking is the global
commit sequence (physical order).

The plain transaction, like the Tardis one, reads the pre-step state
first and then writes, in the JAX package's order, the entries the JAX
transaction changes; the sharer rows and the invalidations across every
core's L1 set are torch ops over the cores.
"""
from __future__ import annotations

import functools

import torch

from .geometry import (Geometry, addr_bank, addr_l1_set, addr_llc_set,
                       hop_dist, pick_llc_victim, pick_way, wrap_i32 as _i32)
from .protocol import EXCLUSIVE, INVALID, SHARED
from .simulator import _bump, _row


@functools.lru_cache(maxsize=None)
def _bank_dist(geom: Geometry, bank: int):
    """hop_dist(bank, c) for every core c."""
    return [hop_dist(geom, bank, c) for c in range(geom.n_cores)]


def _inv_cost(geom: Geometry, cfg, bank, mask, limited_bcast):
    """(latency, traffic, n_msgs) of invalidating the cores in ``mask``
    (a bool tensor over the cores).

    Directed mode: INV + ACK per sharer, latency = farthest sharer.
    Broadcast mode (Ackwise overflow): INV to all N cores, every core acks.
    """
    cores = mask.nonzero().flatten().tolist()
    if not cores:
        return 0, 0, 0
    d = _bank_dist(geom, bank)
    hop = cfg["hop"]
    if limited_bcast:
        return 2 * hop * max(d) + 1, sum(2 * x for x in d), 2 * geom.n_cores
    return (2 * hop * max(d[c] for c in cores) + 1,
            sum(2 * d[c] for c in cores), 2 * len(cores))


def _invalidate(st, mask, l1_set, tag):
    """Every L1 way of l1_set holding ``tag`` in the cores of ``mask``
    becomes INVALID (the tags are the pre-step ones: no transaction
    writes an L1 tag before this)."""
    if bool(mask.any()):
        kill = mask[:, None] & (st["l1_tag"][:, l1_set, :] == tag)
        st["l1_st"][:, l1_set, :][kill] = INVALID


def directory_mem(geom: Geometry, st, i, addr, is_store, active, cfg, now,
                  steps):
    """One load/store transaction under (full-map | Ackwise) MSI, in place
    on ``st``.  Returns (latency, op_ts, observed_version)."""
    if not active:
        return 0, steps, 0
    n, is_load = geom.n_cores, not is_store
    k = cfg["ackwise_k"]

    # ---- L1 lookup -------------------------------------------------------
    set1 = addr_l1_set(geom, addr)
    tags1 = _row(st["l1_tag"], i, set1)
    sts1 = _row(st["l1_st"], i, set1)
    hit1, way1 = pick_way(tags1, sts1, _row(st["l1_lru"], i, set1), addr)
    line_st = sts1[way1]
    line_ver = int(st["l1_ver"][i, set1, way1])
    line_dirty = bool(st["l1_dirty"][i, set1, way1])
    if is_store:
        l1_ok = hit1 and line_st == EXCLUSIVE
    else:
        l1_ok = hit1 and line_st != INVALID
    needs_llc = not l1_ok
    upgrade = needs_llc and is_store and hit1 and line_st == SHARED

    g_ver = 0
    missL = v1_valid = False
    traffic = msgs = inv_msgs = 0
    lat = 1
    if needs_llc:
        # ---- LLC / directory lookup (the pre-step reads first) ----------
        bank = addr_bank(geom, addr)
        gset = addr_llc_set(geom, addr)
        tagsL = _row(st["llc_tag"], gset)
        stsL = _row(st["llc_st"], gset)
        lrusL = _row(st["llc_lru"], gset)
        ownersL = _row(st["llc_owner"], gset)
        hitL, wayL = pick_way(tagsL, stsL, lrusL, addr)
        if not hitL:
            wayL = pick_llc_victim(tagsL, stsL, lrusL, ownersL, i)
        L_st, L_tag, owner = stsL[wayL], tagsL[wayL], ownersL[wayL]
        L_ver = int(st["llc_ver"][gset, wayL])
        L_dirty = bool(st["llc_dirty"][gset, wayL])
        L_sharers = st["sharers"][gset, wayL].clone()
        owned = hitL and L_st == EXCLUSIVE
        missL = not hitL

        v_valid = missL and L_st != INVALID
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
            vo_ver = int(st["l1_ver"][vo, vset1, vo_way])
            vo_dirty = bool(st["l1_dirty"][vo, vset1, vo_way])
        o_act = False
        if owned:
            ow = owner % n
            o_hit, o_way = pick_way(_row(st["l1_tag"], ow, set1),
                                    _row(st["l1_st"], ow, set1),
                                    _row(st["l1_lru"], ow, set1), addr)
            o_act = o_hit
            o_ver = int(st["l1_ver"][ow, set1, o_way])
        mem_ver_addr = int(st["mem_ver"][addr])

        # ---- LLC victim eviction: invalidate its sharers -----------------
        v_inv = (0, 0, 0)
        if v_valid and not v_owned:
            _invalidate(st, L_sharers, vset1, L_tag)
            v_bcast = k > 0 and int(L_sharers.sum()) > k
            v_inv = _inv_cost(geom, cfg, bank, L_sharers, v_bcast)
        if vo_flush:
            st["l1_st"][vo, vset1, vo_way] = INVALID
        victim_ver = vo_ver if vo_flush else L_ver
        victim_dirty = (vo_dirty or L_dirty) if vo_flush else L_dirty
        if v_valid and victim_dirty:
            st["mem_ver"][L_tag] = victim_ver

        # ---- owner downgrade / flush for the requested line ---------------
        if o_act:
            st["l1_st"][ow, set1, o_way] = INVALID if is_store else SHARED

        # ---- invalidate sharers on GETX -----------------------------------
        s_inv = (0, 0, 0)
        if is_store and hitL and not owned:
            others = L_sharers.clone()
            others[i] = False
            _invalidate(st, others, set1, addr)
            s_bcast = k > 0 and int(others.sum()) > k
            s_inv = _inv_cost(geom, cfg, bank, others, s_bcast)

        # ---- grant ----------------------------------------------------------
        g_ver = o_ver if owned else (L_ver if hitL else mem_ver_addr)

        # ---- directory entry update ---------------------------------------
        new_sharers = torch.zeros_like(L_sharers)
        if is_load:
            if owned:
                new_sharers[owner % n] = True
            elif hitL:
                new_sharers = L_sharers.clone()
            new_sharers[i] = True
        st["sharers"][gset, wayL] = new_sharers
        st["llc_tag"][gset, wayL] = addr
        st["llc_st"][gset, wayL] = EXCLUSIVE if is_store else SHARED
        st["llc_owner"][gset, wayL] = i if is_store else -1
        st["llc_ver"][gset, wayL] = g_ver
        st["llc_dirty"][gset, wayL] = (owned or (hitL and L_dirty)) \
            and is_load
        st["llc_lru"][gset, wayL] = now

        # ---- L1 victim (PUTS / PUTX) --------------------------------------
        v1_st = sts1[way1]
        v1_valid = (not hit1) and v1_st != INVALID
        v1_excl = v1_valid and v1_st == EXCLUSIVE
        v1_shared = v1_valid and v1_st == SHARED
        v1_hit = False
        d_ibv1 = 0
        if v1_valid:
            v1_tag = tags1[way1]
            gsetv1 = addr_llc_set(geom, v1_tag)
            d_ibv1 = hop_dist(geom, i, addr_bank(geom, v1_tag))
            hv1, wv1 = pick_way(_row(st["llc_tag"], gsetv1),
                                _row(st["llc_st"], gsetv1),
                                _row(st["llc_lru"], gsetv1), v1_tag)
            v1_hit = hv1
            # PUTS: drop my sharer bit; PUTX: write data back, unowned
            if v1_hit and v1_shared:
                st["sharers"][gsetv1, wv1, i] = False
            if v1_hit and v1_excl:
                st["llc_st"][gsetv1, wv1] = SHARED
                st["llc_ver"][gsetv1, wv1] = line_ver
                st["llc_dirty"][gsetv1, wv1] = True
                st["sharers"][gsetv1, wv1] = False
            if v1_excl and not hv1:
                st["mem_ver"][v1_tag] = line_ver

        # ---- latency & traffic --------------------------------------------
        hop = cfg["hop"]
        d_ib = hop_dist(geom, i, bank)
        d_bo = hop_dist(geom, bank, owner)
        d_bvo = hop_dist(geom, bank, v_owner)
        inv_lat, inv_traf, s_msgs = s_inv
        v_inv_lat, v_inv_traf, v_msgs = v_inv
        llc_leg = 2 * hop * d_ib + cfg["llc_lat"]
        owner_leg = 2 * hop * d_bo + 1 if o_act else 0
        vflush_leg = 2 * hop * d_bvo + 1 if vo_flush else 0
        dram_leg = cfg["dram_lat"] + vflush_leg + v_inv_lat if missL else 0
        lat = max(1, _i32(llc_leg + owner_leg + dram_leg + inv_lat
                          - cfg["ooo_hide"]))
        reply_flits = 1 if (upgrade and not owned) else 5
        traffic = (1 + reply_flits) * d_ib
        traffic += ((1 + 5) * d_bo if o_act else 0)
        traffic += inv_traf + v_inv_traf
        traffic += (1 + 5 if missL else 0)
        traffic += (5 if v_valid and victim_dirty else 0)
        traffic += ((1 + 5) * d_bvo if vo_flush else 0)
        traffic += (1 * d_ibv1 if v1_hit and v1_shared else 0)      # PUTS
        traffic += (5 * d_ibv1 if v1_excl else 0)                  # PUTX
        inv_msgs = s_msgs + v_msgs
        msgs = (2 + (2 if o_act else 0) + (2 if missL else 0)
                + (2 if vo_flush else 0) + (1 if v1_valid else 0) + inv_msgs)

    # ---- requester L1 -------------------------------------------------------
    if is_store:
        f_st, f_dirty = EXCLUSIVE, True
        f_ver = _i32(int(st["store_count"][addr]) + 1)
    else:
        f_st = line_st if l1_ok else SHARED
        f_ver = line_ver if l1_ok else g_ver
        f_dirty = line_dirty if l1_ok else False
    st["l1_tag"][i, set1, way1] = addr
    st["l1_st"][i, set1, way1] = f_st
    st["l1_ver"][i, set1, way1] = f_ver
    st["l1_dirty"][i, set1, way1] = f_dirty
    st["l1_lru"][i, set1, way1] = now
    if is_store:
        st["store_count"][addr] = f_ver

    _bump(st["stats"],
          traffic=traffic, msgs=msgs,
          n_llc_req=needs_llc, n_dram=missL,
          n_inv_msgs=inv_msgs,
          n_l1_miss=needs_llc,
          n_evict_msgs=v1_valid)
    # directory "timestamp" for SC logging = commit sequence number
    return lat, steps, f_ver
