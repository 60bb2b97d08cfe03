"""Guarded-action model of the Tardis protocol (paper Tables I-III).

The port's own copy of ``repro.analysis.model`` (it imports only the
standard library); names, rule names and the ``TransitionInfo`` records
are kept as they are, since the bridge and the tests key on them.

The model is an explicit-state transition system over bounded configurations
(2-3 cores, 1-2 blocks).  A state is a nested tuple of small ints::

    state = (pts, lines, llc, mts, dram, vers)

      pts   : per-core program timestamps, tuple (C,)
      lines : per-core private cache, tuple (C, B) of (st, wts, rts, ver)
              with st in {INVALID, SHARED, EXCLUSIVE}; invalid lines are
              normalized to (0, 0, 0, 0)
      llc   : per-block manager line, tuple (B,) of (st, wts, rts, owner,
              ver) with st in {LLC_DRAM, LLC_S, LLC_E}; when owned the
              owner's copy is authoritative, so wts/rts/ver are normalized
              to 0; when in DRAM the timestamps live in ``mts``
      mts   : the manager's memory timestamp (LLC evictions fold rts in)
      dram  : per-block version id held by DRAM (-1 while the LLC holds
              the block -- DRAM content is dead until the next eviction
              rewrites it)
      vers  : per-block tuple of version-creation write timestamps; cache
              line / LLC ``ver`` fields index into it.  Values stand in
              for versions: "the load returned version v" is the whole
              observable behavior, so value--timestamp consistency checks
              reduce to interval checks against ``vers``.

Each transition is one rule of Tables I-III (plus the private-write
optimization of section IV-C and the ``ts_bits`` rebase the shipped
``LeaseEngine`` performs).  The timestamp math lives in :class:`Rules` as
pure-int static methods that transcribe ``core.protocol``; the bridge
(:mod:`repro_torch.analysis.bridge`) replays every recorded call against the
port's ``core.protocol`` and its ``LeaseEngine`` (the numpy mirror, or the
lease kernels K1 / K2 on the device backend) so the enumeration checks the
*shipped* rules, not this transcription.  Mutant rule sets (for the
seeded-mutation sensitivity tests) subclass :class:`Rules`.

The state space closes because timestamps are drawn from the bounded domain
[0, 2**ts_bits + lease]: whenever any timestamp reaches 2**ts_bits the
*rebase* rule becomes urgent (it is the only enabled transition) and shifts
every timestamp down by 2**(ts_bits-1), exactly like
``LeaseEngine.maybe_rebase`` / ``timestamps.apply_rebase`` -- including the
engine's drop rule for private Shared lines whose lease lies entirely below
the shift.  Gap-capping canonicalizations are deliberately *not* used: the
protocol guards are max-plus expressions and capping adjacent timestamp
gaps can flip a ``pts + lease >= rts`` comparison, so the only sound finite
abstraction is the one the shipped system itself implements.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import permutations
from typing import Iterator, List, Optional, Tuple

INVALID, SHARED, EXCLUSIVE = 0, 1, 2
LLC_DRAM, LLC_S, LLC_E = 0, 1, 2

_ST_NAME = {0: "I", 1: "S", 2: "E"}
_LLC_NAME = {0: "DRAM", 1: "S", 2: "E"}


@dataclass(frozen=True)
class Config:
    """Bounded model configuration.

    ``consistency`` picks the forbidden-outcome predicates evaluated over
    the SAME enumerated state graph (transitions never change):

      * ``sc``  -- all three load checks (value-ts lower bound, no stale
        value inside a newer version's interval, never past the lease end),
      * ``tso`` -- the store->load relaxation: a load may act as if ordered
        at a timestamp inside its lease even when the core's own
        program-earlier stores/ticks pushed pts past the lease end, so the
        "beyond the serving lease end" check is waived,
      * ``rc``  -- additionally waives the stale-inside-newer-interval
        check (loads may reorder with program-earlier loads); only the
        per-location value-ts lower bound remains.
    """
    n_cores: int = 2
    n_blocks: int = 1
    lease: int = 2
    ts_bits: int = 3          # rebase threshold 2**ts_bits, shift 2**(bits-1)
    self_inc: bool = True     # cores may advance pts spontaneously
    pw_opt: bool = True       # section IV-C private-write optimization
    symmetry: bool = True     # quotient by core/block permutations
    consistency: str = "sc"   # sc | tso | rc (see above)

    @property
    def threshold(self) -> int:
        return 1 << self.ts_bits

    @property
    def shift(self) -> int:
        return 1 << (self.ts_bits - 1)


class Rules:
    """Pure-int transcription of the ``core.protocol`` scalars.

    Every method mirrors the protocol function of the same name; the bridge
    cross-validates each distinct call bit-for-bit.  Seeded mutants for the
    sensitivity tests override single methods.
    """

    @staticmethod
    def load_no_cache(pts, wts, rts):
        new_pts = max(pts, wts)
        return new_pts, max(new_pts, rts)

    @staticmethod
    def store_no_cache(pts, wts, rts):
        ts = max(pts, rts + 1)
        return ts, ts, ts

    @staticmethod
    def load_hit_shared(pts, wts):
        return max(pts, wts)

    @staticmethod
    def load_hit_exclusive(pts, wts, rts):
        new_pts = max(pts, wts)
        return new_pts, max(new_pts, rts)

    @staticmethod
    def store_hit_exclusive(pts, rts):
        ts = max(pts, rts + 1)
        return ts, ts, ts

    @staticmethod
    def store_hit_private(pts, rts):
        ts = max(pts, rts)
        return ts, ts, ts

    @staticmethod
    def shared_expired(pts, rts):
        return pts > rts

    @staticmethod
    def writeback_rts(line_wts, line_rts, req_pts, lease):
        return max(line_rts, line_wts + lease, req_pts + lease)

    @staticmethod
    def lease_extend(llc_wts, llc_rts, req_pts, lease):
        return max(llc_rts, llc_wts + lease, req_pts + lease)

    @staticmethod
    def renewable(req_wts, llc_wts):
        return req_wts == llc_wts

    @staticmethod
    def dram_fill_ts(mts):
        return mts, mts

    @staticmethod
    def evict_mts(mts, line_rts):
        return max(mts, line_rts)


@dataclass
class TransitionInfo:
    """Everything the enumerator and the bridge need about one transition."""
    rule: str
    core: Optional[int] = None
    block: Optional[int] = None
    pts_before: Optional[int] = None
    pts_after: Optional[int] = None
    # (protocol_fn_name, args, expected_result) -- bridge replays these
    calls: List[Tuple[str, tuple, object]] = field(default_factory=list)
    # manager-table op replayed through the LeaseEngine, or None
    engine_op: Optional[tuple] = None
    is_rebase: bool = False
    # invariant violations detected while applying (value-ts containment,
    # pts monotonicity, version ordering)
    violations: List[str] = field(default_factory=list)


def _line(st=INVALID, wts=0, rts=0, ver=0):
    return (st, wts, rts, ver)


class TardisModel:
    """Tables I-III as guarded transitions over bounded explicit states."""

    def __init__(self, cfg: Config, rules: Optional[Rules] = None):
        self.cfg = cfg
        self.rules = rules if rules is not None else Rules()
        # A non-default rule set is a seeded mutant: the bridge would flag
        # the transcription mismatch before the invariant checker got to
        # show the *semantic* failure, so explore() refuses the combination.
        self.is_mutant = type(self.rules) is not Rules

    # -- state constructors -------------------------------------------------

    def initial_state(self):
        cfg = self.cfg
        pts = (0,) * cfg.n_cores
        lines = tuple(tuple(_line() for _ in range(cfg.n_blocks))
                      for _ in range(cfg.n_cores))
        llc = tuple((LLC_DRAM, 0, 0, -1, 0) for _ in range(cfg.n_blocks))
        dram = (0,) * cfg.n_blocks        # DRAM holds version 0 everywhere
        vers = ((0,),) * cfg.n_blocks     # version 0 written at ts 0
        return self.canon((pts, lines, llc, 0, dram, vers))

    # -- canonicalization ---------------------------------------------------

    def canon(self, state):
        """Normalize hidden fields, GC version prefixes, pick the symmetry
        representative.

        Idempotent.  Invalid lines and owned/DRAM LLC entries carry no
        information, so their fields are zeroed; per block, versions below
        the oldest still-referenced one are dropped and ids renumbered.
        Rules treat all cores and all blocks identically, so states that
        differ only by a core/block relabeling are the same protocol
        situation -- with ``cfg.symmetry`` the lexicographically least
        relabeling represents the orbit.
        """
        state = self._canon_base(state)
        if not self.cfg.symmetry:
            return state
        best = state
        for cp in permutations(range(self.cfg.n_cores)):
            for bp in permutations(range(self.cfg.n_blocks)):
                cand = self._permute(state, cp, bp)
                if cand < best:
                    best = cand
        return best

    def _permute(self, state, cp, bp):
        """Relabel cores by ``cp`` and blocks by ``bp`` (new -> old)."""
        pts, lines, llc, mts, dram, vers = state
        inv = {old: new for new, old in enumerate(cp)}
        pts2 = tuple(pts[c] for c in cp)
        lines2 = tuple(tuple(lines[c][b] for b in bp) for c in cp)
        llc2 = tuple(
            (st, w, r, inv[o] if o >= 0 else -1, v)
            for st, w, r, o, v in (llc[b] for b in bp))
        dram2 = tuple(dram[b] for b in bp)
        vers2 = tuple(vers[b] for b in bp)
        return (pts2, lines2, llc2, mts, dram2, vers2)

    def _canon_base(self, state):
        pts, lines, llc, mts, dram, vers = state
        B = self.cfg.n_blocks
        lo = [0] * B
        new_vers = []
        for a in range(B):
            refs = [lines[i][a][3] for i in range(self.cfg.n_cores)
                    if lines[i][a][0] != INVALID]
            if llc[a][0] == LLC_S:
                refs.append(llc[a][4])
            elif llc[a][0] == LLC_DRAM:
                refs.append(dram[a])
            # llc E: the owner's private line (already counted) is latest
            lo[a] = min(refs) if refs else len(vers[a]) - 1
            new_vers.append(tuple(vers[a][lo[a]:]))
        new_lines = tuple(
            tuple(_line() if ln[0] == INVALID else
                  (ln[0], ln[1], ln[2], ln[3] - lo[a])
                  for a, ln in enumerate(row))
            for row in lines)
        new_llc = []
        new_dram = []
        for a in range(B):
            st, w, r, o, v = llc[a]
            if st == LLC_DRAM:
                new_llc.append((LLC_DRAM, 0, 0, -1, 0))
                new_dram.append(dram[a] - lo[a])
            elif st == LLC_E:
                new_llc.append((LLC_E, 0, 0, o, 0))
                new_dram.append(-1)
            else:
                new_llc.append((LLC_S, w, r, -1, v - lo[a]))
                new_dram.append(-1)
        return (pts, new_lines, tuple(new_llc), mts, tuple(new_dram),
                tuple(new_vers))

    # -- helpers ------------------------------------------------------------

    def max_ts(self, state) -> int:
        pts, lines, llc, mts, dram, vers = state
        m = max(max(pts), mts)
        for row in lines:
            for st, w, r, _ in row:
                if st != INVALID:
                    m = max(m, r)       # wts <= rts on valid lines
        for st, w, r, _, _ in llc:
            if st == LLC_S:
                m = max(m, r)
        for vs in vers:
            m = max(m, vs[-1])
        return m

    def describe(self, state) -> str:
        pts, lines, llc, mts, dram, vers = state
        parts = [f"pts={list(pts)} mts={mts}"]
        for i, row in enumerate(lines):
            cells = [f"{_ST_NAME[st]}(w{w},r{r},v{v})" if st else "I"
                     for st, w, r, v in row]
            parts.append(f"c{i}=[{' '.join(cells)}]")
        cells = []
        for a, (st, w, r, o, v) in enumerate(llc):
            if st == LLC_S:
                cells.append(f"S(w{w},r{r},v{v})")
            elif st == LLC_E:
                cells.append(f"E(own{o})")
            else:
                cells.append(f"DRAM(v{dram[a]})")
        parts.append(f"llc=[{' '.join(cells)}] vers={list(vers)}")
        return " ".join(parts)

    # -- value-timestamp consistency for one observed load ------------------

    def _check_load(self, info: TransitionInfo, vers_a, ver, new_pts,
                    serve_rts):
        """A load at pts must return the version whose [wts, rts] interval
        contains it: the serving version's creation stamp is <= new_pts and,
        if a newer version exists, its creation stamp is strictly above.

        ``cfg.consistency`` waives the checks the weaker memory model does
        not require (the relaxed forbidden-outcome predicates over the same
        enumerated graph; see :class:`Config`).
        """
        model = getattr(self.cfg, "consistency", "sc")
        if not (0 <= ver < len(vers_a)):
            info.violations.append(
                f"{info.rule}: served version id {ver} out of range")
            return
        if vers_a[ver] > new_pts:
            info.violations.append(
                f"{info.rule}: load observed pts {new_pts} below the served "
                f"version's creation wts {vers_a[ver]} (value-ts)")
        if model in ("sc", "tso") and ver + 1 < len(vers_a) \
                and new_pts >= vers_a[ver + 1]:
            info.violations.append(
                f"{info.rule}: load at pts {new_pts} returned a version "
                f"superseded at wts {vers_a[ver + 1]} (value-ts: stale value "
                f"served inside a newer version's validity interval)")
        if model == "sc" and new_pts > serve_rts:
            info.violations.append(
                f"{info.rule}: load consumed pts {new_pts} beyond the "
                f"serving lease end rts {serve_rts}")

    # -- transitions --------------------------------------------------------

    def successors(self, state) -> Iterator[Tuple[object, TransitionInfo]]:
        """Yield (canonical_successor, info) for every enabled rule.

        The rebase rule is *urgent*: once any timestamp reaches the
        2**ts_bits threshold it is the only enabled transition, mirroring
        ``LeaseEngine.maybe_rebase`` running before the next protocol op.
        """
        cfg = self.cfg
        if self.max_ts(state) >= cfg.threshold:
            yield self._rebase(state)
            return
        pts, lines, llc, mts, dram, vers = state
        R = self.rules
        for i in range(cfg.n_cores):
            for a in range(cfg.n_blocks):
                yield from self._core_block_rules(state, i, a)
            if cfg.self_inc:
                info = TransitionInfo("self_inc", core=i,
                                      pts_before=pts[i],
                                      pts_after=pts[i] + 1)
                np_ = pts[:i] + (pts[i] + 1,) + pts[i + 1:]
                yield (self.canon((np_, lines, llc, mts, dram, vers)), info)
        for a in range(cfg.n_blocks):
            st = llc[a][0]
            if st == LLC_S:
                m2 = R.evict_mts(mts, llc[a][2])
                info = TransitionInfo("llc_evict", block=a)
                info.calls.append(("evict_mts", (mts, llc[a][2]), m2))
                llc2 = _replace(llc, a, (LLC_DRAM, 0, 0, -1, 0))
                dram2 = _replace(dram, a, llc[a][4])
                yield (self.canon((pts, lines, llc2, m2, dram2, vers)), info)
            elif st == LLC_E:
                # evicting an owned LLC line flushes the owner first
                j = llc[a][3]
                ost, ow, orr, ov = lines[j][a]
                m2 = R.evict_mts(mts, orr)
                info = TransitionInfo("llc_evict_owned", block=a, core=j)
                info.calls.append(("evict_mts", (mts, orr), m2))
                lines2 = _set_line(lines, j, a, _line())
                llc2 = _replace(llc, a, (LLC_DRAM, 0, 0, -1, 0))
                dram2 = _replace(dram, a, ov)
                yield (self.canon((pts, lines2, llc2, m2, dram2, vers)),
                       info)

    def _core_block_rules(self, state, i, a):
        cfg, R = self.cfg, self.rules
        pts, lines, llc, mts, dram, vers = state
        p = pts[i]
        lst, lw, lr, lv = lines[i][a]
        mst = llc[a][0]
        V = vers[a]

        def out(name, p2, lines2, llc2=llc, mts2=mts, dram2=dram,
                vers2=vers, info=None):
            info = info or TransitionInfo(name)
            info.rule, info.core, info.block = name, i, a
            info.pts_before, info.pts_after = p, p2
            if p2 < p and not info.is_rebase:
                info.violations.append(
                    f"{name}: core {i} pts decreased {p} -> {p2}")
            np_ = pts[:i] + (p2,) + pts[i + 1:]
            return (self.canon((np_, lines2, llc2, mts2, dram2, vers2)),
                    info)

        # ---- Table II: private-cache load hits ----
        if lst == SHARED and not R.shared_expired(p, lr):
            p2 = R.load_hit_shared(p, lw)
            info = TransitionInfo("load_hit_s")
            info.calls.append(("load_hit_shared", (p, lw), p2))
            info.calls.append(("shared_expired", (p, lr), False))
            self._check_load(info, V, lv, p2, lr)
            yield out("load_hit_s", p2, lines, info=info)
        if lst == EXCLUSIVE:
            p2, r2 = R.load_hit_exclusive(p, lw, lr)
            info = TransitionInfo("load_hit_e")
            info.calls.append(("load_hit_exclusive", (p, lw, lr), (p2, r2)))
            self._check_load(info, V, lv, p2, r2)
            lines2 = _set_line(lines, i, a, (EXCLUSIVE, lw, r2, lv))
            yield out("load_hit_e", p2, lines2, info=info)

        # ---- load misses (invalid line, or Shared line whose lease ran
        # out -> renewal attempt), served by the manager (Table III) ----
        miss_load = (lst == INVALID or
                     (lst == SHARED and R.shared_expired(p, lr)))
        if miss_load:
            req_wts = lw if lst == SHARED else -1
            if lst == SHARED:
                exp_calls = [("shared_expired", (p, lr), True)]
            else:
                exp_calls = []
            if mst == LLC_S:
                _, gw, gr, _, gv = llc[a]
                r2 = R.lease_extend(gw, gr, p, cfg.lease)
                p2, _ = R.load_no_cache(p, gw, gr)
                renew = lst == SHARED and R.renewable(lw, gw)
                served = lv if renew else gv
                info = TransitionInfo("load_llc_s")
                info.calls += exp_calls
                info.calls.append(("lease_extend", (gw, gr, p, cfg.lease),
                                   r2))
                info.calls.append(("load_no_cache", (p, gw, gr),
                                   R.load_no_cache(p, gw, gr)))
                if lst == SHARED:
                    info.calls.append(("renewable", (lw, gw), renew))
                info.engine_op = ("read", gw, gr, p, req_wts, r2, p2)
                self._check_load(info, V, served, p2, r2)
                lines2 = _set_line(lines, i, a, (SHARED, gw, r2, served))
                llc2 = _replace(llc, a, (LLC_S, gw, r2, -1, gv))
                yield out("load_llc_s", p2, lines2, llc2, info=info)
            elif mst == LLC_E:
                # WB_REQ: the owner answers with its timestamps, extends
                # the lease per Table II's last column, and downgrades.
                j = llc[a][3]
                if j != i:      # owner's own access is a hit, handled above
                    ost, ow, orr, ov = lines[j][a]
                    wb = R.writeback_rts(ow, orr, p, cfg.lease)
                    p2, _ = R.load_no_cache(p, ow, wb)
                    info = TransitionInfo("load_wb")
                    info.calls += exp_calls
                    info.calls.append(
                        ("writeback_rts", (ow, orr, p, cfg.lease), wb))
                    info.calls.append(("load_no_cache", (p, ow, wb),
                                       R.load_no_cache(p, ow, wb)))
                    self._check_load(info, V, ov, p2, wb)
                    lines2 = _set_line(lines, j, a, (SHARED, ow, wb, ov))
                    lines2 = _set_line(lines2, i, a, (SHARED, ow, wb, ov))
                    llc2 = _replace(llc, a, (LLC_S, ow, wb, -1, ov))
                    yield out("load_wb", p2, lines2, llc2, info=info)
            else:               # LLC miss: DRAM fill at mts
                w0, r0 = R.dram_fill_ts(mts)
                r2 = R.lease_extend(w0, r0, p, cfg.lease)
                p2, _ = R.load_no_cache(p, w0, r0)
                renew = lst == SHARED and R.renewable(lw, w0)
                served = lv if renew else dram[a]
                info = TransitionInfo("load_dram")
                info.calls += exp_calls
                info.calls.append(("dram_fill_ts", (mts,), (w0, r0)))
                info.calls.append(("lease_extend", (w0, r0, p, cfg.lease),
                                   r2))
                info.calls.append(("load_no_cache", (p, w0, r0),
                                   R.load_no_cache(p, w0, r0)))
                self._check_load(info, V, served, p2, r2)
                lines2 = _set_line(lines, i, a, (SHARED, w0, r2, served))
                llc2 = _replace(llc, a, (LLC_S, w0, r2, -1, dram[a]))
                dram2 = _replace(dram, a, -1)
                yield out("load_dram", p2, lines2, llc2, dram2=dram2,
                          info=info)

        # ---- Table II: store hit on an Exclusive line ----
        if lst == EXCLUSIVE:
            if cfg.pw_opt:
                # modified bit is set (E is only reachable by a store
                # here), so repeated stores reuse the version slot
                ts, _, _ = R.store_hit_private(p, lr)
                info = TransitionInfo("store_hit_pw")
                info.calls.append(("store_hit_private", (p, lr),
                                   (ts, ts, ts)))
                if ts < V[lv]:
                    info.violations.append(
                        f"store_hit_pw: restamp {ts} below version "
                        f"creation {V[lv]}")
                vers2 = _replace(vers, a, V[:lv] + (ts,) + V[lv + 1:])
                lines2 = _set_line(lines, i, a, (EXCLUSIVE, ts, ts, lv))
                yield out("store_hit_pw", ts, lines2, vers2=vers2,
                          info=info)
            else:
                ts, _, _ = R.store_hit_exclusive(p, lr)
                info = TransitionInfo("store_hit_e")
                info.calls.append(("store_hit_exclusive", (p, lr),
                                   (ts, ts, ts)))
                if ts <= V[-1]:
                    info.violations.append(
                        f"store_hit_e: new version ts {ts} not above "
                        f"previous creation {V[-1]}")
                vers2 = _replace(vers, a, V + (ts,))
                lines2 = _set_line(lines, i, a,
                                   (EXCLUSIVE, ts, ts, len(V)))
                yield out("store_hit_e", ts, lines2, vers2=vers2,
                          info=info)

        # ---- store misses: acquire exclusive via the manager ----
        if lst != EXCLUSIVE:
            if mst == LLC_S:
                _, gw, gr, _, _ = llc[a]
                ts, _, _ = R.store_no_cache(p, gw, gr)
                info = TransitionInfo("store_llc_s")
                info.calls.append(("store_no_cache", (p, gw, gr),
                                   (ts, ts, ts)))
                if lst == SHARED:   # UPGRADE_REP vs EX_REP: traffic only
                    info.calls.append(("renewable", (lw, gw),
                                       R.renewable(lw, gw)))
                info.engine_op = ("write", gw, gr, p, ts)
                yield from self._store_fill(state, i, a, ts, info)
            elif mst == LLC_E:
                j = llc[a][3]
                if j != i:
                    ost, ow, orr, ov = lines[j][a]
                    ts, _, _ = R.store_no_cache(p, ow, orr)
                    info = TransitionInfo("store_flush")
                    info.calls.append(("store_no_cache", (p, ow, orr),
                                       (ts, ts, ts)))
                    lines2 = _set_line(lines, j, a, _line())
                    yield from self._store_fill(
                        (pts, lines2, llc, mts, dram, vers), i, a, ts, info)
            else:
                w0, r0 = R.dram_fill_ts(mts)
                ts, _, _ = R.store_no_cache(p, w0, r0)
                info = TransitionInfo("store_dram")
                info.calls.append(("dram_fill_ts", (mts,), (w0, r0)))
                info.calls.append(("store_no_cache", (p, w0, r0),
                                   (ts, ts, ts)))
                dram2 = _replace(dram, a, -1)
                yield from self._store_fill(
                    (pts, lines, llc, mts, dram2, vers), i, a, ts, info)

        # ---- silent / writeback evictions of the private line ----
        if lst == SHARED:
            info = TransitionInfo("evict_s")
            lines2 = _set_line(lines, i, a, _line())
            yield out("evict_s", p, lines2, info=info)
        if lst == EXCLUSIVE:
            # FLUSH_REP back to the LLC: timestamps travel with the data
            info = TransitionInfo("evict_e")
            lines2 = _set_line(lines, i, a, _line())
            llc2 = _replace(llc, a, (LLC_S, lw, lr, -1, lv))
            yield out("evict_e", p, lines2, llc2, info=info)

    def _store_fill(self, state, i, a, ts, info):
        """Complete a store miss: new version at ts, requester takes E."""
        pts, lines, llc, mts, dram, vers = state
        V = vers[a]
        info.rule = info.rule or "store"
        if ts <= V[-1]:
            info.violations.append(
                f"{info.rule}: new version ts {ts} not above previous "
                f"creation {V[-1]} (write did not jump the read lease)")
        vers2 = _replace(vers, a, V + (ts,))
        lines2 = _set_line(lines, i, a, (EXCLUSIVE, ts, ts, len(V)))
        llc2 = _replace(llc, a, (LLC_E, 0, 0, i, 0))
        info.core, info.block = i, a
        info.pts_before, info.pts_after = pts[i], ts
        if ts < pts[i]:
            info.violations.append(
                f"{info.rule}: core {i} pts decreased {pts[i]} -> {ts}")
        np_ = pts[:i] + (ts,) + pts[i + 1:]
        yield (self.canon((np_, lines2, llc2, mts, dram, vers2)), info)

    # -- the urgent rebase rule --------------------------------------------

    def _rebase(self, state):
        """Shift every timestamp down by 2**(ts_bits-1), clamping at 0.

        Mirrors the shipped wraparound handling: ``LeaseEngine.maybe_rebase``
        for the manager table, ``timestamps.apply_rebase`` /
        ``DecodeReplica.rebase_kv`` for private lines -- a private Shared
        line whose lease ends below the shift is invalidated rather than
        clamped (clamping could alias its stale version onto the new base).
        """
        cfg = self.cfg
        shift = cfg.shift
        pts, lines, llc, mts, dram, vers = state

        def c(x):
            return max(0, x - shift)

        info = TransitionInfo("rebase", is_rebase=True)
        pts2 = tuple(c(p) for p in pts)
        new_lines = []
        for row in lines:
            nrow = []
            for st, w, r, v in row:
                if st == SHARED and r < shift:
                    nrow.append(_line())          # dropped, not clamped
                elif st == INVALID:
                    nrow.append(_line())
                else:
                    nrow.append((st, c(w), c(r), v))
            new_lines.append(tuple(nrow))
        new_llc = []
        table = []
        for st, w, r, o, v in llc:
            if st == LLC_S:
                new_llc.append((LLC_S, c(w), c(r), -1, v))
                table.append((w, r))
            else:
                new_llc.append((st, 0, 0, o, 0) if st == LLC_E
                               else (LLC_DRAM, 0, 0, -1, 0))
                table.append((0, 0))
        # the engine rebases when its own table crosses the threshold;
        # replay only when this rebase is visible to the manager table
        if any(r >= cfg.threshold for _, r in table):
            info.engine_op = ("rebase", tuple(table), cfg.ts_bits,
                              tuple((c(w), c(r)) for w, r in table))
        vers2 = tuple(tuple(c(x) for x in vs) for vs in vers)
        st2 = (pts2, tuple(new_lines), tuple(new_llc), c(mts), dram, vers2)
        return self.canon(st2), info

    # -- per-state invariants ----------------------------------------------

    def check_state(self, state) -> List[str]:
        """The proof's invariants, checked on one reachable state."""
        cfg = self.cfg
        pts, lines, llc, mts, dram, vers = state
        bad = []
        bound = cfg.threshold + cfg.lease
        if not all(0 <= p <= bound for p in pts) or not 0 <= mts <= bound:
            bad.append(f"timestamp out of bounds [0, {bound}]")
        # Tardis 2.0 lease-horizon: every granted lease end stays within one
        # lease of the system's progress frontier (mts is in the frontier
        # because LLC eviction folds line rts into it).  An over-predicting
        # lease extension rule breaks this on its first grant.
        horizon = max(max(pts), mts) + cfg.lease
        for a in range(cfg.n_blocks):
            V = vers[a]
            latest = len(V) - 1
            if any(V[k] > V[k + 1] for k in range(latest)):
                bad.append(f"block {a}: version stamps not monotone {V}")
            owners = [i for i in range(cfg.n_cores)
                      if lines[i][a][0] == EXCLUSIVE]
            mst, gw, gr, own, gv = llc[a]
            if mst == LLC_E:
                if owners != [own]:
                    bad.append(f"block {a}: llc owner {own} but exclusive "
                               f"lines at cores {owners}")
                elif lines[own][a][3] != latest:
                    bad.append(f"block {a}: owner holds version "
                               f"{lines[own][a][3]}, latest is {latest}")
            else:
                if owners:
                    bad.append(f"block {a}: exclusive lines at {owners} "
                               f"but llc state {_LLC_NAME[mst]}")
                if mst == LLC_S and gv != latest:
                    bad.append(f"block {a}: llc serves version {gv}, "
                               f"latest is {latest}")
                if mst == LLC_DRAM and dram[a] != latest:
                    bad.append(f"block {a}: dram holds version {dram[a]}, "
                               f"latest is {latest}")
            if mst == LLC_S:
                if not gw <= gr:
                    bad.append(f"block {a}: llc wts {gw} > rts {gr}")
                if not (0 <= gw and gr <= bound):
                    bad.append(f"block {a}: llc ts out of bounds")
                if gr > horizon:
                    bad.append(f"block {a}: llc rts {gr} above the lease "
                               f"horizon {horizon} (over-predicted lease "
                               f"extension)")
            for i in range(cfg.n_cores):
                st, w, r, v = lines[i][a]
                if st == INVALID:
                    continue
                if not w <= r:
                    bad.append(f"core {i} block {a}: wts {w} > rts {r}")
                if not (0 <= w and r <= bound):
                    bad.append(f"core {i} block {a}: ts out of bounds")
                if r > horizon:
                    bad.append(f"core {i} block {a}: line rts {r} above the "
                               f"lease horizon {horizon} (over-predicted "
                               f"lease extension)")
                if not 0 <= v <= latest:
                    bad.append(f"core {i} block {a}: version id {v} "
                               f"out of range")
                    continue
                if V[v] > w:
                    bad.append(f"core {i} block {a}: line wts {w} below "
                               f"its version's creation {V[v]}")
                if v < latest and not r < V[v + 1]:
                    bad.append(f"core {i} block {a}: stale version {v} "
                               f"lease rts {r} reaches into successor "
                               f"wts {V[v + 1]}")
                # the manager's lease dominates every Shared copy it issued
                if st == SHARED and mst == LLC_S and v == gv and r > gr:
                    bad.append(f"core {i} block {a}: private rts {r} "
                               f"above manager rts {gr}")
                if st == SHARED and mst == LLC_DRAM and r > mts:
                    bad.append(f"core {i} block {a}: private rts {r} "
                               f"above mts {mts} after llc eviction")
        return bad


def _replace(tup, idx, val):
    return tup[:idx] + (val,) + tup[idx + 1:]


def _set_line(lines, i, a, val):
    return _replace(lines, i, _replace(lines[i], a, val))
