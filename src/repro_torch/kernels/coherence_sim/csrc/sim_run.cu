// K9: the coherence simulator's whole loop in ONE launch (sm_90a).
//
// No Pallas kernel is its counterpart: it replaces the JAX package's
// `jax.lax.while_loop(cond, step, st0)` (repro/core/simulator.py:570),
// whose body is the min-clock scheduler plus one memory transaction under
// Tardis (`tardis_mem`, simulator.py:156-452) or full-map MSI / Ackwise
// (`directory_mem`, directory.py:51-256).  It computes what that loop
// computes -- the same state, bit for bit: int32 arithmetic that wraps,
// float32 stats summed in `_bump`'s order, the JAX index rules (a negative
// core index wraps to n - 1; `%` and `/` floor) -- on the state tensors
// that `core.simulator.init_state` made, in place.
//
// What bounds it: neither bytes nor flops.  Each step is one transaction
// of the core with the smallest clock, and the next step's choice depends
// on this step's result, so a run is a serial chain of steps, and each
// step a chain of dependent loads (the trace entry, the L1 set, the LLC
// set, the owner's L1 set, ...) -- a few L2 round trips a step.  The
// one-warp design does two things about it: the whole loop runs in the
// kernel (no launch and no host round trip between steps), and the parts
// of a step that are wide -- the scheduler's argmin over the cores'
// clocks, the barrier's all-arrived test and release, the directory's
// sharer rows, their invalidations across every core's L1 set and the
// cost sums and maxima over cores, the rebase's kill over a core's L1 --
// are spread over the 32 lanes (core c on lane c % 32) and reduced with
// shuffles.  The scalar chain runs on every lane redundantly (uniform
// branches, broadcast loads, the same value stored by every lane), so no
// lane waits on another's broadcast.  Lanes are not in lockstep, so each
// step is a sequence of read phases and write phases with a __syncwarp()
// between them: no lane writes an entry before every lane has read its
// old value, and no lane reads another lane's write before it is made.
//
// Launch: grid 1, one warp; at most 256 cores (8 a lane).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kPerLane = 8;          // cores a lane holds: n <= 256
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -kIntMax - 1;
enum { INVALID = 0, SHARED = 1, EXCLUSIVE = 2 };
enum { OP_LOAD = 0, OP_STORE = 1, OP_SPIN = 2, OP_BARRIER = 3, OP_END = 4 };

// STAT_KEYS of core/simulator.py, in order
enum {
  ST_OPS_DONE, ST_TRAFFIC, ST_MSGS, ST_RENEW, ST_RENEW_OK, ST_MISSPEC,
  ST_UPGRADE_OK, ST_LLC_REQ, ST_DRAM, ST_TS_INCR, ST_SELFINC, ST_REBASE_L1,
  ST_REBASE_L2, ST_REBASE_INVAL, ST_INV_MSGS, ST_SPIN_POLLS, ST_L1_MISS,
  ST_EVICT_MSGS, ST_EGRANT, kNumStats
};
// CFG_KEYS of kernel.py, in order
enum {
  CF_LEASE, CF_PERIOD, CF_SPEC, CF_OOO_HIDE, CF_PW_OPT, CF_TS_BITS,
  CF_REBASE_L1, CF_REBASE_L2, CF_HOP, CF_LLC_LAT, CF_DRAM_LAT, CF_FLUSH_PEN,
  CF_ACKWISE_K, CF_ESTATE, CF_BACKOFF_CAP, CF_BARRIER_COST, CF_MAX_STEPS,
  kNumCfg
};
// the pointer table kernel.py passes: STATE_KEYS, STAT_KEYS, CFG_KEYS,
// sharers, the log's five arrays and its count
enum {
  P_CLOCK, P_PTS, P_IDX, P_DONE, P_BLOCKED, P_ARRIVED, P_ACC, P_SPIN_ITER,
  P_L1_TAG, P_L1_ST, P_L1_WTS, P_L1_RTS, P_L1_VER, P_L1_DIRTY, P_L1_LRU,
  P_LLC_TAG, P_LLC_ST, P_LLC_WTS, P_LLC_RTS, P_LLC_OWNER, P_LLC_VER,
  P_LLC_DIRTY, P_LLC_LRU, P_LLC_ACC,
  P_MEM_VER, P_MTS, P_STORE_COUNT, P_BTS_L1, P_BTS_LLC, P_MAXTS_L1,
  P_MAXTS_LLC,
  P_OP_TYPE, P_OP_ADDR, P_OP_AUX, P_OP_THINK,
  P_LRU_CLOCK, P_STEPS, P_ABORTED,
  P_STATS,
  P_CFG = P_STATS + kNumStats,
  P_SHARERS = P_CFG + kNumCfg,
  P_LOG,                              // core, kind, addr, ts, ver
  P_LOG_N = P_LOG + 5,
  kNumPtrs
};
constexpr int kNumInts = 9;          // the geometry, as kernel.py lists it

struct State {
  int *clock, *pts, *idx, *acc, *spin_iter;
  uint8_t *done, *blocked, *arrived;
  int *l1_tag, *l1_st, *l1_wts, *l1_rts, *l1_ver, *l1_lru;
  uint8_t* l1_dirty;
  int *llc_tag, *llc_st, *llc_wts, *llc_rts, *llc_owner, *llc_ver, *llc_lru;
  uint8_t *llc_dirty, *llc_acc;
  int *mem_ver, *mts, *store_count, *bts_l1, *bts_llc, *maxts_l1, *maxts_llc;
  const int *op_type, *op_addr, *op_aux, *op_think;
  int *lru_clock, *steps;
  uint8_t* aborted;
  float* stats[kNumStats];
  const int* cfg[kNumCfg];
  uint8_t* sharers;                   // directory only
  int* log[5];
  int* log_n;                         // logging only
  int n, s1, w1, llc_sets, w2, n_addr, trace_len, log_size, grid;
};

struct Cfg {
  int lease, period, spec, ooo_hide, pw_opt, ts_bits, rebase_l1, rebase_l2,
      hop, llc_lat, dram_lat, flush_pen, ackwise_k, estate, backoff_cap,
      barrier_cost, max_steps;
};

// int32 arithmetic that wraps, as the JAX package's int32 does
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
// floor division and modulo (jnp's // and % on int32)
__device__ __forceinline__ int fmod_i(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ int fdiv_i(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
// int32(1) << k as XLA shifts: 0 outside [0, 32)
__device__ __forceinline__ int shl1(int k) {
  return (k >= 0 && k < 32) ? static_cast<int>(1u << k) : 0;
}
__device__ __forceinline__ int hop_dist(int grid, int a, int b) {
  return abs(fmod_i(a, grid) - fmod_i(b, grid))
       + abs(fdiv_i(a, grid) - fdiv_i(b, grid));
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
// stats[k] + 0.0 + float32(v): a zero delta leaves the sum as it is
__device__ __forceinline__ void bump(float& s, int v) {
  if (v != 0) s = __fadd_rn(s, __int2float_rn(v));
}

__device__ __forceinline__ int bank_of(const State& S, int a) {
  return fmod_i(a, S.n);
}
__device__ __forceinline__ int llc_set_of(const State& S, int a) {
  return bank_of(S, a) * S.llc_sets + fmod_i(fdiv_i(a, S.n), S.llc_sets);
}
__device__ __forceinline__ int l1_set_of(const State& S, int a) {
  return fmod_i(a, S.s1);
}
__device__ __forceinline__ int l1_row(const State& S, int c, int set) {
  return (c * S.s1 + set) * S.w1;
}

struct WayPick { bool hit; int way; };

// geometry.pick_way: the first matching valid way, else the first invalid
// way, else the first least-recently-used one
__device__ __forceinline__ WayPick pick_way(const int* tags, const int* sts,
                                            const int* lrus, int W,
                                            int addr) {
  int hit_way = -1, inv_way = -1, lru_way = 0, lru_best = 0;
  for (int w = 0; w < W; ++w) {
    const bool valid = sts[w] != 0;
    if (valid && tags[w] == addr && hit_way < 0) hit_way = w;
    if (!valid && inv_way < 0) inv_way = w;
    const int v = valid ? lrus[w] : kIntMax;
    if (w == 0 || v < lru_best) { lru_best = v; lru_way = w; }
  }
  if (hit_way >= 0) return {true, hit_way};
  return {false, inv_way >= 0 ? inv_way : lru_way};
}

// geometry.pick_llc_victim: invalid > shared-LRU > exclusive-LRU, never
// (short of every way) a line the requester owns
__device__ __forceinline__ int pick_llc_victim(const int* sts,
                                               const int* lrus,
                                               const int* owners, int W,
                                               int requester) {
  int best = 0, best_score = 0;
  for (int w = 0; w < W; ++w) {
    const int s = sts[w];
    if (s == 0) return w;
    const int pen = s == 2 ? (owners[w] == requester ? 1 << 29 : 1 << 20) : 0;
    const int score = wadd(lrus[w], pen);
    if (w == 0 || score < best_score) { best_score = score; best = w; }
  }
  return best;
}

struct Tx { int lat, op_ts, ver; };

// ---------------------------------------------------------------------------
// Tardis transaction (simulator.py:156-452), on every lane
// ---------------------------------------------------------------------------
__device__ __forceinline__ Tx tardis_mem(const State& S, const Cfg& C,
                                         float* stats, int lane, int i,
                                         int addr, bool is_store, int now) {
  const bool is_load = !is_store;
  const int n = S.n;
  const int pts = S.pts[i];

  // ---- L1 lookup ----
  const int set1 = l1_set_of(S, addr);
  const int r1 = l1_row(S, i, set1);
  const WayPick p1 = pick_way(S.l1_tag + r1, S.l1_st + r1, S.l1_lru + r1,
                              S.w1, addr);
  const bool hit1 = p1.hit;
  const int e1 = r1 + p1.way;
  const int line_st = S.l1_st[e1], line_tag = S.l1_tag[e1];
  const int line_wts = S.l1_wts[e1], line_rts = S.l1_rts[e1];
  const int line_ver = S.l1_ver[e1];
  const bool line_dirty = S.l1_dirty[e1] != 0;
  const bool expired = hit1 && line_st == SHARED && pts > line_rts;
  const bool l1_ok = is_store
      ? (hit1 && line_st == EXCLUSIVE)
      : (hit1 && (line_st == EXCLUSIVE
                  || (line_st == SHARED && pts <= line_rts)));
  const bool needs_llc = !l1_ok;
  const bool renewal = needs_llc && is_load && expired;

  bool renew_ok = false, upgrade_ok = false, grant_e = false, missL = false;
  int g_wts = 0, g_rts_raw = 0, g_ver = 0, new_llc_rts = 0;
  int traffic = 0, msgs = 0, lat = 1;
  const int bank = bank_of(S, addr);
  if (needs_llc) {
    // ---- LLC lookup: every read of the pre-step state first ----
    const int rL = llc_set_of(S, addr) * S.w2;
    const WayPick pL = pick_way(S.llc_tag + rL, S.llc_st + rL,
                                S.llc_lru + rL, S.w2, addr);
    const bool hitL = pL.hit;
    const int eL = rL + (hitL ? pL.way
                              : pick_llc_victim(S.llc_st + rL, S.llc_lru + rL,
                                                S.llc_owner + rL, S.w2, i));
    const int L_st = S.llc_st[eL], L_tag = S.llc_tag[eL];
    const int owner = S.llc_owner[eL];
    const int L_wts = S.llc_wts[eL], L_rts = S.llc_rts[eL];
    const int L_ver = S.llc_ver[eL];
    const bool L_dirty = S.llc_dirty[eL] != 0, L_acc = S.llc_acc[eL] != 0;
    const bool owned = hitL && L_st == EXCLUSIVE;
    missL = !hitL;
    grant_e = is_load && C.estate == 1
              && (missL || (L_st == SHARED && !L_acc));
    const bool v_valid = missL && L_st != INVALID;
    const bool v_owned = v_valid && L_st == EXCLUSIVE;
    const int v_owner = v_owned ? owner : 0;
    bool vo_flush = false, vo_dirty = false;
    int vo_e = 0, vo_rts = 0, vo_ver = 0;
    if (v_owned) {
      const int rv = l1_row(S, fmod_i(v_owner, n), l1_set_of(S, L_tag));
      const WayPick pv = pick_way(S.l1_tag + rv, S.l1_st + rv,
                                  S.l1_lru + rv, S.w1, L_tag);
      vo_flush = pv.hit;
      vo_e = rv + pv.way;
      vo_rts = S.l1_rts[vo_e];
      vo_ver = S.l1_ver[vo_e];
      vo_dirty = S.l1_dirty[vo_e] != 0;
    }
    bool o_act = false;
    int o_e = 0, o_wts = 0, o_rts = 0, o_ver = 0;
    if (owned) {
      const int ro = l1_row(S, fmod_i(owner, n), set1);
      const WayPick po = pick_way(S.l1_tag + ro, S.l1_st + ro,
                                  S.l1_lru + ro, S.w1, addr);
      o_act = po.hit;
      o_e = ro + po.way;
      o_wts = S.l1_wts[o_e];
      o_rts = S.l1_rts[o_e];
      o_ver = S.l1_ver[o_e];
    }
    const int mem_ver_addr = S.mem_ver[addr];
    int mts_bank = S.mts[bank];
    __syncwarp();                     // every pre-step read done

    // ---- LLC victim eviction ----
    const int victim_rts = vo_flush ? vo_rts : L_rts;
    const int victim_ver = vo_flush ? vo_ver : L_ver;
    const bool victim_dirty = vo_flush ? (vo_dirty || L_dirty) : L_dirty;
    if (vo_flush) S.l1_st[vo_e] = INVALID;
    if (v_valid && victim_dirty) S.mem_ver[L_tag] = victim_ver;
    if (v_valid) {
      mts_bank = max(mts_bank, victim_rts);
      S.mts[bank] = mts_bank;
    }

    // ---- owner write-back / flush ----
    int wb_rts = 0;
    if (owned)
      wb_rts = max(max(o_rts, wadd(o_wts, C.lease)), wadd(pts, C.lease));
    if (o_act) {
      S.l1_st[o_e] = is_store ? INVALID : SHARED;
      if (is_load) S.l1_rts[o_e] = wb_rts;
    }

    // ---- grant ----
    bool g_dirty;
    if (owned) {
      g_wts = o_wts; g_ver = o_ver; g_dirty = true;
      g_rts_raw = is_load ? wb_rts : o_rts;
    } else if (hitL) {
      g_wts = L_wts; g_rts_raw = L_rts; g_ver = L_ver; g_dirty = L_dirty;
    } else {
      g_wts = g_rts_raw = mts_bank; g_ver = mem_ver_addr; g_dirty = false;
    }
    new_llc_rts = max(max(g_rts_raw, wadd(g_wts, C.lease)),
                      wadd(pts, C.lease));
    renew_ok = renewal && line_wts == g_wts;
    upgrade_ok = is_store && hit1 && line_wts == g_wts && !owned && hitL;

    // ---- LLC line update ----
    const bool excl_grant = is_store || grant_e;
    S.llc_tag[eL] = addr;
    S.llc_st[eL] = excl_grant ? EXCLUSIVE : SHARED;
    S.llc_wts[eL] = g_wts;
    S.llc_rts[eL] = is_load ? new_llc_rts : g_rts_raw;
    S.llc_owner[eL] = excl_grant ? i : -1;
    S.llc_acc[eL] = 1;
    S.llc_ver[eL] = g_ver;
    S.llc_dirty[eL] = g_dirty && is_load;
    S.llc_lru[eL] = now;

    // ---- L1 victim write-back ----
    const bool v1_excl = !hit1 && line_st == EXCLUSIVE;
    bool v1_to_llc = false, v1_to_dram = false;
    int d_ibv1 = 0;
    if (v1_excl) {
      const int rv1 = llc_set_of(S, line_tag) * S.w2;
      const int bankv1 = bank_of(S, line_tag);
      const WayPick pv1 = pick_way(S.llc_tag + rv1, S.llc_st + rv1,
                                   S.llc_lru + rv1, S.w2, line_tag);
      v1_to_llc = pv1.hit;
      v1_to_dram = !pv1.hit;
      d_ibv1 = hop_dist(S.grid, i, bankv1);
      const int mts_v1 = S.mts[bankv1];
      __syncwarp();
      if (v1_to_llc) {
        const int ev1 = rv1 + pv1.way;
        S.llc_st[ev1] = SHARED;
        S.llc_wts[ev1] = line_wts;
        S.llc_rts[ev1] = line_rts;
        S.llc_ver[ev1] = line_ver;
        S.llc_dirty[ev1] = 1;
        S.llc_acc[ev1] = 0;
      } else {
        S.mem_ver[line_tag] = line_ver;
        S.mts[bankv1] = max(mts_v1, line_rts);
      }
    }

    // ---- latency & traffic ----
    const int hop = C.hop;
    const int d_ib = hop_dist(S.grid, i, bank);
    const int d_bo = hop_dist(S.grid, bank, owner);
    const int d_bvo = hop_dist(S.grid, bank, v_owner);
    const int llc_leg = 2 * hop * d_ib + C.llc_lat;
    const int owner_leg = owned ? 2 * hop * d_bo + 1 : 0;
    const int vflush_leg = vo_flush ? 2 * hop * d_bvo + 1 : 0;
    const int dram_leg = missL ? C.dram_lat + vflush_leg : 0;
    const int lat_exposed =
        max(1, wsub(llc_leg + owner_leg + dram_leg, C.ooo_hide));
    if (renewal && renew_ok && C.spec == 1) lat = 1;
    else if (renewal && !renew_ok)
      lat = wadd(lat_exposed, C.spec * C.flush_pen);
    else lat = lat_exposed;
    const int reply = is_load ? (renew_ok ? 1 : 6) : (upgrade_ok ? 1 : 6);
    traffic = (2 + reply) * d_ib;
    if (o_act) traffic += is_load ? (2 + 6) * d_bo : (1 + 6) * d_bo;
    if (missL) traffic += 1 + 5;
    if (v_valid && victim_dirty) traffic += 5;
    if (vo_flush) traffic += (1 + 6) * d_bvo;
    if (v1_to_llc) traffic += 6 * d_ibv1;
    if (v1_to_dram) traffic += 6 * d_ibv1 + 5;
    msgs = 2 + (o_act ? 2 : 0) + (missL ? 2 : 0) + (vo_flush ? 2 : 0)
         + (v1_excl ? 1 : 0) + (v_valid && victim_dirty ? 1 : 0);
  }

  // ---- requester L1 + timestamps (its reads, then its writes) ----
  const int new_ver = is_store ? wadd(S.store_count[addr], 1) : 0;
  const int old_maxts_l1 = S.maxts_l1[i], bts_l1 = S.bts_l1[i];
  const int old_maxts_llc = S.maxts_llc[bank], bts_llc = S.bts_llc[bank];
  __syncwarp();
  const bool pw = C.pw_opt == 1 && line_dirty;
  const int ts_hitE = pw ? max(pts, line_rts) : max(pts, wadd(line_rts, 1));
  const int ts_fill = max(pts, wadd(g_rts_raw, 1));
  const int store_ts = l1_ok ? ts_hitE : ts_fill;
  const bool keep = l1_ok || renew_ok;
  const int load_pts = max(pts, keep ? line_wts : g_wts);
  const int new_pts = is_store ? store_ts : load_pts;
  const int f_st = (is_store || grant_e) ? EXCLUSIVE
                                         : (l1_ok ? line_st : SHARED);
  const int f_wts = is_store ? store_ts : (l1_ok ? line_wts : g_wts);
  int f_rts;
  if (is_store) f_rts = store_ts;
  else if (l1_ok && line_st == EXCLUSIVE) f_rts = max(load_pts, line_rts);
  else if (l1_ok) f_rts = line_rts;
  else if (grant_e) f_rts = max(load_pts, g_rts_raw);
  else f_rts = new_llc_rts;
  const int f_ver = is_store ? new_ver : (keep ? line_ver : g_ver);
  const bool f_dirty = is_store || (keep && line_dirty);
  S.l1_tag[e1] = addr;
  S.l1_st[e1] = f_st;
  S.l1_wts[e1] = f_wts;
  S.l1_rts[e1] = f_rts;
  S.l1_ver[e1] = f_ver;
  S.l1_dirty[e1] = f_dirty;
  S.l1_lru[e1] = now;
  if (is_store) S.store_count[addr] = new_ver;

  // ---- timestamp-compression accounting ----
  const bool use_comp = C.ts_bits > 0;
  const int thr = C.ts_bits >= 0 ? shl1(min(C.ts_bits, 30)) : 0;
  const int maxts_l1 = max(old_maxts_l1, max(f_wts, f_rts));
  S.maxts_l1[i] = maxts_l1;
  bool reb1 = false, reb2 = false;
  int n_kill = 0;
  if (use_comp) {
    const int half = thr / 2;
    reb1 = wsub(maxts_l1, bts_l1) >= thr;
    if (needs_llc) {
      const int m = max(old_maxts_llc, max(g_wts, new_llc_rts));
      S.maxts_llc[bank] = m;
      reb2 = wsub(m, bts_llc) >= thr;
    }
    const int new_bts1 = wadd(bts_l1, half);
    if (reb1) S.bts_l1[i] = new_bts1;
    if (reb2) S.bts_llc[bank] = wadd(bts_llc, half);
    if (reb1) {
      // invalidate long-expired private Shared lines: core i's whole L1,
      // spread over the lanes
      __syncwarp();
      const int base = l1_row(S, i, 0), cnt = S.s1 * S.w1;
      int mine = 0;
      for (int e = lane; e < cnt; e += kLanes) {
        if (S.l1_st[base + e] == SHARED && S.l1_rts[base + e] < new_bts1) {
          S.l1_st[base + e] = INVALID;
          ++mine;
        }
      }
      n_kill = warp_sum(mine);
      __syncwarp();
    }
  } else if (needs_llc) {
    S.maxts_llc[bank] = max(old_maxts_llc, max(g_wts, new_llc_rts));
  }
  lat = wadd(lat, (reb1 ? C.rebase_l1 : 0) + (reb2 ? C.rebase_l2 : 0));

  bump(stats[ST_TRAFFIC], traffic);
  bump(stats[ST_MSGS], msgs);
  bump(stats[ST_RENEW], renewal);
  bump(stats[ST_RENEW_OK], renew_ok);
  bump(stats[ST_MISSPEC], renewal && !renew_ok && C.spec == 1);
  bump(stats[ST_UPGRADE_OK], upgrade_ok);
  bump(stats[ST_LLC_REQ], needs_llc);
  bump(stats[ST_DRAM], missL);
  bump(stats[ST_TS_INCR], wsub(new_pts, pts));
  bump(stats[ST_REBASE_L1], reb1);
  bump(stats[ST_REBASE_L2], reb2);
  bump(stats[ST_REBASE_INVAL], n_kill);
  bump(stats[ST_L1_MISS], needs_llc && !renewal);
  bump(stats[ST_EGRANT], grant_e);
  S.pts[i] = new_pts;
  return {lat, new_pts, f_ver};
}

// ---------------------------------------------------------------------------
// Directory transaction (directory.py:51-256): the wide parts over lanes
// ---------------------------------------------------------------------------

// every L1 way of `set` holding `tag` in the cores whose bits are set
// (bit q of a lane: core lane + 32 q) becomes INVALID
__device__ __forceinline__ void invalidate(const State& S, int lane,
                                           unsigned bits, int set, int tag) {
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int c = lane + kLanes * q;
    if (c < S.n && ((bits >> q) & 1u)) {
      const int r = l1_row(S, c, set);
      for (int w = 0; w < S.w1; ++w)
        if (S.l1_tag[r + w] == tag) S.l1_st[r + w] = INVALID;
    }
  }
  __syncwarp();
}

// _inv_cost: (latency, traffic, messages) of invalidating `bits`' cores
__device__ __forceinline__ void inv_cost(const State& S, const Cfg& C,
                                         int lane, int bank, unsigned bits,
                                         bool bcast, int& lat, int& traf,
                                         int& nmsg) {
  int cnt = 0, dmax = 0, dsum = 0, amax = 0, asum = 0;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int c = lane + kLanes * q;
    if (c < S.n) {
      const int d = hop_dist(S.grid, bank, c);
      amax = max(amax, d);
      asum += 2 * d;
      if ((bits >> q) & 1u) {
        ++cnt;
        dmax = max(dmax, d);
        dsum += 2 * d;
      }
    }
  }
  cnt = warp_sum(cnt);
  if (cnt == 0) { lat = traf = nmsg = 0; return; }
  if (bcast) {
    lat = 2 * C.hop * warp_max(amax) + 1;
    traf = warp_sum(asum);
    nmsg = 2 * S.n;
  } else {
    lat = 2 * C.hop * warp_max(dmax) + 1;
    traf = warp_sum(dsum);
    nmsg = 2 * cnt;
  }
}

__device__ __forceinline__ Tx directory_mem(const State& S, const Cfg& C,
                                            float* stats, int lane, int i,
                                            int addr, bool is_store, int now,
                                            int steps) {
  const bool is_load = !is_store;
  const int n = S.n;

  // ---- L1 lookup ----
  const int set1 = l1_set_of(S, addr);
  const int r1 = l1_row(S, i, set1);
  const WayPick p1 = pick_way(S.l1_tag + r1, S.l1_st + r1, S.l1_lru + r1,
                              S.w1, addr);
  const bool hit1 = p1.hit;
  const int e1 = r1 + p1.way;
  const int line_st = S.l1_st[e1], line_tag = S.l1_tag[e1];
  const int line_ver = S.l1_ver[e1];
  const bool line_dirty = S.l1_dirty[e1] != 0;
  const bool l1_ok = is_store ? (hit1 && line_st == EXCLUSIVE)
                              : (hit1 && line_st != INVALID);
  const bool needs_llc = !l1_ok;
  const bool upgrade = needs_llc && is_store && hit1 && line_st == SHARED;

  int g_ver = 0, traffic = 0, msgs = 0, inv_msgs = 0, lat = 1;
  bool missL = false, v1_valid = false;
  if (needs_llc) {
    // ---- LLC / directory lookup: the pre-step reads first ----
    const int bank = bank_of(S, addr);
    const int rL = llc_set_of(S, addr) * S.w2;
    const WayPick pL = pick_way(S.llc_tag + rL, S.llc_st + rL,
                                S.llc_lru + rL, S.w2, addr);
    const bool hitL = pL.hit;
    const int eL = rL + (hitL ? pL.way
                              : pick_llc_victim(S.llc_st + rL, S.llc_lru + rL,
                                                S.llc_owner + rL, S.w2, i));
    const int L_st = S.llc_st[eL], L_tag = S.llc_tag[eL];
    const int owner = S.llc_owner[eL], L_ver = S.llc_ver[eL];
    const bool L_dirty = S.llc_dirty[eL] != 0;
    uint8_t* const sh_row = S.sharers + static_cast<size_t>(eL) * n;
    unsigned L_bits = 0;              // this lane's cores of the sharer row
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + kLanes * q;
      if (c < n && sh_row[c]) L_bits |= 1u << q;
    }
    const bool owned = hitL && L_st == EXCLUSIVE;
    missL = !hitL;
    const bool v_valid = missL && L_st != INVALID;
    const bool v_owned = v_valid && L_st == EXCLUSIVE;
    const int v_owner = v_owned ? owner : 0;
    const int vset1 = l1_set_of(S, L_tag);
    bool vo_flush = false, vo_dirty = false;
    int vo_e = 0, vo_ver = 0;
    if (v_owned) {
      const int rv = l1_row(S, fmod_i(v_owner, n), vset1);
      const WayPick pv = pick_way(S.l1_tag + rv, S.l1_st + rv,
                                  S.l1_lru + rv, S.w1, L_tag);
      vo_flush = pv.hit;
      vo_e = rv + pv.way;
      vo_ver = S.l1_ver[vo_e];
      vo_dirty = S.l1_dirty[vo_e] != 0;
    }
    bool o_act = false;
    int o_e = 0, o_ver = 0;
    if (owned) {
      const int ro = l1_row(S, fmod_i(owner, n), set1);
      const WayPick po = pick_way(S.l1_tag + ro, S.l1_st + ro,
                                  S.l1_lru + ro, S.w1, addr);
      o_act = po.hit;
      o_e = ro + po.way;
      o_ver = S.l1_ver[o_e];
    }
    const int mem_ver_addr = S.mem_ver[addr];
    const int owner_core = fmod_i(owner, n);
    __syncwarp();                     // every pre-step read done

    // ---- LLC victim eviction: invalidate its sharers ----
    int v_lat = 0, v_traf = 0, v_msgs = 0;
    if (v_valid && !v_owned) {
      invalidate(S, lane, L_bits, vset1, L_tag);
      const int cnt = warp_sum(__popc(L_bits));
      inv_cost(S, C, lane, bank, L_bits, C.ackwise_k > 0 && cnt > C.ackwise_k,
               v_lat, v_traf, v_msgs);
    }
    if (vo_flush) S.l1_st[vo_e] = INVALID;
    const int victim_ver = vo_flush ? vo_ver : L_ver;
    const bool victim_dirty = vo_flush ? (vo_dirty || L_dirty) : L_dirty;
    if (v_valid && victim_dirty) S.mem_ver[L_tag] = victim_ver;

    // ---- owner downgrade / flush ----
    if (o_act) S.l1_st[o_e] = is_store ? INVALID : SHARED;

    // ---- invalidate sharers on GETX ----
    int s_lat = 0, s_traf = 0, s_msgs = 0;
    if (is_store && hitL && !owned) {
      unsigned others = L_bits;
      if ((i & (kLanes - 1)) == lane) others &= ~(1u << (i / kLanes));
      invalidate(S, lane, others, set1, addr);
      const int cnt = warp_sum(__popc(others));
      inv_cost(S, C, lane, bank, others, C.ackwise_k > 0 && cnt > C.ackwise_k,
               s_lat, s_traf, s_msgs);
    }

    // ---- grant ----
    g_ver = owned ? o_ver : (hitL ? L_ver : mem_ver_addr);

    // ---- directory entry update ----
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + kLanes * q;
      if (c < n) {
        bool v = false;
        if (is_load) {
          if (owned) v = c == owner_core;
          else if (hitL) v = (L_bits >> q) & 1u;
          v = v || c == i;
        }
        sh_row[c] = v;
      }
    }
    __syncwarp();
    S.llc_tag[eL] = addr;
    S.llc_st[eL] = is_store ? EXCLUSIVE : SHARED;
    S.llc_owner[eL] = is_store ? i : -1;
    S.llc_ver[eL] = g_ver;
    S.llc_dirty[eL] = (owned || (hitL && L_dirty)) && is_load;
    S.llc_lru[eL] = now;

    // ---- L1 victim (PUTS / PUTX) ----
    v1_valid = !hit1 && line_st != INVALID;
    const bool v1_excl = v1_valid && line_st == EXCLUSIVE;
    const bool v1_shared = v1_valid && line_st == SHARED;
    bool v1_hit = false;
    int d_ibv1 = 0;
    if (v1_valid) {
      const int rv1 = llc_set_of(S, line_tag) * S.w2;
      d_ibv1 = hop_dist(S.grid, i, bank_of(S, line_tag));
      const WayPick pv1 = pick_way(S.llc_tag + rv1, S.llc_st + rv1,
                                   S.llc_lru + rv1, S.w2, line_tag);
      v1_hit = pv1.hit;
      const int ev1 = rv1 + pv1.way;
      __syncwarp();
      if (v1_hit && v1_shared)
        S.sharers[static_cast<size_t>(ev1) * n + i] = 0;
      if (v1_hit && v1_excl) {
        S.llc_st[ev1] = SHARED;
        S.llc_ver[ev1] = line_ver;
        S.llc_dirty[ev1] = 1;
        __syncwarp();
        uint8_t* const row = S.sharers + static_cast<size_t>(ev1) * n;
        for (int c = lane; c < n; c += kLanes) row[c] = 0;
        __syncwarp();
      }
      if (v1_excl && !v1_hit) S.mem_ver[line_tag] = line_ver;
    }

    // ---- latency & traffic ----
    const int hop = C.hop;
    const int d_ib = hop_dist(S.grid, i, bank);
    const int d_bo = hop_dist(S.grid, bank, owner);
    const int d_bvo = hop_dist(S.grid, bank, v_owner);
    const int llc_leg = 2 * hop * d_ib + C.llc_lat;
    const int owner_leg = o_act ? 2 * hop * d_bo + 1 : 0;
    const int vflush_leg = vo_flush ? 2 * hop * d_bvo + 1 : 0;
    const int dram_leg = missL ? C.dram_lat + vflush_leg + v_lat : 0;
    lat = max(1, wsub(llc_leg + owner_leg + dram_leg + s_lat, C.ooo_hide));
    const int reply = (upgrade && !owned) ? 1 : 5;
    traffic = (1 + reply) * d_ib;
    if (o_act) traffic += (1 + 5) * d_bo;
    traffic += s_traf + v_traf;
    if (missL) traffic += 1 + 5;
    if (v_valid && victim_dirty) traffic += 5;
    if (vo_flush) traffic += (1 + 5) * d_bvo;
    if (v1_hit && v1_shared) traffic += 1 * d_ibv1;          // PUTS
    if (v1_excl) traffic += 5 * d_ibv1;                      // PUTX
    inv_msgs = s_msgs + v_msgs;
    msgs = 2 + (o_act ? 2 : 0) + (missL ? 2 : 0) + (vo_flush ? 2 : 0)
         + (v1_valid ? 1 : 0) + inv_msgs;
  }

  // ---- requester L1 ----
  int f_st, f_ver;
  bool f_dirty;
  if (is_store) {
    f_st = EXCLUSIVE;
    f_dirty = true;
    f_ver = wadd(S.store_count[addr], 1);
    __syncwarp();
  } else {
    f_st = l1_ok ? line_st : SHARED;
    f_ver = l1_ok ? line_ver : g_ver;
    f_dirty = l1_ok && line_dirty;
  }
  S.l1_tag[e1] = addr;
  S.l1_st[e1] = f_st;
  S.l1_ver[e1] = f_ver;
  S.l1_dirty[e1] = f_dirty;
  S.l1_lru[e1] = now;
  if (is_store) S.store_count[addr] = f_ver;

  bump(stats[ST_TRAFFIC], traffic);
  bump(stats[ST_MSGS], msgs);
  bump(stats[ST_LLC_REQ], needs_llc);
  bump(stats[ST_DRAM], missL);
  bump(stats[ST_INV_MSGS], inv_msgs);
  bump(stats[ST_L1_MISS], needs_llc);
  bump(stats[ST_EVICT_MSGS], v1_valid);
  return {lat, steps, f_ver};
}

// ---------------------------------------------------------------------------
// The loop (simulator.py:455-573): cond, then the scheduler's step
// ---------------------------------------------------------------------------
template <bool kDirectory>
__global__ void __launch_bounds__(kLanes, 1) sim_run_kernel(State S) {
  const int lane = threadIdx.x;
  const int n = S.n;
  Cfg C;
  {
    int v[kNumCfg];
#pragma unroll
    for (int k = 0; k < kNumCfg; ++k) v[k] = *S.cfg[k];
    C = Cfg{v[CF_LEASE], v[CF_PERIOD], v[CF_SPEC], v[CF_OOO_HIDE],
            v[CF_PW_OPT], v[CF_TS_BITS], v[CF_REBASE_L1], v[CF_REBASE_L2],
            v[CF_HOP], v[CF_LLC_LAT], v[CF_DRAM_LAT], v[CF_FLUSH_PEN],
            v[CF_ACKWISE_K], v[CF_ESTATE], v[CF_BACKOFF_CAP],
            v[CF_BARRIER_COST], v[CF_MAX_STEPS]};
  }
  float stats[kNumStats];
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) stats[k] = *S.stats[k];
  int lru_clock = *S.lru_clock, steps = *S.steps;
  bool aborted = *S.aborted != 0;
  int log_n = S.log_size ? *S.log_n : 0;
  int n_done = 0;
  for (int c = lane; c < n; c += kLanes) n_done += S.done[c] != 0;
  n_done = warp_sum(n_done);
  const int trace_last = S.trace_len - 1;

  while (n_done < n && steps < C.max_steps) {
    // ---- scheduler: argmin of the runnable cores' clocks, lowest id ----
    int best_v = kIntMax, best_c = kIntMax;
    bool any_run = false;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + kLanes * q;
      if (c < n) {
        const bool run = !S.done[c] && !S.blocked[c];
        any_run |= run;
        const int v = run ? S.clock[c] : kIntMax;
        if (v < best_v || (v == best_v && c < best_c)) {
          best_v = v;
          best_c = c;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const int ov = __shfl_xor_sync(kFull, best_v, o);
      const int oc = __shfl_xor_sync(kFull, best_c, o);
      if (ov < best_v || (ov == best_v && oc < best_c)) {
        best_v = ov;
        best_c = oc;
      }
    }
    const bool none_runnable = !__any_sync(kFull, any_run);
    const bool live = !none_runnable;
    const int i = best_c;
    const int idx_i = S.idx[i];
    const int te = i * S.trace_len + min(max(idx_i, 0), trace_last);
    const int ty = S.op_type[te];
    const int addr = min(max(S.op_addr[te], 0), S.n_addr - 1);
    const int aux = S.op_aux[te];
    const int think = S.op_think[te];
    const bool is_end = ty == OP_END || none_runnable;
    const bool is_barrier = ty == OP_BARRIER && live;
    const bool is_spin = ty == OP_SPIN && live;
    const bool is_store = ty == OP_STORE && live;
    const bool is_mem = (ty == OP_LOAD || ty == OP_STORE || ty == OP_SPIN)
                        && live;
    const int now = wadd(lru_clock, 1);
    const int clock_i = S.clock[i];
    Tx tx{0, 0, 0};
    if (is_mem) {
      tx = kDirectory
          ? directory_mem(S, C, stats, lane, i, addr, is_store, now, steps)
          : tardis_mem(S, C, stats, lane, i, addr, is_store, now);
    }

    // ---- spin backoff, self-increment, clock / idx advance ----
    const bool spin_fail = is_spin && !(tx.ver >= aux);
    const int spin_iter = S.spin_iter[i];
    const int acc_i = S.acc[i], pts_i = S.pts[i];
    __syncwarp();                     // the step's reads done
    const int backoff = min(C.backoff_cap, shl1(min(spin_iter, 8)));
    S.spin_iter[i] = spin_fail ? wadd(spin_iter, 1) : 0;
    const int credit = (is_mem ? 1 : 0) + (spin_fail ? backoff : 0);
    const int acc1 = wadd(acc_i, credit);
    const int period = max(C.period, 1);
    const int n_inc = fdiv_i(acc1, period);
    const bool selfinc = is_mem && n_inc > 0;
    S.acc[i] = selfinc ? fmod_i(acc1, period) : acc1;
    if (selfinc) S.pts[i] = wadd(pts_i, n_inc);
    S.clock[i] = wadd(wadd(clock_i, think),
                      wadd(is_mem ? tx.lat : 0, spin_fail ? backoff : 0));
    const bool advance = (is_mem && !spin_fail) || is_end;
    if (advance && live) S.idx[i] = wadd(idx_i, 1);
    if (is_end && live) {             // a live step's core is not done
      S.done[i] = 1;
      ++n_done;
    }
    if (none_runnable) {
      for (int c = lane; c < n; c += kLanes) S.done[c] = 1;
      n_done = n;
    }

    // ---- barrier: all arrived (or done) -> release ----
    if (is_barrier) {
      S.arrived[i] = 1;
      S.blocked[i] = 1;
      __syncwarp();
      bool all = true;
      int rel = kIntMin;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int c = lane + kLanes * q;
        if (c < n) {
          const bool a = S.arrived[c] != 0;
          all = all && (a || S.done[c]);
          rel = max(rel, a ? S.clock[c] : 0);
        }
      }
      if (__all_sync(kFull, all)) {
        rel = wadd(warp_max(rel), C.barrier_cost);
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + kLanes * q;
          if (c < n) {
            if (S.arrived[c]) {
              S.clock[c] = rel;
              S.idx[c] = wadd(S.idx[c], 1);
            }
            S.blocked[c] = 0;
            S.arrived[c] = 0;
          }
        }
      }
    }

    bump(stats[ST_OPS_DONE], advance && is_mem);
    bump(stats[ST_SELFINC], selfinc ? n_inc : 0);
    bump(stats[ST_TS_INCR], selfinc ? n_inc : 0);
    bump(stats[ST_SPIN_POLLS], is_spin);
    steps = wadd(steps, 1);
    lru_clock = now;
    aborted = aborted || none_runnable;
    if (S.log_size && is_mem && log_n < S.log_size) {
      const int w = max(log_n, 0);
      S.log[0][w] = i;
      S.log[1][w] = is_store ? 1 : 0;
      S.log[2][w] = addr;
      S.log[3][w] = tx.op_ts;
      S.log[4][w] = tx.ver;
      ++log_n;
    }
    __syncwarp();
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kNumStats; ++k) *S.stats[k] = stats[k];
    *S.lru_clock = lru_clock;
    *S.steps = steps;
    *S.aborted = aborted;
    if (S.log_size) *S.log_n = log_n;
  }
}

// one thread follows i = nxt[i] through L2 (ld.global.cg): a chain of
// dependent L2 round trips, the probe that bounds K9's step
__global__ void l2_chase_kernel(const int* nxt, int hops, int* out) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = __ldcg(nxt + i);
  *out = i;
}

}  // namespace

extern "C" int tardis_sim_run(void* ptr_table, int n_ptrs, void* int_table,
                              int n_ints, int directory, void* stream) {
  if (n_ptrs != kNumPtrs || n_ints != kNumInts) return cudaErrorInvalidValue;
  void** p = static_cast<void**>(ptr_table);
  const int* g = static_cast<const int*>(int_table);
  auto I = [&](int k) { return static_cast<int*>(p[k]); };
  auto B = [&](int k) { return static_cast<uint8_t*>(p[k]); };
  State S;
  S.clock = I(P_CLOCK); S.pts = I(P_PTS); S.idx = I(P_IDX);
  S.done = B(P_DONE); S.blocked = B(P_BLOCKED); S.arrived = B(P_ARRIVED);
  S.acc = I(P_ACC); S.spin_iter = I(P_SPIN_ITER);
  S.l1_tag = I(P_L1_TAG); S.l1_st = I(P_L1_ST); S.l1_wts = I(P_L1_WTS);
  S.l1_rts = I(P_L1_RTS); S.l1_ver = I(P_L1_VER); S.l1_dirty = B(P_L1_DIRTY);
  S.l1_lru = I(P_L1_LRU);
  S.llc_tag = I(P_LLC_TAG); S.llc_st = I(P_LLC_ST); S.llc_wts = I(P_LLC_WTS);
  S.llc_rts = I(P_LLC_RTS); S.llc_owner = I(P_LLC_OWNER);
  S.llc_ver = I(P_LLC_VER); S.llc_dirty = B(P_LLC_DIRTY);
  S.llc_lru = I(P_LLC_LRU); S.llc_acc = B(P_LLC_ACC);
  S.mem_ver = I(P_MEM_VER); S.mts = I(P_MTS); S.store_count = I(P_STORE_COUNT);
  S.bts_l1 = I(P_BTS_L1); S.bts_llc = I(P_BTS_LLC);
  S.maxts_l1 = I(P_MAXTS_L1); S.maxts_llc = I(P_MAXTS_LLC);
  S.op_type = I(P_OP_TYPE); S.op_addr = I(P_OP_ADDR);
  S.op_aux = I(P_OP_AUX); S.op_think = I(P_OP_THINK);
  S.lru_clock = I(P_LRU_CLOCK); S.steps = I(P_STEPS);
  S.aborted = B(P_ABORTED);
  for (int k = 0; k < kNumStats; ++k)
    S.stats[k] = static_cast<float*>(p[P_STATS + k]);
  for (int k = 0; k < kNumCfg; ++k) S.cfg[k] = I(P_CFG + k);
  S.sharers = B(P_SHARERS);
  for (int k = 0; k < 5; ++k) S.log[k] = I(P_LOG + k);
  S.log_n = I(P_LOG_N);
  S.n = g[0]; S.s1 = g[1]; S.w1 = g[2]; S.llc_sets = g[3]; S.w2 = g[4];
  S.n_addr = g[5]; S.trace_len = g[6]; S.log_size = g[7]; S.grid = g[8];
  if (S.n < 1 || S.n > kLanes * kPerLane || (directory && !S.sharers)
      || (S.log_size && !S.log_n))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (directory) sim_run_kernel<true><<<1, kLanes, 0, s>>>(S);
  else sim_run_kernel<false><<<1, kLanes, 0, s>>>(S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tardis_l2_chase(const void* nxt, int hops, void* out,
                               void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), hops, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
