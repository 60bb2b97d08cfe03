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
// step a chain of dependent loads.  One warp runs the loop (no launch and
// no host round trip between steps); the wide parts of a step -- the
// scheduler's argmin over the cores' clocks, the barrier's all-arrived
// test and release, the directory's sharer rows, their invalidations
// across every core's L1 set and the cost sums and maxima over cores, the
// rebase's kill over a core's L1 -- are spread over the 32 lanes (core c
// on lane c % 32) and reduced across them.  The scalar chain runs on
// every lane redundantly (uniform branches, the same value stored by
// every lane), so no lane waits on another's broadcast.
//
// What this design does about the chain.  The first design kept every
// array in global memory: ~15 dependent L2 round trips a step.  Measured
// with clock64() between phases, the step is as much a chain of dependent
// instructions -- integer divisions, warp reductions, syncs, a load used
// at once -- as of loads, so both are cut:
//  * The run's hot state lives in shared memory for the whole launch:
//    the core arrays, the per-core timestamps, each core's next trace op,
//    a table of the cores' mesh coordinates and -- the `smem` variant,
//    where they fit -- the L1 arrays.  They are copied in at the start
//    (cp.async) and back out to the same tensors at the end.  The
//    `global` variant (fig8's 256 cores: 819 KB of L1) keeps the L1 in
//    global memory.
//  * The scheduler's keys (run ? clock : INT_MAX) live in the registers
//    of the core's lane, updated where a step or a barrier release
//    changes them; the argmin is two __reduce_min_sync (the clock, then
//    the lowest tied core id).
//  * The trace is read ahead: each core's next op sits in a shared-memory
//    slot.  When a step advances its core's idx, the op after it is
//    loaded into registers, untouched until it lands in the slot a step
//    later (a barrier release reloads its cores' slots at once).
//  * A set lookup is one wave: lanes 0 .. W-1 each load every field of
//    one way, the way is picked by ballots and min-reductions in
//    `pick_way`'s / `pick_llc_victim`'s exact order, and its fields are
//    shuffled to every lane.  An LLC request is ONE wave of independent
//    global loads: its set (lanes 0 .. W2-1; under the directory with the
//    set's sharer rows, turned into bitmasks only where used), the L1
//    victim's set (lanes W2 .. 2 W2-1) and mem_ver[addr].  It is issued
//    once the L1 lookup has missed: issued before the lookup, whatever it
//    found, it overlapped an LLC request's round trip with the lookup but
//    cost the steps that hit in L1 more (scripts/k9_variants.py).
//  * The run's divisors (n, s1, llc_sets, the mesh width) divide by a
//    shift and a mask where they are powers of two; hop distances read
//    the coordinate table and are computed only where they are used;
//    the self-increment divides only when the credit reaches a period.
// Lanes are not in lockstep, so each step is a sequence of read phases
// and write phases with a __syncwarp() between them (it orders shared
// memory too): no lane writes an entry before every lane has read its old
// value, and no lane reads another lane's write before it is made.  What
// every lane writes alike it reads back as it wrote it, so a step needs
// no sync at its end: its first writes follow a sync of its own.  Merged
// phases: the end-of-step read phase (spin_iter, acc, pts) and the
// requester's timestamp reads join the step's first read phase (the
// transaction writes none of them; it returns the new pts); the L1
// victim's write-back needs no sync of its own (its entry is neither
// read nor written before it; its mts max is idempotent).
//
// Launch: grid 1, one warp, the state's shared memory (smem_bytes) as
// opt-in dynamic shared memory; at most 256 cores (8 a lane), at most 32
// L1 ways and 16 LLC ways.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kPerLane = 8;          // cores a lane holds: n <= 256
constexpr int kMaxW1 = kLanes;       // an L1 set is one wave
constexpr int kMaxW2 = kLanes / 2;   // an LLC request's two sets are one
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

// a divisor of the run (n, s1, llc_sets, grid): a power of two divides by
// a shift and a mask (floor semantics for negative operands too), any
// other by fmod_i / fdiv_i
struct Div { int d, sh; bool p2; };

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
  // shared memory only: each core's next op (type, address, aux, think)
  // and its mesh coordinates (x | y << 16)
  int *sl_ty, *sl_addr, *sl_aux, *sl_think, *xy;
  int n, s1, w1, llc_sets, w2, n_addr, trace_len, log_size, grid;
  Div dn, ds1, dllc, dgrid;
};

// The shared-memory layout, each array rounded up to 16 bytes: the
// kCoreInts int arrays of n (clock, pts, idx, acc, spin_iter, mts, bts_l1,
// bts_llc, maxts_l1, maxts_llc, the four op slots, xy), then (the `smem`
// variant) the six int L1 arrays of e = n * s1 * w1 entries, then the
// byte arrays done, blocked, arrived and (smem) l1_dirty.  kernel.py's
// smem_bytes repeats this sum.
constexpr int kCoreInts = 15;
__host__ __device__ __forceinline__ int round16(int b) {
  return (b + 15) & ~15;
}
__host__ __device__ __forceinline__ int smem_bytes(int n, int e, bool l1) {
  return kCoreInts * round16(4 * n) + 3 * round16(n)
       + (l1 ? 6 * round16(4 * e) + round16(e) : 0);
}

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
__device__ __forceinline__ Div make_div(int d) {
  const bool p2 = d > 0 && (d & (d - 1)) == 0;
  return {d, p2 ? __ffs(d) - 1 : 0, p2};
}
__device__ __forceinline__ int fmod_d(int a, const Div& D) {
  return D.p2 ? (a & (D.d - 1)) : fmod_i(a, D.d);
}
__device__ __forceinline__ int fdiv_d(int a, const Div& D) {
  return D.p2 ? (a >> D.sh) : fdiv_i(a, D.d);
}
// int32(1) << k as XLA shifts: 0 outside [0, 32)
__device__ __forceinline__ int shl1(int k) {
  return (k >= 0 && k < 32) ? static_cast<int>(1u << k) : 0;
}
__device__ __forceinline__ int hop_xy(int a, int b) {
  return abs((a & 0xffff) - (b & 0xffff)) + abs((a >> 16) - (b >> 16));
}
// mesh distance: the coordinate table for cores, the floor arithmetic for
// anything else (an unowned line's owner -1)
__device__ __forceinline__ int hop(const State& S, int a, int b) {
  if (static_cast<unsigned>(a) < static_cast<unsigned>(S.n)
      && static_cast<unsigned>(b) < static_cast<unsigned>(S.n))
    return hop_xy(S.xy[a], S.xy[b]);
  return abs(fmod_d(a, S.dgrid) - fmod_d(b, S.dgrid))
       + abs(fdiv_d(a, S.dgrid) - fdiv_d(b, S.dgrid));
}
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(kFull, v);
}
// stats[k] + 0.0 + float32(v): a zero delta leaves the sum as it is
__device__ __forceinline__ void bump(float& s, int v) {
  if (v != 0) s = __fadd_rn(s, __int2float_rn(v));
}
__device__ __forceinline__ void bump(float& s, bool b) {
  if (b) s = __fadd_rn(s, 1.0f);
}

__device__ __forceinline__ int bank_of(const State& S, int a) {
  return fmod_d(a, S.dn);
}
__device__ __forceinline__ int llc_set_of(const State& S, int a) {
  return bank_of(S, a) * S.llc_sets + fmod_d(fdiv_d(a, S.dn), S.dllc);
}
__device__ __forceinline__ int l1_set_of(const State& S, int a) {
  return fmod_d(a, S.ds1);
}
__device__ __forceinline__ int l1_row(const State& S, int c, int set) {
  return (c * S.s1 + set) * S.w1;
}

// ---- bulk copies between the state's tensors and shared memory ----------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// global -> shared, asynchronously where the source is 16-byte aligned
// (the destination always is); the caller waits with cp_async_wait_all
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        int nbytes, int lane) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    for (int b = 16 * lane; b < nbytes; b += 16 * kLanes)
      cp_async16(d + b, s + b, min(16, nbytes - b));
  } else {
    for (int b = lane; b < nbytes; b += kLanes) d[b] = s[b];
  }
}
// shared -> global, 16 bytes a store where the destination is aligned
__device__ __forceinline__ void copy_out(void* dst, const void* src,
                                         int nbytes, int lane) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  int b0 = 0;
  if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    b0 = nbytes & ~15;
    for (int b = 16 * lane; b < b0; b += 16 * kLanes)
      *reinterpret_cast<uint4*>(d + b) =
          *reinterpret_cast<const uint4*>(s + b);
  }
  for (int b = b0 + lane; b < nbytes; b += kLanes) d[b] = s[b];
}

// ---- the next op of a core ----------------------------------------------
struct Op { int ty, addr, aux, think; };   // addr as the trace holds it

// the op at idx (clamped to the trace), its address as the trace holds
// it: nothing waits for the loads until the op is used
__device__ __forceinline__ Op load_op(const State& S, int c, int idx) {
  const int te = c * S.trace_len + min(max(idx, 0), S.trace_len - 1);
  return {__ldg(S.op_type + te), __ldg(S.op_addr + te), __ldg(S.op_aux + te),
          __ldg(S.op_think + te)};
}
__device__ __forceinline__ void put_slot(const State& S, int c, const Op& o) {
  S.sl_ty[c] = o.ty;
  S.sl_addr[c] = o.addr;
  S.sl_aux[c] = o.aux;
  S.sl_think[c] = o.think;
}

// ---- set lookups, one wave each -----------------------------------------
struct WayPick { bool hit; int way; };

// geometry.pick_way over lanes 0 .. W-1 (lane w holds way w): the first
// matching valid way, else the first invalid way, else the first
// least-recently-used one
__device__ __forceinline__ WayPick pick_way(int lane, int W, bool valid,
                                            bool match, int lru) {
  const bool in = lane < W;
  const unsigned hit = __ballot_sync(kFull, in && valid && match);
  if (hit) return {true, __ffs(hit) - 1};
  const unsigned inv = __ballot_sync(kFull, in && !valid);
  if (inv) return {false, __ffs(inv) - 1};
  const int v = in ? lru : kIntMax;
  const int m = __reduce_min_sync(kFull, v);
  return {false, __ffs(__ballot_sync(kFull, in && v == m)) - 1};
}

// geometry.pick_llc_victim over lanes 0 .. W-1: invalid > shared-LRU >
// exclusive-LRU, never (short of every way) a line the requester owns
__device__ __forceinline__ int pick_llc_victim(int lane, int W, int st,
                                               int lru, int owner,
                                               int requester) {
  const bool in = lane < W;
  const unsigned inv = __ballot_sync(kFull, in && st == INVALID);
  if (inv) return __ffs(inv) - 1;
  const int pen = st == EXCLUSIVE ? (owner == requester ? 1 << 29 : 1 << 20)
                                  : 0;
  const int v = in ? wadd(lru, pen) : kIntMax;
  const int m = __reduce_min_sync(kFull, v);
  return __ffs(__ballot_sync(kFull, in && v == m)) - 1;
}

// one L1 way's fields; the dirty byte as loaded (a load is consumed only
// where its value is used, so a wave's loads stay in flight)
struct Line { int tag, st, wts, rts, ver, lru, dirty; };

// lane w < W1 loads way w of the L1 row at entry r; the other lanes load
// its last way (no branch: the picks and shuffles read lanes < W1 only)
__device__ __forceinline__ Line load_l1_way(const State& S, int r,
                                            int lane) {
  const int e = r + min(lane, S.w1 - 1);
  return {S.l1_tag[e], S.l1_st[e], S.l1_wts[e], S.l1_rts[e], S.l1_ver[e],
          S.l1_lru[e], S.l1_dirty[e]};
}
__device__ __forceinline__ Line shfl_line(const Line& l, int w) {
  return {__shfl_sync(kFull, l.tag, w), __shfl_sync(kFull, l.st, w),
          __shfl_sync(kFull, l.wts, w), __shfl_sync(kFull, l.rts, w),
          __shfl_sync(kFull, l.ver, w), __shfl_sync(kFull, l.lru, w),
          __shfl_sync(kFull, l.dirty, w)};
}
// pick_way over the L1 row of core c's set `set` for `tag`: (entry, hit,
// that way's fields on every lane)
struct L1Pick { int e; bool hit; Line line; };
__device__ __forceinline__ L1Pick l1_lookup(const State& S, int lane, int c,
                                            int set, int tag) {
  const int r = l1_row(S, c, set);
  const Line mine = load_l1_way(S, r, lane);
  const WayPick p = pick_way(lane, S.w1, mine.st != INVALID, mine.tag == tag,
                             mine.lru);
  return {r + p.way, p.hit, shfl_line(mine, p.way)};
}

// one LLC way's fields, its dirty and accessed bytes as loaded
struct LlcWay { int tag, st, lru, owner, wts, rts, ver, dirty, acc; };

// lanes lo .. lo+W2-1 load way `lane - lo` of the LLC set at entry r (an
// invalid way elsewhere, and everywhere for r < 0)
__device__ __forceinline__ LlcWay load_llc_way(const State& S, int lane,
                                               int lo, int r) {
  LlcWay l{-1, INVALID, kIntMax, -1, 0, 0, 0, 0, 0};
  if (r >= 0 && lane >= lo && lane < lo + S.w2) {
    const int e = r + lane - lo;
    l = {S.llc_tag[e], S.llc_st[e], S.llc_lru[e], S.llc_owner[e],
         S.llc_wts[e], S.llc_rts[e], S.llc_ver[e], S.llc_dirty[e],
         S.llc_acc[e]};
  }
  return l;
}
// The sharer rows of the LLC set at entry rL, way `lane` on lanes
// 0 .. W2-1.  Where n is a multiple of 16, load_sharer_rows issues 16-byte
// loads that nothing waits for; sharer_words turns them (or, for other n,
// the row's bytes) into bitmasks: bit j of words[q] the sharer bit of core
// 32 q + j.
struct SharerRows { uint4 v[kPerLane][2]; };
__device__ __forceinline__ void load_sharer_rows(const State& S, int lane,
                                                 int rL, SharerRows& raw) {
  const int n = S.n;
  if ((n & 15) != 0 || lane >= S.w2) return;
  const uint8_t* row = S.sharers + static_cast<size_t>(rL + lane) * n;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (32 * q + 16 * k < n)
        raw.v[q][k] = *reinterpret_cast<const uint4*>(row + 32 * q + 16 * k);
}
__device__ __forceinline__ void sharer_words(const State& S, int lane,
                                             int rL, const SharerRows& raw,
                                             unsigned (&words)[kPerLane]) {
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) words[q] = 0;
  if (lane >= S.w2) return;
  const int n = S.n;
  if ((n & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (32 * q + 16 * k < n) {
          const uint4 v = raw.v[q][k];
          const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const unsigned nib = (x[u] & 1u) | ((x[u] >> 7) & 2u)
                               | ((x[u] >> 14) & 4u) | ((x[u] >> 21) & 8u);
            words[q] |= nib << (16 * k + 4 * u);
          }
        }
      }
    }
  } else {
    const uint8_t* row = S.sharers + static_cast<size_t>(rL + lane) * n;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      for (int j = 0; j < 32 && 32 * q + j < n; ++j)
        words[q] |= static_cast<unsigned>(row[32 * q + j] != 0) << j;
  }
}
__device__ __forceinline__ LlcWay shfl_llc(const LlcWay& l, int w) {
  return {__shfl_sync(kFull, l.tag, w),   __shfl_sync(kFull, l.st, w),
          __shfl_sync(kFull, l.lru, w),   __shfl_sync(kFull, l.owner, w),
          __shfl_sync(kFull, l.wts, w),   __shfl_sync(kFull, l.rts, w),
          __shfl_sync(kFull, l.ver, w), __shfl_sync(kFull, l.dirty, w),
          __shfl_sync(kFull, l.acc, w)};
}
// the L1 victim's LLC hit, from lanes W2 .. 2 W2-1 of the wave, as
// pick_way sees the set AFTER this request's update of entry eL (whose tag
// becomes the requested address, never the victim's: a valid L1 way that
// held it would have been a hit): -1 for a miss, else the entry
__device__ __forceinline__ int victim_llc_hit(const State& S, int lane,
                                              int rV, const LlcWay& l,
                                              int tag, int eL) {
  const int w2 = S.w2;
  const bool in = lane >= w2 && lane < 2 * w2;
  const unsigned hit = __ballot_sync(
      kFull, in && l.st != INVALID && l.tag == tag && rV + lane - w2 != eL);
  return hit ? rV + __ffs(hit) - 1 - w2 : -1;
}

struct Tx { int lat, op_ts, ver, pts; };

// ---------------------------------------------------------------------------
// Tardis transaction (simulator.py:156-452), on every lane
// ---------------------------------------------------------------------------
__device__ __forceinline__ Tx tardis_mem(const State& S, const Cfg& C,
                                         float* stats, int lane, int i,
                                         int addr, bool is_store, int now) {
  const bool is_load = !is_store;
  const int n = S.n;
  const int bank = bank_of(S, addr);
  // the requester's reads, issued with the L1 lookup
  const int sc_addr = is_store ? S.store_count[addr] : 0;
  const int pts = S.pts[i];
  const int old_maxts_l1 = S.maxts_l1[i], bts_l1 = S.bts_l1[i];
  const int old_maxts_llc = S.maxts_llc[bank], bts_llc = S.bts_llc[bank];

  // ---- L1 lookup ----
  const int set1 = l1_set_of(S, addr);
  const L1Pick p1 = l1_lookup(S, lane, i, set1, addr);
  const bool hit1 = p1.hit;
  const int e1 = p1.e;
  const int line_st = p1.line.st, line_tag = p1.line.tag;
  const int line_wts = p1.line.wts, line_rts = p1.line.rts;
  const int line_ver = p1.line.ver;
  const bool line_dirty = p1.line.dirty != 0;
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
  if (needs_llc) {
    // ---- LLC lookup: one wave of independent loads -- the set (lanes
    // 0 .. W2-1), the L1 victim's set (lanes W2 .. 2 W2-1), the address's
    // DRAM version ----
    const bool v1_excl = !hit1 && line_st == EXCLUSIVE;
    const int rL = llc_set_of(S, addr) * S.w2;
    const int rV = v1_excl ? llc_set_of(S, line_tag) * S.w2 : -1;
    const LlcWay mine = load_llc_way(S, lane, 0, rL);
    const LlcWay vway = load_llc_way(S, lane, S.w2, rV);
    const int mem_ver_addr = S.mem_ver[addr];
    const WayPick pL = pick_way(lane, S.w2, mine.st != INVALID,
                                mine.tag == addr, mine.lru);
    const bool hitL = pL.hit;
    const int wL = hitL ? pL.way
                        : pick_llc_victim(lane, S.w2, mine.st, mine.lru,
                                          mine.owner, i);
    const int eL = rL + wL;
    const LlcWay L = shfl_llc(mine, wL);
    const int L_st = L.st, L_tag = L.tag, owner = L.owner;
    const int L_wts = L.wts, L_rts = L.rts, L_ver = L.ver;
    const bool L_dirty = L.dirty != 0, L_acc = L.acc != 0;
    const bool owned = hitL && L_st == EXCLUSIVE;
    missL = !hitL;
    grant_e = is_load && C.estate == 1
              && (missL || (L_st == SHARED && !L_acc));
    const bool v_valid = missL && L_st != INVALID;
    const bool v_owned = v_valid && L_st == EXCLUSIVE;
    const int v_owner = v_owned ? owner : 0;
    // the owner's (owned) or the victim owner's (v_owned) L1 way: at most
    // one of the two, hit and miss exclusive
    bool vo_flush = false, vo_dirty = false, o_act = false;
    int vo_e = 0, vo_rts = 0, vo_ver = 0;
    int o_e = 0, o_wts = 0, o_rts = 0, o_ver = 0;
    if (owned || v_owned) {
      const L1Pick po = owned
          ? l1_lookup(S, lane, fmod_d(owner, S.dn), set1, addr)
          : l1_lookup(S, lane, fmod_d(v_owner, S.dn), l1_set_of(S, L_tag),
                      L_tag);
      if (owned) {
        o_act = po.hit;
        o_e = po.e;
        o_wts = po.line.wts;
        o_rts = po.line.rts;
        o_ver = po.line.ver;
      } else {
        vo_flush = po.hit;
        vo_e = po.e;
        vo_rts = po.line.rts;
        vo_ver = po.line.ver;
        vo_dirty = po.line.dirty != 0;
      }
    }
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
    bool v1_to_llc = false, v1_to_dram = false;
    int d_ibv1 = 0;
    if (v1_excl) {
      const int ev1 = victim_llc_hit(S, lane, rV, vway, line_tag, eL);
      const int bankv1 = bank_of(S, line_tag);
      v1_to_llc = ev1 >= 0;
      v1_to_dram = !v1_to_llc;
      d_ibv1 = hop(S, i, bankv1);
      // no sync: a lane that reads mts[bankv1] after another's max below
      // computes the same max
      const int mts_v1 = S.mts[bankv1];
      if (v1_to_llc) {
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
    const int hop_c = C.hop;
    const int d_ib = hop(S, i, bank);
    const int d_bo = owned ? hop(S, bank, owner) : 0;
    const int d_bvo = vo_flush ? hop(S, bank, v_owner) : 0;
    const int llc_leg = 2 * hop_c * d_ib + C.llc_lat;
    const int owner_leg = owned ? 2 * hop_c * d_bo + 1 : 0;
    const int vflush_leg = vo_flush ? 2 * hop_c * d_bvo + 1 : 0;
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

  // ---- requester L1 + timestamps (their reads were the step's first) ----
  const int new_ver = is_store ? wadd(sc_addr, 1) : 0;
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
      int killed = 0;
      for (int e = lane; e < cnt; e += kLanes) {
        if (S.l1_st[base + e] == SHARED && S.l1_rts[base + e] < new_bts1) {
          S.l1_st[base + e] = INVALID;
          ++killed;
        }
      }
      n_kill = warp_sum(killed);
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
  return {lat, new_pts, f_ver, new_pts};
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
  const int xy_bank = S.xy[bank];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int c = lane + kLanes * q;
    if (c < S.n) {
      const int d = hop_xy(xy_bank, S.xy[c]);
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
                                            int steps, int pts) {
  const bool is_load = !is_store;
  const int n = S.n;
  const int bank = bank_of(S, addr);
  // the store counter, issued with the L1 lookup
  const int sc_addr = is_store ? S.store_count[addr] : 0;

  // ---- L1 lookup ----
  const int set1 = l1_set_of(S, addr);
  const L1Pick p1 = l1_lookup(S, lane, i, set1, addr);
  const bool hit1 = p1.hit;
  const int e1 = p1.e;
  const int line_st = p1.line.st, line_tag = p1.line.tag;
  const int line_ver = p1.line.ver;
  const bool line_dirty = p1.line.dirty != 0;
  const bool l1_ok = is_store ? (hit1 && line_st == EXCLUSIVE)
                              : (hit1 && line_st != INVALID);
  const bool needs_llc = !l1_ok;
  const bool upgrade = needs_llc && is_store && hit1 && line_st == SHARED;

  int g_ver = 0, traffic = 0, msgs = 0, inv_msgs = 0, lat = 1;
  bool missL = false, v1_valid = false;
  if (needs_llc) {
    // ---- LLC / directory lookup: one wave of independent loads -- the
    // set and its sharer rows (lanes 0 .. W2-1), the L1 victim's set
    // (lanes W2 .. 2 W2-1), the address's DRAM version ----
    v1_valid = !hit1 && line_st != INVALID;
    const int rL = llc_set_of(S, addr) * S.w2;
    const int rV = v1_valid ? llc_set_of(S, line_tag) * S.w2 : -1;
    const LlcWay mine = load_llc_way(S, lane, 0, rL);
    SharerRows raw;
    load_sharer_rows(S, lane, rL, raw);
    const LlcWay vway = load_llc_way(S, lane, S.w2, rV);
    const int mem_ver_addr = S.mem_ver[addr];
    const WayPick pL = pick_way(lane, S.w2, mine.st != INVALID,
                                mine.tag == addr, mine.lru);
    const bool hitL = pL.hit;
    const int wL = hitL ? pL.way
                        : pick_llc_victim(lane, S.w2, mine.st, mine.lru,
                                          mine.owner, i);
    const int eL = rL + wL;
    const LlcWay L = shfl_llc(mine, wL);
    const int L_st = L.st, L_tag = L.tag, owner = L.owner, L_ver = L.ver;
    const bool L_dirty = L.dirty != 0;
    uint8_t* const sh_row = S.sharers + static_cast<size_t>(eL) * n;
    unsigned words[kPerLane];
    sharer_words(S, lane, rL, raw, words);
    unsigned L_bits = 0;              // this lane's cores of the sharer row
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (kLanes * q < n) {
        const unsigned w = __shfl_sync(kFull, words[q], wL);
        L_bits |= ((w >> lane) & 1u) << q;
      }
    }
    const bool owned = hitL && L_st == EXCLUSIVE;
    missL = !hitL;
    const bool v_valid = missL && L_st != INVALID;
    const bool v_owned = v_valid && L_st == EXCLUSIVE;
    const int v_owner = v_owned ? owner : 0;
    const int vset1 = l1_set_of(S, L_tag);
    bool vo_flush = false, vo_dirty = false, o_act = false;
    int vo_e = 0, vo_ver = 0, o_e = 0, o_ver = 0;
    if (owned || v_owned) {
      const L1Pick po = owned
          ? l1_lookup(S, lane, fmod_d(owner, S.dn), set1, addr)
          : l1_lookup(S, lane, fmod_d(v_owner, S.dn), vset1, L_tag);
      if (owned) {
        o_act = po.hit;
        o_e = po.e;
        o_ver = po.line.ver;
      } else {
        vo_flush = po.hit;
        vo_e = po.e;
        vo_ver = po.line.ver;
        vo_dirty = po.line.dirty != 0;
      }
    }
    const int owner_core = fmod_d(owner, S.dn);
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
    const bool v1_excl = v1_valid && line_st == EXCLUSIVE;
    const bool v1_shared = v1_valid && line_st == SHARED;
    bool v1_hit = false;
    int d_ibv1 = 0;
    if (v1_valid) {
      const int ev1 = victim_llc_hit(S, lane, rV, vway, line_tag, eL);
      d_ibv1 = hop(S, i, bank_of(S, line_tag));
      v1_hit = ev1 >= 0;
      // ev1 != eL: these entries were neither read nor written before
      if (v1_hit && v1_shared)
        S.sharers[static_cast<size_t>(ev1) * n + i] = 0;
      if (v1_hit && v1_excl) {
        S.llc_st[ev1] = SHARED;
        S.llc_ver[ev1] = line_ver;
        S.llc_dirty[ev1] = 1;
        uint8_t* const row = S.sharers + static_cast<size_t>(ev1) * n;
        for (int c = lane; c < n; c += kLanes) row[c] = 0;
        __syncwarp();                 // the row's bytes, by every lane
      }
      if (v1_excl && !v1_hit) S.mem_ver[line_tag] = line_ver;
    }

    // ---- latency & traffic ----
    const int hop_c = C.hop;
    const int d_ib = hop(S, i, bank);
    const int d_bo = o_act ? hop(S, bank, owner) : 0;
    const int d_bvo = vo_flush ? hop(S, bank, v_owner) : 0;
    const int llc_leg = 2 * hop_c * d_ib + C.llc_lat;
    const int owner_leg = o_act ? 2 * hop_c * d_bo + 1 : 0;
    const int vflush_leg = vo_flush ? 2 * hop_c * d_bvo + 1 : 0;
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

  // ---- requester L1 (the store counter was read with the L1 lookup) ----
  int f_st, f_ver;
  bool f_dirty;
  if (is_store) {
    f_st = EXCLUSIVE;
    f_dirty = true;
    f_ver = wadd(sc_addr, 1);
  } else {
    f_st = l1_ok ? line_st : SHARED;
    f_ver = l1_ok ? line_ver : g_ver;
    f_dirty = l1_ok && line_dirty;
  }
  __syncwarp();
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
  return {lat, steps, f_ver, pts};
}

// ---------------------------------------------------------------------------
// The loop (simulator.py:455-573): cond, then the scheduler's step
// ---------------------------------------------------------------------------
template <bool kDirectory, bool kSmemL1>
__global__ void __launch_bounds__(kLanes, 1) sim_run_kernel(State G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int n = G.n;
  const int e1_count = n * G.s1 * G.w1;

  // ---- the hot state into shared memory (G keeps the tensors) ----
  State S = G;
  S.dn = make_div(n);
  S.ds1 = make_div(S.s1);
  S.dllc = make_div(S.llc_sets);
  S.dgrid = make_div(S.grid);
  unsigned char* p = smem;
  auto ints = [&](int count) {
    int* r = reinterpret_cast<int*>(p);
    p += round16(4 * count);
    return r;
  };
  auto bytes = [&](int count) {
    uint8_t* r = reinterpret_cast<uint8_t*>(p);
    p += round16(count);
    return r;
  };
  S.clock = ints(n); S.pts = ints(n); S.idx = ints(n); S.acc = ints(n);
  S.spin_iter = ints(n); S.mts = ints(n); S.bts_l1 = ints(n);
  S.bts_llc = ints(n); S.maxts_l1 = ints(n); S.maxts_llc = ints(n);
  S.sl_ty = ints(n); S.sl_addr = ints(n); S.sl_aux = ints(n);
  S.sl_think = ints(n); S.xy = ints(n);
  if (kSmemL1) {
    S.l1_tag = ints(e1_count); S.l1_st = ints(e1_count);
    S.l1_wts = ints(e1_count); S.l1_rts = ints(e1_count);
    S.l1_ver = ints(e1_count); S.l1_lru = ints(e1_count);
  }
  S.done = bytes(n); S.blocked = bytes(n); S.arrived = bytes(n);
  if (kSmemL1) S.l1_dirty = bytes(e1_count);
  // the arrays that live in shared memory, (shared, global, bytes)
  struct Pair { void* s; void* g; int nb; };
  const Pair pairs[] = {
      {S.clock, G.clock, 4 * n}, {S.pts, G.pts, 4 * n},
      {S.idx, G.idx, 4 * n}, {S.acc, G.acc, 4 * n},
      {S.spin_iter, G.spin_iter, 4 * n}, {S.mts, G.mts, 4 * n},
      {S.bts_l1, G.bts_l1, 4 * n}, {S.bts_llc, G.bts_llc, 4 * n},
      {S.maxts_l1, G.maxts_l1, 4 * n}, {S.maxts_llc, G.maxts_llc, 4 * n},
      {S.done, G.done, n}, {S.blocked, G.blocked, n},
      {S.arrived, G.arrived, n},
      {S.l1_tag, G.l1_tag, kSmemL1 ? 4 * e1_count : 0},
      {S.l1_st, G.l1_st, kSmemL1 ? 4 * e1_count : 0},
      {S.l1_wts, G.l1_wts, kSmemL1 ? 4 * e1_count : 0},
      {S.l1_rts, G.l1_rts, kSmemL1 ? 4 * e1_count : 0},
      {S.l1_ver, G.l1_ver, kSmemL1 ? 4 * e1_count : 0},
      {S.l1_lru, G.l1_lru, kSmemL1 ? 4 * e1_count : 0},
      {S.l1_dirty, G.l1_dirty, kSmemL1 ? e1_count : 0}};
  constexpr int kPairs = sizeof(pairs) / sizeof(pairs[0]);
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
    copy_in(pairs[k].s, pairs[k].g, pairs[k].nb, lane);
  for (int c = lane; c < n; c += kLanes)
    S.xy[c] = fmod_d(c, S.dgrid) | (fdiv_d(c, S.dgrid) << 16);
  cp_async_wait_all();
  __syncwarp();
  for (int c = lane; c < n; c += kLanes)
    put_slot(S, c, load_op(S, c, S.idx[c]));

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
  // the scheduler's keys of this lane's cores (core lane + 32 q) in
  // registers: run ? clock : INT_MAX, bit q of `run` whether it may run
  int key[kPerLane];
  unsigned run = 0;
  auto refresh_keys = [&]() {
    run = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + kLanes * q;
      const bool r = c < n && !S.done[c] && !S.blocked[c];
      key[q] = r ? S.clock[c] : kIntMax;
      run |= static_cast<unsigned>(r) << q;
    }
  };
  refresh_keys();
  __syncwarp();
  const int n_q = (n + kLanes - 1) / kLanes;   // a lane's core slots in use
  const int period = max(C.period, 1);
  int pend_c = -1;                    // the core whose slot is in flight
  Op pend{0, 0, 0, 0};

  while (n_done < n && steps < C.max_steps) {
    // ---- scheduler: argmin of the runnable cores' clocks, lowest id ----
    int best_v = kIntMax, best_c = kIntMax;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (q >= n_q) break;
      const int c = lane + kLanes * q;
      if (c < n && (key[q] < best_v || (key[q] == best_v && c < best_c))) {
        best_v = key[q];
        best_c = c;
      }
    }
    const int min_v = __reduce_min_sync(kFull, best_v);
    const int i = __reduce_min_sync(kFull, best_v == min_v ? best_c
                                                           : kIntMax);
    const bool none_runnable = !__any_sync(kFull, run != 0);
    const bool live = !none_runnable;
    const Op op = i == pend_c ? pend
                              : Op{S.sl_ty[i], S.sl_addr[i], S.sl_aux[i],
                                   S.sl_think[i]};
    const int ty = op.ty, aux = op.aux, think = op.think;
    const int addr = min(max(op.addr, 0), S.n_addr - 1);
    const bool is_end = ty == OP_END || none_runnable;
    const bool is_barrier = ty == OP_BARRIER && live;
    const bool is_spin = ty == OP_SPIN && live;
    const bool is_store = ty == OP_STORE && live;
    const bool is_mem = (ty == OP_LOAD || ty == OP_STORE || ty == OP_SPIN)
                        && live;
    const int now = wadd(lru_clock, 1);
    // the step's own reads of core i (the end-of-step read phase, merged)
    const int clock_i = S.clock[i], idx_i = S.idx[i];
    const int spin_iter = S.spin_iter[i], acc_i = S.acc[i];
    const int pts_i = S.pts[i];
    Tx tx{0, 0, 0, pts_i};
    if (is_mem) {
      tx = kDirectory
          ? directory_mem(S, C, stats, lane, i, addr, is_store, now, steps,
                          pts_i)
          : tardis_mem(S, C, stats, lane, i, addr, is_store, now);
    } else {
      __syncwarp();                   // the step's reads done
    }

    // ---- spin backoff, self-increment, clock / idx advance ----
    const bool spin_fail = is_spin && !(tx.ver >= aux);
    const int backoff = min(C.backoff_cap, shl1(min(spin_iter, 8)));
    S.spin_iter[i] = spin_fail ? wadd(spin_iter, 1) : 0;
    const int credit = (is_mem ? 1 : 0) + (spin_fail ? backoff : 0);
    const int acc1 = wadd(acc_i, credit);
    // acc1 / period and acc1 % period, floor; no division while
    // 0 <= acc1 < period
    int n_inc = 0, acc_mod = acc1;
    if (acc1 < 0 || acc1 >= period) {
      n_inc = fdiv_i(acc1, period);
      acc_mod = fmod_i(acc1, period);
    }
    const bool selfinc = is_mem && n_inc > 0;
    S.acc[i] = selfinc ? acc_mod : acc1;
    S.pts[i] = selfinc ? wadd(tx.pts, n_inc) : tx.pts;
    const int clock_new = wadd(wadd(clock_i, think),
                               wadd(is_mem ? tx.lat : 0,
                                    spin_fail ? backoff : 0));
    S.clock[i] = clock_new;
    const bool advance = (is_mem && !spin_fail) || is_end;
    if (advance && live) S.idx[i] = wadd(idx_i, 1);
    if (is_end && live) {             // a live step's core is not done
      S.done[i] = 1;
      ++n_done;
    }
    if (none_runnable) {
      for (int c = lane; c < n; c += kLanes) S.done[c] = 1;
      n_done = n;
      run = 0;
    } else {                          // core i's key, on its lane
      const bool r = !is_end && !is_barrier;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        if (q >= n_q) break;
        if (i == lane + kLanes * q) {
          key[q] = r ? clock_new : kIntMax;
          run = r ? run | (1u << q) : run & ~(1u << q);
        }
      }
    }
    // ---- the trace read ahead: the slot in flight lands, core i's next
    // op is loaded (it lands a step later) ----
    if (pend_c >= 0) put_slot(S, pend_c, pend);
    if (advance && live) {
      pend = load_op(S, i, wadd(idx_i, 1));
      pend_c = i;
    } else {
      pend_c = -1;
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
              const int nx = wadd(S.idx[c], 1);
              S.clock[c] = rel;
              S.idx[c] = nx;
              put_slot(S, c, load_op(S, c, nx));
            }
            S.blocked[c] = 0;
            S.arrived[c] = 0;
          }
        }
        refresh_keys();
        __syncwarp();                 // the released cores' rows, by lane
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
    // no sync here: a step's every write follows a sync of that step, and
    // what a step writes on every lane alike, each lane reads as it wrote
    // it; writes made by one lane (a barrier release, invalidations, the
    // rebase's kill, sharer rows) are followed by a sync where they are
  }
  __syncwarp();

  // ---- the state back to its tensors ----
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
    copy_out(pairs[k].g, pairs[k].s, pairs[k].nb, lane);
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
// dependent L2 round trips, the probe that bounds K9's LLC requests
__global__ void l2_chase_kernel(const int* nxt, int hops, int* out) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = __ldcg(nxt + i);
  *out = i;
}

// one thread copies the cycle nxt (n entries) into shared memory and
// follows i = nxt[i] there: a chain of dependent shared-memory round
// trips, the probe that bounds K9's steps
__global__ void smem_chase_kernel(const int* nxt, int n, int hops, int* out) {
  extern __shared__ int cyc[];
  for (int k = 0; k < n; ++k) cyc[k] = nxt[k];
  int i = 0;
  for (int h = 0; h < hops; ++h) i = cyc[i];
  *out = i;
}

template <bool kDirectory, bool kSmemL1>
int launch_sim(const State& S, int bytes, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      sim_run_kernel<kDirectory, kSmemL1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  sim_run_kernel<kDirectory, kSmemL1><<<1, kLanes, bytes, s>>>(S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 1 = the L1 arrays in shared memory, 0 = in global memory;
// smem: the shared-memory bytes the wrapper counted for it (checked)
extern "C" int tardis_sim_run(void* ptr_table, int n_ptrs, void* int_table,
                              int n_ints, int directory, int variant,
                              int smem, void* stream) {
  if (n_ptrs != kNumPtrs || n_ints != kNumInts) return cudaErrorInvalidValue;
  void** p = static_cast<void**>(ptr_table);
  const int* g = static_cast<const int*>(int_table);
  auto I = [&](int k) { return static_cast<int*>(p[k]); };
  auto B = [&](int k) { return static_cast<uint8_t*>(p[k]); };
  State S{};
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
  if (S.n < 1 || S.n > kLanes * kPerLane || S.w1 < 1 || S.w1 > kMaxW1
      || S.w2 < 1 || S.w2 > kMaxW2 || S.trace_len < 1
      || (directory && !S.sharers) || (S.log_size && !S.log_n)
      || (variant != 0 && variant != 1))
    return cudaErrorInvalidValue;
  const int bytes = smem_bytes(S.n, S.n * S.s1 * S.w1, variant == 1);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes != smem || bytes > limit) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (directory)
    return variant ? launch_sim<true, true>(S, bytes, s)
                   : launch_sim<true, false>(S, bytes, s);
  return variant ? launch_sim<false, true>(S, bytes, s)
                 : launch_sim<false, false>(S, bytes, s);
}

extern "C" int tardis_l2_chase(const void* nxt, int hops, void* out,
                               void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), hops, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tardis_smem_chase(const void* nxt, int n, int hops, void* out,
                                 void* stream) {
  const int bytes = 4 * n;
  const cudaError_t e = cudaFuncSetAttribute(
      smem_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_chase_kernel<<<1, 1, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), n, hops, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
