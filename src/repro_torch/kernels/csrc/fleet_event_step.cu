// Hopper (sm_90a) kernel of the fleet engine: F <= 8 function pools under
// one shared cluster capacity, with optional bounded FIFO queues.
//
// Replaces the TPU kernel repro/kernels/faas_event_step.py::_fleet_kernel
// (launched by fleet_sweep_pallas through _pallas_fleet_rows) for its base
// path, the gap and prestamped stream modes, queue_depth > 0 and platform
// faults.  A fleet
// (one what-if cell x one replica) is F functions, each with its own pool
// of M instance slots, its keep-alive threshold and its concurrency limit;
// cold starts of every function contend for ncl live instances in all.
// The fleet runs the K events of one merged arrival stream (times or
// gaps, the acting function's id, its warm and cold service samples).
// Per event, in this order:
//   1. every pool integrates running and idle instance-time over the
//      interval clipped to [skip, t_end];
//   2. every pool expires its instances with busy + t_exp <= t_new (a tie
//      expires);
//   3. with queues, up to Q drain passes serve the acting function's queue
//      head (only while the event lies inside the horizon): warm on the
//      newest idle instance, else cold under the function's limit, a free
//      slot and the cluster capacity; a pass that serves nothing leaves
//      the state unchanged, so draining stops at the first such pass;
//   4. the acting function routes the arrival: warm on the newest idle
//      instance (lowest slot on a creation tie), else cold when its live
//      count is below its limit, it has a free slot and the fleet-wide
//      live count is below ncl, else the queue if it has room, else reject;
//   5. peak = max(peak, fleet-wide live count), on every event.
// Counters engage past skip (overflow only needs the horizon).  The acc
// columns per function are the reference's FLEET_ACC_COLS: cold, warm,
// reject, run, idle, cold response, warm response, overflow, arrivals,
// enqueued, queue-served, queue wait, peak.
//
// Platform faults (FAULT, not with queues): the fault path of
// faas_event_step.cu, per function pool, without reliability.  Each slot
// carries a crash clock (doom, +inf until a cold start stamps t_new +
// (-log(1 - u) / crash_rate) from the event's crash uniform, read through
// `stream` like the samples); step 1 stops at min(hi, doom), step 2 exits
// at min(expiry, doom) and counts a crash (doom < expiry, skip < doom <=
// t_end) for the dying instance's function.  Between steps 2 and 4, with a
// capacity profile (per fleet, a leading 0 edge implied), ceil(fleet live
// count - ceiling) of the newest idle instances fleet-wide are evicted
// inside the horizon (creation, then the lower flat id f*M + m on a tie),
// counted past skip for the evicted instance's function; step 4's cold
// start also needs the fleet's live count below the ceiling, and an
// arrival whose instance dies before its service ends is interrupted.  The
// three fault columns (crashes, evictions, interrupted attempts) follow
// the 13.  The crash clocks come out as doom[N, F, M]: +inf where no cold
// start stamped one, else the last stamped, live or not.  With crashes off
// the clocks hold +inf, which leaves the mins the identity; without FAULT
// the code is the path without faults.
//
// What the TPU kernel's layout was, and why this one differs: the TPU
// kernel makes a fleet an 8-row block, one row per function, and its
// launcher copies the merged stream into every row of every block (8 rows
// x every cell of a sweep).  Here a fleet reads its replica's stream once,
// through the per-fleet row index `stream`, so a sweep's cells share one
// [replicas, K] stream; fids travel as uint8.
//
// What bounds it on this card: operations, in a sequential chain per
// fleet.  Each event needs the two integrals and the exit test on every
// live instance of the fleet, the idle and newest tests on the acting
// function's live instances, and O(1) scalar work, against 13 bytes of
// stream per event read once for every cell that shares it: ~25
// operations per byte at the catalog sweep (F = 8, M = 64, ~23 live
// instances of 512 slots), above the H100's f32 balance point.  The first
// design walked all F*M slots per event (16 a lane, ~4.6% live) and ran
// seven warp collectives on each: 221x its bound, in two waves.
//
// What the design does about that: one warp per fleet, and per-event work
// only where the event changes something.
//   - The slots are an alive bitmap, one unsigned a lane (function g's
//     slot m is bit g*SF + m/32 of lane m % 32, SF = ceil(M/32)): the
//     acting function's lowest free slot and live count are SF ballots,
//     without touching per-instance data, and are read only when no
//     instance is idle.  The bitmap bounds the caps: F*SF <= 32.
//   - The live instances sit in a compact table, L entries a lane (entry j
//     of lane l holds any instance): its function and slot, creation (as
//     an order key), busy, expiry and, with faults, crash clock, in
//     registers.  The host bounds the live count without reading the card
//     (min(ncl, sum of min(limit, M)), F*M) and the launch takes the
//     narrowest L that holds it: L = 1 at the catalog's ncl = 24, against
//     16 slots a lane in the first design.  A cold start takes the lowest
//     empty entry (ballot, __ffs); a fleet that found none (a bound below
//     the true count) gets NaN outputs.
//   - The integrals are accrued, not summed per event: an instance's
//     running and idle time over a span in which its state holds is
//     accrue(P) - accrue(Q) (event_step_common.cuh), so its function's
//     columns gain accrue(hi) when its state starts (cold start, warm
//     start) and lose accrue(hi) when the state ends (warm start, expiry,
//     crash, eviction, the last event).  Where the clipped clock goes
//     back from hi_prev to hi (unsorted prestamped times, negative gaps),
//     the reference counts (hi, hi_prev] again on the next intervals: one
//     pass over the live entries adds accrue(hi) - accrue(hi_prev) of each.
//   - Exits are found without a per-event vote: the fleet keeps a lower
//     bound of its instances' earliest exit clock (lowered by each start,
//     exact after each exit pass), and the exit pass (a test per entry, a
//     vote, a warp-uniform loop over the ballot of the entries that left,
//     a redux for the new bound) runs only once the clock reaches it.
//   - Warm routing is the newest idle entry of the acting function by
//     (creation, slot) and eviction the newest idle entry of the fleet by
//     (creation, flat id): an order key per lane and two reduxes each, the
//     lowest id winning a tie as in the reference.  A warm event then
//     costs the samples' broadcast, those two reduxes and the winning
//     lane's update: ~4 collectives, where the first design ran ~12.
//   - The fleet-wide live count is a warp-uniform counter (+1 per cold
//     start, -1 per death), so the peak and the capacity checks need no
//     collective; lane g owns function g's accumulators, limit, threshold
//     and queue pointers.
//   - The queues are three [F, Q] planes per warp in shared memory, used as
//     rings (same FIFO order as the reference's shifted arrays).  Samples
//     are loaded 32 events at a time, one per lane (coalesced), and
//     broadcast per event with __shfl_sync.
//   - The crash clocks go to doom[fleet, f, m] at each cold start (+inf at
//     the fleet's start), written by lane m % 32, the same thread for every
//     value of one address, so program order leaves the last one stamped.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py::
// fleet_sweep_ref): every clock update is one rounded f32 operation
// (built with --fmad=false, written with __fadd_rn), the sentinels are
// the reference's (NEG = -1e30, any_idle = best > NEG/2, ncl = inf as
// 1e30), live counts are exact integers, and each counter adds the same
// values as the reference's.  The integral columns (3 and 4) add the same
// pieces in another association (per state span rather than per event),
// so they may differ in the last places.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "event_step_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 4;  // fleets per block
constexpr int ACC_COLS = 13;
constexpr int FAULT_COLS = 3;
constexpr int MAX_FUNCTIONS = 8;
// queue entries per function: 3 planes x 8 functions x 128 entries x 4
// warps x 4 bytes is the 48 KB of shared memory a block has by default
constexpr int MAX_QUEUE = 128;
// table entries per lane: 32 x 32 = 1024 instances, the most slots a fleet has
constexpr int MAX_TABLE = 32;

// Blocks a SM that the register budget must allow: 768 catalog blocks fit
// the 132 SMs in one wave at 6 a SM (<= 80 registers a thread); the wider
// tables keep ptxas' own choice.
template <int L>
struct MinBlocks {
  static constexpr int value = L == 1 ? 6 : 1;
};

// A fleet's instances: the alive bitmap and the lane's L table entries.
template <int L, bool FAULT>
struct Pool {
  unsigned alive = 0u;  // bit g*SF + q: slot q*32 + lane of function g is live
  unsigned used = 0u;   // bit j: entry j holds a live instance
  unsigned ckey[L];     // order_key(creation)
  float busy[L], expire[L];
  float doom[FAULT ? L : 1];
  int id[L];  // (function << 16) | slot
};

template <int L, bool FAULT>
__device__ __forceinline__ float doom_of(const Pool<L, FAULT>& p, int j) {
  return FAULT ? p.doom[FAULT ? j : 0] : INFINITY;
}

// The fleet's newest idle instance of function fa (fa < 0: of any
// function) by (creation, then the lowest slot, or flat id f*M + m for
// fa < 0): the lane's own candidate (key 0: none, idx, ent) and the warp's
// (best, best_idx), in every lane.
struct Newest {
  unsigned key, idx, best, best_idx;
  int ent;
  __device__ __forceinline__ bool mine() const {
    return key != 0u && key == best && idx == best_idx;
  }
};

template <int L, bool FAULT>
__device__ __forceinline__ Newest newest(const Pool<L, FAULT>& p, int fa, int M, float t_new) {
  Newest n;
  n.key = 0u;
  n.idx = UINT_MAX;
  n.ent = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int g = p.id[j] >> 16, m = p.id[j] & 0xffff;
    const bool cand = ((p.used >> j) & 1u) && (fa < 0 || g == fa) && p.busy[j] <= t_new;
    const unsigned k = cand ? p.ckey[j] : 0u;
    const unsigned x = fa < 0 ? (unsigned)(g * M + m) : (unsigned)m;
    // a lane's ids need not ascend with j, so the tie is compared
    if (k > n.key || (k != 0u && k == n.key && x < n.idx)) {
      n.key = k;
      n.idx = x;
      n.ent = j;
    }
  }
  n.best = __reduce_max_sync(FULL, n.key);
  n.best_idx = n.best != 0u ? __reduce_min_sync(FULL, n.key == n.best ? n.idx : UINT_MAX)
                            : UINT_MAX;
  return n;
}

// The acting function's lowest free slot (-1 if none) and live count, from
// the bitmap: SF ballots.
struct Slots {
  int first_free, n_alive;
};

__device__ __forceinline__ Slots slots_of(unsigned alive, int fa, int M, int SF) {
  Slots r{-1, 0};
  for (int q = 0; q < SF; ++q) {
    const unsigned b = __ballot_sync(FULL, (alive >> (fa * SF + q)) & 1u);
    r.n_alive += __popc(b);
    const int left = M - q * 32;
    const unsigned fr = ~b & (left >= 32 ? FULL : (1u << left) - 1u);
    if (r.first_free < 0 && fr) r.first_free = q * 32 + __ffs(fr) - 1;
  }
  return r;
}

// The fleet's running state outside the table: the live count, a lower
// bound of the earliest exit clock of its instances (an exit pass runs only
// once the clock reaches it), the accumulators a lane owns, and the broken
// flag (an instance that found no table entry).
struct Fleet {
  int live = 0;
  float next_exit = INFINITY;
  float a_run = 0.f, a_idle = 0.f;
  bool broken = false;
};

// A warm start on the routed instance, busy until `done`: its lane swaps
// the accrual to the new state; returns its crash clock.
template <int L, bool FAULT>
__device__ __forceinline__ float warm_start(Pool<L, FAULT>& p, Fleet& s, const Newest& r,
                                            int fa, float hi, float te, float done,
                                            float expire, int lane) {
  const bool win = r.mine();
  float dr = 0.f, di = 0.f, dm = INFINITY;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (win && j == r.ent) {
      // accrue(busy, expire, doom, hi, te) of the idle instance: busy <=
      // t_new <= t_end, so busy <= hi, its running time past hi is 0 and its
      // idle time starts at hi
      const float dj = doom_of(p, j);
      const float was = fmaxf(__fsub_rn(fminf(fminf(p.expire[j], dj), te), hi), 0.f);
      const float2 now = accrue(done, expire, dj, hi, te);
      dr = now.x;
      di = __fsub_rn(now.y, was);
      dm = dj;
    }
    p.busy[j] = win && j == r.ent ? done : p.busy[j];
    p.expire[j] = win && j == r.ent ? expire : p.expire[j];
  }
  // the instance's exit clock moves to min(expire, its doom), at least
  // min(expire, the old bound)
  s.next_exit = fminf(s.next_exit, expire);
  const int wl = __ffs(__ballot_sync(FULL, win)) - 1;
  dr = __shfl_sync(FULL, dr, wl);
  di = __shfl_sync(FULL, di, wl);
  if (lane == fa) {
    s.a_run = __fadd_rn(s.a_run, dr);
    s.a_idle = __fadd_rn(s.a_idle, di);
  }
  return FAULT ? __shfl_sync(FULL, dm, wl) : INFINITY;
}

// A cold start of function fa on slot m, busy until `done`, crash clock
// `doom` (stamped into doom_f[m], function fa's [M] plane, when not null):
// the lowest empty table entry takes it.
template <int L, bool FAULT>
__device__ __forceinline__ void cold_start(Pool<L, FAULT>& p, Fleet& s, int fa, int m,
                                           float t_new, float hi, float te, float done,
                                           float expire, float doom, int SF, int lane,
                                           float* doom_f) {
  int el = -1, ej = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (el < 0) {  // warp-uniform
      const unsigned e = __ballot_sync(FULL, !((p.used >> j) & 1u));
      if (e) {
        el = __ffs(e) - 1;
        ej = j;
      }
    }
  }
  if (el < 0) {
    s.broken = true;
    return;
  }
  const unsigned ck = order_key(t_new);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool hit = lane == el && j == ej;
    p.ckey[j] = hit ? ck : p.ckey[j];
    p.busy[j] = hit ? done : p.busy[j];
    p.expire[j] = hit ? expire : p.expire[j];
    p.id[j] = hit ? (fa << 16) | m : p.id[j];
    if (FAULT) p.doom[FAULT ? j : 0] = hit ? doom : p.doom[FAULT ? j : 0];
  }
  if (lane == el) p.used |= 1u << ej;
  if (lane == (m & 31)) {
    p.alive |= 1u << (fa * SF + (m >> 5));
    if (doom_f != nullptr) doom_f[m] = doom;
  }
  if (lane == fa) {
    const float2 a = accrue(done, expire, doom, hi, te);
    s.a_run = __fadd_rn(s.a_run, a.x);
    s.a_idle = __fadd_rn(s.a_idle, a.y);
  }
  s.next_exit = fminf(s.next_exit, fminf(expire, doom));
  ++s.live;
}

// Every live entry's accrual moved from clock `to` to clock `from` (<= te):
// function g's columns gain accrue(from) - accrue(to) of g's entries.  At
// the end of the run (from = te, where nothing is left to accrue) it gives
// back what the live instances accrued past the last clock; after the clock
// went back (from < to) it counts (from, to] again, as the reference's next
// intervals do.  Warp-uniform.
template <int L, bool FAULT>
__device__ __forceinline__ void settle(const Pool<L, FAULT>& p, Fleet& s, float from, float to,
                                       float te, int F, int lane) {
  for (int g = 0; g < F; ++g) {
    float r = 0.f, d = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (((p.used >> j) & 1u) && (p.id[j] >> 16) == g) {
        const float2 a = accrue(p.busy[j], p.expire[j], doom_of(p, j), from, te);
        const float2 b = accrue(p.busy[j], p.expire[j], doom_of(p, j), to, te);
        r = __fadd_rn(r, __fsub_rn(a.x, b.x));
        d = __fadd_rn(d, __fsub_rn(a.y, b.y));
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      r = __fadd_rn(r, __shfl_xor_sync(FULL, r, m));
      d = __fadd_rn(d, __shfl_xor_sync(FULL, d, m));
    }
    if (lane == g) {
      s.a_run = __fadd_rn(s.a_run, r);
      s.a_idle = __fadd_rn(s.a_idle, d);
    }
  }
}

// The exit pass (the clock has reached the bound): entries whose exit clock
// (expiry, or a crash) is at or before t_new leave the fleet, each giving
// back what it accrued past hi, freeing its slot and leaving the live count;
// a crash (doom < expiry, skip < doom <= t_end) is counted for its
// function.  A warp-uniform loop over the ballot of each entry index; then
// the bound becomes the earliest exit clock left.
template <int L, bool FAULT>
__device__ __forceinline__ void exits(Pool<L, FAULT>& p, Fleet& s, float t_new, float hi,
                                      float sk, float te, int SF, int lane, float& a_crash) {
  unsigned gone = 0u, crashed = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float dj = doom_of(p, j);
    if (((p.used >> j) & 1u) && fminf(p.expire[j], dj) <= t_new) {
      gone |= 1u << j;
      if (FAULT && dj < p.expire[j] && dj > sk && dj <= te) crashed |= 1u << j;
    }
  }
  if (__any_sync(FULL, gone)) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      unsigned lanes = __ballot_sync(FULL, (gone >> j) & 1u);
      if (!lanes) continue;  // warp-uniform
      const float2 a = (gone >> j) & 1u ? accrue(p.busy[j], p.expire[j], doom_of(p, j), hi, te)
                                        : make_float2(0.f, 0.f);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        const int id = __shfl_sync(FULL, p.id[j], src);
        const float r = __shfl_sync(FULL, a.x, src), d = __shfl_sync(FULL, a.y, src);
        const bool cr = FAULT && __shfl_sync(FULL, (crashed >> j) & 1u, src);
        const int g = id >> 16, m = id & 0xffff;
        if (lane == g) {
          s.a_run = __fsub_rn(s.a_run, r);
          s.a_idle = __fsub_rn(s.a_idle, d);
          if (cr) a_crash = __fadd_rn(a_crash, 1.f);
        }
        if (lane == (m & 31)) p.alive &= ~(1u << (g * SF + (m >> 5)));
        --s.live;
      }
    }
    p.used &= ~gone;
  }
  float nx = INFINITY;
#pragma unroll
  for (int j = 0; j < L; ++j)
    if ((p.used >> j) & 1u) nx = fminf(nx, fminf(p.expire[j], doom_of(p, j)));
  s.next_exit = key_value(__reduce_min_sync(FULL, order_key(nx)));
}

// QUEUE: queue_depth > 0 (never with FAULT); without it the queue code
// compiles away
template <int L, bool FAULT, bool QUEUE>
__global__ void __launch_bounds__(WARPS * 32, MinBlocks<L>::value)
fleet_sweep_kernel(const float* __restrict__ t_exp, const float* __restrict__ limit,
                   const float* __restrict__ ncl_in, const float* __restrict__ t_end,
                   const float* __restrict__ skip, const long long* __restrict__ stream,
                   const float* __restrict__ times, const uint8_t* __restrict__ fids,
                   const float* __restrict__ warms, const float* __restrict__ colds,
                   const float* __restrict__ crate_in, const float* __restrict__ crash_u,
                   const float* __restrict__ cap_e_in, const float* __restrict__ cap_v_in,
                   float* __restrict__ acc_out, float* __restrict__ qleft_out,
                   float* __restrict__ doom_out, int N, int F, int M, int K, int Q_in,
                   int E, int prestamped, long long rows) {
  const int Q = QUEUE ? Q_in : 0;
  constexpr int COLS = ACC_COLS + (FAULT ? FAULT_COLS : 0);
  const float qnan = __int_as_float(0x7fc00000);
  extern __shared__ float qmem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int fleet = blockIdx.x * WARPS + wib;
  if (fleet >= N) return;  // the ragged last block: the whole warp leaves
  const long long row = stream[fleet];
  if (row < 0 || row >= rows) {  // no stream row to read: the fleet's outputs are NaN
    if (lane < F) {
      for (int c = 0; c < COLS; ++c) acc_out[((size_t)fleet * F + lane) * COLS + c] = qnan;
      qleft_out[(size_t)fleet * F + lane] = qnan;
    }
    return;
  }
  const int SF = (M + 31) >> 5;

  // this warp's three [F, Q] queue planes (enqueue time, warm, cold)
  float* qt = qmem + (size_t)wib * 3 * F * Q;
  float* qw = qt + F * Q;
  float* qc = qw + F * Q;

  Pool<L, FAULT> p;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    p.ckey[j] = 0u;
    p.busy[j] = NEG;
    p.expire[j] = NEG;
    p.id[j] = 0;
    if (FAULT) p.doom[FAULT ? j : 0] = INFINITY;
  }
  Fleet s;
  const float ncl = ncl_in[fleet], tend = t_end[fleet], sk = skip[fleet];
  // lane g owns function g: its threshold, limit, accumulators and queue
  const bool owner = lane < F;
  const float my_texp = owner ? t_exp[(size_t)fleet * F + lane] : 0.f;
  const float my_limit = owner ? limit[(size_t)fleet * F + lane] : 0.f;
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f;
  float a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f, a_arr = 0.f, a_enq = 0.f;
  float a_qsrv = 0.f, a_qwait = 0.f;
  int my_qhead = 0, my_qlen = 0;
  float peak = 0.f, t = 0.f;
  float hi_prev = fminf(fmaxf(t, sk), tend);  // the previous clock, clipped
  // faults: the fleet's crash rate and capacity profile, its current
  // segment (empty: looked up at the first event) and the owner lane's
  // fault columns
  // (the rate, the profile and the clocks' plane are read where they are
  // used, which keeps the fault path within the registers of six blocks a SM)
  const bool crash = FAULT && crash_u != nullptr;
  const bool capped = FAULT && cap_v_in != nullptr;
  float cap_now = 0.f, cap_lo = INFINITY, cap_hi = -INFINITY;
  float a_crash = 0.f, a_evict = 0.f, a_int = 0.f;
  if (crash) {  // +inf until stamped, by the lane that stamps each slot
    for (int g = 0; g < F; ++g)
      for (int m = lane; m < M; m += 32) doom_out[((size_t)fleet * F + g) * M + m] = INFINITY;
  }

  const size_t srow = (size_t)row * (size_t)K;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    const bool in = k < K;
    const float d_l = in ? times[srow + k] : 0.f;
    const int f_l = in ? (int)fids[srow + k] : 0;
    const float w_l = in ? warms[srow + k] : 0.f;
    const float c_l = in ? colds[srow + k] : 0.f;
    const float u_l = crash && in ? crash_u[srow + k] : 0.f;
    const int n = min(32, K - base);
    for (int i = 0; i < n; ++i) {
      const float dt = __shfl_sync(FULL, d_l, i);
      const int fa = __shfl_sync(FULL, f_l, i);
      const float warm_s = __shfl_sync(FULL, w_l, i);
      const float cold_s = __shfl_sync(FULL, c_l, i);
      const float t_new = prestamped ? dt : __fadd_rn(t, dt);
      const float hi = fminf(fmaxf(t_new, sk), tend);
      // the clock went back: (hi, hi_prev] is counted again (rare)
      if (hi < hi_prev) settle(p, s, hi, hi_prev, tend, F, lane);
      hi_prev = hi;

      // 1-2. the exits (expiry, or a crash), once the clock reaches the
      // bound; the integrals up to hi are already accrued
      if (t_new >= s.next_exit) exits(p, s, t_new, hi, sk, tend, SF, lane, a_crash);

      const bool counted = t_new > sk;
      const bool in_h = t_new <= tend;
      if (capped) {
        // capacity churn: evict the newest idle instances fleet-wide above
        // the ceiling, one newest() each (removing instances keeps the
        // exit bound a bound)
        if (!(t_new >= cap_lo && t_new < cap_hi))
          cap_seek(cap_e_in + (size_t)fleet * E, cap_v_in + (size_t)fleet * (E + 1), E, t_new,
                   lane, cap_now, cap_lo, cap_hi);
        const float over = __fsub_rn((float)s.live, cap_now);
        if (over > 0.f && in_h) {
          for (int nev = 0; (float)nev < over; ++nev) {
            const Newest r = newest(p, -1, M, t_new);
            if (r.best == 0u) break;  // nothing idle is left
            const bool win = r.mine();
            float2 a = make_float2(0.f, 0.f);
#pragma unroll
            for (int j = 0; j < L; ++j)
              if (win && j == r.ent) a = accrue(p.busy[j], p.expire[j], doom_of(p, j), hi, tend);
            if (win) p.used &= ~(1u << r.ent);
            const int wl = __ffs(__ballot_sync(FULL, win)) - 1;
            const float rr = __shfl_sync(FULL, a.x, wl), d = __shfl_sync(FULL, a.y, wl);
            const int g = (int)r.best_idx / M, m = (int)r.best_idx - g * M;
            if (lane == g) {
              s.a_run = __fsub_rn(s.a_run, rr);
              s.a_idle = __fsub_rn(s.a_idle, d);
              if (counted) a_evict = __fadd_rn(a_evict, 1.f);
            }
            if (lane == (m & 31)) p.alive &= ~(1u << (g * SF + (m >> 5)));
            --s.live;
          }
        }
      }
      // an event past the horizon changes nothing but the clock and the exits
      if (fa < F && in_h) {  // warp-uniform; an id past F acts on no function
        const float texp = __shfl_sync(FULL, my_texp, fa);
        const bool mine = lane == fa;
        float* doom_f = crash ? doom_out + ((size_t)fleet * F + fa) * M : nullptr;
        int qlen = 0, qhead = 0;
        if (Q > 0) {
          qlen = __shfl_sync(FULL, my_qlen, fa);
          qhead = __shfl_sync(FULL, my_qhead, fa);
        }
        // 3. drain passes ahead of the arrival (no faults with queues)
        for (int pass = 0; pass < Q && qlen > 0; ++pass) {
          const Newest r = newest(p, fa, M, t_new);
          const bool any_idle = r.best != 0u && key_value(r.best) > NEG * 0.5f;
          Slots fs{-1, 0};
          bool can_cold = false;
          if (!any_idle) {
            fs = slots_of(p.alive, fa, M, SF);
            can_cold = (float)fs.n_alive < __shfl_sync(FULL, my_limit, fa) &&
                       fs.first_free >= 0 && (float)s.live < ncl;
            if (!can_cold) break;  // nothing served: nothing changes
          }
          const int h = fa * Q + qhead;
          const float ht = qt[h], hw = qw[h], hc = qc[h];
          const float done = __fadd_rn(t_new, any_idle ? hw : hc);
          const float expire = __fadd_rn(done, texp);
          if (any_idle) warm_start(p, s, r, fa, hi, tend, done, expire, lane);
          else cold_start(p, s, fa, fs.first_free, t_new, hi, tend, done, expire, INFINITY, SF,
                          lane, doom_f);
          if (mine && counted) {
            if (can_cold) {
              a_cold = __fadd_rn(a_cold, 1.f);
              a_cresp = __fadd_rn(a_cresp, hc);
            } else {
              a_warm = __fadd_rn(a_warm, 1.f);
              a_wresp = __fadd_rn(a_wresp, hw);
            }
            a_qsrv = __fadd_rn(a_qsrv, 1.f);
            a_qwait = __fadd_rn(a_qwait, __fsub_rn(t_new, ht));
          }
          qhead = qhead + 1 == Q ? 0 : qhead + 1;
          --qlen;
        }
        // 4. the arrival: warm on the newest idle instance; the slots are
        // read only when none is idle
        const Newest r = newest(p, fa, M, t_new);
        const bool is_warm = r.best != 0u && key_value(r.best) > NEG * 0.5f;
        if (is_warm) {
          const float done = __fadd_rn(t_new, warm_s);
          const float dc =
              warm_start(p, s, r, fa, hi, tend, done, __fadd_rn(done, texp), lane);
          if (mine && counted) {
            a_warm = __fadd_rn(a_warm, 1.f);
            a_wresp = __fadd_rn(a_wresp, warm_s);
            a_arr = __fadd_rn(a_arr, 1.f);
            if (crash && dc < done) a_int = __fadd_rn(a_int, 1.f);
          }
        } else {
          const Slots fs = slots_of(p.alive, fa, M, SF);
          const bool any_free = fs.first_free >= 0;
          const bool below = (float)fs.n_alive < __shfl_sync(FULL, my_limit, fa);
          // with a capacity profile a cold start also needs the fleet's
          // live count below the ceiling
          const bool is_cold = below && any_free && (float)s.live < ncl &&
                               (!capped || (float)s.live < cap_now);
          const bool is_enq = !is_cold && qlen < Q;
          if (is_cold) {
            // the lifetime stamped at a cold start; the served attempt is
            // interrupted when its instance dies before the service ends
            float life = INFINITY;
            const float crate = crash ? __ldg(crate_in + fleet) : 0.f;
            if (crate > 0.f)
              life = __fdiv_rn(-logf(__fsub_rn(1.f, __shfl_sync(FULL, u_l, i))), crate);
            const float done = __fadd_rn(t_new, cold_s);
            const float doom = FAULT ? __fadd_rn(t_new, life) : INFINITY;
            cold_start(p, s, fa, fs.first_free, t_new, hi, tend, done, __fadd_rn(done, texp),
                       doom, SF, lane, doom_f);
            if (mine && counted && crash && doom < done) a_int = __fadd_rn(a_int, 1.f);
          }
          if (is_enq) {
            int pos = qhead + qlen;
            if (pos >= Q) pos -= Q;
            if (lane == 0) {
              qt[fa * Q + pos] = t_new;
              qw[fa * Q + pos] = warm_s;
              qc[fa * Q + pos] = cold_s;
            }
            __syncwarp();
            ++qlen;
          }
          if (mine) {
            if (counted) {
              if (is_cold) {
                a_cold = __fadd_rn(a_cold, 1.f);
                a_cresp = __fadd_rn(a_cresp, cold_s);
              }
              if (!is_cold && !is_enq) a_rej = __fadd_rn(a_rej, 1.f);
              a_arr = __fadd_rn(a_arr, 1.f);
              if (is_enq) a_enq = __fadd_rn(a_enq, 1.f);
            }
            // overflow is counted for arrivals in the horizon, past skip or not
            if (below && !any_free) a_over = __fadd_rn(a_over, 1.f);
          }
        }
        if (mine) {
          my_qlen = qlen;
          my_qhead = qhead;
        }
      }
      // 5. the fleet-wide peak, on every event
      peak = fmaxf(peak, (float)s.live);
      t = t_new;
    }
  }

  // the live instances give back what they accrued past the last clock
  settle(p, s, tend, fminf(fmaxf(t, sk), tend), tend, F, lane);
  if (owner) {
    float* a = acc_out + ((size_t)fleet * F + lane) * COLS;
    a[0] = a_cold;
    a[1] = a_warm;
    a[2] = a_rej;
    a[3] = s.a_run;
    a[4] = s.a_idle;
    a[5] = a_cresp;
    a[6] = a_wresp;
    a[7] = a_over;
    a[8] = a_arr;
    a[9] = a_enq;
    a[10] = a_qsrv;
    a[11] = a_qwait;
    a[12] = peak;
    if (FAULT) {
      a[13] = a_crash;
      a[14] = a_evict;
      a[15] = a_int;
    }
    qleft_out[(size_t)fleet * F + lane] = (float)my_qlen;
    if (s.broken) {  // the live-count bound was below the live count
      for (int c = 0; c < COLS; ++c) a[c] = qnan;
      qleft_out[(size_t)fleet * F + lane] = qnan;
    }
  }
}

// the launch's sizes
struct Dims {
  int N, F, M, K, Q, E, prestamped;
  long long rows;
};

template <int L, bool FAULT, bool QUEUE>
void launch(const void* const* in, void* const* out, const Dims& d, cudaStream_t stream) {
  const dim3 blocks((d.N + WARPS - 1) / WARPS), threads(WARPS * 32);
  const size_t smem = (size_t)WARPS * 3 * d.F * d.Q * sizeof(float);
  fleet_sweep_kernel<L, FAULT, QUEUE><<<blocks, threads, smem, stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[4], (const long long*)in[5], (const float*)in[6],
      (const uint8_t*)in[7], (const float*)in[8], (const float*)in[9],
      (const float*)in[10], (const float*)in[11], (const float*)in[12],
      (const float*)in[13], (float*)out[0], (float*)out[1], (float*)out[2], d.N, d.F, d.M,
      d.K, d.Q, d.E, d.prestamped, d.rows);
}

// entries a lane of the narrowest table holding `live` instances in 32 lanes
int table_entries(int live) {
  int L = 1;
  while (L < MAX_TABLE && 32 * L < live) L *= 2;
  return L;
}

template <int L = 1>
void launch_table(const void* const* in, void* const* out, const Dims& d, int entries,
                  bool faults, cudaStream_t st) {
  if constexpr (L < MAX_TABLE) {
    if (L < entries) return launch_table<L * 2>(in, out, d, entries, faults, st);
  }
  if (faults) launch<L, true, false>(in, out, d, st);
  else if (d.Q > 0) launch<L, false, true>(in, out, d, st);
  else launch<L, false, false>(in, out, d, st);
}

}  // namespace

// Plain C entry, bound with ctypes.  Inputs: t_exp, limit [N, F]; ncl,
// t_end, skip [N] f32; stream [N] int64 (the stream row of each fleet;
// a fleet whose row lies outside [0, S) gets NaN outputs); times, warms,
// colds [S, K] f32 and fids [S, K] uint8; faults (each null when off, and
// not with Q > 0): crash_rate [N] and crash_u [S, K] (crashes), cap_edges
// [N, E] (strictly increasing, > 0; null when E = 0) and cap_values [N,
// E+1] (capacity) — all contiguous, on `device`.  Outputs: acc [N, F, 13,
// or 16 with faults], qleft [N, F] f32, and doom [N, F, M] with crashes
// (else null).  `live` bounds every fleet's live instance count (the table
// holds the narrowest power-of-two multiple of 32 entries at or above it,
// up to 1024; a fleet that outgrows it gets NaN outputs).  Caps: F <= 8, F
// rounded up to a power of two times M rounded up to a power-of-two
// multiple of 32 at most 1024 slots, Q <= 128.  Launches on `stream_ptr`
// and returns cudaGetLastError() (or cudaErrorInvalidValue for an input
// past a cap).
extern "C" int fleet_sweep_f32(const void* t_exp, const void* limit, const void* ncl,
                               const void* t_end, const void* skip, const void* stream,
                               const void* times, const void* fids, const void* warms,
                               const void* colds, const void* crash_rate,
                               const void* crash_u, const void* cap_edges,
                               const void* cap_values, void* acc, void* qleft, void* doom,
                               int N, int F, int M, int S, int K, int Q, int E,
                               int prestamped, int live, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool crash = crash_u != nullptr, capped = cap_values != nullptr;
  int fp = 1, sf = 1;
  while (fp < F) fp *= 2;
  while (32 * sf < M) sf *= 2;
  if (N < 1 || F < 1 || F > MAX_FUNCTIONS || M < 1 || fp * sf > 32 || S < 1 || K < 0 ||
      Q < 0 || Q > MAX_QUEUE || live < 1 || ((crash || capped) && Q > 0) ||
      (crash && (crash_rate == nullptr || doom == nullptr)) ||
      (capped && (E < 0 || (E > 0 && cap_edges == nullptr))))
    return (int)cudaErrorInvalidValue;
  const void* in[14] = {t_exp, limit, ncl,     t_end,   skip,      stream,    times,
                        fids,  warms, colds, crash_rate, crash_u, cap_edges, cap_values};
  void* out[3] = {acc, qleft, doom};
  const Dims d{N, F, M, K, Q, capped ? E : 0, prestamped, S};
  launch_table(in, out, d, table_entries(live < F * M ? live : F * M), crash || capped,
               (cudaStream_t)stream_ptr);
  return (int)cudaGetLastError();
}

// The table entries a lane that fleet_sweep_f32 launches with for `live`
// (its live bound, clipped to F*M by the caller).
extern "C" int fleet_table_entries(int live) { return table_entries(live); }
