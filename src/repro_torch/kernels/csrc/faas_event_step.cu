// Hopper (sm_90a) kernel of the f32 steady-state block engine.
//
// Replaces the TPU kernel repro/kernels/faas_event_step.py::_faas_kernel
// (launched by faas_sweep_pallas) for its base staged path, the
// prestamped mode, the transient grid-curve columns, the metric windows,
// the reliability layer (timeouts, failures), client retries, fused
// threefry draws and platform faults.  Each row
// (one replica of one what-if cell) runs K arrivals against its own pool
// of M instance slots (alive, creation, busy).  Per arrival: exact
// integrals of running and idle instance-time over the interval clipped
// to [skip, t_end]; expiry of idle instances past t_exp (expire-first on
// a tie); then the newest idle instance serves (warm, lowest slot on a
// creation tie), else a free slot below max_concurrency (cold), else the
// arrival is rejected.  Arrivals past t_end are inert: they move the clock
// and expire instances, nothing else.
//
// Grid curves (GRID, the temporal engine): each grid point g of the row
// that falls in an arrival's interval (t, min(t_new, t_end)] records the
// running (busy > g), idle (busy <= g) and no-idle counts of the
// pre-expiry pool's live instances (busy + t_exp > g).  The warp keeps the
// smallest grid time past the clock (next_g), so an event that holds no
// grid point costs one warp-uniform compare.
//
// Metric windows (WIN): W windows [b_w, b_w+1) with strictly increasing
// bounds.  Per window: cold, served and arrival counts (rejects included)
// of the active arrivals whose instant lies in it, and the running and
// idle integrals over the window intersected with (min(t, t_end),
// min(t_new, t_end)] (windows ignore skip).  A cursor (the first window
// ending past the clock) holds its window's columns in registers from
// entering it to leaving it, so no event waits on a global
// read-modify-write; a row whose clock goes back recounts the windows it
// went back over and re-enters the cursor's window.
//
// Reliability (RELY): a served attempt holds its instance for
// min(service, t_timeout) (NO_TIMEOUT = 1e30 leaves min() the identity);
// it times out when service > t_timeout, else fails when its uniform is
// below p_fail; response sums read min(service, t_timeout).  Retries
// (RETRY, implies RELY): the events are a host-built attempt table; an
// attempt is active only when it is a first attempt or an earlier
// attempt's timeout, failure or rejection switched it on (child_pos, a
// later position: the table is sorted stably and backoffs are > 0).
// Inactive attempts still advance the clock, integrate and expire.
//
// Fused draws (FUSED; base, windows and reliability): instead of reading
// staged samples, the kernel draws event k's samples from the row's
// per-stream uint32 key pair, as repro_torch/core/drawplan.py defines the
// bitstream: threefry-2x32 of the counter (k, 0), 20 rounds, each word's
// top 23 bits filling the mantissa of 1.0, minus 1, then the stream's
// inverse CDF or Box-Muller transform with its two per-row parameters
// (distribution ids are runtime, warp-uniform arguments, so the template
// instances do not multiply by 6^3).  The failure uniform is word 0 of the
// fail stream's draw.  The transforms call the same libm functions in the
// same order as the plain version (logf, cosf, expf, powf, sqrtf,
// correctly rounded divisions, the 1e-9 clamp).
//
// Platform faults (FAULT; base, reliability, retries): instance crashes
// and capacity churn.  With crashes each cold start stamps its slot's crash
// clock doom = t_new + (-log(1 - u) / crash_rate) (+inf at a zero rate)
// from the event's crash uniform; a warm hit keeps it, and fresh slots hold
// +inf.  The integrals stop at min(hi, doom), an instance leaves at
// min(expiry, doom), and the exit counts as a crash when doom < expiry and
// skip < doom <= t_end.  A served attempt whose instance dies before
// t_new + occupancy is interrupted (with reliability: one not timed out or
// failed, and it triggers the retry).  With a capacity profile (E edges,
// E + 1 ceilings per row; a leading 0 edge implied) the ceiling in effect
// at t_new gates cold starts (live count below it) and, inside the horizon,
// ceil(live - ceiling) of the newest idle instances are evicted, each the
// routing rule's choice, so the choice after the last eviction is the
// routing candidate.  The row's segment [lo, hi) stays in registers and is
// looked up again only when t_new leaves it.  With the crash clocks off
// the doom plane holds +inf, which leaves every min() above the identity,
// so one template instance serves crashes, capacity or both (a runtime,
// warp-uniform choice); without FAULT the code is the path without faults.
//
// What bounds it on this card: each row is a chain of dependent events, and
// the samples are 12 to 24 bytes an event read once.  The first design
// walked every slot on every event, inside the horizon or not: the two
// integral terms, three warp sums, a ten-shuffle arg-max and M/32 ballots,
// ~25 operations a slot, which made it bound by operations at 24.8x the
// bound.  An event changes at most one instance, and those past the horizon
// change none, so what an event needs is its own chain of collectives: the
// longest rows (2.0/s, ~200,000 events in horizon at Table 1) set a floor of
// their event count times one event's latency.  On an H100 one row alone
// takes ~447 cycles an event (two reduxes of ~48 cycles, ~10 warp-uniform
// branches of ~16), and Table 1's 4,096 rows take 2.4x that floor: the
// rows on a scheduler share its issue at ~126 instructions a warm event.
//
// What the design does about that: one warp per row, the pool in registers
// (ceil(M/32) slots a lane, the alive flags a bitmask), and work only where
// an event changes something:
//   - The integrals are accrued per state span (event_step_common.cuh
//     accrue): the owning lane adds accrue(hi) of an instance when its state
//     starts (cold or warm start) and subtracts it when the state ends (warm
//     start, eviction, the last event; an exit accrues nothing past its exit
//     clock, so it subtracts 0).  Each lane keeps its own part of the two
//     sums, added across the warp once at the end.  Where the clipped clock
//     goes back (unsorted prestamped times, negative gaps) a pass over the
//     live slots adds accrue(hi) - accrue(hi_prev), the interval the plain
//     version counts again.  The metric windows accrue the same way into the
//     cursor's columns, with one pass over the live slots each time the
//     clock crosses into a window.
//   - Exits are found without a per-event walk: the row keeps a lower bound
//     of its earliest exit clock (lowered at each start, exact after each
//     exit pass) and runs the exit pass (a test a slot, one redux for the
//     count, one for the new bound) only once the clock reaches it.
//   - Routing is an order key of the creation time (kept per slot) and two
//     reduxes (the newest idle instance, then its lowest slot), the eviction
//     order under a capacity profile the same; the live count is a
//     warp-uniform counter, and the first-free ballots run only when no
//     instance is idle.  The owning lane's updates are selects, not
//     branches, and each event's gap and warm sample are broadcast ahead of
//     their use.
//   - A quiet event (inside the horizon, nothing deferred, the clipped
//     clock not going back, no exit, grid point, window bound or capacity
//     step due: one warp-uniform test) goes straight to the routing.
//   - The inert tail: an event past t_end changes the clock and the exits it
//     passes, and nothing else.  Expiry is monotone in the clock while
//     nothing is assigned, so one exit pass at the largest clock reached
//     gives the same pool and crash count as a pass per event; it runs
//     before the next event inside the horizon, and at the end.  A batch of
//     32 events wholly past the horizon (the clock past t_end, and gaps >= 0
//     or times past t_end) only advances the clock: its warm, cold and other
//     samples are neither loaded nor drawn.  Inactive retry attempts skip the
//     routing the same way.
// Samples are loaded 32 events at a time, one per lane (coalesced), and
// broadcast per event with __shfl_sync; with fused draws lane l draws event
// base + l of the batch.  Pools of more than 512 slots keep their creation
// keys (and crash clocks) in shared memory, a column per lane.  The window, grid and activation planes are
// unbounded in W, G and K, so they live in global memory: lane 0 adds each
// grid term in event order, and stores each window's columns when the
// cursor leaves it.  A retry's child can fall inside the 32-event batch
// whose activations were loaded at its start, so activations made during a
// batch for that batch's own events ride in a warp-uniform bitmask (pend);
// the global plane is read at the next batch's start after a __syncwarp()
// that orders lane 0's stores.  Many rows per SM (4 per block, thousands per
// grid) hide each chain's latency.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py): every
// clock update is one rounded f32 operation (built with --fmad=false, and
// written with __fadd_rn), the sentinels are the reference's (NEG = -1e30
// for dead slots, any_idle = best > NEG/2), live counts are exact integers,
// and the counters are per-row sequential sums in the same order.  The
// alive plane is 0/1.  Only the integrals (acc columns 3-4 and each
// window's two integral columns) add the same pieces in another
// association (per state span and per lane rather than per event), so they
// may differ from the plain version in the last places.  Counts (base,
// window, grid, reliability, faults), the activation plane, the pools, the
// crash clocks and the final clock are exact.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "event_step_common.cuh"
#include "threefry.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float NO_CHILD_F = 1073741824.f;  // 2^30, a last attempt's child_pos
constexpr int WARPS = 4;  // rows per block
constexpr int ACC_COLS = 8;
constexpr int MAX_GRID = 1024;  // grid points per row (3 acc columns each)
constexpr int MAX_WINDOWS = 65536;  // windows per row (5 acc columns each)

// which optional paths a launch runs (a template instance each)
constexpr int F_GRID = 1, F_WIN = 2, F_RELY = 4, F_RETRY = 8, F_FUSED = 16, F_FAULT = 32;

using namespace threefry;

struct Params {
  const float *alive_in, *creation_in, *busy_in, *t0, *t_exp, *t_end, *skip;
  const float *dts, *warms, *colds, *grid, *wb, *t_to, *p_fail, *fail_u,
      *is_first, *child_pos;
  // fused draws: uint32 key pairs [R, 2] (arrival, warm, cold, fail) and
  // f32 (p0, p1) pairs [R, 2] (arrival, warm, cold)
  const unsigned *keys[4];
  const float* params[3];
  int dists[3];
  // platform faults: crash rates [R] and uniforms [R, K] (null without
  // crashes), capacity edges [R, E] and ceilings [R, E+1] (null without)
  const float *crate, *crash_u, *cap_e, *cap_v;
  float *alive_out, *creation_out, *busy_out, *t_out, *acc_out, *act_out, *doom_out;
  int R, M, K, G, W, E, cols;
  float max_c;
  int prestamped;
};

// a row's fused stream: its key pair and parameters, loaded once
struct FusedStream {
  unsigned k0, k1;
  float p0, p1;
  int kind;

  __device__ __forceinline__ void load(const unsigned* keys, const float* params, int d,
                                       int row) {
    k0 = keys[2 * row];
    k1 = keys[2 * row + 1];
    p0 = params ? params[2 * row] : 0.f;
    p1 = params ? params[2 * row + 1] : 0.f;
    kind = d;
  }
  __device__ __forceinline__ float draw(unsigned k) const {
    unsigned b0, b1;
    threefry2x32(k0, k1, k, b0, b1);
    return sample_dist(kind, uniform_from_bits(b0), uniform_from_bits(b1), p0, p1);
  }
  __device__ __forceinline__ float uniform(unsigned k) const {
    unsigned b0, b1;
    threefry2x32(k0, k1, k, b0, b1);
    return uniform_from_bits(b0);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

// Blocks a SM that the register budget must allow: at one or two slots a
// lane (M <= 64, Table 1's width) the 1,024 blocks of a 4,096-row sweep fit
// the 132 SMs in one wave at 8 a SM (<= 64 registers a thread), which the
// paths without reliability and faults fit; those two take 6 (<= 80
// registers); the fused draws and the wider pools keep ptxas' own choice.
template <int S, bool RELY, bool FUSED, bool FAULT>
struct MinBlocks {
  static constexpr int value = S > 2 || FUSED ? 1 : RELY || FAULT ? 6 : 8;
};

// A per-slot array of the pool: in registers (element s of this lane's
// slots), or, for the widest pools, in this warp's column of shared memory
// (element s at [s][lane]), where 32 slots a lane of creation keys and crash
// clocks beside the busy clocks would not fit the register file.
template <typename T, int S, bool SHARED>
struct Slots {
  T v[S];
  __device__ __forceinline__ T& operator[](int s) { return v[s]; }
  __device__ __forceinline__ const T& operator[](int s) const { return v[s]; }
};
template <typename T, int S>
struct Slots<T, S, true> {
  T* col;
  __device__ __forceinline__ T& operator[](int s) { return col[s * 32]; }
  __device__ __forceinline__ const T& operator[](int s) const { return col[s * 32]; }
};

// What an instance accrues over (from, te] (event_step_common.cuh accrue):
// with crash clocks (FAULT) the full form, without them the same with doom
// = +inf left out (fminf(x, +inf) is no identity to the compiler, which
// keeps NaN's).
template <bool FAULT>
__device__ __forceinline__ float2 accrue_of(float busy, float expire, float doom, float from,
                                            float te) {
  if (FAULT) return accrue(busy, expire, doom, from, te);
  const float run = fmaxf(__fsub_rn(fminf(busy, te), from), 0.f);
  const float idle = fmaxf(__fsub_rn(fminf(expire, te), fmaxf(busy, from)), 0.f);
  return make_float2(run, idle);
}

// What slot state (busy, doom) accrues from `from` on, up to the horizon's
// end te: running time until min(busy, doom) and idle time from busy until
// min(busy + t_exp, doom).
template <bool FAULT>
__device__ __forceinline__ float2 slot_accrue(float busy, float texp, float doom, float from,
                                              float te) {
  return accrue_of<FAULT>(busy, __fadd_rn(busy, texp), doom, from, te);
}

// The newest idle instance of the pool (largest creation, lowest slot on a
// tie), in every lane: best is its order key (0: none is idle), j its slot.
struct Newest {
  unsigned best, j;
  // an idle instance whose creation is above NEG / 2, as the plain version
  // reads its arg-max (the order key keeps the order, 0 stands for none)
  __device__ __forceinline__ bool found() const { return best > order_key(NEG * 0.5f); }
};

template <int S, class Keys>
__device__ __forceinline__ Newest newest_idle(unsigned live, const Keys& ckey,
                                              const float (&busy)[S], float t_new, int lane) {
  unsigned k = 0u;
  int ks = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned c = ((live >> s) & 1u) && busy[s] <= t_new ? ckey[s] : 0u;
    // this lane's slots ascend with s, so '>' keeps the lowest slot on a tie
    if (c > k) {
      k = c;
      ks = s;
    }
  }
  Newest n;
  n.best = __reduce_max_sync(FULL, k);
  n.j = __reduce_min_sync(FULL, k == n.best && k ? (unsigned)(ks * 32 + lane) : UINT_MAX);
  return n;
}

// the lowest free slot below M (-1 if none), in every lane
template <int S>
__device__ __forceinline__ int first_free_slot(unsigned live, int M, int lane) {
  int ff = -1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned fm = __ballot_sync(FULL, s * 32 + lane < M && !((live >> s) & 1u));
    if (ff < 0 && fm) ff = s * 32 + __ffs(fm) - 1;
  }
  return ff;
}

// The exit pass at clock T: live slots whose exit clock (expiry, or a
// crash) is at or before T leave; a crash (doom < expiry, skip < doom <=
// t_end) counts in this lane's crash_l.  They accrued nothing past their
// exit, so there is nothing to give back.  The live count drops by the
// exits, and the bound becomes the earliest exit clock left.  Warp-uniform.
template <int S, bool FAULT, class Dooms>
__device__ __forceinline__ void exit_pass(unsigned& live, const float (&busy)[S],
                                          const Dooms& doom, float texp,
                                          float T, float sk, float te, int& n_live,
                                          float& next_exit, int& crash_l) {
  unsigned gone = 0u;
  float nx = INFINITY;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if ((live >> s) & 1u) {
      const float e = __fadd_rn(busy[s], texp);
      const float d = FAULT ? doom[FAULT ? s : 0] : INFINITY;
      const float x = FAULT ? fminf(e, d) : e;
      if (x <= T) {
        gone |= 1u << s;
        if (FAULT) crash_l += d < e && d > sk && d <= te;
      } else {
        nx = fminf(nx, x);
      }
    }
  }
  live &= ~gone;
  n_live -= (int)__reduce_add_sync(FULL, (unsigned)__popc(gone));
  next_exit = key_value(__reduce_min_sync(FULL, order_key(nx)));
}

// Every live slot's accrual moved from clock `to` to clock `from` (<= te):
// this lane's parts gain accrue(from) - accrue(to) of its live slots.  At the
// end of the run (from = te, where nothing is left to accrue) it gives back
// what the live instances accrued past the last clock; after the clock
// went back (from < to) it counts (from, to] again, as the plain version's
// next intervals do.
template <int S, bool FAULT, class Dooms>
__device__ __forceinline__ void settle(unsigned live, const float (&busy)[S],
                                       const Dooms& doom, float texp,
                                       float from, float to, float te, float& run_l,
                                       float& idle_l) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if ((live >> s) & 1u) {
      const float d = FAULT ? doom[FAULT ? s : 0] : INFINITY;
      const float2 a = slot_accrue<FAULT>(busy[s], texp, d, from, te);
      const float2 b = slot_accrue<FAULT>(busy[s], texp, d, to, te);
      run_l = __fadd_rn(run_l, __fsub_rn(a.x, b.x));
      idle_l = __fadd_rn(idle_l, __fsub_rn(a.y, b.y));
    }
  }
}

// the smallest grid time past the clock t (+inf if none), in every lane
__device__ __forceinline__ float next_grid(const float* grow, int G, float t,
                                           int lane) {
  float m = INFINITY;
  for (int gi = lane; gi < G; gi += 32) {
    const float g = __ldg(grow + gi);
    if (g > t) m = fminf(m, g);
  }
  return warp_min(m);
}

// The window cursor: the first window ending past the window clock
// min(t, t_end), whose five acc columns live in registers from entering the
// window to leaving it: the three counts the same in every lane, the two
// integrals as this lane's part (lane 0's starts from what was stored),
// added across the warp when the cursor leaves.  A state that starts at
// window clock x adds what it accrues in the cursor's window from x on
// (window_accrue), and subtracts it at clock y when it ends; when the clock
// crosses into a window every live instance adds what it accrues there from
// the window's start.
struct WindowCursor {
  const float* bounds;  // the row's W + 1 bounds
  float* acc;           // the row's 5W window columns
  int W, w;
  float lo, hi;  // window w's bounds (+inf past the last window)
  float c[3];    // cold, served, arrivals
  float r, i;    // this lane's part of ∫running, ∫idle

  __device__ __forceinline__ void enter(int to, int lane) {
    __syncwarp();  // lane 0's store of a window left earlier, before the loads
    w = to;
    const bool in = w < W;
    lo = in ? __ldg(bounds + w) : INFINITY;
    hi = in ? __ldg(bounds + w + 1) : INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = in ? acc[k * W + w] : 0.f;
    r = in && lane == 0 ? acc[3 * W + w] : 0.f;
    i = in && lane == 0 ? acc[4 * W + w] : 0.f;
  }
  // warp-uniform
  __device__ __forceinline__ void leave(int lane) {
    if (w >= W) return;
    const float rs = warp_sum(r), is = warp_sum(i);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k * W + w] = c[k];
      acc[3 * W + w] = rs;
      acc[4 * W + w] = is;
    }
  }
  // the first window ending past x, entered straight (no accrual)
  __device__ __forceinline__ void seek(float x, int lane) {
    int w0 = 0;
    while (w0 < W && __ldg(bounds + w0 + 1) <= x) ++w0;
    enter(w0, lane);
  }
  // what a state accrues in the cursor's window from window clock x on
  __device__ __forceinline__ float2 window_accrue(float busy, float texp, float x,
                                                  float te) const {
    return slot_accrue<false>(busy, texp, INFINITY, fmaxf(x, lo), fminf(hi, te));
  }
  // every live slot's window_accrue(x) - window_accrue(y) into this lane's part
  template <int S>
  __device__ __forceinline__ void add_live(unsigned live, const float (&busy)[S], float texp,
                                           float x, float y, float te) {
    if (w >= W) return;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((live >> s) & 1u) {
        const float2 a = window_accrue(busy[s], texp, x, te);
        const float2 b = window_accrue(busy[s], texp, y, te);
        r = __fadd_rn(r, __fsub_rn(a.x, b.x));
        i = __fadd_rn(i, __fsub_rn(a.y, b.y));
      }
    }
  }
  // the window clock moves forward to x: each window entered on the way
  // takes every live state from its start
  template <int S>
  __device__ __forceinline__ void cross(unsigned live, const float (&busy)[S], float texp,
                                        float x, float te, int lane) {
    while (w < W && hi <= x) {
      leave(lane);
      enter(w + 1, lane);
      add_live(live, busy, texp, lo, INFINITY, te);
    }
  }
  // the window clock went back from x to y: every live state gives back
  // what it added past x in the cursor's window and, the cursor moved back
  // to y's window, adds what it accrues there from y on; the windows in
  // between take it again when the clock crosses them, as the plain
  // version's next intervals count (y, x] again
  template <int S>
  __device__ __forceinline__ void back(unsigned live, const float (&busy)[S], float texp,
                                       float y, float x, float te, int lane) {
    add_live(live, busy, texp, INFINITY, x, te);
    leave(lane);
    seek(y, lane);
    add_live(live, busy, texp, y, INFINITY, te);
  }
};

// S: slots per lane (M <= 32 * S); GRID, WIN, RELY, RETRY, FUSED, FAULT:
// the optional paths (RETRY implies RELY; FUSED goes without GRID and
// RETRY; FAULT without GRID, WIN and FUSED)
template <int S, bool GRID, bool WIN, bool RELY, bool RETRY, bool FUSED, bool FAULT>
__global__ void __launch_bounds__(WARPS * 32, (MinBlocks<S, RELY, FUSED, FAULT>::value))
    faas_sweep_kernel(const Params p) {
  static_assert(!RETRY || RELY, "retries ride on the reliability path");
  static_assert(!FUSED || (!GRID && !RETRY), "fused draws serve base, windows, reliability");
  static_assert(!FAULT || (!GRID && !WIN && !FUSED), "faults serve base, reliability, retries");
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= p.R) return;  // the ragged last block: the whole warp leaves
  const int M = p.M, K = p.K, G = p.G, W = p.W;

  // slot j = s * 32 + lane; slots past M do not exist (never alive, never
  // free); bit s of `live` is slot j's alive flag
  const size_t pool = (size_t)row * M;
  unsigned live = 0u;
  float busy[S];
  // order_key of each slot's creation time; faults: the crash clocks (+inf:
  // none stamped); past 16 slots a lane, in shared memory
  constexpr bool WIDE = S > 16;
  Slots<unsigned, S, WIDE> ckey;
  Slots<float, FAULT ? S : 1, WIDE && FAULT> doom;
  if constexpr (WIDE) {
    extern __shared__ float slot_smem[];
    float* warp_cols = slot_smem + (size_t)(threadIdx.x >> 5) * (FAULT ? 2 : 1) * S * 32;
    ckey.col = (unsigned*)warp_cols + lane;
    if constexpr (FAULT) doom.col = warp_cols + S * 32 + lane;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    const bool ex = j < M;
    if (ex && p.alive_in[pool + j] > 0.f) live |= 1u << s;
    ckey[s] = order_key(ex ? p.creation_in[pool + j] : NEG);
    busy[s] = ex ? p.busy_in[pool + j] : NEG;
    if (FAULT) doom[FAULT ? s : 0] = INFINITY;
  }
  float t = p.t0[row];
  const float texp = p.t_exp[row], tend = p.t_end[row], sk = p.skip[row];
  const float tto = RELY ? p.t_to[row] : 0.f;
  const float pf = RELY ? p.p_fail[row] : 0.f;
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f;
  float a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f;
  float a_tout = 0.f, a_fail = 0.f, a_retry = 0.f, a_aband = 0.f;
  // faults: the row's crash rate and capacity profile, its current segment
  // (empty: looked up at the first event) and the fault columns
  const bool crash = FAULT && p.crash_u != nullptr;
  const bool capped = FAULT && p.cap_v != nullptr;
  const float crate = crash ? p.crate[row] : 0.f;
  const float* cap_e = capped ? p.cap_e + (size_t)row * p.E : nullptr;
  const float* cap_v = capped ? p.cap_v + (size_t)row * (p.E + 1) : nullptr;
  float cap_now = 0.f, cap_lo = INFINITY, cap_hi = -INFINITY;
  float a_evict = 0.f, a_int = 0.f;
  int crash_l = 0;
  // acc row: 8 base | 5W windows | 3G grid | 4 reliability | 3 fault columns
  float* arow = p.acc_out + (size_t)row * p.cols;
  float* wacc = arow + ACC_COLS;
  float* gacc = wacc + 5 * W;
  const float* grow = GRID ? p.grid + (size_t)row * G : nullptr;
  const float* wrow = WIN ? p.wb + (size_t)row * (W + 1) : nullptr;
  float* act = RETRY ? p.act_out + (size_t)row * K : nullptr;
  // the planes start at zero; lane 0 adds into them, after the barrier
  if (WIN)
    for (int c = lane; c < 5 * W; c += 32) wacc[c] = 0.f;
  if (GRID)
    for (int c = lane; c < 3 * G; c += 32) gacc[c] = 0.f;
  if (RETRY)
    for (int k = lane; k < K; k += 32) act[k] = 0.f;
  __syncwarp();
  float next_g = INFINITY;
  if (GRID) next_g = next_grid(grow, G, t, lane);

  // the row's running state: the clock clipped to [skip, t_end] (hi_prev)
  // and to t_end (hie_prev, the windows' clock), the live count, the lower
  // bound of the earliest exit clock, this lane's part of the integrals,
  // and the exits deferred past the horizon (up to the clock tmax)
  float hi_prev = fminf(fmaxf(t, sk), tend);
  float hie_prev = fminf(t, tend);
  int n_live = (int)__reduce_add_sync(FULL, (unsigned)__popc(live));
  float run_l = 0.f, idle_l = 0.f;
  float next_exit;
  {
    float nx = INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((live >> s) & 1u) {
        nx = fminf(nx, __fadd_rn(busy[s], texp));
        const float2 a = slot_accrue<false>(busy[s], texp, INFINITY, hi_prev, tend);
        run_l = __fadd_rn(run_l, a.x);
        idle_l = __fadd_rn(idle_l, a.y);
      }
    }
    next_exit = key_value(__reduce_min_sync(FULL, order_key(nx)));
  }
  float tmax = -INFINITY;
  bool deferred = false;
  WindowCursor cur;
  if (WIN) {
    cur.bounds = wrow;
    cur.acc = wacc;
    cur.W = W;
    cur.seek(hie_prev, lane);
    cur.add_live(live, busy, texp, hie_prev, INFINITY, tend);
  }

  FusedStream fa, fw, fc, ff;
  if (FUSED) {
    fa.load(p.keys[0], p.params[0], p.dists[0], row);
    fw.load(p.keys[1], p.params[1], p.dists[1], row);
    fc.load(p.keys[2], p.params[2], p.dists[2], row);
    if (RELY) ff.load(p.keys[3], nullptr, 0, row);
  }

  const size_t srow = (size_t)row * K;
  for (int base = 0; base < K; base += 32) {
    if (RETRY) __syncwarp();  // lane 0's activation stores, before the loads
    const int k = base + lane;
    const bool in = k < K;
    const int n = min(32, K - base);
    // lane l loads (or, fused, draws) event base + l of the batch
    const float d_l = in ? (FUSED ? fa.draw((unsigned)k) : p.dts[srow + k]) : 0.f;
    // a batch wholly past the horizon (the clock past t_end, and gaps >= 0 or
    // times past t_end) only moves the clock; its exits wait for the pass
    // at the largest clock reached
    if (!(t <= tend)) {
      const bool inert = !in || (p.prestamped ? !(d_l <= tend) : d_l >= 0.f);
      if (__all_sync(FULL, inert)) {
        if (p.prestamped) {
          t = __shfl_sync(FULL, d_l, n - 1);
          tmax = fmaxf(tmax, key_value(__reduce_max_sync(FULL, in ? order_key(d_l) : 0u)));
        } else {
#pragma unroll 8
          for (int i = 0; i < n; ++i) t = __fadd_rn(t, __shfl_sync(FULL, d_l, i));
          tmax = fmaxf(tmax, t);
        }
        deferred = true;
        continue;
      }
    }
    float w_l, c_l, f_l;
    if (FUSED) {
      w_l = in ? fw.draw((unsigned)k) : 0.f;
      c_l = in ? fc.draw((unsigned)k) : 0.f;
      f_l = RELY && in ? ff.uniform((unsigned)k) : 1.f;
    } else {
      w_l = in ? p.warms[srow + k] : 0.f;
      c_l = in ? p.colds[srow + k] : 0.f;
      f_l = RELY && in ? p.fail_u[srow + k] : 1.f;
    }
    const float u_l = FAULT && crash && in ? p.crash_u[srow + k] : 0.f;
    const float first_l = RETRY && in ? p.is_first[srow + k] : 0.f;
    const float child_l = RETRY && in ? p.child_pos[srow + k] : NO_CHILD_F;
    const float act_l = RETRY && in ? act[k] : 0.f;
    // activations of this batch's events made during this batch
    unsigned pend = 0u;
    // each event's gap (or time) and warm sample are broadcast one event
    // ahead of their use, off the chain of the routing
    float d_next = __shfl_sync(FULL, d_l, 0);
    for (int i = 0; i < n; ++i) {
      const float dt = d_next;
      d_next = __shfl_sync(FULL, d_l, (i + 1) & 31);
      const float w_i = __shfl_sync(FULL, w_l, i);
      const float t_new = p.prestamped ? dt : __fadd_rn(t, dt);
      const float hi = fminf(fmaxf(t_new, sk), tend);
      // a quiet event moves no clock-driven state: inside the horizon with
      // nothing deferred, the clipped clock not going back, no exit, grid
      // point, window bound or capacity step due
      bool quiet = t_new <= tend && !deferred && hi >= hi_prev && t_new < next_exit;
      if (GRID) quiet = quiet && next_g > t_new && t_new >= t;
      if (WIN) quiet = quiet && t_new >= hie_prev && cur.hi > t_new;
      if (capped)
        quiet = quiet && t_new >= cap_lo && t_new < cap_hi && (float)n_live <= cap_now;
      Newest r{0u, UINT_MAX};
      bool have_r = false;
      const bool counted = t_new > sk;
      if (!quiet) {
        const bool inert = !(t_new <= tend);
        if (!inert && deferred) {
          // back inside the horizon: first the exits deferred past it
          exit_pass<S, FAULT>(live, busy, doom, texp, tmax, sk, tend, n_live, next_exit,
                              crash_l);
          deferred = false;
        }
        if (GRID) {
          const float hi_g = fminf(t_new, tend);
          if (next_g <= hi_g) {
            // grid points in (t, hi_g]: counts on the pre-expiry pool
            for (int gb = 0; gb < G; gb += 32) {
              const int gi = gb + lane;
              const float g = gi < G ? __ldg(grow + gi) : 0.f;
              unsigned hit = __ballot_sync(FULL, gi < G && g > t && g <= hi_g);
              while (hit) {
                const int l = __ffs(hit) - 1;
                hit &= hit - 1;
                const float gg = __shfl_sync(FULL, g, l);
                int n_run = 0, n_idle = 0;
#pragma unroll
                for (int s = 0; s < S; ++s) {
                  const bool lv = ((live >> s) & 1u) && __fadd_rn(busy[s], texp) > gg;
                  n_run += __popc(__ballot_sync(FULL, lv && busy[s] > gg));
                  n_idle += __popc(__ballot_sync(FULL, lv && busy[s] <= gg));
                }
                if (lane == 0) {
                  float* a = gacc + gb + l;
                  a[0] = __fadd_rn(a[0], (float)n_run);
                  a[G] = __fadd_rn(a[G], (float)n_idle);
                  if (n_idle == 0) a[2 * G] = __fadd_rn(a[2 * G], 1.f);
                }
              }
            }
          }
          if (next_g <= t_new || t_new < t) next_g = next_grid(grow, G, t_new, lane);
        }
        if (inert) {
          // past the horizon: the clocks move (the windows' to t_end), the
          // exits wait
          if (WIN) cur.cross(live, busy, texp, fminf(t_new, tend), tend, lane);
          hie_prev = fminf(t_new, tend);
          hi_prev = hi;
          tmax = deferred ? fmaxf(tmax, t_new) : t_new;
          deferred = true;
          t = t_new;
          continue;
        }
        // where a clipped clock goes back, the live states count the
        // interval again
        if (hi < hi_prev) settle<S, FAULT>(live, busy, doom, texp, hi, hi_prev, tend, run_l, idle_l);
        if (WIN) {
          if (t_new < hie_prev) cur.back(live, busy, texp, t_new, hie_prev, tend, lane);
          else cur.cross(live, busy, texp, t_new, tend, lane);
        }
        // the exits (expiry, or a crash), once the clock reaches the bound
        if (t_new >= next_exit)
          exit_pass<S, FAULT>(live, busy, doom, texp, t_new, sk, tend, n_live, next_exit, crash_l);
        if (capped) {
          // capacity churn: evict the newest idle instances above the
          // ceiling, each choice after an eviction the next newest
          if (!(t_new >= cap_lo && t_new < cap_hi))
            cap_seek(cap_e, cap_v, p.E, t_new, lane, cap_now, cap_lo, cap_hi);
          const float over = __fsub_rn((float)n_live, cap_now);
          if (over > 0.f) {
            r = newest_idle<S>(live, ckey, busy, t_new, lane);
            have_r = true;
            int nev = 0;
            while ((float)nev < over && r.found()) {
              const bool mine = lane == (int)(r.j & 31u);
              const int cs = (int)(r.j >> 5);
              float be = busy[0], de = FAULT ? doom[0] : INFINITY;
#pragma unroll
              for (int s = 1; s < S; ++s) {
                be = s == cs ? busy[s] : be;
                de = s == cs ? doom[FAULT ? s : 0] : de;
              }
              // the state ends: it gives back what it accrued past hi
              const float2 a = slot_accrue<FAULT>(be, texp, de, hi, tend);
              run_l = __fsub_rn(run_l, mine ? a.x : 0.f);
              idle_l = __fsub_rn(idle_l, mine ? a.y : 0.f);
              if (mine) live &= ~(1u << cs);
              ++nev;
              r = newest_idle<S>(live, ckey, busy, t_new, lane);
            }
            if (nev) {
              n_live -= nev;
              if (counted) a_evict = __fadd_rn(a_evict, (float)nev);
            }
          }
        }
      }
      hi_prev = hi;
      if (WIN) hie_prev = t_new;

      bool active = true;
      float first_i = 1.f;
      if (RETRY) {
        first_i = __shfl_sync(FULL, first_l, i);
        const bool on = __shfl_sync(FULL, act_l, i) > 0.f || ((pend >> i) & 1u);
        active = first_i > 0.f || on;
      }
      // an inactive attempt changes nothing past the exits and evictions
      if (active) {
        if (!have_r) r = newest_idle<S>(live, ckey, busy, t_new, lane);
        const bool any_idle = r.found();
        bool is_cold = false, below = true, any_free = true, cut = false;
        float service = w_i;
        if (any_idle) {
          // warm: the newest idle instance, busy until done; its lane swaps
          // the accrual of the state that ends for the one that starts
          const float occ = RELY ? fminf(service, tto) : service;
          const float done = __fadd_rn(t_new, occ), expire = __fadd_rn(done, texp);
          const bool mine = lane == (int)(r.j & 31u);
          const int cs = (int)(r.j >> 5);
          float bw = busy[0], dw = FAULT ? doom[0] : INFINITY;
#pragma unroll
          for (int s = 1; s < S; ++s) {
            bw = s == cs ? busy[s] : bw;
            if (FAULT) dw = s == cs ? doom[FAULT ? s : 0] : dw;
          }
          const float2 was = slot_accrue<FAULT>(bw, texp, dw, hi, tend);
          const float2 now = accrue_of<FAULT>(done, expire, dw, hi, tend);
          run_l = __fadd_rn(run_l, mine ? __fsub_rn(now.x, was.x) : 0.f);
          idle_l = __fadd_rn(idle_l, mine ? __fsub_rn(now.y, was.y) : 0.f);
          if (WIN && cur.w < W) {
            const float2 wn = cur.window_accrue(done, texp, t_new, tend);
            const float2 ww = cur.window_accrue(bw, texp, t_new, tend);
            cur.r = __fadd_rn(cur.r, mine ? __fsub_rn(wn.x, ww.x) : 0.f);
            cur.i = __fadd_rn(cur.i, mine ? __fsub_rn(wn.y, ww.y) : 0.f);
          }
#pragma unroll
          for (int s = 0; s < S; ++s) busy[s] = mine && s == cs ? done : busy[s];
          // its exit moves to min(expire, doom), at least min(expire, the bound)
          next_exit = fminf(next_exit, expire);
          if (crash) cut = __shfl_sync(FULL, dw, r.j & 31u) < done;
        } else {
          // the slots are read only when no instance is idle
          const int first_free = first_free_slot<S>(live, M, lane);
          any_free = first_free >= 0;
          const float n_alive = (float)n_live;
          below = n_alive < p.max_c;
          // with a capacity profile a cold start also needs the live count
          // below the ceiling
          is_cold = below && any_free && (!capped || n_alive < cap_now);
          if (is_cold) {
            service = __shfl_sync(FULL, c_l, i);
            const float occ = RELY ? fminf(service, tto) : service;
            const float done = __fadd_rn(t_new, occ), expire = __fadd_rn(done, texp);
            float dn = INFINITY;  // the crash clock stamped at the cold start
            if (crash) {
              const float u = __shfl_sync(FULL, u_l, i);
              const float life =
                  crate > 0.f ? __fdiv_rn(-logf(__fsub_rn(1.f, u)), crate) : INFINITY;
              dn = __fadd_rn(t_new, life);
            }
            const bool mine = lane == (first_free & 31);
            const int cs = first_free >> 5;
            const float2 now = accrue_of<FAULT>(done, expire, dn, hi, tend);
            run_l = __fadd_rn(run_l, mine ? now.x : 0.f);
            idle_l = __fadd_rn(idle_l, mine ? now.y : 0.f);
            if (WIN && cur.w < W) {
              const float2 wn = cur.window_accrue(done, texp, t_new, tend);
              cur.r = __fadd_rn(cur.r, mine ? wn.x : 0.f);
              cur.i = __fadd_rn(cur.i, mine ? wn.y : 0.f);
            }
            const unsigned ck = order_key(t_new);
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const bool hit = mine && s == cs;
              busy[s] = hit ? done : busy[s];
              ckey[s] = hit ? ck : ckey[s];
              if (FAULT) doom[FAULT ? s : 0] = hit ? dn : doom[FAULT ? s : 0];
            }
            if (mine) live |= 1u << cs;
            ++n_live;
            next_exit = fminf(next_exit, fminf(expire, dn));
            cut = crash && dn < done;
          }
        }
        const bool assign = any_idle || is_cold;
        const float occ = RELY ? fminf(service, tto) : service;
        // the counters add 1 or 0 (a response or 0) each event, as the plain
        // version's rows do
        const bool cold_c = is_cold && counted, warm_c = any_idle && counted;
        a_cold = __fadd_rn(a_cold, cold_c ? 1.f : 0.f);
        a_cresp = __fadd_rn(a_cresp, cold_c ? occ : 0.f);
        a_warm = __fadd_rn(a_warm, warm_c ? 1.f : 0.f);
        a_wresp = __fadd_rn(a_wresp, warm_c ? occ : 0.f);
        a_rej = __fadd_rn(a_rej, !assign && counted ? 1.f : 0.f);
        // overflow is counted for active arrivals whether or not past skip
        a_over = __fadd_rn(a_over, !any_idle && below && !any_free ? 1.f : 0.f);

        if (WIN) {
          // the arrival (t_new = the window clock) lies in the cursor's
          // window when it has begun by t_new
          if (cur.w < W && cur.lo <= t_new) {
            if (is_cold) cur.c[0] = __fadd_rn(cur.c[0], 1.f);
            if (assign) cur.c[1] = __fadd_rn(cur.c[1], 1.f);
            cur.c[2] = __fadd_rn(cur.c[2], 1.f);
          }
        }

        bool interrupted = cut;
        if (RELY) {
          const bool timed_out = assign && service > tto;
          const bool failed = assign && !timed_out && __shfl_sync(FULL, f_l, i) < pf;
          interrupted = cut && !timed_out && !failed;
          const bool trigger = timed_out || failed || interrupted || !assign;
          if (counted) {
            if (timed_out) a_tout = __fadd_rn(a_tout, 1.f);
            if (failed) a_fail = __fadd_rn(a_fail, 1.f);
          }
          if (RETRY) {
            const float child_i = __shfl_sync(FULL, child_l, i);
            if (first_i <= 0.f && counted) a_retry = __fadd_rn(a_retry, 1.f);
            if (trigger && !(child_i < NO_CHILD_F) && counted)
              a_aband = __fadd_rn(a_aband, 1.f);
            // switch on the successor: a position of this row's stream
            if (trigger && child_i >= 0.f && child_i < (float)K) {
              const int c = (int)child_i;
              if ((float)c == child_i) {
                if (lane == 0) act[c] = 1.f;
                if (c >= base && c < base + 32) pend |= 1u << (c - base);
              }
            }
          } else if (trigger && counted) {
            a_aband = __fadd_rn(a_aband, 1.f);
          }
        }
        if (interrupted && counted) a_int = __fadd_rn(a_int, 1.f);
      }
      t = t_new;
    }
  }

  // the exits deferred past the horizon; then the live instances give back
  // what they accrued past the last clock
  if (deferred)
    exit_pass<S, FAULT>(live, busy, doom, texp, tmax, sk, tend, n_live, next_exit, crash_l);
  settle<S, FAULT>(live, busy, doom, texp, tend, hi_prev, tend, run_l, idle_l);
  if (WIN) {
    cur.add_live(live, busy, texp, INFINITY, hie_prev, tend);
    cur.leave(lane);
  }
  const float a_run = warp_sum(run_l), a_idle = warp_sum(idle_l);
  const float a_crash = (float)__reduce_add_sync(FULL, (unsigned)crash_l);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      p.alive_out[pool + j] = (live >> s) & 1u ? 1.f : 0.f;
      p.creation_out[pool + j] = key_value(ckey[s]);
      p.busy_out[pool + j] = busy[s];
      if (crash) p.doom_out[pool + j] = doom[FAULT ? s : 0];
    }
  }
  if (lane == 0) {
    p.t_out[row] = t;
    arow[0] = a_cold;
    arow[1] = a_warm;
    arow[2] = a_rej;
    arow[3] = a_run;
    arow[4] = a_idle;
    arow[5] = a_cresp;
    arow[6] = a_wresp;
    arow[7] = a_over;
    float* r = gacc + 3 * G;
    if (RELY) {
      r[0] = a_tout;
      r[1] = a_fail;
      r[2] = a_retry;
      r[3] = a_aband;
      r += 4;
    }
    if (FAULT) {
      r[0] = a_crash;
      r[1] = a_evict;
      r[2] = a_int;
    }
  }
}

template <int S, bool GRID, bool WIN, bool RELY, bool RETRY, bool FUSED = false,
          bool FAULT = false>
void launch_one(const Params& p, cudaStream_t stream) {
  const dim3 blocks((p.R + WARPS - 1) / WARPS), threads(WARPS * 32);
  // the widest pools' creation keys (and crash clocks) in shared memory
  const size_t smem = S > 16 ? (size_t)WARPS * (FAULT ? 2 : 1) * S * 32 * sizeof(float) : 0;
  faas_sweep_kernel<S, GRID, WIN, RELY, RETRY, FUSED, FAULT>
      <<<blocks, threads, smem, stream>>>(p);
}

// the flag sets the front door reaches: GRID alone (the temporal engine);
// windows and/or reliability, with or without retries, staged or (without
// retries) fused draws, and staged faults alone, with reliability or with
// retries (the scan engine)
template <int S>
bool launch(const Params& p, int flags, cudaStream_t st) {
  switch (flags) {
    case 0: launch_one<S, false, false, false, false>(p, st); return true;
    case F_GRID: launch_one<S, true, false, false, false>(p, st); return true;
    case F_WIN: launch_one<S, false, true, false, false>(p, st); return true;
    case F_RELY: launch_one<S, false, false, true, false>(p, st); return true;
    case F_WIN | F_RELY: launch_one<S, false, true, true, false>(p, st); return true;
    case F_RELY | F_RETRY: launch_one<S, false, false, true, true>(p, st); return true;
    case F_WIN | F_RELY | F_RETRY:
      launch_one<S, false, true, true, true>(p, st);
      return true;
    case F_FUSED: launch_one<S, false, false, false, false, true>(p, st); return true;
    case F_FUSED | F_WIN: launch_one<S, false, true, false, false, true>(p, st); return true;
    case F_FUSED | F_RELY: launch_one<S, false, false, true, false, true>(p, st); return true;
    case F_FUSED | F_WIN | F_RELY:
      launch_one<S, false, true, true, false, true>(p, st);
      return true;
    case F_FAULT: launch_one<S, false, false, false, false, false, true>(p, st); return true;
    case F_FAULT | F_RELY:
      launch_one<S, false, false, true, false, false, true>(p, st);
      return true;
    case F_FAULT | F_RELY | F_RETRY:
      launch_one<S, false, false, true, true, false, true>(p, st);
      return true;
    default: return false;
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  Inputs: alive, creation, busy [R, M];
// t0, t_exp, t_end, skip [R]; dts, warms, colds [R, K] (null with fused
// draws); then the optional paths' inputs, each null when its path is off:
// grid [R, G] (G > 0), window_bounds [R, W+1] (W > 0, strictly
// increasing), t_timeout, p_fail [R] and fail_u [R, K] (reliability; null
// fail_u with fused draws), is_first, child_pos [R, K] (retries, with
// reliability) — all f32, contiguous, on `device`; fused draws: uint32 key
// pairs [R, 2] arrival, warm, cold (and fail with reliability), f32
// parameter pairs [R, 2] arrival, warm, cold and the three distribution
// ids (FUSED_DISTS order); faults: crash_rate [R] and crash_u [R, K]
// (crashes), cap_edges [R, E] (strictly increasing, > 0; null when E = 0)
// and cap_values [R, E+1] (capacity).  Outputs: alive, creation, busy [R,
// M], t [R], acc [R, 8 + 5W + 3G + 4 with reliability + 3 with faults],
// act [R, K] with retries and doom [R, M] with crashes (else null).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments no instance takes.
extern "C" int faas_sweep_f32(
    const void* alive_in, const void* creation_in, const void* busy_in,
    const void* t0, const void* t_exp, const void* t_end, const void* skip,
    const void* dts, const void* warms, const void* colds, const void* grid,
    const void* window_bounds, const void* t_timeout, const void* p_fail,
    const void* fail_u, const void* is_first, const void* child_pos,
    const void* akey, const void* wkey, const void* ckey, const void* fkey,
    const void* apar, const void* wpar, const void* cpar, const void* crash_rate,
    const void* crash_u, const void* cap_edges, const void* cap_values,
    void* alive_out, void* creation_out, void* busy_out, void* t_out,
    void* acc_out, void* act_out, void* doom_out, int R, int M, int K, int G, int W,
    int E, int max_concurrency, int prestamped, int d_arr, int d_warm, int d_cold,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool rely = t_timeout != nullptr, retry = is_first != nullptr;
  const bool fused = akey != nullptr;
  const bool crash = crash_u != nullptr, capped = cap_values != nullptr;
  const int flags = (G > 0 ? F_GRID : 0) | (W > 0 ? F_WIN : 0) |
                    (rely ? F_RELY : 0) | (retry ? F_RETRY : 0) |
                    (fused ? F_FUSED : 0) | (crash || capped ? F_FAULT : 0);
  const bool dists_ok = d_arr >= 0 && d_arr < N_DISTS && d_warm >= 0 &&
                        d_warm < N_DISTS && d_cold >= 0 && d_cold < N_DISTS;
  if (R < 1 || M < 1 || M > 1024 || K < 0 || G < 0 || G > MAX_GRID || W < 0 ||
      W > MAX_WINDOWS || (G > 0 && grid == nullptr) ||
      (W > 0 && window_bounds == nullptr) ||
      (rely && (p_fail == nullptr || (fused ? fkey : fail_u) == nullptr)) ||
      (retry && (child_pos == nullptr || act_out == nullptr || K > (1 << 24))) ||
      (fused && (wkey == nullptr || ckey == nullptr || apar == nullptr ||
                 wpar == nullptr || cpar == nullptr || !dists_ok || prestamped)) ||
      (!fused && (dts == nullptr || warms == nullptr || colds == nullptr)) ||
      (crash && (crash_rate == nullptr || doom_out == nullptr)) ||
      (capped && (E < 0 || (E > 0 && cap_edges == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.alive_in = (const float*)alive_in;
  p.creation_in = (const float*)creation_in;
  p.busy_in = (const float*)busy_in;
  p.t0 = (const float*)t0;
  p.t_exp = (const float*)t_exp;
  p.t_end = (const float*)t_end;
  p.skip = (const float*)skip;
  p.dts = (const float*)dts;
  p.warms = (const float*)warms;
  p.colds = (const float*)colds;
  p.grid = (const float*)grid;
  p.wb = (const float*)window_bounds;
  p.t_to = (const float*)t_timeout;
  p.p_fail = (const float*)p_fail;
  p.fail_u = (const float*)fail_u;
  p.is_first = (const float*)is_first;
  p.child_pos = (const float*)child_pos;
  p.keys[0] = (const unsigned*)akey;
  p.keys[1] = (const unsigned*)wkey;
  p.keys[2] = (const unsigned*)ckey;
  p.keys[3] = (const unsigned*)fkey;
  p.params[0] = (const float*)apar;
  p.params[1] = (const float*)wpar;
  p.params[2] = (const float*)cpar;
  p.dists[0] = d_arr;
  p.dists[1] = d_warm;
  p.dists[2] = d_cold;
  p.crate = (const float*)crash_rate;
  p.crash_u = (const float*)crash_u;
  p.cap_e = (const float*)cap_edges;
  p.cap_v = (const float*)cap_values;
  p.alive_out = (float*)alive_out;
  p.creation_out = (float*)creation_out;
  p.busy_out = (float*)busy_out;
  p.t_out = (float*)t_out;
  p.acc_out = (float*)acc_out;
  p.act_out = (float*)act_out;
  p.doom_out = (float*)doom_out;
  p.R = R;
  p.M = M;
  p.K = K;
  p.G = G;
  p.W = W;
  p.E = capped ? E : 0;
  p.cols = ACC_COLS + 5 * W + 3 * G + (rely ? 4 : 0) + (crash || capped ? 3 : 0);
  p.max_c = (float)max_concurrency;
  p.prestamped = prestamped;
  cudaStream_t st = (cudaStream_t)stream;
  const int s = (M + 31) / 32;
  bool ok;
  if (s <= 1) ok = launch<1>(p, flags, st);
  else if (s <= 2) ok = launch<2>(p, flags, st);
  else if (s <= 4) ok = launch<4>(p, flags, st);
  else if (s <= 8) ok = launch<8>(p, flags, st);
  else if (s <= 16) ok = launch<16>(p, flags, st);
  else ok = launch<32>(p, flags, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
