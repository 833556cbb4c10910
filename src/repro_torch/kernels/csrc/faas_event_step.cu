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
// arrival is rejected.
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
// min(t_new, t_end)] (windows ignore skip).  Only the windows that
// overlap the interval give a nonzero term; the clock does not go back,
// so a cursor (the first window ending past the clock) visits one or two
// windows per event instead of all W.  The skipped terms are +0 added to
// sums that start at +0, so the counts stay bit-equal.  The cursor's
// columns stay in registers until it leaves the window, so no event waits
// on a global read-modify-write.  A row whose clock does go back rescans
// from window 0, reloading what it stored.
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
// ceil(live - ceiling) of the newest idle instances are evicted: one warp
// arg-max pass over (creation, lower slot on a tie) per eviction, the
// routing rule, so the pass after the last eviction leaves the routing
// candidate.  The row's segment [lo, hi) stays in registers and is looked
// up again only when t_new leaves it.  With the crash clocks off the
// doom plane holds +inf, which leaves every min() above the identity, so
// one template instance serves crashes, capacity or both (a runtime,
// warp-uniform choice); without FAULT the code is the path without faults.
//
// What bounds it on this card: every event touches every slot of the row
// (~25 f32 operations per slot in the body below, ~12 more per slot and
// overlapping window) while the samples are 12 to 24 bytes per event, so
// at M = 64 it does over 60 operations per byte: above the H100's f32
// balance point (67 TFLOP/s over 3.35 TB/s, ~20 operations per byte).  It
// is bound by operations, and each row is a sequential chain of events,
// so the latency of each event's reductions matters as much as their
// count.
//
// Fused draws add per event about 130 integer operations a stream (3 or 4
// streams) and up to 4 transcendental calls, against the ~25 M f32
// operations of the pool walk, and remove the 12-16 bytes of sample loads.
//
// What the design does about that: one warp per row, with the pool in
// registers (ceil(M/32) slots per lane), so no pool state ever leaves the
// SM.  Samples are loaded 32 events at a time, one per lane (coalesced),
// and broadcast per event with __shfl_sync; with fused draws lane l draws
// event base + l of the batch instead of loading it, so the 32 lanes draw a
// batch in parallel and the broadcast stays.  The per-event reductions over
// the pool are warp shuffles (sums and the argmax by xor butterflies) and
// ballots (the lowest free slot); the butterflies leave the same bits in
// every lane, so the row's clock and accumulators are replicated per lane
// and no lane ever waits on shared memory.  The window, grid and
// activation planes are unbounded in W, G and K, so they live in global
// memory: lane 0 adds each grid term in event order, and stores each
// window's columns when the cursor leaves it.  A retry's child can fall
// inside the 32-event batch whose activations were loaded at its start, so
// activations made during a batch for that batch's own events ride in a
// warp-uniform bitmask (pend); the global plane is read at the next
// batch's start after a __syncwarp() that orders lane 0's stores.  Many
// rows per SM (4 per block, thousands per grid) hide each chain's latency.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py): every
// clock update is one rounded f32 operation (built with --fmad=false, and
// written with __fadd_rn), the sentinels are the reference's (NEG = -1e30
// for dead slots, any_idle = best > NEG/2), and the acc columns are
// per-row sequential sums in the same order.  Only the M-reductions of the
// integrals (acc columns 3-4 and each window's two integral columns) sum
// in a different order, so they may differ from the plain version in the
// last places.  Counts (base, window, grid, reliability) and the
// activation plane are exact.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "event_step_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float NO_CHILD_F = 1073741824.f;  // 2^30, a last attempt's child_pos
constexpr int WARPS = 4;  // rows per block
constexpr int ACC_COLS = 8;
constexpr int MAX_GRID = 1024;  // grid points per row (3 acc columns each)
constexpr int MAX_WINDOWS = 65536;  // windows per row (5 acc columns each)

// which optional paths a launch runs (a template instance each)
constexpr int F_GRID = 1, F_WIN = 2, F_RELY = 4, F_RETRY = 8, F_FUSED = 16, F_FAULT = 32;

// fused distribution ids (repro_torch/core/drawplan.py FUSED_DISTS)
enum Dist { D_EXP = 0, D_DET, D_GAUSS, D_WEIBULL, D_LOGNORM, D_PARETO, N_DISTS };

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

// four threefry rounds with rotations R0..R3
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(unsigned& x0, unsigned& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3); x1 ^= x0;
}

// threefry-2x32, 20 rounds, of the counter (c0, 0) under key (k0, k1): five
// blocks of four rounds, after block b the key words (b+1)%3 and (b+2)%3 and
// the block number b+1 injected
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1, unsigned c0,
                                             unsigned& o0, unsigned& o1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  unsigned x0 = c0 + k0, x1 = k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

// a [0, 1) uniform from a word: its top 23 bits fill the mantissa of 1.0
__device__ __forceinline__ float uniform_from_bits(unsigned b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.f);
}

__device__ __forceinline__ float box_muller(float u0, float u1) {
  const float r = sqrtf(__fmul_rn(-2.f, logf(__fsub_rn(1.f, u0))));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831855f, u1)));
}

// one sample by inverse CDF or Box-Muller, as drawplan.sample_dist
__device__ __forceinline__ float sample_dist(int kind, float u0, float u1, float p0,
                                             float p1) {
  float out;
  switch (kind) {
    case D_EXP: out = __fdiv_rn(-logf(__fsub_rn(1.f, u0)), p0); break;
    case D_DET: out = p0; break;
    case D_GAUSS: out = __fadd_rn(p0, __fmul_rn(p1, box_muller(u0, u1))); break;
    case D_WEIBULL:
      out = __fmul_rn(p1, powf(-logf(__fsub_rn(1.f, u0)), __fdiv_rn(1.f, p0)));
      break;
    case D_LOGNORM: out = expf(__fadd_rn(p0, __fmul_rn(p1, box_muller(u0, u1)))); break;
    default: out = __fdiv_rn(p1, powf(__fsub_rn(1.f, u0), __fdiv_rn(1.f, p0))); break;
  }
  return fmaxf(out, 1e-9f);
}

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

// the newest idle instance of the pool (largest creation, lowest slot on a
// tie) as best/best_j in every lane; best = NEG when no instance is idle
template <int S>
__device__ __forceinline__ void newest_idle(const float (&alive)[S], const float (&cre)[S],
                                            const float (&busy)[S], float t_new, int lane,
                                            float& best, int& best_j) {
  best = NEG;
  best_j = INT_MAX;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    // this lane's slots ascend with s, so '>' keeps the lowest slot on a tie
    if (alive[s] > 0.f && busy[s] <= t_new && cre[s] > best) {
      best = cre[s];
      best_j = s * 32 + lane;
    }
  }
  warp_argmax(best, best_j);
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

// The window cursor: the first window ending past the clock, whose five
// acc columns (cold, served, arrivals, ∫running, ∫idle) live in registers,
// the same in every lane, from entering the window to leaving it; every
// term of a window is added while it is the cursor, in event order.
struct WindowCursor {
  const float* bounds;  // the row's W + 1 bounds
  float* acc;           // the row's 5W window columns
  int W, w;
  float lo, hi;  // window w's bounds (+inf past the last window)
  float c[5];

  __device__ __forceinline__ void enter(int to) {
    __syncwarp();  // lane 0's store of a window left earlier, before the loads
    w = to;
    lo = w < W ? __ldg(bounds + w) : INFINITY;
    hi = w < W ? __ldg(bounds + w + 1) : INFINITY;
#pragma unroll
    for (int k = 0; k < 5; ++k) c[k] = w < W ? acc[k * W + w] : 0.f;
  }
  __device__ __forceinline__ void leave(int lane) {
    if (w < W && lane == 0)
#pragma unroll
      for (int k = 0; k < 5; ++k) acc[k * W + w] = c[k];
  }
  __device__ __forceinline__ void next(int lane) {
    leave(lane);
    enter(w + 1);
  }
};

// S: slots per lane (M <= 32 * S); GRID, WIN, RELY, RETRY, FUSED, FAULT:
// the optional paths (RETRY implies RELY; FUSED goes without GRID and
// RETRY; FAULT without GRID, WIN and FUSED)
template <int S, bool GRID, bool WIN, bool RELY, bool RETRY, bool FUSED, bool FAULT>
__global__ void __launch_bounds__(WARPS * 32) faas_sweep_kernel(const Params p) {
  static_assert(!RETRY || RELY, "retries ride on the reliability path");
  static_assert(!FUSED || (!GRID && !RETRY), "fused draws serve base, windows, reliability");
  static_assert(!FAULT || (!GRID && !WIN && !FUSED), "faults serve base, reliability, retries");
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= p.R) return;  // the ragged last block: the whole warp leaves
  const int M = p.M, K = p.K, G = p.G, W = p.W;

  // slot j = s * 32 + lane; slots past M do not exist (never alive, never free)
  const size_t pool = (size_t)row * M;
  float alive[S], cre[S], busy[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    const bool ex = j < M;
    alive[s] = ex ? p.alive_in[pool + j] : 0.f;
    cre[s] = ex ? p.creation_in[pool + j] : NEG;
    busy[s] = ex ? p.busy_in[pool + j] : NEG;
  }
  float t = p.t0[row];
  const float texp = p.t_exp[row], tend = p.t_end[row], sk = p.skip[row];
  const float tto = RELY ? p.t_to[row] : 0.f;
  const float pf = RELY ? p.p_fail[row] : 0.f;
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f, a_run = 0.f, a_idle = 0.f;
  float a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f;
  float a_tout = 0.f, a_fail = 0.f, a_retry = 0.f, a_aband = 0.f;
  // faults: the crash clocks (+inf: none stamped), the row's crash rate and
  // capacity profile, its current segment (empty: looked up at the first
  // event) and the fault columns
  float doom[S];
  const bool crash = FAULT && p.crash_u != nullptr;
  const bool capped = FAULT && p.cap_v != nullptr;
  const float crate = crash ? p.crate[row] : 0.f;
  const float* cap_e = capped ? p.cap_e + (size_t)row * p.E : nullptr;
  const float* cap_v = capped ? p.cap_v + (size_t)row * (p.E + 1) : nullptr;
  float cap_now = 0.f, cap_lo = INFINITY, cap_hi = -INFINITY;
  float a_crash = 0.f, a_evict = 0.f, a_int = 0.f;
  if (FAULT) {
#pragma unroll
    for (int s = 0; s < S; ++s) doom[s] = INFINITY;
  }
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
  WindowCursor cur;
  if (WIN) {
    cur.bounds = wrow;
    cur.acc = wacc;
    cur.W = W;
    cur.enter(0);
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
    // lane l loads (or, fused, draws) event base + l of the batch
    float d_l, w_l, c_l, f_l;
    if (FUSED) {
      d_l = in ? fa.draw((unsigned)k) : 0.f;
      w_l = in ? fw.draw((unsigned)k) : 0.f;
      c_l = in ? fc.draw((unsigned)k) : 0.f;
      f_l = RELY && in ? ff.uniform((unsigned)k) : 1.f;
    } else {
      d_l = in ? p.dts[srow + k] : 0.f;
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
    const int n = min(32, K - base);
    for (int i = 0; i < n; ++i) {
      const float dt = __shfl_sync(FULL, d_l, i);
      const float warm_s = __shfl_sync(FULL, w_l, i);
      const float cold_s = __shfl_sync(FULL, c_l, i);
      const float t_new = p.prestamped ? dt : __fadd_rn(t, dt);
      const float lo = fminf(fmaxf(t, sk), tend);
      const float hi = fminf(fmaxf(t_new, sk), tend);

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
                const bool live = alive[s] > 0.f && __fadd_rn(busy[s], texp) > gg;
                n_run += __popc(__ballot_sync(FULL, live && busy[s] > gg));
                n_idle += __popc(__ballot_sync(FULL, live && busy[s] <= gg));
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

      // the window integrals over (lo_e, hi_e] on the pre-expiry pool
      const float hi_e = fminf(t_new, tend);
      if (WIN) {
        const float lo_e = fminf(t, tend);
        if (t_new < t) {  // the clock went back: rescan from window 0
          cur.leave(lane);
          cur.enter(0);
        }
        if (lo_e < hi_e) {
          while (cur.w < W && cur.hi <= lo_e) cur.next(lane);
          // the windows overlapping the interval, each in turn the cursor
          while (cur.w < W && cur.lo < hi_e) {
            const float wlo = fmaxf(cur.lo, lo_e), whi = fminf(cur.hi, hi_e);
            if (wlo < whi) {
              float r_l = 0.f, i_l = 0.f;
#pragma unroll
              for (int s = 0; s < S; ++s) {
                const float expire = __fadd_rn(busy[s], texp);
                const float r = fmaxf(__fsub_rn(fminf(busy[s], whi), wlo), 0.f);
                const float d =
                    fmaxf(__fsub_rn(fminf(expire, whi), fmaxf(busy[s], wlo)), 0.f);
                r_l = __fadd_rn(r_l, __fmul_rn(r, alive[s]));
                i_l = __fadd_rn(i_l, __fmul_rn(d, alive[s]));
              }
              cur.c[3] = __fadd_rn(cur.c[3], warp_sum(r_l));
              cur.c[4] = __fadd_rn(cur.c[4], warp_sum(i_l));
            }
            if (cur.hi > hi_e) break;  // the window goes on past the interval
            cur.next(lane);
          }
        }
      }

      // integrals over (lo, hi] on the pre-expiry pool, then expiry, then
      // the routing candidates on the post-expiry pool
      float run_l = 0.f, idle_l = 0.f, alive_l = 0.f;
      float best = NEG;
      int best_j = INT_MAX;
      int crash_l = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float expire = __fadd_rn(busy[s], texp);
        // a crashed instance accrues nothing past its doom
        const float stop = FAULT ? fminf(hi, doom[s]) : hi;
        const float r = fmaxf(__fsub_rn(fminf(busy[s], stop), lo), 0.f);
        const float d = fmaxf(__fsub_rn(fminf(expire, stop), fmaxf(busy[s], lo)), 0.f);
        run_l = __fadd_rn(run_l, __fmul_rn(r, alive[s]));
        idle_l = __fadd_rn(idle_l, __fmul_rn(d, alive[s]));
        if (FAULT) {
          // the exit clock that fires first: expiry, or a crash
          if (alive[s] > 0.f && fminf(expire, doom[s]) <= t_new) {
            crash_l += doom[s] < expire && doom[s] > sk && doom[s] <= tend;
            alive[s] = 0.f;
          }
        } else if (alive[s] > 0.f && expire <= t_new) {
          alive[s] = 0.f;
        }
        alive_l = __fadd_rn(alive_l, alive[s]);
        // this lane's slots ascend with s, so '>' keeps the lowest slot on a tie
        if (alive[s] > 0.f && busy[s] <= t_new && cre[s] > best) {
          best = cre[s];
          best_j = s * 32 + lane;
        }
      }
      const float run_sum = warp_sum(run_l);
      const float idle_sum = warp_sum(idle_l);
      float n_alive = warp_sum(alive_l);
      warp_argmax(best, best_j);
      if (crash) {
        const int n_crash = (int)__reduce_add_sync(FULL, (unsigned)crash_l);
        if (n_crash) a_crash = __fadd_rn(a_crash, (float)n_crash);
      }
      if (capped) {
        // capacity churn: evict the newest idle instances above the
        // ceiling, each pass's arg-max the next newest
        if (!(t_new >= cap_lo && t_new < cap_hi))
          cap_seek(cap_e, cap_v, p.E, t_new, lane, cap_now, cap_lo, cap_hi);
        const float over = __fsub_rn(n_alive, cap_now);
        if (over > 0.f && t_new <= tend) {
          int nev = 0;
          while ((float)nev < over && best > NEG * 0.5f) {
#pragma unroll
            for (int s = 0; s < S; ++s)
              if (s * 32 + lane == best_j) alive[s] = 0.f;
            ++nev;
            newest_idle<S>(alive, cre, busy, t_new, lane, best, best_j);
          }
          if (nev) {
            n_alive = __fsub_rn(n_alive, (float)nev);
            if (t_new > sk) a_evict = __fadd_rn(a_evict, (float)nev);
          }
        }
      }
      int first_free = -1;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const unsigned fm = __ballot_sync(FULL, s * 32 + lane < M && alive[s] <= 0.f);
        if (first_free < 0 && fm) first_free = s * 32 + __ffs(fm) - 1;
      }

      bool active = t_new <= tend;
      float first_i = 1.f, child_i = NO_CHILD_F;
      if (RETRY) {
        first_i = __shfl_sync(FULL, first_l, i);
        child_i = __shfl_sync(FULL, child_l, i);
        const bool on = __shfl_sync(FULL, act_l, i) > 0.f || ((pend >> i) & 1u);
        active = active && (first_i > 0.f || on);
      }
      const bool any_idle = best > NEG * 0.5f;
      const bool any_free = first_free >= 0;
      const bool counted = t_new > sk;
      const bool below = n_alive < p.max_c;
      // with a capacity profile a cold start also needs the live count below
      // the ceiling
      const bool can_cold = !any_idle && below && any_free && (!capped || n_alive < cap_now);
      const bool is_warm = any_idle && active;
      const bool is_cold = can_cold && active;
      const bool is_reject = !any_idle && !can_cold && active;
      const bool assign = is_warm || is_cold;
      const float service = is_warm ? warm_s : cold_s;
      // the served attempt's instance dies before the attempt ends
      bool cut = false;
      if (assign) {
        const int chosen = is_warm ? best_j : first_free;
        const float done = __fadd_rn(t_new, RELY ? fminf(service, tto) : service);
        float life = INFINITY;
        if (crash && is_cold) {
          const float u = __shfl_sync(FULL, u_l, i);
          if (crate > 0.f) life = __fdiv_rn(-logf(__fsub_rn(1.f, u)), crate);
        }
        float dc = INFINITY;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s * 32 + lane == chosen) {
            busy[s] = done;
            if (is_cold) {
              cre[s] = t_new;
              alive[s] = 1.f;
              if (crash) doom[s] = __fadd_rn(t_new, life);
            }
            if (FAULT) dc = doom[s];
          }
        }
        if (crash) cut = __shfl_sync(FULL, dc, chosen & 31) < done;
      }
      if (counted) {
        if (is_cold) {
          a_cold = __fadd_rn(a_cold, 1.f);
          a_cresp = __fadd_rn(a_cresp, RELY ? fminf(cold_s, tto) : cold_s);
        }
        if (is_warm) {
          a_warm = __fadd_rn(a_warm, 1.f);
          a_wresp = __fadd_rn(a_wresp, RELY ? fminf(warm_s, tto) : warm_s);
        }
        if (is_reject) a_rej = __fadd_rn(a_rej, 1.f);
      }
      a_run = __fadd_rn(a_run, run_sum);
      a_idle = __fadd_rn(a_idle, idle_sum);
      // overflow is counted for active arrivals whether or not past skip
      if (!any_idle && below && !any_free && active) a_over = __fadd_rn(a_over, 1.f);

      if (WIN) {
        // the cursor moves to the first window ending past hi_e; an active
        // arrival (t_new = hi_e) lies in it when it has begun by t_new
        while (cur.w < W && cur.hi <= hi_e) cur.next(lane);
        if (active && cur.w < W && cur.lo <= t_new) {
          if (is_cold) cur.c[0] = __fadd_rn(cur.c[0], 1.f);
          if (assign) cur.c[1] = __fadd_rn(cur.c[1], 1.f);
          cur.c[2] = __fadd_rn(cur.c[2], 1.f);
        }
      }

      bool interrupted = cut;
      if (RELY) {
        const float fail_i = __shfl_sync(FULL, f_l, i);
        const bool timed_out = assign && service > tto;
        const bool failed = assign && !timed_out && fail_i < pf;
        interrupted = cut && !timed_out && !failed;
        const bool trigger = timed_out || failed || interrupted || is_reject;
        if (counted) {
          if (timed_out) a_tout = __fadd_rn(a_tout, 1.f);
          if (failed) a_fail = __fadd_rn(a_fail, 1.f);
        }
        if (RETRY) {
          if (first_i <= 0.f && active && counted) a_retry = __fadd_rn(a_retry, 1.f);
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
      t = t_new;
    }
  }

  if (WIN) cur.leave(lane);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      p.alive_out[pool + j] = alive[s];
      p.creation_out[pool + j] = cre[s];
      p.busy_out[pool + j] = busy[s];
      if (crash) p.doom_out[pool + j] = doom[s];
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
  faas_sweep_kernel<S, GRID, WIN, RELY, RETRY, FUSED, FAULT>
      <<<blocks, threads, 0, stream>>>(p);
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
