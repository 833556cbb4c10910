// Hopper (sm_90a) kernel of the f64 engine's pool scan (backend "scan").
//
// No Pallas kernel is replaced: the reference runs this loop as a
// lax.scan, one step per event (repro/core/simulator.py::_make_scan_fn,
// then _flush; the temporal engine's grid snapshots in
// repro/core/temporal.py::_simulate_temporal).  Each row (one replica or
// grid cell) runs K events from its initial pool of M slots, in f64:
//   - the clock: the previous clock plus the f32 gap, or the f64 timestamp
//     of a prestamped stream (a timestamp process or a retry table);
//   - with grid points: the running and idle counts of the pre-event pool
//     at each point inside (t_prev, min(t, t_end)];
//   - exact ∫running and ∫idle over the interval clipped to [skip, t_end]
//     (cut at each slot's crash time with crashes), per metric window over
//     the interval clipped to t_end, and the time spent at each total
//     instance count (the histogram);
//   - exits at or before the clock: expiry at busy + t_exp, or a crash at
//     doom when it comes strictly first; lifespans of exits in
//     (skip, t_end];
//   - capacity churn: the newest idle instances above the ceiling in
//     effect are evicted, and no cold start goes over it;
//   - routing: the newest (or, routing "oldest", the oldest) idle instance
//     serves warm, lowest slot on a creation tie (jnp.argmax's rule), else
//     the lowest free slot below max_concurrency instances cold-starts,
//     else the event is rejected; with retries a non-first attempt acts
//     only once its parent switched it on in the activation plane;
//   - reliability: the instance is held min(service, t_timeout); a served
//     attempt times out past t_timeout, else fails below p_fail, else (with
//     crashes) is interrupted when its instance's crash comes first; each
//     such trigger (and a rejection) switches the attempt's retry on;
// then the tail (t_last, t_end] is flushed as the reference does.
//
// Fused draws (FUSED; the reference's _scan_one_fused, simulator.py:1144,
// with _make_scan_fn's thin=): no staged sample is read.  Event k's gap,
// warm and cold samples (and, with reliability, its failure uniform) are
// threefry-2x32 of the counter (k, 0) under the row's per-stream keys,
// the f32 uniforms cast to f64 and transformed in f64 (threefry.cuh
// sample_dist64).  With NHPP thinning the gap is the envelope's
// exponential at lam = max_rate, and a candidate whose acceptance uniform
// (word 1 of its arrival draw) has u * lam > rate(t) (profile_rate) is an
// inert arrival: it moves the clock, integrates and expires, and routes
// nothing.  Draws do not depend on the pool, so lane l draws event k0 + l
// of each batch and the event's samples are broadcast by shuffle as staged
// ones are; the clock is still accumulated t_prev + gap one event at a
// time, in the reference's order (a warp prefix sum of the gaps would round
// differently).  A batch wholly past the horizon draws only its gaps.
// Instances: base, windows, the histogram, fail-only reliability and both
// routings; no grid points, retries, faults or prestamped streams, as the
// reference's fused backend serves.
//
// What bounds it on this card: each row is a chain of dependent events,
// and an event's samples are 12 to 30 bytes read once.  The first design
// (one warp a row, every path a runtime flag) did the reference's work on
// every slot of every staged event: the interval's integrals on each live
// slot, a binary search and two warp sums for each window, a walk of the
// in-window expiries for the histogram, a ballot over the grid points, an
// exit test and a live count per slot, and an (f64, slot) argmax of five
// dependent shuffle rounds, on the 58.7% of Table 1's events past their
// horizons too: 157x its byte bound.  An event changes at most one
// instance, and one past the horizon changes none.
//
// What the design does about that: one warp per row, the pool in registers
// (ceil(M/32) slots a lane: busy, the creation's order key and, with
// faults, the crash clock; the alive flags a bitmask), and work only where
// an event changes something (the f32 kernel's design, event_step_common.cuh
// and faas_event_step.cu, in f64):
//   - ∫running and ∫idle are accrued per state span (scan64_common.cuh
//     accrue, cut at the crash clock): the owning lane adds accrue(hi) of
//     an instance when its state starts (a cold or warm start, or the
//     initial pool) and subtracts it when the state ends (a warm start, an
//     eviction; an exit accrues nothing past its exit clock); the tail
//     flush is what every live state accrued up to t_end.  Each lane keeps
//     its own part, summed across the warp once at the end.  Where the
//     clipped clock goes back (unsorted f64 timestamps, negative gaps) a
//     pass over the live slots adds accrue(hi) - accrue(hi_prev), the
//     interval the plain version counts again.
//   - The metric windows: a cursor (the first window ending past the
//     window clock min(t, t_end)) holds its window's four counts and this
//     lane's part of its two integrals in registers; states accrue into it
//     as above, every live state enters a window when the clock crosses
//     into it (one pass at each crossing), and the columns are stored when
//     the cursor leaves.  Windows do not stop at a crash (the reference's
//     window_integrals does not), so a crash exit gives back what the
//     state accrued in the cursor's window past the removal.
//   - The histogram is credited where the count changes (hist_credit):
//     before each exit pass, eviction and cold start, and at the end.
//   - Grid points: the smallest grid time past the clock (next_g), so an
//     event with no grid point costs one warp-uniform compare.
//   - Exits: the row keeps a lower bound of its earliest exit clock
//     (expiry, or a crash when that comes first), lowered at each start
//     and exact after each exit pass, and runs the exit pass (a test a
//     slot, one redux for the live count, two for the new bound) only once
//     the clock reaches it.  The live count is a warp-uniform counter.
//   - Routing on order keys: the 64-bit order key of the f64 creation time
//     (its complement for "oldest"), reduced as its high word, its low word
//     among the ties, then the lowest slot; equal creations keep equal keys,
//     so the lowest slot wins as in jnp.argmax, and capacity evictions take
//     the newest by the same key.  The free-slot ballots run only when no
//     instance is idle.
//   - A quiet event (inside the horizon, nothing deferred, the clock not
//     going back, no exit, grid point, window bound or capacity step due:
//     one warp-uniform test on the raw clock) goes straight to the routing.
//     Its gap and warm sample were broadcast during the event before.
//   - The inert tail: an event past t_end moves the clock and nothing
//     else.  Exits past t_end are deferred to one pass at the largest clock
//     reached (expiry is monotone in the clock while nothing is assigned),
//     run before the next event inside the horizon and at the end.  A
//     32-event batch wholly past t_end (the clock past it, and gaps >= 0 or
//     timestamps past it) only adds its gaps to the clock, one at a time so
//     that t rounds as the plain version's does; its warm, cold and other
//     samples are not loaded.
// Samples are loaded 32 events at a time, one per lane (coalesced), and
// broadcast per event with __shfl_sync.  The window, histogram and grid
// columns live in the row's accumulator in device memory (lane 0 adds; the
// windows once per window left), so no shared memory caps their number.
// The activation plane of a retry stream is in device memory; a batch
// loads its own entries at its start, and activations made during a batch
// for that batch's own events ride in a warp-uniform bitmask (pend).
//
// Arithmetic is the plain version's (kernels/ref64.py scan_sweep_ref): each
// clock, finish and expiry is one rounded f64 operation (built with
// --fmad=false), decisions compare the same values, and the counters and
// response sums are sequential in event order, so they are equal bit for
// bit, as are the final pool, crash clocks, grid columns and activation
// plane.  The integrals, lifespans, window integrals and histogram bins add
// the same pieces in another order (per state span and per lane), so they
// agree to rounding.

#include <type_traits>

#include "scan64_common.cuh"
#include "threefry.cuh"

using namespace scan64;

namespace {

constexpr int WARPS = 4;  // rows a block

struct Args {
  // initial pool [R, M]
  const uint8_t* alive0;
  const double* creation0;
  const double* busy0;
  const double* doom0;  // or null: +inf
  // the event stream [R, K]
  const void* arr;  // f32 gaps, or f64 (arr_f64) / f32 timestamps
  const float* warms;
  const float* colds;
  const float* fail_u;     // reliability
  const uint8_t* first;    // retries
  const int* child;        // retries
  const float* crash_u;    // crashes
  // per row [R]
  const double* t_exp;
  const double* t_end;
  const double* skip;
  const double* t_timeout;   // reliability
  const double* p_fail;      // reliability
  const double* crash_rate;  // crashes
  // per row matrices
  const double* bounds;      // [R, W+1] windows
  const double* grid;        // [R, G]
  const double* cap_edges;   // [R, E]
  const double* cap_values;  // [R, E+1]
  // outputs
  uint8_t* alive_out;
  double* creation_out;
  double* busy_out;
  double* doom_out;  // crashes
  double* t_out;
  double* acc;  // [R, cols]
  uint8_t* act;  // [R, K], zeroed (retries)
  // fused draws: uint32 key pairs [R, 2] (arrival, warm, cold, fail), f64
  // (p0, p1) pairs [R, 2] (arrival, warm, cold), their distribution ids,
  // and the NHPP profile block (null: no thinning)
  const unsigned* keys[4];
  const double* fparams[3];
  int dists[3];
  const double* profile;
  int R, M, K, W, H, G, E;
  long long max_c;
  int prestamped, arr_f64, oldest;
  int rely_at, fault_at, win_at, hist_at, grid_at, cols;
};

// Slot cs of this lane's S, read by selects (an index would put the slots
// in local memory).
template <int S, typename T>
__device__ __forceinline__ T pick(const T (&v)[S], int cs) {
  T x = v[0];
#pragma unroll
  for (int s = 1; s < S; ++s) x = s == cs ? v[s] : x;
  return x;
}

// The metric-window cursor: the first window ending past the window clock
// min(t, t_end).  Its counts (cold, warm, arrivals, failures) are the same
// in every lane; its ∫running and ∫idle are this lane's part (lane 0's
// starts from what was stored), summed across the warp when it leaves.
struct Cursor {
  const double* bnd;  // the row's W + 1 bounds
  double* cols;       // the row's 6W window columns
  int W, w;
  double lo, hi;  // window w's bounds (+inf past the last window)
  double c[4];
  double r, i;

  __device__ __forceinline__ void enter(int to, int lane) {
    __syncwarp();  // lane 0's stores of a window left earlier, before the loads
    w = to;
    const bool in = w < W;
    lo = in ? __ldg(bnd + w) : INFINITY;
    hi = in ? __ldg(bnd + w + 1) : INFINITY;
    c[0] = in ? cols[w] : 0.0;
    c[1] = in ? cols[W + w] : 0.0;
    c[2] = in ? cols[2 * W + w] : 0.0;
    c[3] = in ? cols[5 * W + w] : 0.0;
    r = in && lane == 0 ? cols[3 * W + w] : 0.0;
    i = in && lane == 0 ? cols[4 * W + w] : 0.0;
  }
  __device__ __forceinline__ void leave(int lane) {
    if (w >= W) return;
    const double rs = warp_sum(r), is = warp_sum(i);
    if (lane == 0) {
      cols[w] = c[0];
      cols[W + w] = c[1];
      cols[2 * W + w] = c[2];
      cols[5 * W + w] = c[3];
      cols[3 * W + w] = rs;
      cols[4 * W + w] = is;
    }
  }
  // the first window ending past x, entered with nothing accrued
  __device__ __forceinline__ void seek(double x, int lane) {
    enter(count_le(bnd + 1, W, x), lane);
  }
  // what a state busy until b accrues in the cursor's window from window
  // clock x on (windows ignore crashes)
  __device__ __forceinline__ void accrue_w(double b, double texp, double x, double te,
                                           double& run, double& idle) const {
    accrue(b, b + texp, INFINITY, fmax(x, lo), fmin(hi, te), run, idle);
  }
  // every live state's accrue_w(x) - accrue_w(y) into this lane's part
  template <int S>
  __device__ __forceinline__ void add_live(unsigned live, const double (&busy)[S], double texp,
                                           double x, double y, double te) {
    if (w >= W) return;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((live >> s) & 1u) {
        double ra, ia, rb, ib;
        accrue_w(busy[s], texp, x, te, ra, ia);
        accrue_w(busy[s], texp, y, te, rb, ib);
        r += ra - rb;
        i += ia - ib;
      }
    }
  }
  // the window clock moves forward to x: each window entered on the way
  // takes every live state from its start
  template <int S>
  __device__ __forceinline__ void cross(unsigned live, const double (&busy)[S], double texp,
                                        double x, double te, int lane) {
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
  __device__ __forceinline__ void back(unsigned live, const double (&busy)[S], double texp,
                                       double y, double x, double te, int lane) {
    add_live(live, busy, texp, INFINITY, x, te);
    leave(lane);
    seek(y, lane);
    add_live(live, busy, texp, y, INFINITY, te);
  }
};

// A row's fused stream: its key pair and f64 parameters, loaded once.
struct Stream64 {
  unsigned k0, k1;
  double p0, p1;
  int kind;

  __device__ __forceinline__ void load(const unsigned* keys, const double* params, int d,
                                       int row) {
    k0 = keys[2 * row];
    k1 = keys[2 * row + 1];
    p0 = params ? params[2 * row] : 0.0;
    p1 = params ? params[2 * row + 1] : 0.0;
    kind = d;
  }
  // both uniforms of event k
  __device__ __forceinline__ void uniforms(unsigned k, float& u0, float& u1) const {
    unsigned b0, b1;
    threefry::threefry2x32(k0, k1, k, b0, b1);
    u0 = threefry::uniform_from_bits(b0);
    u1 = threefry::uniform_from_bits(b1);
  }
  __device__ __forceinline__ double draw(unsigned k) const {
    float u0, u1;
    uniforms(k, u0, u1);
    return threefry::sample_dist64(kind, u0, u1, p0, p1);
  }
};

// rate(t) of the profile block (repro_torch/core/processes.py block_rate):
// a sinusoid [1, base, amplitude, period, phase] or piecewise constant
// rates [2, E, edges[E], rates[E+1]], in block_rate's operations and order
__device__ __forceinline__ double profile_rate(const double* prof, double t) {
  if (__ldg(prof) == 1.0) {
    const double base = __ldg(prof + 1), amp = __ldg(prof + 2), period = __ldg(prof + 3),
                 phase = __ldg(prof + 4);
    return base * (1.0 + amp * sin(6.283185307179586 * t / period + phase));
  }
  const int E = (int)__ldg(prof + 1);
  return __ldg(prof + 2 + E + count_le(prof + 2, E, t));
}

// S: slots a lane (M <= 32 S); FAULT: crash clocks and capacity churn;
// LAYERS: metric windows, the histogram and grid points (each a runtime
// choice inside); FUSED: fused draws (not with FAULT, grid points, retries
// or prestamped streams).  Reliability and retries are runtime choices.  LAYERS is
// a template parameter because the layers' cursor state costs the rows
// without layers registers and spills when it is a runtime flag (the
// layers' instance at S = 2: 128 registers and 40 bytes of spills, 103 and
// none without): as a flag, the Table-1 sweep took 238-241 ms against
// 195-199, the retry sweep 360 against 294, the fault sweep 13.8-14.2
// against 11.2-12.4 (in turns on one H100 80GB HBM3 at 700 W).
template <int S, bool FAULT, bool LAYERS, bool FUSED>
__global__ void __launch_bounds__(WARPS * 32, S <= 4 ? 4 : 1) scan_sweep_kernel(const Args a) {
  static_assert(!(FUSED && FAULT), "fused draws serve no faults");
  // a sample's type: the staged f32 samples, or the fused f64 draws
  using Samp = typename std::conditional<FUSED, double, float>::type;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.R) return;  // the ragged last block: the whole warp leaves

  const bool rely = a.t_timeout != nullptr;
  const bool retries = a.first != nullptr;
  const bool crashes = FAULT && a.crash_u != nullptr;
  const bool capped = FAULT && a.cap_values != nullptr;
  const int W = LAYERS ? a.W : 0, H = LAYERS ? a.H : 0, G = LAYERS ? a.G : 0;
  const int M = a.M, K = a.K;
  const size_t pm = (size_t)row * M;
  const size_t pk = (size_t)row * K;
  const double te = a.t_exp[row], tend = a.t_end[row], skp = a.skip[row];
  const double tto = rely ? a.t_timeout[row] : 0.0;
  const double pf = rely ? a.p_fail[row] : 0.0;
  const double crate = crashes ? a.crash_rate[row] : 0.0;
  const double* ce = capped ? a.cap_edges + (size_t)row * a.E : nullptr;
  const double* cv = capped ? a.cap_values + (size_t)row * (a.E + 1) : nullptr;
  const double* grd = G ? a.grid + (size_t)row * G : nullptr;
  double* out = a.acc + (size_t)row * a.cols;
  // fused draws: the row's streams; an NHPP arrival draws its candidates
  // from the envelope's exponential and thins at each candidate's clock
  Stream64 fa, fw, fc, ff;
  const bool nhpp = FUSED && a.profile != nullptr;
  if (FUSED) {
    fa.load(a.keys[0], a.fparams[0], nhpp ? threefry::D_EXP : a.dists[0], row);
    fw.load(a.keys[1], a.fparams[1], a.dists[1], row);
    fc.load(a.keys[2], a.fparams[2], a.dists[2], row);
    if (rely) ff.load(a.keys[3], nullptr, 0, row);
  }
  double* hist = out + a.hist_at;
  double* gcol = out + a.grid_at;
  // the window, histogram and grid columns start at 0; lane 0 adds
  for (int i = a.win_at + lane; i < a.cols; i += 32) out[i] = 0.0;
  __syncwarp();

  // the pool: slot j = s * 32 + lane; slots past M never live, never free
  unsigned live = 0u;
  double bsy[S];
  u64 ck[S];  // okey of the creation time
  double dm[FAULT ? S : 1];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    const bool ok = j < M;
    if (ok && a.alive0[pm + j]) live |= 1u << s;
    ck[s] = okey(ok ? a.creation0[pm + j] : NEG);
    bsy[s] = ok ? a.busy0[pm + j] : NEG;
    if (FAULT) dm[FAULT ? s : 0] = (ok && crashes && a.doom0) ? a.doom0[pm + j] : INFINITY;
  }
  const auto doom = [&](int s) { return FAULT ? dm[FAULT ? s : 0] : INFINITY; };

  // this lane's parts of the sums over slots
  double run_l = 0.0, idle_l = 0.0, life_l = 0.0;
  int lcnt_l = 0, crash_l = 0;
  // the row's decision counters, sequential in event order (every lane)
  int n_cold = 0, n_warm = 0, n_rej = 0, n_over = 0, n_evict = 0;
  int n_to = 0, n_fail = 0, n_retry = 0, n_aband = 0, n_intr = 0;
  double s_cold = 0.0, s_warm = 0.0;

  // the clock and its clipped forms: hi_prev to [skip, t_end], hie_prev to
  // t_end (the windows' clock); the histogram's credited clock
  double t = 0.0;
  double hi_prev = fmin(fmax(t, skp), tend), hie_prev = fmin(t, tend), x_h = hi_prev;
  int n_live = (int)__reduce_add_sync(FULL, (unsigned)__popc(live));
  double next_exit;
  {
    double nx = INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((live >> s) & 1u) {
        const double e = bsy[s] + te;
        nx = fmin(nx, fmin(e, doom(s)));
        double r, i;
        accrue(bsy[s], e, doom(s), hi_prev, tend, r, i);
        run_l += r;
        idle_l += i;
      }
    }
    next_exit = warp_min(nx);
  }
  // exits deferred past the horizon, up to the largest clock reached
  double tmax = -INFINITY;
  bool deferred = false;
  Cursor cur;
  cur.W = 0;
  cur.w = 0;
  cur.hi = INFINITY;
  if (W) {
    cur.bnd = a.bounds + (size_t)row * (W + 1);
    cur.cols = out + a.win_at;
    cur.W = W;
    cur.seek(hie_prev, lane);
    cur.add_live(live, bsy, te, hie_prev, INFINITY, tend);
  }
  double next_g = G ? next_grid(grd, G, t, lane) : INFINITY;
  // the capacity segment [cap_lo, cap_hi) holding the clock, and its ceiling
  double cap_now = 0.0, cap_lo = INFINITY, cap_hi = -INFINITY;

  // The exit pass at clock T (the event's clipped clocks hi, hie): live
  // slots whose exit clock is at or before T leave, with their lifespans
  // and crashes; the histogram is credited up to hi first, and a crash
  // gives back what it accrued in the cursor's window past hie.
  const auto exit_pass = [&](double T, double hi, double hie) {
    if (H) hist_credit<S>(live, bsy, te, x_h, hi, hist, H, lane);
    unsigned gone = 0u;
    double nx = INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((live >> s) & 1u) {
        const double e = bsy[s] + te, d = doom(s);
        const double x = FAULT ? fmin(e, d) : e;
        if (x <= T) {
          gone |= 1u << s;
          if (crashes && d < e && d > skp && d <= tend) ++crash_l;
          if (x > skp && x <= tend) {
            life_l += x - key_value(ck[s]);
            ++lcnt_l;
          }
          if (FAULT && W && d < e) {
            double r, i;
            cur.accrue_w(bsy[s], te, hie, tend, r, i);
            cur.r -= r;
            cur.i -= i;
          }
        } else {
          nx = fmin(nx, x);
        }
      }
    }
    live &= ~gone;
    n_live -= (int)__reduce_add_sync(FULL, (unsigned)__popc(gone));
    next_exit = warp_min(nx);
  };

  const float* arr32 = (const float*)a.arr;
  const double* arr64 = (const double*)a.arr;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kl = k0 + lane;
    const bool in = kl < K;
    const int n = min(32, K - k0);
    const size_t ek = pk + kl;
    // lane l loads (or, fused, draws) event k0 + l of the batch; an NHPP
    // candidate keeps its acceptance uniform
    double x_l = 0.0;
    float acc_l = 0.f;
    if (FUSED) {
      if (in) {
        float u0, u1;
        fa.uniforms((unsigned)kl, u0, u1);
        x_l = threefry::sample_dist64(fa.kind, u0, u1, fa.p0, fa.p1);
        acc_l = u1;
      }
    } else {
      x_l = in ? (a.arr_f64 ? arr64[ek] : (double)arr32[ek]) : 0.0;
    }
    // a batch wholly past the horizon only moves the clock; its exits wait
    // for the pass at the largest clock reached
    if (!(t <= tend)) {
      const bool inert = !in || (a.prestamped ? !(x_l <= tend) : x_l >= 0.0);
      if (__all_sync(FULL, inert)) {
        if (a.prestamped) {
          t = __shfl_sync(FULL, x_l, n - 1);
          tmax = fmax(tmax, warp_max(in ? x_l : -INFINITY));
        } else {
#pragma unroll 8
          for (int i = 0; i < n; ++i) t = t + __shfl_sync(FULL, x_l, i);
          tmax = fmax(tmax, t);
        }
        deferred = true;
        continue;
      }
    }
    Samp w_l = 0, c_l = 0;
    float f_l = 0.f;
    if (FUSED) {
      if (in) {
        w_l = fw.draw((unsigned)kl);
        c_l = fc.draw((unsigned)kl);
        if (rely) {
          float u1;
          ff.uniforms((unsigned)kl, f_l, u1);
        }
      }
    } else {
      w_l = in ? a.warms[ek] : 0.f;
      c_l = in ? a.colds[ek] : 0.f;
      f_l = (in && rely) ? a.fail_u[ek] : 0.f;
    }
    const float u_l = (in && crashes) ? a.crash_u[ek] : 0.f;
    const int first_l = (in && retries) ? (int)a.first[ek] : 1;
    const int child_l = (in && retries) ? a.child[ek] : NO_CHILD;
    // every lane writes each activation itself, so its own loads see it
    const int act_l = (in && retries) ? (int)a.act[ek] : 0;
    unsigned pend = 0u;  // activations of this batch's events made in it
    // each event's gap (or time) and warm sample are broadcast one event
    // ahead of their use, off the chain of the routing
    double x_next = __shfl_sync(FULL, x_l, 0);
    Samp w_next = __shfl_sync(FULL, w_l, 0);
    for (int i = 0; i < n; ++i) {
      const double x = x_next;
      const Samp w_i = w_next;
      x_next = __shfl_sync(FULL, x_l, (i + 1) & 31);
      w_next = __shfl_sync(FULL, w_l, (i + 1) & 31);
      const double tn = a.prestamped ? x : t + x;
      const double hi = fmin(fmax(tn, skp), tend);
      const double hie = fmin(tn, tend);
      // a quiet event moves no clock-driven state; tested on the raw clock
      // (tn >= t implies that the clipped clocks do not go back), off the
      // chain of the clipping
      bool quiet = tn <= tend && !deferred && tn >= t && tn < next_exit;
      if (G) quiet = quiet && next_g > tn;
      if (W) quiet = quiet && cur.hi > tn;
      if (capped) quiet = quiet && tn >= cap_lo && tn < cap_hi && (double)n_live <= cap_now;
      if (!quiet) {
        const bool inert = !(tn <= tend);
        if (!inert && deferred) {
          // back inside the horizon: first the exits deferred past it
          exit_pass(tmax, hi_prev, hie_prev);
          deferred = false;
        }
        if (G) {
          // grid points in (t, hie]: counts on the pre-event pool
          if (next_g <= hie) {
            for (int gb = 0; gb < G; gb += 32) {
              const int gi = gb + lane;
              const double g = gi < G ? __ldg(grd + gi) : 0.0;
              unsigned hit = __ballot_sync(FULL, gi < G && g > t && g <= hie);
              while (hit) {
                const int l = __ffs(hit) - 1;
                hit &= hit - 1;
                const double gg = __shfl_sync(FULL, g, l);
                int nr = 0, ni = 0;
#pragma unroll
                for (int s = 0; s < S; ++s) {
                  const bool lv = ((live >> s) & 1u) && bsy[s] + te > gg;
                  nr += __popc(__ballot_sync(FULL, lv && bsy[s] > gg));
                  ni += __popc(__ballot_sync(FULL, lv && bsy[s] <= gg));
                }
                if (lane == 0) {
                  const int p = gb + l;
                  gcol[p] += nr;
                  gcol[G + p] += ni;
                  if (ni == 0) gcol[2 * G + p] = 1.0;
                  gcol[3 * G + p] = 1.0;
                }
              }
            }
          }
          if (next_g <= tn || tn < t) next_g = next_grid(grd, G, tn, lane);
        }
        if (inert) {
          // past the horizon: the clocks move (the windows' to t_end), the
          // exits wait
          if (W) cur.cross(live, bsy, te, hie, tend, lane);
          hi_prev = hi;
          hie_prev = hie;
          tmax = deferred ? fmax(tmax, tn) : tn;
          deferred = true;
          t = tn;
          continue;
        }
        if (hi < hi_prev) {
          // the clipped clock went back: the live states count the interval
          // (hi, hi_prev] again, and the histogram credits it again
          if (H) {
            hist_credit<S>(live, bsy, te, x_h, hi_prev, hist, H, lane);
            x_h = hi;
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if ((live >> s) & 1u) {
              double ra, ia, rb, ib;
              accrue(bsy[s], bsy[s] + te, doom(s), hi, tend, ra, ia);
              accrue(bsy[s], bsy[s] + te, doom(s), hi_prev, tend, rb, ib);
              run_l += ra - rb;
              idle_l += ia - ib;
            }
          }
        }
        if (W) {
          if (hie < hie_prev)
            cur.back(live, bsy, te, hie, hie_prev, tend, lane);
          else
            cur.cross(live, bsy, te, hie, tend, lane);
        }
        if (tn >= next_exit) exit_pass(tn, hi, hie);
        if (capped) {
          if (!(tn >= cap_lo && tn < cap_hi)) {
            const int seg = count_le(ce, a.E, tn);
            cap_now = __ldg(cv + seg);
            cap_lo = seg > 0 ? __ldg(ce + seg - 1) : -INFINITY;
            cap_hi = seg < a.E ? __ldg(ce + seg) : INFINITY;
          }
          // capacity churn: evict the newest idle instances above the
          // ceiling, one at a time
          const double over = (double)n_live - cap_now;
          if (over > 0.0) {
            if (H) hist_credit<S>(live, bsy, te, x_h, hi, hist, H, lane);
            for (int q = 0; (double)q < over; ++q) {
              u64 kb = 0ull;
              int sb = 0;
#pragma unroll
              for (int s = 0; s < S; ++s) {
                const u64 kk = ((live >> s) & 1u) && bsy[s] <= tn ? ck[s] : 0ull;
                if (kk > kb) {
                  kb = kk;
                  sb = s;
                }
              }
              const u64 best = warp_max_key(kb);
              if (!best) break;
              const unsigned j =
                  __reduce_min_sync(FULL, kb == best ? (unsigned)(sb * 32 + lane) : UINT_MAX);
              if (lane == (int)(j & 31u)) {
                const int cs = (int)(j >> 5);
                const double b = pick<S>(bsy, cs);
                double r, idl;
                // the state ends at hi: it gives back what it accrued past it
                accrue(b, b + te, FAULT ? pick<FAULT ? S : 1>(dm, FAULT ? cs : 0) : INFINITY,
                       hi, tend, r, idl);
                run_l -= r;
                idle_l -= idl;
                if (W) {
                  cur.accrue_w(b, te, hie, tend, r, idl);
                  cur.r -= r;
                  cur.i -= idl;
                }
                if (tn > skp) {
                  life_l += tn - key_value(pick<S>(ck, cs));
                  ++lcnt_l;
                }
                live &= ~(1u << cs);
              }
              if (tn > skp) ++n_evict;
              --n_live;
            }
          }
        }
      }
      hi_prev = hi;
      hie_prev = hie;

      bool active = true;
      int first = 1;
      if (nhpp) {
        // thinning: a rejected candidate is an inert arrival (it moved the
        // clock, integrated and expired above, and routes nothing)
        const double u = (double)__shfl_sync(FULL, acc_l, i);
        active = u * fa.p0 <= profile_rate(a.profile, tn);
      }
      if (retries) {
        first = __shfl_sync(FULL, first_l, i);
        active = first || __shfl_sync(FULL, act_l, i) || ((pend >> i) & 1u);
      }
      if (active) {
        // the newest (oldest) idle instance, by order key
        u64 kb = 0ull;
        int sb = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const u64 kk = ((live >> s) & 1u) && bsy[s] <= tn ? (a.oldest ? ~ck[s] : ck[s]) : 0ull;
          // this lane's slots ascend with s, so '>' keeps the lowest on a tie
          if (kk > kb) {
            kb = kk;
            sb = s;
          }
        }
        const u64 best = warp_max_key(kb);
        const bool any_idle = best != 0ull;
        bool is_cold = false, below = true, any_free = true;
        const double w_s = (double)w_i;
        double service = w_s, fin = 0.0, doom_c = INFINITY;
        if (any_idle) {
          // warm: its lane swaps the accrual of the state that ends for the
          // one that starts
          const unsigned j =
              __reduce_min_sync(FULL, kb == best ? (unsigned)(sb * 32 + lane) : UINT_MAX);
          const double occ = rely ? fmin(service, tto) : service;
          fin = tn + occ;
          const int owner = (int)(j & 31u), cs = (int)(j >> 5);
          if (lane == owner) {
            const double b = pick<S>(bsy, cs);
            const double d = FAULT ? pick<FAULT ? S : 1>(dm, FAULT ? cs : 0) : INFINITY;
            double ra, ia, rb, ib;
            accrue(fin, fin + te, d, hi, tend, ra, ia);
            accrue(b, b + te, d, hi, tend, rb, ib);
            run_l += ra - rb;
            idle_l += ia - ib;
            if (W) {
              cur.accrue_w(fin, te, hie, tend, ra, ia);
              cur.accrue_w(b, te, hie, tend, rb, ib);
              cur.r += ra - rb;
              cur.i += ia - ib;
            }
#pragma unroll
            for (int s = 0; s < S; ++s) bsy[s] = s == cs ? fin : bsy[s];
            doom_c = d;
          }
          if (crashes) doom_c = __shfl_sync(FULL, doom_c, owner);
          // its exit moves to min(expiry, doom), which the bound already
          // lies below except for the expiry
          next_exit = fmin(next_exit, fin + te);
        } else {
          // the slots are read only when no instance is idle
          int free_j = -1;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const unsigned fm = __ballot_sync(FULL, s * 32 + lane < M && !((live >> s) & 1u));
            if (free_j < 0 && fm) free_j = s * 32 + __ffs(fm) - 1;
          }
          any_free = free_j >= 0;
          below = n_live < a.max_c;
          is_cold = below && any_free && (!capped || (double)n_live < cap_now);
          if (is_cold) {
            if (H) hist_credit<S>(live, bsy, te, x_h, hi, hist, H, lane);
            service = (double)__shfl_sync(FULL, c_l, i);
            const double occ = rely ? fmin(service, tto) : service;
            fin = tn + occ;
            if (crashes) {
              const double u = (double)__shfl_sync(FULL, u_l, i);
              const double life = crate > 0.0 ? -log(1.0 - u) / crate : INFINITY;
              doom_c = tn + life;
            }
            const int cs = free_j >> 5;
            if (lane == (free_j & 31)) {
              double r, idl;
              accrue(fin, fin + te, doom_c, hi, tend, r, idl);
              run_l += r;
              idle_l += idl;
              if (W) {
                cur.accrue_w(fin, te, hie, tend, r, idl);
                cur.r += r;
                cur.i += idl;
              }
              const u64 kc = okey(tn);
#pragma unroll
              for (int s = 0; s < S; ++s) {
                bsy[s] = s == cs ? fin : bsy[s];
                ck[s] = s == cs ? kc : ck[s];
                if (FAULT) dm[FAULT ? s : 0] = s == cs ? doom_c : dm[FAULT ? s : 0];
              }
              live |= 1u << cs;
            }
            ++n_live;
            next_exit = fmin(next_exit, fmin(fin + te, doom_c));
          }
        }
        const bool assign = any_idle || is_cold;
        const bool is_rej = !assign;
        const bool counted = tn > skp;
        n_cold += is_cold && counted;
        n_warm += any_idle && counted;
        n_rej += is_rej && counted;
        n_over += !any_idle && below && !any_free;
        bool timed_out = false, failed = false;
        double cold_r = service, warm_r = service;
        if (rely) {
          timed_out = assign && service > tto;
          failed = assign && !timed_out && (double)__shfl_sync(FULL, f_l, i) < pf;
          bool trigger = timed_out || failed || is_rej;
          if (crashes) {
            const bool intr = assign && !timed_out && !failed && doom_c < fin;
            trigger = trigger || intr;
            n_intr += intr && counted;
          }
          cold_r = warm_r = fmin(service, tto);
          n_to += timed_out && counted;
          n_fail += failed && counted;
          if (retries) {
            const int child = __shfl_sync(FULL, child_l, i);
            n_retry += !first && counted;
            n_aband += trigger && child >= NO_CHILD && counted;
            if (trigger && child >= 0 && child < K) {
              a.act[pk + child] = 1;
              if (child >= k0 && child < k0 + 32) pend |= 1u << (child - k0);
            }
          } else {
            n_aband += trigger && counted;
          }
        } else if (crashes) {
          n_intr += (assign && doom_c < fin) && counted;
        }
        if (is_cold && counted) s_cold += cold_r;
        if (any_idle && counted) s_warm += warm_r;
        // the arrival lies in the cursor's window once that has begun
        if (W && cur.w < W && cur.lo <= tn) {
          cur.c[0] += is_cold;
          cur.c[1] += any_idle;
          cur.c[2] += 1.0;
          if (rely) cur.c[3] += timed_out || failed;
        }
      }
      t = tn;
    }
  }

  // the exits deferred past the horizon; then the grid points after the
  // last event, the histogram and windows up to t_end, and the lifespans of
  // exits in the tail (the live states accrued up to t_end already)
  if (deferred) exit_pass(tmax, hi_prev, hie_prev);
  if (G) {
    for (int gb = 0; gb < G; gb += 32) {
      const int gi = gb + lane;
      __syncwarp();
      const double g = gi < G ? __ldg(grd + gi) : 0.0;
      unsigned hit = __ballot_sync(FULL, gi < G && g > t && g <= tend && gcol[3 * G + gi] == 0.0);
      while (hit) {
        const int l = __ffs(hit) - 1;
        hit &= hit - 1;
        const double gg = __shfl_sync(FULL, g, l);
        int nr = 0, ni = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool lv = ((live >> s) & 1u) && bsy[s] + te > gg;
          nr += __popc(__ballot_sync(FULL, lv && bsy[s] > gg));
          ni += __popc(__ballot_sync(FULL, lv && bsy[s] <= gg));
        }
        if (lane == 0) {
          const int p = gb + l;
          gcol[p] += nr;
          gcol[G + p] += ni;
          if (ni == 0) gcol[2 * G + p] = 1.0;
          gcol[3 * G + p] = 1.0;
        }
      }
    }
  }
  if (H) hist_credit<S>(live, bsy, te, x_h, tend, hist, H, lane);
  if (W) {
    cur.cross(live, bsy, te, tend, tend, lane);
    cur.leave(lane);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double e = bsy[s] + te, d = doom(s);
    const double x = FAULT ? fmin(e, d) : e;
    if (((live >> s) & 1u) && x <= tend && x > skp) {
      life_l += x - key_value(ck[s]);
      ++lcnt_l;
      if (crashes && d < e) ++crash_l;
    }
  }

  // ---- outputs
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      a.alive_out[pm + j] = (live >> s) & 1u;
      a.creation_out[pm + j] = key_value(ck[s]);
      a.busy_out[pm + j] = bsy[s];
      if (crashes) a.doom_out[pm + j] = doom(s);
    }
  }
  const double run = warp_sum(run_l), idle = warp_sum(idle_l), life = warp_sum(life_l);
  const int lcnt = (int)__reduce_add_sync(FULL, (unsigned)lcnt_l);
  const int ncrash = (int)__reduce_add_sync(FULL, (unsigned)crash_l);
  if (lane == 0) {
    a.t_out[row] = t;
    out[0] = (double)n_cold;
    out[1] = (double)n_warm;
    out[2] = (double)n_rej;
    out[3] = run;
    out[4] = idle;
    out[5] = s_cold;
    out[6] = s_warm;
    out[7] = life;
    out[8] = (double)lcnt;
    out[9] = (double)n_over;
    if (rely) {
      out[a.rely_at] = (double)n_to;
      out[a.rely_at + 1] = (double)n_fail;
      out[a.rely_at + 2] = (double)n_retry;
      out[a.rely_at + 3] = (double)n_aband;
    }
    if (crashes || capped) {
      out[a.fault_at] = (double)ncrash;
      out[a.fault_at + 1] = (double)n_evict;
      out[a.fault_at + 2] = (double)n_intr;
    }
  }
}

template <int S, bool FAULT, bool LAYERS, bool FUSED = false>
int launch_one(const Args& a, cudaStream_t stream) {
  scan_sweep_kernel<S, FAULT, LAYERS, FUSED>
      <<<(a.R + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch(const Args& a, cudaStream_t stream) {
  const bool fault = a.crash_u != nullptr || a.cap_values != nullptr;
  const bool layers = a.W > 0 || a.H > 0 || a.G > 0;
  if (a.keys[0] != nullptr)
    return layers ? launch_one<S, false, true, true>(a, stream)
                  : launch_one<S, false, false, true>(a, stream);
  if (fault)
    return layers ? launch_one<S, true, true>(a, stream) : launch_one<S, true, false>(a, stream);
  return layers ? launch_one<S, false, true>(a, stream) : launch_one<S, false, false>(a, stream);
}

}  // namespace

// Plain C entry, bound with ctypes.  ptrs (28, in this order): alive0
// (uint8), creation0, busy0, doom0 (f64 [R, M]; doom0 may be null); arr
// (f32, or f64 when arr_f64), warms, colds, fail_u, is_first (uint8),
// child_pos (int32), crash_u ([R, K]); t_exp, t_end, skip, t_timeout,
// p_fail, crash_rate (f64 [R]); bounds [R, W+1], grid [R, G], cap_edges
// [R, E], cap_values [R, E+1] (f64); outputs alive (uint8), creation, busy,
// doom ([R, M]), t [R], acc [R, cols] (f64) and act (uint8 [R, K]); then
// the fused draws' keys (uint32 [R, 2]: arrival, warm, cold, fail), f64
// parameters ([R, 2]: arrival, warm, cold) and profile block (f64; null
// without NHPP thinning), all null for staged samples (arr, warms and colds
// are then null, and K is the number of events drawn).  A null optional
// input turns its path off.  ints (21): R, M, K, W, H, G, E,
// max_concurrency, prestamped, arr_f64, oldest, rely_at, fault_at, win_at,
// hist_at, grid_at, cols, device and the three distribution ids (threefry.cuh
// Dist), then the stream.  Returns the CUDA error code (0 = ok).
extern "C" int scan_sweep_f64(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  a.alive0 = (const uint8_t*)ptrs[0];
  a.creation0 = (const double*)ptrs[1];
  a.busy0 = (const double*)ptrs[2];
  a.doom0 = (const double*)ptrs[3];
  a.arr = ptrs[4];
  a.warms = (const float*)ptrs[5];
  a.colds = (const float*)ptrs[6];
  a.fail_u = (const float*)ptrs[7];
  a.first = (const uint8_t*)ptrs[8];
  a.child = (const int*)ptrs[9];
  a.crash_u = (const float*)ptrs[10];
  a.t_exp = (const double*)ptrs[11];
  a.t_end = (const double*)ptrs[12];
  a.skip = (const double*)ptrs[13];
  a.t_timeout = (const double*)ptrs[14];
  a.p_fail = (const double*)ptrs[15];
  a.crash_rate = (const double*)ptrs[16];
  a.bounds = (const double*)ptrs[17];
  a.grid = (const double*)ptrs[18];
  a.cap_edges = (const double*)ptrs[19];
  a.cap_values = (const double*)ptrs[20];
  a.alive_out = (uint8_t*)ptrs[21];
  a.creation_out = (double*)ptrs[22];
  a.busy_out = (double*)ptrs[23];
  a.doom_out = (double*)ptrs[24];
  a.t_out = (double*)ptrs[25];
  a.acc = (double*)ptrs[26];
  a.act = (uint8_t*)ptrs[27];
  for (int i = 0; i < 4; ++i) a.keys[i] = (const unsigned*)ptrs[28 + i];
  for (int i = 0; i < 3; ++i) a.fparams[i] = (const double*)ptrs[32 + i];
  a.profile = (const double*)ptrs[35];
  for (int i = 0; i < 3; ++i) a.dists[i] = ints[18 + i];
  a.R = ints[0];
  a.M = ints[1];
  a.K = ints[2];
  a.W = ints[3];
  a.H = ints[4];
  a.G = ints[5];
  a.E = ints[6];
  a.max_c = ints[7];
  a.prestamped = ints[8];
  a.arr_f64 = ints[9];
  a.oldest = ints[10];
  a.rely_at = ints[11];
  a.fault_at = ints[12];
  a.win_at = ints[13];
  a.hist_at = ints[14];
  a.grid_at = ints[15];
  a.cols = ints[16];
  const int device = ints[17];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.R < 1 || a.M < 1 || a.M > 512 || a.K < 0 || a.W < 0 || a.H < 0 || a.G < 0 ||
      (a.cap_values && a.E < 0))
    return (int)cudaErrorInvalidValue;
  if (a.keys[0] != nullptr) {
    // fused draws: base, windows, the histogram, fail-only reliability and
    // routing, on gap streams
    bool ok = a.keys[1] && a.keys[2] && a.fparams[0] && a.fparams[1] && a.fparams[2] &&
              !a.first && !a.crash_u && !a.cap_values && a.G == 0 && !a.prestamped &&
              (a.t_timeout == nullptr || a.keys[3] != nullptr);
    for (int i = 0; i < 3; ++i) ok = ok && a.dists[i] >= 0 && a.dists[i] < threefry::N_DISTS;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  if (a.t_timeout == nullptr) a.fail_u = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.act) {
    err = cudaMemsetAsync(a.act, 0, (size_t)a.R * a.K, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int s = (a.M + 31) / 32;
  if (s <= 1) return launch<1>(a, st);
  if (s <= 2) return launch<2>(a, st);
  if (s <= 4) return launch<4>(a, st);
  if (s <= 8) return launch<8>(a, st);
  return launch<16>(a, st);
}
