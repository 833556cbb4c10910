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
//     instance count (the histogram: the in-window expiries in order);
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
// Design: one warp per row, a simple kernel that computes what the plain
// version (kernels/ref64.py scan_sweep_ref) computes, decision for
// decision, with every path a runtime flag.
//   - Slot j is lane j % 32's (j / 32)-th slot: its alive flag, creation,
//     busy and crash clocks live in registers (S slots a lane, S a
//     template parameter: M <= 32 S).
//   - The events are read 32 at a time, one per lane (coalesced), and
//     broadcast by shuffles.
//   - A row's ∫running, ∫idle, Σlifespan and per-slot counts are per-lane
//     partials summed once at the end by an xor butterfly; the window
//     integrals are summed per event (only the windows the interval
//     overlaps) and, with the histogram and grid columns, kept in shared
//     memory until the end.
//   - Warm routing is an argmax over the warp (largest priority, lowest
//     slot on a tie), the free slot a ballot and __ffs.
//   - The histogram walks the in-window expiries in order, one warp argmin
//     each (an event sees few); capacity evictions take the newest idle
//     instance one at a time, which evicts exactly the slots whose rank
//     among the newer idle ones is below the excess.
//   - The activation plane of a retry stream is in global memory: every
//     lane switches a child on itself and reads its own writes back.
//
// Arithmetic is the plain version's: each clock, finish and expiry is one
// rounded f64 operation (built with --fmad=false), decisions compare the
// same values, and the counters and response sums are sequential in event
// order, so they are equal bit for bit.  The integrals, lifespans, window
// integrals and histogram bins add the same pieces in another order and
// agree to rounding.

#include <cstdint>

#include "scan64_common.cuh"

using namespace scan64;

namespace {

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
  int R, M, K, W, H, G, E;
  long long max_c;
  int prestamped, arr_f64, oldest;
  int rely_at, fault_at, win_at, hist_at, grid_at, cols;
};

template <int S>
__global__ void __launch_bounds__(128) scan_sweep_kernel(const Args a, int wpb) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * wpb + wid;
  if (row >= a.R) return;  // whole warps only
  const int extra = 6 * a.W + a.H + 4 * a.G;
  double* sx = smem + (size_t)wid * extra;  // window, histogram, grid columns
  double* sw = sx;
  double* shist = sx + 6 * a.W;
  double* sgrid = shist + a.H;
  for (int i = lane; i < extra; i += 32) sx[i] = 0.0;
  __syncwarp();

  const bool rely = a.t_timeout != nullptr;
  const bool retries = a.first != nullptr;
  const bool crashes = a.crash_u != nullptr;
  const bool capped = a.cap_values != nullptr;
  const size_t pm = (size_t)row * a.M;
  const size_t pk = (size_t)row * a.K;
  const double te = a.t_exp[row], tend = a.t_end[row], skp = a.skip[row];
  const double tto = rely ? a.t_timeout[row] : 0.0;
  const double pf = rely ? a.p_fail[row] : 0.0;
  const double crate = crashes ? a.crash_rate[row] : 0.0;
  const double* bnd = a.bounds ? a.bounds + (size_t)row * (a.W + 1) : nullptr;
  const double* grd = a.grid ? a.grid + (size_t)row * a.G : nullptr;
  const double* ce = capped ? a.cap_edges + (size_t)row * a.E : nullptr;
  const double* cv = capped ? a.cap_values + (size_t)row * (a.E + 1) : nullptr;

  bool al[S];
  double cre[S], bsy[S], dm[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    const bool ok = j < a.M;
    al[s] = ok && a.alive0[pm + j] != 0;
    cre[s] = ok ? a.creation0[pm + j] : NEG;
    bsy[s] = ok ? a.busy0[pm + j] : NEG;
    dm[s] = (ok && a.doom0) ? a.doom0[pm + j] : INFINITY;
  }
  // per-lane partials of the per-slot sums
  double p_run = 0.0, p_idle = 0.0, p_life = 0.0;
  long long p_lcnt = 0, p_crash = 0;
  // the row's decision counters (every lane holds them)
  long long n_cold = 0, n_warm = 0, n_rej = 0, n_over = 0, n_evict = 0;
  long long n_to = 0, n_fail = 0, n_retry = 0, n_aband = 0, n_intr = 0;
  double s_cold = 0.0, s_warm = 0.0;
  double t_prev = 0.0;

  // the grid snapshot of the current pool at the points in (lo_g, hi_g]
  // (tail: also not seen yet)
  auto grid_step = [&](double lo_g, double hi_g, bool tail) {
    for (int b = 0; b < a.G; b += 32) {
      const int gi = b + lane;
      const double gv = gi < a.G ? __ldg(grd + gi) : 0.0;
      bool in = gi < a.G && gv > lo_g && gv <= hi_g;
      if (tail && in) in = sgrid[3 * a.G + gi] == 0.0;
      unsigned mask = __ballot_sync(FULL, in);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const double g = __shfl_sync(FULL, gv, src);
        int run = 0, idle = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool live = al[s] && bsy[s] + te > g;
          run += __popc(__ballot_sync(FULL, live && bsy[s] > g));
          idle += __popc(__ballot_sync(FULL, live && bsy[s] <= g));
        }
        if (lane == 0) {
          const int p = b + src;
          sgrid[p] += run;
          sgrid[a.G + p] += idle;
          if (idle == 0) sgrid[2 * a.G + p] = 1.0;
          sgrid[3 * a.G + p] = 1.0;
        }
        __syncwarp();
      }
    }
  };

  // the interval's pieces over (lo, hi] into the partials, the windows
  // over (lo_e, hi_e] and the histogram over (lo, hi]
  auto integrate = [&](double lo, double hi, double lo_e, double hi_e) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (al[s]) {
        double run, idle;
        slot_integrals(bsy[s], bsy[s] + te, crashes ? dm[s] : INFINITY, lo, hi, run, idle);
        p_run += run;
        p_idle += idle;
      }
    }
    if (a.W) {
      // the windows the interval overlaps: b[w+1] > lo_e and b[w] < hi_e
      for (int w = count_le(bnd + 1, a.W, lo_e); w < a.W && __ldg(bnd + w) < hi_e; ++w) {
        const double wlo = fmax(__ldg(bnd + w), lo_e), whi = fmin(__ldg(bnd + w + 1), hi_e);
        double r = 0.0, i = 0.0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (al[s]) {
            double run, idle;
            slot_integrals(bsy[s], bsy[s] + te, INFINITY, wlo, whi, run, idle);
            r += run;
            i += idle;
          }
        }
        r = warp_sum(r);
        i = warp_sum(i);
        if (lane == 0) {
          sw[3 * a.W + w] += r;
          sw[4 * a.W + w] += i;
        }
      }
    }
    if (a.H && hi - lo > 0.0) {
      int n0 = 0, m = 0;
      bool inw[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const double ex = bsy[s] + te;
        const bool live = al[s] && ex > lo;
        inw[s] = live && ex <= hi;
        n0 += __popc(__ballot_sync(FULL, live));
        m += __popc(__ballot_sync(FULL, inw[s]));
      }
      double prev = lo;
      for (int q = 0; q < m; ++q) {
        double v = INFINITY;
        int j = INT_MAX;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const double ex = bsy[s] + te;
          if (inw[s] && ex < v) {
            v = ex;
            j = s * 32 + lane;
          }
        }
        warp_argmin(v, j);
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (j == s * 32 + lane) inw[s] = false;
        const double dur = fmax(v - prev, 0.0);
        const int cnt = n0 - q;
        if (lane == 0 && cnt >= 0 && dur > 0.0) shist[min(cnt, a.H - 1)] += dur;
        prev = v;
      }
      const double dur = fmax(hi - prev, 0.0);
      const int cnt = n0 - m;
      if (lane == 0 && cnt >= 0 && dur > 0.0) shist[min(cnt, a.H - 1)] += dur;
    }
    __syncwarp();
  };

  const float* arr32 = (const float*)a.arr;
  const double* arr64 = (const double*)a.arr;
  for (int k0 = 0; k0 < a.K; k0 += 32) {
    const int kl = k0 + lane;
    const bool in = kl < a.K;
    const size_t ek = pk + kl;
    const double x_arr = in ? (a.arr_f64 ? arr64[ek] : (double)arr32[ek]) : 0.0;
    const float x_warm = in ? a.warms[ek] : 0.f;
    const float x_cold = in ? a.colds[ek] : 0.f;
    const float x_fail = (in && rely) ? a.fail_u[ek] : 0.f;
    const int x_first = (in && retries) ? (int)a.first[ek] : 1;
    const int x_child = (in && retries) ? a.child[ek] : NO_CHILD;
    const float x_crash = (in && crashes) ? a.crash_u[ek] : 0.f;
    const int n = min(32, a.K - k0);
    for (int e = 0; e < n; ++e) {
      const int k = k0 + e;
      const double x = __shfl_sync(FULL, x_arr, e);
      const double t = a.prestamped ? x : t_prev + x;
      if (a.G) grid_step(t_prev, fmin(t, tend), false);
      const double lo = fmin(fmax(t_prev, skp), tend);
      const double hi = fmin(fmax(t, skp), tend);
      integrate(lo, hi, fmin(t_prev, tend), fmin(t, tend));

      // ---- exits at or before the event
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const double expire = bsy[s] + te;
        const double ex = crashes ? fmin(expire, dm[s]) : expire;
        if (al[s] && ex <= t) {
          if (crashes && dm[s] < expire && dm[s] > skp && dm[s] <= tend) ++p_crash;
          if (ex > skp && ex <= tend) {
            p_life += ex - cre[s];
            ++p_lcnt;
          }
          al[s] = false;
        }
      }
      int n_alive = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) n_alive += __popc(__ballot_sync(FULL, al[s]));

      // ---- capacity churn
      double cap_now = 0.0;
      if (capped) {
        cap_now = __ldg(cv + count_le(ce, a.E, t));
        const double over = (double)n_alive - cap_now;
        if (over > 0.0 && t <= tend) {
          bool idle_now[S];
#pragma unroll
          for (int s = 0; s < S; ++s) idle_now[s] = al[s] && bsy[s] <= t;
          for (int q = 0; (double)q < over; ++q) {
            double v = -INFINITY;
            int j = INT_MAX;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (idle_now[s] && (cre[s] > v || j == INT_MAX)) {
                v = cre[s];
                j = s * 32 + lane;
              }
            }
            warp_argmax(v, j);
            if (j == INT_MAX) break;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (j == s * 32 + lane) {
                idle_now[s] = false;
                al[s] = false;
                if (t > skp) {
                  p_life += t - cre[s];
                  ++p_lcnt;
                }
              }
            }
            if (t > skp) ++n_evict;
            --n_alive;
          }
        }
      }

      // ---- routing
      bool active = t <= tend;
      const int first = __shfl_sync(FULL, x_first, e);
      if (retries && active && !first) active = a.act[pk + k] != 0;
      double v = -INFINITY;
      int warm_j = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const double pr = a.oldest ? -cre[s] : cre[s];
        if (al[s] && bsy[s] <= t && (pr > v || warm_j == INT_MAX)) {
          v = pr;
          warm_j = s * 32 + lane;
        }
      }
      warp_argmax(v, warm_j);
      const bool any_idle = warm_j != INT_MAX;
      int free_j = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const unsigned fm = __ballot_sync(FULL, !al[s] && s * 32 + lane < a.M);
        if (fm && free_j == INT_MAX) free_j = s * 32 + __ffs(fm) - 1;
      }
      const bool any_free = free_j != INT_MAX;
      const bool below = n_alive < a.max_c;
      bool can_cold = !any_idle && below && any_free;
      if (capped) can_cold = can_cold && (double)n_alive < cap_now;
      const bool is_warm = any_idle && active;
      const bool is_cold = can_cold && active;
      const bool is_rej = !any_idle && !can_cold && active;
      const bool assign = is_warm || is_cold;
      const int chosen = is_warm ? warm_j : (any_free ? free_j : 0);
      const double w_s = (double)__shfl_sync(FULL, x_warm, e);
      const double c_s = (double)__shfl_sync(FULL, x_cold, e);
      const double service = is_warm ? w_s : c_s;
      const double occ = rely ? fmin(service, tto) : service;
      const double fin = t + occ;
      double doom_c = INFINITY;
      if (crashes) {
        const double u = (double)__shfl_sync(FULL, x_crash, e);
        const double life = crate > 0.0 ? -log(1.0 - u) / crate : INFINITY;
        double mine = INFINITY;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (chosen == s * 32 + lane) mine = is_cold ? t + life : dm[s];
        doom_c = __shfl_sync(FULL, mine, chosen & 31);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (chosen == s * 32 + lane) {
          if (assign) bsy[s] = fin;
          if (is_cold) {
            cre[s] = t;
            al[s] = true;
            if (crashes) dm[s] = doom_c;
          }
        }
      }

      const bool counted = t > skp;
      n_cold += is_cold && counted;
      n_warm += is_warm && counted;
      n_rej += is_rej && counted;
      n_over += !any_idle && below && !any_free && active;
      bool timed_out = false, failed = false, trigger = false;
      double cold_r = c_s, warm_r = w_s;
      if (rely) {
        const double fu = (double)__shfl_sync(FULL, x_fail, e);
        timed_out = assign && service > tto;
        failed = assign && !timed_out && fu < pf;
        trigger = timed_out || failed || is_rej;
        if (crashes) {
          const bool intr = assign && !timed_out && !failed && doom_c < fin;
          trigger = trigger || intr;
          n_intr += intr && counted;
        }
        cold_r = fmin(c_s, tto);
        warm_r = fmin(w_s, tto);
      } else if (crashes) {
        n_intr += (assign && doom_c < fin) && counted;
      }
      if (is_cold && counted) s_cold += cold_r;
      if (is_warm && counted) s_warm += warm_r;
      if (rely) {
        n_to += timed_out && counted;
        n_fail += failed && counted;
        if (retries) {
          const int child = __shfl_sync(FULL, x_child, e);
          n_retry += !first && active && counted;
          n_aband += trigger && child >= NO_CHILD && counted;
          if (trigger && child >= 0 && child < a.K) a.act[pk + child] = 1;
        } else {
          n_aband += trigger && counted;
        }
      }
      if (a.W && active && lane == 0) {
        const int w = count_le(bnd, a.W + 1, t) - 1;
        if (w >= 0 && w < a.W) {
          sw[w] += is_cold;
          sw[a.W + w] += is_warm;
          sw[2 * a.W + w] += 1.0;
          if (rely) sw[5 * a.W + w] += timed_out || failed;
        }
      }
      t_prev = t;
    }
  }

  // ---- grid points after the last event, then the tail flush
  if (a.G) grid_step(t_prev, tend, true);
  const double lo = fmin(fmax(t_prev, skp), tend);
  integrate(lo, tend, fmin(t_prev, tend), tend);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double expire = bsy[s] + te;
    const double ex = crashes ? fmin(expire, dm[s]) : expire;
    if (al[s] && ex <= tend && ex > skp) {
      p_life += ex - cre[s];
      ++p_lcnt;
      if (crashes && dm[s] < expire) ++p_crash;
    }
  }

  // ---- outputs
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < a.M) {
      a.alive_out[pm + j] = al[s];
      a.creation_out[pm + j] = cre[s];
      a.busy_out[pm + j] = bsy[s];
      if (crashes) a.doom_out[pm + j] = dm[s];
    }
  }
  const double run = warp_sum(p_run), idle = warp_sum(p_idle), life = warp_sum(p_life);
  const long long lcnt = warp_sum(p_lcnt), ncrash = warp_sum(p_crash);
  double* out = a.acc + (size_t)row * a.cols;
  for (int i = lane; i < extra; i += 32) out[a.win_at + i] = sx[i];
  if (lane == 0) {
    a.t_out[row] = t_prev;
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

template <int S>
int launch(const Args& a, int device, cudaStream_t stream) {
  const size_t row_bytes = (size_t)(6 * a.W + a.H + 4 * a.G) * sizeof(double);
  int wpb = 4;
  while (wpb > 1 && wpb * row_bytes > (size_t)96 * 1024) wpb /= 2;
  const size_t smem = wpb * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      scan_sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.act) {
    err = cudaMemsetAsync(a.act, 0, (size_t)a.R * a.K, stream);
    if (err != cudaSuccess) return (int)err;
  }
  scan_sweep_kernel<S><<<(a.R + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(a, wpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes.  ptrs (28, in this order): alive0
// (uint8), creation0, busy0, doom0 (f64 [R, M]; doom0 may be null); arr
// (f32, or f64 when arr_f64), warms, colds, fail_u, is_first (uint8),
// child_pos (int32), crash_u ([R, K]); t_exp, t_end, skip, t_timeout,
// p_fail, crash_rate (f64 [R]); bounds [R, W+1], grid [R, G], cap_edges
// [R, E], cap_values [R, E+1] (f64); outputs alive (uint8), creation, busy,
// doom ([R, M]), t [R], acc [R, cols] (f64) and act (uint8 [R, K]).  A
// null optional input turns its path off.  ints (18): R, M, K, W, H, G, E,
// max_concurrency, prestamped, arr_f64, oldest, rely_at, fault_at, win_at,
// hist_at, grid_at, cols, device, then the stream.  Returns the CUDA error
// code (0 = ok).
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
  if (a.t_timeout == nullptr) a.fail_u = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const int s = (a.M + 31) / 32;
  if (s <= 1) return launch<1>(a, device, st);
  if (s <= 2) return launch<2>(a, device, st);
  if (s <= 4) return launch<4>(a, device, st);
  if (s <= 8) return launch<8>(a, device, st);
  return launch<16>(a, device, st);
}
