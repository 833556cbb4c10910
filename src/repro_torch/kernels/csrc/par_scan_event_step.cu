// Hopper (sm_90a) kernel of the f64 engine's concurrency-value scan
// (backend "scan", engine "par").
//
// No Pallas kernel is replaced: the reference runs this loop as a
// lax.scan (repro/core/par_simulator.py::_par_scan_fn, and the tail flush
// of _simulate_par_batch).  Each row runs K events from an empty pool of
// M instances that serve up to c requests each: finish[M, c] holds each
// request sub-slot's finish time, and an instance is busy until busy =
// max_i finish.  Per event, in f64: exact ∫running and ∫idle over the
// interval clipped to [skip, t_end], ∫in-flight over every sub-slot of a
// live instance, the histogram of the total count; expiry at busy + t_exp;
// then the newest live instance with a finished sub-slot serves (warm,
// lowest slot on a creation tie), else the lowest free slot below
// max_concurrency instances (cold), else the event is rejected.  The
// request takes the instance's first finished sub-slot, found before a
// cold start wipes the reused row to NEG, and holds it until t +
// min(service, t_timeout).  Reliability and retries as in the pool scan
// (scan_event_step.cu).
//
// Design: one warp per row, the simple counterpart of the plain version
// (kernels/ref64.py par_scan_sweep_ref).
//   - Slot j is lane j % 32's: its alive flag, creation, busy (the row's
//     max finish) and free-by (the row's min finish) live in registers.
//     busy and free-by change only where a request is assigned, so they
//     are recomputed there from the row, and routing needs no sub-slot:
//     #(finish > t) < c iff free-by <= t.
//   - finish lives in shared memory, instance-major (slot j's c finishes
//     at [j*c, (j+1)*c)).  The assigned row is searched for its first
//     finished sub-slot by ballots over lanes, wiped on a cold start, and
//     its max and min taken by warp reductions.
//   - ∫in-flight: for c <= 32 each lane sums its own slots' rows; above,
//     the lanes split each live instance's row.
//   - The integrals are per-lane partials summed at the end; the
//     histogram walks the in-window expiries in order (warp argmin).
//
// Arithmetic is the plain version's (one rounded f64 operation per clock
// and finish, built with --fmad=false); counters and response sums are
// equal bit for bit, the integrals and bins agree to rounding.

#include <cstdint>

#include "scan64_common.cuh"

using namespace scan64;

namespace {

struct Args {
  const void* arr;  // [R, K] f32 gaps, or f64 (arr_f64) / f32 timestamps
  const float* warms;
  const float* colds;
  const float* fail_u;   // reliability
  const uint8_t* first;  // retries
  const int* child;      // retries
  const double* t_exp;
  const double* t_end;
  const double* skip;
  const double* t_timeout;  // reliability
  const double* p_fail;     // reliability
  uint8_t* alive_out;       // [R, M]
  double* creation_out;     // [R, M]
  double* finish_out;       // [R, M, c]
  double* t_out;            // [R]
  double* acc;              // [R, cols]
  uint8_t* act;             // [R, K], zeroed (retries)
  int R, M, c, K, H;
  long long max_c;
  int prestamped, arr_f64, rely_at, hist_at, cols;
};

template <int S>
__global__ void __launch_bounds__(128) par_scan_kernel(const Args a, int wpb) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * wpb + wid;
  if (row >= a.R) return;
  const int c = a.c;
  double* fin = smem + (size_t)wid * ((size_t)a.M * c + a.H);
  double* shist = fin + (size_t)a.M * c;
  for (int i = lane; i < a.M * c; i += 32) fin[i] = NEG;
  for (int i = lane; i < a.H; i += 32) shist[i] = 0.0;
  __syncwarp();

  const bool rely = a.t_timeout != nullptr;
  const bool retries = a.first != nullptr;
  const size_t pk = (size_t)row * a.K;
  const double te = a.t_exp[row], tend = a.t_end[row], skp = a.skip[row];
  const double tto = rely ? a.t_timeout[row] : 0.0;
  const double pf = rely ? a.p_fail[row] : 0.0;

  bool al[S];
  double cre[S], bsy[S], fb[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    al[s] = false;
    cre[s] = NEG;
    bsy[s] = NEG;
    fb[s] = NEG;
  }
  double p_run = 0.0, p_idle = 0.0, p_flight = 0.0, p_life = 0.0;
  long long p_lcnt = 0;
  long long n_cold = 0, n_warm = 0, n_rej = 0, n_over = 0;
  long long n_to = 0, n_fail = 0, n_retry = 0, n_aband = 0;
  double s_cold = 0.0, s_warm = 0.0;
  double t_prev = 0.0;

  auto integrate = [&](double lo, double hi) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (al[s]) {
        double run, idle;
        slot_integrals(bsy[s], bsy[s] + te, INFINITY, lo, hi, run, idle);
        p_run += run;
        p_idle += idle;
      }
    }
    if (c <= 32) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (al[s]) {
          const double* r = fin + (size_t)(s * 32 + lane) * c;
          for (int i = 0; i < c; ++i) p_flight += fmax(fmin(r[i], hi) - lo, 0.0);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        unsigned live = __ballot_sync(FULL, al[s]);
        while (live) {
          const int j = s * 32 + __ffs(live) - 1;
          live &= live - 1;
          const double* r = fin + (size_t)j * c;
          for (int i = lane; i < c; i += 32) p_flight += fmax(fmin(r[i], hi) - lo, 0.0);
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
    const int n = min(32, a.K - k0);
    for (int e = 0; e < n; ++e) {
      const int k = k0 + e;
      const double x = __shfl_sync(FULL, x_arr, e);
      const double t = a.prestamped ? x : t_prev + x;
      const double lo = fmin(fmax(t_prev, skp), tend);
      const double hi = fmin(fmax(t, skp), tend);
      integrate(lo, hi);

#pragma unroll
      for (int s = 0; s < S; ++s) {
        const double ex = bsy[s] + te;
        if (al[s] && ex <= t) {
          if (ex > skp && ex <= tend) {
            p_life += ex - cre[s];
            ++p_lcnt;
          }
          al[s] = false;
        }
      }

      bool active = t <= tend;
      const int first = __shfl_sync(FULL, x_first, e);
      if (retries && active && !first) active = a.act[pk + k] != 0;
      double v = -INFINITY;
      int warm_j = INT_MAX;
      int n_alive = 0;
      int free_j = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (al[s] && fb[s] <= t && (cre[s] > v || warm_j == INT_MAX)) {
          v = cre[s];
          warm_j = s * 32 + lane;
        }
        n_alive += __popc(__ballot_sync(FULL, al[s]));
        const unsigned fm = __ballot_sync(FULL, !al[s] && s * 32 + lane < a.M);
        if (fm && free_j == INT_MAX) free_j = s * 32 + __ffs(fm) - 1;
      }
      warp_argmax(v, warm_j);
      const bool any_cap = warm_j != INT_MAX;
      const bool any_free = free_j != INT_MAX;
      const bool below = n_alive < a.max_c;
      const bool can_cold = !any_cap && below && any_free;
      const bool is_warm = any_cap && active;
      const bool is_cold = can_cold && active;
      const bool is_rej = !any_cap && !can_cold && active;
      const bool assign = is_warm || is_cold;
      const double w_s = (double)__shfl_sync(FULL, x_warm, e);
      const double c_s = (double)__shfl_sync(FULL, x_cold, e);
      const double service = is_warm ? w_s : c_s;
      const double occ = rely ? fmin(service, tto) : service;
      if (assign) {
        const int inst = is_warm ? warm_j : free_j;
        double* r = fin + (size_t)inst * c;
        // the first finished sub-slot of the row as it stands
        int sub = 0;
        for (int b = 0; b < c; b += 32) {
          const int i = b + lane;
          const unsigned m = __ballot_sync(FULL, i < c && r[i] <= t);
          if (m) {
            sub = b + __ffs(m) - 1;
            break;
          }
        }
        __syncwarp();
        if (is_cold)
          for (int i = lane; i < c; i += 32) r[i] = NEG;
        __syncwarp();
        if (lane == (sub & 31)) r[sub] = t + occ;
        __syncwarp();
        double mx = -INFINITY, mn = INFINITY;
        for (int i = lane; i < c; i += 32) {
          mx = fmax(mx, r[i]);
          mn = fmin(mn, r[i]);
        }
        mx = warp_max(mx);
        mn = warp_min(mn);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (inst == s * 32 + lane) {
            bsy[s] = mx;
            fb[s] = mn;
            if (is_cold) {
              cre[s] = t;
              al[s] = true;
            }
          }
        }
      }

      const bool counted = t > skp;
      n_cold += is_cold && counted;
      n_warm += is_warm && counted;
      n_rej += is_rej && counted;
      n_over += !any_cap && below && !any_free && active;
      bool timed_out = false, failed = false, trigger = false;
      double cold_r = c_s, warm_r = w_s;
      if (rely) {
        const double fu = (double)__shfl_sync(FULL, x_fail, e);
        timed_out = assign && service > tto;
        failed = assign && !timed_out && fu < pf;
        trigger = timed_out || failed || is_rej;
        cold_r = fmin(c_s, tto);
        warm_r = fmin(w_s, tto);
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
      t_prev = t;
    }
  }

  const double lo = fmin(fmax(t_prev, skp), tend);
  integrate(lo, tend);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double ex = bsy[s] + te;
    if (al[s] && ex <= tend && ex > skp) {
      p_life += ex - cre[s];
      ++p_lcnt;
    }
  }

  const size_t pm = (size_t)row * a.M;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < a.M) {
      a.alive_out[pm + j] = al[s];
      a.creation_out[pm + j] = cre[s];
    }
  }
  for (int i = lane; i < a.M * c; i += 32) a.finish_out[pm * c + i] = fin[i];
  const double run = warp_sum(p_run), idle = warp_sum(p_idle);
  const double flight = warp_sum(p_flight), life = warp_sum(p_life);
  const long long lcnt = warp_sum(p_lcnt);
  double* out = a.acc + (size_t)row * a.cols;
  for (int i = lane; i < a.H; i += 32) out[a.hist_at + i] = shist[i];
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
    out[10] = flight;
    if (rely) {
      out[a.rely_at] = (double)n_to;
      out[a.rely_at + 1] = (double)n_fail;
      out[a.rely_at + 2] = (double)n_retry;
      out[a.rely_at + 3] = (double)n_aband;
    }
  }
}

template <int S>
int launch(const Args& a, cudaStream_t stream) {
  const size_t row_bytes = ((size_t)a.M * a.c + a.H) * sizeof(double);
  int wpb = 4;
  while (wpb > 1 && wpb * row_bytes > (size_t)96 * 1024) wpb /= 2;
  const size_t smem = wpb * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      par_scan_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.act) {
    err = cudaMemsetAsync(a.act, 0, (size_t)a.R * a.K, stream);
    if (err != cudaSuccess) return (int)err;
  }
  par_scan_kernel<S><<<(a.R + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(a, wpb);
  return (int)cudaGetLastError();
}

}  // namespace

// the most f64 values of one row's shared memory (finish[M, c] and the
// histogram bins): one row per block within sm_90's 227 KB
constexpr long long MAX_ROW_DOUBLES = 232448 / 8;

// Plain C entry, bound with ctypes.  ptrs (17, in this order): arr (f32,
// or f64 when arr_f64), warms, colds, fail_u (f32), is_first (uint8),
// child_pos (int32) [R, K]; t_exp, t_end, skip, t_timeout, p_fail (f64
// [R]); outputs alive (uint8 [R, M]), creation (f64 [R, M]), finish (f64
// [R, M, c]), t (f64 [R]), acc (f64 [R, cols]), act (uint8 [R, K]).  A
// null optional input turns its path off.  ints (13): R, M, c, K, H,
// max_concurrency, prestamped, arr_f64, rely_at, hist_at, cols, device;
// then the stream.  Returns the CUDA error code (0 = ok).
extern "C" int par_scan_sweep_f64(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  a.arr = ptrs[0];
  a.warms = (const float*)ptrs[1];
  a.colds = (const float*)ptrs[2];
  a.fail_u = (const float*)ptrs[3];
  a.first = (const uint8_t*)ptrs[4];
  a.child = (const int*)ptrs[5];
  a.t_exp = (const double*)ptrs[6];
  a.t_end = (const double*)ptrs[7];
  a.skip = (const double*)ptrs[8];
  a.t_timeout = (const double*)ptrs[9];
  a.p_fail = (const double*)ptrs[10];
  a.alive_out = (uint8_t*)ptrs[11];
  a.creation_out = (double*)ptrs[12];
  a.finish_out = (double*)ptrs[13];
  a.t_out = (double*)ptrs[14];
  a.acc = (double*)ptrs[15];
  a.act = (uint8_t*)ptrs[16];
  a.R = ints[0];
  a.M = ints[1];
  a.c = ints[2];
  a.K = ints[3];
  a.H = ints[4];
  a.max_c = ints[5];
  a.prestamped = ints[6];
  a.arr_f64 = ints[7];
  a.rely_at = ints[8];
  a.hist_at = ints[9];
  a.cols = ints[10];
  const int device = ints[11];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.R < 1 || a.M < 1 || a.M > 512 || a.c < 1 || a.K < 0 || a.H < 0 ||
      (long long)a.M * a.c + a.H > MAX_ROW_DOUBLES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int s = (a.M + 31) / 32;
  if (s <= 1) return launch<1>(a, st);
  if (s <= 2) return launch<2>(a, st);
  if (s <= 4) return launch<4>(a, st);
  if (s <= 8) return launch<8>(a, st);
  return launch<16>(a, st);
}
