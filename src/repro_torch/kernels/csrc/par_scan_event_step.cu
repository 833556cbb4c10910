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
// request takes the instance's first finished sub-slot (the first sub-slot
// when none is), found before a cold start wipes the reused row to NEG,
// and holds it until t + min(service, t_timeout).  Reliability and
// retries as in the pool scan (scan_event_step.cu); then the tail (t_last,
// t_end] is flushed.
//
// What bounds it on this card: each row is a chain of dependent events on
// 12 to 21 bytes of samples each.  The first design did the reference's
// work per event: ∫in-flight over every sub-slot of every live instance,
// running and idle time on every live slot, an exit walk, live-count and
// free-slot ballots, an (f64, slot) shuffle argmax and, per assignment, a
// row search, a wipe and an f64 max and min over c; finish[M, c] lived in
// shared memory, so at c = 80 a row took 40,960 bytes and a block of 96 KB
// held 2 rows (about 4 an SM, 8 waves for 4,096 rows) where about one
// instance is live: 161x, 243x and 201x its bound at c = 1, 3, 80.
//
// What the design does about that: one warp per row, and sub-slot work
// only on the instance an event changes (the f32 kernel's design,
// par_event_step.cu, in f64, with scan_event_step.cu's exit bound and
// inert tail):
//   - Slot j belongs to lane j % 32: its busy (the row's max finish),
//     free-by (the row's min finish) and the creation's order key in
//     registers, alive as a bitmask.  An event's routing needs no
//     sub-slot: #(finish > t) < c iff free-by <= t.
//   - ∫in-flight is accrued per request at its assignment: its finish is
//     fixed then, so its time in flight clipped to [skip, t_end] is known
//     at once (the reference's tail flush counts the rest up to t_end).  A
//     request is replaced only once finished, so replacing needs no
//     give-back; an instance that exits gives back what its requests
//     accrued past the removal (nothing, with t_exp >= 0).  Running and
//     idle time are accrued per state span (scan64_common.cuh accrue).
//     Where the clipped clock goes back, one pass over the live slots and
//     their rows adds what each accrues over the interval counted again.
//   - The exit bound, order-key routing (the newest instance with a free
//     sub-slot: two reduxes for its key, one for its lowest slot), the
//     warp-uniform live count, the histogram credited where the count
//     changes, and the inert tail past t_end, as in scan_event_step.cu.
//   - An assignment updates one row: at c = 1 it writes the request's
//     finish without a read; up to c = 3 the slot's lane walks the row
//     alone (the f32 kernel measured a few reads beating a ballot and two
//     reduxes up to c = 3 on an H100); above, lane i takes sub-slots i,
//     i + 32, ..., a ballot finds the first finished one and four reduxes
//     the row's new free-by and busy (a cold start's row is NEG but for
//     the request, so it needs none).
//   - finish lives in the output plane in device memory, instance-major,
//     read and written only on an assignment (the lines a warp touches
//     stay in L1), so no shared memory caps the rows an SM holds.  Measured
//     in turns at Fig. 1 c = 80 on an H100 (700 W): all rows in device
//     memory 112.4 ms; the rows of the lowest slots (where cold starts
//     gather the live instances) in 4 or 8 KB of shared memory a warp
//     114.3 and 114.4 ms, 16 KB 160.6, 64 KB (every row) 336.5.
//
// Arithmetic is the plain version's (kernels/ref64.py par_scan_sweep_ref;
// one rounded f64 operation per clock and finish, built with
// --fmad=false); counters, response sums, the final pool and finish plane
// are equal bit for bit, the integrals and bins agree to rounding.

#include "scan64_common.cuh"

using namespace scan64;

namespace {

constexpr int WARPS = 4;  // rows a block
// up to SERIAL_C sub-slots the slot's lane walks the row alone
constexpr int SERIAL_C = 3;

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
  double* finish_out;       // [R, M, c]: the rows as the kernel updates them
  double* t_out;            // [R]
  double* acc;              // [R, cols]
  uint8_t* act;             // [R, K], zeroed (retries)
  int R, M, c, K, H;
  long long max_c;
  int prestamped, arr_f64, rely_at, hist_at, cols;
};

template <int S, typename T>
__device__ __forceinline__ T pick(const T (&v)[S], int cs) {
  T x = v[0];
#pragma unroll
  for (int s = 1; s < S; ++s) x = s == cs ? v[s] : x;
  return x;
}

// what a request finishing at f accrues in flight from clock x on (<= te)
__device__ __forceinline__ double ahead(double f, double x, double te) {
  return fmax(fmin(f, te) - x, 0.0);
}

// this lane's part of what a row's requests accrue in flight from x on,
// less what they accrue from y on
__device__ __forceinline__ double row_span(const double* rf, int c, double x, double y,
                                           double te, int lane) {
  double v = 0.0;
  for (int i = lane; i < c; i += 32) v += ahead(rf[i], x, te) - ahead(rf[i], y, te);
  return v;
}

template <int S>
__global__ void __launch_bounds__(WARPS * 32, S <= 4 ? 4 : 1) par_scan_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.R) return;
  const int c = a.c, M = a.M, K = a.K, H = a.H;
  const size_t pm = (size_t)row * M;
  double* fin = a.finish_out + pm * c;  // this row's finish[M, c]
  const auto row_of = [&](int j) { return fin + (size_t)j * c; };
  for (size_t i = lane; i < (size_t)M * c; i += 32) fin[i] = NEG;
  double* out = a.acc + (size_t)row * a.cols;
  double* hist = out + a.hist_at;
  for (int i = lane; i < H; i += 32) hist[i] = 0.0;
  __syncwarp();

  const bool rely = a.t_timeout != nullptr;
  const bool retries = a.first != nullptr;
  const size_t pk = (size_t)row * K;
  const double te = a.t_exp[row], tend = a.t_end[row], skp = a.skip[row];
  const double tto = rely ? a.t_timeout[row] : 0.0;
  const double pf = rely ? a.p_fail[row] : 0.0;

  unsigned live = 0u;
  double bsy[S], fb[S];
  u64 ck[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bsy[s] = NEG;
    fb[s] = NEG;
    ck[s] = okey(NEG);
  }
  double run_l = 0.0, idle_l = 0.0, flight_l = 0.0, life_l = 0.0;
  int lcnt_l = 0;
  int n_cold = 0, n_warm = 0, n_rej = 0, n_over = 0;
  int n_to = 0, n_fail = 0, n_retry = 0, n_aband = 0;
  double s_cold = 0.0, s_warm = 0.0;
  double t = 0.0;
  double hi_prev = fmin(fmax(t, skp), tend), x_h = hi_prev;
  int n_live = 0;
  double next_exit = INFINITY, tmax = -INFINITY;
  bool deferred = false;

  // the exit pass at clock T (the event's clipped clock hi)
  const auto exit_pass = [&](double T, double hi) {
    if (H) hist_credit<S>(live, bsy, te, x_h, hi, hist, H, lane);
    unsigned gone = 0u;
    double nx = INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((live >> s) & 1u) {
        const double e = bsy[s] + te;
        if (e <= T) {
          gone |= 1u << s;
          if (e > skp && e <= tend) {
            life_l += e - key_value(ck[s]);
            ++lcnt_l;
          }
        } else {
          nx = fmin(nx, e);
        }
      }
    }
    if (te < 0.0) {
      __syncwarp();  // the owners' row writes, before every lane reads
      // requests may outlive their instance's exit: they give back what
      // they accrued in flight past hi (with t_exp >= 0 every request
      // finished by the exit)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        unsigned lanes = __ballot_sync(FULL, (gone >> s) & 1u);
        while (lanes) {
          const int src = __ffs(lanes) - 1;
          lanes &= lanes - 1;
          flight_l += row_span(row_of(s * 32 + src), c, tend, hi, tend, lane);
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
    const double x_l = in ? (a.arr_f64 ? arr64[ek] : (double)arr32[ek]) : 0.0;
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
    const float w_l = in ? a.warms[ek] : 0.f;
    const float c_l = in ? a.colds[ek] : 0.f;
    const float f_l = (in && rely) ? a.fail_u[ek] : 0.f;
    const int first_l = (in && retries) ? (int)a.first[ek] : 1;
    const int child_l = (in && retries) ? a.child[ek] : NO_CHILD;
    const int act_l = (in && retries) ? (int)a.act[ek] : 0;
    unsigned pend = 0u;
    for (int i = 0; i < n; ++i) {
      const double x = __shfl_sync(FULL, x_l, i);
      const double tn = a.prestamped ? x : t + x;
      const double hi = fmin(fmax(tn, skp), tend);
      const bool quiet = tn <= tend && !deferred && hi >= hi_prev && tn < next_exit;
      if (!quiet) {
        const bool inert = !(tn <= tend);
        if (!inert && deferred) {
          exit_pass(tmax, hi_prev);
          deferred = false;
        }
        if (inert) {
          hi_prev = hi;
          tmax = deferred ? fmax(tmax, tn) : tn;
          deferred = true;
          t = tn;
          continue;
        }
        if (hi < hi_prev) {
          // the clipped clock went back: the live states and their
          // requests count (hi, hi_prev] again
          if (H) {
            hist_credit<S>(live, bsy, te, x_h, hi_prev, hist, H, lane);
            x_h = hi;
          }
          __syncwarp();  // the owners' row writes, before every lane reads
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if ((live >> s) & 1u) {
              double ra, ia, rb, ib;
              accrue(bsy[s], bsy[s] + te, INFINITY, hi, tend, ra, ia);
              accrue(bsy[s], bsy[s] + te, INFINITY, hi_prev, tend, rb, ib);
              run_l += ra - rb;
              idle_l += ia - ib;
            }
            unsigned lanes = __ballot_sync(FULL, (live >> s) & 1u);
            while (lanes) {
              const int src = __ffs(lanes) - 1;
              lanes &= lanes - 1;
              flight_l += row_span(row_of(s * 32 + src), c, hi, hi_prev, tend, lane);
            }
          }
        }
        if (tn >= next_exit) exit_pass(tn, hi);
      }
      hi_prev = hi;

      bool active = true;
      int first = 1;
      if (retries) {
        first = __shfl_sync(FULL, first_l, i);
        active = first || __shfl_sync(FULL, act_l, i) || ((pend >> i) & 1u);
      }
      if (active) {
        // the newest instance with a finished sub-slot
        u64 kb = 0ull;
        int sb = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const u64 kk = ((live >> s) & 1u) && fb[s] <= tn ? ck[s] : 0ull;
          if (kk > kb) {
            kb = kk;
            sb = s;
          }
        }
        const u64 best = warp_max_key(kb);
        const bool any_cap = best != 0ull;
        int inst = -1;
        bool below = true, any_free = true;
        if (any_cap) {
          inst = (int)__reduce_min_sync(FULL, kb == best ? (unsigned)(sb * 32 + lane) : UINT_MAX);
        } else {
          int free_j = -1;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const unsigned fm = __ballot_sync(FULL, s * 32 + lane < M && !((live >> s) & 1u));
            if (free_j < 0 && fm) free_j = s * 32 + __ffs(fm) - 1;
          }
          any_free = free_j >= 0;
          below = n_live < a.max_c;
          if (below && any_free) inst = free_j;
        }
        const bool is_cold = !any_cap && inst >= 0;
        const bool assign = inst >= 0;
        const double w_s = (double)__shfl_sync(FULL, w_l, i);
        const double c_s = (double)__shfl_sync(FULL, c_l, i);
        const double service = any_cap ? w_s : c_s;
        const double occ = rely ? fmin(service, tto) : service;
        if (assign) {
          if (is_cold && H) hist_credit<S>(live, bsy, te, x_h, hi, hist, H, lane);
          const double fin = tn + occ;
          double* rf = row_of(inst);
          const int owner = inst & 31, cs = inst >> 5;
          // the request's sub-slot, then the row's new free-by and busy
          double nfb, nb;
          if (c == 1) {
            // the one sub-slot takes the request (finished, or the first
            // when none is): no read
            nfb = nb = fin;
            if (lane == owner) rf[0] = fin;
          } else if (c <= SERIAL_C) {
            nfb = INFINITY;
            nb = -INFINITY;
            if (lane == owner) {
              double v[SERIAL_C];
              int sub = -1;
#pragma unroll
              for (int q = 0; q < SERIAL_C; ++q) {
                v[q] = q < c ? rf[q] : INFINITY;
                if (sub < 0 && q < c && v[q] <= tn) sub = q;
              }
              if (sub < 0) sub = 0;
#pragma unroll
              for (int q = 0; q < SERIAL_C; ++q) {
                if (q < c) {
                  const double w = q == sub ? fin : (is_cold ? NEG : v[q]);
                  if (q == sub || is_cold) rf[q] = w;
                  nfb = fmin(nfb, w);
                  nb = fmax(nb, w);
                }
              }
            }
          } else {
            int sub = -1;
            for (int b = 0; b < c && sub < 0; b += 32) {
              const int q = b + lane;
              const unsigned h = __ballot_sync(FULL, q < c && rf[q] <= tn);
              if (h) sub = b + __ffs(h) - 1;
            }
            if (sub < 0) sub = 0;
            if (is_cold) {
              // the row is NEG but for the request
              for (int q = lane; q < c; q += 32) rf[q] = q == sub ? fin : NEG;
              nfb = fmin(fin, NEG);
              nb = fmax(fin, NEG);
            } else {
              u64 kmin = ~0ull, kmax = 0ull;
              for (int q = lane; q < c; q += 32) {
                double w = rf[q];
                if (q == sub) {
                  w = fin;
                  rf[q] = w;
                }
                const u64 k = okey(w);
                kmin = min(kmin, k);
                kmax = max(kmax, k);
              }
              nfb = key_value(warp_min_key(kmin));
              nb = key_value(warp_max_key(kmax));
            }
          }
          if (lane == owner) {
            const double b = pick<S>(bsy, cs);
            // a new busy ends the old state at hi and starts the new one
            if (is_cold || nb != b) {
              double r, idl;
              if (!is_cold) {
                accrue(b, b + te, INFINITY, hi, tend, r, idl);
                run_l -= r;
                idle_l -= idl;
              }
              accrue(nb, nb + te, INFINITY, hi, tend, r, idl);
              run_l += r;
              idle_l += idl;
            }
            // the request's time in flight, to its finish
            flight_l += ahead(fin, hi, tend);
            const u64 kc = okey(tn);
#pragma unroll
            for (int s = 0; s < S; ++s) {
              bsy[s] = s == cs ? nb : bsy[s];
              fb[s] = s == cs ? nfb : fb[s];
              ck[s] = s == cs && is_cold ? kc : ck[s];
            }
            if (is_cold) live |= 1u << cs;
          }
          if (is_cold) ++n_live;
          // busy, the row's max, is at least fin
          next_exit = fmin(next_exit, fin + te);
        }

        const bool counted = tn > skp;
        n_cold += is_cold && counted;
        n_warm += any_cap && counted;
        n_rej += !assign && counted;
        n_over += !any_cap && below && !any_free;
        double cold_r = c_s, warm_r = w_s;
        if (rely) {
          const bool timed_out = assign && service > tto;
          const bool failed = assign && !timed_out && (double)__shfl_sync(FULL, f_l, i) < pf;
          const bool trigger = timed_out || failed || !assign;
          cold_r = fmin(c_s, tto);
          warm_r = fmin(w_s, tto);
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
        }
        if (is_cold && counted) s_cold += cold_r;
        if (any_cap && counted) s_warm += warm_r;
      }
      t = tn;
    }
  }

  // the exits deferred past the horizon; the histogram up to t_end and the
  // lifespans of exits in the tail (the live states and their requests
  // accrued up to t_end already)
  if (deferred) exit_pass(tmax, hi_prev);
  if (H) hist_credit<S>(live, bsy, te, x_h, tend, hist, H, lane);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double e = bsy[s] + te;
    if (((live >> s) & 1u) && e <= tend && e > skp) {
      life_l += e - key_value(ck[s]);
      ++lcnt_l;
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      a.alive_out[pm + j] = (live >> s) & 1u;
      a.creation_out[pm + j] = key_value(ck[s]);
    }
  }
  const double run = warp_sum(run_l), idle = warp_sum(idle_l);
  const double flight = warp_sum(flight_l), life = warp_sum(life_l);
  const int lcnt = (int)__reduce_add_sync(FULL, (unsigned)lcnt_l);
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
  par_scan_kernel<S><<<(a.R + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes.  ptrs (17, in this order): arr (f32,
// or f64 when arr_f64), warms, colds, fail_u (f32), is_first (uint8),
// child_pos (int32) [R, K]; t_exp, t_end, skip, t_timeout, p_fail (f64
// [R]); outputs alive (uint8 [R, M]), creation (f64 [R, M]), finish (f64
// [R, M, c]), t (f64 [R]), acc (f64 [R, cols]), act (uint8 [R, K]).  A
// null optional input turns its path off.  ints (12): R, M, c, K, H,
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
  if (a.R < 1 || a.M < 1 || a.M > 512 || a.c < 1 || a.K < 0 || a.H < 0)
    return (int)cudaErrorInvalidValue;
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
