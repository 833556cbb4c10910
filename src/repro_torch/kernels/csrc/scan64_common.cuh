// The warp helpers of the f64 engine's kernels: scan_event_step.cu (the
// pool scan) and par_scan_event_step.cu (the concurrency-value scan).  One
// warp runs one row; slot j of the row belongs to lane j % 32, as its
// (j / 32)-th slot, and bit j / 32 of the lane's `live` mask is its alive
// flag.  Every helper is warp-uniform: all 32 lanes call it and leave with
// the same value, except where a lane's own part is named.

#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace scan64 {

constexpr unsigned FULL = 0xffffffffu;
// the reference's dead-slot sentinel (_NEG_INF)
constexpr double NEG = -1e30;
// child_pos of a last attempt (core.reliability.NO_CHILD)
constexpr int NO_CHILD = 1 << 30;
using u64 = unsigned long long;

// Sum over the warp by an xor butterfly: IEEE addition commutes, so every
// lane ends with the same bits.
__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// An order-preserving 64-bit integer of an f64 (NaN aside): x < y iff
// okey(x) < okey(y), -0 and +0 share a key, and every key is above 0, which
// stands for "no candidate" in a max (and ~0 above every key, for a min).
// A warp's largest key is then two 32-bit reduxes (the high words, then the
// low words among the ties) and its lowest slot among equal keys a third,
// where an (f64, slot) shuffle tree takes five dependent rounds of three.
__device__ __forceinline__ u64 okey(double x) {
  const u64 u = (u64)__double_as_longlong(x + 0.0);  // -0 + 0 = +0
  return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}

__device__ __forceinline__ double key_value(u64 k) {
  return __longlong_as_double(
      (long long)((k & 0x8000000000000000ull) ? (k & 0x7fffffffffffffffull) : ~k));
}

__device__ __forceinline__ u64 warp_max_key(u64 k) {
  const unsigned hi = __reduce_max_sync(FULL, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 warp_min_key(u64 k) {
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(k >> 32));
  const unsigned lo =
      __reduce_min_sync(FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : UINT_MAX);
  return ((u64)hi << 32) | lo;
}

// the smallest value over the warp (+inf where no lane has one below it)
__device__ __forceinline__ double warp_min(double x) {
  return key_value(warp_min_key(okey(x)));
}

__device__ __forceinline__ double warp_max(double x) {
  return key_value(warp_max_key(okey(x)));
}

// #(a[i] <= x) over a sorted a[0, n): searchsorted(a, x, "right").
__device__ __forceinline__ int count_le(const double* a, int n, double x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// What a live state (busy until b, expiring at e = b + t_exp, crashing at
// d, +inf without crashes) accrues over (from, te], te the horizon's end:
// running time until min(b, d) and idle time from b until min(e, d).  The
// reference integrates each event's interval (lo, hi] clipped to [skip,
// te] (interval_integrals, fault_interval_integrals); over a span (P, Q]
// in which the state holds, P <= Q <= te, the sum of those pieces is
// accrue(P) - accrue(Q) exactly in real arithmetic, so a kernel adds
// accrue(P) when the state starts and subtracts accrue(Q) when it ends,
// with no work per event.  Each piece is one rounded f64 operation as in
// the reference; only the order of the additions differs.
__device__ __forceinline__ void accrue(double b, double e, double d, double from, double te,
                                       double& run, double& idle) {
  run = fmax(fmin(fmin(b, d), te) - from, 0.0);
  idle = fmax(fmin(fmin(e, d), te) - fmax(b, from), 0.0);
}

// The smallest grid time past the clock t (+inf if none).
__device__ __forceinline__ double next_grid(const double* g, int G, double t, int lane) {
  double m = INFINITY;
  for (int i = lane; i < G; i += 32) {
    const double v = __ldg(g + i);
    if (v > t) m = fmin(m, v);
  }
  return warp_min(m);
}

// The instance-count histogram, credited where the count changes
// (histogram_update's segments): between two events the count only falls,
// at the live instances' expiries, and the pool changes it only at a cold
// start, an exit or an eviction.  So the row keeps the clock x up to which
// the histogram is credited, and before each such change credits (x, to]
// from the pool as it stands: n0 instances live past x, then one segment
// per distinct expiry inside (x, to], in order, at count n0 - (expiries so
// far).  A warm start moves only an expiry past the clock, which a later
// credit reads.  The bins are the row's f64 histogram columns (lane 0
// adds); a count past the last bin adds to it, a segment of no length adds
// nothing.
template <int S>
__device__ __forceinline__ void hist_credit(unsigned live, const double (&busy)[S], double texp,
                                            double& x, double to, double* bins, int H,
                                            int lane) {
  if (!(to > x)) return;
  int n0 = 0;
  unsigned inw = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double e = busy[s] + texp;
    const bool lv = ((live >> s) & 1u) && e > x;
    if (lv && e <= to) inw |= 1u << s;
    n0 += __popc(__ballot_sync(FULL, lv));
  }
  double prev = x;
  int q = 0;
  while (__any_sync(FULL, inw)) {
    double v = INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if ((inw >> s) & 1u) v = fmin(v, busy[s] + texp);
    v = warp_min(v);
    unsigned eq = 0u;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (((inw >> s) & 1u) && busy[s] + texp == v) eq |= 1u << s;
    inw &= ~eq;
    const double dur = fmax(v - prev, 0.0);
    const int cnt = n0 - q;
    if (lane == 0 && cnt >= 0 && dur > 0.0) bins[min(cnt, H - 1)] += dur;
    q += (int)__reduce_add_sync(FULL, (unsigned)__popc(eq));
    prev = v;
  }
  const double dur = fmax(to - prev, 0.0);
  const int cnt = n0 - q;
  if (lane == 0 && cnt >= 0 && dur > 0.0) bins[min(cnt, H - 1)] += dur;
  x = to;
}

}  // namespace scan64
