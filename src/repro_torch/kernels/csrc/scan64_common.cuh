// The warp helpers of the f64 engine's kernels: scan_event_step.cu (the
// pool scan) and par_scan_event_step.cu (the concurrency-value scan).  One
// warp runs one row; slot j of the row belongs to lane j % 32, as its
// (j / 32)-th slot.  Every helper leaves the same value in all 32 lanes.

#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace scan64 {

constexpr unsigned FULL = 0xffffffffu;
// the reference's dead-slot sentinel (_NEG_INF)
constexpr double NEG = -1e30;
// child_pos of a last attempt (core.reliability.NO_CHILD)
constexpr int NO_CHILD = 1 << 30;

// Sum over the warp by an xor butterfly: IEEE addition commutes, so every
// lane ends with the same bits.
__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// The largest value and, among equal ones, the lowest slot: jnp.argmax's
// tie rule.  A lane without a candidate passes (-inf, INT_MAX).
__device__ __forceinline__ void warp_argmax(double& v, int& j) {
  for (int o = 16; o; o >>= 1) {
    const double ov = __shfl_xor_sync(FULL, v, o);
    const int oj = __shfl_xor_sync(FULL, j, o);
    if (ov > v || (ov == v && oj < j)) {
      v = ov;
      j = oj;
    }
  }
}

// The smallest value and, among equal ones, the lowest slot; a lane
// without a candidate passes (+inf, INT_MAX).
__device__ __forceinline__ void warp_argmin(double& v, int& j) {
  for (int o = 16; o; o >>= 1) {
    const double ov = __shfl_xor_sync(FULL, v, o);
    const int oj = __shfl_xor_sync(FULL, j, o);
    if (ov < v || (ov == v && oj < j)) {
      v = ov;
      j = oj;
    }
  }
}

__device__ __forceinline__ double warp_max(double x) {
  for (int o = 16; o; o >>= 1) x = fmax(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ double warp_min(double x) {
  for (int o = 16; o; o >>= 1) x = fmin(x, __shfl_xor_sync(FULL, x, o));
  return x;
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

// #(a[i] < x) over a sorted a[0, n).
__device__ __forceinline__ int count_lt(const double* a, int n, double x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The running and idle time of one slot over (lo, hi], its accrual cut at
// stop = min(hi, doom) (doom = +inf without crashes): the reference's
// interval_integrals / fault_interval_integrals, one slot, each piece one
// rounded f64 subtraction clipped at 0.
__device__ __forceinline__ void slot_integrals(double busy, double expire, double doom,
                                               double lo, double hi, double& run,
                                               double& idle) {
  const double stop = fmin(hi, doom);
  run = fmax(fmin(busy, stop) - lo, 0.0);
  idle = fmax(fmin(expire, stop) - fmax(busy, lo), 0.0);
}

}  // namespace scan64
