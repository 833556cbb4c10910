// The warp helpers that faas_event_step.cu (one pool per warp) and
// fleet_event_step.cu (a fleet's pools per warp) share: the arg-max behind
// warm routing and the newest-idle eviction order, and the capacity
// segment lookup of the fault path.  One copy, so that the tie rule and
// the segment rule cannot drift apart between the two engines.

#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// the warp's largest best (the lowest best_j on a tie), in every lane
__device__ __forceinline__ void warp_argmax(float& best, int& best_j) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, m);
    const int oj = __shfl_xor_sync(FULL, best_j, m);
    if (ob > best || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
  }
}

// The capacity segment of t in a profile (E edges, a leading 0 edge
// implied): its ceiling, and the bounds [lo, hi) over which it holds, in
// every lane.  seg = #(edges <= t), counting the implied 0, minus 1; before
// t = 0 there is no segment and the ceiling is 0, as in the plain version.
__device__ __forceinline__ void cap_seek(const float* edges, const float* values, int E,
                                         float t, int lane, float& now, float& lo,
                                         float& hi) {
  int cnt = 0.f <= t ? 1 : 0;
  for (int b = 0; b < E; b += 32) {
    const int j = b + lane;
    cnt += __popc(__ballot_sync(FULL, j < E && __ldg(edges + j) <= t));
  }
  const int seg = cnt - 1;
  now = seg >= 0 ? __ldg(values + seg) : 0.f;
  lo = seg >= 1 ? __ldg(edges + seg - 1) : (seg == 0 ? 0.f : -INFINITY);
  hi = seg < 0 ? 0.f : (seg < E ? __ldg(edges + seg) : INFINITY);
}

}  // namespace
