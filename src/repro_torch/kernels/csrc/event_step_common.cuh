// The warp helpers of the event-loop kernels: faas_event_step.cu (one pool
// per warp), fleet_event_step.cu (a fleet's pools per warp) and
// par_event_step.cu (one concurrency-value pool per warp).  The order key
// behind warm routing and the newest-idle eviction order (a key and two
// reduxes), the capacity segment lookup of the fault path, and what a live
// instance accrues ahead of the clock.  One copy, so that the tie rule, the
// segment rule and the integrals cannot drift apart between the engines.

#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// An order-preserving u32 of an f32 (NaN aside): x < y iff key(x) <
// key(y), -0 and +0 share a key, and every float's key is above 0, which
// stands for "no candidate".  The warp's newest candidate is then one redux
// (the largest key) and its lowest id among ties a second: two
// instructions, where a shuffle tree takes ten.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.f));  // -0 + 0 = +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// What an instance accrues over (from, te] if its state holds: running
// time until min(busy, doom) and idle time from busy until min(expire,
// doom), clipped to the horizon's end te (from <= te).  The reference
// integrates each event's interval (lo, hi]; over a span (P, Q] in which
// the state holds, with P <= Q <= te, the sum of those pieces is
// accrue(P) - accrue(Q) exactly in real arithmetic, so a kernel can add
// accrue(P) when the state starts, subtract accrue(Q) when it ends, and
// do no per-event work.  Each piece is one rounded subtraction, as in the
// reference; only the accumulation order differs.
__device__ __forceinline__ float2 accrue(float busy, float expire, float doom, float from,
                                         float te) {
  const float run = fmaxf(__fsub_rn(fminf(fminf(busy, doom), te), from), 0.f);
  const float idle =
      fmaxf(__fsub_rn(fminf(fminf(expire, doom), te), fmaxf(busy, from)), 0.f);
  return make_float2(run, idle);
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
