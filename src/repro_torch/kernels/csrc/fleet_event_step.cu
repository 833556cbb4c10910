// Hopper (sm_90a) kernel of the fleet engine: F <= 8 function pools under
// one shared cluster capacity, with optional bounded FIFO queues.
//
// Replaces the TPU kernel repro/kernels/faas_event_step.py::_fleet_kernel
// (launched by fleet_sweep_pallas through _pallas_fleet_rows) for its base
// path, the gap and prestamped stream modes, queue_depth > 0 and platform
// faults.  A fleet
// (one what-if cell x one replica) is F functions, each with its own pool
// of M instance slots, its keep-alive threshold and its concurrency limit;
// cold starts of every function contend for ncl live instances in all.
// The fleet runs the K events of one merged arrival stream (times or
// gaps, the acting function's id, its warm and cold service samples).
// Per event, in this order:
//   1. every pool integrates running and idle instance-time over the
//      interval clipped to [skip, t_end];
//   2. every pool expires its instances with busy + t_exp <= t_new (a tie
//      expires);
//   3. with queues, up to Q drain passes serve the acting function's queue
//      head (only while the event lies inside the horizon): warm on the
//      newest idle instance, else cold under the function's limit, a free
//      slot and the cluster capacity; a pass that serves nothing leaves
//      the state unchanged, so draining stops at the first such pass;
//   4. the acting function routes the arrival: warm on the newest idle
//      instance (lowest slot on a creation tie), else cold when its live
//      count is below its limit, it has a free slot and the fleet-wide
//      live count is below ncl, else the queue if it has room, else reject;
//   5. peak = max(peak, fleet-wide live count), on every event.
// Counters engage past skip (overflow only needs the horizon).  The acc
// columns per function are the reference's FLEET_ACC_COLS: cold, warm,
// reject, run, idle, cold response, warm response, overflow, arrivals,
// enqueued, queue-served, queue wait, peak.
//
// Platform faults (FAULT, not with queues): the fault path of
// faas_event_step.cu, per function pool, without reliability.  Each slot
// carries a crash clock (doom, +inf until a cold start stamps t_new +
// (-log(1 - u) / crash_rate) from the event's crash uniform, read through
// `stream` like the samples); step 1 stops at min(hi, doom), step 2 exits
// at min(expiry, doom) and counts a crash (doom < expiry, skip < doom <=
// t_end) for the dying instance's function.  Between steps 2 and 4, with a
// capacity profile (per fleet, a leading 0 edge implied), ceil(fleet live
// count - ceiling) of the newest idle instances fleet-wide are evicted
// inside the horizon: one warp arg-max pass each over (creation, lower
// flat id f*M + m on a tie), counted past skip for the evicted instance's
// function; step 4's cold start also needs the fleet's live count below
// the ceiling, and an arrival whose instance dies before its service ends
// is interrupted.  The three fault columns (crashes, evictions, interrupted
// attempts) follow the 13; crashes and evictions, found in any lane, are
// counted into their function's owner lane by ballots, only on events that
// have one.  With crashes off the clocks hold +inf, which leaves the mins
// the identity; without FAULT the code is the path without faults.
//
// What the TPU kernel's layout was, and why this one differs: the TPU
// kernel makes a fleet an 8-row block, one row per function, and its
// launcher copies the merged stream into every row of every block (8 rows
// x every cell of a sweep).  Here a fleet reads its replica's stream once,
// through the per-fleet row index `stream`, so a sweep's cells share one
// [replicas, K] stream; fids travel as uint8.
//
// What bounds it on this card: operations.  Each event needs the two
// integrals and the expiry test on every live instance of the fleet
// (11 f32 operations each), the idle and newest tests on the acting
// function's live instances, and O(1) scalar work (clock, decisions,
// counters, the lowest free slot, live counts), against 13 bytes of
// stream per event, read once for every cell that shares the stream: at
// the catalog sweep (F = 8, M = 64, ~23 live instances) ~320 operations,
// ~25 per byte for a single cell, above the H100's f32 balance point
// (~20 operations per byte).  This kernel does the per-slot work
// (~16 f32 operations) on all F*M slots, live or not, ~25x what the live
// instances need there, and each fleet is a sequential chain of events.
//
// What the design does about that: one warp per fleet, with all F*M slots
// in the warp's registers (FP*SF slots per lane: function g's slot m sits
// in lane m % 32, register g*SF + m/32; FP is F rounded up to a power of
// two, SF = M/32 rounded up), so the fleet-wide live count is one
// __reduce_add_sync of the lanes' alive-bit popcounts and never needs a
// block barrier.  Expiry and the integrals run over every slot; routing
// touches only the acting function's SF registers (its id is warp-uniform,
// so the branch is uniform).  The per-function run/idle sums of an event
// are one reduce-scatter over the warp (FP values per lane halved at each
// butterfly stage: 2(FP-1) + 2(5 - log2 FP) shuffles for both sums instead
// of 10 FP), after which lane g holds function g's sums; lane g also owns
// function g's 12 accumulators, its queue's head and length, and its
// limit, so nothing is replicated F times.  The queues are three [FP, Q]
// planes per warp in shared memory, used as rings (same FIFO order as the
// reference's shifted arrays).  Samples are loaded 32 events at a time,
// one per lane (coalesced), and broadcast per event with __shfl_sync.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py::
// fleet_sweep_ref): every clock update is one rounded f32 operation
// (built with --fmad=false, written with __fadd_rn), the sentinels are
// the reference's (NEG = -1e30, any_idle = best > NEG/2, ncl = inf as
// 1e30), live counts are exact integers, and each accumulator adds the
// same values in the same order (drain passes first, then the arrival).
// Only the per-function M-sums of the integrals (columns 3 and 4) are
// summed in another order, so they may differ in the last places.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "event_step_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 4;  // fleets per block
constexpr int ACC_COLS = 13;
constexpr int FAULT_COLS = 3;
constexpr int MAX_FUNCTIONS = 8;
// queue entries per function: 3 planes x 8 functions x 128 entries x 4
// warps x 4 bytes is the 48 KB of shared memory a block has by default
constexpr int MAX_QUEUE = 128;

template <int FP>
struct Log2 {
  static constexpr int value = 1 + Log2<FP / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// v[FP] per lane -> the warp sum of value index (lane >> (5 - log2 FP)),
// returned in that lane: each butterfly stage sends the half of the values
// a lane does not keep, the last 5 - log2 FP stages reduce the one left.
template <int FP>
__device__ __forceinline__ float reduce_scatter(float (&v)[FP], int lane) {
#pragma unroll
  for (int st = 0; st < Log2<FP>::value; ++st) {
    const int h = FP >> (st + 1), m = 16 >> st;
    const bool upper = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, m));
    }
  }
#pragma unroll
  for (int m = 16 / FP; m >= 1; m >>= 1)
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], m));
  return v[0];
}

// The acting function's routing candidates on the current pool: the
// newest idle instance (lowest slot on a creation tie) as best/best_m,
// the lowest free slot (-1 if none) and its live count, in every lane.
template <int FP, int SF>
__device__ __forceinline__ void route(int fa, unsigned alive, const float (&cre)[FP * SF],
                                      const float (&busy)[FP * SF], float t_new, int M,
                                      int lane, float& best, int& best_m,
                                      int& first_free, int& n_alive) {
  best = NEG;
  best_m = INT_MAX;
  first_free = -1;
  int nal = 0;
#pragma unroll
  for (int g = 0; g < FP; ++g) {
    if (g == fa) {  // warp-uniform
#pragma unroll
      for (int q = 0; q < SF; ++q) {
        const int s = g * SF + q;
        const int m = q * 32 + lane;
        const bool al = (alive >> s) & 1u;
        // a lane's slots ascend with q, so '>' keeps the lowest slot on a tie
        if (al && busy[s] <= t_new && cre[s] > best) {
          best = cre[s];
          best_m = m;
        }
        nal += al;
        const unsigned fm = __ballot_sync(FULL, m < M && !al);
        if (first_free < 0 && fm) first_free = q * 32 + __ffs(fm) - 1;
      }
    }
  }
  warp_argmax(best, best_m);
  n_alive = (int)__reduce_add_sync(FULL, (unsigned)nal);
}

// start slot m of function fa: busy until `done`; a cold start also stamps
// its creation and makes it live
template <int FP, int SF>
__device__ __forceinline__ void assign(int fa, int m, bool cold, float t_new, float done,
                                       int lane, unsigned& alive, float (&cre)[FP * SF],
                                       float (&busy)[FP * SF]) {
#pragma unroll
  for (int g = 0; g < FP; ++g) {
    if (g == fa) {
#pragma unroll
      for (int q = 0; q < SF; ++q) {
        const int s = g * SF + q;
        if (q * 32 + lane == m) {
          busy[s] = done;
          if (cold) {
            cre[s] = t_new;
            alive |= 1u << s;
          }
        }
      }
    }
  }
}

// the fleet's newest idle instance (largest creation, lowest flat id f*M +
// m on a tie) as best/best_f in every lane; best = NEG when none is idle
template <int FP, int SF>
__device__ __forceinline__ void newest_idle_fleet(unsigned alive, const float (&cre)[FP * SF],
                                                  const float (&busy)[FP * SF], float t_new,
                                                  int M, int lane, float& best, int& best_f) {
  best = NEG;
  best_f = INT_MAX;
#pragma unroll
  for (int s = 0; s < FP * SF; ++s) {
    // a lane's flat ids ascend with s, so '>' keeps the lowest on a tie
    if (((alive >> s) & 1u) && busy[s] <= t_new && cre[s] > best) {
      best = cre[s];
      best_f = (s / SF) * M + (s % SF) * 32 + lane;
    }
  }
  warp_argmax(best, best_f);
}

// per function g, the lanes' bits of `mask` (bit s: slot s) among g's
// slots, counted into lane g's `acc` (one add per function with any)
template <int FP, int SF>
__device__ __forceinline__ void count_into_owner(unsigned mask, int lane, float& acc) {
#pragma unroll
  for (int g = 0; g < FP; ++g) {
    int n = 0;
#pragma unroll
    for (int q = 0; q < SF; ++q) n += __popc(__ballot_sync(FULL, (mask >> (g * SF + q)) & 1u));
    if (lane == g && n) acc = __fadd_rn(acc, (float)n);
  }
}

template <int FP, int SF, bool FAULT>
__global__ void __launch_bounds__(WARPS * 32)
fleet_sweep_kernel(const float* __restrict__ t_exp, const float* __restrict__ limit,
                   const float* __restrict__ ncl_in, const float* __restrict__ t_end,
                   const float* __restrict__ skip, const long long* __restrict__ stream,
                   const float* __restrict__ times, const uint8_t* __restrict__ fids,
                   const float* __restrict__ warms, const float* __restrict__ colds,
                   const float* __restrict__ crate_in, const float* __restrict__ crash_u,
                   const float* __restrict__ cap_e_in, const float* __restrict__ cap_v_in,
                   float* __restrict__ acc_out, float* __restrict__ qleft_out,
                   float* __restrict__ doom_out, int N, int F, int M, int K, int Q, int E,
                   int prestamped, long long rows) {
  constexpr int S = FP * SF;
  constexpr int SHIFT = 5 - Log2<FP>::value;
  constexpr int COLS = ACC_COLS + (FAULT ? FAULT_COLS : 0);
  extern __shared__ float qmem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int fleet = blockIdx.x * WARPS + wib;
  if (fleet >= N) return;  // the ragged last block: the whole warp leaves
  const long long row = stream[fleet];
  if (row < 0 || row >= rows) {  // no stream row to read: the fleet's outputs are NaN
    if (lane < F) {
      for (int c = 0; c < COLS; ++c)
        acc_out[((size_t)fleet * F + lane) * COLS + c] = __int_as_float(0x7fc00000);
      qleft_out[(size_t)fleet * F + lane] = __int_as_float(0x7fc00000);
    }
    return;
  }

  // this warp's three [FP, Q] queue planes (enqueue time, warm, cold)
  float* qt = qmem + (size_t)wib * 3 * FP * Q;
  float* qw = qt + FP * Q;
  float* qc = qw + FP * Q;

  unsigned alive = 0u;  // bit s: slot s is live
  float cre[S], busy[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    cre[s] = NEG;
    busy[s] = NEG;
  }
  // every function's threshold in every lane (indexed by the slot's
  // function, a compile-time index); padded functions are never live
  float texp[FP];
#pragma unroll
  for (int g = 0; g < FP; ++g) texp[g] = g < F ? t_exp[(size_t)fleet * F + g] : 1.f;
  const float ncl = ncl_in[fleet], tend = t_end[fleet], sk = skip[fleet];
  // lane g owns function g: its limit, accumulators and queue pointers
  const bool owner = lane < F;
  const float my_limit = owner ? limit[(size_t)fleet * F + lane] : 0.f;
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f, a_run = 0.f, a_idle = 0.f;
  float a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f, a_arr = 0.f, a_enq = 0.f;
  float a_qsrv = 0.f, a_qwait = 0.f;
  int my_qhead = 0, my_qlen = 0;
  float peak = 0.f, t = 0.f;
  // faults: the crash clocks (+inf: none stamped), the fleet's crash rate
  // and capacity profile, its current segment (empty: looked up at the
  // first event) and the owner lane's fault columns
  float doom[S];
  const bool crash = FAULT && crash_u != nullptr;
  const bool capped = FAULT && cap_v_in != nullptr;
  const float crate = crash ? crate_in[fleet] : 0.f;
  const float* cap_e = capped ? cap_e_in + (size_t)fleet * E : nullptr;
  const float* cap_v = capped ? cap_v_in + (size_t)fleet * (E + 1) : nullptr;
  float cap_now = 0.f, cap_lo = INFINITY, cap_hi = -INFINITY;
  float a_crash = 0.f, a_evict = 0.f, a_int = 0.f;
  if (FAULT) {
#pragma unroll
    for (int s = 0; s < S; ++s) doom[s] = INFINITY;
  }

  const size_t srow = (size_t)row * (size_t)K;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    const bool in = k < K;
    const float d_l = in ? times[srow + k] : 0.f;
    const int f_l = in ? (int)fids[srow + k] : 0;
    const float w_l = in ? warms[srow + k] : 0.f;
    const float c_l = in ? colds[srow + k] : 0.f;
    const float u_l = crash && in ? crash_u[srow + k] : 0.f;
    const int n = min(32, K - base);
    for (int i = 0; i < n; ++i) {
      const float dt = __shfl_sync(FULL, d_l, i);
      const int fa = __shfl_sync(FULL, f_l, i);
      const float warm_s = __shfl_sync(FULL, w_l, i);
      const float cold_s = __shfl_sync(FULL, c_l, i);
      const float t_new = prestamped ? dt : __fadd_rn(t, dt);
      const float lo = fminf(fmaxf(t, sk), tend);
      const float hi = fminf(fmaxf(t_new, sk), tend);

      // 1-2. integrals over (lo, hi] on the pre-expiry pools, then expiry
      float run_v[FP], idle_v[FP];
      unsigned kept = alive, crashed = 0u;
#pragma unroll
      for (int g = 0; g < FP; ++g) {
        run_v[g] = 0.f;
        idle_v[g] = 0.f;
#pragma unroll
        for (int q = 0; q < SF; ++q) {
          const int s = g * SF + q;
          const bool al = (alive >> s) & 1u;
          const float expire = __fadd_rn(busy[s], texp[g]);
          // a crashed instance accrues nothing past its doom
          const float stop = FAULT ? fminf(hi, doom[s]) : hi;
          const float r = fmaxf(__fsub_rn(fminf(busy[s], stop), lo), 0.f);
          const float d = fmaxf(__fsub_rn(fminf(expire, stop), fmaxf(busy[s], lo)), 0.f);
          run_v[g] = __fadd_rn(run_v[g], al ? r : 0.f);
          idle_v[g] = __fadd_rn(idle_v[g], al ? d : 0.f);
          if (FAULT) {
            // the exit clock that fires first: expiry, or a crash
            if (al && fminf(expire, doom[s]) <= t_new) {
              kept &= ~(1u << s);
              if (doom[s] < expire && doom[s] > sk && doom[s] <= tend) crashed |= 1u << s;
            }
          } else if (al && expire <= t_new) {
            kept &= ~(1u << s);
          }
        }
      }
      alive = kept;
      if (crash && __any_sync(FULL, crashed)) count_into_owner<FP, SF>(crashed, lane, a_crash);
      const int src = (lane & (FP - 1)) << SHIFT;  // the lane holding function lane's sums
      const float run_sum = __shfl_sync(FULL, reduce_scatter<FP>(run_v, lane), src);
      const float idle_sum = __shfl_sync(FULL, reduce_scatter<FP>(idle_v, lane), src);
      a_run = __fadd_rn(a_run, run_sum);
      a_idle = __fadd_rn(a_idle, idle_sum);

      const bool counted = t_new > sk;
      const bool in_h = t_new <= tend;
      if (capped) {
        // capacity churn: evict the newest idle instances fleet-wide above
        // the ceiling, one arg-max pass each
        if (!(t_new >= cap_lo && t_new < cap_hi))
          cap_seek(cap_e, cap_v, E, t_new, lane, cap_now, cap_lo, cap_hi);
        const float cl0 = (float)__reduce_add_sync(FULL, (unsigned)__popc(alive));
        const float over = __fsub_rn(cl0, cap_now);
        if (over > 0.f && in_h) {
          float best;
          int best_f;
          newest_idle_fleet<FP, SF>(alive, cre, busy, t_new, M, lane, best, best_f);
          for (int nev = 0; (float)nev < over && best > NEG * 0.5f; ++nev) {
            const int g = best_f / M, m = best_f - g * M;
            if (lane == (m & 31)) alive &= ~(1u << (g * SF + (m >> 5)));
            if (lane == g && counted) a_evict = __fadd_rn(a_evict, 1.f);
            newest_idle_fleet<FP, SF>(alive, cre, busy, t_new, M, lane, best, best_f);
          }
        }
      }
      if (fa < F) {  // warp-uniform; an id past F acts on no function
        const float lim = __shfl_sync(FULL, my_limit, fa);
        const bool mine = lane == fa;
        float best;
        int best_m, first_free, nal;
        int qlen = 0, qhead = 0;
        if (Q > 0) {
          qlen = __shfl_sync(FULL, my_qlen, fa);
          qhead = __shfl_sync(FULL, my_qhead, fa);
        }
        // 3. drain passes ahead of the arrival
        if (Q > 0 && in_h) {
          for (int pass = 0; pass < Q && qlen > 0; ++pass) {
            route<FP, SF>(fa, alive, cre, busy, t_new, M, lane, best, best_m, first_free, nal);
            const int cl = (int)__reduce_add_sync(FULL, (unsigned)__popc(alive));
            const bool any_idle = best > NEG * 0.5f;
            const bool can_cold = !any_idle && (float)nal < lim && first_free >= 0 &&
                                  (float)cl < ncl;
            if (!any_idle && !can_cold) break;  // nothing served: nothing changes
            const int h = fa * Q + qhead;
            const float ht = qt[h], hw = qw[h], hc = qc[h];
            const float service = any_idle ? hw : hc;
            assign<FP, SF>(fa, any_idle ? best_m : first_free, can_cold, t_new,
                           __fadd_rn(t_new, service), lane, alive, cre, busy);
            if (mine && counted) {
              if (can_cold) {
                a_cold = __fadd_rn(a_cold, 1.f);
                a_cresp = __fadd_rn(a_cresp, hc);
              } else {
                a_warm = __fadd_rn(a_warm, 1.f);
                a_wresp = __fadd_rn(a_wresp, hw);
              }
              a_qsrv = __fadd_rn(a_qsrv, 1.f);
              a_qwait = __fadd_rn(a_qwait, __fsub_rn(t_new, ht));
            }
            qhead = qhead + 1 == Q ? 0 : qhead + 1;
            --qlen;
          }
        }
        // 4. the arrival
        route<FP, SF>(fa, alive, cre, busy, t_new, M, lane, best, best_m, first_free, nal);
        const int cl = (int)__reduce_add_sync(FULL, (unsigned)__popc(alive));
        const bool any_idle = best > NEG * 0.5f;
        const bool any_free = first_free >= 0;
        const bool below = (float)nal < lim;
        // with a capacity profile a cold start also needs the fleet's live
        // count below the ceiling
        const bool can_cold = !any_idle && below && any_free && (float)cl < ncl &&
                              (!capped || (float)cl < cap_now);
        const bool is_warm = any_idle && in_h;
        const bool is_cold = can_cold && in_h;
        const bool can_enq = !any_idle && !can_cold && qlen < Q;
        const bool is_enq = can_enq && in_h;
        const bool is_reject = !any_idle && !can_cold && !can_enq && in_h;
        if (is_warm || is_cold) {
          const int m = is_warm ? best_m : first_free;
          const float done = __fadd_rn(t_new, is_warm ? warm_s : cold_s);
          assign<FP, SF>(fa, m, is_cold, t_new, done, lane, alive, cre, busy);
          if (crash) {
            // the lifetime stamped at a cold start; the served attempt is
            // interrupted when its instance dies before the service ends
            float life = INFINITY;
            if (is_cold && crate > 0.f)
              life = __fdiv_rn(-logf(__fsub_rn(1.f, __shfl_sync(FULL, u_l, i))), crate);
            float dc = INFINITY;
#pragma unroll
            for (int g = 0; g < FP; ++g) {
              if (g == fa) {
#pragma unroll
                for (int q = 0; q < SF; ++q) {
                  if (q * 32 + lane == m) {
                    if (is_cold) doom[g * SF + q] = __fadd_rn(t_new, life);
                    dc = doom[g * SF + q];
                  }
                }
              }
            }
            const bool cut = __shfl_sync(FULL, dc, m & 31) < done;
            if (mine && counted && cut) a_int = __fadd_rn(a_int, 1.f);
          }
        }
        if (is_enq) {
          int pos = qhead + qlen;
          if (pos >= Q) pos -= Q;
          if (lane == 0) {
            qt[fa * Q + pos] = t_new;
            qw[fa * Q + pos] = warm_s;
            qc[fa * Q + pos] = cold_s;
          }
          __syncwarp();
          ++qlen;
        }
        if (mine) {
          if (counted) {
            if (is_cold) {
              a_cold = __fadd_rn(a_cold, 1.f);
              a_cresp = __fadd_rn(a_cresp, cold_s);
            }
            if (is_warm) {
              a_warm = __fadd_rn(a_warm, 1.f);
              a_wresp = __fadd_rn(a_wresp, warm_s);
            }
            if (is_reject) a_rej = __fadd_rn(a_rej, 1.f);
            if (in_h) a_arr = __fadd_rn(a_arr, 1.f);
            if (is_enq) a_enq = __fadd_rn(a_enq, 1.f);
          }
          // overflow is counted for arrivals in the horizon, past skip or not
          if (!any_idle && below && !any_free && in_h) a_over = __fadd_rn(a_over, 1.f);
          my_qlen = qlen;
          my_qhead = qhead;
        }
      }
      // 5. the fleet-wide peak, on every event
      peak = fmaxf(peak, (float)__reduce_add_sync(FULL, (unsigned)__popc(alive)));
      t = t_new;
    }
  }

  if (crash) {
#pragma unroll
    for (int g = 0; g < FP; ++g)
#pragma unroll
      for (int q = 0; q < SF; ++q) {
        const int m = q * 32 + lane;
        if (g < F && m < M) doom_out[((size_t)fleet * F + g) * M + m] = doom[g * SF + q];
      }
  }
  if (owner) {
    float* a = acc_out + ((size_t)fleet * F + lane) * COLS;
    a[0] = a_cold;
    a[1] = a_warm;
    a[2] = a_rej;
    a[3] = a_run;
    a[4] = a_idle;
    a[5] = a_cresp;
    a[6] = a_wresp;
    a[7] = a_over;
    a[8] = a_arr;
    a[9] = a_enq;
    a[10] = a_qsrv;
    a[11] = a_qwait;
    a[12] = peak;
    if (FAULT) {
      a[13] = a_crash;
      a[14] = a_evict;
      a[15] = a_int;
    }
    qleft_out[(size_t)fleet * F + lane] = (float)my_qlen;
  }
}

// the launch's sizes
struct Dims {
  int N, F, M, K, Q, E, prestamped;
  long long rows;
};

template <int FP, int SF, bool FAULT>
void launch(const void* const* in, void* const* out, const Dims& d, cudaStream_t stream) {
  const dim3 blocks((d.N + WARPS - 1) / WARPS), threads(WARPS * 32);
  const size_t smem = (size_t)WARPS * 3 * FP * d.Q * sizeof(float);
  fleet_sweep_kernel<FP, SF, FAULT><<<blocks, threads, smem, stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[4], (const long long*)in[5], (const float*)in[6],
      (const uint8_t*)in[7], (const float*)in[8], (const float*)in[9],
      (const float*)in[10], (const float*)in[11], (const float*)in[12],
      (const float*)in[13], (float*)out[0], (float*)out[1], (float*)out[2], d.N, d.F, d.M,
      d.K, d.Q, d.E, d.prestamped, d.rows);
}

// the narrowest instance holding sf slots per function per lane; past 32
// slots per lane (FP * SF > 32) there is none
template <int FP, int SF = 1>
int launch_fp(const void* const* in, void* const* out, const Dims& d, bool faults,
              cudaStream_t st) {
  if constexpr (FP * SF > 32) {
    return (int)cudaErrorInvalidValue;
  } else {
    if ((d.M + 31) / 32 <= SF) {
      if (faults) launch<FP, SF, true>(in, out, d, st);
      else launch<FP, SF, false>(in, out, d, st);
      return 0;
    }
    return launch_fp<FP, SF * 2>(in, out, d, faults, st);
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  Inputs: t_exp, limit [N, F]; ncl,
// t_end, skip [N] f32; stream [N] int64 (the stream row of each fleet;
// a fleet whose row lies outside [0, S) gets NaN outputs); times, warms,
// colds [S, K] f32 and fids [S, K] uint8; faults (each null when off, and
// not with Q > 0): crash_rate [N] and crash_u [S, K] (crashes), cap_edges
// [N, E] (strictly increasing, > 0; null when E = 0) and cap_values [N,
// E+1] (capacity) — all contiguous, on `device`.  Outputs: acc [N, F, 13,
// or 16 with faults], qleft [N, F] f32, and doom [N, F, M] with crashes
// (else null).  Caps: F <= 8, F rounded up to a power of two times M
// rounded up to a power-of-two multiple of 32 at most 1024 slots, Q <=
// 128.  Launches on `stream_ptr` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an input past a cap).
extern "C" int fleet_sweep_f32(const void* t_exp, const void* limit, const void* ncl,
                               const void* t_end, const void* skip, const void* stream,
                               const void* times, const void* fids, const void* warms,
                               const void* colds, const void* crash_rate,
                               const void* crash_u, const void* cap_edges,
                               const void* cap_values, void* acc, void* qleft, void* doom,
                               int N, int F, int M, int S, int K, int Q, int E,
                               int prestamped, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool crash = crash_u != nullptr, capped = cap_values != nullptr;
  if (N < 1 || F < 1 || F > MAX_FUNCTIONS || M < 1 || S < 1 || K < 0 || Q < 0 ||
      Q > MAX_QUEUE || ((crash || capped) && Q > 0) ||
      (crash && (crash_rate == nullptr || doom == nullptr)) ||
      (capped && (E < 0 || (E > 0 && cap_edges == nullptr))))
    return (int)cudaErrorInvalidValue;
  const void* in[14] = {t_exp, limit, ncl,     t_end,   skip,      stream,    times,
                        fids,  warms, colds, crash_rate, crash_u, cap_edges, cap_values};
  void* out[3] = {acc, qleft, doom};
  const Dims d{N, F, M, K, Q, capped ? E : 0, prestamped, S};
  const bool faults = crash || capped;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int rc;
  if (F <= 1) rc = launch_fp<1>(in, out, d, faults, st);
  else if (F <= 2) rc = launch_fp<2>(in, out, d, faults, st);
  else if (F <= 4) rc = launch_fp<4>(in, out, d, faults, st);
  else rc = launch_fp<8>(in, out, d, faults, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
