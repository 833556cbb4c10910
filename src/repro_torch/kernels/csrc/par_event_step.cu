// Hopper (sm_90a) kernel of the concurrency-value platform (the par engine).
//
// Replaces the TPU kernel repro/kernels/faas_event_step.py::_par_kernel
// (launched by par_sweep_pallas).  Each row (one replica) runs K arrivals
// from an empty pool of M instance slots, each instance serving up to c
// requests at once: finish[M, c] holds each request sub-slot's finish time
// and an instance is busy until busy = max_j finish.  Per arrival: exact
// integrals of running and idle instance-time over the interval clipped to
// [skip, t_end], and of in-flight requests over every sub-slot of a live
// instance; expiry of instances idle past t_exp (busy + t_exp <= t_new,
// expire-first on a tie); then the newest live instance with
// #(finish > t_new) < c serves (warm, lowest slot on a creation tie), else
// a free slot below max_concurrency instances (cold), else the arrival is
// rejected.  The request takes the chosen instance's first sub-slot with
// finish <= t_new, read before a cold start wipes the (possibly stale) row
// to NEG, and writes t_new + service there.
//
// What bounds it on this card: operations, in a sequential chain per row.
// Read per event, the reference touches every sub-slot of every live
// instance (~7 f32 operations each) on top of the base engine's work per
// slot, against 12 bytes of samples per event.  The first design let one
// lane walk an instance's c sub-slots in a loop of dependent shared-memory
// reads and recomputed busy from them on every event: at c = 80, where one
// instance serves nearly everything, one lane walked 80 entries while 31
// waited (128x its bound), and 20 KB of finish planes a row held an SM to
// 8 rows.
//
// What the design does about that: one warp per row, and sub-slot work
// only on the instance an event changes.
//   - Slot j belongs to lane j % 32 (S = ceil(M/32) slots a lane): its
//     creation, busy (the row's max finish) and free-by (the row's min
//     finish) in registers, alive as a bitmask.  busy and free-by change
//     only when a request is assigned (or a cold start wipes the row), so
//     they are set there from the row, and an event's routing needs no
//     sub-slot: #(finish > t_new) < c iff free-by <= t_new, exactly.
//   - finish lives in shared memory instance-major (slot j's c finishes at
//     [j*c, (j+1)*c)).  An assignment updates one row: for c <= 3 the
//     slot's lane walks it alone in one pass (a few reads beat a ballot and
//     two reduxes: 1.16x, 1.08x and 1.02x the spread pass at c = 1, 2 and
//     3 on an H100, 0.95x at c = 4); for larger c lane i takes
//     sub-slots i, i+32, ... (consecutive words, no bank conflicts, and no
//     lane reads another's writes), a ballot finds the first free sub-slot
//     and two reduxes the row's new min and max.  Output goes back to the
//     reference's [R, c, M] layout at the end.
//   - The three integrals are accrued, not summed per event
//     (event_step_common.cuh accrue): a slot's running and idle time is
//     added when its state starts (a cold or warm start) and given back
//     past the clock when it ends (the next start, expiry, the last event),
//     and a request's in-flight time up to min(finish, t_end) is added when
//     it is assigned and given back past the clock if its instance dies or
//     the run ends first (a pass over that row).  A request is only
//     replaced once finished, so replacing needs no give-back.  Where the
//     clipped clock goes back from hi_prev to hi (unsorted prestamped
//     times, negative gaps), the reference counts (hi, hi_prev] again on
//     the next intervals: one pass over the live slots and their rows adds
//     what each accrues over it.
//   - Expiry is found without a per-event vote: the row keeps a lower bound
//     of its earliest expiry (lowered by each warm start, reset by a cold
//     one, exact after each exit pass) and tests its slots only once the
//     clock reaches it.  An event past the horizon changes nothing but the
//     clock; the free slots are read only when no instance has capacity.
//     A warm event then costs the samples' broadcast, the newest candidate
//     (an order key a slot, two reduxes) and the one row's update.
//   - The host picks 1, 2 or 4 rows a block for the most rows an SM holds
//     at M*c*4 bytes of shared memory a row (at c = 80, M = 64: 10 rows an
//     SM, where 4-row blocks held 8); shared memory is what bounds
//     residency at large c, since the final planes keep every sub-slot.
//     The cap is one row per block, M*c <= MAX_FINISH floats.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py
// faas_par_sweep_ref): every clock update is one rounded f32 operation
// (built with --fmad=false, written with __fadd_rn), the sentinels are the
// reference's (NEG = -1e30, any_cap = best > NEG/2), busy and free-by are a
// max and a min (exact), and the counters are per-row sequential sums in
// event order.  The integrals (acc columns 3, 4 and 8) add the same
// pieces in another association (per state span rather than per event),
// so they may differ from the plain version in the last places.  No
// sample needs a sign: a negative service only makes a request finish
// before it starts, and busy and free-by are read from the row.

#include <climits>
#include <cuda_runtime.h>

#include "event_step_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_WARPS = 4;  // rows per block, fewer when finish is large
constexpr int ACC_COLS = 9;
// the most shared memory one block may use on sm_90 (227 KB)
constexpr int MAX_SMEM = 232448;
constexpr int MAX_FINISH = MAX_SMEM / 4;  // M*c floats of one row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

// the lane's part of what one row's requests accrue in flight from clock
// `from` on, less what they accrue from `to` on: its sub-slots' ahead(from)
// - ahead(to), ahead(x) = max(min(finish, te) - x, 0) (ahead(te) = 0)
__device__ __forceinline__ float in_flight_span(const float* rf, int c, float from, float to,
                                                float te, int lane) {
  float v = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float f = fminf(rf[i], te);
    v = __fadd_rn(v, __fsub_rn(fmaxf(__fsub_rn(f, from), 0.f), fmaxf(__fsub_rn(f, to), 0.f)));
  }
  return v;
}

// Every live slot's accrual moved from clock `to` to clock `from` (<= te):
// the lane's shares gain accrue(from) - accrue(to) of its slots and the
// in-flight span of every live row.  At the end of the run (from = te,
// where nothing is left to accrue) it gives back what the live instances
// and their requests accrued past the last clock; after the clock went back
// (from < to) it counts (from, to] again, as the reference's next intervals
// do.  Warp-uniform.
template <int S>
__device__ __forceinline__ void settle(unsigned alive, const float (&busy)[S], float texp,
                                       const float* fin, int c, float from, float to, float te,
                                       int lane, float& a_run, float& a_idle, float& a_flight) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if ((alive >> s) & 1u) {
      const float ex = __fadd_rn(busy[s], texp);
      const float2 a = accrue(busy[s], ex, INFINITY, from, te);
      const float2 b = accrue(busy[s], ex, INFINITY, to, te);
      a_run = __fadd_rn(a_run, __fsub_rn(a.x, b.x));
      a_idle = __fadd_rn(a_idle, __fsub_rn(a.y, b.y));
    }
    unsigned lanes = __ballot_sync(FULL, (alive >> s) & 1u);
    while (lanes) {
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      a_flight = __fadd_rn(
          a_flight, in_flight_span(fin + (size_t)(s * 32 + src) * c, c, from, to, te, lane));
    }
  }
}

// A request on the chosen instance's row `rf` (c sub-slots) at t_new,
// finishing at `done`: its first sub-slot with finish <= t_new, read before
// a cold start wipes the row to NEG (sub, -1 if none, and then nothing is
// written), and the row's min and max after the write.
struct RowUpdate {
  int sub;
  float lo, hi;
};

// up to SERIAL_C sub-slots: the owner lane walks the row alone, in one
// pass (a few shared-memory reads beat a ballot and two reduxes; the
// largest c at which it does on an H100)
constexpr int SERIAL_C = 3;

__device__ __forceinline__ RowUpdate row_serial(float* rf, int c, bool cold, float t_new,
                                                float done) {
  RowUpdate u{-1, INFINITY, -INFINITY};
  for (int i = 0; i < c; ++i) {
    const float f = rf[i];
    const bool take = u.sub < 0 && f <= t_new;
    if (take) u.sub = i;
    const float w = take ? done : (cold ? NEG : f);
    if (take || cold) rf[i] = w;
    u.lo = fminf(u.lo, w);
    u.hi = fmaxf(u.hi, w);
  }
  return u;
}

// more sub-slots: lane i takes sub-slots i, i + 32, ...; a ballot finds the
// first free one, two reduxes the extremes (in every lane)
__device__ __forceinline__ RowUpdate row_spread(float* rf, int c, bool cold, float t_new,
                                                float done, int lane) {
  int sub = -1;
  for (int b = 0; b < c && sub < 0; b += 32) {
    const int i = b + lane;
    const unsigned h = __ballot_sync(FULL, i < c && rf[i] <= t_new);
    if (h) sub = b + __ffs(h) - 1;
  }
  unsigned kmin = UINT_MAX, kmax = 0u;
  for (int i = lane; i < c; i += 32) {
    const float w = i == sub ? done : (cold ? NEG : rf[i]);
    if (cold || i == sub) rf[i] = w;
    const unsigned k = order_key(w);
    kmin = min(kmin, k);
    kmax = max(kmax, k);
  }
  return {sub, key_value(__reduce_min_sync(FULL, kmin)),
          key_value(__reduce_max_sync(FULL, kmax))};
}

// Fig. 1's 4,096 rows of 64 slots fit the 132 SMs in one wave at 8 blocks
// of 4 rows a SM (<= 64 registers a thread); wider pools keep ptxas' choice
template <int S>  // slots per lane: M <= 32 * S
__global__ void __launch_bounds__(MAX_WARPS * 32, S <= 2 ? 8 : 1)
par_sweep_kernel(const float* __restrict__ t_exp, const float* __restrict__ t_end,
                 const float* __restrict__ skip, const float* __restrict__ dts,
                 const float* __restrict__ warms, const float* __restrict__ colds,
                 float* __restrict__ alive_out, float* __restrict__ creation_out,
                 float* __restrict__ finish_out, float* __restrict__ t_out,
                 float* __restrict__ acc_out, int R, int M, int c, int K,
                 float max_c, int prestamped) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= R) return;  // the ragged last block: the whole warp leaves
  float* fin = smem + (size_t)warp * M * c;  // this row's finish, instance-major
  for (int i = lane; i < M * c; i += 32) fin[i] = NEG;
  __syncwarp();

  // slot j = s * 32 + lane; slots past M do not exist (never alive, never free)
  unsigned alive = 0u;  // bit s: slot s * 32 + lane is live
  float cre[S], busy[S], free_by[S];
  unsigned ckey[S];  // order_key(cre)
#pragma unroll
  for (int s = 0; s < S; ++s) {
    cre[s] = NEG;
    busy[s] = NEG;
    free_by[s] = NEG;
    ckey[s] = 0u;
  }
  float t = 0.f;
  const float texp = t_exp[row], tend = t_end[row], sk = skip[row];
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f, a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f;
  float a_run = 0.f, a_idle = 0.f, a_flight = 0.f;  // this lane's share
  int n_alive = 0;
  // a lower bound of the earliest expiry: the exit pass runs once the clock
  // reaches it
  float next_exit = INFINITY;
  float hi_prev = fminf(fmaxf(t, sk), tend);  // the previous clock, clipped

  const size_t srow = (size_t)row * K;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    const float d_l = k < K ? dts[srow + k] : 0.f;
    const float w_l = k < K ? warms[srow + k] : 0.f;
    const float c_l = k < K ? colds[srow + k] : 0.f;
    const int n = min(32, K - base);
    for (int e = 0; e < n; ++e) {
      const float dt = __shfl_sync(FULL, d_l, e);
      const float warm_s = __shfl_sync(FULL, w_l, e);
      const float cold_s = __shfl_sync(FULL, c_l, e);
      const float t_new = prestamped ? dt : __fadd_rn(t, dt);
      const float hi = fminf(fmaxf(t_new, sk), tend);
      // the clock went back: (hi, hi_prev] is counted again (rare)
      if (hi < hi_prev)
        settle(alive, busy, texp, fin, c, hi, hi_prev, tend, lane, a_run, a_idle, a_flight);
      hi_prev = hi;

      // expiry: a dying instance gives back what it accrued past hi, and
      // its requests what they accrued in flight past hi
      if (t_new >= next_exit) {
        unsigned gone = 0u;
        float nx = INFINITY;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float ex = __fadd_rn(busy[s], texp);
          if ((alive >> s) & 1u) {
            if (ex <= t_new) gone |= 1u << s;
            else nx = fminf(nx, ex);
          }
        }
        if (__any_sync(FULL, gone)) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if ((gone >> s) & 1u) {
              const float2 a = accrue(busy[s], __fadd_rn(busy[s], texp), INFINITY, hi, tend);
              a_run = __fsub_rn(a_run, a.x);
              a_idle = __fsub_rn(a_idle, a.y);
            }
            unsigned lanes = __ballot_sync(FULL, (gone >> s) & 1u);
            n_alive -= __popc(lanes);
            while (lanes) {
              const int src = __ffs(lanes) - 1;
              lanes &= lanes - 1;
              a_flight = __fadd_rn(a_flight, in_flight_span(fin + (size_t)(s * 32 + src) * c,
                                                            c, tend, hi, tend, lane));
            }
          }
          alive &= ~gone;
        }
        next_exit = key_value(__reduce_min_sync(FULL, order_key(nx)));
      }

      // an arrival past the horizon changes nothing but the clock
      if (t_new <= tend) {
        const bool counted = t_new > sk;
        // the newest live instance with a free sub-slot (a lane's slots
        // ascend with s, so '>' keeps the lowest on a tie); the slots are
        // read only when none has one
        unsigned key = 0u, idx = UINT_MAX;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const unsigned ks = ((alive >> s) & 1u) && free_by[s] <= t_new ? ckey[s] : 0u;
          if (ks > key) {
            key = ks;
            idx = s * 32 + lane;
          }
        }
        const unsigned best = __reduce_max_sync(FULL, key);
        const bool is_warm = best != 0u && key_value(best) > NEG * 0.5f;
        int chosen = -1;
        if (is_warm) {
          chosen = (int)__reduce_min_sync(FULL, key == best ? idx : UINT_MAX);
        } else {
          int first_free = -1;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const unsigned fm = __ballot_sync(FULL, s * 32 + lane < M && !((alive >> s) & 1u));
            if (first_free < 0 && fm) first_free = s * 32 + __ffs(fm) - 1;
          }
          const bool below = (float)n_alive < max_c;
          if (below && first_free >= 0) {
            chosen = first_free;
          } else {
            // overflow is counted for active arrivals whether or not past skip
            if (below) a_over = __fadd_rn(a_over, 1.f);
            if (counted) a_rej = __fadd_rn(a_rej, 1.f);
          }
        }
        if (chosen >= 0) {
          const bool is_cold = !is_warm;
          const float done = __fadd_rn(t_new, is_warm ? warm_s : cold_s);
          float* rf = fin + (size_t)chosen * c;
          const int owner = chosen & 31, os = chosen >> 5;
          RowUpdate u{-1, 0.f, 0.f};
          if (c > SERIAL_C) u = row_spread(rf, c, is_cold, t_new, done, lane);
          else if (lane == owner) u = row_serial(rf, c, is_cold, t_new, done);
          if (lane == owner) {
            // slot os of this lane, read and written back by selects (an
            // index would put the slots in local memory)
            float b = busy[0];
#pragma unroll
            for (int s = 1; s < S; ++s) b = s == os ? busy[s] : b;
            // a new busy ends the old state at hi and starts the new one
            if (is_cold || u.hi != b) {
              if (is_warm) {
                const float2 a = accrue(b, __fadd_rn(b, texp), INFINITY, hi, tend);
                a_run = __fsub_rn(a_run, a.x);
                a_idle = __fsub_rn(a_idle, a.y);
              }
              const float2 a = accrue(u.hi, __fadd_rn(u.hi, texp), INFINITY, hi, tend);
              a_run = __fadd_rn(a_run, a.x);
              a_idle = __fadd_rn(a_idle, a.y);
            }
#pragma unroll
            for (int s = 0; s < S; ++s) {
              busy[s] = s == os ? u.hi : busy[s];
              free_by[s] = s == os ? u.lo : free_by[s];
              cre[s] = s == os && is_cold ? t_new : cre[s];
              ckey[s] = s == os && is_cold ? order_key(t_new) : ckey[s];
            }
            if (is_cold) alive |= 1u << os;
            if (u.sub >= 0)  // the request's time in flight, to its finish
              a_flight = __fadd_rn(a_flight, fmaxf(__fsub_rn(fminf(done, tend), hi), 0.f));
          }
          if (is_cold) {
            ++n_alive;
            next_exit = -INFINITY;  // its expiry is read at the next event
          } else {
            // busy, the row's max, is at least done
            next_exit = fminf(next_exit, __fadd_rn(done, texp));
          }
          if (counted) {
            if (is_cold) {
              a_cold = __fadd_rn(a_cold, 1.f);
              a_cresp = __fadd_rn(a_cresp, cold_s);
            } else {
              a_warm = __fadd_rn(a_warm, 1.f);
              a_wresp = __fadd_rn(a_wresp, warm_s);
            }
          }
        }
      }
      t = t_new;
    }
  }

  // the live instances and their requests give back what they accrued past
  // the last clock
  settle(alive, busy, texp, fin, c, tend, fminf(fmaxf(t, sk), tend), tend, lane, a_run, a_idle,
         a_flight);
  a_run = warp_sum(a_run);
  a_idle = warp_sum(a_idle);
  a_flight = warp_sum(a_flight);
  __syncwarp();

  const size_t pool = (size_t)row * M;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      alive_out[pool + j] = (alive >> s) & 1u ? 1.f : 0.f;
      creation_out[pool + j] = cre[s];
    }
  }
  for (int i = 0; i < c; ++i)  // back to [c, M] planes
    for (int j = lane; j < M; j += 32)
      finish_out[pool * c + (size_t)i * M + j] = fin[(size_t)j * c + i];
  if (lane == 0) {
    t_out[row] = t;
    float* a = acc_out + (size_t)row * ACC_COLS;
    a[0] = a_cold;
    a[1] = a_warm;
    a[2] = a_rej;
    a[3] = a_run;
    a[4] = a_idle;
    a[5] = a_cresp;
    a[6] = a_wresp;
    a[7] = a_over;
    a[8] = a_flight;
  }
}

template <int S>
int launch(const float* const* in, float* const* out, int R, int M, int c, int K,
           float max_c, int prestamped, int device, cudaStream_t stream) {
  // rows a block: the most rows an SM holds in its shared memory (each
  // block also reserves some), the wider block on a tie
  const size_t row_bytes = (size_t)M * c * sizeof(float);
  int sm_smem = 0, reserved = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return (int)err;
  int warps = 1, held = 0;
  for (int w = MAX_WARPS; w >= 1; w /= 2) {
    if (w * row_bytes > (size_t)MAX_SMEM) continue;
    int blocks = (int)(sm_smem / (w * row_bytes + reserved));
    blocks = min(blocks, min(32, 64 / w));  // blocks and warps an SM may hold
    if (blocks * w > held) {
      held = blocks * w;
      warps = w;
    }
  }
  const size_t smem = warps * row_bytes;
  err = cudaFuncSetAttribute(par_sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((R + warps - 1) / warps), threads(warps * 32);
  par_sweep_kernel<S><<<blocks, threads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], out[3],
      out[4], R, M, c, K, max_c, prestamped);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes.  Inputs: t_exp, t_end, skip [R]; dts,
// warms, colds [R, K] — all f32, contiguous, on `device`.  Outputs: alive,
// creation [R, M], finish [R, c, M], t [R], acc [R, 9].  The pool starts
// empty.  Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int par_sweep_f32(const void* t_exp, const void* t_end,
                             const void* skip, const void* dts,
                             const void* warms, const void* colds,
                             void* alive_out, void* creation_out,
                             void* finish_out, void* t_out, void* acc_out,
                             int R, int M, int c, int K, int max_concurrency,
                             int prestamped, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || M < 1 || M > 1024 || c < 1 || (long long)M * c > MAX_FINISH ||
      K < 0)
    return (int)cudaErrorInvalidValue;
  const float* in[6] = {(const float*)t_exp, (const float*)t_end,
                        (const float*)skip,  (const float*)dts,
                        (const float*)warms, (const float*)colds};
  float* out[5] = {(float*)alive_out, (float*)creation_out, (float*)finish_out,
                   (float*)t_out, (float*)acc_out};
  const float max_c = (float)max_concurrency;
  cudaStream_t st = (cudaStream_t)stream;
  const int s = (M + 31) / 32;
  if (s <= 1) return launch<1>(in, out, R, M, c, K, max_c, prestamped, device, st);
  if (s <= 2) return launch<2>(in, out, R, M, c, K, max_c, prestamped, device, st);
  if (s <= 4) return launch<4>(in, out, R, M, c, K, max_c, prestamped, device, st);
  if (s <= 8) return launch<8>(in, out, R, M, c, K, max_c, prestamped, device, st);
  if (s <= 16) return launch<16>(in, out, R, M, c, K, max_c, prestamped, device, st);
  return launch<32>(in, out, R, M, c, K, max_c, prestamped, device, st);
}
