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
// What bounds it on this card: every event reads every sub-slot of every
// live instance (~6 f32 operations each: max, clip of the overlap, add,
// compare) on top of the ~25 per slot of the base engine, while the
// samples are 12 bytes per event.  It is bound by operations, and each row
// is a sequential chain of events.
//
// What the design does about that: one warp per row.  Slot j belongs to
// lane j % 32 (S = ceil(M/32) slots per lane, alive and creation in
// registers, as in faas_event_step.cu).  finish does not fit in registers
// for large c (20 KB per row at M = 64, c = 80), so each warp keeps its
// row's finish[M, c] in shared memory as c planes of M floats (plane i at
// [i*M, (i+1)*M)): a lane reads and writes only its own slots' entries, so
// lanes at one sub-slot index touch consecutive words (no bank conflicts)
// and no lane ever waits for another's writes.  A lane walks the c
// sub-slots only for its live slots; dead slots add nothing to any
// integral and cannot take a request.  The host picks up to 4 warps per
// block so that the block's shared memory fits (M*c*4 bytes per warp); the
// cap is one row per block, M*c <= MAX_FINISH floats.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py
// faas_par_sweep_ref): every clock update is one rounded f32 operation
// (built with --fmad=false, written with __fadd_rn), the sentinels are the
// reference's (NEG = -1e30, any_cap = best > NEG/2), and the counters are
// per-row sequential sums in event order.  The M-sums of the run/idle
// integrals (acc columns 3, 4) and the M*c-sum of the in-flight integral
// (column 8) associate differently from torch, so they may differ from
// the plain version in the last places.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
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

template <int S>  // slots per lane: M <= 32 * S
__global__ void __launch_bounds__(MAX_WARPS * 32)
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
  float* fin = smem + (size_t)warp * M * c;  // this row's finish planes

  // slot j = s * 32 + lane; slots past M do not exist (never alive, never free)
  float alive[S], cre[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    alive[s] = 0.f;
    cre[s] = NEG;
    if (j < M)
      for (int i = 0; i < c; ++i) fin[i * M + j] = NEG;
  }
  float t = 0.f;
  const float texp = t_exp[row], tend = t_end[row], sk = skip[row];
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f, a_run = 0.f, a_idle = 0.f;
  float a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f, a_flight = 0.f;

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
      const float lo = fminf(fmaxf(t, sk), tend);
      const float hi = fminf(fmaxf(t_new, sk), tend);

      // one pass over each live slot's sub-slots: busy, the in-flight
      // integral and the in-flight count (pre-wipe finishes); then the
      // instance integrals and expiry; then the routing candidates on the
      // post-expiry pool
      float run_l = 0.f, idle_l = 0.f, flight_l = 0.f, alive_l = 0.f;
      float best = NEG;
      int best_j = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = s * 32 + lane;
        int in_flight = 0;
        if (alive[s] > 0.f) {
          float busy = NEG;
          for (int i = 0; i < c; ++i) {
            const float f = fin[i * M + j];
            busy = fmaxf(busy, f);
            flight_l = __fadd_rn(flight_l, fmaxf(__fsub_rn(fminf(f, hi), lo), 0.f));
            in_flight += f > t_new;
          }
          const float expire = __fadd_rn(busy, texp);
          run_l = __fadd_rn(run_l, fmaxf(__fsub_rn(fminf(busy, hi), lo), 0.f));
          idle_l = __fadd_rn(
              idle_l, fmaxf(__fsub_rn(fminf(expire, hi), fmaxf(busy, lo)), 0.f));
          if (expire <= t_new) alive[s] = 0.f;
        }
        alive_l = __fadd_rn(alive_l, alive[s]);
        // this lane's slots ascend with s, so '>' keeps the lowest slot on a tie
        if (alive[s] > 0.f && in_flight < c && cre[s] > best) {
          best = cre[s];
          best_j = j;
        }
      }
      const float run_sum = warp_sum(run_l);
      const float idle_sum = warp_sum(idle_l);
      const float flight_sum = warp_sum(flight_l);
      const float n_alive = warp_sum(alive_l);
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, m);
        const int oj = __shfl_xor_sync(FULL, best_j, m);
        if (ob > best || (ob == best && oj < best_j)) {
          best = ob;
          best_j = oj;
        }
      }
      int first_free = -1;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const unsigned fm = __ballot_sync(FULL, s * 32 + lane < M && alive[s] <= 0.f);
        if (first_free < 0 && fm) first_free = s * 32 + __ffs(fm) - 1;
      }

      const bool any_cap = best > NEG * 0.5f;
      const bool any_free = first_free >= 0;
      const bool active = t_new <= tend;
      const bool counted = t_new > sk;
      const bool below = n_alive < max_c;
      const bool can_cold = !any_cap && below && any_free;
      const bool is_warm = any_cap && active;
      const bool is_cold = can_cold && active;
      const bool is_reject = !any_cap && !can_cold && active;
      if (is_warm || is_cold) {
        const int chosen = is_warm ? best_j : first_free;
        if (lane == (chosen & 31)) {
          // the first free sub-slot, read before a cold start's wipe
          int sub = -1;
          for (int i = 0; i < c; ++i) {
            if (fin[i * M + chosen] <= t_new) {
              sub = i;
              break;
            }
          }
          if (is_cold)
            for (int i = 0; i < c; ++i) fin[i * M + chosen] = NEG;
          if (sub >= 0)
            fin[sub * M + chosen] = __fadd_rn(t_new, is_warm ? warm_s : cold_s);
        }
        if (is_cold) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (s * 32 + lane == chosen) {
              cre[s] = t_new;
              alive[s] = 1.f;
            }
          }
        }
      }
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
      }
      a_run = __fadd_rn(a_run, run_sum);
      a_idle = __fadd_rn(a_idle, idle_sum);
      a_flight = __fadd_rn(a_flight, flight_sum);
      // overflow is counted for active arrivals whether or not past skip
      if (!any_cap && below && !any_free && active) a_over = __fadd_rn(a_over, 1.f);
      t = t_new;
    }
  }

  const size_t pool = (size_t)row * M;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      alive_out[pool + j] = alive[s];
      creation_out[pool + j] = cre[s];
      for (int i = 0; i < c; ++i) finish_out[pool * c + (size_t)i * M + j] = fin[i * M + j];
    }
  }
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
int launch(const float* const* in, float* const* out, int R, int M, int c,
           int K, float max_c, int prestamped, cudaStream_t stream) {
  const size_t row_bytes = (size_t)M * c * sizeof(float);
  const int warps = (int)(MAX_SMEM / row_bytes < MAX_WARPS ? MAX_SMEM / row_bytes
                                                           : MAX_WARPS);
  const size_t smem = warps * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      par_sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  if (s <= 1) return launch<1>(in, out, R, M, c, K, max_c, prestamped, st);
  if (s <= 2) return launch<2>(in, out, R, M, c, K, max_c, prestamped, st);
  if (s <= 4) return launch<4>(in, out, R, M, c, K, max_c, prestamped, st);
  if (s <= 8) return launch<8>(in, out, R, M, c, K, max_c, prestamped, st);
  if (s <= 16) return launch<16>(in, out, R, M, c, K, max_c, prestamped, st);
  return launch<32>(in, out, R, M, c, K, max_c, prestamped, st);
}
