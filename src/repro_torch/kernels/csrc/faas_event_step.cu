// Hopper (sm_90a) kernel of the f32 steady-state block engine.
//
// Replaces the TPU kernel repro/kernels/faas_event_step.py::_faas_kernel
// (launched by faas_sweep_pallas) for its base staged path, the
// prestamped mode and the transient grid-curve columns.  Each row (one
// replica of one what-if cell) runs K arrivals against its own pool of M
// instance slots (alive, creation, busy).  Per arrival: exact integrals
// of running and idle instance-time over the interval clipped to
// [skip, t_end]; expiry of idle instances past t_exp (expire-first on a
// tie); then the newest idle instance serves (warm, lowest slot on a
// creation tie), else a free slot below max_concurrency (cold), else the
// arrival is rejected.
//
// Grid curves (G > 0, the temporal engine): each grid point g of the row
// that falls in an arrival's interval (t, min(t_new, t_end)] records the
// running (busy > g), idle (busy <= g) and no-idle counts of the
// pre-expiry pool's live instances (busy + t_exp > g) in acc columns
// [8, 8+G), [8+G, 8+2G), [8+2G, 8+3G).  The warp keeps the smallest grid
// time past the clock (next_g), so an event that holds no grid point costs
// one warp-uniform compare.  G is a runtime argument (cap MAX_GRID); the
// grid code is a template instance of its own (GRID), so the scan path's
// instances (G = 0) compile to the same loop as without it.
//
// What bounds it on this card: every event touches every slot of the row
// (~25 f32 operations per slot in the body below) while the samples are
// 12 bytes per event, so at M = 64 it does ~135 operations per byte —
// far above the H100's f32 balance point (67 TFLOP/s over 3.35 TB/s, ~20
// operations per byte).  It is bound by operations, and each row is a
// sequential chain of events, so the latency of each event's reductions
// matters as much as their count.
//
// What the design does about that: one warp per row, with the pool in
// registers (ceil(M/32) slots per lane), so no pool state ever leaves the
// SM.  Samples are loaded 32 events at a time, one per lane (coalesced),
// and broadcast per event with __shfl_sync.  The per-event reductions over
// the pool are warp shuffles (sums and the argmax by xor butterflies) and
// ballots (the lowest free slot); the butterflies leave the same bits in
// every lane, so the row's clock and accumulators are replicated per lane
// and no lane ever waits on shared memory.  Many rows per SM (4 per block,
// thousands per grid) hide each chain's latency.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py): every
// clock update is one rounded f32 operation (built with --fmad=false, and
// written with __fadd_rn), the sentinels are the reference's (NEG = -1e30
// for dead slots, any_idle = best > NEG/2), and the acc columns are
// per-row sequential sums in the same order.  Only the two M-reductions of
// the integrals (acc columns 3 and 4) sum in a different order, so they
// may differ from the plain version in the last places.  The grid columns
// are integer counts (ballot popcounts) added in event order: exact.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // rows per block
constexpr int ACC_COLS = 8;
constexpr int MAX_GRID = 1024;  // grid points per row (3 acc columns each)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

// the smallest grid time past the clock t (+inf if none), in every lane
__device__ __forceinline__ float next_grid(const float* grow, int G, float t,
                                           int lane) {
  float m = INFINITY;
  for (int gi = lane; gi < G; gi += 32) {
    const float g = grow[gi];
    if (g > t) m = fminf(m, g);
  }
  return warp_min(m);
}

// S: slots per lane (M <= 32 * S); GRID: accumulate the grid columns (G > 0)
template <int S, bool GRID>
__global__ void __launch_bounds__(WARPS * 32)
faas_sweep_kernel(const float* __restrict__ alive_in,
                  const float* __restrict__ creation_in,
                  const float* __restrict__ busy_in,
                  const float* __restrict__ t0, const float* __restrict__ t_exp,
                  const float* __restrict__ t_end, const float* __restrict__ skip,
                  const float* __restrict__ dts, const float* __restrict__ warms,
                  const float* __restrict__ colds,
                  const float* __restrict__ grid, float* __restrict__ alive_out,
                  float* __restrict__ creation_out, float* __restrict__ busy_out,
                  float* __restrict__ t_out, float* __restrict__ acc_out, int R,
                  int M, int K, int G, float max_c, int prestamped) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // the ragged last block: the whole warp leaves

  // slot j = s * 32 + lane; slots past M do not exist (never alive, never free)
  const size_t pool = (size_t)row * M;
  float alive[S], cre[S], busy[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    const bool ex = j < M;
    alive[s] = ex ? alive_in[pool + j] : 0.f;
    cre[s] = ex ? creation_in[pool + j] : NEG;
    busy[s] = ex ? busy_in[pool + j] : NEG;
  }
  float t = t0[row];
  const float texp = t_exp[row], tend = t_end[row], sk = skip[row];
  float a_cold = 0.f, a_warm = 0.f, a_rej = 0.f, a_run = 0.f, a_idle = 0.f;
  float a_cresp = 0.f, a_wresp = 0.f, a_over = 0.f;
  float* arow = acc_out + (size_t)row * (ACC_COLS + 3 * G);
  const float* grow = grid + (size_t)row * G;
  float next_g = INFINITY;
  if (GRID) {
    // grid columns start at zero; lane 0 adds each hit into them
    for (int c = lane; c < 3 * G; c += 32) arow[ACC_COLS + c] = 0.f;
    __syncwarp();
    next_g = next_grid(grow, G, t, lane);
  }

  const size_t srow = (size_t)row * K;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    const float d_l = k < K ? dts[srow + k] : 0.f;
    const float w_l = k < K ? warms[srow + k] : 0.f;
    const float c_l = k < K ? colds[srow + k] : 0.f;
    const int n = min(32, K - base);
    for (int i = 0; i < n; ++i) {
      const float dt = __shfl_sync(FULL, d_l, i);
      const float warm_s = __shfl_sync(FULL, w_l, i);
      const float cold_s = __shfl_sync(FULL, c_l, i);
      const float t_new = prestamped ? dt : __fadd_rn(t, dt);
      const float lo = fminf(fmaxf(t, sk), tend);
      const float hi = fminf(fmaxf(t_new, sk), tend);

      if (GRID) {
        const float hi_g = fminf(t_new, tend);
        if (next_g <= hi_g) {
          // grid points in (t, hi_g]: counts on the pre-expiry pool
          for (int gb = 0; gb < G; gb += 32) {
            const int gi = gb + lane;
            const float g = gi < G ? grow[gi] : 0.f;
            unsigned hit = __ballot_sync(FULL, gi < G && g > t && g <= hi_g);
            while (hit) {
              const int l = __ffs(hit) - 1;
              hit &= hit - 1;
              const float gg = __shfl_sync(FULL, g, l);
              int n_run = 0, n_idle = 0;
#pragma unroll
              for (int s = 0; s < S; ++s) {
                const bool live = alive[s] > 0.f && __fadd_rn(busy[s], texp) > gg;
                n_run += __popc(__ballot_sync(FULL, live && busy[s] > gg));
                n_idle += __popc(__ballot_sync(FULL, live && busy[s] <= gg));
              }
              if (lane == 0) {
                float* a = arow + ACC_COLS + gb + l;
                a[0] = __fadd_rn(a[0], (float)n_run);
                a[G] = __fadd_rn(a[G], (float)n_idle);
                if (n_idle == 0) a[2 * G] = __fadd_rn(a[2 * G], 1.f);
              }
            }
          }
        }
        if (next_g <= t_new || t_new < t) next_g = next_grid(grow, G, t_new, lane);
      }

      // integrals over (lo, hi] on the pre-expiry pool, then expiry, then
      // the routing candidates on the post-expiry pool
      float run_l = 0.f, idle_l = 0.f, alive_l = 0.f;
      float best = NEG;
      int best_j = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float expire = __fadd_rn(busy[s], texp);
        const float r = fmaxf(__fsub_rn(fminf(busy[s], hi), lo), 0.f);
        const float d = fmaxf(__fsub_rn(fminf(expire, hi), fmaxf(busy[s], lo)), 0.f);
        run_l = __fadd_rn(run_l, __fmul_rn(r, alive[s]));
        idle_l = __fadd_rn(idle_l, __fmul_rn(d, alive[s]));
        if (alive[s] > 0.f && expire <= t_new) alive[s] = 0.f;
        alive_l = __fadd_rn(alive_l, alive[s]);
        // this lane's slots ascend with s, so '>' keeps the lowest slot on a tie
        if (alive[s] > 0.f && busy[s] <= t_new && cre[s] > best) {
          best = cre[s];
          best_j = s * 32 + lane;
        }
      }
      const float run_sum = warp_sum(run_l);
      const float idle_sum = warp_sum(idle_l);
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

      const bool any_idle = best > NEG * 0.5f;
      const bool any_free = first_free >= 0;
      const bool active = t_new <= tend;
      const bool counted = t_new > sk;
      const bool below = n_alive < max_c;
      const bool can_cold = !any_idle && below && any_free;
      const bool is_warm = any_idle && active;
      const bool is_cold = can_cold && active;
      const bool is_reject = !any_idle && !can_cold && active;
      if (is_warm || is_cold) {
        const int chosen = is_warm ? best_j : first_free;
        const float done = __fadd_rn(t_new, is_warm ? warm_s : cold_s);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s * 32 + lane == chosen) {
            busy[s] = done;
            if (is_cold) {
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
      // overflow is counted for active arrivals whether or not past skip
      if (!any_idle && below && !any_free && active) a_over = __fadd_rn(a_over, 1.f);
      t = t_new;
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * 32 + lane;
    if (j < M) {
      alive_out[pool + j] = alive[s];
      creation_out[pool + j] = cre[s];
      busy_out[pool + j] = busy[s];
    }
  }
  if (lane == 0) {
    t_out[row] = t;
    float* a = arow;
    a[0] = a_cold;
    a[1] = a_warm;
    a[2] = a_rej;
    a[3] = a_run;
    a[4] = a_idle;
    a[5] = a_cresp;
    a[6] = a_wresp;
    a[7] = a_over;
  }
}

template <int S>
void launch(const float* const* in, float* const* out, int R, int M, int K,
            int G, float max_c, int prestamped, cudaStream_t stream) {
  const dim3 blocks((R + WARPS - 1) / WARPS), threads(WARPS * 32);
  if (G > 0)
    faas_sweep_kernel<S, true><<<blocks, threads, 0, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], out[0], out[1], out[2], out[3], out[4], R, M, K, G, max_c,
        prestamped);
  else
    faas_sweep_kernel<S, false><<<blocks, threads, 0, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], out[0], out[1], out[2], out[3], out[4], R, M, K, 0, max_c,
        prestamped);
}

}  // namespace

// Plain C entry, bound with ctypes.  Inputs: alive, creation, busy [R, M];
// t0, t_exp, t_end, skip [R]; dts, warms, colds [R, K]; grid [R, G] (may
// be null when G = 0) — all f32, contiguous, on `device`.  Outputs: alive,
// creation, busy [R, M], t [R], acc [R, 8 + 3G].  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int faas_sweep_f32(
    const void* alive_in, const void* creation_in, const void* busy_in,
    const void* t0, const void* t_exp, const void* t_end, const void* skip,
    const void* dts, const void* warms, const void* colds, const void* grid,
    void* alive_out, void* creation_out, void* busy_out, void* t_out,
    void* acc_out, int R, int M, int K, int G, int max_concurrency,
    int prestamped, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || M < 1 || M > 1024 || K < 0 || G < 0 || G > MAX_GRID ||
      (G > 0 && grid == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* in[11] = {
      (const float*)alive_in, (const float*)creation_in, (const float*)busy_in,
      (const float*)t0,       (const float*)t_exp,       (const float*)t_end,
      (const float*)skip,     (const float*)dts,         (const float*)warms,
      (const float*)colds,    (const float*)grid};
  float* out[5] = {(float*)alive_out, (float*)creation_out, (float*)busy_out,
                   (float*)t_out, (float*)acc_out};
  const float max_c = (float)max_concurrency;
  cudaStream_t st = (cudaStream_t)stream;
  const int s = (M + 31) / 32;
  if (s <= 1) launch<1>(in, out, R, M, K, G, max_c, prestamped, st);
  else if (s <= 2) launch<2>(in, out, R, M, K, G, max_c, prestamped, st);
  else if (s <= 4) launch<4>(in, out, R, M, K, G, max_c, prestamped, st);
  else if (s <= 8) launch<8>(in, out, R, M, K, G, max_c, prestamped, st);
  else if (s <= 16) launch<16>(in, out, R, M, K, G, max_c, prestamped, st);
  else launch<32>(in, out, R, M, K, G, max_c, prestamped, st);
  return (int)cudaGetLastError();
}
