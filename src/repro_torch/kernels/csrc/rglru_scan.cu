// Hopper (sm_90a) RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_rglru_kernel
// (launched by rglru_scan_pallas).  a and b are [B, L, W] f32, h0 [B, W] f32
// or null (zeros); y [B, L, W] f32 receives every h_t.  Each step is one
// rounded f32 multiply and one rounded add in time order (the build passes
// --fmad=false), as the plain version repro_torch/models/scans.py::
// rglru_scan_ref computes it, so the two agree bit for bit.  A scan chunked
// over L would round in another order; the channels alone fill the card.
//
// What bounds it on this card: bytes.  Two reads and one write of 4 bytes
// per element: at recurrentgemma-9b's prefill (B = 4, L = 2,048, W = 4,096)
// 3 x 134.2 MB, 0.1202 ms at 3.35 TB/s.  Not the chain: a step is one
// multiply and one add, 8.4 cycles measured, so L = 2,048 steps take ~9 us
// at 1.98 GHz, a thirteenth of that bound.  What a warp can wait on is its
// loads: streaming at ~3 TB/s over 132 SMs asks each SM to keep ~23 KB in
// flight (Little's law at ~1 us of loaded latency), and the first version
// (one thread a channel, 16 steps of loads issued together, then the chain
// on them) kept at most ~16 KB in flight an SM at B = 4, none while its
// chain ran: 1.14 TB/s.  This one streams at ~2.7 TB/s on an H100 at 700 W,
// ~1.1x the time of torch.add over the same bytes; 2 to 5 stages move that
// by under 3%.  At B = 1 one warp a SM sets the pace: ~38 us a warp, of
// which ~22 us is its own instruction stream (the loop's issue, not the
// chain) and the rest waits on loads.
//
// The design: one warp a block owns 32 neighbouring channels of one batch
// row and walks L in order with h in a register, so B = 1 (128 warps at
// W = 4,096) still reaches 128 SMs and B = 4 runs in one wave.  Each warp
// has a ring of STAGES stages in shared memory; a stage is a box of T
// steps x 32 channels of a and of b (8 KB).  Before the warp consumes stage
// i, it asks for stage i + STAGES - 1, so 3 stages (24 KB) of reads are in
// flight while the chain runs: 24 KB an SM at B = 1, ~96 KB at B = 4.
// Every step stores one coalesced 128-byte row of y straight from
// registers; writes need nothing in flight.
// - TMA (W % 4 == 0 and a, b 16-byte aligned): lane 0 fills a stage with
//   two cp.async.bulk.tensor.3d boxes (1 x T x 32, from 3-D maps of
//   [B, L, W], so a box never runs into the next batch row; zeros past L and
//   W), completing on the stage's mbarrier.  The warp both fills and drains
//   its ring, so a __syncwarp before the refill of the slot it just read is
//   all the "empty" signal needed.
// - cp.async (any other W or pointer): each lane copies its own channel's
//   T steps with 4-byte cp.async into the same stages and arrives on the
//   same mbarrier (cp.async.mbarrier.arrive.noinc, 32 arrivals a phase).
//   A lane reads only what it copied, so no lane waits on another.
// The wrapper (kernels/rglru_scan.py::launch_plan) picks the path.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_common.cuh"

namespace {

constexpr int LANES = 32;   // channels a warp (and a block) owns
constexpr int T = 32;       // steps a stage
constexpr int STAGES = 4;   // ring depth
constexpr uint32_t STAGE_BYTES = 2 * T * LANES * 4;

struct __align__(128) Ring {
  float a[STAGES][T][LANES];
  float b[STAGES][T][LANES];
  uint64_t full[STAGES];
};

// one [1, T, 32] box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

template <bool TMA>
__global__ void __launch_bounds__(LANES)
rglru_scan_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ y, int L, int W) {
  __shared__ Ring ring;
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * LANES, w = w0 + lane, row = blockIdx.y;
  const bool live = w < W;
  const size_t col = (size_t)row * L * W + w;  // element (row, 0, w)
  const int n_stages = (L + T - 1) / T;

  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&ring.full[s]), TMA ? 1 : LANES);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // stage i into slot i % STAGES
  auto fill = [&](int i) {
    const int s = i % STAGES, t0 = i * T;
    const uint32_t bar = smem_u32(&ring.full[s]);
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load3(smem_u32(&ring.a[s][0][0]), &ma, bar, w0, t0, row);
        tma_load3(smem_u32(&ring.b[s][0][0]), &mb, bar, w0, t0, row);
      }
    } else {
      if (live) {
        const int n = min(T, L - t0);
        const float* pa = a + col + (size_t)t0 * W;
        const float* pb = b + col + (size_t)t0 * W;
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
          cp_async4(smem_u32(&ring.a[s][t][lane]), pa + (size_t)t * W);
          cp_async4(smem_u32(&ring.b[s][t][lane]), pb + (size_t)t * W);
        }
      }
      cp_async_arrive(bar);
    }
  };

  float h = (h0 != nullptr && live) ? h0[(size_t)row * W + w] : 0.f;
  for (int i = 0; i < STAGES - 1 && i < n_stages; ++i) fill(i);
  for (int i = 0; i < n_stages; ++i) {
    if (i + STAGES - 1 < n_stages) {
      // slot (i - 1) % STAGES was read by every lane in the last round
      if constexpr (TMA) __syncwarp();
      fill(i + STAGES - 1);
    }
    const int s = i % STAGES, t0 = i * T;
    mbar_wait(smem_u32(&ring.full[s]), (i / STAGES) & 1);
    float* yo = y + col + (size_t)t0 * W;
    const float(*sa)[LANES] = ring.a[s];
    const float(*sb)[LANES] = ring.b[s];
    if (t0 + T <= L) {
      // the stage into registers first: read inside the chain, each
      // multiply waits on its own shared-memory load
      float ra[T], rb[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        ra[t] = sa[t][lane];
        rb[t] = sb[t][lane];
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        h = __fadd_rn(__fmul_rn(ra[t], h), rb[t]);
        if (live) yo[(size_t)t * W] = h;
      }
    } else {
      for (int t = 0; t < L - t0; ++t) {
        h = __fadd_rn(__fmul_rn(sa[t][lane], h), sb[t][lane]);
        if (live) yo[(size_t)t * W] = h;
      }
    }
  }
}

// the map of an f32 [B, L, W] tensor read in boxes of 1 x T steps x 32
// channels, zeros past L and W
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int L, int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)L * W * 4};
  const cuuint32_t box[3] = {LANES, T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C entry, bound with ctypes.  a, b and y [B, L, W], h0 [B, W] or null:
// contiguous f32 on `device`.  tma = 1 takes the TMA path (W % 4 == 0, a and
// b 16-byte aligned, else the call is refused), 0 the cp.async path.
// Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* y,
                              int B, int L, int W, int tma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || L < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + LANES - 1) / LANES, B);
  CUtensorMap ma{}, mb{};
  if (tma) {
    const auto misaligned = [](const void* p) { return ((size_t)p & 15) != 0; };
    if (W % 4 != 0 || misaligned(a) || misaligned(b)) return (int)cudaErrorInvalidValue;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    if (!make_map(encode, &ma, a, B, L, W) || !make_map(encode, &mb, b, B, L, W))
      return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float *af = (const float*)a, *bf = (const float*)b, *hf = (const float*)h0;
  if (tma)
    rglru_scan_kernel<true><<<grid, LANES, 0, st>>>(ma, mb, af, bf, hf, (float*)y, L, W);
  else
    rglru_scan_kernel<false><<<grid, LANES, 0, st>>>(ma, mb, af, bf, hf, (float*)y, L, W);
  return (int)cudaGetLastError();
}
