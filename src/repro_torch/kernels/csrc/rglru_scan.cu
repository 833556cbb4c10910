// Hopper (sm_90a) RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_rglru_kernel
// (launched by rglru_scan_pallas).  a and b are [B, L, W] f32, h0 [B, W] f32
// or null (zeros); y [B, L, W] f32 receives every h_t.  Each step is one
// rounded f32 multiply and one rounded add (the build passes --fmad=false),
// as the plain version repro_torch/models/rglru.py::rglru_scan_ref computes
// it, so the two agree bit for bit.
//
// What bounds it on this card: bytes.  Two reads and one write of 4 bytes
// per element and one multiply-add: at recurrentgemma-9b's prefill (B = 4,
// L = 2,048, W = 4,096) 3 x 134.2 MB, 0.120 ms at 3.35 TB/s.
//
// What the design does about that: the TPU kernel keeps a [1, Wb] state in
// VMEM and streams [chunk, Wb] tiles over a sequential time axis.  Here one
// thread owns one channel (b, w) and walks t in order with h in a register;
// a warp's 32 channels are neighbouring addresses, so every step's loads and
// the store are coalesced 128-byte rows.  The dependent chain is one
// multiply and one add a step, so the loads of the next U steps are issued
// together into registers before the chain consumes them, keeping U x 2
// loads in flight per thread.  B x W = 16,384 channels are 512 warps, under
// four per SM of the 132: that is the limit of this first version, and a
// two-pass chunked scan over L (local scans, then a scan of the chunk
// carries) is the lever if it is latency-bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;  // steps whose loads are in flight together

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ y, int L,
                  int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)row * L * W + w;
  float h = h0 ? h0[(size_t)row * W + w] : 0.f;
  for (int t0 = 0; t0 < L; t0 += U) {
    float ra[U], rb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t off = base + (size_t)(t0 + u) * W;
      const bool in = t0 + u < L;
      ra[u] = in ? a[off] : 0.f;
      rb[u] = in ? b[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < L) {
        h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
        y[base + (size_t)(t0 + u) * W] = h;
      }
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  a, b and y [B, L, W], h0 [B, W] or null:
// contiguous f32 on `device`.  Launches on `stream` and returns the CUDA
// error code (0 = ok).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* y,
                              int B, int L, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || L < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)y, L, W);
  return (int)cudaGetLastError();
}
