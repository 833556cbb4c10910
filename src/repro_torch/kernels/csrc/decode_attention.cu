// Hopper (sm_90a) decode attention: one new query token per sequence
// against its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (launched by decode_attention_pallas).  out[b, h] attends q[b, h] over
// cache positions t < cache_len[b] (and t > cache_len[b] - 1 - window when
// window > 0) of KV head h / G, G = Hq / Hkv.  The arithmetic is the prefill
// kernel's (flash_attention.cu): f32 scores, scale, tanh soft-cap, the
// finite NEG_INF mask, p rounded to v's type before P·V with f32
// accumulation, l summing the unrounded p, out = acc / max(l, 1e-37).  A
// sequence with cache_len 0 reads nothing and gets zeros, as the TPU
// kernel does.
//
// What bounds it on this card: bytes.  Every valid K and V row of the cache
// is read once per token (at B = 4, ~2,100 valid positions, Hkv = 8, D = 64
// in bf16: ~17 MB, 5.2 us at 3.35 TB/s), against ~2 FLOP per byte.
//
// What the design does about that: the TPU grid is (B, Hkv, T-chunks) with
// the chunk axis sequential and the G grouped query rows resident.  Here a
// block of 128 threads owns (b, kv head, one split of the T axis): it keeps
// the G query rows in shared memory, reads only the 64-key tiles of its
// split that hold a valid position (below cache_len, inside the window), and
// reads each tile once for all G heads.  B * Hkv blocks alone would leave
// most of the 132 SMs idle at small batch (32 blocks at B = 4, Hkv = 8), so
// the wrapper splits T into `nsplit` ranges (FlashDecoding) and a second
// kernel combines the splits' (m, l, acc) per row.  A tile is staged in
// shared memory as f32 with row stride D + 1 (bank-conflict-free reads
// along a row); scores and P·V are scalar f32 FMAs; acc lives in shared
// memory, each entry updated only by the thread that owns it.  Loads are
// not overlapped with compute yet (no cp.async / TMA ring): that is the
// next lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         ((size_t)2 * G * D + (size_t)2 * BK * (D + 1) + (size_t)G * BK + 3 * G);
}

// One (kv head, batch row, split): partial m, l [G] and acc [G, D] of the
// split's tiles, written to part_m/part_l [B, Hkv, nsplit, G] and
// part_acc [B, Hkv, nsplit, G, D].
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cache_len,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int T_len, int Hq, int Hkv,
                    int D, int window, float softcap, float scale,
                    int tiles_per_split) {
  const int G = Hq / Hkv;
  const int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [G][D]
  float* Ks = Qs + G * D;        // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Ps = Vs + BK * LD;      // [G][BK]
  float* As = Ps + G * BK;       // [G][D] acc
  float* Ms = As + G * D;        // [G]
  float* Ls = Ms + G;            // [G]
  float* Cs = Ls + G;            // [G] corr of the current tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  const T* kb = k + (size_t)b * T_len * kv_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * T_len * kv_stride + (size_t)hk * D;

  int len = cache_len[b];
  len = len < T_len ? len : T_len;
  for (int i = tid; i < G * D; i += THREADS) {
    Qs[i] = to_f32(qb[i]);
    As[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }

  const int n_tiles = (T_len + BK - 1) / BK;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  for (int kt = t0; kt < t1; ++kt) {
    const int k_start = kt * BK;
    bool needed = k_start < len;
    if (window > 0) needed = needed && (k_start + BK - 1 > len - 1 - window);
    if (!needed) continue;  // uniform over the block

    __syncthreads();  // Qs/As/Ms ready; the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int t = k_start + r;
      const bool in = t < T_len;
      Ks[r * LD + c] = in ? to_f32(kb[(size_t)t * kv_stride + c]) : 0.f;
      Vs[r * LD + c] = in ? to_f32(vb[(size_t)t * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < G * BK; e += THREADS) {
      const int g = e / BK, j = e % BK;
      const float* qr = Qs + g * D;
      const float* kr = Ks + j * LD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      float x = s * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int t = k_start + j;
      bool valid = t < len;
      if (window > 0) valid = valid && (t > len - 1 - window);
      if (t >= T_len) x = -INFINITY;
      else if (!valid) x = NEG_INF;
      Ps[e] = x;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* prow = Ps + g * BK;
      const float x0 = prow[lane], x1 = prow[lane + 32];
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float psum = warp_sum(p0 + p1);
      prow[lane] = round_to<T>(p0);
      prow[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Ls[g] = Ls[g] * corr + psum;
        Ms[g] = m_new;
        Cs[g] = corr;
      }
    }
    __syncthreads();

    for (int o = tid; o < G * D; o += THREADS) {
      const int g = o / D, c = o % D;
      const float* prow = Ps + g * BK;
      float a = As[o] * Cs[g];
      for (int j = 0; j < BK; ++j) a = fmaf(prow[j], Vs[j * LD + c], a);
      As[o] = a;
    }
  }
  __syncthreads();

  const size_t row = ((size_t)b * Hkv + hk) * nsplit + split;  // [B, Hkv, nsplit]
  for (int i = tid; i < G * D; i += THREADS) part_acc[row * G * D + i] = As[i];
  for (int g = tid; g < G; g += THREADS) {
    part_m[row * G + g] = Ms[g];
    part_l[row * G + g] = Ls[g];
  }
}

// out[b, hk*G + g] = sum_s acc_s e^(m_s - m) / max(sum_s l_s e^(m_s - m), 1e-37)
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int Hq, int Hkv, int D, int nsplit) {
  const int G = Hq / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t row0 = ((size_t)b * Hkv + hk) * nsplit;
  T* ob = out + ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int o = threadIdx.x; o < G * D; o += THREADS) {
    const int g = o / D;
    float m = NEG_INF;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[(row0 + s) * G + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(part_m[(row0 + s) * G + g] - m);
      l = fmaf(part_l[(row0 + s) * G + g], w, l);
      a = fmaf(part_acc[(row0 + s) * G * D + o], w, a);
    }
    ob[o] = from_f32<T>(a / fmaxf(l, 1e-37f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           void* out, float* scratch, int B, int T_len, int Hq, int Hkv, int D,
           int window, float softcap, float scale, int nsplit,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T_len + BK - 1) / BK;
  const int tps = (n_tiles + nsplit - 1) / nsplit;
  const size_t rows = (size_t)B * Hkv * nsplit;
  float* part_m = scratch;
  float* part_l = part_m + rows * G;
  float* part_acc = part_l + rows * G;
  decode_split_kernel<T><<<dim3(Hkv, B, nsplit), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, cache_len, part_m, part_l,
      part_acc, T_len, Hq, Hkv, D, window, softcap, scale, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(Hkv, B), THREADS, 0, stream>>>(
      part_m, part_l, part_acc, (T*)out, Hq, Hkv, D, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes.  q [B, Hq, D], k_cache and v_cache
// [B, T, Hkv, D], out [B, Hq, D]: contiguous, of one type (dtype 0 = f32,
// 1 = bf16); cache_len [B] int32; scratch f32 of B*Hkv*nsplit*G*(D + 2)
// floats; all on `device`.  D a multiple of 32 up to 256, Hq a multiple of
// Hkv, 1 <= nsplit <= ceil(T / 64).  Launches the split and combine kernels
// on `stream` and returns the CUDA error code (0 = ok).
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* cache_len,
                                    void* out, void* scratch, int B, int T_len,
                                    int Hq, int Hkv, int D, int dtype,
                                    int window, float softcap, float scale,
                                    int nsplit, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || T_len < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || D < 32 ||
      D > 256 || D % 32 != 0 || nsplit < 1 || nsplit > (T_len + BK - 1) / BK ||
      Hkv > 65535 || B > 65535 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, (const int*)cache_len, out,
                         (float*)scratch, B, T_len, Hq, Hkv, D, window, softcap,
                         scale, nsplit, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, (const int*)cache_len,
                                 out, (float*)scratch, B, T_len, Hq, Hkv, D,
                                 window, softcap, scale, nsplit, st);
  return (int)cudaErrorInvalidValue;
}
