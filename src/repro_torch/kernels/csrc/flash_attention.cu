// Hopper (sm_90a) prefill attention: the tiled online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas).  out[b, s, h] is the softmax-weighted
// sum of v[b, :, h / G] for query q[b, s, h] (G = Hq / Hkv query heads per
// KV head), with the options causal, window, prefix_len, softcap and scale.
// The arithmetic is the reference's: scores in f32, scaled, soft-capped by
// tanh, masked with the finite NEG_INF (not -inf: a row whose first visited
// tile is fully masked gets p = exp(0) = 1 there, wiped out by the next
// tile's corr = exp(NEG_INF - m) = 0); p is rounded to v's type before the
// P·V product, which accumulates in f32; the row sum l adds the unrounded
// p; the output is acc / max(l, 1e-37) in q's type.  Keys past T (the ragged
// last tile) get -inf, so p = 0 for them: they do not exist.
//
// What bounds it on this card: at the serving path's shapes (B = 4, S = T =
// 2,048, Hq = 32, Hkv = 8, D = 64, bf16, causal) one call needs ~6.9e10 FLOP
// (QK^T and PV over the causal half) on 84 MB of q, k, v and out, so the
// tensor cores (989 TFLOP/s bf16) bound it at ~0.07 ms; the bytes take
// 0.025 ms at 3.35 TB/s.
//
// What the design does about that, in this first version: the TPU walks kv
// tiles as a sequential grid axis with m, l and acc in VMEM scratch; here
// one block of 128 threads (4 warps) owns a (b, h, 64-query tile) and loops
// over the 64-key tiles itself, with m, l and acc held by the threads that
// own a row.  For bf16 (the serving path) the two products run on the
// tensor cores through WMMA 16x16x16 bf16 tiles with f32 accumulation:
// each warp owns 16 query rows, computes its 16 x 64 scores from the
// shared Q and K tiles, runs the online softmax on them (two lanes per row,
// p rounded to bf16 in shared memory, which is the reference's cast), and
// multiplies p by the V tile into a per-tile f32 product that the row's
// lanes fold into their acc registers as acc * corr + pv, the reference's
// order.  Rows are private to a warp, so only the K/V tile loads (16-byte
// vector loads) need the whole block.  For f32 (the tests) the products are
// scalar FMAs (explicit fmaf) from 4x8 register micro-tiles over f32 tiles
// with row stride D + 1.  Neither uses wgmma or TMA, or overlaps a tile's
// load with the previous tile's compute: those are the levers left.
// Tiles skip as the reference's do (flash_attention.py:57-63): strictly
// future tiles unless the prefix reaches them, and tiles wholly outside the
// window.  Any S and T: the ragged edges are masked, not asserted away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "attention_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;

// tile ki of the block's queries [q_start, q_start + BQ) holds a key that
// some row may attend to (flash_attention.py:57-63)
__device__ __forceinline__ bool tile_reached(int k_start, int q_start, int causal,
                                             int window, int prefix_len) {
  bool reach = true;
  if (causal) reach = (k_start <= q_start + BQ - 1) || (k_start < prefix_len);
  if (window > 0) reach = reach && (k_start + BK - 1 > q_start - window);
  return reach;
}

// the score of query qi against key kj: scaled, soft-capped, then NEG_INF
// where masked and -inf past T (a key that does not exist)
__device__ __forceinline__ float masked_score(float dot, int qi, int kj, int T_len,
                                              int causal, int window, int prefix_len,
                                              float softcap, float scale) {
  float x = dot * scale;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  bool allow = causal ? (kj <= qi) : true;
  if (prefix_len > 0) allow = allow || (qi < prefix_len && kj < prefix_len);
  if (window > 0) allow = allow && (kj > qi - window);
  if (kj >= T_len) return -INFINITY;
  return allow ? x : NEG_INF;
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int T_len,
             int Hq, int Hkv, int causal, int window, int prefix_len,
             float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int NC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* Ks = Qs + BQ * LD;      // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Ps = Vs + BK * LD;      // [BQ][LP] scores, then p
  float* row_val = Ps + BQ * LP;  // [BQ] corr per tile, then l

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_stride = (size_t)Hq * D;  // between sequence positions
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * T_len * kv_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * T_len * kv_stride + (size_t)hk * D;
  T* ob = out + (size_t)b * S * q_stride + (size_t)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qi = q_start + r;
    Qs[r * LD + c] = qi < S ? to_f32(qb[(size_t)qi * q_stride + c]) : 0.f;
  }

  // micro-tile of this thread: rows tr*4 .. tr*4+3, columns tc + 8j
  const int tr = tid >> 3, tc = tid & 7;
  // softmax: row tid/2, columns (tid&1)*32 .. +31; both threads of the pair
  // hold the row's m and l
  const int sm_row = tid >> 1, sm_half = tid & 1;
  float m_i = NEG_INF, l_i = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int n_tiles = (T_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * BK;
    if (!tile_reached(k_start, q_start, causal, window, prefix_len)) continue;

    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kj = k_start + r;
      const bool in = kj < T_len;
      Ks[r * LD + c] = in ? to_f32(kb[(size_t)kj * kv_stride + c]) : 0.f;
      Vs[r * LD + c] = in ? to_f32(vb[(size_t)kj * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    // scores s = q k^T for the 4x8 micro-tile, then scale, softcap, mask
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_start + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[(tr * 4 + i) * LP + tc + 8 * j] =
            masked_score(s[i][j], qi, k_start + tc + 8 * j, T_len, causal, window,
                         prefix_len, softcap, scale);
    }
    __syncthreads();

    // online softmax over the tile, one row per thread pair
    {
      float* prow = Ps + sm_row * LP + sm_half * 32;
      float tmax = -INFINITY;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) tmax = fmaxf(tmax, prow[c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
      const float m_new = fmaxf(m_i, tmax);
      float psum = 0.f;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float p = expf(prow[c] - m_new);
        psum += p;
        prow[c] = round_to<T>(p);
      }
      psum += __shfl_xor_sync(FULL, psum, 1);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + psum;
      m_i = m_new;
      if (sm_half == 0) row_val[sm_row] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = row_val[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= cr;
    }
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = Vs[kk * LD + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  __syncthreads();
  if (sm_half == 0) row_val[sm_row] = l_i;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_start + tr * 4 + i;
    if (qi >= S) continue;
    const float l = fmaxf(row_val[tr * 4 + i], 1e-37f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[(size_t)qi * q_stride + tc + 8 * j] = from_f32<T>(acc[i][j] / l);
  }
}

// shared memory of the bf16 kernel: Q, K, V tiles (bf16, row stride D + 8),
// the f32 scores (64 + 4), p in bf16 (64 + 8), the tile's f32 P·V (D + 4)
// and one float per row; every array starts on a 128-byte boundary
template <int D>
constexpr int tc_smem_bytes() {
  return 3 * BQ * (D + 8) * 2 + BQ * (BK + 4) * 4 + BQ * (BK + 8) * 2 +
         BQ * (D + 4) * 4 + BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int S, int T_len, int Hq,
                int Hkv, int causal, int window, int prefix_len, float softcap,
                float scale) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int LDQ = D + 8;   // Qs, Ks, Vs
  constexpr int LDS = BK + 4;  // Sf
  constexpr int LDP = BK + 8;  // Pb
  constexpr int LDO = D + 4;   // Of
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  constexpr int HALF = D / 2;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LDQ;
  bf16* Vs = Ks + BK * LDQ;
  float* Sf = reinterpret_cast<float*>(Vs + BK * LDQ);
  bf16* Pb = reinterpret_cast<bf16*>(Sf + BQ * LDS);
  float* Of = reinterpret_cast<float*>(Pb + BQ * LDP);
  float* row_val = Of + BQ * LDO;  // [BQ] corr of the current tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * S * q_stride + (size_t)h * D;
  const bf16* kb = k + (size_t)b * T_len * kv_stride + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * T_len * kv_stride + (size_t)hk * D;
  bf16* ob = out + (size_t)b * S * q_stride + (size_t)h * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int qi = q_start + r;
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) =
        qi < S ? *reinterpret_cast<const uint4*>(qb + (size_t)qi * q_stride + c) : zero;
  }

  // this warp's 16 rows; row sm_row's columns sm_half*32 .. +31 in the
  // softmax and sm_half*HALF .. +HALF-1 of the output belong to this lane
  const int row0 = warp * 16;
  const int sm_row = row0 + (lane >> 1), sm_half = lane & 1;
  const int qi = q_start + sm_row;
  float m_i = NEG_INF, l_i = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  const int n_tiles = (T_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * BK;
    if (!tile_reached(k_start, q_start, causal, window, prefix_len)) continue;

    __syncthreads();  // every warp is done with the previous K and V tiles
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const int kj = k_start + r;
      const bool in = kj < T_len;
      *reinterpret_cast<uint4*>(Ks + r * LDQ + c) =
          in ? *reinterpret_cast<const uint4*>(kb + (size_t)kj * kv_stride + c) : zero;
      *reinterpret_cast<uint4*>(Vs + r * LDQ + c) =
          in ? *reinterpret_cast<const uint4*>(vb + (size_t)kj * kv_stride + c) : zero;
    }
    __syncthreads();

    {  // scores of the warp's 16 rows against the tile's 64 keys
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + row0 * LDQ + kk, LDQ);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          // K^T as a col-major B: element (d, key) at Ks[key * LDQ + d]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + 16 * j * LDQ + kk, LDQ);
          wmma::mma_sync(sacc[j], a, bk, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(Sf + row0 * LDS + 16 * j, sacc[j], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    {  // online softmax, two lanes per row
      const float* srow = Sf + sm_row * LDS + sm_half * 32;
      bf16* prow = Pb + sm_row * LDP + sm_half * 32;
      const int kj0 = k_start + sm_half * 32;
      float xs[32];
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        xs[c] = masked_score(srow[c], qi, kj0 + c, T_len, causal, window, prefix_len,
                             softcap, scale);
        tmax = fmaxf(tmax, xs[c]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
      const float m_new = fmaxf(m_i, tmax);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = expf(xs[c] - m_new);
        psum += p;
        prow[c] = __float2bfloat16_rn(p);
      }
      psum += __shfl_xor_sync(FULL, psum, 1);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + psum;
      m_i = m_new;
      if (sm_half == 0) row_val[sm_row] = corr;
    }
    __syncwarp();

#pragma unroll
    for (int n = 0; n < D; n += 16) {  // the tile's p v for the warp's rows
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pb + row0 * LDP + kk, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * LDQ + n, LDQ);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(Of + row0 * LDO + n, o, LDO, wmma::mem_row_major);
    }
    __syncwarp();

    const float cr = row_val[sm_row];
    const float* orow = Of + sm_row * LDO + sm_half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] = acc[i] * cr + orow[i];
  }

  if (qi < S) {
    const float l = fmaxf(l_i, 1e-37f);
    __nv_bfloat162* orow =
        reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qi * q_stride + sm_half * HALF);
#pragma unroll
    for (int i = 0; i < HALF; i += 2)
      orow[i / 2] = __floats2bfloat162_rn(acc[i] / l, acc[i + 1] / l);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int T_len, int Hq, int Hkv, int causal, int window,
              int prefix_len, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static_assert(smem <= MAX_SMEM, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_kernel_tc<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, S, T_len, Hq, Hkv, causal, window, prefix_len, softcap,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int T_len, int Hq, int Hkv, int causal, int window, int prefix_len,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static_assert(smem <= MAX_SMEM, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, T_len, Hq, Hkv, causal,
      window, prefix_len, softcap, scale);
  return (int)cudaGetLastError();
}

// f32: the scalar kernel; bf16: the tensor-core kernel
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int Hq, int Hkv, int D, int causal, int window,
             int prefix_len, float softcap, float scale, cudaStream_t st) {
#define FLASH_CASE(DD)                                                         \
  case DD:                                                                     \
    if constexpr (sizeof(T) == 2)                                              \
      return launch_tc<DD>(q, k, v, out, B, S, T_len, Hq, Hkv, causal, window, \
                           prefix_len, softcap, scale, st);                    \
    else                                                                       \
      return launch<T, DD>(q, k, v, out, B, S, T_len, Hq, Hkv, causal, window, \
                           prefix_len, softcap, scale, st);
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    FLASH_CASE(160)
    FLASH_CASE(192)
    FLASH_CASE(224)
    FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// Plain C entry, bound with ctypes.  q [B, S, Hq, D], k and v [B, T, Hkv, D],
// out [B, S, Hq, D]: contiguous, of one type (dtype 0 = f32, 1 = bf16; bf16
// pointers 16-byte aligned), on `device`; D a multiple of 32 up to 256, Hq a
// multiple of Hkv.  Launches on
// `stream` and returns the CUDA error code (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int S, int T_len, int Hq,
                                   int Hkv, int D, int dtype, int causal,
                                   int window, int prefix_len, float softcap,
                                   float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || T_len < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, T_len, Hq, Hkv, D, causal,
                           window, prefix_len, softcap, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T_len, Hq, Hkv, D,
                                   causal, window, prefix_len, softcap, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
