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
// 0.025 ms at 3.35 TB/s.  recurrentgemma-9b's local layers (Hq = 16,
// Hkv = 1, D = 256, window 2,048 = S) need 1.4e11 FLOP: 0.14 ms.  At D = 64
// the exponential unit is nearly as tight: 16 ex2 a clock per SM is ~4.2e12
// a second, against the ~3.9e12 scores a second the tensor cores produce.
//
// bf16 (the serving path): a warp-specialised wgmma kernel, which replaced
// a WMMA kernel that stored every 64-key tile's scores, p and P·V product
// in shared memory and loaded K and V synchronously (68.7 TFLOP/s at
// llama's shape, 57 at D = 256).  A block owns BQ query rows of one
// (b, head): CONSUMERS warpgroups of 64 rows each, then one producer
// warpgroup that hands most of its registers to them (setmaxnreg).
// - The producer's first thread loads Q once and then the K and V tiles of
//   every key tile the block reaches, by TMA (cp.async.bulk.tensor over the
//   [B, T, H, D] tensors, 4-D maps from cuTensorMapEncodeTiled, fetched at
//   run time with cudaGetDriverEntryPoint, passed as __grid_constant__),
//   into a ring of ST stages guarded by full and empty mbarriers, K and V
//   apart (a stage's K is free once its S is done).  A tile is D / CB
//   column blocks of [rows][CB] with the hardware's 128-byte swizzle (CB =
//   64 when D is a multiple of 64) or 64-byte swizzle (CB = 32 otherwise),
//   the layout the wgmma descriptors name.  TMA fills rows past S or T with
//   zeros; keys past T still get -inf.
// - A consumer warpgroup computes S = Q K^T as a chain of wgmma.mma_async
//   m64n128k16 (m64n64k16 where BK = 64; Q and K both K-major in shared
//   memory), runs scale, soft-cap, mask and the online softmax on the
//   accumulator registers (a row's maximum takes two quad shuffles; its sum
//   is kept per thread and reduced once at the end), rescales O by corr in
//   registers, rounds p to bf16 in registers (the accumulator layout is the
//   A-fragment layout) and issues O += P V as wgmma with A from registers
//   and V as an MN-major B (the transpose bit), 64 (or 32) output columns an
//   instruction.  Nothing goes through shared memory between the two
//   products.  The warpgroup issues tile i's S beside tile i - 1's P V and
//   runs tile i's softmax while that P V finishes.
// - Tiles: at D <= 64 three consumer warpgroups (BQ = 192, 160 registers a
//   thread), so each K/V tile serves 192 query rows; above, two (BQ = 128,
//   232 registers: at D = 256 O alone is 128 f32 registers a thread).
//   BK = 128 keys for D <= 128, 64 above; ST = 3 stages where shared memory
//   allows, else 2 (D = 256: 64 KB of Q and 2 x 64 KB of K and V).  One
//   block a SM; ptxas reports no spill at any D.
// - Exponentials are ex2.approx with scale * log2(e) folded: on a tile that
//   needs no element mask and no soft-cap, p = 2^(fma(dot, scale log2 e,
//   -m)) with m the running maximum in the log2 domain, one multiply-add
//   and one MUFU op a score (the build's --fmad=false does not touch the
//   explicit __fmaf_rn).  Against the reference's expf(x - m) this moves p
//   by a few ulp, well inside the bf16 tolerance; the f32 path below keeps
//   expf.
// - Schedule: tiles skip as the reference's do (flash_attention.py:57-63,
//   with q_chunk = BQ and kv_chunk = BK), a warpgroup also skips a tile
//   whose keys all lie after its last row; element masks run only on tiles
//   that the causal diagonal, the window edge, the prefix or T cross.  The
//   query tiles go out longest first (the last tiles of a causal sequence
//   are issued first), so the causal tail does not leave SMs idle.
// - Against the bound: at llama's shape the kernel is neither tensor- nor
//   exponential-bound alone (removing either the wgmma or the softmax
//   leaves its time within a few percent); at D = 256 the 16 query heads
//   of one KV head re-read its K/V tiles from L2 (~1.1 GB a call), and with
//   two stages a stage's K is released once its S is done (V once its P V
//   is), so the next tile's K loads a step before its V.
//
// f32 (the tests' precision): one block of 128 threads (4 warps) owns a
// (b, h, 64-query tile) and loops over the 64-key tiles itself with m, l
// and acc held by the threads that own a row; the products are scalar FMAs
// (explicit fmaf) from 4x8 register micro-tiles over f32 tiles with row
// stride D + 1.  Tiles skip as the reference's do.  Any S and T: the ragged
// edges are masked, not asserted away.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "tma_common.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernel (see the note at the top)
// ---------------------------------------------------------------------------
namespace hop {

constexpr int WG_ROWS = 64;  // query rows of a consumer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BAR_BYTES = 256;

template <int D>
struct Cfg {
  // consumer warpgroups a block (the producer warpgroup comes last): three
  // at D <= 64, where each K/V tile then serves 192 query rows, else two
  static constexpr int CONSUMERS = D <= 64 ? 3 : 2;
  static constexpr int BQ = CONSUMERS * WG_ROWS;  // query rows a block
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  // registers a thread after the producer hands its share to the consumers
  // (setmaxnreg), within the allocation at launch (65,536 / THREADS a thread):
  // 128 x 24 + 384 x 160 and 128 x 32 + 256 x 232
  static constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 24 : 32;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 232;
  static constexpr int CB = D % 64 == 0 ? 64 : 32;  // columns of a swizzle block
  static constexpr int NCB = D / CB;
  static constexpr int ROW_BYTES = CB * 2;           // 128 (SW128) or 64 (SW64)
  static constexpr int ATOM = 8 * ROW_BYTES;         // 8 rows: the swizzle atom
  static constexpr int BK = D <= 128 ? 128 : 64;     // keys a tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or one V tile
  static constexpr int ST_FIT = (MAX_SMEM - 1024 - BAR_BYTES - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int ST = ST_FIT < 3 ? ST_FIT : 3;  // ring stages
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + BAR_BYTES;
  static_assert(ST >= 2, "the K/V ring needs two stages");
  static_assert(SMEM <= MAX_SMEM, "tile does not fit shared memory");
  static_assert(4 * ST * 8 + 8 <= BAR_BYTES, "barriers do not fit");
};

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the (asynchronous) wgmma instructions and their waits
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1 = 128-byte, 2 = 64-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] = A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss64_zero(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss64_acc(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] = A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss128_zero(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss128_acc(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// tile kt of the query rows [q_lo, q_hi] holds a key some row may attend to:
// the plain version's skips (models/attention.py) with its chunks BQ x BK
__device__ __forceinline__ bool reached(int k_start, int k_end, int q_lo, int q_hi,
                                        int causal, int window, int prefix_len) {
  if (causal && k_start > q_hi && k_start >= prefix_len) return false;
  if (window > 0 && k_end - 1 <= q_lo - window) return false;
  return true;
}

// what a consumer thread needs to mask and scale its scores: its rows qA
// and qB = qA + 8 (of the warpgroup's wq0 .. wq_last) and its first column
// c0 of each 8-column chunk of the accumulator layout
struct RowCtx {
  int T_len, causal, window, prefix_len;
  float softcap, scale, sl2;
  int wq0, wq_last, qA, qB, c0;
};

// the online-softmax state of the thread's two rows: maxima in the log2
// domain, partial sums over the thread's columns, and the last tile's corr
struct RowState {
  float mA, mB, lA, lB, corrA, corrB;
};

// S = Q K^T of one tile into sc: 64 rows x BK keys, 128 keys an instruction
// where BK allows, both operands K-major in shared memory
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<D>::BK / 2], uint32_t q_wg,
                                        uint32_t k_tile) {
  using C = Cfg<D>;
  constexpr uint32_t SWZ = C::CB == 64 ? 1u : 2u;
  constexpr int SN = C::BK % 128 == 0 ? 128 : 64;  // keys an instruction
#pragma unroll
  for (int c = 0; c < C::NCB; ++c)
#pragma unroll
    for (int kk = 0; kk < C::CB / 16; ++kk) {
      const uint64_t da = make_desc(q_wg + c * WG_ROWS * C::ROW_BYTES + kk * 32, 16, C::ATOM, SWZ);
#pragma unroll
      for (int n = 0; n < C::BK / SN; ++n) {
        const uint64_t db = make_desc(
            k_tile + c * C::BK * C::ROW_BYTES + n * SN * C::ROW_BYTES + kk * 32, 16, C::ATOM,
            SWZ);
        if constexpr (SN == 128) {
          if (c == 0 && kk == 0)
            wgmma_ss128_zero(sc + 64 * n, da, db);
          else
            wgmma_ss128_acc(sc + 64 * n, da, db);
        } else {
          if (c == 0 && kk == 0)
            wgmma_ss64_zero(sc + 32 * n, da, db);
          else
            wgmma_ss64_acc(sc + 32 * n, da, db);
        }
      }
    }
}

// O += P V of one tile: p from registers, V [BK keys][D] an MN-major B
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&pa)[Cfg<D>::BK / 16][4],
                                         uint32_t v_tile) {
  using C = Cfg<D>;
  constexpr uint32_t SWZ = C::CB == 64 ? 1u : 2u;
  constexpr uint32_t LBO = C::BK * C::ROW_BYTES;  // from one column block to the next
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
      wgmma_rs64(o + 32 * n, pa[kk],
                 make_desc(v_tile + (64 * n / C::CB) * LBO + kk * 16 * C::ROW_BYTES, LBO,
                           C::ATOM, SWZ));
    if constexpr (D % 64 != 0)
      wgmma_rs32(o + 32 * (D / 64), pa[kk],
                 make_desc(v_tile + (D / 32 - 1) * LBO + kk * 16 * C::ROW_BYTES, LBO, C::ATOM,
                           SWZ));
  }
}

// the online softmax of the tile at k_start on the accumulator layout, in
// place (sc becomes p): element j of sc is row (j & 2 ? qB : qA), key
// k_start + 8 (j / 4) + c0 + (j & 1); sets corr and updates m and l
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], int k_start,
                                               const RowCtx& x, RowState& st) {
  const bool need_mask = x.softcap > 0.f || k_start + BK > x.T_len ||
                         (x.causal && k_start + BK - 1 > x.wq0) ||
                         (x.window > 0 && k_start <= x.wq_last - x.window);
  float tA = -INFINITY, tB = -INFINITY;  // the tile's row maxima
  if (!need_mask) {  // interior tile: the maxima of the raw dots, scaled once
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      if (j & 2) tB = fmaxf(tB, sc[j]);
      else tA = fmaxf(tA, sc[j]);
    }
    tA *= x.sl2;
    tB *= x.sl2;
  } else {  // scores in the log2 domain, then the masks (each pass its own loop)
    if (x.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        sc[j] = (x.softcap * tanhf((sc[j] * x.scale) / x.softcap)) * LOG2E;
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] *= x.sl2;
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int qi = (j & 2) ? x.qB : x.qA;
      const int kj = k_start + 8 * (j >> 2) + x.c0 + (j & 1);
      bool allow = x.causal ? kj <= qi : true;
      if (x.prefix_len > 0) allow = allow || (qi < x.prefix_len && kj < x.prefix_len);
      if (x.window > 0) allow = allow && kj > qi - x.window;
      const float y = kj >= x.T_len ? -INFINITY : (allow ? sc[j] : NEG_INF);
      sc[j] = y;
      if (j & 2) tB = fmaxf(tB, y);
      else tA = fmaxf(tA, y);
    }
  }
  tA = fmaxf(tA, __shfl_xor_sync(FULL, tA, 1));
  tA = fmaxf(tA, __shfl_xor_sync(FULL, tA, 2));
  tB = fmaxf(tB, __shfl_xor_sync(FULL, tB, 1));
  tB = fmaxf(tB, __shfl_xor_sync(FULL, tB, 2));
  const float nA = fmaxf(st.mA, tA), nB = fmaxf(st.mB, tB);
  st.corrA = ex2(st.mA - nA);
  st.corrB = ex2(st.mB - nB);
  st.mA = nA;
  st.mB = nB;
  float sumA = 0.f, sumB = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const float m = (j & 2) ? nB : nA;
    // one exponential a score: the argument is chosen, not the call
    const float p = ex2(need_mask ? sc[j] - m : __fmaf_rn(sc[j], x.sl2, -m));
    sc[j] = p;
    if (j & 2) sumB += p;
    else sumA += p;
  }
  st.lA = st.lA * st.corrA + sumA;
  st.lB = st.lB * st.corrB + sumB;
}

// O *= corr (the reference's acc * corr + pv), then p to bf16 A fragments
template <int D>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2],
                                             uint32_t (&pa)[Cfg<D>::BK / 16][4],
                                             const float (&sc)[Cfg<D>::BK / 2],
                                             const RowState& st) {
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] *= (j & 2) ? st.corrB : st.corrA;
#pragma unroll
  for (int j = 0; j < Cfg<D>::BK / 2; j += 2)
    pa[j / 8][(j % 8) / 2] = pack_bf16(sc[j], sc[j + 1]);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                   int S, int T_len, int Hq, int Hkv, int causal, int window, int prefix_len,
                   float softcap, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, ST = C::ST, CB = C::CB, NCB = C::NCB;
  constexpr int BQ = C::BQ, CONSUMERS = C::CONSUMERS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // [CONSUMERS][NCB][64][CB]
  const uint32_t sK = sQ + C::Q_BYTES;            // [ST][NCB][BK][CB]
  const uint32_t sV = sK + ST * C::KV_BYTES;      // [ST][NCB][BK][CB]
  const uint32_t bar = sV + ST * C::KV_BYTES;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u + 8u * s; };
  auto v_full = [&](int s) { return bar + 8u + 8u * (ST + s); };
  // K and V of a stage are released apart: K once the tile's S is done, V
  // once its P V is, so the next K loads a step earlier
  auto k_empty = [&](int s) { return bar + 8u + 8u * (2 * ST + s); };
  auto v_empty = [&](int s) { return bar + 8u + 8u * (3 * ST + s); };

  // the block's (query tile, head, batch row): the last query tiles first
  const int n_qt = (S + BQ - 1) / BQ;
  const int per_tile = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / per_tile;
  const int rem = (int)blockIdx.x % per_tile;
  const int h = rem % Hq, b = rem / Hq;
  const int hk = h / (Hq / Hkv);
  const int q_start = qt * BQ;
  const int q_last = min(q_start + BQ, S) - 1;
  const int n_wg = min(CONSUMERS, (S - q_start + WG_ROWS - 1) / WG_ROWS);

  // the key tiles the block reaches: a contiguous range [kt_lo, kt_hi)
  const int n_tiles = (T_len + BK - 1) / BK;
  int kt_hi = n_tiles;
  while (kt_hi > 0 && !reached((kt_hi - 1) * BK, min(kt_hi * BK, T_len), q_start, q_last,
                               causal, window, prefix_len))
    --kt_hi;
  int kt_lo = 0;
  while (kt_lo < kt_hi && !reached(kt_lo * BK, min(kt_lo * BK + BK, T_len), q_start, q_last,
                                   causal, window, prefix_len))
    ++kt_lo;
  const int n_k = kt_hi - kt_lo;

  // warp and warpgroup read through a shuffle, so the compiler knows them
  // uniform over the warp (wgmma under a branch it cannot prove uniform is
  // serialised)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * n_wg);  // one arrival per consumer warp
      mbar_init(v_empty(s), 4 * n_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::PRODUCER_REGS));
    if (warp == 4 * CONSUMERS && lane == 0) {
      mbar_expect_tx(q_full, n_wg * WG_ROWS * D * 2);
      for (int g = 0; g < n_wg; ++g)
#pragma unroll
        for (int c = 0; c < NCB; ++c)
          tma_load(sQ + (g * NCB + c) * WG_ROWS * C::ROW_BYTES, &tq, q_full, c * CB, h,
                   q_start + g * WG_ROWS, b);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % ST, kt = kt_lo + i;
        mbar_wait(k_empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCB; ++c)
          tma_load(sK + s * C::KV_BYTES + c * BK * C::ROW_BYTES, &tk, k_full(s), c * CB, hk,
                   kt * BK, b);
        mbar_wait(v_empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCB; ++c)
          tma_load(sV + s * C::KV_BYTES + c * BK * C::ROW_BYTES, &tv, v_full(s), c * CB, hk,
                   kt * BK, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CONSUMER_REGS));
  const int wg = warp >> 2;
  if (wg >= n_wg) return;
  const int wq0 = q_start + wg * WG_ROWS;
  const int wq_last = min(wq0 + WG_ROWS, S) - 1;
  const int rA = (warp & 3) * 16 + (lane >> 2);  // the thread's rows rA, rA + 8
  const int qA = wq0 + rA, qB = qA + 8;
  const int c0 = 2 * (lane & 3);  // the thread's first column of each 8-column chunk
  const RowCtx ctx{T_len, causal, window, prefix_len, softcap, scale, scale * LOG2E,
                   wq0, wq_last, qA, qB, c0};
  const uint32_t q_wg = sQ + wg * NCB * WG_ROWS * C::ROW_BYTES;
  // the warpgroup's tiles: the block's, less a suffix whose keys all lie
  // after its last row (and outside the prefix)
  int n_mine = n_k;
  while (n_mine > 0 && causal && (kt_lo + n_mine - 1) * BK > wq_last &&
         (kt_lo + n_mine - 1) * BK >= prefix_len)
    --n_mine;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  RowState st{NEG_INF, NEG_INF, 0.f, 0.f, 1.f, 1.f};
  float sc[BK / 2];         // S of the newest tile, then its p
  uint32_t pa[BK / 16][4];  // p of the tile before it in bf16: P V's A fragments

  mbar_wait(q_full, 0);
  if (n_mine > 0) {
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_s<D>(sc, q_wg, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(0));
    online_softmax<BK>(sc, kt_lo * BK, ctx, st);
    rescale_pack<D>(o, pa, sc, st);
    // step i issues tile i's S on the tensor cores beside tile i - 1's P V,
    // runs tile i's softmax while that P V finishes, then releases tile
    // i - 1's stage.  The barrier waits come before the warpgroup fence: a
    // wgmma right after a spin would be serialised.
    for (int i = 1; i < n_mine; ++i) {
      const int s = i % ST, sp = (i - 1) % ST;
      mbar_wait(k_full(s), (i / ST) & 1);
      mbar_wait(v_full(sp), ((i - 1) / ST) & 1);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_s<D>(sc, q_wg, sK + s * C::KV_BYTES);
      wgmma_commit();
      issue_pv<D>(o, pa, sV + sp * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile i
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(s));
      online_softmax<BK>(sc, (kt_lo + i) * BK, ctx, st);
      wgmma_wait<0>();  // P V of tile i - 1
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(sp));
      rescale_pack<D>(o, pa, sc, st);
    }
    const int sl = (n_mine - 1) % ST;
    mbar_wait(v_full(sl), ((n_mine - 1) / ST) & 1);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<D>(o, pa, sV + sl * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(sl));
  }
  // tiles past this warpgroup's rows: release only, each half after its
  // load landed, so an arrival never counts toward an earlier round
  for (int i = n_mine; i < n_k; ++i) {
    mbar_wait(k_full(i % ST), (i / ST) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(i % ST));
    mbar_wait(v_full(i % ST), (i / ST) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(i % ST));
  }

  // the row sums over the quad, then out = acc / max(l, 1e-37)
  float lA = st.lA, lB = st.lB;
  lA += __shfl_xor_sync(FULL, lA, 1);
  lA += __shfl_xor_sync(FULL, lA, 2);
  lB += __shfl_xor_sync(FULL, lB, 1);
  lB += __shfl_xor_sync(FULL, lB, 2);
  const float dA = fmaxf(lA, 1e-37f), dB = fmaxf(lB, 1e-37f);
  const size_t q_stride = (size_t)Hq * D;
  __nv_bfloat16* ob = out + (size_t)b * S * q_stride + (size_t)h * D;
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int col = 8 * (j >> 2) + c0;
    const int qi = (j & 2) ? qB : qA;
    const float dn = (j & 2) ? dB : dA;
    if (qi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qi * q_stride + col) =
          __floats2bfloat162_rn(o[j] / dn, o[j + 1] / dn);
  }
}

// the map of a bf16 [Bn, L, H, D] tensor read in boxes of `rows` positions
// x one head x `cb` columns, swizzled as the wgmma descriptors expect
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int Bn, int L, int H,
              int D, int cb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)Bn};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cb, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int Hq, int Hkv, int causal, int window, int prefix_len, float softcap, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, S, Hq, D, C::CB, WG_ROWS) ||
      !make_map(encode, &tk, k, B, T_len, Hkv, D, C::CB, C::BK) ||
      !make_map(encode, &tv, v, B, T_len, Hkv, D, C::CB, C::BK))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((S + C::BQ - 1) / C::BQ) * Hq * B;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_kernel_wgmma<D><<<(unsigned)blocks, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, S, T_len, Hq, Hkv, causal, window, prefix_len, softcap,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace hop

// f32: the scalar kernel; bf16: the wgmma kernel
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int Hq, int Hkv, int D, int causal, int window,
             int prefix_len, float softcap, float scale, cudaStream_t st) {
#define FLASH_CASE(DD)                                                         \
  case DD:                                                                     \
    if constexpr (sizeof(T) == 2)                                              \
      return hop::launch<DD>(q, k, v, out, B, S, T_len, Hq, Hkv, causal,      \
                             window, prefix_len, softcap, scale, st);          \
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
