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
// in bf16: ~17 MB, 5.2 us at 3.35 TB/s; recurrentgemma-9b's full 2,048-slot
// ring at Hkv = 1, D = 256: 8.4 MB, 2.5 us), against ~2 FLOP per byte.
//
// What the design does about that: the TPU grid is (B, Hkv, T-chunks) with
// the chunk axis sequential and the G grouped query rows resident.  Here
// the work is split FlashDecoding-style into (split, kv head x 16-row group
// of its G query heads, b) blocks of 128 threads, `nsplit` splits chosen by
// the wrapper to fill the card, and a second kernel combines the splits.
// A split covers an equal share of the 64-key tiles that hold a valid
// position (below cache_len, inside the window), so no block reads a tile
// of invalid positions and the splits stay balanced whatever cache_len is.
//
// bf16 (the serving path), redesigned after the first version staged each
// tile as f32 in shared memory (row stride D + 1, one 2-byte load at a
// time), ran scalar score and P·V loops with the accumulator in shared
// memory, and combined on B * Hkv blocks (4 at recurrentgemma, 126 of its
// 188 us):
// - K and V tiles [64 keys][D] stay bf16 and arrive by cp.async in 16-byte
//   vectors (positions outside the valid range zero-filled, not read) into
//   a ring of ST = 3 stages (2 at D > 128; rows padded by 16 bytes, so the
//   ldmatrix reads below are conflict-free); the copies of the next ST - 1
//   tiles are in flight while the current one is used.
// - Each warp owns 16 keys of every tile and keeps its own running maximum,
//   sum and accumulator in registers: the 16 query rows (G padded to 16;
//   exactly 16 at recurrentgemma, 4 at llama) against the warp's keys are
//   one mma.sync m16n8k16 chain per 8 keys (Q and K by ldmatrix), the
//   online softmax runs on the accumulator registers (quad shuffles), and
//   P·V takes p in bf16 straight from those registers as the A fragment,
//   V by ldmatrix.trans.  Exponentials are ex2.approx with scale * log2(e)
//   folded in, so the partial maxima are in the log2 domain.  At the end
//   the four warps merge in shared memory and the block writes one (m, l,
//   acc) partial.
// - The combine runs on (64-column slice, query head, b) blocks: 16 lanes
//   of 4 columns (16-byte loads) times 8 groups of splits, merged in shared
//   memory.
// f32 (the tests' precision) keeps the first version's split kernel:
// 128 threads per (b, kv head, split) with the G query rows in shared
// memory, tiles staged as f32 with row stride D + 1, scalar FMAs; its
// partial maxima are in the natural-log domain.  It shares the combine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;  // query rows of a bf16 block: one m16 tile
constexpr float LOG2E = 1.4426950408889634f;

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

// f32: one (kv head, batch row, split): partial m, l [G] and acc [G, D] of
// the split's tiles (m in the natural-log domain), written to part_m/part_l [B, Hkv, nsplit, G] and
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


// ---------------------------------------------------------------------------
// bf16: the split kernel on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;  // row stride in elements: 16 bytes of pad
  static constexpr int ST = D <= 128 ? 3 : 2;
  static constexpr int TILE = BK * LD;  // elements of one K or V tile
  static constexpr int SMEM = 2 * (ROWS * LD + 2 * ST * TILE);
  // the warps' partials, merged after the loop in the same memory
  static constexpr int MERGE = 4 * (WARPS * ROWS * D + 2 * WARPS * ROWS);
  static_assert(MERGE <= SMEM, "the merge does not fit the ring");
  static_assert(SMEM <= MAX_SMEM, "the ring does not fit shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// One (split, kv head x row group, batch row): partial m (log2 domain), l
// and acc of the split's tiles for the group's (up to) 16 query rows,
// written to part_m/part_l [B, Hkv, nsplit, G] and part_acc
// [B, Hkv, nsplit, G, D].
template <int D>
__global__ void __launch_bounds__(THREADS)
decode_split_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int T_len, int Hq, int Hkv, int window,
                 float softcap, float scale, int ngroups) {
  using C = Cfg<D>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = C::LD, ST = C::ST, CH = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* Ks = Qs + ROWS * LD;                      // [ST][BK][LD]
  bf16* Vs = Ks + ST * C::TILE;                   // [ST][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hk = blockIdx.y / ngroups, g0 = (blockIdx.y % ngroups) * ROWS;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int rows = min(ROWS, G - g0);
  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* qb = q + ((size_t)b * Hq + (size_t)hk * G + g0) * D;
  const bf16* kb = k + (size_t)b * T_len * kv_stride + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * T_len * kv_stride + (size_t)hk * D;

  // the valid positions [lo, len), their tiles spread evenly over the splits
  const int len = max(0, min(cache_len[b], T_len));
  const int lo = window > 0 ? max(0, len - window) : 0;
  int t0 = 0, n_t = 0;
  if (len > lo) {
    const int first = lo / BK, n_valid = (len - 1) / BK - first + 1;
    const int tps = (n_valid + nsplit - 1) / nsplit;
    t0 = first + split * tps;
    n_t = max(0, min(tps, first + n_valid - t0));
  }

  auto load_tile = [&](int t, int st) {
    bf16* ks = Ks + st * C::TILE;
    bf16* vs = Vs + st * C::TILE;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const int pos = t * BK + r;
      const bool in = pos >= lo && pos < len;
      const size_t off = (size_t)(in ? pos : lo) * kv_stride + c;
      cp_async16(ks + r * LD + c, kb + off, in ? 16 : 0);
      cp_async16(vs + r * LD + c, vb + off, in ? 16 : 0);
    }
  };

  // group 0: Q and the first tile; then the next ST - 2 tiles
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(Qs + r * LD + c, qb + (r < rows ? r : 0) * D + c, r < rows ? 16 : 0);
  }
  if (n_t > 0) load_tile(t0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < ST - 1; ++s) {
    if (s < n_t) load_tile(t0 + s, s);
    cp_async_commit();
  }

  // this thread's rows gA, gA + 8 and, in each 8-key chunk, keys c0, c0 + 1
  const int gA = lane >> 2, c0 = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;

  for (int i = 0; i < n_t; ++i) {
    if (i + ST - 1 < n_t) load_tile(t0 + i + ST - 1, (i + ST - 1) % ST);
    cp_async_commit();
    cp_async_wait<ST - 1>();  // tile i (and Q) has landed
    __syncthreads();

    const bf16* ks = Ks + (i % ST) * C::TILE + 16 * warp * LD;
    const bf16* vs = Vs + (i % ST) * C::TILE + 16 * warp * LD;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, Qs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * kk + 8 * (lane >> 4));
      ldmatrix_x4(bk, ks + ((lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk + 8 * ((lane >> 3) & 1));
      mma16816(s[0], a, bk[0], bk[1]);
      mma16816(s[1], a, bk[2], bk[3]);
    }

    // scale, soft-cap, mask, online softmax: s[n][e] is row gA + 8 (e / 2),
    // position t * BK + 16 warp + 8 n + c0 + e % 2
    const int pos0 = (t0 + i) * BK + 16 * warp + c0;
    float tA = -INFINITY, tB = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + 8 * n + (e & 1);
        float y;
        if (softcap > 0.f) {
          const float x = s[n][e] * scale;
          y = (softcap * tanhf(x / softcap)) * LOG2E;
        } else {
          y = s[n][e] * sl2;
        }
        y = pos >= T_len ? -INFINITY : (pos >= lo && pos < len ? y : NEG_INF);
        s[n][e] = y;
        if (e & 2) tB = fmaxf(tB, y);
        else tA = fmaxf(tA, y);
      }
    tA = fmaxf(tA, __shfl_xor_sync(FULL, tA, 1));
    tA = fmaxf(tA, __shfl_xor_sync(FULL, tA, 2));
    tB = fmaxf(tB, __shfl_xor_sync(FULL, tB, 1));
    tB = fmaxf(tB, __shfl_xor_sync(FULL, tB, 2));
    const float nA = fmaxf(mA, tA), nB = fmaxf(mB, tB);
    const float corrA = ex2(mA - nA), corrB = ex2(mB - nB);
    mA = nA;
    mB = nB;
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ex2(s[n][e] - ((e & 2) ? nB : nA));
    lA = lA * corrA + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    lB = lB * corrB + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= (j & 2) ? corrB : corrA;
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * nd +
                                8 * (lane >> 4));
      mma16816(o + 8 * nd, pa, bv[0], bv[1]);
      mma16816(o + 8 * nd + 4, pa, bv[2], bv[3]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  lA += __shfl_xor_sync(FULL, lA, 1);
  lA += __shfl_xor_sync(FULL, lA, 2);
  lB += __shfl_xor_sync(FULL, lB, 1);
  lB += __shfl_xor_sync(FULL, lB, 2);

  // merge the four warps' partials in the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(smem_raw);  // [WARPS][ROWS]
  float* Lw = Mw + WARPS * ROWS;                    // [WARPS][ROWS]
  float* Aw = Lw + WARPS * ROWS;                    // [WARPS][ROWS][D]
  if ((lane & 3) == 0) {
    Mw[warp * ROWS + gA] = mA;
    Mw[warp * ROWS + gA + 8] = mB;
    Lw[warp * ROWS + gA] = lA;
    Lw[warp * ROWS + gA + 8] = lB;
  }
  float* aw = Aw + warp * ROWS * D;
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int col = 8 * (j >> 2) + c0, row = (j & 2) ? gA + 8 : gA;
    *reinterpret_cast<float2*>(aw + row * D + col) = make_float2(o[j], o[j + 1]);
  }
  __syncthreads();
  const size_t prow = ((size_t)b * Hkv + hk) * nsplit + split;  // [B, Hkv, nsplit]
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, Mw[w * ROWS + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(Mw[w * ROWS + r] - m);
      l += Lw[w * ROWS + r] * f;
      a += Aw[(w * ROWS + r) * D + d] * f;
    }
    const size_t row = prow * G + g0 + r;
    part_acc[row * D + d] = a;
    if (d == 0) {
      part_m[row] = m;
      part_l[row] = l;
    }
  }
}

// out[b, h] = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-37), w_s = e^(m_s - m)
// (2^(m_s - m) with LOG2): one block per (64-column slice, query head, b);
// lane j of each 16-lane group holds 4 columns, the 8 groups take every 8th
// split and merge in shared memory
template <typename T, bool LOG2>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out, int Hq, int Hkv,
                      int D, int nsplit) {
  constexpr int GROUPS = THREADS / 16;
  __shared__ float sm[GROUPS], sl[GROUPS];
  __shared__ float4 sa[GROUPS][16];
  const int G = Hq / Hkv, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G, g = h % G;
  const int j = threadIdx.x & 15, grp = threadIdx.x >> 4;
  const int d = blockIdx.x * 64 + 4 * j;
  const bool live = d < D;
  auto e = [](float x) { return LOG2 ? exp2f(x) : expf(x); };
  const size_t row0 = ((size_t)b * Hkv + hk) * nsplit;
  float m = NEG_INF, l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = grp; s < nsplit; s += GROUPS) {
    const size_t r = (row0 + s) * G + g;
    const float ms = part_m[r], mn = fmaxf(m, ms);
    const float fo = e(m - mn), fn = e(ms - mn);
    l = l * fo + part_l[r] * fn;
    if (live) {
      const float4 x = *reinterpret_cast<const float4*>(part_acc + r * D + d);
      a = make_float4(a.x * fo + x.x * fn, a.y * fo + x.y * fn, a.z * fo + x.z * fn,
                      a.w * fo + x.w * fn);
    }
    m = mn;
  }
  if (j == 0) {
    sm[grp] = m;
    sl[grp] = l;
  }
  sa[grp][j] = a;
  __syncthreads();
  if (grp != 0 || !live) return;
  float M = NEG_INF;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) M = fmaxf(M, sm[k]);
  float L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const float f = e(sm[k] - M);
    L += sl[k] * f;
    const float4 x = sa[k][j];
    A = make_float4(A.x + x.x * f, A.y + x.y * f, A.z + x.z * f, A.w + x.w * f);
  }
  L = fmaxf(L, 1e-37f);
  T* ob = out + ((size_t)b * Hq + h) * D + d;
  ob[0] = from_f32<T>(A.x / L);
  ob[1] = from_f32<T>(A.y / L);
  ob[2] = from_f32<T>(A.z / L);
  ob[3] = from_f32<T>(A.w / L);
}

// the three partial arrays in the scratch, acc first (16-byte aligned)
struct Parts {
  float *acc, *m, *l;
};
Parts parts(float* scratch, int B, int Hkv, int G, int D, int nsplit) {
  const size_t rows = (size_t)B * Hkv * nsplit * G;
  return Parts{scratch, scratch + rows * D, scratch + rows * D + rows};
}

template <typename T, bool LOG2>
int launch_combine(const Parts& p, void* out, int B, int Hq, int Hkv, int D, int nsplit,
                   cudaStream_t stream) {
  decode_combine_kernel<T, LOG2><<<dim3((D + 63) / 64, Hq, B), THREADS, 0, stream>>>(
      p.m, p.l, p.acc, (T*)out, Hq, Hkv, D, nsplit);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const int* cache_len, void* out,
               float* scratch, int B, int T_len, int Hq, int Hkv, int D, int window,
               float softcap, float scale, int nsplit, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T_len + BK - 1) / BK;
  const int tps = (n_tiles + nsplit - 1) / nsplit;
  const Parts p = parts(scratch, B, Hkv, G, D, nsplit);
  decode_split_kernel<float><<<dim3(Hkv, B, nsplit), THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cache_len, p.m, p.l, p.acc, T_len,
      Hq, Hkv, D, window, softcap, scale, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<float, false>(p, out, B, Hq, Hkv, D, nsplit, stream);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const int* cache_len, void* out,
                float* scratch, int B, int T_len, int Hq, int Hkv, int window, float softcap,
                float scale, int nsplit, cudaStream_t stream) {
  using C = Cfg<D>;
  const int G = Hq / Hkv, ngroups = (G + ROWS - 1) / ROWS;
  if ((long long)Hkv * ngroups > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Parts p = parts(scratch, B, Hkv, G, D, nsplit);
  decode_split_mma<D><<<dim3(nsplit, Hkv * ngroups, B), THREADS, C::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, cache_len,
      p.m, p.l, p.acc, T_len, Hq, Hkv, window, softcap, scale, ngroups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<__nv_bfloat16, true>(p, out, B, Hq, Hkv, D, nsplit, stream);
}

int dispatch_bf16(const void* q, const void* k, const void* v, const int* cache_len, void* out,
                  float* scratch, int B, int T_len, int Hq, int Hkv, int D, int window,
                  float softcap, float scale, int nsplit, cudaStream_t st) {
#define DECODE_CASE(DD) \
  case DD:              \
    return launch_bf16<DD>(q, k, v, cache_len, out, scratch, B, T_len, Hq, Hkv, window, \
                           softcap, scale, nsplit, st);
  switch (D) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(96)
    DECODE_CASE(128)
    DECODE_CASE(160)
    DECODE_CASE(192)
    DECODE_CASE(224)
    DECODE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace

// Plain C entry, bound with ctypes.  q [B, Hq, D], k_cache and v_cache
// [B, T, Hkv, D], out [B, Hq, D]: contiguous, of one type (dtype 0 = f32,
// 1 = bf16; bf16 pointers 16-byte aligned); cache_len [B] int32; scratch f32
// of B*Hkv*nsplit*G*(D + 2) floats (16-byte aligned); all on `device`.  D a
// multiple of 32 up to 256, Hq a multiple of Hkv, 1 <= nsplit <= ceil(T / 64).
// Launches the split and combine kernels on `stream` and returns the CUDA
// error code (0 = ok).
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
      Hkv > 65535 || B > 65535 || Hq > 65535 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k_cache, v_cache, (const int*)cache_len, out, (float*)scratch, B,
                      T_len, Hq, Hkv, D, window, softcap, scale, nsplit, st);
  if (dtype == 1)
    return dispatch_bf16(q, k_cache, v_cache, (const int*)cache_len, out, (float*)scratch, B,
                         T_len, Hq, Hkv, D, window, softcap, scale, nsplit, st);
  return (int)cudaErrorInvalidValue;
}
