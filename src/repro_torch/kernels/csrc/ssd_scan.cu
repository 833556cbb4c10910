// Hopper (sm_90a) Mamba-2 SSD chunked scan.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (launched
// by ssd_scan_pallas).  Per (batch row b, head h), over the sequence in
// chunks of Q tokens, with the [P, N] f32 state carried from chunk to chunk:
//
//   xd = x * dt,  dA = dt * A[h],  cum = cumsum(dA) within the chunk
//   intra-chunk  y  = (C Bᵀ ⊙ tril(exp(cum_t - cum_s))) xd
//   cross-chunk  y += exp(cum_t) (C stateᵀ)
//   state        state = exp(cum_last) state + (exp(cum_last - cum) xd)ᵀ B
//
// which is repro_torch/models/scans.py::ssd_chunked_ref (the reference's
// ssd_chunked_ref) in exact arithmetic for any chunk length.  Inputs are f32:
// x [B, L, H, P], dt [B, L, H], A [H], B and C [B, L, G, N] per group (head h
// reads group h / (H / G)); outputs y [B, L, H, P] and the final state
// [B, H, P, N], f32.  The state starts at zero, as the reference's does.
//
// What bounds it on this card: operations.  At mamba2-2.7b's prefill (B = 4,
// L = 2,048, H = 80, P = 64, N = 128, G = 1) the products take ~2.4e10 f32
// operations (counted with scores once per group) against ~357 MB of input
// and output, so 67 TFLOP/s of f32 outside the tensor cores bound it at
// ~0.36 ms and the bytes at ~0.11 ms.  The reference computes in f32, so the
// tensor cores (TF32 keeps 10 mantissa bits) are not used.  The first design
// (one 256-thread block per (b, h), ~133 KB of shared memory, scalar reads
// feeding 4x4 register tiles) read 2.64 ms on an H100: one block a SM in
// three waves, the scores C Bᵀ recomputed by every head, two shared-memory
// reads issued per two FMAs.  This one reads 1.6-1.7 ms there, bound by the
// latencies of each phase of a chunk at 16 warps a SM.
//
// What the design does about that:
// - Rows of y and of the state split by head dimension: y[:, p] and
//   state[p, :] depend only on x[:, p], so a block owns (b, h, a slice of 32
//   of the P columns) and walks the chunks itself, the state slice in shared
//   memory.  256 threads and 105 KB a block (N = 128): two blocks and 16
//   warps a SM, and 640 blocks at mamba2-2.7b, ~4.8 a SM, where the waves
//   lose little.  (128 threads a block, with twice the tile a thread, ran
//   1.23x slower: 8 warps a SM left the latencies of each phase exposed.)
// - The scores C Bᵀ depend on (b, group, chunk) only, and are computed once
//   per thread block cluster of up to 8 blocks of the same group (heads and
//   slices; 4 heads at mamba2-2.7b, where every head computed them): each
//   block computes every 8th column s (the causal part, t >= s) and stores it
//   into every block's score tile through distributed shared memory; a
//   cluster barrier publishes them, a second one (split into arrive and wait
//   around the rest of the chunk) keeps the next chunk's stores from landing
//   before every block has read the tile.  The decay exp(cum_t - cum_s) is
//   per head, so each block applies its own, masked before the exponential
//   (exp(cum_t - cum_s) for s > t may overflow to inf, and inf * 0 is NaN).
// - Every product is a register tile fed by 8- and 16-byte shared-memory
//   reads: y 4 t x 2 p, the state 4 p x 4 n, a score column 2 t; operands
//   stored in the order their tiles read them (C transposed), with the
//   16-byte quads of a row permuted by an XOR of the row so that a quarter
//   warp's reads and stores fall in distinct banks or broadcast.  Products
//   are explicit fmaf (the build passes --fmad=false); the state's decay
//   weights exp(cum_last - cum_s) are folded into B once a chunk.
// - Loads overlap compute: the next chunk's C and dt are read into
//   registers before the state update and stored after it; its B and x are
//   copied with cp.async while its first phase (the cumulative decay and
//   C stateᵀ, which need neither) runs.  The causal half of the intra-chunk
//   product is skipped a warp at a time.
// - The kernel's own chunk is Q = 64, whatever chunk the model asks its plain
//   version for (256 for mamba2-2.7b): the result differs from the plain
//   version at 256 only by rounding (cum is summed over 64 tokens instead of
//   256, so exp(cum_t - cum_s) is closer to exact).
// - B and C are read per group, not broadcast to heads (the Pallas launcher
//   takes them broadcast, two [B, L, H, N] copies); any L is taken, the
//   ragged last chunk read as dt = 0, x = B = C = 0 rows (the plain
//   version's padding), where the Pallas launcher asserts L % chunk == 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int Q = 64;  // tokens per chunk inside the kernel
constexpr int PS = 32;  // head-dimension columns a block owns
constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 232448;  // the most shared memory a block may use on sm_90

// The block's shared memory, in floats: Ct [N][Q] (C transposed), Bs [Q][N],
// Xs [Q][PS] (x * dt), St [N][PS] (the state slice, transposed), Mt [Q][Q]
// (the masked, decayed scores, transposed: Mt[s][t]), then dt, cum,
// exp(cum_t) and exp(cum_last - cum_s), Q each.
template <int N>
struct Layout {
  static constexpr int CT = 0;
  static constexpr int BS = CT + N * Q;
  static constexpr int XS = BS + Q * N;
  static constexpr int ST = XS + Q * PS;
  static constexpr int MT = ST + N * PS;
  static constexpr int DT = MT + Q * Q;
  static constexpr int floats = DT + 4 * Q;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// Where a 16-byte quad of each operand lies: the quads of a row permuted by
// an XOR of the row, so that the quarter warps' patterns below hit distinct
// banks.  Ct row n, quad tq (t = 4 tq..4 tq + 3):
__device__ __forceinline__ int ct_at(int n, int tq) { return n * Q + ((tq ^ ((n >> 2) & 7)) << 2); }
// Bs row s, quad nq:
template <int N>
__device__ __forceinline__ int bs_at(int s, int nq) {
  constexpr int mask = N / 4 >= 8 ? 7 : N / 4 - 1;
  return s * N + ((nq ^ ((s >> 3) & mask)) << 2);
}
// St row n, quad pq:
__device__ __forceinline__ int st_at(int n, int pq) { return n * PS + ((pq ^ ((n >> 2) & 7)) << 2); }

__device__ __forceinline__ float& lane_of(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the cluster barrier, split: arrive (releasing this thread's stores to
// other blocks' shared memory) and wait (acquiring theirs)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Blocks a SM that the register budget must allow: two (<= 128 registers a
// thread) where the state is wide; the narrow states (N <= 32, the smoke
// model's widths) keep ptxas' own choice
template <int N>
struct MinBlocks {
  static constexpr int value = N >= 64 ? 2 : 1;
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS, MinBlocks<N>::value)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, int L, int H, int G, int CL) {
  using Lay = Layout<N>;
  constexpr int SL = P / PS;  // slices of a head
  constexpr int NQ = N / 4;   // quads of a B or C row
  // the C chunk in registers: (t quad, n quad) tiles of 4 x 4, CPT a thread
  constexpr int CTILES = (Q / 4) * NQ;
  constexpr int CPT = (CTILES + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem + Lay::CT;
  float* Bs = smem + Lay::BS;
  float* Xs = smem + Lay::XS;
  float* St = smem + Lay::ST;
  float* Mt = smem + Lay::MT;
  float* dts = smem + Lay::DT;
  float* cum = dts + Q;
  float* ecum = cum + Q;
  float* wdec = ecum + Q;

  const int tid = threadIdx.x;
  const int h = blockIdx.x / SL, slice = blockIdx.x % SL, b = blockIdx.y;
  const int g = h / (H / G);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const float a_h = A[h];
  const size_t row_x = (size_t)H * P;   // stride of one token in x and y
  const size_t row_bc = (size_t)G * N;  // stride of one token in B and C
  const float* xb = x + (size_t)b * L * row_x + (size_t)h * P + slice * PS;
  const float* dtb = dt + (size_t)b * L * H + h;
  const float* Bb = Bm + (size_t)b * L * row_bc + (size_t)g * N;
  const float* Cb = Cm + (size_t)b * L * row_bc + (size_t)g * N;
  float* yb = y + (size_t)b * L * row_x + (size_t)h * P + slice * PS;

  for (int i = tid; i < N * PS; i += THREADS) St[i] = 0.f;

  // B and x of the chunk at t0 (dt is folded in later), copied
  // asynchronously; rows past L read as zeros
  auto load_async = [&](int t0) {
    for (int i = tid; i < Q * NQ; i += THREADS) {
      const int s = i / NQ, nq = i % NQ;
      const bool in = t0 + s < L;
      cp_async16(Bs + bs_at<N>(s, nq), in ? Bb + (size_t)(t0 + s) * row_bc + 4 * nq : Bb,
                 in ? 16 : 0);
    }
    for (int i = tid; i < Q * (PS / 4); i += THREADS) {
      const int s = i / (PS / 4), pq = i % (PS / 4);
      const bool in = t0 + s < L;
      cp_async16(Xs + s * PS + 4 * pq, in ? xb + (size_t)(t0 + s) * row_x + 4 * pq : xb,
                 in ? 16 : 0);
    }
  };
  // C of the chunk at t0 into registers, 4 rows of a tile at a time
  float4 creg[CPT][4];
  auto load_c = [&](int t0) {
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int i = tid + m * THREADS;
      if (i < CTILES) {
        const int nq = i % NQ, tq = i / NQ;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + 4 * tq + k;
          creg[m][k] = t < L ? *(const float4*)(Cb + (size_t)t * row_bc + 4 * nq)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  };
  // ... and from registers into Ct, transposed
  auto store_c = [&]() {
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int i = tid + m * THREADS;
      if (i < CTILES) {
        const int nq = i % NQ, tq = i / NQ;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *(float4*)(Ct + ct_at(4 * nq + j, tq)) =
              make_float4(lane_of(creg[m][0], j), lane_of(creg[m][1], j),
                          lane_of(creg[m][2], j), lane_of(creg[m][3], j));
      }
    }
  };

  // every block of the cluster has started before any stores into another's
  // shared memory
  cluster_arrive();
  cluster_wait();
  load_c(0);
  load_async(0);
  store_c();
  if (tid < Q) dts[tid] = tid < L ? dtb[(size_t)tid * H] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int nc = (L + Q - 1) / Q;
  const int tg = tid >> 4, pp = tid & 15;  // y's tile: rows 4 tg.., columns 2 pp, 2 pp + 1
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    // ---- 1. cum by a warp scan (2 tokens a lane); the cross-chunk term
    // C stateᵀ of the state entering the chunk; B and x of the chunk arrive
    if (tid < 32) {
      const float d0 = dts[2 * tid] * a_h, d1 = dts[2 * tid + 1] * a_h;
      const float pair = d0 + d1;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + d0, c1 = excl + pair;
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      wdec[2 * tid] = expf(last - c0);
      wdec[2 * tid + 1] = expf(last - c1);
    }
    float off[4][2] = {};
    for (int n4 = 0; n4 < N / 4; ++n4) {
      const float* cq = Ct + 4 * n4 * Q + ((tg ^ (n4 & 7)) << 2);
      const float* sq = St + 4 * n4 * PS + (((pp >> 1) ^ (n4 & 7)) << 2) + 2 * (pp & 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 cv = *(const float4*)(cq + u * Q);
        const float2 sv = *(const float2*)(sq + u * PS);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          off[i][0] = fmaf(lane_of(cv, i), sv.x, off[i][0]);
          off[i][1] = fmaf(lane_of(cv, i), sv.y, off[i][1]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // cum; B and x of the chunk; every read of St done

    // ---- 2. this block's score columns s = rank, rank + CL, ...: C_t . B_s
    // for t >= s, into every block's Mt (once each block has read the last)
    if (c > 0) cluster_wait();
    for (int i = tid; i < (Q / CL) * 32; i += THREADS) {
      // column s, rows t = 2 tp, 2 tp + 1 (a warp shares s)
      const int s = rank + CL * (i >> 5), tp = i & 31;
      float2 acc = make_float2(0.f, 0.f);
      if (2 * tp + 1 >= s) {
        constexpr int mask = N / 4 >= 8 ? 7 : N / 4 - 1;
        const float* brow = Bs + s * N;
        const int bsw = (s >> 3) & mask;
        for (int n4 = 0; n4 < N / 4; ++n4) {
          const float4 bv = *(const float4*)(brow + ((n4 ^ bsw) << 2));
          const float* cq = Ct + 4 * n4 * Q + (((tp >> 1) ^ (n4 & 7)) << 2) + 2 * (tp & 1);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 cv = *(const float2*)(cq + u * Q);
            const float b = lane_of(bv, u);
            acc.x = fmaf(cv.x, b, acc.x);
            acc.y = fmaf(cv.y, b, acc.y);
          }
        }
      }
      for (int r = 0; r < CL; ++r)
        *(float2*)(cluster.map_shared_rank(Mt, r) + s * Q + 2 * tp) = acc;
    }
    cluster_arrive();
    cluster_wait();

    // ---- 3. this head's decay, masked before the exponential; x * dt; the
    // state's decay weights into B; the next chunk's C and dt into registers
#pragma unroll 2
    for (int qi = tid; qi < Q * 16; qi += THREADS) {
      const int s = qi >> 4, tq = qi & 15;
      float4* mp = (float4*)(Mt + s * Q + 4 * tq);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * tq + 3 >= s) {
        v = *mp;
        const float cs = cum[s];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = 4 * tq + k;
          lane_of(v, k) = t >= s ? lane_of(v, k) * expf(cum[t] - cs) : 0.f;
        }
      }
      *mp = v;
    }
    for (int i = tid; i < Q * (PS / 4); i += THREADS) {
      float4* px = (float4*)(Xs + 4 * i);
      const float d = dts[i / (PS / 4)];
      float4 v = *px;
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      *px = v;
    }
    for (int i = tid; i < Q * NQ; i += THREADS) {
      const int s = i / NQ;
      float4* pb = (float4*)(Bs + bs_at<N>(s, i % NQ));
      const float w = wdec[s];
      float4 v = *pb;
      v.x *= w;
      v.y *= w;
      v.z *= w;
      v.w *= w;
      *pb = v;
    }
    const bool more = c + 1 < nc;
    float dt_next = 0.f;
    if (more) {
      load_c(t0 + Q);
      if (tid < Q && t0 + Q + tid < L) dt_next = dtb[(size_t)(t0 + Q + tid) * H];
    }
    __syncthreads();

    // ---- 4. state = exp(cum_last) state + xdᵀ (exp(cum_last - cum_s) B_s)
    if (tid < 8 * NQ) {
      // the tile 4 p x 4 n: p quad pq, n quad nq (a warp shares pq)
      constexpr int mask = N / 4 >= 8 ? 7 : N / 4 - 1;
      const int nq = tid % NQ, pq = tid / NQ;
      float acc[4][4] = {};
      for (int s8 = 0; s8 < Q / 8; ++s8) {
        const float* bq = Bs + 8 * s8 * N + ((nq ^ (s8 & mask)) << 2);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 xv = *(const float4*)(Xs + (8 * s8 + u) * PS + 4 * pq);
          const float4 bv = *(const float4*)(bq + u * N);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[i][k] = fmaf(lane_of(xv, i), lane_of(bv, k), acc[i][k]);
        }
      }
      const float e_last = ecum[Q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4* sp = (float4*)(St + st_at(4 * nq + k, pq));
        float4 v = *sp;
#pragma unroll
        for (int i = 0; i < 4; ++i) lane_of(v, i) = lane_of(v, i) * e_last + acc[i][k];
        *sp = v;
      }
    }
    // ---- ... and y = M xd + exp(cum_t) C stateᵀ, rows t = 4 tg.., columns
    // 2 pp, 2 pp + 1; M is zero past the diagonal, so a warp stops at its
    // last row
    {
      float d[4][2] = {};
      const int s_end = 8 * (tid >> 5) + 8;
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        const float4 mv = *(const float4*)(Mt + s * Q + 4 * tg);
        const float2 xv = *(const float2*)(Xs + s * PS + 2 * pp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i][0] = fmaf(lane_of(mv, i), xv.x, d[i][0]);
          d[i][1] = fmaf(lane_of(mv, i), xv.y, d[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tg + i;
        if (t0 + t >= L) continue;
        const float e = ecum[t];
        *(float2*)(yb + (size_t)(t0 + t) * row_x + 2 * pp) =
            make_float2(d[i][0] + e * off[i][0], d[i][1] + e * off[i][1]);
      }
    }
    cluster_arrive();  // this block is done with Mt
    __syncthreads();   // ... and with Bs, Xs, dts and Ct

    // ---- 5. the next chunk's B and x, copied while its first phase runs;
    // its C and dt from registers
    if (more) {
      load_async(t0 + Q);
      store_c();
      if (tid < Q) dts[tid] = dt_next;
    }
    __syncthreads();
  }
  cluster_wait();  // the last chunk's phase: no block stores into Mt past it

  for (int i = tid; i < PS * N; i += THREADS) {
    const int p = i / N, n = i % N;
    state_out[((size_t)b * H + h) * P * N + (size_t)(slice * PS + p) * N + n] =
        St[st_at(n, p >> 2) + (p & 3)];
  }
}

// the cluster size: the most blocks (up to 8) that divides a group's blocks
int cluster_size(int per_group) {
  int cl = MAX_CLUSTER;
  while (per_group % cl) cl >>= 1;
  return cl;
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* st, int B, int L, int H, int G,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<N>::bytes;
  static_assert(smem <= MAX_SMEM, "the chunk does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int SL = P / PS;
  const int CL = cluster_size((H / G) * SL);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * SL, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_scan_kernel<P, N>, x, dt, A, Bm, Cm, y, st, L, H, G, CL);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, float* y, float* st, int B, int L, int H,
               int G, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch<P, 16>(x, dt, A, Bm, Cm, y, st, B, L, H, G, s);
    case 32: return launch<P, 32>(x, dt, A, Bm, Cm, y, st, B, L, H, G, s);
    case 64: return launch<P, 64>(x, dt, A, Bm, Cm, y, st, B, L, H, G, s);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, y, st, B, L, H, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  x [B, L, H, P], dt [B, L, H], A [H],
// Bm and Cm [B, L, G, N], y [B, L, H, P] and state [B, H, P, N]:
// contiguous f32 on `device`, x, Bm, Cm and y 16-byte aligned; P in {32, 64,
// 128}, N in {16, 32, 64, 128}, H a multiple of G.  Launches on `stream` and
// returns the CUDA error code (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, void* state,
                            int B, int L, int H, int G, int P, int N, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto misaligned = [](const void* p) { return ((size_t)p & 15) != 0; };
  if (B < 1 || B > 65535 || L < 1 || H < 1 || G < 1 || H % G != 0 || misaligned(x) ||
      misaligned(Bm) || misaligned(Cm) || misaligned(y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *dtf = (const float*)dt, *Af = (const float*)A,
              *Bf = (const float*)Bm, *Cf = (const float*)Cm;
  float *yf = (float*)y, *sf = (float*)state;
  switch (P) {
    case 32: return dispatch_n<32>(xf, dtf, Af, Bf, Cf, yf, sf, B, L, H, G, N, s);
    case 64: return dispatch_n<64>(xf, dtf, Af, Bf, Cf, yf, sf, B, L, H, G, N, s);
    case 128: return dispatch_n<128>(xf, dtf, Af, Bf, Cf, yf, sf, B, L, H, G, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
