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
// tensor cores (TF32 keeps 10 mantissa bits) are not used.
//
// What the design does about that, in this first version:
// - The TPU kernel walks the chunk axis as a sequential grid dimension with
//   the state in VMEM scratch.  Here one block of 256 threads owns (b, h)
//   and loops over the chunks itself, the state held in shared memory
//   (32 KB at P = 64, N = 128).
// - The kernel's own chunk is Q = 64, whatever chunk the model asks its plain
//   version for (256 for mamba2-2.7b): f32 C, B and a 256 x 256 score tile
//   do not fit 227 KB of shared memory beside the state.  The result differs
//   from the plain version at 256 only by rounding (cum is summed over 64
//   tokens instead of 256, so exp(cum_t - cum_s) is closer to exact).
// - B and C are read per group, not broadcast to heads (the Pallas launcher
//   takes them broadcast, two [B, L, H, N] copies); any L is taken, the
//   ragged last chunk read as dt = 0, x = B = C = 0 rows (the plain
//   version's padding), where the Pallas launcher asserts L % chunk == 0.
// - The decay mask is applied before the exponential: exp(cum_t - cum_s) for
//   s > t may overflow to inf, and inf * 0 is NaN in a fused product.
// - Products are scalar f32 FMAs (explicit fmaf: the build passes
//   --fmad=false) from register micro-tiles: each thread owns rows ty + 16 i
//   and columns tx + 16 j of an output, so that with row strides padded to
//   odd lengths a warp's shared-memory reads fall in distinct banks or
//   broadcast.
// Left for later: the scores C Bᵀ are recomputed by every head of a group
// (80 times at G = 1), and no load overlaps the previous chunk's compute.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int Q = 64;  // tokens per chunk inside the kernel
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // the most shared memory a block may use on sm_90

template <int P, int N>
struct Layout {
  static constexpr int LX = P + 1;  // X [Q][LX]: x * dt of the chunk
  static constexpr int LN = N + 1;  // Bs, Cs [Q][LN]; S [P][LN]
  static constexpr int LM = Q + 1;  // M [Q][LM]: masked, decayed scores
  static constexpr int floats = Q * LX + 2 * Q * LN + P * LN + Q * LM + 4 * Q;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, int L, int H, int G) {
  using Lay = Layout<P, N>;
  constexpr int LX = Lay::LX, LN = Lay::LN, LM = Lay::LM;
  constexpr int JP = P / 16, JN = N / 16;
  extern __shared__ float smem[];
  float* Xs = smem;             // [Q][LX]
  float* Bs = Xs + Q * LX;      // [Q][LN]
  float* Cs = Bs + Q * LN;      // [Q][LN]
  float* Ss = Cs + Q * LN;      // [P][LN]
  float* Ms = Ss + P * LN;      // [Q][LM]
  float* dts = Ms + Q * LM;     // [Q] dt
  float* cum = dts + Q;         // [Q]
  float* ecum = cum + Q;        // [Q] exp(cum_t)
  float* wdec = ecum + Q;       // [Q] exp(cum_last - cum_s)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = A[h];
  const size_t row_x = (size_t)H * P;  // stride of one token in x and y
  const size_t row_bc = (size_t)G * N;  // stride of one token in B and C
  const float* xb = x + (size_t)b * L * row_x + (size_t)h * P;
  const float* dtb = dt + (size_t)b * L * H + h;
  const float* Bb = Bm + (size_t)b * L * row_bc + (size_t)g * N;
  const float* Cb = Cm + (size_t)b * L * row_bc + (size_t)g * N;
  float* yb = y + (size_t)b * L * row_x + (size_t)h * P;
  const size_t st_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS) Ss[(i / N) * LN + i % N] = 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    // ---- load the chunk (rows past L read as zeros: dt = 0 is a no-op)
    for (int t = tid; t < Q; t += THREADS)
      dts[t] = (t0 + t < L) ? dtb[(size_t)(t0 + t) * H] : 0.f;
    for (int i = tid; i < Q * P; i += THREADS) {
      const int t = i / P, p = i % P;
      Xs[t * LX + p] = (t0 + t < L) ? xb[(size_t)(t0 + t) * row_x + p] : 0.f;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int t = i / N, n = i % N;
      const bool in = t0 + t < L;
      Bs[t * LN + n] = in ? Bb[(size_t)(t0 + t) * row_bc + n] : 0.f;
      Cs[t * LN + n] = in ? Cb[(size_t)(t0 + t) * row_bc + n] : 0.f;
    }
    __syncthreads();

    // ---- fold dt into x and the decay; cum by a warp scan (2 tokens a lane)
    for (int i = tid; i < Q * P; i += THREADS) {
      const int t = i / P, p = i % P;
      Xs[t * LX + p] = Xs[t * LX + p] * dts[t];
    }
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
    __syncthreads();

    // ---- M[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float c[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * LN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          Ms[t * LM + s] = (s <= t) ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = M xd + exp(cum_t) (C stateᵀ), rows t = ty + 16 i, columns p
    {
      float diag[4][JP] = {}, off[4][JP] = {};
      for (int s = 0; s < Q; ++s) {
        float m[4], xv[JP];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = Ms[(ty + 16 * i) * LM + s];
#pragma unroll
        for (int j = 0; j < JP; ++j) xv[j] = Xs[s * LX + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JP; ++j) diag[i][j] = fmaf(m[i], xv[j], diag[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float c[4], sv[JP];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * LN + n];
#pragma unroll
        for (int j = 0; j < JP; ++j) sv[j] = Ss[(tx + 16 * j) * LN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JP; ++j) off[i][j] = fmaf(c[i], sv[j], off[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t >= L) continue;
        const float e = ecum[t];
#pragma unroll
        for (int j = 0; j < JP; ++j)
          yb[(size_t)(t0 + t) * row_x + tx + 16 * j] = diag[i][j] + e * off[i][j];
      }
    }
    __syncthreads();  // every thread has read the state entering this chunk

    // ---- state = exp(cum_last) state + (exp(cum_last - cum_s) xd_s)ᵀ B_s
    {
      float acc[JP][JN] = {};
      for (int s = 0; s < Q; ++s) {
        const float w = wdec[s];
        float xv[JP], bv[JN];
#pragma unroll
        for (int i = 0; i < JP; ++i) xv[i] = Xs[s * LX + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < JN; ++j) bv[j] = Bs[s * LN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < JP; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float e_last = ecum[Q - 1];
#pragma unroll
      for (int i = 0; i < JP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          float* sp = &Ss[(ty + 16 * i) * LN + tx + 16 * j];
          *sp = *sp * e_last + acc[i][j];
        }
    }
    __syncthreads();  // the next chunk's loads overwrite X, B and C
  }

  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    state_out[st_off + i] = Ss[p * LN + n];
  }
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* st, int B, int L, int H, int G,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<P, N>::bytes;
  static_assert(smem <= MAX_SMEM, "the chunk does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<P, N><<<dim3(H, B), THREADS, smem, stream>>>(
      x, dt, A, Bm, Cm, y, st, L, H, G);
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
// contiguous f32 on `device`; P in {32, 64, 128}, N in {16, 32, 64, 128}, H
// a multiple of G.  Launches on `stream` and returns the CUDA error code
// (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, void* state,
                            int B, int L, int H, int G, int P, int N, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || L < 1 || H < 1 || G < 1 || H % G != 0)
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
