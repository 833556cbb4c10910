// The fused draws of the event-loop kernels (faas_event_step.cu's f32
// FUSED paths, scan_event_step.cu's f64 FUSED path): the bitstream of
// repro_torch/core/drawplan.py.  Draw k of a row with key (k0, k1) is
// threefry-2x32 of the counter (k, 0), 20 rounds with rotations
// (13, 15, 26, 6) / (17, 29, 16, 24) and parity 0x1BD11BDA; each output
// word becomes a [0, 1) f32 uniform by filling the mantissa of 1.0 with its
// top 23 bits and subtracting 1; a sample is the inverse CDF or Box-Muller
// transform of the two uniforms in the parameters' type (the f32 uniforms
// cast up for f64), clamped at 1e-9.  The transforms call the same libm
// functions in the same order as drawplan.sample_dist, each operation
// rounded once (the kernels are built with --fmad=false).

#pragma once

#include <cmath>
#include <cuda_runtime.h>

namespace threefry {

// fused distribution ids (repro_torch/core/drawplan.py FUSED_DISTS)
enum Dist { D_EXP = 0, D_DET, D_GAUSS, D_WEIBULL, D_LOGNORM, D_PARETO, N_DISTS };

// four threefry rounds with rotations R0..R3
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(unsigned& x0, unsigned& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3); x1 ^= x0;
}

// threefry-2x32, 20 rounds, of the counter (c0, 0) under key (k0, k1): five
// blocks of four rounds, after block b the key words (b+1)%3 and (b+2)%3 and
// the block number b+1 injected
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1, unsigned c0,
                                             unsigned& o0, unsigned& o1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  unsigned x0 = c0 + k0, x1 = k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

// a [0, 1) uniform from a word: its top 23 bits fill the mantissa of 1.0
__device__ __forceinline__ float uniform_from_bits(unsigned b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.f);
}

__device__ __forceinline__ float box_muller(float u0, float u1) {
  const float r = sqrtf(__fmul_rn(-2.f, logf(__fsub_rn(1.f, u0))));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831855f, u1)));
}

// one f32 sample by inverse CDF or Box-Muller, as drawplan.sample_dist
__device__ __forceinline__ float sample_dist(int kind, float u0, float u1, float p0,
                                             float p1) {
  float out;
  switch (kind) {
    case D_EXP: out = __fdiv_rn(-logf(__fsub_rn(1.f, u0)), p0); break;
    case D_DET: out = p0; break;
    case D_GAUSS: out = __fadd_rn(p0, __fmul_rn(p1, box_muller(u0, u1))); break;
    case D_WEIBULL:
      out = __fmul_rn(p1, powf(-logf(__fsub_rn(1.f, u0)), __fdiv_rn(1.f, p0)));
      break;
    case D_LOGNORM: out = expf(__fadd_rn(p0, __fmul_rn(p1, box_muller(u0, u1)))); break;
    default: out = __fdiv_rn(p1, powf(__fsub_rn(1.f, u0), __fdiv_rn(1.f, p0))); break;
  }
  return fmaxf(out, 1e-9f);
}

__device__ __forceinline__ double box_muller64(double u0, double u1) {
  const double r = sqrt(-2.0 * log(1.0 - u0));
  return r * cos(6.283185307179586 * u1);
}

// one f64 sample, as drawplan.sample_dist with f64 parameters (the f64
// engine's fused draws): the f32 uniforms are cast up first
__device__ __forceinline__ double sample_dist64(int kind, float u0f, float u1f, double p0,
                                                double p1) {
  const double u0 = (double)u0f, u1 = (double)u1f;
  double out;
  switch (kind) {
    case D_EXP: out = -log(1.0 - u0) / p0; break;
    case D_DET: out = p0; break;
    case D_GAUSS: out = p0 + p1 * box_muller64(u0, u1); break;
    case D_WEIBULL: out = p1 * pow(-log(1.0 - u0), 1.0 / p0); break;
    case D_LOGNORM: out = exp(p0 + p1 * box_muller64(u0, u1)); break;
    default: out = p1 / pow(1.0 - u0, 1.0 / p0); break;
  }
  return fmax(out, 1e-9);
}

}  // namespace threefry
