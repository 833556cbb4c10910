// The arithmetic contract that flash_attention.cu (prefill) and
// decode_attention.cu (decode) share: the finite mask value and where a
// score's probability p is rounded to v's type before the P·V product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the reference's mask value (repro/models/attention.py NEG_INF); finite,
// so a fully masked tile gives p = exp(0) = 1, wiped out by the next
// tile's corr = exp(NEG_INF - m) = 0, where -inf would give NaN
constexpr float NEG_INF = -2.3819763e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;  // the most shared memory a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p.astype(v.dtype) read back as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

}  // namespace
