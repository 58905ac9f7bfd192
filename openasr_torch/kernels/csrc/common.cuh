// Helpers shared by the kernels: element conversion, warp reductions and
// the attention-dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace openasr {

// Element-type codes of the C interface (openasr_torch/kernels/__init__.py).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
// Round to nearest even, as torch's .to(torch.bfloat16) does.
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Butterfly sum over the 32 lanes: every lane ends with the same total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Attention-dropout parameters of one launch: on/off, the uint32 seed, the
// keep threshold round((1 - rate) * 2^32) and the kept weights' scale
// 1 / (1 - rate).
struct Dropout {
  bool on;
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

// Attention-dropout keep decision for one (query, key) pair: the murmur3
// fmix32 hash of (seed, b*H + h, qpos, kpos) against a uint32 threshold,
// bit for bit the mask of openasr_tpu/kernels/flash_attention.py:78-134
// (`attention_dropout_mask`).  It depends on positions only, so the forward
// and both backward kernels regenerate the same mask in any tile order.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             uint32_t qpos, uint32_t kpos,
                                             uint32_t keep_thresh) {
  uint32_t x = qpos * 2654435761u + kpos;
  x ^= seed + bh * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < keep_thresh;
}

}  // namespace openasr
