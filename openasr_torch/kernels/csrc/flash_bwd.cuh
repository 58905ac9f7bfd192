// What the attention backward's two routes share (flash_attention_bwd.cu:
// mma.sync, f32 and bf16; flash_attention_bwd_wgmma.cu: wgmma, bf16): the
// launch arguments, the row statistics' layout and the elementwise steps
// that make P and dS the same bits in the statistics pass, dK/dV and dQ
// of one route.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_tiles.cuh"

namespace openasr {

constexpr int kStats = 3;            // row statistics: m, 1 / l, delta ([3][B][H][Tq])
constexpr float kNegInf = -1.0e30f;  // a masked score, in log2 units

// The weights, in every kernel and the same bits: P = exp2(s' - m) / l,
// s' = S scale log2(e), from the row's max m and 1 / l (the statistics
// pass's).  Each product and difference is rounded where written, so no
// contraction differs between the kernels and the row's max gives
// exp2(0) = 1 exactly.
__device__ __forceinline__ float weight(float s, float scale_log2, float m, float inv_l) {
  return __fmul_rn(exp2f(__fsub_rn(__fmul_rn(s, scale_log2), m)), inv_l);
}
// An entry of dS = P o (dP o D - delta) * scale, with delta = rowsum(P o
// dP o D) from the same P and dP (the statistics pass's): where P is
// one-hot, dP o D - delta is exactly 0.
__device__ __forceinline__ float grad_entry(float p, float dpd, float delta, float sm_scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dpd, delta)), sm_scale);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  float* stats;  // written by the statistics pass, read by dK/dV and dQ
  const int* kv_lengths;
  void *dq, *dk, *dv;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, ds;
  float sm_scale;
  Mask mask;
  Dropout drop;
  int device;
};

// The wgmma route (flash_attention_bwd_wgmma.cu), bf16 at D 32, 64 and
// 128.  which = 0: dK/dV, 1: dQ, 2: the statistics.
cudaError_t launch_bwd_wgmma(int which, int D, const BwdArgs& a, cudaStream_t stream);

}  // namespace openasr
