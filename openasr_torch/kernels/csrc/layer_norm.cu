// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openasr_tpu/kernels/layer_norm.py:_fwd_kernel
// (:56): per row of x [N, D], f32 mean and var = E[x^2] - mean^2,
// rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma + beta written in
// x's dtype, plus mean and rstd [N] in f32 for the backward pass.
//
// Bound on the H100: bytes.  Each row is read once and written once (about
// 4 flops per element against 4-8 bytes), so the floor is
// (2 * N * D * sizeof(x) + 8 * N) / 3.35 TB/s.
//
// Design: one warp per row, the row held in registers (VPT = D/32 values a
// lane, rounded up to a power of two, so D <= 1024), two warp-shuffle sums,
// then the normalize pass from registers: x is read from device memory
// exactly once.  Four rows per 128-thread block.
//
// What the simple design leaves on the table: loads are 4 bytes a lane
// (f32) or 2 bytes (bf16) instead of 16-byte vectors, and a short row count
// (the decode step's [batch*beam, 512] norms) fills only a few SMs, where
// launch latency dominates anyway.

#include "common.cuh"

namespace openasr {
namespace {

constexpr int kRowsPerBlock = 4;

template <typename T, int VPT>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int n_rows, int d, long long x_stride, long long y_stride,
                      float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // whole warp leaves together
  const T* xr = x + (long long)row * x_stride;

  float v[VPT];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? to_float(xr[c]) : 0.f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / d;
  const float var = s2 / d - mu * mu;
  const float rs = rsqrtf(var + eps);

  T* yr = y + (long long)row * y_stride;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) yr[c] = from_float<T>((v[i] - mu) * rs * gamma[c] + beta[c]);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* mean, void* rstd, int n_rows, int d, long long x_stride,
                   long long y_stride, float eps, cudaStream_t stream) {
  int vpt = 1;
  while (32 * vpt < d) vpt *= 2;
  const dim3 block(32 * kRowsPerBlock);
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
#define OPENASR_LN_CASE(V)                                                     \
  case V:                                                                      \
    layer_norm_fwd_kernel<T, V><<<grid, block, 0, stream>>>(                   \
        static_cast<const T*>(x), static_cast<const float*>(gamma),            \
        static_cast<const float*>(beta), static_cast<T*>(y),                   \
        static_cast<float*>(mean), static_cast<float*>(rstd), n_rows, d,       \
        x_stride, y_stride, eps);                                              \
    break;
  switch (vpt) {
    OPENASR_LN_CASE(1)
    OPENASR_LN_CASE(2)
    OPENASR_LN_CASE(4)
    OPENASR_LN_CASE(8)
    OPENASR_LN_CASE(16)
    OPENASR_LN_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef OPENASR_LN_CASE
  return cudaGetLastError();
}

}  // namespace
}  // namespace openasr

extern "C" {

// The library's error text for a code returned by any entry point.
const char* openasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y, mean, rstd = LayerNorm(x) over rows.  x and y: [n_rows, d] with unit
// column stride; gamma, beta: [d] f32; mean, rstd: [n_rows] f32.
int openasr_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, void* mean, void* rstd, int n_rows, int d,
                           long long x_stride, long long y_stride, float eps,
                           int dtype, int device, void* stream) {
  if (n_rows < 1 || d < 1 || d > 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case openasr::kFloat32:
      return openasr::launch<float>(x, gamma, beta, y, mean, rstd, n_rows, d,
                                    x_stride, y_stride, eps, s);
    case openasr::kBFloat16:
      return openasr::launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd,
                                            n_rows, d, x_stride, y_stride, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
