// Row LayerNorm forward and backward for Hopper (sm_90a).
//
// Forward replaces the Pallas TPU kernel
// openasr_tpu/kernels/layer_norm.py:_fwd_kernel (:56): per row of x [N, D],
// f32 mean and var = E[x^2] - mean^2, rstd = rsqrt(var + eps),
// y = (x - mean) * rstd * gamma + beta written in x's dtype, plus mean and
// rstd [N] in f32 for the backward pass.
//
// Backward replaces `_bwd_kernel_partials` (:85) and, as its
// `partials = false` mode, `_bwd_dx_kernel` (:69): with xhat = (x-mean)*rstd
// and g = dy*gamma, dx = rstd * (g - mean(g) - xhat * mean(g*xhat)); the
// partials mode also writes per-block column sums of dy*xhat and dy (the
// dgamma / dbeta partials, [blocks, D] f32), which the caller sums.
//
// Bound on the H100: bytes.  The forward reads each row once and writes it
// once (about 4 flops per element against 4-8 bytes), so the floor is
// (2 * N * D * sizeof(x) + 8 * N) / 3.35 TB/s; the backward reads x and dy
// and writes dx: (3 * N * D * sizeof(x) + 8 * N) / 3.35 TB/s.
//
// Design: one warp per row, the row held in registers (VPT = D/32 values a
// lane, rounded up to a power of two, so D <= 1024), two warp-shuffle sums,
// then the normalize pass from registers: x is read from device memory
// exactly once.  Four rows per 128-thread block.
//
// The backward keeps that layout: one warp per row, x and dy read once into
// registers, two shuffle sums for the row means.  Its warps stride over the
// rows (grid-stride), and in the partials mode each lane carries its
// columns' dgamma / dbeta sums across every row its warp visits; the block's
// four warps add theirs in shared memory and write one [D] partial row per
// block, so the partial buffer stays a few hundred rows whatever N is.
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

template <typename T, int VPT, bool kPartials>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, int n_rows, int d,
                      long long x_stride, long long dy_stride,
                      long long dx_stride) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float dg[VPT], db[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) dg[i] = db[i] = 0.f;

  for (int row = blockIdx.x * kRowsPerBlock + warp; row < n_rows;
       row += gridDim.x * kRowsPerBlock) {
    const T* xr = x + (long long)row * x_stride;
    const T* dyr = dy + (long long)row * dy_stride;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[VPT], g[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      float dyv = 0.f;
      xh[i] = 0.f;
      if (c < d) {
        xh[i] = (to_float(xr[c]) - mu) * rs;
        dyv = to_float(dyr[c]);
      }
      g[i] = c < d ? dyv * gamma[c] : 0.f;
      s1 += g[i];
      s2 += g[i] * xh[i];
      if (kPartials) {
        dg[i] += dyv * xh[i];
        db[i] += dyv;
      }
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
    T* dxr = dx + (long long)row * dx_stride;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) dxr[c] = from_float<T>(rs * (g[i] - s1 - xh[i] * s2));
    }
  }

  if (kPartials) {
    __shared__ float sg[kRowsPerBlock * 32 * VPT];
    __shared__ float sb[kRowsPerBlock * 32 * VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      sg[warp * 32 * VPT + lane + 32 * i] = dg[i];
      sb[warp * 32 * VPT + lane + 32 * i] = db[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += 32 * kRowsPerBlock) {
      float tg = 0.f, tb = 0.f;
#pragma unroll
      for (int w = 0; w < kRowsPerBlock; ++w) {
        tg += sg[w * 32 * VPT + c];
        tb += sb[w * 32 * VPT + c];
      }
      dgamma_part[(long long)blockIdx.x * d + c] = tg;
      dbeta_part[(long long)blockIdx.x * d + c] = tb;
    }
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

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* gamma,
                       const void* mean, const void* rstd, void* dx,
                       void* dgamma_part, void* dbeta_part, int n_rows, int d,
                       long long x_stride, long long dy_stride,
                       long long dx_stride, int n_blocks, cudaStream_t stream) {
  int vpt = 1;
  while (32 * vpt < d) vpt *= 2;
  const bool partials = dgamma_part != nullptr;
  const dim3 block(32 * kRowsPerBlock);
  const dim3 grid(n_blocks);
#define OPENASR_LN_BWD_CASE(V)                                                 \
  case V:                                                                      \
    if (partials)                                                              \
      layer_norm_bwd_kernel<T, V, true><<<grid, block, 0, stream>>>(           \
          static_cast<const T*>(x), static_cast<const T*>(dy),                 \
          static_cast<const float*>(gamma), static_cast<const float*>(mean),   \
          static_cast<const float*>(rstd), static_cast<T*>(dx),                \
          static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part),   \
          n_rows, d, x_stride, dy_stride, dx_stride);                          \
    else                                                                       \
      layer_norm_bwd_kernel<T, V, false><<<grid, block, 0, stream>>>(          \
          static_cast<const T*>(x), static_cast<const T*>(dy),                 \
          static_cast<const float*>(gamma), static_cast<const float*>(mean),   \
          static_cast<const float*>(rstd), static_cast<T*>(dx), nullptr,       \
          nullptr, n_rows, d, x_stride, dy_stride, dx_stride);                 \
    break;
  switch (vpt) {
    OPENASR_LN_BWD_CASE(1)
    OPENASR_LN_BWD_CASE(2)
    OPENASR_LN_BWD_CASE(4)
    OPENASR_LN_BWD_CASE(8)
    OPENASR_LN_BWD_CASE(16)
    OPENASR_LN_BWD_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef OPENASR_LN_BWD_CASE
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

// dx (and, when dgamma_part is not null, the dgamma / dbeta partials) of
// LayerNorm over rows.  x, dy, dx: [n_rows, d] with unit column stride;
// gamma: [d] f32; mean, rstd: [n_rows] f32 from the forward; dgamma_part,
// dbeta_part: [n_blocks, d] f32 or both null (the dx-only mode).
int openasr_layer_norm_bwd(const void* x, const void* dy, const void* gamma,
                           const void* mean, const void* rstd, void* dx,
                           void* dgamma_part, void* dbeta_part, int n_rows,
                           int d, long long x_stride, long long dy_stride,
                           long long dx_stride, int n_blocks, int dtype,
                           int device, void* stream) {
  if (n_rows < 1 || d < 1 || d > 1024 || n_blocks < 1 || n_blocks > 65535 ||
      (dgamma_part == nullptr) != (dbeta_part == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case openasr::kFloat32:
      return openasr::launch_bwd<float>(x, dy, gamma, mean, rstd, dx,
                                        dgamma_part, dbeta_part, n_rows, d,
                                        x_stride, dy_stride, dx_stride,
                                        n_blocks, s);
    case openasr::kBFloat16:
      return openasr::launch_bwd<__nv_bfloat16>(
          x, dy, gamma, mean, rstd, dx, dgamma_part, dbeta_part, n_rows, d,
          x_stride, dy_stride, dx_stride, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
