// Row LayerNorm forward and backward for Hopper (sm_90a).
//
// Forward replaces the Pallas TPU kernel
// openasr_tpu/kernels/layer_norm.py:_fwd_kernel (:56): per row of x [N, D],
// f32 mean and var = E[x^2] - mean^2, rstd = rsqrt(var + eps),
// y = (x - mean) * rstd * gamma + beta written in x's dtype, plus mean and
// rstd [N] in f32 for the backward pass.
//
// Backward replaces `_bwd_kernel_partials` (:85) with the sum of its
// partials and, as its dx-only mode, `_bwd_dx_kernel` (:69): with
// xhat = (x - mean) * rstd and g = dy * gamma,
// dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) in x's dtype, and in
// the partials mode dgamma = sum_rows dy * xhat, dbeta = sum_rows dy in f32.
//
// Bound on the H100: bytes.  The forward reads each row once and writes it
// once (about 4 flops per element against 4-8 bytes), so the floor is
// (2 * N * D * sizeof(x) + 8 * N) / 3.35 TB/s; the backward reads x and dy
// and writes dx: (3 * N * D * sizeof(x) + 8 * N) / 3.35 TB/s.
//
// Forward design: one warp per row, the row held in registers (VPT = D/32
// values a lane, rounded up to a power of two, for D <= 1024), two
// warp-shuffle sums, then the normalize pass from registers: x is read
// from device memory exactly once.  Four rows per 128-thread block.
//
// Backward design (D <= 1024): 4-warp blocks and one warp a row.  In the
// partials mode there are as many blocks as the SMs hold at the kernel's
// register count (the occupancy API), and the warps stride over the rows.  A lane loads its columns as 16-byte vectors (4
// f32 or 8 bf16; vector v of a row is lane v % 32's, so a warp's loads are
// contiguous) when D, the pointers and the row strides allow it, else one
// element at a time.  The next row's x, dy, mean and rstd are loaded, as
// raw vectors, before the current row's two shuffle sums, so each warp
// keeps two rows in flight (partials mode).  In the partials mode a lane carries its
// columns' dgamma and dbeta sums in registers across its warp's rows; the
// block's warps add theirs in shared memory, in warp order, into one
// partial row per block, and a second small kernel sums the partial rows
// column by column in a fixed order, so dgamma and dbeta come out of the
// library (no PyTorch reduction) and are the same bits from run to run on
// one card.  The dx-only mode is the same kernel without the partials,
// the prefetch and the stride: a row a warp over the whole grid.
//
// Rows wider than 1024 (both directions): one warp a row, two passes over
// the row's columns (the second re-reads x and dy from L1/L2); in the
// partials mode each warp accumulates into its own partial row in device
// memory (a lane owns its columns, so nothing races), summed as above.

#include "common.cuh"

namespace openasr {
namespace {

constexpr int kRowsPerBlock = 4;   // forward: one warp a row
constexpr int kWarps = 4;          // backward: warps a block
constexpr int kMaxRegD = 1024;     // widest row held in registers
constexpr int kMaxDevices = 64;

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

// Rows wider than kMaxRegD: the same math in two passes over the columns.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y,
                           float* __restrict__ mean, float* __restrict__ rstd,
                           int n_rows, int d, long long x_stride, long long y_stride,
                           float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* xr = x + (long long)row * x_stride;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_float(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / d;
  const float var = s2 / d - mu * mu;
  const float rs = rsqrtf(var + eps);
  T* yr = y + (long long)row * y_stride;
  for (int c = lane; c < d; c += 32)
    yr[c] = from_float<T>((to_float(xr[c]) - mu) * rs * gamma[c] + beta[c]);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// ------------------------------------------------------------ backward

// The backward kernels' arguments, one struct for every instantiation.
struct BwdArgs {
  const void* x;
  const void* dy;
  const float* gamma;
  const float* mean;
  const float* rstd;
  void* dx;
  float* part;  // [2, rows, d]: dgamma partials, then dbeta's; null in dx-only
  int n_rows, d;
  long long x_stride, dy_stride, dx_stride;
};

// VEC consecutive elements of a row as one load: a float4 (4 f32), a uint4
// (8 bf16) or a single element.
template <typename T, int VEC>
struct RawVec;
template <>
struct RawVec<float, 4> {
  using type = float4;
};
template <>
struct RawVec<__nv_bfloat16, 8> {
  using type = uint4;
};
template <typename T>
struct RawVec<T, 1> {
  using type = T;
};

__device__ __forceinline__ void unpack(const float4& r, float (&f)[4]) {
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
template <typename T>
__device__ __forceinline__ void unpack(const T& r, float (&f)[1]) {
  f[0] = to_float(r);
}

__device__ __forceinline__ float4 pack(const float (&f)[4], float*) {
  return make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <typename T>
__device__ __forceinline__ T pack(const float (&f)[1], T*) {
  return from_float<T>(f[0]);
}

// gamma[c .. c + VEC) as floats (16-byte loads when VEC is a multiple of 4)
template <int VEC>
__device__ __forceinline__ void load_gamma(const float* __restrict__ gamma, int c,
                                           float (&g)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(gamma + c + 4 * i);
      g[4 * i] = v.x;
      g[4 * i + 1] = v.y;
      g[4 * i + 2] = v.z;
      g[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) g[i] = gamma[c + i];
  }
}

// One warp a row, NV vectors of VEC elements a lane (32 * NV * VEC >= d).
template <typename T, int VEC, int NV, bool kPartials>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_bwd_kernel(BwdArgs a) {
  using Raw = typename RawVec<T, VEC>::type;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = a.d / VEC;
  const Raw* x = static_cast<const Raw*>(a.x);
  const Raw* dy = static_cast<const Raw*>(a.dy);
  Raw* dx = static_cast<Raw*>(a.dx);
  // row strides in vectors (the host checks they divide)
  const long long xs = a.x_stride / VEC, dys = a.dy_stride / VEC, dxs = a.dx_stride / VEC;

  float dg[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dg[i][j] = db[i][j] = 0.f;

  const int step = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  Raw xr[NV], dyr[NV];
  float mu = 0.f, rs = 0.f;
  auto load_row = [&](int r, Raw (&xv)[NV], Raw (&dyv)[NV], float& m, float& s) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        xv[i] = x[r * xs + v];
        dyv[i] = dy[r * dys + v];
      }
    }
    m = a.mean[r];
    s = a.rstd[r];
  };
  if (row < a.n_rows) load_row(row, xr, dyr, mu, rs);

  for (; row < a.n_rows; row += step) {
    // the partials mode's warps walk several rows: the next one's loads go
    // out before this one's sums (the dx-only mode has a row a warp)
    Raw xn[NV], dyn[NV];
    float mun = 0.f, rsn = 0.f;
    if (kPartials && row + step < a.n_rows) load_row(row + step, xn, dyn, mun, rsn);

    float xh[NV][VEC], g[NV][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
#pragma unroll
      for (int j = 0; j < VEC; ++j) xh[i][j] = g[i][j] = 0.f;
      if (v < nvec) {
        float xf[VEC], dyf[VEC], gm[VEC];
        unpack(xr[i], xf);
        unpack(dyr[i], dyf);
        load_gamma<VEC>(a.gamma, v * VEC, gm);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          xh[i][j] = (xf[j] - mu) * rs;
          g[i][j] = dyf[j] * gm[j];
          s1 += g[i][j];
          s2 += g[i][j] * xh[i][j];
          if (kPartials) {
            dg[i][j] += dyf[j] * xh[i][j];
            db[i][j] += dyf[j];
          }
        }
      }
    }
    s1 = warp_sum(s1) / a.d;
    s2 = warp_sum(s2) / a.d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = rs * (g[i][j] - s1 - xh[i][j] * s2);
        dx[row * dxs + v] = pack(o, static_cast<T*>(nullptr));
      }
    }
    if constexpr (kPartials) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xr[i] = xn[i];
        dyr[i] = dyn[i];
      }
      mu = mun;
      rs = rsn;
    } else if (row + step < a.n_rows) {
      load_row(row + step, xr, dyr, mu, rs);
    }
  }

  if constexpr (kPartials) {
    // the block's warps, in order, into one partial row
    extern __shared__ float sm[];  // [2][kWarps][d]
    float* sg = sm + warp * a.d;
    float* sb = sm + (kWarps + warp) * a.d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sg[v * VEC + j] = dg[i][j];
          sb[v * VEC + j] = db[i][j];
        }
      }
    }
    __syncthreads();
    const long long rows = gridDim.x;
    for (int c = threadIdx.x; c < a.d; c += 32 * kWarps) {
      float tg = 0.f, tb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        tg += sm[w * a.d + c];
        tb += sm[(kWarps + w) * a.d + c];
      }
      a.part[blockIdx.x * (long long)a.d + c] = tg;
      a.part[(rows + blockIdx.x) * a.d + c] = tb;
    }
  }
}

// Rows wider than kMaxRegD: one warp a row, two passes over the columns;
// warp w of block b accumulates into partial row b * kWarps + w.
template <typename T, bool kPartials>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_bwd_wide_kernel(BwdArgs a) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const long long rows = (long long)gridDim.x * kWarps;
  const long long prow = (long long)blockIdx.x * kWarps + warp;
  float* pg = kPartials ? a.part + prow * a.d : nullptr;
  float* pb = kPartials ? a.part + (rows + prow) * a.d : nullptr;
  if (kPartials)
    for (int c = lane; c < a.d; c += 32) pg[c] = pb[c] = 0.f;

  for (int row = prow; row < a.n_rows; row += rows) {
    const T* xr = x + row * a.x_stride;
    const T* dyr = dy + row * a.dy_stride;
    const float mu = a.mean[row], rs = a.rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < a.d; c += 32) {
      const float xh = (to_float(xr[c]) - mu) * rs;
      const float g = to_float(dyr[c]) * a.gamma[c];
      s1 += g;
      s2 += g * xh;
    }
    s1 = warp_sum(s1) / a.d;
    s2 = warp_sum(s2) / a.d;
    T* dxr = dx + row * a.dx_stride;
    for (int c = lane; c < a.d; c += 32) {
      const float xh = (to_float(xr[c]) - mu) * rs;
      const float dyv = to_float(dyr[c]);
      const float g = dyv * a.gamma[c];
      dxr[c] = from_float<T>(rs * (g - s1 - xh * s2));
      if (kPartials) {
        pg[c] += dyv * xh;
        pb[c] += dyv;
      }
    }
  }
}

// dgamma[c], dbeta[c] = the partial rows' column sums, in row order within
// each of 32 warps and then in warp order: the same bits on every run.
constexpr int kSumWarps = 32;

__global__ void __launch_bounds__(32 * kSumWarps)
column_sum_kernel(const float* __restrict__ part, int rows, int d,
                  float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float acc[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const float* src = part + (long long)blockIdx.y * rows * d;
  float t = 0.f;
  if (c < d)
    for (int r = warp; r < rows; r += kSumWarps) t += src[(long long)r * d + c];
  acc[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && c < d) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) s += acc[w][lane];
    (blockIdx.y == 0 ? dgamma : dbeta)[c] = s;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* mean, void* rstd, int n_rows, int d, long long x_stride,
                   long long y_stride, float eps, cudaStream_t stream) {
  const dim3 block(32 * kRowsPerBlock);
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (d > kMaxRegD) {
    layer_norm_fwd_wide_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), n_rows, d,
        x_stride, y_stride, eps);
    return cudaGetLastError();
  }
  int vpt = 1;
  while (32 * vpt < d) vpt *= 2;
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

using BwdKernel = void (*)(BwdArgs);

// The backward's launch: which kernel, its grid and shared memory, and how
// many partial rows it writes (at most ceil(n_rows / kWarps) blocks, and at
// most 2048 threads an SM's worth of them; kWarps rows a block when wide).
struct BwdPlan {
  BwdKernel kernel;
  int blocks;
  size_t smem;
  int partial_rows;
};

template <typename T, int VEC, bool P>
BwdKernel pick_reg_kernel(int nv) {
  switch (nv) {
    case 1: return layer_norm_bwd_kernel<T, VEC, 1, P>;
    case 2: return layer_norm_bwd_kernel<T, VEC, 2, P>;
    case 4: return layer_norm_bwd_kernel<T, VEC, 4, P>;
    case 8: return layer_norm_bwd_kernel<T, VEC, 8, P>;
    default: break;
  }
  if constexpr (VEC == 1) {
    switch (nv) {
      case 16: return layer_norm_bwd_kernel<T, 1, 16, P>;
      case 32: return layer_norm_bwd_kernel<T, 1, 32, P>;
      default: break;
    }
  }
  return nullptr;
}

template <typename T, bool P>
BwdKernel pick_kernel(bool vec, int d) {
  if (d > kMaxRegD) return layer_norm_bwd_wide_kernel<T, P>;
  constexpr int kVec = 16 / sizeof(T);
  const int per = vec ? kVec : 1;
  int nv = 1;
  while (32 * nv * per < d) nv *= 2;
  return vec ? pick_reg_kernel<T, kVec, P>(nv) : pick_reg_kernel<T, 1, P>(nv);
}

cudaError_t plan_bwd(const void* x, const void* dy, const void* dx, const void* gamma,
                     int n_rows, int d, long long xs, long long dys, long long dxs,
                     int dtype, bool partials, int device, BwdPlan* plan) {
  const int es = dtype == kBFloat16 ? 2 : 4;
  const int vec_elems = 16 / es;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = d <= kMaxRegD && d % vec_elems == 0 && aligned(x) && aligned(dy) &&
                   aligned(dx) && aligned(gamma) && xs % vec_elems == 0 &&
                   dys % vec_elems == 0 && dxs % vec_elems == 0;
  BwdKernel k;
  if (dtype == kFloat32)
    k = partials ? pick_kernel<float, true>(vec, d) : pick_kernel<float, false>(vec, d);
  else if (dtype == kBFloat16)
    k = partials ? pick_kernel<__nv_bfloat16, true>(vec, d)
                 : pick_kernel<__nv_bfloat16, false>(vec, d);
  else
    return cudaErrorInvalidValue;
  if (k == nullptr) return cudaErrorInvalidValue;
  const bool wide = d > kMaxRegD;
  const size_t smem = partials && !wide ? sizeof(float) * 2 * kWarps * d : 0;
  // as many blocks as the SMs hold at once, never more than the rows need
  const int row_blocks = (n_rows + kWarps - 1) / kWarps;
  static int sms[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sms[device]) {
    cudaError_t err =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(k), 32 * kWarps, smem);
  if (err != cudaSuccess) return err;
  // (the dx-only mode: a row a warp)
  int blocks = !partials || row_blocks < sms[device] * per_sm ? row_blocks : sms[device] * per_sm;
  if (blocks < 1) blocks = 1;
  *plan = {k, blocks, smem, partials ? (wide ? blocks * kWarps : blocks) : 0};
  return cudaSuccess;
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
  if (n_rows < 1 || d < 1) return cudaErrorInvalidValue;
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

// dx (and, when dgamma is not null, dgamma and dbeta) of LayerNorm over
// rows.  x, dy, dx: [n_rows, d] with unit column stride; gamma: [d] f32;
// mean, rstd: [n_rows] f32 from the forward; dgamma, dbeta: [d] f32 or both
// null (the dx-only mode); scratch: scratch_rows * 2 * d f32 (null in
// dx-only), of which the launch uses [2, rows, d] for rows partial rows:
// an error, not a launch, if that is more than scratch_rows.  Launches the
// row kernel and, in the partials mode, the column sum.
int openasr_layer_norm_bwd(const void* x, const void* dy, const void* gamma,
                           const void* mean, const void* rstd, void* dx,
                           void* dgamma, void* dbeta, void* scratch,
                           int scratch_rows, int n_rows, int d, long long x_stride,
                           long long dy_stride, long long dx_stride, int dtype,
                           int device, void* stream) {
  const bool partials = dgamma != nullptr;
  if (n_rows < 1 || d < 1 || (dbeta != nullptr) != partials ||
      (scratch != nullptr) != partials)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  openasr::BwdPlan plan;
  err = openasr::plan_bwd(x, dy, dx, gamma, n_rows, d, x_stride, dy_stride, dx_stride,
                          dtype, partials, device, &plan);
  if (err != cudaSuccess) return err;
  // (the partials' shared memory, 2 * kWarps * d floats, stays within the
  // default 48 KB at d <= kMaxRegD)
  if (partials && plan.partial_rows > scratch_rows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const openasr::BwdArgs args{x, dy,
                              static_cast<const float*>(gamma),
                              static_cast<const float*>(mean),
                              static_cast<const float*>(rstd), dx,
                              static_cast<float*>(scratch), n_rows, d,
                              x_stride, dy_stride, dx_stride};
  plan.kernel<<<plan.blocks, 32 * openasr::kWarps, plan.smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partials) return err;
  const dim3 grid((d + 31) / 32, 2);
  openasr::column_sum_kernel<<<grid, 32 * openasr::kSumWarps, 0, s>>>(
      static_cast<const float*>(scratch), plan.partial_rows, d,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}

}  // extern "C"
