// Flash attention backward for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces the Pallas TPU kernels
// openasr_tpu/kernels/flash_attention.py:_bwd_dkv_kernel (:238) and
// `_bwd_dq_kernel` (:327).  Both recompute the weights from the forward's
// logsumexp rows, P = exp(S * scale - lse), with the forward's masks (key
// padding from kv_lengths, causal kpos <= qpos) and, with dropout, the same
// positional hash mask D = keep / (1 - rate) (common.cuh):
//   dV = (P o D)^T dO,   dP = (dO V^T) o D,
//   dS = P o (dP - delta) * scale,   dK = dS^T Q,   dQ = dS K,
// where delta = rowsum(dO o O) [B, H, Tq] f32 is computed by the caller
// (:468).  Rows the forward left empty carry lse = +inf, so their P is 0.
// As on the TPU, dK/dV and dQ are two kernels: the first walks queries for
// a tile of keys, the second keys for a tile of queries, so neither needs
// atomics.
//
// Bound on the H100: operations.  The work is five Tq x Tk x D products
// (S and dP in both kernels' recompute is counted once: S, dP, dV, dK, dQ),
// 10 * D flops per (query, valid key) pair, against reading q, k, v, O, dO
// once and writing dq, dk, dv once.  In bf16 the floor is
// flops / 989 TFLOP/s; f32 is held to 67 TFLOP/s (no TF32, as in the
// forward).
//
// Design, the forward's layout turned around for dK/dV: one block per
// (batch, head, 64-key tile); each key row is owned by D/32 adjacent lanes
// that hold 32 of its k and v values and 32 of its dk and dv accumulators
// in registers.  Query tiles of 32 rows (q and dO as f32, plus lse and
// delta) are staged in shared memory; a score or dP is a 32-term partial
// dot summed across the row's lanes by shuffles.  Under causal the walk
// starts at the query tile holding the block's first key; a block whose
// keys are all padding writes zeros.  dQ is the forward's layout: one
// block per (batch, head, 64-query tile), q, dO and the dq accumulator in
// registers, key and value tiles of 32 staged in shared memory, the key
// loop ending at kv_length (and the diagonal under causal).
//
// What the simple design leaves on the table: like the forward, every
// operation is an f32 FMA on the CUDA cores (no mma/wgmma), tiles are
// loaded synchronously, and both kernels recompute S and dP.

#include "common.cuh"

namespace openasr {
namespace {

constexpr int kRows = 64;   // keys (dK/dV) or queries (dQ) per block
constexpr int kTile = 32;   // rows per shared-memory tile
constexpr int kPart = 36;   // floats per 32-value part of a staged row

// Partial dot of this lane's 32 values with a staged row part.
__device__ __forceinline__ float dot32(const float* r, const float* smem_part) {
  const float4* p = reinterpret_cast<const float4*>(smem_part);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < 8; ++d4) {
    const float4 z = p[d4];
    acc += r[4 * d4] * z.x;
    acc += r[4 * d4 + 1] * z.y;
    acc += r[4 * d4 + 2] * z.z;
    acc += r[4 * d4 + 3] * z.w;
  }
  return acc;
}

// acc += w * staged row part (32 values).
__device__ __forceinline__ void axpy32(float* acc, float w, const float* smem_part) {
  const float4* p = reinterpret_cast<const float4*>(smem_part);
#pragma unroll
  for (int d4 = 0; d4 < 8; ++d4) {
    const float4 z = p[d4];
    acc[4 * d4] += w * z.x;
    acc[4 * d4 + 1] += w * z.y;
    acc[4 * d4 + 2] += w * z.z;
    acc[4 * d4 + 3] += w * z.w;
  }
}

template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  long long b, t, h;
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kRows * (D / 32))
flash_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ kv_lengths,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, Strides qs_,
    Strides ks_, Strides vs_, Strides ds_, float sm_scale, int causal,
    Dropout drop) {
  constexpr int kTpr = D / 32;
  constexpr int kThreads = kRows * kTpr;
  constexpr int kRow = kTpr * kPart;
  __shared__ __align__(16) float qsm[kTile * kRow];
  __shared__ __align__(16) float dosm[kTile * kRow];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int part = tid % kTpr;
  const int kpos = k0 + tid / kTpr;
  const bool active = kpos < Tk;
  const uint32_t bh = (uint32_t)(b * H + h);

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  const bool key_ok = kpos < n_valid;

  float kr[32], vr[32], dka[32], dva[32];
  {
    const long long kk = active ? kpos : 0;
    const T* kp = k + b * ks_.b + kk * ks_.t + h * ks_.h + part * 32;
    const T* vp = v + b * vs_.b + kk * vs_.t + h * vs_.h + part * 32;
#pragma unroll
    for (int dd = 0; dd < 32; ++dd) {
      kr[dd] = active ? to_float(kp[dd]) : 0.f;
      vr[dd] = active ? to_float(vp[dd]) : 0.f;
      dka[dd] = 0.f;
      dva[dd] = 0.f;
    }
  }

  // queries before the block's first key see none of its keys under causal
  int q_begin = causal ? (k0 / kTile) * kTile : 0;
  if (k0 >= n_valid) q_begin = Tq;  // every key of the block is padding
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* db = dout + b * ds_.b + h * ds_.h;
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* delta_b = delta + ((long long)b * H + h) * Tq;
  for (int q0 = q_begin; q0 < Tq; q0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int i = idx / D, c = idx % D;
      const int qp = q0 + i;
      float qx = 0.f, dx = 0.f;
      if (qp < Tq) {
        qx = to_float(qb[(long long)qp * qs_.t + c]);
        dx = to_float(db[(long long)qp * ds_.t + c]);
      }
      const int off = i * kRow + (c / 32) * kPart + (c % 32);
      qsm[off] = qx;
      dosm[off] = dx;
    }
    for (int i = tid; i < kTile; i += kThreads) {
      const int qp = q0 + i;
      lse_s[i] = qp < Tq ? lse_b[qp] : __int_as_float(0x7f800000);
      delta_s[i] = qp < Tq ? delta_b[qp] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float* qrow = qsm + i * kRow + part * kPart;
      const float* drow = dosm + i * kRow + part * kPart;
      const float s = group_sum<kTpr>(dot32(kr, qrow));
      const float dp = group_sum<kTpr>(dot32(vr, drow));
      const int qp = q0 + i;
      const bool ok = key_ok && qp < Tq && (!causal || kpos <= qp);
      // lse = +inf (an empty row) gives p = 0
      const float p = ok ? expf(s * sm_scale - lse_s[i]) : 0.f;
      float pd = p, dpd = dp;
      if (kDropout) {
        const bool keep = dropout_keep(drop.seed, bh, (uint32_t)qp, (uint32_t)kpos,
                                       drop.thresh);
        pd = keep ? p * drop.scale : 0.f;
        dpd = keep ? dp * drop.scale : 0.f;
      }
      const float ds = p * (dpd - delta_s[i]) * sm_scale;
      axpy32(dva, pd, drow);
      axpy32(dka, ds, qrow);
    }
  }

  if (!active) return;
  const long long o = (((long long)b * Tk + kpos) * H + h) * D + part * 32;
#pragma unroll
  for (int dd = 0; dd < 32; ++dd) {
    dk[o + dd] = from_float<T>(dka[dd]);
    dv[o + dd] = from_float<T>(dva[dd]);
  }
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kRows * (D / 32))
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ kv_lengths,
    T* __restrict__ dq, int H, int Tq, int Tk, Strides qs_, Strides ks_,
    Strides vs_, Strides ds_, float sm_scale, int causal, Dropout drop) {
  constexpr int kTpr = D / 32;
  constexpr int kThreads = kRows * kTpr;
  constexpr int kRow = kTpr * kPart;
  __shared__ __align__(16) float ksm[kTile * kRow];
  __shared__ __align__(16) float vsm[kTile * kRow];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int part = tid % kTpr;
  const int qpos = q0 + tid / kTpr;
  const bool active = qpos < Tq;
  const uint32_t bh = (uint32_t)(b * H + h);

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  const int k_end = causal ? min(n_valid, q0 + kRows) : n_valid;

  float qr[32], dor[32], acc[32];
  {
    const long long qq = active ? qpos : 0;
    const T* qp = q + b * qs_.b + qq * qs_.t + h * qs_.h + part * 32;
    const T* dp = dout + b * ds_.b + qq * ds_.t + h * ds_.h + part * 32;
#pragma unroll
    for (int dd = 0; dd < 32; ++dd) {
      qr[dd] = active ? to_float(qp[dd]) : 0.f;
      dor[dd] = active ? to_float(dp[dd]) : 0.f;
      acc[dd] = 0.f;
    }
  }
  const long long row = ((long long)b * H + h) * Tq + (active ? qpos : 0);
  const float lse_q = active ? lse[row] : __int_as_float(0x7f800000);
  const float delta_q = active ? delta[row] : 0.f;

  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Tk) {
        kx = to_float(kb[(long long)kp * ks_.t + c]);
        vx = to_float(vb[(long long)kp * vs_.t + c]);
      }
      const int off = j * kRow + (c / 32) * kPart + (c % 32);
      ksm[off] = kx;
      vsm[off] = vx;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* krow = ksm + j * kRow + part * kPart;
      const float* vrow = vsm + j * kRow + part * kPart;
      const float s = group_sum<kTpr>(dot32(qr, krow));
      const float dp = group_sum<kTpr>(dot32(dor, vrow));
      const int kp = k0 + j;
      const bool ok = kp < n_valid && (!causal || kp <= qpos);
      const float p = ok ? expf(s * sm_scale - lse_q) : 0.f;
      float dpd = dp;
      if (kDropout) {
        const bool keep = dropout_keep(drop.seed, bh, (uint32_t)qpos, (uint32_t)kp,
                                       drop.thresh);
        dpd = keep ? dp * drop.scale : 0.f;
      }
      axpy32(acc, p * (dpd - delta_q) * sm_scale, krow);
    }
  }

  if (!active) return;
  const long long o = (((long long)b * Tq + qpos) * H + h) * D + part * 32;
#pragma unroll
  for (int dd = 0; dd < 32; ++dd) dq[o + dd] = from_float<T>(acc[dd]);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_lengths;
  void *dq, *dk, *dv;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, ds;
  float sm_scale;
  int causal;
  Dropout drop;
};

template <typename T, int D, bool kDropout>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tk + kRows - 1) / kRows, a.H, a.B);
  flash_attention_bwd_dkv_kernel<T, D, kDropout><<<grid, kRows * (D / 32), 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      a.kv_lengths, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Tq,
      a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <typename T, int D, bool kDropout>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kRows - 1) / kRows, a.H, a.B);
  flash_attention_bwd_dq_kernel<T, D, kDropout><<<grid, kRows * (D / 32), 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      a.kv_lengths, static_cast<T*>(a.dq), a.H, a.Tq, a.Tk, a.qs, a.ks, a.vs,
      a.ds, a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ
template <typename T, int D>
cudaError_t launch_one(int which, const Args& a, cudaStream_t stream) {
  if (which == 0)
    return a.drop.on ? launch_dkv<T, D, true>(a, stream)
                     : launch_dkv<T, D, false>(a, stream);
  return a.drop.on ? launch_dq<T, D, true>(a, stream)
                   : launch_dq<T, D, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_d(int which, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_one<T, 32>(which, a, stream);
    case 64:
      return launch_one<T, 64>(which, a, stream);
    case 128:
      return launch_one<T, 128>(which, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* kv_lengths, void* dq, void* dk, void* dv, int B, int H,
        int Tq, int Tk, int D, const long long* strides, float sm_scale,
        int causal, unsigned int dropout_seed, unsigned int keep_thresh,
        float drop_scale, int dropout, int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a{q, k, v, dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kv_lengths), dq, dk, dv, B, H, Tq, Tk,
         {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
         {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]},
         sm_scale, causal, {dropout != 0, dropout_seed, keep_thresh, drop_scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(which, D, a, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(which, D, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace openasr

extern "C" {

// dk, dv of attention.  q, dout: [B, Tq, H, D]; k, v: [B, Tk, H, D], each
// addressed through its (batch, time, head) strides, given in `strides` as
// q, k, v, dout triples (12 values), with unit stride along D; lse, delta:
// contiguous [B, H, Tq] f32; kv_lengths: [B] int32 or null; dk, dv:
// contiguous [B, Tk, H, D].  Dropout arguments as in the forward.
int openasr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_lengths, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, const long long* strides,
    float sm_scale, int causal, unsigned int dropout_seed,
    unsigned int keep_thresh, float drop_scale, int dropout, int dtype,
    int device, void* stream) {
  return openasr::run(0, q, k, v, dout, lse, delta, kv_lengths, nullptr, dk, dv,
                      B, H, Tq, Tk, D, strides, sm_scale, causal, dropout_seed,
                      keep_thresh, drop_scale, dropout, dtype, device, stream);
}

// dq of attention; arguments as above, dq: contiguous [B, Tq, H, D].
int openasr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_lengths, void* dq,
    int B, int H, int Tq, int Tk, int D, const long long* strides,
    float sm_scale, int causal, unsigned int dropout_seed,
    unsigned int keep_thresh, float drop_scale, int dropout, int dtype,
    int device, void* stream) {
  return openasr::run(1, q, k, v, dout, lse, delta, kv_lengths, dq, nullptr,
                      nullptr, B, H, Tq, Tk, D, strides, sm_scale, causal,
                      dropout_seed, keep_thresh, drop_scale, dropout, dtype,
                      device, stream);
}

}  // extern "C"
