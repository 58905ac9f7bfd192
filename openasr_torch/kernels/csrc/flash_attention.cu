// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// openasr_tpu/kernels/flash_attention.py:_fwd_kernel (:146): online-softmax
// attention over key tiles with key padding from kv_lengths, an optional
// causal mask that skips key tiles wholly above the diagonal, and fully
// masked rows giving O = 0 and lse = +inf (:218-230).  Outputs
// O [B, Tq, H, D] in q's dtype and lse [B, H, Tq] f32.  With dropout
// (:200-216) the keep mask is the positional hash of common.cuh: l sums the
// undropped p, acc takes p * keep / (1 - rate), so O = (P o D) V with P the
// normalized weights, as on the TPU.
//
// Bound on the H100: operations for long sequences, bytes for short ones.
// The work is 4 * D flops per (query, valid key) pair against reading q, k,
// v once and writing O once.  In bf16 the floor is the larger of
// flops / 989 TFLOP/s and bytes / 3.35 TB/s; f32 inputs are held to f32
// arithmetic (67 TFLOP/s off the tensor cores), because TF32 would not meet
// the f32 tolerance.
//
// Design: one block per (batch, head, 64-query tile).  Each query row is
// owned by D/32 adjacent lanes, each holding 32 of the row's q values and
// 32 of its output accumulators in registers; a score is a 32-term partial
// dot product summed across those lanes by shuffles.  Key and value tiles
// of 32 positions are staged in shared memory as f32, read from device
// memory through the strides of the [B, T, H, D] projection views (unit
// stride only along D).  m, l and acc stay in registers; the loop over key
// tiles stops at the last valid key (kv_lengths) and, for causal, at the
// tile's diagonal.
//
// What the simple design leaves on the table: all arithmetic runs as f32
// FMAs on the CUDA cores, never on the tensor cores (wgmma/mma.sync would
// give bf16 roughly 15x the rate), tiles are loaded synchronously with no
// cp.async/TMA double buffering, and q/O move as 4-byte accesses per lane.

#include "common.cuh"

namespace openasr {
namespace {

constexpr int kBlockQ = 64;   // queries per block
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1.0e30f;

// Shared-memory row of one key: D/32 parts of 32 floats, each part padded
// to 36 floats so the D/32 lanes of one query row hit distinct banks and
// every part starts 16-byte aligned for float4 reads.
constexpr int kPart = 36;

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ kv_lengths,
                           T* __restrict__ out, float* __restrict__ lse,
                           int H, int Tq, int Tk,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           float sm_scale, int causal, uint32_t seed,
                           uint32_t keep_thresh, float drop_scale) {
  constexpr int kTpr = D / 32;             // lanes per query row
  constexpr int kThreads = kBlockQ * kTpr;
  constexpr int kRow = kTpr * kPart;       // floats per staged key
  __shared__ __align__(16) float ks[kBlockK * kRow];
  __shared__ __align__(16) float vs[kBlockK * kRow];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kTpr;
  const int qpos = q0 + tid / kTpr;
  const bool active = qpos < Tq;

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  // keys past the tile's last query are masked for every row under causal
  const int k_end = causal ? min(n_valid, q0 + kBlockQ) : n_valid;

  float qr[32];
  {
    const T* qp = q + b * q_sb + (long long)(active ? qpos : 0) * q_st +
                  h * q_sh + part * 32;
#pragma unroll
    for (int dd = 0; dd < 32; ++dd) qr[dd] = active ? to_float(qp[dd]) : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int dd = 0; dd < 32; ++dd) acc[dd] = 0.f;
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Tk) {
        kx = to_float(kb[(long long)kp * k_st + c]);
        vx = to_float(vb[(long long)kp * v_st + c]);
      }
      const int off = j * kRow + (c / 32) * kPart + (c % 32);
      ks[off] = kx;
      vs[off] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * kRow + part * kPart);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < 8; ++d4) {
        const float4 kk = kr[d4];
        dot += qr[4 * d4] * kk.x;
        dot += qr[4 * d4 + 1] * kk.y;
        dot += qr[4 * d4 + 2] * kk.z;
        dot += qr[4 * d4 + 3] * kk.w;
      }
#pragma unroll
      for (int o = 1; o < kTpr; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int kp = k0 + j;
      const bool ok = kp < n_valid && (!causal || kp <= qpos);
      s[j] = ok ? dot * sm_scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    // rows with no valid key so far keep m == m_new == kNegInf: alpha = 1
    // and every p below is 0, so l and acc stay 0
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
    m = m_new;
    if (kDropout) {
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const bool keep = dropout_keep(seed, (uint32_t)(b * H + h), (uint32_t)qpos,
                                       (uint32_t)(k0 + j), keep_thresh);
        s[j] = keep ? s[j] * drop_scale : 0.f;
      }
    }
#pragma unroll
    for (int dd = 0; dd < 32; ++dd) acc[dd] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * kRow + part * kPart);
#pragma unroll
      for (int d4 = 0; d4 < 8; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] += s[j] * vv.x;
        acc[4 * d4 + 1] += s[j] * vv.y;
        acc[4 * d4 + 2] += s[j] * vv.z;
        acc[4 * d4 + 3] += s[j] * vv.w;
      }
    }
  }

  if (!active) return;
  const bool has_any = l > 0.f;
  T* op = out + (((long long)b * Tq + qpos) * H + h) * D + part * 32;
#pragma unroll
  for (int dd = 0; dd < 32; ++dd) op[dd] = from_float<T>(has_any ? acc[dd] / l : 0.f);
  if (part == 0) {
    lse[((long long)b * H + h) * Tq + qpos] =
        has_any ? m + logf(l) : __int_as_float(0x7f800000);  // +inf
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lengths, void* out, float* lse, int B, int H,
                   int Tq, int Tk, long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh, long long v_sb,
                   long long v_st, long long v_sh, float sm_scale, int causal,
                   const Dropout& drop, cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, B);
  const dim3 block(kBlockQ * (D / 32));
  if (drop.on)
    flash_attention_fwd_kernel<T, D, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        kv_lengths, static_cast<T*>(out), lse, H, Tq, Tk, q_sb, q_st, q_sh, k_sb,
        k_st, k_sh, v_sb, v_st, v_sh, sm_scale, causal, drop.seed, drop.thresh,
        drop.scale);
  else
    flash_attention_fwd_kernel<T, D, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        kv_lengths, static_cast<T*>(out), lse, H, Tq, Tk, q_sb, q_st, q_sh, k_sb,
        k_st, k_sh, v_sb, v_st, v_sh, sm_scale, causal, 0u, 0u, 1.f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* kv_lengths, void* out, float* lse, int B,
                       int H, int Tq, int Tk, long long q_sb, long long q_st,
                       long long q_sh, long long k_sb, long long k_st,
                       long long k_sh, long long v_sb, long long v_st,
                       long long v_sh, float sm_scale, int causal,
                       const Dropout& drop, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, kv_lengths, out, lse, B, H, Tq, Tk, q_sb,
                           q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                           sm_scale, causal, drop, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_lengths, out, lse, B, H, Tq, Tk, q_sb,
                           q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                           sm_scale, causal, drop, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_lengths, out, lse, B, H, Tq, Tk, q_sb,
                            q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                            sm_scale, causal, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace openasr

extern "C" {

// out, lse = attention(q, k, v).  q: [B, Tq, H, D], k/v: [B, Tk, H, D], each
// addressed through its (batch, time, head) strides with unit stride along
// D; kv_lengths: [B] int32 or null (= Tk); out: contiguous [B, Tq, H, D];
// lse: contiguous [B, H, Tq] f32.  With `dropout` set, the weights are
// dropped where the hash of (dropout_seed, b*H + h, qpos, kpos) is not below
// keep_thresh and the kept ones scaled by drop_scale = 1 / (1 - rate).
int openasr_flash_attention_fwd(const void* q, const void* k, const void* v,
                                const void* kv_lengths, void* out, void* lse,
                                int B, int H, int Tq, int Tk, int D,
                                long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                float sm_scale, int causal,
                                unsigned int dropout_seed,
                                unsigned int keep_thresh, float drop_scale,
                                int dropout, int dtype, int device,
                                void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lengths);
  float* lse_f = static_cast<float*>(lse);
  const openasr::Dropout drop{dropout != 0, dropout_seed, keep_thresh, drop_scale};
  switch (dtype) {
    case openasr::kFloat32:
      return openasr::dispatch_d<float>(D, q, k, v, lens, out, lse_f, B, H, Tq,
                                        Tk, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                                        v_sb, v_st, v_sh, sm_scale, causal,
                                        drop, s);
    case openasr::kBFloat16:
      return openasr::dispatch_d<__nv_bfloat16>(
          D, q, k, v, lens, out, lse_f, B, H, Tq, Tk, q_sb, q_st, q_sh, k_sb,
          k_st, k_sh, v_sb, v_st, v_sh, sm_scale, causal, drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
