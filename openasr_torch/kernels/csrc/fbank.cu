// Fused log-mel fbank core for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openasr_tpu/kernels/fbank_fused.py:
// _fbank_kernel (:90).  With DC removal, preemphasis, the window and the
// zero-padded DFT folded into Mc, Ms [ws, F] (kernels/fbank.py:
// fused_matrices), one frame f [ws] of an utterance gives
//
//   re_k = f . Mc[:, k],  im_k = f . Ms[:, k],  p_k = re_k^2 + im_k^2,
//   out_m = log(max(sum_k p_k MelT[k, m], FLT_EPSILON))
//
// in float32, every product an f32 FMA on the CUDA cores: the TPU kernel
// runs at Precision.HIGHEST, and TF32 (about three digits) would break the
// log-mel parity.  Only the K = nfft/2 bins below the Nyquist are computed:
// the Nyquist column of the mel banks is zero (ops/fbank.py: mel_banks).
//
// Bound on the H100: operations.  A frame costs 2 * 2 * ws * F flops for
// re and im (411 200 at ws 400, F 257) and 2 * F * M for the mel product
// against 4 * 160 bytes of new waveform read and 4 * M bytes written, so
// the floor is frames * (4 ws F + 2 F M) / 67 TFLOP/s (f32, no tensor
// cores).  A real FFT would do about a fortieth of the work; the folded
// product is the TPU's form, kept here for the first, simple kernel.
//
// Design: one block of 256 threads owns (utterance, tile of 32 frames).
// 1. The tile is staged transposed in shared memory, sf[n][t], reading
//    frame t of utterance b at frames + b*batch_stride + t*frame_stride:
//    a strided view of the padded waves (frame_stride = the hop, so the
//    [B, T, ws] frame tensor is never written) or materialized dithered
//    frames (frame_stride = ws).  Frames past the utterance's frame count
//    read as 0; a tile wholly past it is written as zeros and skips the
//    products.
// 2. Thread k owns bin k: per sample n it loads (Mc[n,k], Ms[n,k]) as one
//    float2 from L2 (the matrices, 0.8 MB, stay resident there) and the 32
//    frames' samples as eight broadcast float4 reads, and carries 32 re and
//    32 im sums in registers: 64 FMAs per 9 loads.
// 3. The power tile sp[k][t] overwrites the frame tile in shared memory.
// 4. Each thread owns (mel bin m, 4 frames): per bin k one coalesced load
//    of MelT[k, m] and one broadcast float4 of power, then the log and the
//    store of out[b, t, m], zero past the frame count.
//
// What the simple design leaves on the table: the tensor cores (a 3xTF32
// split keeps f32 accuracy), an FFT in place of the folded product, and
// the mel banks' sparsity (each bin touches two filters).

#include <cfloat>

#include "common.cuh"

namespace openasr {
namespace {

constexpr int kThreads = 256;  // one thread per FFT bin below the Nyquist
constexpr int kTile = 32;      // frames per block

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ frames, const float2* __restrict__ cs,
             const float* __restrict__ mel, const int* __restrict__ feat_lengths,
             float* __restrict__ out, int T, int ws, int K, int M,
             long long batch_stride, long long frame_stride, bool use_log) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n_out = min(kTile, T - t0);
  const int n_valid = min(n_out, feat_lengths[b] - t0);
  float* out_b = out + ((long long)b * T + t0) * M;
  if (n_valid <= 0) {
    for (int i = threadIdx.x; i < n_out * M; i += kThreads) out_b[i] = 0.f;
    return;
  }

  // 1. the frame tile, transposed: sf[n * kTile + t]
  const float* src = frames + b * batch_stride + t0 * frame_stride;
  for (int i = threadIdx.x; i < ws * kTile; i += kThreads) {
    const int t = i % kTile, n = i / kTile;
    smem[i] = t < n_valid ? src[t * frame_stride + n] : 0.f;
  }
  __syncthreads();

  // 2. re and im of bin k over the tile's frames
  const int k = threadIdx.x;
  float re[kTile], im[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) re[t] = im[t] = 0.f;
  if (k < K) {
#pragma unroll 4
    for (int n = 0; n < ws; ++n) {
      const float2 w = cs[(long long)n * K + k];
      const float4* f = reinterpret_cast<const float4*>(smem + n * kTile);
#pragma unroll
      for (int j = 0; j < kTile / 4; ++j) {
        const float4 v = f[j];
        re[4 * j + 0] = fmaf(v.x, w.x, re[4 * j + 0]);
        im[4 * j + 0] = fmaf(v.x, w.y, im[4 * j + 0]);
        re[4 * j + 1] = fmaf(v.y, w.x, re[4 * j + 1]);
        im[4 * j + 1] = fmaf(v.y, w.y, im[4 * j + 1]);
        re[4 * j + 2] = fmaf(v.z, w.x, re[4 * j + 2]);
        im[4 * j + 2] = fmaf(v.z, w.y, im[4 * j + 2]);
        re[4 * j + 3] = fmaf(v.w, w.x, re[4 * j + 3]);
        im[4 * j + 3] = fmaf(v.w, w.y, im[4 * j + 3]);
      }
    }
  }
  __syncthreads();  // every read of the frame tile is done

  // 3. the power tile sp[k * kTile + t] over the frame tile
  if (k < K) {
    float4* p = reinterpret_cast<float4*>(smem + k * kTile);
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      p[j] = make_float4(re[4 * j] * re[4 * j] + im[4 * j] * im[4 * j],
                         re[4 * j + 1] * re[4 * j + 1] + im[4 * j + 1] * im[4 * j + 1],
                         re[4 * j + 2] * re[4 * j + 2] + im[4 * j + 2] * im[4 * j + 2],
                         re[4 * j + 3] * re[4 * j + 3] + im[4 * j + 3] * im[4 * j + 3]);
    }
  }
  __syncthreads();

  // 4. the mel product, the log and the store: item = (4-frame group, m)
  for (int item = threadIdx.x; item < M * (kTile / 4); item += kThreads) {
    const int m = item % M, g = item / M;
    if (4 * g >= n_out) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < K; ++kk) {
      const float w = mel[(long long)kk * M + m];
      const float4 p = reinterpret_cast<const float4*>(smem + kk * kTile)[g];
      acc[0] = fmaf(p.x, w, acc[0]);
      acc[1] = fmaf(p.y, w, acc[1]);
      acc[2] = fmaf(p.z, w, acc[2]);
      acc[3] = fmaf(p.w, w, acc[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * g + i;
      if (t >= n_out) break;
      const float v = use_log ? logf(fmaxf(acc[i], FLT_EPSILON)) : acc[i];
      out_b[(long long)t * M + m] = t < n_valid ? v : 0.f;
    }
  }
}

}  // namespace
}  // namespace openasr

extern "C" {

// out [B, T, M] f32 (contiguous) = the log-mel (use_log) or mel energies of
// frames: frame t of utterance b is the ws floats at
// frames + b * batch_stride + t * frame_stride; cs [ws, K, 2] f32 holds the
// folded cos and sin matrices over the K bins below the Nyquist; mel [K, M]
// f32; feat_lengths [B] int32 (frames at or past it are written as 0).
int openasr_fbank(const void* frames, const void* cs, const void* mel,
                  const void* feat_lengths, void* out, int B, int T, int ws,
                  int K, int M, long long batch_stride, long long frame_stride,
                  int use_log, int device, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || ws < 1 || K < 1 ||
      K > openasr::kThreads || M < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // the frame tile [ws][kTile], later the power tile [K][kTile]
  const size_t smem = sizeof(float) * openasr::kTile * (ws > K ? ws : K);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !smem_set[device]) {
    err = cudaFuncSetAttribute(openasr::fbank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  const dim3 grid((T + openasr::kTile - 1) / openasr::kTile, B);
  openasr::fbank_kernel<<<grid, openasr::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float2*>(cs),
      static_cast<const float*>(mel), static_cast<const int*>(feat_lengths),
      static_cast<float*>(out), T, ws, K, M, batch_stride, frame_stride,
      use_log != 0);
  return cudaGetLastError();
}

}  // extern "C"
