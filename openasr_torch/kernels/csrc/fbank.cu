// Fused log-mel fbank core for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openasr_tpu/kernels/fbank_fused.py:
// _fbank_kernel (:90).  Per frame f [ws] f32 of an utterance, Kaldi's fbank
// after framing and dither:
//
//   1. DC removal (minus the frame's mean), 2. preemphasis
//   y_0 = (1 - p) x_0, y_n = x_n - p x_{n-1}, 3. the config's window,
//   4. zero padding to nfft, 5. the power |X_k|^2 of the DFT over the
//   bins k < nfft/2 (the Nyquist bin carries no mel weight), 6. the mel
//   product, 7. log(max(., FLT_EPSILON)), or no log (use_log false);
//
// frames at or past feat_lengths[b] are written as 0.  Frames come in as
// f32 and features go out as f32.
//
// Bound on the H100: bytes.  A frame needs about 15 500 operations at ws
// 400, nfft 512, 80 bins (the FFT's 2.5 nfft log2 nfft, the banks'
// nonzeros, the pre-FFT steps) against the hop's 640 new bytes of
// waveform and 4 M bytes written: at the f32 rate of the data (67 TFLOP/s)
// the bytes' time at 3.35 TB/s bounds it.  This kernel computes in
// float64 (34 TFLOP/s, see Precision), where the same operations would
// take longer than the bytes.
//
// Precision.  The FFT and everything from the frame's samples to the mel
// sums run in float64 (the H100's float64 rate is half its f32 rate).  An
// f32 FFT's rounding is relative to the frame's largest bin, and Kaldi's
// log-mel reads bins 100 dB below it (the int16 quantization floor beside
// loud tones): on the smoke test's training batch an f32 version of this
// kernel was 4.6e-2 from a float64 evaluation where the plain folded f32
// products are 1.9e-3, and the float64 one 4.5e-4 (PERF.md, Findings).
//
// Three kernels, selected from the config (not a fallback):
//
// - nfft = 64 R, R = 2 .. 16 (nfft 128-1024; every repo config is 512):
//   fbank_fft_kernel<R>.  Persistent blocks of W warps (W <= 8, from the
//   shared memory nfft needs; as many blocks as the SMs hold) load the
//   tables once and walk the (utterance, 16-frame tile) pairs.  On the
//   strided route (frame stride < ws: frames are a view of the padded
//   waves) a block stages a tile's contiguous sample span, (valid frames
//   - 1) * stride + ws floats, once in shared memory with 16-byte loads;
//   materialized frames (stride >= ws, the dithered route) are read per
//   frame.  A warp takes one frame at a time, each lane reading and
//   widening its samples once: the mean by a warp sum, then preemphasis
//   and the window ([ws] from float64 on the host) as it packs the real
//   frame into N = nfft/2 complex values z_j = v_2j + i v_2j+1; the
//   N-point FFT as four steps with the frame in registers (R-point FFTs
//   in registers, twiddles, 32-point FFTs across the lanes by shuffles);
//   the real-FFT post-processing X_k = (Z_k + conj Z_{N-k}) / 2 + W^k (Z_k
//   - conj Z_{N-k}) / 2i through shared memory, bins k and N - k from one
//   pair of loads; the power.
//   The twiddles W^k = exp(-2 pi i k / nfft), k < nfft/2, come from one
//   table built in float64 and uploaded as its f32 part and f32 rest; no
//   __sinf/__cosf.  Then the sparse mel product: mel bin m sums its n_m
//   weights (Kaldi's layout: first bin lo_m, count, packed weights, from
//   `mel_banks` in float64 -> f32) over the power in bin order, the lanes
//   taking the bins in `mel_order` (largest first, snaked, so that their
//   weight counts even out), the log, and the store of out[b, t, m].
// - any other power-of-two nfft (up to 8192, the tables and one warp's
//   buffer in shared memory): fbank_fft_smem_kernel, the same steps with
//   an in-place radix-2 FFT in shared memory.
// - nfft not a power of two (round_to_power_of_two false): fbank_folded_kernel,
//   the TPU's form.  DC removal, preemphasis, the window and the zero-padded
//   DFT fold into cs [ws, K, 2] (kernels/fbank.py: fused_matrices); the
//   block's 256 threads loop over the K bins, each carrying re and im of
//   its bin over the tile's 32 frames (staged transposed in shared memory)
//   in registers (f32, as the plain version), then the same sparse mel
//   product.  About 29x the operations of the FFT at ws 400, but any K
//   whose tile fits.

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace openasr {
namespace {

constexpr int kTile = 32;          // folded kernel: frames per block
constexpr int kFftTile = 16;       // FFT kernels: frames per tile
constexpr int kMaxWarps = 8;       // FFT kernels: frames in flight per block
constexpr int kFoldedThreads = 256;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

struct FbankArgs {
  const float* frames;
  long long batch_stride, frame_stride;
  const int* feat_lengths;
  float* out;
  int B, T, ws, nfft, M, n_mel_w;
  const float* window;    // [ws]
  const float2* twiddle;  // [nfft/2]: (cos, sin) of 2 pi k / nfft, in f32
  const float2* twiddle_lo;  // [nfft/2]: float64 value - twiddle, in f32
  const int* mel_idx;     // [3, M]: first bin, count, offset into mel_w
  const float* mel_w;     // [n_mel_w]
  const int* mel_order;   // [M]: the mel bins by lane and round (FFT kernels)
  const float2* cs;       // folded route: [ws, K, 2]
  double preemph;
  bool remove_dc, use_log, stage;
};

// Zero the rows of a tile of `tile` frames past the frame count; -> the
// valid rows (<= 0: the whole tile was zeroed, nothing else to do).
__device__ __forceinline__ int tile_rows(const FbankArgs& a, int b, int t0, int tile,
                                         int* n_out) {
  *n_out = min(tile, a.T - t0);
  const int n_valid = max(0, min(*n_out, a.feat_lengths[b] - t0));
  float* out_b = a.out + ((long long)b * a.T + t0) * a.M;
  for (int i = n_valid * a.M + threadIdx.x; i < *n_out * a.M; i += blockDim.x)
    out_b[i] = 0.f;
  return n_valid;
}

// The sparse mel tables into shared memory: idx [3, M] ints, then weights.
__device__ __forceinline__ void stage_mel(const FbankArgs& a, int* s_idx, float* s_w) {
  for (int i = threadIdx.x; i < 3 * a.M; i += blockDim.x) s_idx[i] = a.mel_idx[i];
  for (int i = threadIdx.x; i < a.n_mel_w; i += blockDim.x) s_w[i] = a.mel_w[i];
}

__device__ __forceinline__ float mel_out(float acc, bool use_log) {
  return use_log ? logf(fmaxf(acc, FLT_EPSILON)) : acc;
}

// Shared memory of the FFT kernels, in floats, and its parts' offsets:
// the twiddle table, `lane_tw` per-lane twiddles of the register kernel,
// the window, the mel tables, the staged span, then per warp the FFT's
// buffer (half double2, padded by one every 32) and the powers (half f32).
struct FftSmem {
  int tw, lane_tw, win, idx, w, ord, span, bufs, per_warp, total;
};

inline FftSmem fft_smem(int ws, int nfft, int M, int n_mel_w, int span, int warps,
                        int lane_tw) {
  const int half = nfft / 2;
  auto up4 = [](int n) { return (n + 3) / 4 * 4; };
  FftSmem s;
  s.tw = 0;                               // half double2
  s.lane_tw = s.tw + 4 * half;            // lane_tw x 32 double2
  s.win = s.lane_tw + 128 * lane_tw;      // ws doubles
  s.idx = s.win + 2 * ws;                 // 3 M ints
  s.w = s.idx + 3 * M;                    // n_mel_w
  s.ord = s.w + n_mel_w;                  // M ints
  s.span = up4(s.ord + M);                // 16-byte aligned; the staged chunks
  s.bufs = up4(s.span + (span ? span + 8 : 0));  // reach up to 6 past it
  s.per_warp = up4(4 * (half + (half + 31) / 32) + half);
  s.total = s.bufs + warps * s.per_warp;
  return s;
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// W^k = exp(-2 pi i k / nfft) for k < nfft from the table of k < nfft/2
// (W^(k + nfft/2) = -W^k).
__device__ __forceinline__ double2 twiddle(const double2* tw, int k, int half) {
  const double2 w = tw[k < half ? k : k - half];
  return k < half ? w : make_double2(-w.x, -w.y);
}

// The block's tables, once: the twiddles in float64 (each the float64
// value's f32 part plus its f32 rest), the window in float64, and the
// sparse mel tables with the order the lanes take the mel bins in.
__device__ void fft_block_tables(const FbankArgs& a, const FftSmem& lay, float* smem) {
  const int half = a.nfft / 2;
  double2* tw = reinterpret_cast<double2*>(smem + lay.tw);
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float2 hi = a.twiddle[i], lo = a.twiddle_lo[i];
    // W^k = cos - i sin
    tw[i] = make_double2((double)hi.x + (double)lo.x, -((double)hi.y + (double)lo.y));
  }
  double* win = reinterpret_cast<double*>(smem + lay.win);
  for (int i = threadIdx.x; i < a.ws; i += blockDim.x) win[i] = a.window[i];
  stage_mel(a, reinterpret_cast<int*>(smem + lay.idx), smem + lay.w);
  int* ord = reinterpret_cast<int*>(smem + lay.ord);
  for (int i = threadIdx.x; i < a.M; i += blockDim.x) ord[i] = a.mel_order[i];
}

// A tile's frames: on the strided route its valid frames' samples staged
// once, with 16-byte loads from the aligned chunk at or below the first
// sample (the chunks lie in the allocation).  -> where frame t starts.
__device__ const float* fft_tile_frames(const FbankArgs& a, const FftSmem& lay, int b,
                                        int t0, int n_valid, float* smem) {
  const float* src = a.frames + b * a.batch_stride + t0 * a.frame_stride;
  if (!a.stage) return src;
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) % 16) / 4);
  const float4* base = reinterpret_cast<const float4*>(src - shift);
  const int n = shift + (n_valid - 1) * static_cast<int>(a.frame_stride) + a.ws;
  float4* dst = reinterpret_cast<float4*>(smem + lay.span);
  for (int i = threadIdx.x; i < (n + 3) / 4; i += blockDim.x) dst[i] = base[i];
  return smem + lay.span + shift;
}

// The blocks walk the (utterance, 16-frame tile) pairs, a block's warps a
// frame each at a time: frame(x, out_row, buf, pw) for each valid frame.
template <typename Frame>
__device__ __forceinline__ void fft_tiles(const FbankArgs& a, const FftSmem& lay,
                                          float* smem, Frame frame) {
  const int tiles_per_utt = (a.T + kFftTile - 1) / kFftTile;
  const int n_tiles = a.B * tiles_per_utt;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  float* buf = smem + lay.bufs + warp * lay.per_warp;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_utt, t0 = (tile % tiles_per_utt) * kFftTile;
    int n_out;
    const int n_valid = tile_rows(a, b, t0, kFftTile, &n_out);
    if (n_valid <= 0) continue;
    __syncthreads();  // the previous tile's frames are done with the span
    const float* span = fft_tile_frames(a, lay, b, t0, n_valid, smem);
    __syncthreads();
    for (int t = warp; t < n_valid; t += warps)
      frame(span + t * a.frame_stride, a.out + ((long long)b * a.T + t0 + t) * a.M, buf);
  }
}

// The frame's mean (DC removal), by a warp sum in float64.
__device__ __forceinline__ double frame_mean(const FbankArgs& a, const float* x, int lane) {
  if (!a.remove_dc) return 0.0;
  double s = 0.0;
  for (int n = lane; n < a.ws; n += 32) s += x[n];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s / a.ws;
}

// Sample n of the frame after DC removal, preemphasis and the window (0
// past ws: the zero padding).
__device__ __forceinline__ double frame_sample(const FbankArgs& a, const float* x,
                                               const double* win, double mu, int n) {
  if (n >= a.ws) return 0.0;
  const double c = x[n] - mu;
  const double prev = n > 0 ? x[n - 1] - mu : c;
  return (c - a.preemph * prev) * win[n];
}

// From Z, the half-point FFT of the packed frame (Z_k at zbuf[pos(k)]):
// the power of the real spectrum's bins k < half, X_k = (Z_k + conj
// Z_{N-k}) / 2 + W^k (Z_k - conj Z_{N-k}) / 2i; then the sparse mel
// product in bin order, the log and the store of the frame's row o.
template <typename Pos>
__device__ __forceinline__ void power_and_mel(const FbankArgs& a, const FftSmem& lay,
                                              const float* smem, const double2* zbuf,
                                              float* pw, Pos pos, float* o, int lane) {
  const int half = a.nfft / 2;
  const double2* tw = reinterpret_cast<const double2*>(smem + lay.tw);
  // bins k and half - k from the same two values of Z (W^(half-k) =
  // -conj W^k); bin 0 is real, bin half/2 is |Z_{half/2}|
  for (int k = lane; k < half / 2; k += 32) {
    const double2 zk = zbuf[pos(k)];
    if (k == 0) {
      const double2 zm = zbuf[pos(half / 2)];
      pw[0] = static_cast<float>((zk.x + zk.y) * (zk.x + zk.y));
      pw[half / 2] = static_cast<float>(zm.x * zm.x + zm.y * zm.y);
      continue;
    }
    const double2 zc = zbuf[pos(half - k)];
    const double2 w = tw[k];
    const double2 xk = cadd(make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y - zc.y)),
                            cmul(w, make_double2(0.5 * (zk.y + zc.y), -0.5 * (zk.x - zc.x))));
    const double2 xc = cadd(make_double2(0.5 * (zc.x + zk.x), 0.5 * (zc.y - zk.y)),
                            cmul(make_double2(-w.x, w.y),
                                 make_double2(0.5 * (zc.y + zk.y), -0.5 * (zc.x - zk.x))));
    pw[k] = static_cast<float>(xk.x * xk.x + xk.y * xk.y);
    pw[half - k] = static_cast<float>(xc.x * xc.x + xc.y * xc.y);
  }
  __syncwarp();
  // the mel bins in `mel_order`, which evens out the lanes' weight counts
  const int* m_idx = reinterpret_cast<const int*>(smem + lay.idx);
  const int* ord = reinterpret_cast<const int*>(smem + lay.ord);
  const float* m_w = smem + lay.w;
  for (int j = lane; j < a.M; j += 32) {
    const int m = ord[j];
    const int lo = m_idx[m], cnt = m_idx[a.M + m], off = m_idx[2 * a.M + m];
    double acc = 0.0;
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) acc += (double)m_w[off + i] * (double)pw[lo + i];
    o[m] = mel_out(static_cast<float>(acc), a.use_log);
  }
  __syncwarp();
}

// nfft = 64 R (R = 2 .. 16): the half = 32 R point FFT as four steps with
// the frame in registers.  Lane L holds z[32 n1 + L], n1 < R; an R-point
// decimation-in-frequency FFT in registers; the twiddles W_half^(L k1);
// a 32-point decimation-in-frequency FFT across the lanes by shuffles, one
// for each register.  Register r of lane L then holds
// Z[brev_R(r) + R brev_32(L)], stored at zbuf[33 r + L].  The per-lane
// twiddles of the last two steps come from `lane_tw`, [R + 5][32], built
// once a block.
// (A hint of 3 blocks an SM keeps R <= 8 at 85 registers or fewer: 2-5%
// faster on the H100 than ptxas's own 103 at R = 8; PERF.md, Findings.)
template <int R>
__global__ void __launch_bounds__(32 * kMaxWarps, R >= 16 ? 1 : 3)
fbank_fft_kernel(FbankArgs a, FftSmem lay) {
  constexpr int kLogR = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  static_assert(R == 1 << kLogR, "R is 2, 4, 8 or 16");
  constexpr int kHalf = 32 * R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  fft_block_tables(a, lay, smem);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const double2* tw = reinterpret_cast<const double2*>(smem + lay.tw);
  double2* ltw = reinterpret_cast<double2*>(smem + lay.lane_tw);
  for (int i = threadIdx.x; i < (R + 5) * 32; i += blockDim.x) {
    const int r = i / 32, l = i % 32;
    if (r < R) {  // W_half^(l k1) = W^(2 l k1), k1 = brev_R(r)
      ltw[i] = twiddle(tw, 2 * l * (int)(__brev(r) >> (32 - kLogR)), kHalf);
    } else {      // stage s = 16 >> (r - R): W_{2s}^(l & (s-1)) = W^((l & (s-1)) 32 R / s)
      const int st = 16 >> (r - R);
      ltw[i] = twiddle(tw, (l & (st - 1)) * 32 * R / st, kHalf);
    }
  }
  const double* win = reinterpret_cast<const double*>(smem + lay.win);
  auto pos = [](int k) {
    return (int)(__brev(k % R) >> (32 - kLogR)) * 33 + (int)(__brev(k / R) >> 27);
  };
  fft_tiles(a, lay, smem, [&](const float* x, float* o, float* buf) {
    double2* zbuf = reinterpret_cast<double2*>(buf);
    float* pw = buf + 4 * (kHalf + R);
    // the lane's samples n = 2 (32 r + lane) and n + 1, and x[n - 1], read
    // and widened once; the mean from them (by a warp sum)
    double2 v[R];
    double xp[R];
    double sum = 0.0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = 2 * (32 * r + lane);
      v[r] = make_double2(n < a.ws ? x[n] : 0.f, n + 1 < a.ws ? x[n + 1] : 0.f);
      xp[r] = n > 0 && n <= a.ws ? x[n - 1] : v[r].x;
      sum += v[r].x + v[r].y;
    }
    double mu = 0.0;
    if (a.remove_dc) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      mu = sum / a.ws;
    }
    // DC removal, preemphasis and the window: z_j = v_2j + i v_2j+1
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = 2 * (32 * r + lane);
      const double ce = v[r].x - mu, co = v[r].y - mu;
      v[r].x = n < a.ws ? (ce - a.preemph * (xp[r] - mu)) * win[n] : 0.0;
      v[r].y = n + 1 < a.ws ? (co - a.preemph * ce) * win[n + 1] : 0.0;
    }
    // R-point DIF in registers: W_{2len}^t = W^(32 t R / len)
#pragma unroll
    for (int len = R / 2; len >= 1; len /= 2) {
#pragma unroll
      for (int g = 0; g < R; g += 2 * len) {
#pragma unroll
        for (int i = 0; i < len; ++i) {
          const double2 u = v[g + i], w = v[g + i + len];
          v[g + i] = cadd(u, w);
          v[g + i + len] = cmul(csub(u, w), tw[32 * i * R / len]);
        }
      }
    }
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], ltw[r * 32 + lane]);
    // 32-point DIF across the lanes
#pragma unroll
    for (int si = 0; si < 5; ++si) {
      const int st = 16 >> si;
      const bool upper = lane & st;
      const double2 w = ltw[(R + si) * 32 + lane];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double2 p = make_double2(__shfl_xor_sync(0xffffffffu, v[r].x, st),
                                       __shfl_xor_sync(0xffffffffu, v[r].y, st));
        v[r] = upper ? cmul(csub(p, v[r]), w) : cadd(v[r], p);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) zbuf[33 * r + lane] = v[r];
    __syncwarp();
    power_and_mel(a, lay, smem, zbuf, pw, pos, o, lane);
  });
}

// Any other power-of-two nfft: the packed frame in bit-reversed order in
// shared memory, an in-place radix-2 FFT of nfft/2 points there, one
// __syncwarp a stage.
__global__ void __launch_bounds__(32 * kMaxWarps)
fbank_fft_smem_kernel(FbankArgs a, FftSmem lay, int log2_half) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  fft_block_tables(a, lay, smem);
  const int half = a.nfft / 2;
  const int lane = threadIdx.x % 32;
  const double2* tw = reinterpret_cast<const double2*>(smem + lay.tw);
  const double* win = reinterpret_cast<const double*>(smem + lay.win);
  fft_tiles(a, lay, smem, [&](const float* x, float* o, float* fbuf) {
    double2* buf = reinterpret_cast<double2*>(fbuf);
    float* pw = fbuf + 4 * (half + (half + 31) / 32);
    const double mu = frame_mean(a, x, lane);
    for (int j = lane; j < half; j += 32)
      buf[__brev(j) >> (32 - log2_half)] = make_double2(
          frame_sample(a, x, win, mu, 2 * j), frame_sample(a, x, win, mu, 2 * j + 1));
    __syncwarp();
    for (int lh = 0; lh < log2_half; ++lh) {
      const int h = 1 << lh;
      for (int q = lane; q < half / 2; q += 32) {
        const int p = q & (h - 1);
        const int i0 = ((q >> lh) << (lh + 1)) + p;
        const double2 u = buf[i0], z = cmul(buf[i0 + h], tw[p << (log2_half - lh)]);
        buf[i0] = cadd(u, z);
        buf[i0 + h] = csub(u, z);
      }
      __syncwarp();
    }
    power_and_mel(a, lay, smem, buf, pw, [](int k) { return k; }, o, lane);
  });
}

__global__ void __launch_bounds__(kFoldedThreads)
fbank_folded_kernel(FbankArgs a, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  int n_out;
  const int n_valid = tile_rows(a, b, t0, kTile, &n_out);
  if (n_valid <= 0) return;

  float* sf = smem;                    // frames, transposed: [ws][kTile]
  float* sp = sf + a.ws * kTile;       // power: [K][kTile]
  int* m_idx = reinterpret_cast<int*>(sp + K * kTile);
  float* m_w = reinterpret_cast<float*>(m_idx + 3 * a.M);
  stage_mel(a, m_idx, m_w);
  const float* src = a.frames + b * a.batch_stride + t0 * a.frame_stride;
  for (int i = threadIdx.x; i < a.ws * kTile; i += blockDim.x) {
    const int t = i % kTile, n = i / kTile;
    sf[i] = t < n_valid ? src[t * a.frame_stride + n] : 0.f;
  }
  __syncthreads();

  // re and im of each bin over the tile's frames, then its power
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) re[t] = im[t] = 0.f;
#pragma unroll 4
    for (int n = 0; n < a.ws; ++n) {
      const float2 w = a.cs[(long long)n * K + k];
      const float4* f = reinterpret_cast<const float4*>(sf + n * kTile);
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
    float4* pk = reinterpret_cast<float4*>(sp + k * kTile);
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j)
      pk[j] = make_float4(re[4 * j] * re[4 * j] + im[4 * j] * im[4 * j],
                          re[4 * j + 1] * re[4 * j + 1] + im[4 * j + 1] * im[4 * j + 1],
                          re[4 * j + 2] * re[4 * j + 2] + im[4 * j + 2] * im[4 * j + 2],
                          re[4 * j + 3] * re[4 * j + 3] + im[4 * j + 3] * im[4 * j + 3]);
  }
  __syncthreads();

  // the sparse mel product, the log and the store: item = (4-frame group, m)
  float* out_b = a.out + ((long long)b * a.T + t0) * a.M;
  for (int item = threadIdx.x; item < a.M * (kTile / 4); item += blockDim.x) {
    const int m = item % a.M, g = item / a.M;
    if (4 * g >= n_valid) continue;
    const int lo = m_idx[m], cnt = m_idx[a.M + m], off = m_idx[2 * a.M + m];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < cnt; ++i) {
      const float w = m_w[off + i];
      const float4 q = reinterpret_cast<const float4*>(sp + (lo + i) * kTile)[g];
      acc[0] = fmaf(q.x, w, acc[0]);
      acc[1] = fmaf(q.y, w, acc[1]);
      acc[2] = fmaf(q.z, w, acc[2]);
      acc[3] = fmaf(q.w, w, acc[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * g + i;
      if (t < n_valid) out_b[(long long)t * a.M + m] = mel_out(acc[i], a.use_log);
    }
  }
}

// The opt-in to more than 48 KB of dynamic shared memory, once per kernel
// and device.
cudaError_t allow_big_smem(const void* kernel, int device, int* asked) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!asked[device])
    asked[device] = 1 + cudaFuncSetAttribute(
                            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return static_cast<cudaError_t>(asked[device] - 1);
}

}  // namespace
}  // namespace openasr

extern "C" {

// out [B, T, M] f32 (contiguous) = the log-mel (use_log) or mel energies of
// frames: frame t of utterance b is the ws floats at
// frames + b * batch_stride + t * frame_stride; feat_lengths [B] int32
// (frames at or past it are written as 0).  Tables: window [ws] f32,
// twiddle [nfft/2, 2] f32 and its float64 rest twiddle_lo, mel_idx [3, M]
// int32 (first bin, count, offset), mel_w [n_mel_w] f32, mel_order [M] int32
// (a permutation of the mel bins); cs [ws, nfft/2, 2] f32 only when nfft is not a
// power of two (the folded kernel), else null.
int openasr_fbank(const void* frames, const void* feat_lengths, void* out,
                  const void* window, const void* twiddle, const void* twiddle_lo,
                  const void* mel_idx, const void* mel_w, const void* mel_order,
                  const void* cs, int B, int T, int ws, int nfft,
                  int M, int n_mel_w, long long batch_stride, long long frame_stride,
                  double preemph, int remove_dc, int use_log, int device, void* stream) {
  using namespace openasr;
  const int half = nfft / 2;
  if (B < 1 || B > 65535 || T < 1 || ws < 1 || nfft < 4 || ws > nfft || M < 1 ||
      n_mel_w < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FbankArgs a{static_cast<const float*>(frames), batch_stride, frame_stride,
              static_cast<const int*>(feat_lengths), static_cast<float*>(out),
              B, T, ws, nfft, M, n_mel_w,
              static_cast<const float*>(window), static_cast<const float2*>(twiddle),
              static_cast<const float2*>(twiddle_lo),
              static_cast<const int*>(mel_idx), static_cast<const float*>(mel_w),
              static_cast<const int*>(mel_order), static_cast<const float2*>(cs),
              preemph, remove_dc != 0, use_log != 0, false};
  const dim3 grid((T + kTile - 1) / kTile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pow2 = (nfft & (nfft - 1)) == 0;
  if (pow2) {
    int log2_half = 0;
    while ((1 << log2_half) < half) ++log2_half;
    const int R = half / 32;
    const bool reg = R == 2 || R == 4 || R == 8 || R == 16;
    const int lane_tw = reg ? R + 5 : 0;
    // stage the tile's span when frames overlap and it fits beside 8 warps'
    // buffers; else read frames in place.  Then as many warps as fit.
    const long long span = (kFftTile - 1) * frame_stride + ws;
    const int cap = kSmemLimit / 4;
    a.stage = frame_stride < ws &&
              fft_smem(ws, nfft, M, n_mel_w, static_cast<int>(span), kMaxWarps, lane_tw)
                      .total <= cap;
    const int span_f = a.stage ? static_cast<int>(span) : 0;
    int warps = kMaxWarps;
    while (warps > 1 && fft_smem(ws, nfft, M, n_mel_w, span_f, warps, lane_tw).total > cap)
      --warps;
    const FftSmem lay = fft_smem(ws, nfft, M, n_mel_w, span_f, warps, lane_tw);
    if (lay.total > cap) return cudaErrorInvalidValue;
    const size_t bytes = sizeof(float) * lay.total;
    const void* kernel = R == 2    ? reinterpret_cast<const void*>(fbank_fft_kernel<2>)
                         : R == 4  ? reinterpret_cast<const void*>(fbank_fft_kernel<4>)
                         : R == 8  ? reinterpret_cast<const void*>(fbank_fft_kernel<8>)
                         : R == 16 ? reinterpret_cast<const void*>(fbank_fft_kernel<16>)
                                   : reinterpret_cast<const void*>(fbank_fft_smem_kernel);
    static int asked[5][kMaxDevices] = {};
    err = allow_big_smem(kernel, device, asked[reg ? log2_half - 6 : 4]);
    if (err != cudaSuccess) return err;
    // a persistent grid: as many blocks as the SMs hold, walking the tiles
    static int sms[kMaxDevices] = {};
    if (!sms[device]) {
      err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, bytes);
    if (err != cudaSuccess) return err;
    const long long n_tiles = (long long)B * ((T + kFftTile - 1) / kFftTile);
    const long long most = (long long)sms[device] * (per_sm > 0 ? per_sm : 1);
    const dim3 fgrid(static_cast<unsigned>(n_tiles < most ? n_tiles : most));
    const dim3 block(32 * warps);
    switch (reg ? R : 0) {
      case 2: fbank_fft_kernel<2><<<fgrid, block, bytes, s>>>(a, lay); break;
      case 4: fbank_fft_kernel<4><<<fgrid, block, bytes, s>>>(a, lay); break;
      case 8: fbank_fft_kernel<8><<<fgrid, block, bytes, s>>>(a, lay); break;
      case 16: fbank_fft_kernel<16><<<fgrid, block, bytes, s>>>(a, lay); break;
      default: fbank_fft_smem_kernel<<<fgrid, block, bytes, s>>>(a, lay, log2_half); break;
    }
    return cudaGetLastError();
  }
  if (cs == nullptr) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTile * (ws + half) + 3 * M + n_mel_w);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  static int asked[kMaxDevices] = {};
  err = allow_big_smem(reinterpret_cast<const void*>(fbank_folded_kernel), device, asked);
  if (err != cudaSuccess) return err;
  fbank_folded_kernel<<<grid, kFoldedThreads, smem, s>>>(a, half);
  return cudaGetLastError();
}

}  // extern "C"
