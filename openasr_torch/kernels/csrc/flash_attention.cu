// Flash attention forward for Hopper (sm_90a): FA2's forward on the tensor
// cores.
//
// Replaces the Pallas TPU kernel
// openasr_tpu/kernels/flash_attention.py:_fwd_kernel (:146): online-softmax
// attention over key tiles with key padding from kv_lengths, an optional
// causal mask (kpos <= qpos) that skips key tiles wholly above the
// diagonal, and fully masked rows giving O = 0 and lse = +inf (:218-230).
// Its chunk mode has no TPU kernel: the JAX package trains a streaming
// encoder through dense attention under chunk_bias
// (openasr_tpu/models/encoder.py:205-227).  Here it is a runtime mask
// (openasr::Mask, flash_tiles.cuh): each query sees the keys of its own
// chunk and of `left` chunks before it, so a 64-query tile walks only
// those keys, from the first row's window start to the last row's chunk
// end, and a row with no visible key (a padded query whose window starts
// past the length) gets O = 0 and lse = +inf.
// Outputs O [B, Tq, H, D] in q's dtype and lse [B, H, Tq] f32.  S = Q K^T
// * scale, m, l and acc are f32.  With dropout (:200-216) the keep mask is
// the positional hash of common.cuh at each (qpos, kpos): l sums the
// undropped p, acc takes p * keep, and O = acc / (l (1 - rate)) = (P o D) V
// with P the normalized weights and D = keep / (1 - rate), as on the TPU.
//
// Bound on the H100 at the path's shapes (T' 32-358, D 64): bytes, in bf16
// and in f32 alike.  Reading q, k, v once and writing O and lse once takes
// longer at 3.35 TB/s than the two Tq x Tk x D products at 989 TFLOP/s in
// bf16, or in f32 as 3xTF32 at a third of TF32's 495 TFLOP/s.
//
// Design, the mirror of the backward's dQ kernel (flash_attention_bwd.cu),
// on mma.sync (not wgmma: at these lengths the loads, not the tensor cores'
// rate, set the time):
// - One block of 4 warps per (64-query tile, head, batch); warp w owns
//   queries q0 + 16w..+15.  A lane holds two rows of the accumulator
//   fragments (g and g + 8, g = lane / 4); each row's running max m lives
//   in the lane quad that holds the row, reduced with two shuffles a step,
//   and its sum l as a partial a lane, reduced once at the end.
// - The Q tile is staged once with 16-byte cp.async; K and V are walked in
//   32-key steps double-buffered with cp.async commit/wait groups, so step
//   i + 1 loads while step i computes, through the strides of the
//   [B, T, H, D] projection views.  The walk covers the keys the mask lets
//   the tile's rows see (from 0, or the first row's chunk window, to
//   kv_lengths[b] and, under causal, the tile's diagonal, or the last
//   row's chunk end); a warp skips the products of a step that holds no
//   pair it can see (rows past Tq, or keys outside its rows' windows),
//   which is exact: that step's p are all 0.  A tile with no valid key
//   walks nothing and writes zeros and lse = +inf.
// - S = Q K^T with Q as the A operand and K as the B operand through the
//   non-transposing load; the masks, the exp (exp2 of log2-scaled scores)
//   and the hash at each accumulator element's (qpos, kpos) (c0, c1 at row
//   g, columns 2t and 2t + 1; c2, c3 at row g + 8) turn S into P, or
//   P o keep, in registers.  Those accumulator fragments are the A operand of
//   acc += P V as they stand (Bf16Ops::from_c, Tf32x3Ops::from_c), with V
//   the B operand through the transposing load.
// - bf16 (Bf16Ops): m16n8k16; the weights are rounded to bf16 before P V,
//   where JAX casts them (`p.astype(v.dtype)`, :219-222), but as P o keep:
//   the 1 / (1 - rate) of D joins 1 / l in f32 at the end, as FA2's
//   forward does.  JAX rounds P o D itself, so a row's largest weight,
//   exactly 1 here, becomes 1 / 0.9 rounded to 1.109375 there, and the
//   outputs of the decoder's first causal rows (one key or a few, |O| up
//   to about 5) would land a bf16 step (2^-5 above 4) off the f32 oracle
//   beyond its 2e-2 tolerance.  l and acc stay f32.
// - f32 (Tf32x3Ops): m16n8k8 as 3xTF32 with the k permutation of
//   flash_tiles.cuh, within f32's tolerance (plain TF32 would not be).
// - Q's fragments are re-read from shared memory at each step, as the
//   backward re-reads its own tile's: held in registers, the f32 kernels
//   at D = 128 would need 128 registers for them alone.
// - Epilogue: divide by l (1 - rate), zero the empty rows, stage O
//   through the warp's own rows of the Q tile and write it with 16-byte
//   stores.
// - Shared memory is (64 + 4 * 32) rows of D + 8 elements, above 48 KB
//   (opt-in, asked once per kernel and device) at D = 128 in bf16 and at
//   D >= 64 in f32.
// Registers a thread from ptxas for sm_90a (without / with dropout), no
// instantiation spilling (chip_smoke.py prints them in its [ptxas] line and
// fails on a spill); f32 D = 64, and f32 D = 32 with dropout, through the
// entry point with a hint of 3 blocks an SM (below):
//            bf16       f32
//   D = 32    72 / 75    80 / 116
//   D = 64    95 / 95   168 / 159
//   D = 128  127 / 127  130 / 166

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"

namespace openasr {
namespace {

constexpr int kBlockQ = 64;    // queries per block
constexpr int kThreads = 128;  // 4 warps, 16 queries each
constexpr int kStep = 32;      // keys per step of the walk
constexpr float kNegInf = -1.0e30f;
constexpr float kLn2 = 0.6931471805599453f;

// One launch's arguments, passed to the kernel by value.
struct Args {
  const void *q, *k, *v;
  const int* kv_lengths;
  void* out;
  float* lse;
  int B, H, Tq, Tk;
  Strides qs, ks, vs;
  float sm_scale;
  Mask mask;
  Dropout drop;
  int device;
};

// The block's work, launched through one of the two entry points below.
template <typename Ops, int D, bool kDropout>
__device__ __forceinline__ void fwd_tile(const Args& a) {
  using E = typename Ops::Elem;
  constexpr int kBK = kStep, S = Tiles<Ops, D>::kStride, kK = Ops::kK;
  const E* __restrict__ q = static_cast<const E*>(a.q);
  const E* __restrict__ k = static_cast<const E*>(a.k);
  const E* __restrict__ v = static_cast<const E*>(a.v);
  const int* __restrict__ kv_lengths = a.kv_lengths;
  const int H = a.H, Tq = a.Tq, Tk = a.Tk;
  const Mask mask = a.mask;
  const Strides qs_ = a.qs, ks_ = a.ks, vs_ = a.vs;
  const float sm_scale = a.sm_scale;
  const Dropout drop = a.drop;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* qsm = reinterpret_cast<E*>(smem_raw);  // [kBlockQ][S]
  E* ksm = qsm + kBlockQ * S;                // [2][kBK][S]
  E* vsm = ksm + 2 * kBK * S;                // [2][kBK][S]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int qw = 16 * warp;  // the warp's first row in the query tile
  const uint32_t bh = (uint32_t)(b * H + h);
  const float scale_log2 = sm_scale * kLog2e;

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  // the keys the tile's rows see (the mask's intervals of its first and
  // last row), and those of the warp's 16 rows
  const int q_last = min(q0 + kBlockQ, Tq) - 1;
  const int k_begin = mask.keys_of(q0).x;
  const int k_end = min(n_valid, mask.keys_of(q_last).y);
  const int wk_begin = mask.keys_of(q0 + qw).x;
  const int wk_end = min(n_valid, mask.keys_of(min(q0 + qw + 15, q_last)).y);

  // the lane's two rows (g, g + 8): position, visible keys [klo, khi),
  // running max (log2 units) and the lane's part of the running sum
  int qrow[2], klo[2], khi[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + qw + g + 8 * r;
    const int2 ks = mask.keys_of(qrow[r]);
    klo[r] = ks.x;
    khi[r] = min(ks.y, n_valid);
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (k_begin < k_end) {
    const E* kb = k + b * ks_.b + h * ks_.h;
    const E* vb = v + b * vs_.b + h * vs_.h;
    stage_rows<Ops, D, kBlockQ, kThreads>(qsm, q + b * qs_.b + h * qs_.h, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBK, kThreads>(ksm, kb, ks_.t, k_begin, Tk, tid);
    stage_rows<Ops, D, kBK, kThreads>(vsm, vb, vs_.t, k_begin, Tk, tid);
    cp_async_commit();

    int buf = 0;
    for (int k0 = k_begin; k0 < k_end; k0 += kBK, buf ^= 1) {
      if (k0 + kBK < k_end) {
        stage_rows<Ops, D, kBK, kThreads>(ksm + (buf ^ 1) * kBK * S, kb, ks_.t, k0 + kBK, Tk,
                                          tid);
        stage_rows<Ops, D, kBK, kThreads>(vsm + (buf ^ 1) * kBK * S, vb, vs_.t, k0 + kBK, Tk,
                                          tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const E* kt = ksm + buf * kBK * S;
      const E* vt = vsm + buf * kBK * S;

      // warp-uniform: does this step hold a pair the warp's rows can see?
      if (q0 + qw < Tq && k0 < wk_end && k0 + kBK > wk_begin) {
        // S = Q K^T, [16 queries, kBK keys] a warp
        float s[kBK / 8][4];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / kK; ++kk) {
          typename Ops::A qa;
          Ops::template load_a<S>(qa, qsm, qw, kk * kK, lane);
#pragma unroll
          for (int n2 = 0; n2 < kBK / 16; ++n2) {
            typename Ops::B k0f, k1f;
            Ops::template load_b_nk<S>(k0f, k1f, kt, n2 * 16, kk * kK, lane);
            Ops::mma(s[2 * n2], qa, k0f);
            Ops::mma(s[2 * n2 + 1], qa, k1f);
          }
        }

        // masks, in log2 units: row = query, column = key
        float mt[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int key = k0 + j * 8 + t2 + (e & 1);
            const bool ok = key >= klo[r] && key < khi[r];
            s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
            mt[r] = fmaxf(mt[r], s[j][e]);
          }
        }
        // the step's row max over the quad, the new running max and the
        // rescale of what came before (1 while a row has seen no valid key)
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          const float m_new = fmaxf(m[r], mt[r]);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // s <- P o keep: l sums the undropped weights; masked pairs never
        // reach the exp; 1 / (1 - rate) joins 1 / l at the end
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = s[j][e] > 0.5f * kNegInf ? exp2f(s[j][e] - m[r]) : 0.f;
            l[r] += p;
            if (kDropout) {
              const int key = k0 + j * 8 + t2 + (e & 1);
              const bool keep =
                  dropout_keep(drop.seed, bh, (uint32_t)qrow[r], (uint32_t)key, drop.thresh);
              s[j][e] = keep ? p : 0.f;
            } else {
              s[j][e] = p;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

        // acc += P V, P as the A operand (in bf16 rounded as JAX rounds it)
#pragma unroll
        for (int kq = 0; kq < kBK / kK; ++kq) {
          typename Ops::A pa;
          Ops::from_c(pa, &s[kq * (kK / 8)]);
#pragma unroll
          for (int n2 = 0; n2 < D / 16; ++n2) {
            typename Ops::B v0f, v1f;
            Ops::template load_b_kn<S>(v0f, v1f, vt, kq * kK, n2 * 16, lane);
            Ops::mma(acc[2 * n2], pa, v0f);
            Ops::mma(acc[2 * n2 + 1], pa, v1f);
          }
        }
      }
      __syncthreads();  // buffer `buf` is refilled two steps on
    }
  }

  // epilogue: l over the quad, O = acc / (l (1 - rate)) (0 on empty
  // rows), lse
  const float drop_scale = kDropout ? drop.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      acc[n][e] = l[r] > 0.f ? acc[n][e] * drop_scale / l[r] : 0.f;
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < Tq)
        a.lse[((long long)b * H + h) * Tq + qrow[r]] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : __int_as_float(0x7f800000);  // +inf
  }
  // O through the warp's own rows of the Q tile, then 16-byte stores
  frags_to_smem<Ops, D>(qsm, acc, qw, lane);
  __syncthreads();
  const long long ts = (long long)H * D;
  smem_to_rows<Ops, D, kBlockQ, kThreads>(
      static_cast<E*>(a.out) + (long long)b * Tq * ts + (long long)h * D, qsm, ts, q0, Tq, tid);
}

// ptxas, left to its own register budget, fits the f32 kernels at D = 64
// into 128 registers with an 8-byte spill; asking for 3 blocks an SM gives
// them 168 and no spill (3-8% slower than the spilling build at the path's
// shapes).  Since the masks' per-row key windows (the chunk mode), the f32
// kernel with dropout at D = 32 also spilled (20 bytes at 80 registers) and
// takes the same hint.  Every other instantiation keeps ptxas's own budget: a hint of 1
// or 3 blocks raised their registers and slowed bf16 at the decoder and
// cross shapes by a third (on an H100; PERF.md).
template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(const Args a) {
  fwd_tile<Ops, D, kDropout>(a);
}
template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 3) flash_attention_fwd_kernel_3(const Args a) {
  fwd_tile<Ops, D, kDropout>(a);
}

// ---------------------------------------------------------------- launch

template <typename Ops, int D, bool kDropout>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  // the Q tile; K, V double-buffered
  constexpr size_t smem = (kBlockQ + 4 * kStep) * Tiles<Ops, D>::kStride * sizeof(E);
  auto kernel = [] {
    if constexpr (std::is_same<Ops, Tf32x3Ops>::value && (D == 64 || (D == 32 && kDropout)))
      return flash_attention_fwd_kernel_3<Ops, D, kDropout>;
    else
      return flash_attention_fwd_kernel<Ops, D, kDropout>;
  }();
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename Ops>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return a.drop.on ? launch<Ops, 32, true>(a, stream) : launch<Ops, 32, false>(a, stream);
    case 64:
      return a.drop.on ? launch<Ops, 64, true>(a, stream) : launch<Ops, 64, false>(a, stream);
    case 128:
      return a.drop.on ? launch<Ops, 128, true>(a, stream) : launch<Ops, 128, false>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace openasr

extern "C" {

// out, lse = attention(q, k, v).  q: [B, Tq, H, D], k/v: [B, Tk, H, D], each
// addressed through its (batch, time, head) strides with unit stride along
// D and 16-byte aligned rows (each pointer and stride a multiple of 16
// bytes); kv_lengths: [B] int32 or null (= Tk); out: contiguous
// [B, Tq, H, D]; lse: contiguous [B, H, Tq] f32.  causal, and chunk > 0
// with left_chunks and phase, are the masks of openasr::Mask (a row that
// sees no key gets O = 0 and lse = +inf).  With `dropout` set, the
// weights are dropped where the hash of (dropout_seed, b*H + h, qpos, kpos)
// is not below keep_thresh and the kept ones scaled by drop_scale =
// 1 / (1 - rate).
int openasr_flash_attention_fwd(const void* q, const void* k, const void* v,
                                const void* kv_lengths, void* out, void* lse,
                                int B, int H, int Tq, int Tk, int D,
                                long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                float sm_scale, int causal, int chunk,
                                int left_chunks, int phase,
                                unsigned int dropout_seed,
                                unsigned int keep_thresh, float drop_scale,
                                int dropout, int dtype, int device,
                                void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const openasr::Args a{q, k, v, static_cast<const int*>(kv_lengths), out,
                        static_cast<float*>(lse), B, H, Tq, Tk,
                        {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
                        sm_scale, {causal, chunk, left_chunks, phase},
                        {dropout != 0, dropout_seed, keep_thresh, drop_scale}, device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case openasr::kFloat32:
      return openasr::dispatch_d<openasr::Tf32x3Ops>(D, a, s);
    case openasr::kBFloat16:
      return openasr::dispatch_d<openasr::Bf16Ops>(D, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
