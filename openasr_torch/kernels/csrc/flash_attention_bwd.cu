// Flash attention backward for Hopper (sm_90a): dK/dV and dQ on the
// tensor cores.
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
// atomics and the gradients are the same bit for bit from run to run; dQ
// pays for it by recomputing S and dP (two of its three products).
//
// Bound on the H100 at the training path's shapes (T 32-139, D 64): bytes,
// in bf16 and in f32 alike.  Reading q, k, v, O, dO once and writing dq,
// dk, dv once takes longer at 3.35 TB/s than the five Tq x Tk x D products
// at 989 TFLOP/s in bf16, or in f32 as 3xTF32 at a third of TF32's 495
// TFLOP/s.
//
// Design, FA2's backward on mma.sync (not wgmma: at these shapes the loads,
// not the tensor cores' rate, set the time).  Tiles are the same at every
// D: a block owns 64 rows and walks the other side 32 rows a step.
// - dK/dV: one block of 8 warps per (64-key tile, head, batch).  Warps 0-3
//   accumulate dV and warps 4-7 dK, each for 16 keys k0 + 16(w % 4)..+15,
//   so a lane holds one [16, D] accumulator, not two.  The K and V tiles
//   are staged once in shared memory; the block walks query steps whose Q,
//   dO, lse and delta are double-buffered with cp.async commit/wait groups,
//   so step i + 1 loads while step i computes.  Per step a warp computes
//   S^T = K Q^T (the dK warps also dP^T = V dO^T), rows keys and columns
//   queries, so the masks and the hash take (query, key) swapped back;
//   turns them into (P o D)^T or dS^T in registers; and uses those
//   accumulator fragments as they stand as the A operand of
//   dV += (P o D)^T dO or dK += dS^T Q, with dO and Q read as B operands
//   through a transposing load.  Under causal the walk starts at the step
//   holding the block's first key; a block whose keys are all padding
//   walks nothing and writes zeros.
// - dQ: the mirror, one block of 4 warps per (64-query tile, head, batch),
//   warp w owning queries q0 + 16w..+15 and their lse and delta in
//   registers; key steps double-buffered up to kv_length and, under
//   causal, the diagonal; S = Q K^T, dP = dO V^T, dS as the A operand of
//   dQ += dS K.
// - The fragments of the block's own tile (K and V, or Q and dO) are
//   re-read from shared memory at each step rather than held in registers:
//   held, they made dK/dV at D = 64 with dropout and every D = 128 kernel
//   spill (255 registers).
// - Staged rows are padded by 8 elements, which puts the 8 row addresses of
//   one bf16 ldmatrix, and the lanes of one f32 float2 load, in distinct
//   banks.  cp.async needs 16-byte aligned rows: the wrapper checks it.
//   Shared memory is (2 * 64 + 4 * 32) rows of D + 8 elements (dK/dV adds
//   1 KB of lse and delta), above 48 KB (opt-in) at D = 128 in bf16 and at
//   D >= 64 in f32.
// - bf16 (Bf16Ops): mma.m16n8k16 from ldmatrix / ldmatrix.trans.  P o D
//   and dS are rounded to bf16 before the second products, where JAX casts
//   them (`p_drop.astype(do.dtype)`, `ds.astype(q.dtype)`, :305, :316,
//   :387); sums stay f32.
// - f32 (Tf32x3Ops): mma.m16n8k8 in TF32 with the 3xTF32 split (x = hi +
//   lo, acc += lo.hi + hi.lo + hi.hi), which keeps f32's precision.
//   ldmatrix serves 16-bit elements only, so fragments come from ld.shared.
//   Within each k-step the k index is permuted (mma slot t <-> column 2t,
//   slot t + 4 <-> column 2t + 1) in A and B alike, which leaves the
//   products unchanged and makes an accumulator fragment an A fragment as
//   it stands.
// Registers a thread from ptxas for sm_90a (without / with dropout), no
// instantiation spilling (chip_smoke.py prints them as its [ptxas] line
// and fails on a spill):
//            bf16 dK/dV  bf16 dQ    f32 dK/dV  f32 dQ
//   D = 32   114 / 114    78 / 106  127 / 127  114 / 115
//   D = 64   123 / 124   122 / 141  125 / 125  182 / 142
//   D = 128  161 / 163   183 / 186  166 / 169  182 / 168

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace openasr {
namespace {

struct Strides {
  long long b, t, h;
};

constexpr int kRows = 64;          // keys (dK/dV) or queries (dQ) per block
constexpr int kDkvThreads = 256;   // 8 warps: 4 on dV, 4 on dK, 16 keys each
constexpr int kDqThreads = 128;    // 4 warps, 16 queries each
constexpr int kWalk = 32;          // rows per step of a walk
constexpr float kLog2e = 1.4426950408889634f;

// ----------------------------------------------------------- operands

// bf16: fragments through ldmatrix, m16n8k16.
struct Bf16Ops {
  using Elem = __nv_bfloat16;
  static constexpr int kK = 16;  // k of one mma
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  // A: 16 rows x kK columns at (r0, c0) of a tile of row stride S
  template <int S>
  static __device__ __forceinline__ void load_a(A& a, const Elem* s, int r0, int c0, int lane) {
    ldmatrix_x4(a.r, smem_u32(s + (r0 + (lane & 15)) * S + c0 + (lane >> 4) * 8));
  }
  // B of the n-tiles n0 and n0 + 8 for the k-step at k0, from a tile
  // stored [n][k]
  template <int S>
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const Elem* s, int n0, int k0,
                                                   int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, smem_u32(s + (n0 + (lane & 7) + (lane >> 4) * 8) * S + k0 +
                            ((lane >> 3) & 1) * 8));
    b0.r[0] = r[0], b0.r[1] = r[1], b1.r[0] = r[2], b1.r[1] = r[3];
  }
  // the same from a tile stored [k][n]
  template <int S>
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const Elem* s, int k0, int n0,
                                                   int lane) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, smem_u32(s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 +
                                  (lane >> 4) * 8));
    b0.r[0] = r[0], b0.r[1] = r[1], b1.r[0] = r[2], b1.r[1] = r[3];
  }
  // A of a second product from the accumulators of the kK / 8 = 2 n-tiles
  // c[0], c[1], rounded to bf16
  static __device__ __forceinline__ void from_c(A& a, const float (*c)[4]) {
    a.r[0] = pack_bf16(c[0][0], c[0][1]);
    a.r[1] = pack_bf16(c[0][2], c[0][3]);
    a.r[2] = pack_bf16(c[1][0], c[1][1]);
    a.r[3] = pack_bf16(c[1][2], c[1][3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.r, b.r[0], b.r[1]);
  }
  // two adjacent outputs
  static __device__ __forceinline__ void store2(Elem* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
  }
};

// f32: 3xTF32 m16n8k8, fragments through ld.shared, k permuted within a
// step (slot t <-> column 2t, slot t + 4 <-> column 2t + 1, t = lane % 4).
struct Tf32x3Ops {
  using Elem = float;
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };

  template <int S>
  static __device__ __forceinline__ void load_a(A& a, const Elem* s, int r0, int c0, int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const float2 x = *reinterpret_cast<const float2*>(s + (r0 + g) * S + c0 + t2);
    const float2 y = *reinterpret_cast<const float2*>(s + (r0 + g + 8) * S + c0 + t2);
    split_tf32(x.x, a.hi[0], a.lo[0]);
    split_tf32(y.x, a.hi[1], a.lo[1]);
    split_tf32(x.y, a.hi[2], a.lo[2]);
    split_tf32(y.y, a.hi[3], a.lo[3]);
  }
  template <int S>
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const Elem* s, int n0, int k0,
                                                   int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const float2 x = *reinterpret_cast<const float2*>(s + (n0 + g) * S + k0 + t2);
    const float2 y = *reinterpret_cast<const float2*>(s + (n0 + 8 + g) * S + k0 + t2);
    split_tf32(x.x, b0.hi[0], b0.lo[0]);
    split_tf32(x.y, b0.hi[1], b0.lo[1]);
    split_tf32(y.x, b1.hi[0], b1.lo[0]);
    split_tf32(y.y, b1.hi[1], b1.lo[1]);
  }
  template <int S>
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const Elem* s, int k0, int n0,
                                                   int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const Elem* r = s + (k0 + t2) * S + n0 + g;
    split_tf32(r[0], b0.hi[0], b0.lo[0]);
    split_tf32(r[S], b0.hi[1], b0.lo[1]);
    split_tf32(r[8], b1.hi[0], b1.lo[0]);
    split_tf32(r[S + 8], b1.hi[1], b1.lo[1]);
  }
  // one n-tile's accumulators: c0 (g, 2t) -> slot t, c1 (g, 2t + 1) ->
  // slot t + 4, c2 and c3 the same at row g + 8
  static __device__ __forceinline__ void from_c(A& a, const float (*c)[4]) {
    split_tf32(c[0][0], a.hi[0], a.lo[0]);
    split_tf32(c[0][2], a.hi[1], a.lo[1]);
    split_tf32(c[0][1], a.hi[2], a.lo[2]);
    split_tf32(c[0][3], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
  }
  static __device__ __forceinline__ void store2(Elem* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// Staged rows: D elements padded by 8, copied 16 bytes at a time.
template <typename Ops, int D>
struct Tiles {
  static constexpr int kStride = D + 8;
  static constexpr int kChunk = 16 / sizeof(typename Ops::Elem);  // elements a cp.async
};

// ------------------------------------------------------- staging, stores

// Rows [r0, r0 + N) of one (batch, head)'s [T, D] slice (row stride
// t_stride elements) -> smem [N][D + 8] with 16-byte cp.async by the
// block's NT threads; rows at or past T are zero-filled.
template <typename Ops, int D, int N, int NT, typename E>
__device__ __forceinline__ void stage_rows(E* smem, const E* base, long long t_stride, int r0,
                                           int T, int tid) {
  using Tl = Tiles<Ops, D>;
  constexpr int kPerRow = D / Tl::kChunk;
  for (int idx = tid; idx < N * kPerRow; idx += NT) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * Tl::kChunk;
    const bool ok = r0 + r < T;
    cp_async16(smem_u32(smem + r * Tl::kStride + c),
               base + (ok ? (long long)(r0 + r) * t_stride : 0) + c, ok);
  }
}

// A warp's accumulators [D / 8][4] (rows r0 + g and r0 + g + 8) -> staged
// rows in the output type.
template <typename Ops, int D, typename E>
__device__ __forceinline__ void frags_to_smem(E* s, const float (&acc)[D / 8][4], int r0,
                                              int lane) {
  constexpr int S = Tiles<Ops, D>::kStride;
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    Ops::store2(s + (r0 + g) * S + n * 8 + c, acc[n][0], acc[n][1]);
    Ops::store2(s + (r0 + g + 8) * S + n * 8 + c, acc[n][2], acc[n][3]);
  }
}

// Staged rows [0, N) -> rows r0 + r < T of a contiguous [B, T, H, D] output
// (out points at (b, 0, h)), 16 bytes a thread.
template <typename Ops, int D, int N, int NT, typename E>
__device__ __forceinline__ void smem_to_rows(E* out, const E* s, long long t_stride, int r0,
                                             int T, int tid) {
  using Tl = Tiles<Ops, D>;
  constexpr int kPerRow = D / Tl::kChunk;
  for (int idx = tid; idx < N * kPerRow; idx += NT) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * Tl::kChunk;
    if (r0 + r < T)
      *reinterpret_cast<uint4*>(out + (long long)(r0 + r) * t_stride + c) =
          *reinterpret_cast<const uint4*>(s + r * Tl::kStride + c);
  }
}

// --------------------------------------------------------------- dK, dV

// Warps 0-3 accumulate dV and warps 4-7 dK for the same 16 keys each, so a
// lane holds one [16, D] accumulator (64 registers at D = 128), not two;
// both recompute S^T, the dK warps also dP^T.
template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDkvThreads)
flash_attention_bwd_dkv_kernel(
    const typename Ops::Elem* __restrict__ q, const typename Ops::Elem* __restrict__ k,
    const typename Ops::Elem* __restrict__ v, const typename Ops::Elem* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_lengths, typename Ops::Elem* __restrict__ dk,
    typename Ops::Elem* __restrict__ dv, int H, int Tq, int Tk, Strides qs_, Strides ks_,
    Strides vs_, Strides ds_, float sm_scale, int causal, Dropout drop) {
  using E = typename Ops::Elem;
  constexpr int kBK = kRows, kBQ = kWalk, S = Tiles<Ops, D>::kStride, kK = Ops::kK;
  constexpr int NT = kDkvThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ksm = reinterpret_cast<E*>(smem_raw);   // [kBK][S]
  E* vsm = ksm + kBK * S;                     // [kBK][S]
  E* qsm = vsm + kBK * S;                     // [2][kBQ][S]
  E* dosm = qsm + 2 * kBQ * S;                // [2][kBQ][S]
  float* lse_s = reinterpret_cast<float*>(dosm + 2 * kBQ * S);  // [2][kBQ]
  float* delta_s = lse_s + 2 * kBQ;                               // [2][kBQ]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int kw = 16 * (warp & 3);  // the warp's first row in the key tile
  const bool on_dk = warp >= 4;    // warp-uniform role: dK, else dV
  const uint32_t bh = (uint32_t)(b * H + h);
  const float scale_log2 = sm_scale * kLog2e;

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);

  float acc[D / 8][4];  // dK or dV of the warp's 16 keys
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // queries before the block's first key see none of its keys under causal;
  // a block whose keys are all padding walks nothing and writes zeros
  int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  if (k0 >= n_valid) q_begin = Tq;
  const E* qb = q + b * qs_.b + h * qs_.h;
  const E* db = dout + b * ds_.b + h * ds_.h;
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* delta_b = delta + ((long long)b * H + h) * Tq;

  auto stage_queries = [&](int q0, int buf) {
    stage_rows<Ops, D, kBQ, NT>(qsm + buf * kBQ * S, qb, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm + buf * kBQ * S, db, ds_.t, q0, Tq, tid);
    if (tid < 2 * kBQ) {
      const int i = tid % kBQ;
      const bool ok = q0 + i < Tq;
      cp_async4(smem_u32((tid < kBQ ? lse_s : delta_s) + buf * kBQ + i),
                (tid < kBQ ? lse_b : delta_b) + (ok ? q0 + i : 0), ok);
    }
  };

  if (q_begin < Tq) {
    stage_rows<Ops, D, kBK, NT>(ksm, k + b * ks_.b + h * ks_.h, ks_.t, k0, Tk, tid);
    stage_rows<Ops, D, kBK, NT>(vsm, v + b * vs_.b + h * vs_.h, vs_.t, k0, Tk, tid);
    stage_queries(q_begin, 0);
    cp_async_commit();

    int buf = 0;
    for (int q0 = q_begin; q0 < Tq; q0 += kBQ, buf ^= 1) {
      if (q0 + kBQ < Tq) {
        stage_queries(q0 + kBQ, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const E* qt = qsm + buf * kBQ * S;
      const E* dot = dosm + buf * kBQ * S;
      const float* ls = lse_s + buf * kBQ;
      const float* dl = delta_s + buf * kBQ;

      // S^T = K Q^T (and on the dK warps dP^T = V dO^T), [16 keys, kBQ
      // queries] a warp
      float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / kK; ++kk) {
        typename Ops::A ka;
        Ops::template load_a<S>(ka, ksm, kw, kk * kK, lane);
#pragma unroll
        for (int n2 = 0; n2 < kBQ / 16; ++n2) {
          typename Ops::B q0f, q1f;
          Ops::template load_b_nk<S>(q0f, q1f, qt, n2 * 16, kk * kK, lane);
          Ops::mma(st[2 * n2], ka, q0f);
          Ops::mma(st[2 * n2 + 1], ka, q1f);
        }
        if (on_dk) {
          typename Ops::A va;
          Ops::template load_a<S>(va, vsm, kw, kk * kK, lane);
#pragma unroll
          for (int n2 = 0; n2 < kBQ / 16; ++n2) {
            typename Ops::B o0f, o1f;
            Ops::template load_b_nk<S>(o0f, o1f, dot, n2 * 16, kk * kK, lane);
            Ops::mma(dpt[2 * n2], va, o0f);
            Ops::mma(dpt[2 * n2 + 1], va, o1f);
          }
        }
      }

      // st <- (P o D)^T on the dV warps, dS^T on the dK warps: row = key,
      // column = query, so the masks and the hash take (query, key) in that
      // order
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + g + (e >> 1) * 8;
          const int qi = j * 8 + t2 + (e & 1);
          const int qp = q0 + qi;
          const bool ok = key < n_valid && qp < Tq && (!causal || key <= qp);
          // lse = +inf (an empty row) gives p = 0; masked pairs never
          // reach the exp
          const float p = ok ? exp2f(fmaf(st[j][e], scale_log2, -ls[qi] * kLog2e)) : 0.f;
          const bool keep =
              !kDropout || dropout_keep(drop.seed, bh, (uint32_t)qp, (uint32_t)key, drop.thresh);
          const float scale = kDropout ? drop.scale : 1.f;
          st[j][e] = on_dk ? (ok ? p * ((keep ? dpt[j][e] * scale : 0.f) - dl[qi]) * sm_scale
                                 : 0.f)
                           : (keep ? p * scale : 0.f);
        }
      }

      // dV += (P o D)^T dO or dK += dS^T Q: the fragments above are the A
      // operand (in bf16 rounded as JAX's casts round them)
      const E* rhs = on_dk ? qt : dot;
#pragma unroll
      for (int kq = 0; kq < kBQ / kK; ++kq) {
        typename Ops::A a;
        Ops::from_c(a, &st[kq * (kK / 8)]);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          typename Ops::B b0f, b1f;
          Ops::template load_b_kn<S>(b0f, b1f, rhs, kq * kK, n2 * 16, lane);
          Ops::mma(acc[2 * n2], a, b0f);
          Ops::mma(acc[2 * n2 + 1], a, b1f);
        }
      }
      __syncthreads();  // buffer `buf` is refilled two tiles on
    }
  }

  // epilogue: the output rows through the K (dK) and V (dV) tiles' shared
  // memory, then 16-byte stores
  frags_to_smem<Ops, D>(on_dk ? ksm : vsm, acc, kw, lane);
  __syncthreads();
  const long long ts = (long long)H * D;
  smem_to_rows<Ops, D, kBK, NT>(dk + (long long)b * Tk * ts + (long long)h * D, ksm, ts, k0,
                                Tk, tid);
  smem_to_rows<Ops, D, kBK, NT>(dv + (long long)b * Tk * ts + (long long)h * D, vsm, ts, k0,
                                Tk, tid);
}

// ------------------------------------------------------------------- dQ

template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads)
flash_attention_bwd_dq_kernel(
    const typename Ops::Elem* __restrict__ q, const typename Ops::Elem* __restrict__ k,
    const typename Ops::Elem* __restrict__ v, const typename Ops::Elem* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_lengths, typename Ops::Elem* __restrict__ dq, int H, int Tq,
    int Tk, Strides qs_, Strides ks_, Strides vs_, Strides ds_, float sm_scale, int causal,
    Dropout drop) {
  using E = typename Ops::Elem;
  constexpr int kBQ = kRows, kBK = kWalk, S = Tiles<Ops, D>::kStride, kK = Ops::kK;
  constexpr int NT = kDqThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* qsm = reinterpret_cast<E*>(smem_raw);   // [kBQ][S]
  E* dosm = qsm + kBQ * S;                    // [kBQ][S]
  E* ksm = dosm + kBQ * S;                    // [2][kBK][S]
  E* vsm = ksm + 2 * kBK * S;                 // [2][kBK][S]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int qw = 16 * warp;  // the warp's first row in the query tile
  const uint32_t bh = (uint32_t)(b * H + h);
  const float scale_log2 = sm_scale * kLog2e;

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  const int k_end = causal ? min(n_valid, q0 + kBQ) : n_valid;

  // the lane's two rows (g, g + 8): position, lse in log2 units, delta
  int qrow[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + qw + g + 8 * r;
    const long long i = ((long long)b * H + h) * Tq + min(qrow[r], Tq - 1);
    lse2[r] = qrow[r] < Tq ? lse[i] * kLog2e : __int_as_float(0x7f800000);
    dlt[r] = qrow[r] < Tq ? delta[i] : 0.f;
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  if (k_end > 0) {
    const E* kb = k + b * ks_.b + h * ks_.h;
    const E* vb = v + b * vs_.b + h * vs_.h;
    stage_rows<Ops, D, kBQ, NT>(qsm, q + b * qs_.b + h * qs_.h, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm, dout + b * ds_.b + h * ds_.h, ds_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBK, NT>(ksm, kb, ks_.t, 0, Tk, tid);
    stage_rows<Ops, D, kBK, NT>(vsm, vb, vs_.t, 0, Tk, tid);
    cp_async_commit();

    int buf = 0;
    for (int k0 = 0; k0 < k_end; k0 += kBK, buf ^= 1) {
      if (k0 + kBK < k_end) {
        stage_rows<Ops, D, kBK, NT>(ksm + (buf ^ 1) * kBK * S, kb, ks_.t, k0 + kBK, Tk, tid);
        stage_rows<Ops, D, kBK, NT>(vsm + (buf ^ 1) * kBK * S, vb, vs_.t, k0 + kBK, Tk, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const E* kt = ksm + buf * kBK * S;
      const E* vt = vsm + buf * kBK * S;

      // S = Q K^T and dP = dO V^T, [16 queries, kBK keys] a warp
      float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / kK; ++kk) {
        typename Ops::A qa, oa;
        Ops::template load_a<S>(qa, qsm, qw, kk * kK, lane);
        Ops::template load_a<S>(oa, dosm, qw, kk * kK, lane);
#pragma unroll
        for (int n2 = 0; n2 < kBK / 16; ++n2) {
          typename Ops::B k0f, k1f, v0f, v1f;
          Ops::template load_b_nk<S>(k0f, k1f, kt, n2 * 16, kk * kK, lane);
          Ops::template load_b_nk<S>(v0f, v1f, vt, n2 * 16, kk * kK, lane);
          Ops::mma(s[2 * n2], qa, k0f);
          Ops::mma(s[2 * n2 + 1], qa, k1f);
          Ops::mma(dp[2 * n2], oa, v0f);
          Ops::mma(dp[2 * n2 + 1], oa, v1f);
        }
      }

      // s <- dS: row = query, column = key
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + j * 8 + t2 + (e & 1);
          const int qp = qrow[r];
          const bool ok = key < n_valid && qp < Tq && (!causal || key <= qp);
          const float p = ok ? exp2f(fmaf(s[j][e], scale_log2, -lse2[r])) : 0.f;
          float dpd = dp[j][e];
          if (kDropout) {
            const bool keep =
                dropout_keep(drop.seed, bh, (uint32_t)qp, (uint32_t)key, drop.thresh);
            dpd = keep ? dpd * drop.scale : 0.f;
          }
          s[j][e] = ok ? p * (dpd - dlt[r]) * sm_scale : 0.f;
        }
      }

      // dQ += dS K, dS as the A operand (in bf16 rounded as JAX rounds it)
#pragma unroll
      for (int kq = 0; kq < kBK / kK; ++kq) {
        typename Ops::A sa;
        Ops::from_c(sa, &s[kq * (kK / 8)]);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          typename Ops::B k0f, k1f;
          Ops::template load_b_kn<S>(k0f, k1f, kt, kq * kK, n2 * 16, lane);
          Ops::mma(dqa[2 * n2], sa, k0f);
          Ops::mma(dqa[2 * n2 + 1], sa, k1f);
        }
      }
      __syncthreads();  // buffer `buf` is refilled two tiles on
    }
  }

  // epilogue through the warp's own rows of the Q tile
  frags_to_smem<Ops, D>(qsm, dqa, qw, lane);
  __syncthreads();
  const long long ts = (long long)H * D;
  smem_to_rows<Ops, D, kBQ, NT>(dq + (long long)b * Tq * ts + (long long)h * D, qsm, ts, q0,
                                Tq, tid);
}

// ---------------------------------------------------------------- launch

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
  int device;
};

constexpr int kMaxDevices = 64;

// Dynamic shared memory above the 48 KB default needs the kernel's opt-in.
// It is asked once per kernel and device: `asked`, one array per
// instantiation, keeps 1 + the answer, which every later launch returns.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device, int* asked) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!asked[device])
    asked[device] = 1 + cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  return static_cast<cudaError_t>(asked[device] - 1);
}

template <typename Ops, int D, bool kDropout>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  // K, V tiles; Q, dO, lse, delta double-buffered
  constexpr size_t smem =
      (2 * kRows + 4 * kWalk) * Tiles<Ops, D>::kStride * sizeof(E) + 4 * kWalk * sizeof(float);
  auto kernel = flash_attention_bwd_dkv_kernel<Ops, D, kDropout>;
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const E*>(a.dout), a.lse, a.delta, a.kv_lengths, static_cast<E*>(a.dk),
      static_cast<E*>(a.dv), a.H, a.Tq, a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.causal,
      a.drop);
  return cudaGetLastError();
}

template <typename Ops, int D, bool kDropout>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  // Q, dO tiles; K, V double-buffered
  constexpr size_t smem = (2 * kRows + 4 * kWalk) * Tiles<Ops, D>::kStride * sizeof(E);
  auto kernel = flash_attention_bwd_dq_kernel<Ops, D, kDropout>;
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDqThreads, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const E*>(a.dout), a.lse, a.delta, a.kv_lengths, static_cast<E*>(a.dq), a.H,
      a.Tq, a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ
template <typename Ops, int D>
cudaError_t launch_one(int which, const Args& a, cudaStream_t stream) {
  if (which == 0)
    return a.drop.on ? launch_dkv<Ops, D, true>(a, stream) : launch_dkv<Ops, D, false>(a, stream);
  return a.drop.on ? launch_dq<Ops, D, true>(a, stream) : launch_dq<Ops, D, false>(a, stream);
}

template <typename Ops>
cudaError_t dispatch_d(int which, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_one<Ops, 32>(which, a, stream);
    case 64:
      return launch_one<Ops, 64>(which, a, stream);
    case 128:
      return launch_one<Ops, 128>(which, a, stream);
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
         sm_scale, causal, {dropout != 0, dropout_seed, keep_thresh, drop_scale}, device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<Tf32x3Ops>(which, D, a, s);
    case kBFloat16:
      return dispatch_d<Bf16Ops>(which, D, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace openasr

extern "C" {

// dk, dv of attention.  q, dout: [B, Tq, H, D]; k, v: [B, Tk, H, D], each
// addressed through its (batch, time, head) strides, given in `strides` as
// q, k, v, dout triples (12 values), with unit stride along D, 16-byte
// aligned rows (each pointer and stride a multiple of 16 bytes); lse,
// delta: contiguous [B, H, Tq] f32; kv_lengths: [B] int32 or null; dk, dv:
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
