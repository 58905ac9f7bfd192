// Flash attention backward for Hopper (sm_90a): dK/dV and dQ on the
// tensor cores.
//
// Replaces the Pallas TPU kernels
// openasr_tpu/kernels/flash_attention.py:_bwd_dkv_kernel (:238) and
// `_bwd_dq_kernel` (:327), and its delta (:468).  All three kernels here
// recompute the weights from the forward's logsumexp rows, exp(S * scale -
// lse), with the forward's masks (key padding from kv_lengths, causal kpos
// <= qpos) and, with dropout, the same positional hash mask D = keep / (1 -
// rate) (common.cuh).  A statistics pass (the dQ kernel's code with
// kStats) sums each query row's weights and, with P the weights divided by
// that sum, delta = rowsum(P o dP o D); then
//   dV = (P o D)^T dO,   dP = (dO V^T) o D,
//   dS = P o (dP - delta) * scale,   dK = dS^T Q,   dQ = dS K.
// Unlike the TPU kernels, which take delta = rowsum(dO o O) from the
// caller, P and delta here come from the same products in every kernel,
// bit for bit (S and dP through Ops::mma_sym, whose result does not depend
// on which operand is A), so a one-hot softmax row (scores of 1e4 and more)
// gives dS exactly 0; with delta = rowsum(dO o O) the rounding residue of
// dP - delta, times the keys and the layer's input, was the whole q/k
// gradient there.  Rows the forward left empty carry lse = +inf, so their
// P is 0.
// As on the TPU, dK/dV and dQ are two kernels: the first walks queries for
// a tile of keys, the second keys for a tile of queries, so neither needs
// atomics and the gradients are the same bit for bit from run to run; dQ
// pays for it by recomputing S and dP (two of its three products), and the
// statistics pass walks the keys twice (S, then S and dP).
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
//   dO, lse, the row sums and delta are double-buffered with cp.async commit/wait groups,
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
//   warp w owning queries q0 + 16w..+15 and their lse, row sum and delta
//   in registers (the statistics pass the same, summing over the lane
//   quad); key steps double-buffered up to kv_length and, under
//   causal, the diagonal; S = Q K^T, dP = dO V^T, dS as the A operand of
//   dQ += dS K.
// - The fragments of the block's own tile (K and V, or Q and dO) are
//   re-read from shared memory at each step rather than held in registers:
//   held, they made dK/dV at D = 64 with dropout and every D = 128 kernel
//   spill (255 registers).
// - Operands, staging and stores come from flash_tiles.cuh, shared with
//   the forward: staged rows padded by 8 elements, 16-byte cp.async (the
//   wrapper checks that rows are 16-byte aligned).  Shared memory is (2 *
//   64 + 4 * 32) rows of D + 8 elements (dK/dV adds 1 KB of lse and
//   delta), above 48 KB (opt-in) at D = 128 in bf16 and at D >= 64 in f32.
// - bf16 (Bf16Ops): mma.m16n8k16 from ldmatrix / ldmatrix.trans.  P o D
//   and dS are rounded to bf16 before the second products, where JAX casts
//   them (`p_drop.astype(do.dtype)`, `ds.astype(q.dtype)`, :305, :316,
//   :387); sums stay f32.
// - f32 (Tf32x3Ops): mma.m16n8k8 as 3xTF32, which keeps f32's precision,
//   with the k permutation that makes an accumulator fragment an A
//   fragment as it stands.
// Registers a thread from ptxas for sm_90a (without / with dropout), no
// instantiation spilling (chip_smoke.py prints them as its [ptxas] line
// and fails on a spill; the f32 dQ at D = 64 through its 3-blocks entry):
//            bf16 stats  bf16 dK/dV  bf16 dQ    f32 stats  f32 dK/dV  f32 dQ
//   D = 32   112 / 112   112 / 117    80 / 96   254 / 254  126 / 128  122 / 123
//   D = 64   132 / 132   118 / 123   125 / 124  135 / 135  128 / 126  160 / 160
//   D = 128  135 / 135   161 / 162   166 / 166  135 / 135  169 / 171  161 / 162

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"

namespace openasr {
namespace {

constexpr int kRows = 64;          // keys (dK/dV) or queries (dQ) per block
constexpr int kDkvThreads = 256;   // 8 warps: 4 on dV, 4 on dK, 16 keys each
constexpr int kDqThreads = 128;    // 4 warps, 16 queries each
constexpr int kWalk = 32;          // rows per step of a walk

// The weights, in every kernel and the same bits: P = exp(S scale - lse)
// from the forward's lse (+inf on an empty row gives 0), divided by the
// row's sum of such P (the stats pass's), so a row of P sums to 1 to
// rounding and a one-hot row is exactly one-hot.  The products are
// rounded where written (no contraction that could differ between the
// kernels).
__device__ __forceinline__ float unnormed_weight(float s, float scale_log2, float lse) {
  return exp2f(fmaf(s, scale_log2, -__fmul_rn(lse, kLog2e)));
}
// P / row_sum as p * (1 / row_sum), and 1 where p is the whole row's sum
// (a one-hot row), where the reciprocal's rounding could leave 1 - ulp.
__device__ __forceinline__ float weight(float s, float scale_log2, float lse, float row_sum,
                                        float inv_sum) {
  const float p = unnormed_weight(s, scale_log2, lse);
  return p == row_sum && p > 0.f ? 1.f : __fmul_rn(p, inv_sum);
}
// An entry of dS = P o (dP o D - delta) * scale, with delta = rowsum(P o
// dP o D) from the same P and dP (the stats pass's): where P is one-hot,
// dP o D - delta is exactly 0.
__device__ __forceinline__ float grad_entry(float p, float dpd, float delta, float sm_scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dpd, delta)), sm_scale);
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
    const float* __restrict__ lse, const float* __restrict__ stats,
    const int* __restrict__ kv_lengths, typename Ops::Elem* __restrict__ dk,
    typename Ops::Elem* __restrict__ dv, int H, int Tq, int Tk, Strides qs_, Strides ks_,
    Strides vs_, Strides ds_, float sm_scale, int causal, Dropout drop) {
  using E = typename Ops::Elem;
  constexpr int kBK = kRows, kBQ = kWalk, S = Tiles<Ops, D>::kStride, kK = Ops::kK;
  constexpr int NT = kDkvThreads;
  static_assert(4 * kBQ <= NT, "one thread a row statistic");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ksm = reinterpret_cast<E*>(smem_raw);   // [kBK][S]
  E* vsm = ksm + kBK * S;                     // [kBK][S]
  E* qsm = vsm + kBK * S;                     // [2][kBQ][S]
  E* dosm = qsm + 2 * kBQ * S;                // [2][kBQ][S]
  float* lse_s = reinterpret_cast<float*>(dosm + 2 * kBQ * S);  // [2][kBQ]
  float* sum_s = lse_s + 2 * kBQ;                                 // [2][kBQ]
  float* inv_s = sum_s + 2 * kBQ;                                 // [2][kBQ]
  float* delta_s = inv_s + 2 * kBQ;                               // [2][kBQ]

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
  // the row statistic this thread stages, if any (threads 0-127): lse, or
  // the row sum, its reciprocal or delta ([3][B][H][Tq] stats), into lse_s,
  // sum_s, inv_s or delta_s
  const int stat = tid / kBQ, stat_i = tid % kBQ;
  const float* stat_src =
      (stat == 0 ? lse : stats + (stat - 1) * (long long)gridDim.z * H * Tq) +
      ((long long)b * H + h) * Tq;
  float* stat_dst = lse_s + stat * 2 * kBQ + stat_i;

  auto stage_queries = [&](int q0, int buf) {
    stage_rows<Ops, D, kBQ, NT>(qsm + buf * kBQ * S, qb, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm + buf * kBQ * S, db, ds_.t, q0, Tq, tid);
    if (stat < 4) {
      const bool ok = q0 + stat_i < Tq;
      cp_async4(smem_u32(stat_dst + buf * kBQ), stat_src + (ok ? q0 + stat_i : 0), ok);
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
      const float* sm = sum_s + buf * kBQ;
      const float* iv = inv_s + buf * kBQ;
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
          Ops::mma_sym(st[2 * n2], ka, q0f);
          Ops::mma_sym(st[2 * n2 + 1], ka, q1f);
        }
        if (on_dk) {
          typename Ops::A va;
          Ops::template load_a<S>(va, vsm, kw, kk * kK, lane);
#pragma unroll
          for (int n2 = 0; n2 < kBQ / 16; ++n2) {
            typename Ops::B o0f, o1f;
            Ops::template load_b_nk<S>(o0f, o1f, dot, n2 * 16, kk * kK, lane);
            Ops::mma_sym(dpt[2 * n2], va, o0f);
            Ops::mma_sym(dpt[2 * n2 + 1], va, o1f);
          }
        }
      }

      // st <- (P o D)^T on the dV warps, dS^T on the dK warps: row = key,
      // column = query, so the masks and the hash take (query, key) in that
      // order.  P, the row sums and delta are the dQ kernel's, bit for bit
      // (`weight`, `grad_entry`), so dS^T is exactly 0 where a row is
      // one-hot.
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + g + (e >> 1) * 8;
          const int qi = j * 8 + t2 + (e & 1);
          const int qp = q0 + qi;
          const bool ok = key < n_valid && qp < Tq && (!causal || key <= qp);
          const float p = ok ? weight(st[j][e], scale_log2, ls[qi], sm[qi], iv[qi]) : 0.f;
          const bool keep =
              !kDropout || dropout_keep(drop.seed, bh, (uint32_t)qp, (uint32_t)key, drop.thresh);
          const float dpd = keep ? (kDropout ? __fmul_rn(dpt[j][e], drop.scale) : dpt[j][e]) : 0.f;
          st[j][e] = on_dk ? (ok ? grad_entry(p, dpd, dl[qi], sm_scale) : 0.f)
                           : (keep ? (kDropout ? p * drop.scale : p) : 0.f);
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

// The dQ kernel's body.  kStats: the statistics pass
// (flash_attention_bwd_stats_kernel), which writes each query row's sum of
// P, its reciprocal and delta = rowsum(P o dP o D) (P divided by that sum)
// to `stats_out` ([3][B][H][Tq]), walking the keys twice; else dQ,
// which reads them from `stats` and walks the keys once.  Both compute S
// and dP with the same code, and the dK/dV kernel (with the operands'
// roles swapped, which Ops::mma_sym gives the same bits) too.
template <typename Ops, int D, bool kDropout, bool kStats>
__device__ __forceinline__ void dq_body(
    const typename Ops::Elem* __restrict__ q, const typename Ops::Elem* __restrict__ k,
    const typename Ops::Elem* __restrict__ v, const typename Ops::Elem* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ stats,
    float* __restrict__ stats_out, const int* __restrict__ kv_lengths,
    typename Ops::Elem* __restrict__ dq, int H, int Tq, int Tk, Strides qs_, Strides ks_,
    Strides vs_, Strides ds_, float sm_scale, int causal, Dropout drop) {
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
  const long long rows = (long long)gridDim.z * H * Tq;  // B H Tq

  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  const int k_end = causal ? min(n_valid, q0 + kBQ) : n_valid;

  // the lane's two rows (g, g + 8): position, lse, the row's sum of P and
  // its delta (accumulated here in the stats pass)
  int qrow[2];
  long long at[2];
  float lse_r[2], psum[2], pinv[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + qw + g + 8 * r;
    at[r] = ((long long)b * H + h) * Tq + min(qrow[r], Tq - 1);
    lse_r[r] = qrow[r] < Tq ? lse[at[r]] : __int_as_float(0x7f800000);
    psum[r] = !kStats && qrow[r] < Tq ? stats[at[r]] : 0.f;
    pinv[r] = !kStats && qrow[r] < Tq ? stats[rows + at[r]] : 0.f;
    dlt[r] = !kStats && qrow[r] < Tq ? stats[2 * rows + at[r]] : 0.f;
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const E* kb = k + b * ks_.b + h * ks_.h;
  const E* vb = v + b * vs_.b + h * vs_.h;
  if (k_end > 0) {
    stage_rows<Ops, D, kBQ, NT>(qsm, q + b * qs_.b + h * qs_.h, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm, dout + b * ds_.b + h * ds_.h, ds_.t, q0, Tq, tid);
  }
  // walks over the key steps: pass 0 sums P, pass 1 sums P o dP o D (the
  // statistics), pass 2 accumulates dQ; a loop of known trip count, unrolled,
  // so each pass is its own code
#pragma unroll
  for (int pass = kStats ? 0 : 2; pass <= (kStats ? 1 : 2); ++pass) {
    if (k_end > 0) {
      stage_rows<Ops, D, kBK, NT>(ksm, kb, ks_.t, 0, Tk, tid);
      stage_rows<Ops, D, kBK, NT>(vsm, vb, vs_.t, 0, Tk, tid);
      cp_async_commit();
    }
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
      // the statistics pass holds S and dP with 3xTF32's operands: unrolled
      // whole, f32 at D 128 needs more than 255 registers
      constexpr int kUnrollK = kStats ? 4 : D / kK;
#pragma unroll(kUnrollK)
      for (int kk = 0; kk < D / kK; ++kk) {
        typename Ops::A qa, oa;
        Ops::template load_a<S>(qa, qsm, qw, kk * kK, lane);
        if (pass > 0) Ops::template load_a<S>(oa, dosm, qw, kk * kK, lane);
#pragma unroll
        for (int n2 = 0; n2 < kBK / 16; ++n2) {
          typename Ops::B k0f, k1f;
          Ops::template load_b_nk<S>(k0f, k1f, kt, n2 * 16, kk * kK, lane);
          Ops::mma_sym(s[2 * n2], qa, k0f);
          Ops::mma_sym(s[2 * n2 + 1], qa, k1f);
          if (pass > 0) {
            typename Ops::B v0f, v1f;
            Ops::template load_b_nk<S>(v0f, v1f, vt, n2 * 16, kk * kK, lane);
            Ops::mma_sym(dp[2 * n2], oa, v0f);
            Ops::mma_sym(dp[2 * n2 + 1], oa, v1f);
          }
        }
      }

      // row = query, column = key; s <- dS in pass 2
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + j * 8 + t2 + (e & 1);
          const int qp = qrow[r];
          const bool ok = key < n_valid && qp < Tq && (!causal || key <= qp);
          if (pass == 0) {
            psum[r] += ok ? unnormed_weight(s[j][e], scale_log2, lse_r[r]) : 0.f;
          } else {
            const float p = ok ? weight(s[j][e], scale_log2, lse_r[r], psum[r], pinv[r]) : 0.f;
            float dpd = dp[j][e];
            if (kDropout) {
              const bool keep =
                  dropout_keep(drop.seed, bh, (uint32_t)qp, (uint32_t)key, drop.thresh);
              dpd = keep ? __fmul_rn(dpd, drop.scale) : 0.f;
            }
            if (pass == 1)
              dlt[r] += __fmul_rn(p, dpd);
            else
              s[j][e] = ok ? grad_entry(p, dpd, dlt[r], sm_scale) : 0.f;
          }
        }
      }

      if (pass == 2) {
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
      }
      __syncthreads();  // buffer `buf` is refilled two steps on
    }
    // a row's total over the four lanes that share it, the same bits in each
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (pass == 0) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        pinv[r] = psum[r] > 0.f ? __frcp_rn(psum[r]) : 0.f;
      } else if (pass == 1) {
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 1);
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 2);
      }
    }
  }

  if (kStats) {
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qrow[r] < Tq) {
          stats_out[at[r]] = psum[r];
          stats_out[rows + at[r]] = pinv[r];
          stats_out[2 * rows + at[r]] = dlt[r];
        }
      }
    }
    return;
  }
  // epilogue through the warp's own rows of the Q tile
  frags_to_smem<Ops, D>(qsm, dqa, qw, lane);
  __syncthreads();
  const long long ts = (long long)H * D;
  smem_to_rows<Ops, D, kBQ, NT>(dq + (long long)b * Tq * ts + (long long)h * D, qsm, ts, q0,
                                Tq, tid);
}

#define OPENASR_DQ_PARAMS                                                                  \
  const typename Ops::Elem *__restrict__ q, const typename Ops::Elem *__restrict__ k,      \
      const typename Ops::Elem *__restrict__ v, const typename Ops::Elem *__restrict__ dout, \
      const float *__restrict__ lse, const float *__restrict__ stats,                      \
      float *__restrict__ stats_out, const int *__restrict__ kv_lengths,                   \
      typename Ops::Elem *__restrict__ dq, int H, int Tq, int Tk, Strides qs_,             \
      Strides ks_, Strides vs_, Strides ds_, float sm_scale, int causal, Dropout drop
#define OPENASR_DQ_ARGS                                                                    \
  q, k, v, dout, lse, stats, stats_out, kv_lengths, dq, H, Tq, Tk, qs_, ks_, vs_, ds_,     \
      sm_scale, causal, drop

template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads) flash_attention_bwd_dq_kernel(OPENASR_DQ_PARAMS) {
  dq_body<Ops, D, kDropout, false>(OPENASR_DQ_ARGS);
}
// ptxas, left to its own budget, fits the f32 dQ kernel at D = 64 into 128
// registers with an 8-byte spill; 3 blocks an SM (what its shared memory
// allows) gives it room.  Every other instantiation keeps ptxas's budget,
// as in the forward.
template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads, 3)
    flash_attention_bwd_dq_kernel_3(OPENASR_DQ_PARAMS) {
  dq_body<Ops, D, kDropout, false>(OPENASR_DQ_ARGS);
}

// Two blocks an SM: the hint lets ptxas use the registers that leaves (the
// pass over S and dP holds both, at D 64 and 128 in f32 more than 168)
// instead of spilling; the f32 tiles' shared memory allows at most three.
template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads, 2)
    flash_attention_bwd_stats_kernel(OPENASR_DQ_PARAMS) {
  dq_body<Ops, D, kDropout, true>(OPENASR_DQ_ARGS);
}

#undef OPENASR_DQ_PARAMS
#undef OPENASR_DQ_ARGS

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *stats;
  float* stats_out;
  const int* kv_lengths;
  void *dq, *dk, *dv;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, ds;
  float sm_scale;
  int causal;
  Dropout drop;
  int device;
};

template <typename Ops, int D, bool kDropout>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  // K, V tiles; Q, dO, lse, the row sums, their reciprocals and delta
  // double-buffered
  constexpr size_t smem =
      (2 * kRows + 4 * kWalk) * Tiles<Ops, D>::kStride * sizeof(E) + 8 * kWalk * sizeof(float);
  auto kernel = flash_attention_bwd_dkv_kernel<Ops, D, kDropout>;
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const E*>(a.dout), a.lse, a.stats, a.kv_lengths, static_cast<E*>(a.dk),
      static_cast<E*>(a.dv), a.H, a.Tq, a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.causal,
      a.drop);
  return cudaGetLastError();
}

// kStats: the statistics pass; else dQ
template <typename Ops, int D, bool kDropout, bool kStats>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  // Q, dO tiles; K, V double-buffered
  constexpr size_t smem = (2 * kRows + 4 * kWalk) * Tiles<Ops, D>::kStride * sizeof(E);
  auto kernel = [] {
    if constexpr (kStats)
      return flash_attention_bwd_stats_kernel<Ops, D, kDropout>;
    else if constexpr (std::is_same<Ops, Tf32x3Ops>::value && D == 64)
      return flash_attention_bwd_dq_kernel_3<Ops, D, kDropout>;
    else
      return flash_attention_bwd_dq_kernel<Ops, D, kDropout>;
  }();
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDqThreads, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const E*>(a.dout), a.lse, a.stats, a.stats_out, a.kv_lengths,
      static_cast<E*>(a.dq), a.H, a.Tq, a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.causal,
      a.drop);
  return cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ, 2: the statistics
template <typename Ops, int D>
cudaError_t launch_one(int which, const Args& a, cudaStream_t stream) {
  if (which == 0)
    return a.drop.on ? launch_dkv<Ops, D, true>(a, stream) : launch_dkv<Ops, D, false>(a, stream);
  if (which == 1)
    return a.drop.on ? launch_dq<Ops, D, true, false>(a, stream)
                     : launch_dq<Ops, D, false, false>(a, stream);
  return a.drop.on ? launch_dq<Ops, D, true, true>(a, stream)
                   : launch_dq<Ops, D, false, true>(a, stream);
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
        const void* dout, const void* lse, const void* stats, void* stats_out,
        const void* kv_lengths, void* dq, void* dk, void* dv, int B, int H,
        int Tq, int Tk, int D, const long long* strides, float sm_scale,
        int causal, unsigned int dropout_seed, unsigned int keep_thresh,
        float drop_scale, int dropout, int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a{q, k, v, dout,
         static_cast<const float*>(lse), static_cast<const float*>(stats),
         static_cast<float*>(stats_out), static_cast<const int*>(kv_lengths), dq, dk, dv,
         B, H, Tq, Tk,
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

// The backward's row statistics of attention: for each query row, the sum
// of P = exp(S * scale - lse), its reciprocal and delta = rowsum(P o dP o
// D) with P divided by that sum, written to stats_out, contiguous
// [3][B][H][Tq] f32 (sums, reciprocals, deltas).  q, dout: [B, Tq, H, D]; k, v: [B, Tk, H, D], each
// addressed through its (batch, time, head) strides, given in `strides` as
// q, k, v, dout triples (12 values), with unit stride along D, 16-byte
// aligned rows (each pointer and stride a multiple of 16 bytes); lse:
// contiguous [B, H, Tq] f32; kv_lengths: [B] int32 or null.  Dropout
// arguments as in the forward.
int openasr_flash_attention_bwd_stats(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* stats_out, const void* kv_lengths, int B, int H,
    int Tq, int Tk, int D, const long long* strides, float sm_scale,
    int causal, unsigned int dropout_seed, unsigned int keep_thresh,
    float drop_scale, int dropout, int dtype, int device, void* stream) {
  return openasr::run(2, q, k, v, dout, lse, nullptr, stats_out, kv_lengths, nullptr,
                      nullptr, nullptr, B, H, Tq, Tk, D, strides, sm_scale, causal,
                      dropout_seed, keep_thresh, drop_scale, dropout, dtype, device,
                      stream);
}

// dk, dv of attention; arguments as above, stats: the statistics pass's
// output; dk, dv: contiguous [B, Tk, H, D].
int openasr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* stats, const void* kv_lengths, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, const long long* strides,
    float sm_scale, int causal, unsigned int dropout_seed,
    unsigned int keep_thresh, float drop_scale, int dropout, int dtype,
    int device, void* stream) {
  return openasr::run(0, q, k, v, dout, lse, stats, nullptr, kv_lengths, nullptr, dk,
                      dv, B, H, Tq, Tk, D, strides, sm_scale, causal, dropout_seed,
                      keep_thresh, drop_scale, dropout, dtype, device, stream);
}

// dq of attention; arguments as above, dq: contiguous [B, Tq, H, D].
int openasr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* stats, const void* kv_lengths, void* dq,
    int B, int H, int Tq, int Tk, int D, const long long* strides,
    float sm_scale, int causal, unsigned int dropout_seed,
    unsigned int keep_thresh, float drop_scale, int dropout, int dtype,
    int device, void* stream) {
  return openasr::run(1, q, k, v, dout, lse, stats, nullptr, kv_lengths, dq, nullptr,
                      nullptr, B, H, Tq, Tk, D, strides, sm_scale, causal, dropout_seed,
                      keep_thresh, drop_scale, dropout, dtype, device, stream);
}

}  // extern "C"
