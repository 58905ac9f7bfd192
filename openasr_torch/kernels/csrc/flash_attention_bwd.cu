// Flash attention backward for Hopper (sm_90a): the row statistics, dK/dV
// and dQ on the tensor cores, and the C entry points of both routes.
//
// Replaces the Pallas TPU kernels
// openasr_tpu/kernels/flash_attention.py:_bwd_dkv_kernel (:238) and
// `_bwd_dq_kernel` (:327), and its delta (:468).  With the forward's masks
// (key padding from kv_lengths, causal kpos <= qpos) and, with dropout, the
// same positional hash mask D = keep / (1 - rate) (common.cuh):
// - the statistics pass walks the keys once per query row and writes, in
//   log2 units s' = S * scale * log2(e), the row's max m, 1 / l with l =
//   sum exp2(s' - m), and delta = rowsum(P o dP o D), P = exp2(s' - m) / l;
// - dK/dV and dQ recompute P = exp2(s' - m) * (1 / l) from those, and
//   dV = (P o D)^T dO,   dP = (dO V^T) o D,
//   dS = P o (dP - delta) * scale,   dK = dS^T Q,   dQ = dS K.
// Unlike the TPU kernels, which take P from the forward's lse and delta =
// rowsum(dO o O) from the caller, P and delta here come from the same
// products in every kernel, bit for bit (S and dP through Ops::mma_sym,
// whose result does not depend on which operand is A, in the same k
// order), and P's row max gives exp2(0) = 1 exactly (no contraction between
// the scale and the max).  So on a one-hot softmax row (scores of 1e4 and
// more, as at the recipe gate's first layer) the other terms vanish beside
// 1, l = 1, P is exactly one-hot, delta is the max key's dP o D and dS is
// exactly 0, with no per-element select; with lse and delta = rowsum(dO o
// O) the rounding residue of dP - delta, times the keys and the layer's
// input, was the whole q/k gradient there.  An empty row (past Tq, a batch
// row of length 0) has 1 / l = 0, m = 0 and no valid key, so its P is 0.
// As on the TPU, dK/dV and dQ are two kernels: the first walks queries for
// a tile of keys, the second keys for a tile of queries, so neither needs
// atomics and the gradients are the same bit for bit from run to run; dQ
// pays for it by recomputing S and dP (two of its three products).
// The chunk mode of streaming encoders (openasr::Mask, flash_tiles.cuh; no
// TPU kernel, the JAX package attends densely under chunk_bias) masks
// each pair as the forward does, and each kernel walks only the rows its
// tile's rows can see: the statistics pass and dQ the keys from the first
// query's chunk window to the last query's chunk end, dK/dV the queries
// from the first key's chunk to `left` chunks past the last valid key's.
// A query row that sees no key has m = 1 / l = delta = 0, so its P, its
// dQ and its share of dK and dV are 0.
//
// Bounds on the H100.  At the flagship's training shapes (T 32-139, D 64):
// bytes, in bf16 and in f32 alike; reading q, k, v, dO once and writing dq,
// dk, dv once takes longer at 3.35 TB/s than the Tq x Tk x D products (two
// in the statistics, four in dK/dV, three in dQ) at 989 TFLOP/s in bf16, or
// in f32 as 3xTF32 at a third of TF32's 495 TFLOP/s.  At long T (wav2vec's
// T' up to 3000): those products.  And under every shape an elementwise
// floor that neither bound counts: each kernel's exp2 of every visible pair
// on the MUFU units (16 a clock an SM) and, with dropout, its keep hash
// (11 integer operations a pair, `dropout_keep`, on the INT32 units at 64
// lanes a clock an SM); at wav2vec's 2.6e8 pairs the hash alone is 0.17 ms
// a kernel, more than the bf16 products of the statistics pass or dQ.
//
// Two routes, the three kernels of a backward always on the same one
// (flash_attention.py:bwd_route; P and delta must be the same bits):
// - f32, and bf16 below 72 queries or keys (WGMMA_MIN_T), the mma.sync
//   kernels below: the loads set their time at these shapes, which 64-row
//   tiles and double-buffered cp.async steps serve;
// - bf16 from 72 queries and keys on, the wgmma kernels of
//   flash_attention_bwd_wgmma.cu: TMA-fed rings, asynchronous products
//   from shared-memory and register operands, dK/dV computing S^T once for
//   dV and dK, and each step's elementwise work (the masks, exp2, the hash)
//   on two warpgroups that take turns with the tensor cores; the hash stays
//   the one floor it cannot hide (PERF.md).
//
// Design of the mma.sync route: FA2's backward on mma.sync.  A block owns
// 64 rows and walks the other side 32 rows a step, at every D.
// - Statistics: one block of 4 warps per (64-query tile, head, batch),
//   warp w owning queries q0 + 16w..+15.  One walk over the key steps, up
//   to kv_length and, under causal, the tile's diagonal, K and V each
//   staged once a step, double-buffered with cp.async commit/wait groups;
//   two products a step, S = Q K^T and dP = dO V^T, then FA2's online
//   softmax: a row's running max m lives in the lane quad that holds the
//   row (two shuffles a step), l and a = sum exp2(s' - m) dP o D as a
//   lane's partials, rescaled by exp2(m_old - m_new) when m grows and
//   summed over the quad once at the end; delta = a * (1 / l).  A warp
//   skips the products of a step that holds no pair it can see (rows past
//   Tq, keys all above its diagonal): those pairs add nothing.  No dQ
//   accumulator and no dS, so its registers are its own (the table below),
//   and its blocks an SM are what its shared memory allows, at most 6.
// - dK/dV: one block of 8 warps per (64-key tile, head, batch).  Warps 0-3
//   accumulate dV and warps 4-7 dK, each for 16 keys k0 + 16(w % 4)..+15,
//   so a lane holds one [16, D] accumulator, not two.  The K and V tiles
//   are staged once in shared memory; the block walks query steps whose
//   Q, dO and row statistics (m, 1 / l, delta) are double-buffered, so
//   step i + 1 loads while step i computes.  Per step a warp computes
//   S^T = K Q^T (the dK warps also dP^T = V dO^T), rows keys and columns
//   queries, so the masks and the hash take (query, key) swapped back;
//   turns them into (P o D)^T or dS^T in registers; and uses those
//   accumulator fragments as they stand as the A operand of
//   dV += (P o D)^T dO or dK += dS^T Q, with dO and Q read as B operands
//   through a transposing load.  Under causal the walk starts at the step
//   holding the block's first key; a block whose keys are all padding
//   walks nothing and writes zeros.
// - dQ: the mirror, one block of 4 warps per (64-query tile, head, batch),
//   warp w owning queries q0 + 16w..+15 and their statistics in
//   registers; key steps double-buffered up to kv_length and, under
//   causal, the diagonal; S = Q K^T, dP = dO V^T, dS as the A operand of
//   dQ += dS K.
// - The fragments of the block's own tile (K and V, or Q and dO) are
//   re-read from shared memory at each step rather than held in registers:
//   held, they made dK/dV at D = 64 with dropout and every D = 128 kernel
//   spill (255 registers).
// - Operands, staging and stores come from flash_tiles.cuh, shared with
//   the forward: staged rows padded by 8 elements, 16-byte cp.async (the
//   wrapper checks that rows are 16-byte aligned).  Shared memory is (2 *
//   64 + 4 * 32) rows of D + 8 elements (dK/dV adds 768 bytes of row
//   statistics), above 48 KB (opt-in) at D = 128 in bf16 and at D >= 64 in
//   f32.
// - bf16 (Bf16Ops): mma.m16n8k16 from ldmatrix / ldmatrix.trans.  P o D
//   and dS are rounded to bf16 before the second products, where JAX casts
//   them (`p_drop.astype(do.dtype)`, `ds.astype(q.dtype)`, :305, :316,
//   :387); sums stay f32.
// - f32 (Tf32x3Ops): mma.m16n8k8 as 3xTF32, which keeps f32's precision,
//   with the k permutation that makes an accumulator fragment an A
//   fragment as it stands.
// Registers a thread from ptxas for sm_90a (without / with dropout), no
// instantiation spilling (chip_smoke.py prints them as its [ptxas] line
// and fails on a spill; the f32 dQ at D = 64 through its 3-blocks entry,
// the statistics hinted at the blocks their shared memory allows, at most
// 6: 6, 6, 3 in bf16 and 5, 3, 1 in f32 at D 32, 64, 128):
//            bf16 stats  bf16 dK/dV  bf16 dQ    f32 stats  f32 dK/dV  f32 dQ
//   D = 32    80 /  80   115 / 121    80 /  80   96 /  96  128 / 128  126 / 124
//   D = 64    80 /  78   123 / 127   128 / 128  135 / 137  126 / 125  162 / 159
//   D = 128  135 / 137   162 / 165   166 / 161  135 / 137  169 / 169  161 / 160

#include <type_traits>

#include "flash_bwd.cuh"

namespace openasr {
namespace {

constexpr int kRows = 64;          // keys (dK/dV) or queries (dQ, statistics) per block
constexpr int kDkvThreads = 256;   // 8 warps: 4 on dV, 4 on dK, 16 keys each
constexpr int kDqThreads = 128;    // 4 warps, 16 queries each
constexpr int kWalk = 32;          // rows per step of a walk

// S = Q K^T and dP = dO V^T of one walk step, [16 queries, kWalk keys] a
// warp: the rows qw.. of the staged Q and dO tiles against the staged K
// and V steps.  The statistics pass and dQ compute them with this code, and
// dK/dV the same products with the operands' roles swapped, which
// Ops::mma_sym gives the same bits.  The k loop unrolls by 2 (the k order,
// and so the bits, are the same at any unroll): unrolled whole, dQ took
// 150 registers in bf16 at D 64 where it needs 127 and spilled in f32 at
// D 64, and both ran slower (PERF.md).
template <typename Ops, int D>
__device__ __forceinline__ void score_products(float (&s)[kWalk / 8][4], float (&dp)[kWalk / 8][4],
                                               const typename Ops::Elem* qsm,
                                               const typename Ops::Elem* dosm,
                                               const typename Ops::Elem* kt,
                                               const typename Ops::Elem* vt, int qw, int lane) {
  constexpr int S = Tiles<Ops, D>::kStride, kK = Ops::kK;
#pragma unroll
  for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / kK; ++kk) {
    typename Ops::A qa, oa;
    Ops::template load_a<S>(qa, qsm, qw, kk * kK, lane);
    Ops::template load_a<S>(oa, dosm, qw, kk * kK, lane);
#pragma unroll
    for (int n2 = 0; n2 < kWalk / 16; ++n2) {
      typename Ops::B k0f, k1f, v0f, v1f;
      Ops::template load_b_nk<S>(k0f, k1f, kt, n2 * 16, kk * kK, lane);
      Ops::mma_sym(s[2 * n2], qa, k0f);
      Ops::mma_sym(s[2 * n2 + 1], qa, k1f);
      Ops::template load_b_nk<S>(v0f, v1f, vt, n2 * 16, kk * kK, lane);
      Ops::mma_sym(dp[2 * n2], oa, v0f);
      Ops::mma_sym(dp[2 * n2 + 1], oa, v1f);
    }
  }
}

// ------------------------------------------------------------ statistics

// Shared memory of the statistics pass and dQ: Q, dO tiles; K, V
// double-buffered.  The statistics pass asks for the blocks an SM that it
// allows (232 448 bytes an SM, 1 KB reserved a block), at most 6.
template <typename Ops, int D>
struct QueryTiles {
  static constexpr int kSmem =
      (2 * kRows + 4 * kWalk) * Tiles<Ops, D>::kStride * sizeof(typename Ops::Elem);
  static constexpr int kFit = 232448 / (kSmem + 1024);
  static constexpr int kStatBlocks = kFit < 6 ? kFit : 6;
};

template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads, (QueryTiles<Ops, D>::kStatBlocks))
flash_attention_bwd_stats_kernel(
    const typename Ops::Elem* __restrict__ q, const typename Ops::Elem* __restrict__ k,
    const typename Ops::Elem* __restrict__ v, const typename Ops::Elem* __restrict__ dout,
    const int* __restrict__ kv_lengths, float* __restrict__ stats, int H, int Tq, int Tk,
    Strides qs_, Strides ks_, Strides vs_, Strides ds_, float sm_scale, Mask mask,
    Dropout drop) {
  using E = typename Ops::Elem;
  constexpr int kBQ = kRows, kBK = kWalk, S = Tiles<Ops, D>::kStride, NT = kDqThreads;
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
  // the keys the tile's rows see, and those of the warp's 16 rows
  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int k_begin = mask.keys_of(q0).x;
  const int k_end = min(n_valid, mask.keys_of(q_last).y);
  const int wk_begin = mask.keys_of(q0 + qw).x;
  const int wk_end = min(n_valid, mask.keys_of(min(q0 + qw + 15, q_last)).y);

  // the lane's two rows (g, g + 8): position, visible keys [klo, khi),
  // running max (log2 units), and the lane's parts of l and a = sum
  // exp2(s' - m) dP o D
  int qrow[2], klo[2], khi[2];
  float m[2], l[2], acc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + qw + g + 8 * r;
    const int2 ks = mask.keys_of(qrow[r]);
    klo[r] = ks.x;
    khi[r] = min(ks.y, n_valid);
    m[r] = kNegInf;
    l[r] = acc[r] = 0.f;
  }

  const E* kb = k + b * ks_.b + h * ks_.h;
  const E* vb = v + b * vs_.b + h * vs_.h;
  if (k_begin < k_end) {
    stage_rows<Ops, D, kBQ, NT>(qsm, q + b * qs_.b + h * qs_.h, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm, dout + b * ds_.b + h * ds_.h, ds_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBK, NT>(ksm, kb, ks_.t, k_begin, Tk, tid);
    stage_rows<Ops, D, kBK, NT>(vsm, vb, vs_.t, k_begin, Tk, tid);
    cp_async_commit();
  }
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK, buf ^= 1) {
    if (k0 + kBK < k_end) {
      stage_rows<Ops, D, kBK, NT>(ksm + (buf ^ 1) * kBK * S, kb, ks_.t, k0 + kBK, Tk, tid);
      stage_rows<Ops, D, kBK, NT>(vsm + (buf ^ 1) * kBK * S, vb, vs_.t, k0 + kBK, Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // warp-uniform: does this step hold a pair the warp's rows can see?
    if (q0 + qw < Tq && k0 < wk_end && k0 + kBK > wk_begin) {
      float s[kBK / 8][4], dp[kBK / 8][4];
      score_products<Ops, D>(s, dp, qsm, dosm, ksm + buf * kBK * S, vsm + buf * kBK * S, qw,
                             lane);

      // s <- s' = S scale log2(e), kNegInf where masked; the step's row max
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + j * 8 + t2 + (e & 1);
          const bool ok = key >= klo[r] && key < khi[r];
          s[j][e] = ok ? __fmul_rn(s[j][e], scale_log2) : kNegInf;
          mt[r] = fmaxf(mt[r], s[j][e]);
        }
      }
      // the row max over the quad, the new running max and the rescale of
      // what came before: exp2(0) = 1 while m holds, 0 from a first valid
      // key (kNegInf - m underflows); no infinity enters
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        const float alpha = exp2f(__fsub_rn(m[r], m_new));
        m[r] = m_new;
        l[r] = __fmul_rn(l[r], alpha);
        acc[r] = __fmul_rn(acc[r], alpha);
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          if (s[j][e] > 0.5f * kNegInf) {
            const float p = exp2f(__fsub_rn(s[j][e], m[r]));
            float dpd = dp[j][e];
            if (kDropout) {
              const int key = k0 + j * 8 + t2 + (e & 1);
              const bool keep =
                  dropout_keep(drop.seed, bh, (uint32_t)qrow[r], (uint32_t)key, drop.thresh);
              dpd = keep ? __fmul_rn(dpd, drop.scale) : 0.f;
            }
            l[r] = __fadd_rn(l[r], p);
            acc[r] = __fadd_rn(acc[r], __fmul_rn(p, dpd));
          }
        }
      }
    }
    __syncthreads();  // buffer `buf` is refilled two steps on
  }

  // l and a over the quad (the same bits in each lane), then m, 1 / l and
  // delta = a / l; a row with no valid key writes 0, 0, 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], 1));
    acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], 2));
  }
  if ((lane & 3) == 0) {
    const long long rows = (long long)gridDim.z * H * Tq;  // B H Tq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] < Tq) {
        const long long at = ((long long)b * H + h) * Tq + qrow[r];
        const bool any = l[r] > 0.f;
        const float inv_l = any ? __frcp_rn(l[r]) : 0.f;
        stats[at] = any ? m[r] : 0.f;
        stats[rows + at] = inv_l;
        stats[2 * rows + at] = __fmul_rn(acc[r], inv_l);
      }
    }
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
    const float* __restrict__ stats, const int* __restrict__ kv_lengths,
    typename Ops::Elem* __restrict__ dk, typename Ops::Elem* __restrict__ dv, int H, int Tq,
    int Tk, Strides qs_, Strides ks_, Strides vs_, Strides ds_, float sm_scale, Mask mask,
    Dropout drop) {
  using E = typename Ops::Elem;
  constexpr int kBK = kRows, kBQ = kWalk, S = Tiles<Ops, D>::kStride, kK = Ops::kK;
  constexpr int NT = kDkvThreads;
  static_assert(kStats * kBQ <= NT, "one thread a row statistic");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ksm = reinterpret_cast<E*>(smem_raw);   // [kBK][S]
  E* vsm = ksm + kBK * S;                     // [kBK][S]
  E* qsm = vsm + kBK * S;                     // [2][kBQ][S]
  E* dosm = qsm + 2 * kBQ * S;                // [2][kBQ][S]
  float* m_s = reinterpret_cast<float*>(dosm + 2 * kBQ * S);  // [2][kBQ]
  float* inv_s = m_s + 2 * kBQ;                                 // [2][kBQ]
  float* delta_s = inv_s + 2 * kBQ;                             // [2][kBQ]

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

  // the queries that see the block's valid keys (the mask's intervals of
  // its first and last valid key); a block whose keys are all padding
  // walks nothing and writes zeros
  int q_begin = Tq, q_end = Tq;
  if (k0 < n_valid) {
    q_begin = mask.queries_of(k0).x;
    q_end = min(Tq, mask.queries_of(min(k0 + kBK, n_valid) - 1).y);
  }
  // the lane's two key rows (g, g + 8): the queries [qlo, qhi) that see
  // them, none for a padded key
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw + g + 8 * r;
    const int2 qs = mask.queries_of(key);
    qlo[r] = qs.x;
    qhi[r] = key < n_valid ? min(qs.y, Tq) : 0;
  }
  const E* qb = q + b * qs_.b + h * qs_.h;
  const E* db = dout + b * ds_.b + h * ds_.h;
  // the row statistic this thread stages, if any (threads 0-95): m, 1 / l
  // or delta ([3][B][H][Tq] stats), into m_s, inv_s or delta_s
  const int stat = tid / kBQ, stat_i = tid % kBQ;
  const float* stat_src =
      stats + (stat * (long long)gridDim.z * H + (long long)b * H + h) * Tq;
  float* stat_dst = m_s + stat * 2 * kBQ + stat_i;

  auto stage_queries = [&](int q0, int buf) {
    stage_rows<Ops, D, kBQ, NT>(qsm + buf * kBQ * S, qb, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm + buf * kBQ * S, db, ds_.t, q0, Tq, tid);
    if (stat < kStats) {
      const bool ok = q0 + stat_i < Tq;
      cp_async4(smem_u32(stat_dst + buf * kBQ), stat_src + (ok ? q0 + stat_i : 0), ok);
    }
  };

  if (q_begin < q_end) {
    stage_rows<Ops, D, kBK, NT>(ksm, k + b * ks_.b + h * ks_.h, ks_.t, k0, Tk, tid);
    stage_rows<Ops, D, kBK, NT>(vsm, v + b * vs_.b + h * vs_.h, vs_.t, k0, Tk, tid);
    stage_queries(q_begin, 0);
    cp_async_commit();

    int buf = 0;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ, buf ^= 1) {
      if (q0 + kBQ < q_end) {
        stage_queries(q0 + kBQ, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const E* qt = qsm + buf * kBQ * S;
      const E* dot = dosm + buf * kBQ * S;
      const float* mr = m_s + buf * kBQ;
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
      // order.  P and delta are the statistics pass's, bit for bit
      // (`weight`, `grad_entry`), so dS^T is exactly 0 where a row is
      // one-hot.
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + g + (e >> 1) * 8;
          const int qi = j * 8 + t2 + (e & 1);
          const int qp = q0 + qi;
          const bool ok = qp >= qlo[e >> 1] && qp < qhi[e >> 1];
          const float p = ok ? weight(st[j][e], scale_log2, mr[qi], iv[qi]) : 0.f;
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

// dQ reads each row's m, 1 / l and delta from the statistics pass and
// walks the keys once.
template <typename Ops, int D, bool kDropout>
__device__ __forceinline__ void dq_body(
    const typename Ops::Elem* __restrict__ q, const typename Ops::Elem* __restrict__ k,
    const typename Ops::Elem* __restrict__ v, const typename Ops::Elem* __restrict__ dout,
    const float* __restrict__ stats, const int* __restrict__ kv_lengths,
    typename Ops::Elem* __restrict__ dq, int H, int Tq, int Tk, Strides qs_, Strides ks_,
    Strides vs_, Strides ds_, float sm_scale, Mask mask, Dropout drop) {
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
  // the keys the tile's rows see
  const int k_begin = mask.keys_of(q0).x;
  const int k_end = min(n_valid, mask.keys_of(min(q0 + kBQ, Tq) - 1).y);

  // the lane's two rows (g, g + 8): position, visible keys [klo, khi), m,
  // 1 / l and delta
  int qrow[2], klo[2], khi[2];
  float m_r[2], inv_r[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + qw + g + 8 * r;
    const int2 ks = mask.keys_of(qrow[r]);
    klo[r] = ks.x;
    khi[r] = qrow[r] < Tq ? min(ks.y, n_valid) : 0;
    const long long at = ((long long)b * H + h) * Tq + min(qrow[r], Tq - 1);
    m_r[r] = qrow[r] < Tq ? stats[at] : 0.f;
    inv_r[r] = qrow[r] < Tq ? stats[rows + at] : 0.f;
    dlt[r] = qrow[r] < Tq ? stats[2 * rows + at] : 0.f;
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const E* kb = k + b * ks_.b + h * ks_.h;
  const E* vb = v + b * vs_.b + h * vs_.h;
  if (k_begin < k_end) {
    stage_rows<Ops, D, kBQ, NT>(qsm, q + b * qs_.b + h * qs_.h, qs_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBQ, NT>(dosm, dout + b * ds_.b + h * ds_.h, ds_.t, q0, Tq, tid);
    stage_rows<Ops, D, kBK, NT>(ksm, kb, ks_.t, k_begin, Tk, tid);
    stage_rows<Ops, D, kBK, NT>(vsm, vb, vs_.t, k_begin, Tk, tid);
    cp_async_commit();
  }
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK, buf ^= 1) {
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

    float s[kBK / 8][4], dp[kBK / 8][4];
    score_products<Ops, D>(s, dp, qsm, dosm, kt, vsm + buf * kBK * S, qw, lane);

    // s <- dS: row = query, column = key
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + t2 + (e & 1);
        const int qp = qrow[r];
        const bool ok = key >= klo[r] && key < khi[r];
        const float p = ok ? weight(s[j][e], scale_log2, m_r[r], inv_r[r]) : 0.f;
        float dpd = dp[j][e];
        if (kDropout) {
          const bool keep = dropout_keep(drop.seed, bh, (uint32_t)qp, (uint32_t)key, drop.thresh);
          dpd = keep ? __fmul_rn(dpd, drop.scale) : 0.f;
        }
        s[j][e] = ok ? grad_entry(p, dpd, dlt[r], sm_scale) : 0.f;
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
    __syncthreads();  // buffer `buf` is refilled two steps on
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
      const float *__restrict__ stats, const int *__restrict__ kv_lengths,                 \
      typename Ops::Elem *__restrict__ dq, int H, int Tq, int Tk, Strides qs_,             \
      Strides ks_, Strides vs_, Strides ds_, float sm_scale, Mask mask, Dropout drop
#define OPENASR_DQ_ARGS                                                                    \
  q, k, v, dout, stats, kv_lengths, dq, H, Tq, Tk, qs_, ks_, vs_, ds_, sm_scale, mask, drop

template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads) flash_attention_bwd_dq_kernel(OPENASR_DQ_PARAMS) {
  dq_body<Ops, D, kDropout>(OPENASR_DQ_ARGS);
}
// ptxas, left to its own budget, fits the f32 dQ kernel at D = 64 into 128
// registers with an 8-byte spill; 3 blocks an SM (what its shared memory
// allows) gives it room.  Every other instantiation keeps ptxas's budget,
// as in the forward.
template <typename Ops, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads, 3)
    flash_attention_bwd_dq_kernel_3(OPENASR_DQ_PARAMS) {
  dq_body<Ops, D, kDropout>(OPENASR_DQ_ARGS);
}

#undef OPENASR_DQ_PARAMS
#undef OPENASR_DQ_ARGS

// ---------------------------------------------------------------- launch

template <typename Ops, int D, bool kDropout>
cudaError_t launch_stats(const BwdArgs& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  constexpr size_t smem = QueryTiles<Ops, D>::kSmem;
  auto kernel = flash_attention_bwd_stats_kernel<Ops, D, kDropout>;
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDqThreads, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const E*>(a.dout), a.kv_lengths, a.stats, a.H, a.Tq, a.Tk, a.qs, a.ks, a.vs,
      a.ds, a.sm_scale, a.mask, a.drop);
  return cudaGetLastError();
}

template <typename Ops, int D, bool kDropout>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  // K, V tiles; Q, dO and the row statistics double-buffered
  constexpr size_t smem = (2 * kRows + 4 * kWalk) * Tiles<Ops, D>::kStride * sizeof(E) +
                          2 * kStats * kWalk * sizeof(float);
  auto kernel = flash_attention_bwd_dkv_kernel<Ops, D, kDropout>;
  static int asked[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, a.device, asked);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const E*>(a.dout), a.stats, a.kv_lengths, static_cast<E*>(a.dk),
      static_cast<E*>(a.dv), a.H, a.Tq, a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.mask,
      a.drop);
  return cudaGetLastError();
}

template <typename Ops, int D, bool kDropout>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  using E = typename Ops::Elem;
  constexpr size_t smem = QueryTiles<Ops, D>::kSmem;
  auto kernel = [] {
    if constexpr (std::is_same<Ops, Tf32x3Ops>::value && D == 64)
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
      static_cast<const E*>(a.dout), a.stats, a.kv_lengths, static_cast<E*>(a.dq), a.H, a.Tq,
      a.Tk, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.mask, a.drop);
  return cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ, 2: the statistics
template <typename Ops, int D>
cudaError_t launch_one(int which, const BwdArgs& a, cudaStream_t stream) {
  if (which == 0)
    return a.drop.on ? launch_dkv<Ops, D, true>(a, stream) : launch_dkv<Ops, D, false>(a, stream);
  if (which == 1)
    return a.drop.on ? launch_dq<Ops, D, true>(a, stream) : launch_dq<Ops, D, false>(a, stream);
  return a.drop.on ? launch_stats<Ops, D, true>(a, stream)
                   : launch_stats<Ops, D, false>(a, stream);
}

template <typename Ops>
cudaError_t dispatch_d(int which, int D, const BwdArgs& a, cudaStream_t stream) {
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

// route 0: the mma.sync kernels above (f32, bf16); 1: the wgmma kernels
// (flash_attention_bwd_wgmma.cu, bf16).  The three kernels of one
// backward take the same route, so P and delta agree bit for bit.
int run(int which, const void* q, const void* k, const void* v, const void* dout, void* stats,
        const void* kv_lengths, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
        int D, const long long* strides, float sm_scale, const Mask& mask,
        unsigned int dropout_seed, unsigned int keep_thresh, float drop_scale, int dropout,
        int route, int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BwdArgs a{q, k, v, dout,
            static_cast<float*>(stats), static_cast<const int*>(kv_lengths), dq, dk, dv,
            B, H, Tq, Tk,
            {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
            {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]},
            sm_scale, mask, {dropout != 0, dropout_seed, keep_thresh, drop_scale}, device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return dtype == kBFloat16 ? launch_bwd_wgmma(which, D, a, s) : cudaErrorInvalidValue;
  if (route != 0) return cudaErrorInvalidValue;
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

// The backward's row statistics of attention, written to stats_out,
// contiguous [3][B][H][Tq] f32: for each query row, in log2 units s' = S *
// sm_scale * log2(e) over its valid keys, the max m, 1 / l with l =
// sum exp2(s' - m), and delta = rowsum(P o dP o D) with P = exp2(s' - m) /
// l (0, 0, 0 on a row with no valid key).  q, dout: [B, Tq, H, D]; k, v:
// [B, Tk, H, D], each addressed through its (batch, time, head) strides,
// given in `strides` as q, k, v, dout triples (12 values), with unit stride
// along D, 16-byte aligned rows (each pointer and stride a multiple of 16
// bytes); kv_lengths: [B] int32 or null.  Mask (causal; chunk,
// left_chunks, phase) and dropout arguments as in the forward; route 0
// the mma.sync kernels (f32, bf16), 1 the wgmma kernels (bf16), the same
// for the three kernels of one backward.
int openasr_flash_attention_bwd_stats(
    const void* q, const void* k, const void* v, const void* dout, void* stats_out,
    const void* kv_lengths, int B, int H, int Tq, int Tk, int D, const long long* strides,
    float sm_scale, int causal, int chunk, int left_chunks, int phase,
    unsigned int dropout_seed, unsigned int keep_thresh, float drop_scale, int dropout,
    int route, int dtype, int device, void* stream) {
  return openasr::run(2, q, k, v, dout, stats_out, kv_lengths, nullptr, nullptr, nullptr, B, H,
                      Tq, Tk, D, strides, sm_scale,
                      {causal, chunk, left_chunks, phase}, dropout_seed, keep_thresh,
                      drop_scale, dropout, route, dtype, device, stream);
}

// dk, dv of attention; arguments as above, stats: the statistics pass's
// output; dk, dv: contiguous [B, Tk, H, D].
int openasr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* stats,
    const void* kv_lengths, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    const long long* strides, float sm_scale, int causal, int chunk, int left_chunks,
    int phase, unsigned int dropout_seed, unsigned int keep_thresh, float drop_scale,
    int dropout, int route, int dtype, int device, void* stream) {
  return openasr::run(0, q, k, v, dout, const_cast<void*>(stats), kv_lengths, nullptr, dk, dv,
                      B, H, Tq, Tk, D, strides, sm_scale,
                      {causal, chunk, left_chunks, phase}, dropout_seed, keep_thresh,
                      drop_scale, dropout, route, dtype, device, stream);
}

// dq of attention; arguments as above, dq: contiguous [B, Tq, H, D].
int openasr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* stats,
    const void* kv_lengths, void* dq, int B, int H, int Tq, int Tk, int D,
    const long long* strides, float sm_scale, int causal, int chunk, int left_chunks,
    int phase, unsigned int dropout_seed, unsigned int keep_thresh, float drop_scale,
    int dropout, int route, int dtype, int device, void* stream) {
  return openasr::run(1, q, k, v, dout, const_cast<void*>(stats), kv_lengths, dq, nullptr,
                      nullptr, B, H, Tq, Tk, D, strides, sm_scale,
                      {causal, chunk, left_chunks, phase}, dropout_seed,
                      keep_thresh, drop_scale, dropout, route, dtype, device, stream);
}

}  // extern "C"
