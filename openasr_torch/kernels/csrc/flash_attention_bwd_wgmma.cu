// The bf16 attention backward on Hopper's asynchronous tensor-core path,
// from 72 queries and keys on (flash_attention.py:bwd_route): the
// statistics pass, dK/dV and dQ of flash_attention_bwd.cu (whose header
// states what they compute, the TPU kernels they replace,
// openasr_tpu/kernels/flash_attention.py:_bwd_dkv_kernel and _bwd_dq_kernel
// with its delta, their bounds and the invariant that P and delta are the
// same bits in all three) as wgmma kernels fed by TMA.
//
// A block is two computing warpgroups and a loading warp.  One thread of
// the loading warp issues the TMA copies (4-D tensor maps over [B, T, H,
// D], encoded on the host at each launch, boxes of 64 or 32 columns x
// rows, the ragged T edge zero-filled) into a ring of kStages stages with
// a full and an empty mbarrier each; in dK/dV the warp also copies each
// step's row statistics (m, 1 / l, delta) beside Q and dO with cp.async,
// which arrive on the same full barrier.  Each warpgroup computes 64 rows
// and releases a stage on its empty barrier once its products have read
// it; while one works through a step's elementwise part, the other's
// products run.
// - dK/dV: 128 keys a block (64 at D = 128, each warpgroup half of dK's
//   and dV's columns), K and V loaded once, kBQ queries a step (64 at D
//   32, else 32).  A step issues S^T = K Q^T and dP^T = V dO^T (A and B
//   from shared memory, K-major) behind the previous step's dV and dK
//   products, turns them into (P o D)^T and dS^T, and issues dV += (P o
//   D)^T dO and dK += dS^T Q with those as register A operands (rounded to
//   bf16 where JAX casts) and dO, Q as transposed (MN-major) B operands:
//   one S^T serves both, four products a step.
// - dQ: 128 queries a block, Q and dO loaded once, 64 keys a step (32 at D
//   = 128): S = Q K^T, dP = dO V^T, dS as the register A operand of dQ +=
//   dS K with K as the MN-major B operand.
// - The statistics pass: the same walk and products as dQ, then FA2's
//   online softmax as in the mma.sync kernel.
// - Elementwise: the masks' compares only in a step that is not wholly
//   visible to the lane's rows; exp2 as ex2.approx in all three kernels
//   (`ex2`); the dropout hash of each pair, bit for bit the JAX mask, where
//   it is used.  It is the floor this route leaves: 11 integer operations
//   a pair in each kernel (PERF.md).
// - Registers: three warps share each of the SM's four register files, so
//   a thread has at most 168; the tiles keep every kernel within them, no
//   spill and no serialized product (chip_smoke.py's [ptxas]).
// S and dP come from the same m64nNk16 instruction in k order over D in
// all three kernels, dK/dV with the operands' roles swapped (K Q^T for Q
// K^T); each output is the same sum of the same exact bf16 products, so the
// bits agree, which chip_smoke.py's [saturated softmax] shows on the card
// (dQ and dK exactly 0 on one-hot rows).  No atomics: dK/dV and dQ stay
// two kernels, the gradients the same bits from run to run.

#include <cuda.h>

#include <type_traits>

#include "flash_bwd.cuh"
#include "wgmma.cuh"

namespace openasr {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kWgRows = 64;                       // rows of a computing warpgroup
constexpr int kConsumers = 2;                     // computing warpgroups a block
constexpr int kBlockRows = kConsumers * kWgRows;  // keys (dK/dV) or queries (dQ, statistics)
// Warps 0-7 compute, warp 8 loads: 288 threads.  Three of the block's
// nine warps share each of the SM's four register files of 16384, so a
// thread has at most 168 registers (__launch_bounds__(288, 1)).  (With a
// loading warpgroup ptxas still allocated within 168 whatever setmaxnreg
// then granted the computing ones, and dK/dV spilled.)
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kStages = 4;                         // depth of the ring

// A tile of R rows of D bf16 as TMA writes it: D / kAtom column blocks of
// R rows x kAtom columns (one box each), each swizzled at its row width.
template <int D>
struct Layout {
  static constexpr int kAtom = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kAtom;  // 128 or 64
  static constexpr int kParts = D / kAtom;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor's layout field
  static constexpr int kSbo = 8 * kRowBytes;                      // an 8-row group
};

// Operand descriptors: a tile's base (its start address, LBO, SBO and
// swizzle), built once, plus a k-step's offset in the start-address field
// (16-byte units; the sum stays below the field's 2^14, as shared-memory
// addresses do).  K-major reads of a tile's rows from `tile` on:
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile) {
  using L = Layout<D>;
  return smem_desc(tile, 16, L::kSbo, L::kSwizzle);
}
// their k-step kk (columns 16 kk.., in the column block of an R-row tile)
template <int D, int R>
__device__ __forceinline__ constexpr uint32_t k_step(int kk) {
  using L = Layout<D>;
  return ((16 * kk / L::kAtom) * R * L::kRowBytes + 2 * (16 * kk % L::kAtom)) >> 4;
}
// MN-major reads of an R-row tile (its rows as k, its D columns as n)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile) {
  using L = Layout<D>;
  return smem_desc(tile, R * L::kRowBytes, L::kSbo, L::kSwizzle);
}
// and their k-step kq (rows 16 kq..)
template <int D>
__device__ __forceinline__ constexpr uint32_t mn_step(int kq) {
  return (16 * kq * Layout<D>::kRowBytes) >> 4;
}

// Rows t0..t0 + R of (b, h)'s [T, D] slice into `dst`, completing on `bar`
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int t0, int h, int b) {
  using L = Layout<D>;
#pragma unroll
  for (int p = 0; p < L::kParts; ++p)
    tma_load_4d(dst + p * R * L::kRowBytes, map, bar, p * L::kAtom, h, t0, b);
}

// The A operand of a k-step from the accumulators of its 16 columns,
// rounded to bf16 (Bf16Ops::from_c)
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[N], int kq) {
  a[0] = pack_bf16(c[8 * kq + 0], c[8 * kq + 1]);
  a[1] = pack_bf16(c[8 * kq + 2], c[8 * kq + 3]);
  a[2] = pack_bf16(c[8 * kq + 4], c[8 * kq + 5]);
  a[3] = pack_bf16(c[8 * kq + 6], c[8 * kq + 7]);
}

// exp2 on the MUFU unit alone (ex2.approx.ftz, results below 2^-126
// flushed to 0), and the weight P = exp2(s' - m) / l of flash_bwd.cuh's
// `weight` through it: the route's three kernels use these and no other
// exp2, so P and delta keep the same bits in all three, and exp2(0) = 1
// exactly at a row's max.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float weight_ex2(float s, float scale_log2, float m, float inv_l) {
  return __fmul_rn(ex2(__fsub_rn(__fmul_rn(s, scale_log2), m)), inv_l);
}

// The block's shared memory from a 1024-byte aligned base (the swizzle
// atoms' alignment); the dynamic allocation adds 1 KB for it.
__device__ __forceinline__ uint32_t aligned_base(const unsigned char* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------- dK, dV

// A thread holds dK and dV (kN registers), S^T and dP^T (kBQ) and their
// bf16 A operands in flight (kBQ / 2) within 168 registers.  At D = 128 a
// block takes 64 keys and each warpgroup half of dK's and dV's columns
// (kSplit): both compute the keys' S^T and dP^T.
template <int D>
struct DkvTiles {
  static constexpr bool kSplit = D == 128;
  static constexpr int kKeys = kSplit ? kWgRows : kBlockRows;  // keys a block
  static constexpr int kN = kSplit ? D / 2 : D;                 // dK, dV columns a warpgroup
  static constexpr int kBQ = D == 32 ? 64 : 32;                 // queries a step
  static constexpr int kKV = kKeys * D * 2;         // the K or the V tile, bytes
  static constexpr int kStep = kBQ * D * 2;         // a step's Q or dO
  static constexpr int kStage = 2 * kStep + 1024;   // Q, dO, the 3 kBQ row statistics
  static constexpr int kBars = 2 * kKV + kStages * kStage;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(kStats * kBQ * 4 <= 1024, "row statistics of a step");
};

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
    const float* __restrict__ stats, const int* __restrict__ kv_lengths, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int Tq, int Tk, float sm_scale, Mask mask, Dropout drop) {
  using T = DkvTiles<D>;
  constexpr int kBQ = T::kBQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_tile = base, v_tile = base + T::kKV, ring = base + 2 * T::kKV;
  const uint32_t kv_full = base + T::kBars;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kStages + s); };
  auto q_of = [&](int s) { return ring + s * T::kStage; };  // dO at + kStep, statistics + 2 kStep

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * T::kKeys;
  // the warpgroup index through a shuffle, which ptxas sees uniform over
  // each warp
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // kConsumers: the loading warp
  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  // the queries that see the block's valid keys; a block whose keys are
  // all padding walks nothing and writes zeros
  int q_begin = Tq, q_end = Tq;
  if (k0 < n_valid) {
    q_begin = mask.queries_of(k0).x;
    q_end = min(Tq, mask.queries_of(min(k0 + T::kKeys, n_valid) - 1).y);
  }
  const int steps = q_begin < q_end ? (q_end - q_begin + kBQ - 1) / kBQ : 0;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread's and the 32 statistics lanes'
      mbar_init(empty(s), 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    if (steps > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::kKV);
        load_tile<D, T::kKeys>(k_tile, &mk, kv_full, k0, h, b);
        load_tile<D, T::kKeys>(v_tile, &mv, kv_full, k0, h, b);
      }
      const long long rows = (long long)gridDim.z * H * Tq;  // B H Tq
      const float* st_src = stats + ((long long)b * H + h) * Tq;
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages, q0 = q_begin + i * kBQ;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const uint32_t st_dst = q_of(s) + 2 * T::kStep;
        for (int idx = lane; idx < kStats * kBQ; idx += 32) {
          const int stat = idx / kBQ, qi = idx % kBQ;
          const bool ok = q0 + qi < Tq;
          cp_async4(st_dst + 4 * idx, st_src + stat * rows + (ok ? q0 + qi : 0), ok);
        }
        mbar_arrive_cp_async(full(s));
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * T::kStep);
          load_tile<D, kBQ>(q_of(s), &mq, full(s), q0, h, b);
          load_tile<D, kBQ>(q_of(s) + T::kStep, &mdo, full(s), q0, h, b);
        }
      }
    }
  } else {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const int krow = T::kSplit ? 0 : wg * kWgRows;  // the warpgroup's first key in the tile
    const int cols = T::kSplit ? wg * T::kN : 0;      // and its first column of dK, dV
    const int kwg = k0 + krow;
    const int kw = kwg + 16 * warp;     // the warp's
    const uint32_t bh = (uint32_t)(b * H + h);
    const float scale_log2 = sm_scale * kLog2e;
    // the lane's two key rows (g, g + 8): the queries [qlo, qhi) that see
    // them, none for a padded key
    int qlo[2], qhi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + g + 8 * r;
      const int2 qs = mask.queries_of(key);
      qlo[r] = qs.x;
      qhi[r] = key < n_valid ? min(qs.y, Tq) : 0;
    }
    // the queries the warpgroup's valid keys see: other steps hold no
    // pair it can see, and it skips their products
    int wq_begin = Tq, wq_end = Tq;
    if (kwg < n_valid) {
      wq_begin = mask.queries_of(kwg).x;
      wq_end = min(Tq, mask.queries_of(min(kwg + kWgRows, n_valid) - 1).y);
    }

    float dka[T::kN / 2], dva[T::kN / 2];
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) dka[i] = dva[i] = 0.f;
    if (steps > 0) {
      mbar_wait(kv_full, 0);
      const uint64_t kd = desc_k<D>(k_tile + krow * Layout<D>::kRowBytes);
      const uint64_t vd = desc_k<D>(v_tile + krow * Layout<D>::kRowBytes);
      uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];  // A operands of the products in flight
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages, q0 = q_begin + i * kBQ;
        const bool live = q0 < wq_end && q0 + kBQ > wq_begin;  // warpgroup-uniform
        const uint32_t qt = q_of(s), dot = qt + T::kStep;
        mbar_wait(full(s), (i / kStages) & 1);
        float st[kBQ / 2], dpt[kBQ / 2];
        if (live) {
          const uint64_t qd = desc_k<D>(qt), dod = desc_k<D>(dot);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<kBQ>::ss(st, kd + k_step<D, T::kKeys>(kk), qd + k_step<D, kBQ>(kk), kk);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<kBQ>::ss(dpt, vd + k_step<D, T::kKeys>(kk), dod + k_step<D, kBQ>(kk), kk);
          wgmma_commit();
        }
        // the previous step's dV and dK products are done with this
        // step's S^T and dP^T: release the previous step's stage
        wgmma_wait<0>();
        if (i > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty((i - 1) % kStages));
        }
        if (!live) continue;
        fence_regs(st);
        fence_regs(dpt);
        // S^T -> (P o D)^T and dP^T -> dS^T (row = key, column = query),
        // P and delta the statistics pass's bits (`weight_ex2`,
        // `grad_entry`); the masks' compares only where the step is not
        // wholly visible to the lane's two keys
        const float* sm = reinterpret_cast<const float*>(smem + (qt - base) + 2 * T::kStep);
        auto grads = [&](auto masked) {
#pragma unroll
          for (int e = 0; e < kBQ / 2; ++e) {
            const int r = (e >> 1) & 1, qi = 8 * (e >> 2) + t2 + (e & 1), qp = q0 + qi;
            const bool ok = !decltype(masked)::value || (qp >= qlo[r] && qp < qhi[r]);
            const bool kp = !kDropout || dropout_keep(drop.seed, bh, (uint32_t)qp,
                                                      (uint32_t)(kw + g + 8 * r), drop.thresh);
            const float w = weight_ex2(st[e], scale_log2, sm[qi], sm[kBQ + qi]);
            const float dpd = kDropout ? (kp ? __fmul_rn(dpt[e], drop.scale) : 0.f) : dpt[e];
            const float ds = grad_entry(w, dpd, sm[2 * kBQ + qi], sm_scale);
            dpt[e] = ok ? ds : 0.f;
            st[e] = ok && kp ? (kDropout ? w * drop.scale : w) : 0.f;
          }
        };
        if (q0 >= max(qlo[0], qlo[1]) && q0 + kBQ <= min(qhi[0], qhi[1]))
          grads(std::false_type{});
        else
          grads(std::true_type{});
#pragma unroll
        for (int kq = 0; kq < kBQ / 16; ++kq) {
          to_a(pa[kq], st, kq);
          to_a(sa[kq], dpt, kq);
        }
        // dV += (P o D)^T dO, dK += dS^T Q over the warpgroup's columns (a
        // column block of a D = 128 tile is laid out as a D = 64 tile)
        const uint64_t dom = desc_mn<T::kN, kBQ>(dot + cols * kBQ * 2);
        const uint64_t qm = desc_mn<T::kN, kBQ>(qt + cols * kBQ * 2);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < kBQ / 16; ++kq)
          Wgmma<T::kN>::rs(dva, pa[kq], dom + mn_step<T::kN>(kq));
#pragma unroll
        for (int kq = 0; kq < kBQ / 16; ++kq)
          Wgmma<T::kN>::rs(dka, sa[kq], qm + mn_step<T::kN>(kq));
        wgmma_commit();
      }
      wgmma_wait<0>();
    }
    fence_regs(dka);
    fence_regs(dva);
    // the warp's rows, 4 bytes a store; padded keys write zeros
    const long long ts = (long long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + g + 8 * r;
      if (key >= Tk) continue;
      const long long at = ((long long)b * Tk + key) * ts + (long long)h * D + cols + t2;
#pragma unroll
      for (int j = 0; j < T::kN / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
            pack_bf16(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------ dQ, statistics

template <int D>
struct QueryTiles {
  // keys a step: dQ (D / 2 registers a thread), S and dP (kKeyStep) and
  // dS's bf16 A operand within 168
  static constexpr int kKeyStep = D == 128 ? 32 : 64;
  static constexpr int kQO = kBlockRows * D * 2;  // the Q or the dO tile, bytes
  static constexpr int kStep = kKeyStep * D * 2;  // a step's K or V
  static constexpr int kStage = 2 * kStep;
  static constexpr int kBars = 2 * kQO + kStages * kStage;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

// The walk over the keys of a 128-query block: the statistics pass
// (kStatsPass: m, 1 / l, delta into stats) or dQ (from stats).
template <int D, bool kDropout, bool kStatsPass>
__device__ __forceinline__ void query_walk(const CUtensorMap* mq, const CUtensorMap* mk,
                                           const CUtensorMap* mv, const CUtensorMap* mdo,
                                           float* __restrict__ stats,
                                           const int* __restrict__ kv_lengths,
                                           bf16* __restrict__ dq, int H, int Tq, int Tk,
                                           float sm_scale, Mask mask, Dropout drop) {
  using T = QueryTiles<D>;
  constexpr int kKeyStep = T::kKeyStep;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t q_tile = base, do_tile = base + T::kQO, ring = base + 2 * T::kQO;
  const uint32_t qd_full = base + T::kBars;
  auto full = [&](int s) { return qd_full + 8 * (1 + s); };
  auto empty = [&](int s) { return qd_full + 8 * (1 + kStages + s); };
  auto k_of = [&](int s) { return ring + s * T::kStage; };  // V at + kStep

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  // the warpgroup index through a shuffle, which ptxas sees uniform over
  // each warp
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // kConsumers: the loading warp
  int n_valid = Tk;
  if (kv_lengths != nullptr) n_valid = min(max(kv_lengths[b], 0), Tk);
  // the keys the block's rows see
  const int k_begin = mask.keys_of(q0).x;
  const int k_end = min(n_valid, mask.keys_of(min(q0 + kBlockRows, Tq) - 1).y);
  const int steps = k_begin < k_end ? (k_end - k_begin + kKeyStep - 1) / kKeyStep : 0;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    if (lane == 0 && steps > 0) {
      mbar_expect_tx(qd_full, 2 * T::kQO);
      load_tile<D, kBlockRows>(q_tile, mq, qd_full, q0, h, b);
      load_tile<D, kBlockRows>(do_tile, mdo, qd_full, q0, h, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages, k0 = k_begin + i * kKeyStep;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), T::kStage);
        load_tile<D, kKeyStep>(k_of(s), mk, full(s), k0, h, b);
        load_tile<D, kKeyStep>(k_of(s) + T::kStep, mv, full(s), k0, h, b);
      }
    }
  } else {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const int qwg = q0 + wg * kWgRows;  // the warpgroup's first query
    const uint32_t bh = (uint32_t)(b * H + h);
    const float scale_log2 = sm_scale * kLog2e;
    const long long rows = (long long)gridDim.z * H * Tq;  // B H Tq
    // the keys the warpgroup's rows see: other steps hold no pair it can
    // see, and it skips their products
    const bool wg_live = qwg < Tq;
    const int wk_begin = mask.keys_of(qwg).x;
    const int wk_end = wg_live ? min(n_valid, mask.keys_of(min(qwg + kWgRows, Tq) - 1).y) : 0;

    // the lane's two rows (g, g + 8): position, visible keys [klo, khi)
    int qrow[2], klo[2], khi[2];
    // statistics pass: running max (log2 units) and the lane's parts of l
    // and a = sum exp2(s' - m) dP o D; dQ: m, 1 / l and delta
    float m[2], l[2], acc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qrow[r] = qwg + 16 * warp + g + 8 * r;
      const int2 ks = mask.keys_of(qrow[r]);
      klo[r] = ks.x;
      khi[r] = qrow[r] < Tq ? min(ks.y, n_valid) : 0;
      if (kStatsPass) {
        m[r] = kNegInf;
        l[r] = acc[r] = 0.f;
      } else {
        const long long at = ((long long)b * H + h) * Tq + min(qrow[r], Tq - 1);
        m[r] = qrow[r] < Tq ? stats[at] : 0.f;
        l[r] = qrow[r] < Tq ? stats[rows + at] : 0.f;  // 1 / l
        acc[r] = qrow[r] < Tq ? stats[2 * rows + at] : 0.f;  // delta
      }
    }

    float dqa[D / 2];  // dQ (the statistics pass never reaches its products)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    if (steps > 0) {
      mbar_wait(qd_full, 0);
      const uint64_t qd = desc_k<D>(q_tile + wg * kWgRows * Layout<D>::kRowBytes);
      const uint64_t dod = desc_k<D>(do_tile + wg * kWgRows * Layout<D>::kRowBytes);
      uint32_t sa[kKeyStep / 16][4];  // dS, the A operand of the product in flight
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages, k0 = k_begin + i * kKeyStep;
        const bool live = wg_live && k0 < wk_end && k0 + kKeyStep > wk_begin;
        const uint32_t kt = k_of(s), vt = kt + T::kStep;
        mbar_wait(full(s), (i / kStages) & 1);
        float sc[kKeyStep / 2], dp[kKeyStep / 2];
        if (live) {
          const uint64_t kd = desc_k<D>(kt), vd = desc_k<D>(vt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<kKeyStep>::ss(sc, qd + k_step<D, kBlockRows>(kk),
                                kd + k_step<D, kKeyStep>(kk), kk);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<kKeyStep>::ss(dp, dod + k_step<D, kBlockRows>(kk),
                                vd + k_step<D, kKeyStep>(kk), kk);
          wgmma_commit();
        }
        if (kStatsPass) {
          wgmma_wait<0>();
          if (live) {
            fence_regs(sc);
            fence_regs(dp);
            // sc <- s' = S scale log2(e), kNegInf where masked; the step's
            // row max; then FA2's online update (as in the mma.sync kernel,
            // with `ex2`), the masks' compares only where the step is not
            // wholly visible to the lane's two rows
            auto online = [&](auto masked) {
              float mt[2] = {kNegInf, kNegInf};
#pragma unroll
              for (int e = 0; e < kKeyStep / 2; ++e) {
                const int r = (e >> 1) & 1, key = k0 + 8 * (e >> 2) + t2 + (e & 1);
                const bool ok = !decltype(masked)::value || (key >= klo[r] && key < khi[r]);
                sc[e] = ok ? __fmul_rn(sc[e], scale_log2) : kNegInf;
                mt[r] = fmaxf(mt[r], sc[e]);
              }
              // the row max over the quad, the new running max and the
              // rescale of what came before: exp2(0) = 1 while m holds, 0
              // from a first valid key (kNegInf - m underflows)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
                mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
                const float m_new = fmaxf(m[r], mt[r]);
                const float alpha = ex2(__fsub_rn(m[r], m_new));
                m[r] = m_new;
                l[r] = __fmul_rn(l[r], alpha);
                acc[r] = __fmul_rn(acc[r], alpha);
              }
#pragma unroll
              for (int e = 0; e < kKeyStep / 2; ++e) {
                const int r = (e >> 1) & 1;
                // a masked entry adds 0 (kNegInf - m = 0 on a row with no
                // valid key yet, hence the select)
                const float p =
                    !decltype(masked)::value || sc[e] > 0.5f * kNegInf
                        ? ex2(__fsub_rn(sc[e], m[r]))
                        : 0.f;
                const int key = k0 + 8 * (e >> 2) + t2 + (e & 1);
                const bool kp = !kDropout || dropout_keep(drop.seed, bh, (uint32_t)qrow[r],
                                                          (uint32_t)key, drop.thresh);
                const float dpd = kDropout ? (kp ? __fmul_rn(dp[e], drop.scale) : 0.f) : dp[e];
                l[r] = __fadd_rn(l[r], p);
                acc[r] = __fmaf_rn(p, dpd, acc[r]);
              }
            };
            if (k0 >= max(klo[0], klo[1]) && k0 + kKeyStep <= min(khi[0], khi[1]))
              online(std::false_type{});
            else
              online(std::true_type{});
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(s));
          continue;
        }
        // dQ: the previous step's product is done with this step's S and
        // dP: release the previous step's stage
        wgmma_wait<0>();
        if (i > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty((i - 1) % kStages));
        }
        if (!live) continue;
        fence_regs(sc);
        fence_regs(dp);
        // sc <- dS (row = query, column = key), the masks' compares only
        // where the step is not wholly visible to the lane's two rows
        auto grads = [&](auto masked) {
#pragma unroll
          for (int e = 0; e < kKeyStep / 2; ++e) {
            const int r = (e >> 1) & 1, key = k0 + 8 * (e >> 2) + t2 + (e & 1);
            const bool ok = !decltype(masked)::value || (key >= klo[r] && key < khi[r]);
            const bool kp = !kDropout || dropout_keep(drop.seed, bh, (uint32_t)qrow[r],
                                                      (uint32_t)key, drop.thresh);
            const float w = weight_ex2(sc[e], scale_log2, m[r], l[r]);
            const float dpd = kDropout ? (kp ? __fmul_rn(dp[e], drop.scale) : 0.f) : dp[e];
            const float ds = grad_entry(w, dpd, acc[r], sm_scale);
            sc[e] = ok ? ds : 0.f;
          }
        };
        if (k0 >= max(klo[0], klo[1]) && k0 + kKeyStep <= min(khi[0], khi[1]))
          grads(std::false_type{});
        else
          grads(std::true_type{});
#pragma unroll
        for (int kq = 0; kq < kKeyStep / 16; ++kq) to_a(sa[kq], sc, kq);
        // dQ += dS K
        const uint64_t km = desc_mn<D, kKeyStep>(kt);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < kKeyStep / 16; ++kq)
          Wgmma<D>::rs(dqa, sa[kq], km + mn_step<D>(kq));
        wgmma_commit();
      }
      if (!kStatsPass) wgmma_wait<0>();
    }

    if (kStatsPass) {
      // l and a over the quad (the same bits in each lane), then m, 1 / l
      // and delta = a / l; a row with no valid key writes 0, 0, 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
        l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
        acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], 1));
        acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], 2));
      }
      if ((lane & 3) == 0) {
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
    } else {
      fence_regs(dqa);
      const long long ts = (long long)H * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qrow[r] >= Tq) continue;
        const long long at = ((long long)b * Tq + qrow[r]) * ts + (long long)h * D + t2;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dq + at + 8 * j) =
              pack_bf16(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
      }
    }
  }
}

#define OPENASR_WALK_PARAMS                                                              \
  const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,        \
      const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,   \
      float *__restrict__ stats, const int *__restrict__ kv_lengths, bf16 *__restrict__ dq, \
      int H, int Tq, int Tk, float sm_scale, Mask mask, Dropout drop
#define OPENASR_WALK_ARGS \
  &mq, &mk, &mv, &mdo, stats, kv_lengths, dq, H, Tq, Tk, sm_scale, mask, drop

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_stats_wgmma_kernel(OPENASR_WALK_PARAMS) {
  query_walk<D, kDropout, true>(OPENASR_WALK_ARGS);
}
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_wgmma_kernel(OPENASR_WALK_PARAMS) {
  query_walk<D, kDropout, false>(OPENASR_WALK_ARGS);
}

#undef OPENASR_WALK_PARAMS
#undef OPENASR_WALK_ARGS

// ---------------------------------------------------------------- launch

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda call, through the CUDA runtime's
// entry-point query (no link against libcuda); null where libcuda lacks it
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (D, H, T, B) of a [B, T, H, D] bf16 view (strides in
// elements, 16-byte multiples: the wrapper checks them), boxes of
// Layout<D>::kAtom columns x `rows` rows; a dimension of size 1, never
// stepped, gets its packed stride.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int T, int H, int D, Strides st,
                   int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const int atom = D < 64 ? D : 64;
  const cuuint64_t hs = H > 1 ? 2ull * st.h : 2ull * D;
  const cuuint64_t ts = T > 1 ? 2ull * st.t : hs * H;
  const cuuint64_t bs = B > 1 ? 2ull * st.b : ts * T;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {hs, ts, bs};
  const cuuint32_t box[4] = {(cuuint32_t)atom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q, k, v, dout maps with `q_rows` rows a box for q and dout, `k_rows` for
// k and v
template <int D>
cudaError_t encode_all(CUtensorMap (&maps)[4], const BwdArgs& a, int q_rows, int k_rows) {
  cudaError_t err;
  if ((err = encode(&maps[0], a.q, a.B, a.Tq, a.H, D, a.qs, q_rows)) != cudaSuccess) return err;
  if ((err = encode(&maps[1], a.k, a.B, a.Tk, a.H, D, a.ks, k_rows)) != cudaSuccess) return err;
  if ((err = encode(&maps[2], a.v, a.B, a.Tk, a.H, D, a.vs, k_rows)) != cudaSuccess) return err;
  return encode(&maps[3], a.dout, a.B, a.Tq, a.H, D, a.ds, q_rows);
}

template <int D, bool kDropout>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  using T = DkvTiles<D>;
  CUtensorMap maps[4];
  cudaError_t err = encode_all<D>(maps, a, T::kBQ, T::kKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_attention_bwd_dkv_wgmma_kernel<D, kDropout>;
  static int asked[kMaxDevices];
  if ((err = allow_smem(kernel, T::kSmem, a.device, asked)) != cudaSuccess) return err;
  const dim3 grid((a.Tk + T::kKeys - 1) / T::kKeys, a.H, a.B);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.stats, a.kv_lengths, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.H, a.Tq, a.Tk, a.sm_scale, a.mask, a.drop);
  return cudaGetLastError();
}

template <int D, bool kDropout, bool kStatsPass>
cudaError_t launch_walk(const BwdArgs& a, cudaStream_t stream) {
  using T = QueryTiles<D>;
  CUtensorMap maps[4];
  cudaError_t err = encode_all<D>(maps, a, kBlockRows, T::kKeyStep);
  if (err != cudaSuccess) return err;
  auto kernel = kStatsPass ? flash_attention_bwd_stats_wgmma_kernel<D, kDropout>
                           : flash_attention_bwd_dq_wgmma_kernel<D, kDropout>;
  static int asked[kMaxDevices];
  if ((err = allow_smem(kernel, T::kSmem, a.device, asked)) != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBlockRows - 1) / kBlockRows, a.H, a.B);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], a.stats,
                                                a.kv_lengths, static_cast<bf16*>(a.dq), a.H,
                                                a.Tq, a.Tk, a.sm_scale, a.mask, a.drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_one(int which, const BwdArgs& a, cudaStream_t stream) {
  const bool drop = a.drop.on;
  if (which == 0) return drop ? launch_dkv<D, true>(a, stream) : launch_dkv<D, false>(a, stream);
  if (which == 1)
    return drop ? launch_walk<D, true, false>(a, stream) : launch_walk<D, false, false>(a, stream);
  return drop ? launch_walk<D, true, true>(a, stream) : launch_walk<D, false, true>(a, stream);
}

}  // namespace

cudaError_t launch_bwd_wgmma(int which, int D, const BwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_one<32>(which, a, stream);
    case 64:
      return launch_one<64>(which, a, stream);
    case 128:
      return launch_one<128>(which, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace openasr
