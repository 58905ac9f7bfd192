// Tiles and operands shared by the flash-attention kernels on the tensor
// cores (flash_attention.cu, flash_attention_bwd.cu): the two operand
// types, one per element type, with their fragment loads from staged rows;
// the 16-byte cp.async staging of [T, D] rows into shared memory and the
// 16-byte stores back out; and the shared-memory opt-in above 48 KB.
//
// - bf16 (Bf16Ops): mma.m16n8k16 from ldmatrix / ldmatrix.trans.  An
//   accumulator fragment becomes an A fragment rounded to bf16, where JAX
//   casts the weights before their second product.
// - f32 (Tf32x3Ops): mma.m16n8k8 in TF32 with the 3xTF32 split (x = hi +
//   lo, acc += lo.hi + hi.lo + hi.hi), which keeps f32's precision.
//   ldmatrix serves 16-bit elements only, so fragments come from ld.shared.
//   Within each k-step the k index is permuted (mma slot t <-> column 2t,
//   slot t + 4 <-> column 2t + 1) in A and B alike, which leaves the
//   products unchanged and makes an accumulator fragment an A fragment as
//   it stands.
// Staged rows are padded by 8 elements, which puts the 8 row addresses of
// one bf16 ldmatrix, and the lanes of one f32 float2 load, in distinct
// banks.  cp.async needs 16-byte aligned rows: the Python wrappers check it.
#pragma once

#include <cuda_runtime.h>

#include "mma.cuh"

namespace openasr {

// (batch, time, head) strides of a [B, T, H, D] view, in elements
struct Strides {
  long long b, t, h;
};

// The structured mask of one launch, beside the key padding: causal (key k
// visible to query q iff k <= q) and the chunk mode of streaming encoders
// (chunk > 0; openasr_tpu/ops/masks.py:chunk_bias): q and k lie in chunks
// qc = (q + phase) / chunk and kc = (k + phase) / chunk, and k is visible
// iff qc - left <= kc <= qc (every earlier chunk when left < 0).  Either
// way the keys a query sees form one interval, and so do the queries that
// see a key, and both intervals only move right as q or k grows: so the
// masks are two compares an element, and a tile of rows sees the union of
// its first and last row's intervals, which the kernels walk and nothing
// else.  Positions are never negative, so the divisions round down.
struct Mask {
  int causal, chunk, left, phase;

  // keys [lo, hi) that query q sees, before the key padding
  __device__ __forceinline__ int2 keys_of(int q) const {
    int lo = 0, hi = 0x7fffffff;
    if (causal) hi = q + 1;
    if (chunk > 0) {
      const int c = (q + phase) / chunk;
      hi = min(hi, (c + 1) * chunk - phase);
      if (left >= 0) lo = max(0, (c - left) * chunk - phase);
    }
    return make_int2(lo, hi);
  }
  // queries [lo, hi) that see key k, before the end of the queries
  __device__ __forceinline__ int2 queries_of(int k) const {
    int lo = causal ? k : 0, hi = 0x7fffffff;
    if (chunk > 0) {
      const int c = (k + phase) / chunk;
      lo = max(lo, c * chunk - phase);
      if (left >= 0) hi = (c + left + 1) * chunk - phase;
    }
    return make_int2(max(lo, 0), hi);
  }
};

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
  // one mma: the same bits with the operands' roles swapped
  static __device__ __forceinline__ void mma_sym(float (&d)[4], const A& a, const B& b) {
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
  // The same product, the same bits with the operands' roles swapped: the
  // two cross products are summed on their own before they join d.  The
  // backward kernels compute S and dP as A B in one kernel and as B^T A^T
  // in the other and need them equal.
  static __device__ __forceinline__ void mma_sym(float (&d)[4], const A& a, const B& b) {
    float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c1, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(c2, a.hi, b.lo[0], b.lo[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += __fadd_rn(c1[e], c2[e]);
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

// ---------------------------------------------------------------- launch

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

}  // namespace openasr
