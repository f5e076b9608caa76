// Device building blocks shared by the two EGNN kernels
// (egnn_msgpass.cu, egnn_fused.cu).
//
// Numerics: every value that the JAX kernels hold in the compute dtype T is
// held here in T (in shared memory) or as a float rounded to T
// (Cvt<T>::rnd) at the same points, and every matrix product accumulates in
// float. With T = float the rounding is the identity. The plain PyTorch
// versions beside each wrapper (ops/egnn_msgpass.py, ops/egnn_fused.py)
// round at the same points.
//
// Products: block_gemm runs bf16 products on the tensor cores (WMMA
// 16x16x16, float accumulators, weights staged through shared memory by
// cp.async) and float products as plain FMAs, the weights also staged
// through shared memory by cp.async (the float path must stay exact float,
// which the tensor cores' TF32 is not).
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "egnn_plan.h"

namespace egnn {

constexpr int kTM = 8;         // float path: output rows per thread per pass
constexpr int kTN = 4;         // float path: output columns per thread
// bf16 path: 16x16 output tiles per warp per pass, 64 per block
constexpr int kMaxTiles = 64 / kWarps;
using bf16 = __nv_bfloat16;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};

template <>
struct Cvt<bf16> {
  static __device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ bf16 from_f(float v) {
    return __float2bfloat16(v);  // round to nearest even, as astype
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Row padding of T operands in shared memory (egnn_plan.h: row_pad).
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return row_pad(std::is_same<T, bf16>::value);
}

// SiLU written as v / (1 + exp(-v)) with each step rounded to T, as the JAX
// kernels' _silu computes it in the compute dtype.
template <typename T>
__device__ __forceinline__ float silu_c(float v) {
  const float e = Cvt<T>::rnd(expf(-v));
  const float d = Cvt<T>::rnd(1.0f + e);
  return Cvt<T>::rnd(v / d);
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- float products: plain FMAs, a kTM x kTN register tile per thread.
// W reaches shared memory in chunks of rows by cp.async, the next chunk
// loading while the current one multiplies, so the FMA loop reads it from there instead of waiting on L2.

// (the ring's chunks: egnn_plan.h, kF32Stages, f32_chunk_rows; the widths
// each instantiation takes: egnn_plan.h, ragged_width)

// Copies rows [r0, r1) of a weight matrix W [hw, hw] (global, row-major,
// row stride hw) into dst (row stride ldd, row r0 first), columns [0, hp):
// rows and columns past hw read as zero (hw <= hp). Where hw == hp and a row
// is a whole number of 16-byte vectors the copies are 16-byte cp.async,
// which the caller commits and waits for; else (a width that is not a
// multiple of the tile, the ragged case) plain loads and stores, which the
// caller's barrier before the reads makes visible. Every thread of the
// block takes part.
template <typename T>
__device__ __forceinline__ void copy_weight_rows(T* dst, int ldd, const T* W, int hw, int hp,
                                                 int r0, int r1) {
  constexpr int kVec = 16 / sizeof(T);
  if (hw == hp && hw % kVec == 0) {
    if (ldd == hw) {  // the rows lie contiguous in both
      const int n = (r1 - r0) * hw;
      const T* src = W + (size_t)r0 * hw;
      for (int o = threadIdx.x * kVec; o < n; o += kThreads * kVec)
        __pipeline_memcpy_async(dst + o, src + o, 16);
      return;
    }
    const int per_row = hw / kVec;
    const int n = (r1 - r0) * per_row;
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const int r = p / per_row, q = (p % per_row) * kVec;
      __pipeline_memcpy_async(dst + (size_t)r * ldd + q, W + (size_t)(r0 + r) * hw + q, 16);
    }
    return;
  }
  const int n = (r1 - r0) * hp;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int r = p / hp, c = p % hp;
    const int g = r0 + r;
    dst[(size_t)r * ldd + c] = g < hw && c < hw ? W[(size_t)g * hw + c] : Cvt<T>::from_f(0.0f);
  }
}

// Adds A[m, k0:k1] . W[k0:k1, n0..n0+3] into acc for the TM rows this
// thread owns (arow[i]: its rows of A, float in shared memory). W points at
// row k0, row stride ldw; k0, k1 are multiples of 4.
template <int TM>
__device__ __forceinline__ void accumulate_f32(float (&acc)[TM][kTN], const float* const (&arow)[TM],
                                               const float* W, int ldw, int k0, int k1, int n0) {
  for (int k = k0; k < k1; k += 4) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(arow[i] + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (size_t)(k - k0 + kk) * ldw + n0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i][kk], w.x, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], w.y, acc[i][1]);
        acc[i][2] = fmaf(a[i][kk], w.z, acc[i][2]);
        acc[i][3] = fmaf(a[i][kk], w.w, acc[i][3]);
      }
    }
  }
}

// A pass covers rg_count * TM rows; W1's chunks, then W2's, stream through
// the ring (`ring`: kF32Stages * f32_chunk_rows(H) * H floats), each waited
// for and made visible by one barrier, after which the slot of the chunk
// before it is refilled. The sums run in k order, W1 then W2. Where H / kTN
// column groups do not divide the block, the threads past rg_count whole
// row groups only help with the copies.
template <int TM, bool kRagged, typename Epi>
__device__ void gemm_f32(const float* A1, int lda1, const float* W1,
                         const float* A2, int lda2, const float* W2, int M,
                         int H, int Hw, Epi& epi, float* ring) {
  const int cg_count = H / kTN;
  const int rg_count = kThreads / cg_count;
  const int cg = threadIdx.x % cg_count;
  const int rg = threadIdx.x / cg_count;
  const bool active = !kRagged || rg < rg_count;
  const int n0 = cg * kTN;
  const int rows_per_pass = rg_count * TM;
  const int kr = f32_chunk_rows(H);
  const int per_op = kRagged ? (H + kr - 1) / kr : H / kr;
  const int nq = (A2 != nullptr ? 2 : 1) * per_op;
  auto issue = [&](int q) {
    if (q < nq) {
      if constexpr (kRagged) {
        const int k0 = (q % per_op) * kr;
        copy_weight_rows(ring + (size_t)(q % kF32Stages) * kr * H, H, q < per_op ? W1 : W2, Hw,
                         H, k0, min(H, k0 + kr));
      } else {
        const float* src = (q < per_op ? W1 : W2) + (size_t)(q % per_op) * kr * H;
        float* dst = ring + (size_t)(q % kF32Stages) * kr * H;
        for (int o = threadIdx.x * 4; o < kr * H; o += kThreads * 4)
          __pipeline_memcpy_async(dst + o, src + o, 16);
      }
    }
    __pipeline_commit();
  };
  for (int base = 0; base < M; base += rows_per_pass) {
    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    const float* arow1[TM];
    const float* arow2[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = min(base + rg + i * rg_count, M - 1);
      arow1[i] = A1 + (size_t)m * lda1;
      arow2[i] = A2 + (size_t)m * lda2;
    }
    for (int q = 0; q < kF32Stages - 1; ++q) issue(q);
    for (int q = 0; q < nq; ++q) {
      __pipeline_wait_prior(kF32Stages - 2);  // chunk q is here
      __syncthreads();  // ... for every thread; every warp is done with chunk q - 1
      issue(q + kF32Stages - 1);
      const int k0 = (q % per_op) * kr;
      accumulate_f32<TM>(acc, q < per_op ? arow1 : arow2,
                         ring + (size_t)(q % kF32Stages) * kr * H, H, k0,
                         kRagged ? min(H, k0 + kr) : k0 + kr, n0);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = base + rg + i * rg_count;
      if (m < M && active) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) epi(m, n0 + j, acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// ---- bf16 products: WMMA 16x16x16 on the tensor cores, float accumulators.
// Each pass covers rt row tiles x (H/16) column tiles, at most kMaxTiles per
// warp. The weights stream through two shared-memory slabs of kSlabK rows
// (`wslab`, 2 * kSlabK * (H + 8) bf16, rows padded as row_pad): every
// thread issues 16-byte cp.async
// copies for slab s+1 while the warps multiply slab s, so a pass waits on
// one load latency per slab instead of one per fragment. A warp stages each
// finished tile through its 16x16 float slice of `stage` to hand the
// epilogue one element at a time.
template <bool kRagged, typename Epi>
__device__ void gemm_bf16(const bf16* A1, int lda1, const bf16* W1,
                          const bf16* A2, int lda2, const bf16* W2, int M,
                          int H, int Hw, Epi& epi, float* stage, bf16* wslab) {
  namespace wmma = nvcuda::wmma;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = H / 16;
  const int rt = max(1, min(4, kWarps * kMaxTiles / nt));
  const int per_operand = H / kSlabK;
  const int nslab = (A2 != nullptr ? 2 : 1) * per_operand;
  const int lds = H + row_pad<bf16>();
  float* st = stage + warp * 256;

  auto issue = [&](int s) {
    bf16* dst = wslab + (s & 1) * kSlabK * lds;
    if constexpr (kRagged) {
      const int k0 = (s % per_operand) * kSlabK;
      copy_weight_rows(dst, lds, s < per_operand ? W1 : W2, Hw, H, k0, k0 + kSlabK);
    } else {
      const int slab_elems = kSlabK * H;
      const bf16* src = (s < per_operand ? W1 : W2) + (size_t)(s % per_operand) * slab_elems;
      for (int o = threadIdx.x * 8; o < slab_elems; o += kThreads * 8)
        __pipeline_memcpy_async(dst + (o / H) * lds + o % H, src + o, 16);
    }
    __pipeline_commit();
  };

  for (int base = 0; base < M; base += rt * 16) {
    const int tiles = min(rt, (M - base + 15) / 16) * nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxTiles];
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) wmma::fill_fragment(acc[i], 0.0f);
    issue(0);
    for (int s = 0; s < nslab; ++s) {
      if (s + 1 < nslab) {
        issue(s + 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const bf16* slab = wslab + (s & 1) * kSlabK * lds;
      const bf16* A = s < per_operand ? A1 : A2;
      const int lda = s < per_operand ? lda1 : lda2;
      const int k0 = (s % per_operand) * kSlabK;
#pragma unroll
      for (int kk = 0; kk < kSlabK; kk += 16) {
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          const int t = warp + kWarps * i;
          if (t < tiles) {
            const int r = t / nt, c = t % nt;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, A + (size_t)(base + r * 16) * lda + k0 + kk, lda);
            wmma::load_matrix_sync(fb, slab + kk * lds + c * 16, lds);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
      __syncthreads();  // slab (s & 1) is free for issue(s + 2)
    }
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int t = warp + kWarps * i;
      if (t < tiles) {
        const int r = t / nt, c = t % nt;
        wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int m = base + r * 16 + e / 16;
          if (m < M) epi(m, c * 16 + e % 16, st[e]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// Block-wide C = A1 @ W1 (+ A2 @ W2) for M rows and H output columns,
// accumulated in float. A operands are T in shared memory (row stride lda,
// H columns: any past Hw must hold finite values, zeros in the kernels);
// W operands are T in global memory, row-major [Hw, Hw] (Hw <= H; rows and
// columns past Hw read as zero: copy_weight_rows). epi(m, n, acc)
// receives each output once, after a block barrier that follows every read
// of the pass's A rows, so it may overwrite row m of A1 in place; a barrier
// also follows the last write. All threads must call this with the same M.
// The bf16 path reads A in whole 16-row tiles: the rows up to the next
// multiple of 16 must lie inside the allocation (egnn_plan.h: alloc_rows;
// their values are ignored).
// Requires, for float, H % 4 == 0 and H <= 2048; for bf16, H % 16 == 0 and
// H <= 1024 (at most kMaxTiles tiles a warp); with kRagged = false, also
// Hw == H and, for float, H a power of two (ragged_width). GemmSmem holds
// the products' shared memory (egnn_plan.h: gemm_smem_bytes). Both paths commit cp.async groups of their
// own: the caller's older groups are complete once it returns.
struct GemmSmem {
  float* stage;  // bf16: kWarps * 256 floats
  bf16* wslab;   // bf16: 2 * kSlabK * (H + 8) bf16
  float* ring;   // float: the W ring of gemm_f32
};

template <typename T, bool kRagged, typename Epi>
__device__ void block_gemm(const T* A1, int lda1, const T* W1, const T* A2,
                           int lda2, const T* W2, int M, int H, int Hw,
                           const GemmSmem& gs, Epi epi) {
  if constexpr (std::is_same<T, float>::value && kRagged) {
    // one register tile for every M: widths that are not a power of two
    // are not tuned, and each variant would be compiled at every call site
    gemm_f32<kTM, true>(A1, lda1, W1, A2, lda2, W2, M, H, Hw, epi, gs.ring);
  } else if constexpr (std::is_same<T, float>::value) {
    const int rg_count = kThreads / (H / kTN);
    if (M <= rg_count)
      gemm_f32<1, false>(A1, lda1, W1, A2, lda2, W2, M, H, Hw, epi, gs.ring);
    else if (M <= 2 * rg_count)
      gemm_f32<2, false>(A1, lda1, W1, A2, lda2, W2, M, H, Hw, epi, gs.ring);
    else if (M <= 4 * rg_count)
      gemm_f32<4, false>(A1, lda1, W1, A2, lda2, W2, M, H, Hw, epi, gs.ring);
    else
      gemm_f32<kTM, false>(A1, lda1, W1, A2, lda2, W2, M, H, Hw, epi, gs.ring);
  } else {
    gemm_bf16<kRagged>(A1, lda1, W1, A2, lda2, W2, M, H, Hw, epi, gs.stage, gs.wslab);
  }
}

// The same with W1, W2 [H, H].
template <typename T, bool kRagged, typename Epi>
__device__ void block_gemm(const T* A1, int lda1, const T* W1, const T* A2,
                           int lda2, const T* W2, int M, int H,
                           const GemmSmem& gs, Epi epi) {
  block_gemm<T, kRagged>(A1, lda1, W1, A2, lda2, W2, M, H, H, gs, epi);
}

}  // namespace egnn
