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
// cp.async) and float products as plain FMAs reading weights from global
// memory (the float path must stay exact float, which the tensor cores'
// TF32 is not).
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace egnn {

// threads per block; a kernel's source may set EGNN_THREADS before
// including this header
#ifndef EGNN_THREADS
#define EGNN_THREADS 256
#endif
constexpr int kThreads = EGNN_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;         // float path: output rows per thread per pass
constexpr int kTN = 4;         // float path: output columns per thread
// bf16 path: 16x16 output tiles per warp per pass, 64 per block
constexpr int kMaxTiles = 64 / kWarps;
constexpr int kSlabK = 16;     // bf16 path: weight rows per shared-memory slab
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
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

// Row padding, in elements, of bf16 operands in shared memory. +8 shifts
// consecutive rows by 4 banks, so a WMMA fragment load (8 rows of 16 bytes
// per phase) touches 32 distinct banks instead of 4.
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return std::is_same<T, float>::value ? 0 : 8;
}

// Four consecutive values (16-byte aligned for float, 8 for bf16) as float.
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float o[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
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

// Adds A[m, :] . W[:, n0..n0+3] over k < H into acc for the TM rows this
// thread owns. A is float in shared memory (row stride lda, a multiple of
// 4), W is float in global memory, row-major [H, H].
template <int TM>
__device__ __forceinline__ void accumulate_f32(float (&acc)[TM][kTN],
                                               const float* A, int lda,
                                               const float* W, int H,
                                               int base, int rg, int rg_count,
                                               int M, int n0) {
  const float* arow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = min(base + rg + i * rg_count, M - 1);
    arow[i] = A + (size_t)m * lda;
  }
  for (int k = 0; k < H; k += 4) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(arow[i] + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (size_t)(k + kk) * H + n0);
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

template <int TM, typename Epi>
__device__ void gemm_f32(const float* A1, int lda1, const float* W1,
                         const float* A2, int lda2, const float* W2, int M,
                         int H, Epi& epi) {
  const int cg_count = H / kTN;
  const int rg_count = kThreads / cg_count;
  const int cg = threadIdx.x % cg_count;
  const int rg = threadIdx.x / cg_count;
  const int n0 = cg * kTN;
  const int rows_per_pass = rg_count * TM;
  for (int base = 0; base < M; base += rows_per_pass) {
    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    accumulate_f32<TM>(acc, A1, lda1, W1, H, base, rg, rg_count, M, n0);
    if (A2 != nullptr)
      accumulate_f32<TM>(acc, A2, lda2, W2, H, base, rg, rg_count, M, n0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = base + rg + i * rg_count;
      if (m < M) {
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
template <typename Epi>
__device__ void gemm_bf16(const bf16* A1, int lda1, const bf16* W1,
                          const bf16* A2, int lda2, const bf16* W2, int M,
                          int H, Epi& epi, float* stage, bf16* wslab) {
  namespace wmma = nvcuda::wmma;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = H / 16;
  const int rt = max(1, min(4, kWarps * kMaxTiles / nt));
  const int per_operand = H / kSlabK;
  const int nslab = (A2 != nullptr ? 2 : 1) * per_operand;
  const int slab_elems = kSlabK * H;
  const int lds = H + row_pad<bf16>();
  float* st = stage + warp * 256;

  auto issue = [&](int s) {
    const bf16* src = (s < per_operand ? W1 : W2) + (size_t)(s % per_operand) * slab_elems;
    bf16* dst = wslab + (s & 1) * kSlabK * lds;
    for (int o = threadIdx.x * 8; o < slab_elems; o += kThreads * 8)
      __pipeline_memcpy_async(dst + (o / H) * lds + o % H, src + o, 16);
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
// accumulated in float. A operands are T in shared memory (row stride lda);
// W operands are T in global memory, row-major [H, H]. epi(m, n, acc)
// receives each output once, after a block barrier that follows every read
// of the pass's A rows, so it may overwrite row m of A1 in place; a barrier
// also follows the last write. All threads must call this with the same M.
// The bf16 path reads A in whole 16-row tiles: the rows up to the next
// multiple of 16 must lie inside the allocation (tile_rows; their values
// are ignored).
// Requires, for float, H % 4 == 0 and (H / 4) dividing kThreads; for bf16,
// H % 32 == 0 and H <= 512. GemmSmem holds the bf16 path's shared memory.
struct GemmSmem {
  float* stage;  // kWarps * 256 floats
  bf16* wslab;   // 2 * kSlabK * (H + 8) bf16
};

template <typename T, typename Epi>
__device__ void block_gemm(const T* A1, int lda1, const T* W1, const T* A2,
                           int lda2, const T* W2, int M, int H,
                           const GemmSmem& gs, Epi epi) {
  if constexpr (std::is_same<T, float>::value) {
    const int rg_count = kThreads / (H / kTN);
    if (M <= rg_count)
      gemm_f32<1>(A1, lda1, W1, A2, lda2, W2, M, H, epi);
    else if (M <= 2 * rg_count)
      gemm_f32<2>(A1, lda1, W1, A2, lda2, W2, M, H, epi);
    else if (M <= 4 * rg_count)
      gemm_f32<4>(A1, lda1, W1, A2, lda2, W2, M, H, epi);
    else
      gemm_f32<kTM>(A1, lda1, W1, A2, lda2, W2, M, H, epi);
  } else {
    gemm_bf16(A1, lda1, W1, A2, lda2, W2, M, H, epi, gs.stage, gs.wslab);
  }
}

// The first pair layer of E edges, silu'd into buf (row stride ldb):
// silu(wi_r + proj_j + radial * we0 + dist0 * we1) for edge e = r * K + k
// and j = eidx[e], each add rounded to T as the JAX kernels do.
template <typename T>
__device__ void pair_layer(const T* wi, const T* proj, const T* we,
                           const int* eidx, const float* erad,
                           const float* ed0, int E, int K, int H, T* buf,
                           int ldb) {
  using C = Cvt<T>;
  // four consecutive channels per thread: one vector load per operand
  for (int p = threadIdx.x * 4; p < E * H; p += kThreads * 4) {
    const int e = p / H, c = p % H;
    float a[4], g[4], w0[4], w1[4];
    load4(wi + (size_t)(e / K) * H + c, a);
    load4(proj + (size_t)eidx[e] * H + c, g);
    load4(we + c, w0);
    load4(we + H + c, w1);
    const float rad = C::rnd(erad[e]);
    const float d0 = ed0[e];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = C::rnd(a[j] + g[j]);
      v = C::rnd(v + C::rnd(rad * w0[j]));
      v = C::rnd(v + C::rnd(d0 * w1[j]));
      buf[(size_t)e * ldb + c + j] = C::from_f(silu_c<T>(v));
    }
  }
}

// The GCL message tile, shared by both kernels. R receivers with K edges
// each, edge e = r * K + k; ldb and ldg are the row strides of buf and agg.
//   buf   [R*K, H]: in: silu of the first pair layer (T);
//                   out: m = silu(buf @ W2 + b2) (T).
//   scale [R*K]   : out: sigmoid(m . att_k + att_b) * kmask, or kmask.
//   agg   [R, H]  : out: (sum over k of m * scale) * (1 / norm_factor),
//                   summed in T in k order, as the JAX kernels do.
template <typename T>
__device__ void gcl_message_tile(T* buf, int ldb, int R, int K, int H, const T* W2,
                                 const float* b2, const T* att_k,
                                 const float* att_b, int attention,
                                 const float* kmask, float* scale,
                                 float norm_factor, T* agg, int ldg,
                                 const GemmSmem& gs) {
  using C = Cvt<T>;
  const int E = R * K;
  block_gemm<T>(buf, ldb, W2, (const T*)nullptr, 0, (const T*)nullptr, E, H,
                gs, [&](int m, int n, float acc) {
                  buf[(size_t)m * ldb + n] = C::from_f(silu_c<T>(C::rnd(acc + b2[n])));
                });
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < E; e += kWarps) {
    float s;
    if (attention) {
      float d = 0.0f;
      for (int c = lane; c < H; c += 32)
        d = fmaf(C::to_f(buf[(size_t)e * ldb + c]), C::to_f(att_k[c]), d);
      d = warp_sum(d);
      s = C::rnd(sigmoid_f(d + att_b[0]) * kmask[e]);
    } else {
      s = C::rnd(kmask[e]);
    }
    if (lane == 0) scale[e] = s;
  }
  __syncthreads();
  const float inv = C::rnd(1.0f / norm_factor);
  for (int p = threadIdx.x; p < R * H; p += kThreads) {
    const int r = p / H, c = p % H;
    const T* col = buf + (size_t)r * K * ldb + c;
    float a = C::rnd(C::to_f(col[0]) * scale[r * K]);
    for (int k = 1; k < K; ++k)
      a = C::rnd(a + C::rnd(C::to_f(col[(size_t)k * ldb]) * scale[r * K + k]));
    agg[(size_t)r * ldg + c] = C::from_f(C::rnd(a * inv));
  }
  __syncthreads();
}

// Bytes of GemmSmem for width H (the float path needs none).
template <typename T>
__host__ __device__ inline size_t gemm_smem_bytes(int H) {
  return std::is_same<T, float>::value
             ? 0
             : 4 * (size_t)kWarps * 256 + 2 * (size_t)2 * kSlabK * (H + row_pad<T>());
}

// Offsets of 128-byte-aligned arrays in dynamic shared memory; the same
// sequence of take() calls sizes the allocation on the host.
struct Carver {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off += (bytes + 127) / 128 * 128;
    return o;
  }
};

// Rows to allocate for an A operand of `rows` rows: the bf16 products read
// whole 16-row tiles, the float products only the rows they use.
template <typename T>
__host__ __device__ inline size_t tile_rows(size_t rows) {
  return std::is_same<T, float>::value ? rows : (rows + 15) / 16 * 16;
}

}  // namespace egnn
