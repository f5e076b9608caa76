// bf16 tile products on the tensor cores by mma.sync, for a block of 16
// warps (512 threads), with the weight matrix in shared memory.
//
// A block multiplies a tile of 16 * MI * 4 rows (64 or 128) of a bf16
// operand A in shared memory by a bf16 weight matrix W [H, H] (row-major
// [in, out], H % 32 == 0, H <= 256) also in shared memory (a smaller matrix
// [hw, hw] zero-padded to H on its way there: load_chunk), rows of both
// padded by 8 elements (row_pad: an ldmatrix phase then reads 8 rows on 32
// distinct banks). The 16 warps form a 4 x 4 grid; warp (wr, wc) owns rows
// [wr * 16 * MI, +16 * MI) and columns [wc * H / 4, +H / 4): a register
// tile of MI m16 tiles x H / 32 n8 tiles of float accumulators (32 x 64 at
// MI = 2, H = 256). Each 16-deep step loads A by ldmatrix.x4 and W by
// ldmatrix.x4.trans (W is [k, n] row-major, mma wants it column-major) and
// runs mma.sync.m16n8k16 with float accumulation. A matrix held as [n, k]
// row-major (WT: the transpose of an nn.Linear weight, as PyTorch stores
// it) is already column-major for mma and loads by ldmatrix.x4 without
// .trans. Epilogues read the accumulators in registers (for_each_pair,
// row_partials).
//
// Weights reach shared memory by 16-byte cp.async in chunks of kChunk rows,
// one commit group per chunk. A resident matrix (loaded once per phase) is
// multiplied with no block barrier inside the K loop (mma_tile). A streamed
// product (mma_streamed) waits for each chunk in turn and, once every warp
// has finished a chunk, refills its rows with the same chunk of the next
// matrix, so the next product's weights load while this one computes.
#pragma once

#include "egnn_common.cuh"

namespace egnn {
namespace tiles {

static_assert(kThreads == 512, "the tile products are laid out for 16 warps");

using egnn::kWarpCols;  // warp grid: 4 x 4 over the block's 16 warps
constexpr int kMaxNT = 8;     // n8 tiles per warp at H = 256
constexpr int kChunk = 64;    // weight rows per cp.async group

// ---- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_n(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), float accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ---- end PTX

// The accumulators of one warp: MI m16 tiles x kMaxNT n8 tiles; element
// [mi][j][2 * h + i] is row 16 * mi + lane / 4 + 8 * h, column
// 8 * j + 2 * (lane % 4) + i of the warp's tile. Only j < H / 32 is used.
template <int MI>
struct Acc {
  float v[MI][kMaxNT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mi][j][i] = 0.0f;
  }
};

__host__ __device__ inline int nchunks(int H) { return (H + kChunk - 1) / kChunk; }

// Waits until at most n of this thread's cp.async groups are pending
// (n < 4: the weight chunks of H <= 256).
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    default: __pipeline_wait_prior(3); break;
  }
}

// Copies rows [c * kChunk, +kChunk) of W [hw, hw] (global; zero past hw,
// copy_weight_rows) into the same rows of wsm (row stride ldw, H columns)
// and commits them as one group.
template <bool kRagged>
__device__ __forceinline__ void load_chunk(bf16* wsm, int ldw, const bf16* W, int hw, int H,
                                           int c) {
  const int r0 = c * kChunk;
  if constexpr (kRagged) {
    copy_weight_rows(wsm + (size_t)r0 * ldw, ldw, W, hw, H, r0, min(H, r0 + kChunk));
  } else {
    const int per_row = H / 8;
    const int n = (min(H, r0 + kChunk) - r0) * per_row;
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const int r = r0 + p / per_row, q = (p % per_row) * 8;
      __pipeline_memcpy_async(wsm + (size_t)r * ldw + q, W + (size_t)r * H + q, 16);
    }
  }
  __pipeline_commit();
}

// Starts loading W [hw, hw] into wsm as nchunks(H) groups, or commits as
// many empty groups if wsm already holds W (resident tracks what wsm
// holds). Every warp must be done with wsm's previous contents.
template <bool kRagged = false>
__device__ __forceinline__ void use_weights(const bf16*& resident, bf16* wsm, int ldw,
                                            const bf16* W, int hw, int H) {
  const int nch = nchunks(H);
  for (int c = 0; c < nch; ++c) {
    if (resident == W)
      __pipeline_commit();
    else
      load_chunk<kRagged>(wsm, ldw, W, hw, H, c);
  }
  resident = W;
}

// The same with W [H, H].
__device__ __forceinline__ void use_weights(const bf16*& resident, bf16* wsm, int ldw,
                                            const bf16* W, int H) {
  use_weights<false>(resident, wsm, ldw, W, H, H);
}

// acc += A[warp rows, k0:k1] . W[k0:k1, warp columns], all in shared memory
// (row strides lda, ldw); k0, k1 multiples of 16. W is [k, n] row-major, or
// [n, k] row-major with WT. No barrier.
template <int MI, bool WT = false>
__device__ __forceinline__ void mma_range(Acc<MI>& acc, const bf16* A, int lda,
                                          const bf16* W, int ldw, int H, int k0, int k1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / kWarpCols, wc = warp % kWarpCols;
  const int nt = H / 32;
  const bf16* arow = A + (size_t)(wr * 16 * MI + lane % 16) * lda + (lane / 16) * 8;
  // the x4 load's matrices are n8 tiles j, j+1 times k halves 0..7, 8..15:
  // lane l addresses row l % 8 of matrix l / 8
  const bf16* wcol =
      WT ? W + (size_t)(wc * nt * 8 + lane % 8 + (lane / 16) * 8) * ldw + ((lane / 8) % 2) * 8
         : W + (size_t)(lane % 16) * ldw + wc * nt * 8 + (lane / 16) * 8;
  for (int k = k0; k < k1; k += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) ldsm_x4(a[mi], arow + (size_t)mi * 16 * lda + k);
    // two n8 tiles of W at a time, each multiplied as soon as it is loaded
#pragma unroll
    for (int j = 0; j < kMaxNT; j += 2) {
      if (j < nt) {
        uint32_t b0, b1, b2 = 0, b3 = 0;
        if (WT) {
          const bf16* p = wcol + (size_t)j * 8 * ldw + k;
          if (j + 1 < nt)
            ldsm_x4_n(b0, b1, b2, b3, p);
          else
            ldsm_x2(b0, b1, p);
        } else {
          const bf16* p = wcol + (size_t)k * ldw + j * 8;
          if (j + 1 < nt)
            ldsm_x4_t(b0, b1, b2, b3, p);
          else
            ldsm_x2_t(b0, b1, p);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_16816(acc.v[mi][j], a[mi], b0, b1);
          if (j + 1 < nt) mma_16816(acc.v[mi][j + 1], a[mi], b2, b3);
        }
      }
    }
  }
}

// acc += A . W over the full depth H, W resident and visible in wsm.
template <int MI, bool WT = false>
__device__ __forceinline__ void mma_tile(Acc<MI>& acc, const bf16* A, int lda,
                                         const bf16* wsm, int ldw, int H) {
  mma_range<MI, WT>(acc, A, lda, wsm, ldw, H, 0, H);
}

// acc += A . W, W's chunks arriving in wsm: its nchunks(H) groups were the
// last ones committed before this call, or are complete. Chunk c is waited
// for (at most nchunks - 1 younger groups pending: W's later chunks plus
// one group per earlier chunk of this call), made visible by a barrier and
// multiplied; then, after a barrier, its rows take chunk c of `next` (or an
// empty group is committed), which leaves next's chunks as the last
// nchunks(H) groups for the following call. Loads of A committed before
// W's chunks are complete and visible after the first chunk's wait.
template <int MI>
__device__ __forceinline__ void mma_streamed(Acc<MI>& acc, const bf16* A, int lda,
                                             bf16* wsm, int ldw, int H,
                                             const bf16*& resident, const bf16* next) {
  const int nch = nchunks(H);
  for (int c = 0; c < nch; ++c) {
    wait_pending(nch - 1);
    __syncthreads();
    mma_range<MI>(acc, A, lda, wsm, ldw, H, c * kChunk, min(H, (c + 1) * kChunk));
    if (next != nullptr) {
      __syncthreads();
      load_chunk<false>(wsm, ldw, next, H, H, c);
    } else {
      __pipeline_commit();
    }
  }
  if (next != nullptr) resident = next;
}

// Calls epi(m, n, v0, v1) for each pair of adjacent output columns (n, n+1)
// of this thread's accumulators; m is the row within the block's tile.
template <int MI, typename Epi>
__device__ __forceinline__ void for_each_pair(const Acc<MI>& acc, int H, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / kWarpCols, wc = warp % kWarpCols;
  const int nt = H / 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j)
      if (j < nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(wr * 16 * MI + mi * 16 + lane / 4 + 8 * h, wc * nt * 8 + j * 8 + 2 * (lane % 4),
              acc.v[mi][j][2 * h], acc.v[mi][j][2 * h + 1]);
      }
}

// A row-wise sum over the columns of the tile, from the accumulators:
// part[wc * ldp + m] = sum over warp column group wc's columns n of
// f(m, n, v0, v1) (each call covers columns n, n+1), reduced across the
// four lanes of a row by shuffles. The caller sums the kWarpCols partials
// after a barrier.
template <int MI, typename F>
__device__ __forceinline__ void row_partials(const Acc<MI>& acc, int H, float* part, int ldp, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / kWarpCols, wc = warp % kWarpCols;
  const int nt = H / 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wr * 16 * MI + mi * 16 + lane / 4 + 8 * h;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        if (j < nt)
          s += f(m, wc * nt * 8 + j * 8 + 2 * (lane % 4), acc.v[mi][j][2 * h],
                 acc.v[mi][j][2 * h + 1]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (lane % 4 == 0) part[wc * ldp + m] = s;
    }
}

}  // namespace tiles
}  // namespace egnn
