// K1: one GCL's message pass and sum aggregation on the fixed-K neighbor
// list, hand-written for Hopper (sm_90a).
//
// Replaces: cmdgen_tpu/ops/egnn_msgpass.py:gcl_message_agg (pallas_call at
// :168, kernel body _make_kernel :51-102).
//
// Computes, for every receiver i and its K neighbors j = idx[i, k]:
//   pre = silu(wi_i + wj_j + radial * we0 + dist0 * we1)
//   m   = silu(pre @ W2 + b2)
//   s   = sigmoid(m . att + b_att) * kmask   (kmask alone without attention)
//   agg_i = (sum_k m * s) / normalization_factor
// with the casts of the JAX kernel (see egnn_common.cuh).
//
// Bound on an H100 SXM: at the flagship shape (B=48, N=118, K=12, H=256,
// bf16) the 67,968 edges each do a 256x256 product: 2 * 67,968 * 256^2 =
// 8.9 GFLOP, 9.0 us at 989 TFLOP/s, against ~10 MB of inputs and outputs
// (~3 us at 3.35 TB/s). The kernel is bound by operations.
//
// Design: one block per (sample, tile of R receivers), R * K <= 64 edges,
// three blocks per SM. The block loads its own neighbor indices and
// gathers the wj rows by address (no one-hot gather matrix, which was a
// TPU device). The R*K x H pair tile lives in shared memory in the compute
// dtype; the W2 product runs on the tensor cores for bf16 (WMMA, float
// accumulators, W2 streamed through shared memory by cp.async) and as
// float FMAs for float; the epilogue applies bias, SiLU, the attention
// gate (one warp per edge) and the K-sum. Measured far from its bound
// (PERF.md): the kernel's time is about the waves of blocks times one
// block's latency, which more resident blocks hide only in part; what sets
// that latency is not yet measured (no instruction-level profiler runs on
// the card's machine). wgmma with TMA-fed tiles comes after that is known.
#include "egnn_common.cuh"

namespace egnn {

template <typename T>
struct MsgpassSmem {
  size_t buf, agg, ekm, escale, erad, ed0, eidx, gemm, total;
  __host__ __device__ MsgpassSmem(int R, int K, int H) {
    Carver c;
    buf = c.take(sizeof(T) * tile_rows<T>((size_t)R * K) * (H + row_pad<T>()));
    agg = c.take(sizeof(T) * (size_t)R * H);
    ekm = c.take(4 * (size_t)R * K);
    escale = c.take(4 * (size_t)R * K);
    erad = c.take(4 * (size_t)R * K);
    ed0 = c.take(4 * (size_t)R * K);
    eidx = c.take(4 * (size_t)R * K);
    gemm = c.take(gemm_smem_bytes<T>(H));
    total = c.off;
  }
};

constexpr int kTileEdges = 64;  // edges per block: R * K <= kTileEdges

// Three resident blocks per SM (registers capped to fit): a block's
// phases are latency-bound, and a tuning sweep (PERF.md) found three
// blocks per SM faster than two or four.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
gcl_message_agg_kernel(const T* __restrict__ wi, const T* __restrict__ wj,
                       const int* __restrict__ idx,
                       const float* __restrict__ radial,
                       const float* __restrict__ dist0,
                       const float* __restrict__ kmask,
                       const T* __restrict__ we, const T* __restrict__ W2,
                       const float* __restrict__ b2,
                       const T* __restrict__ att_k,
                       const float* __restrict__ att_b, int attention,
                       float norm_factor, int N, int K, int H, int R,
                       T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using C = Cvt<T>;
  const MsgpassSmem<T> L(R, K, H);
  T* buf = reinterpret_cast<T*>(smem_raw + L.buf);
  T* agg = reinterpret_cast<T*>(smem_raw + L.agg);
  float* ekm = reinterpret_cast<float*>(smem_raw + L.ekm);
  float* escale = reinterpret_cast<float*>(smem_raw + L.escale);
  float* erad = reinterpret_cast<float*>(smem_raw + L.erad);
  float* ed0 = reinterpret_cast<float*>(smem_raw + L.ed0);
  int* eidx = reinterpret_cast<int*>(smem_raw + L.eidx);
  const GemmSmem gs{reinterpret_cast<float*>(smem_raw + L.gemm),
                    reinterpret_cast<bf16*>(smem_raw + L.gemm + 4 * kWarps * 256)};

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * R;
  const int rv = min(R, N - i0);
  const int E = rv * K;
  const int ldb = H + row_pad<T>();
  const size_t row0 = (size_t)b * N + i0;

  for (int e = threadIdx.x; e < E; e += kThreads) {
    const size_t off = row0 * K + e;
    eidx[e] = min(max(idx[off], 0), N - 1);
    ekm[e] = kmask[off];
    erad[e] = C::rnd(radial[off]);
    ed0[e] = C::rnd(dist0[off]);
  }
  __syncthreads();

  pair_layer<T>(wi + row0 * H, wj + (size_t)b * N * H, we, eidx, erad, ed0, E, K,
                H, buf, ldb);
  __syncthreads();

  gcl_message_tile<T>(buf, ldb, rv, K, H, W2, b2, att_k, att_b, attention,
                      ekm, escale, norm_factor, agg, H, gs);

  for (int p = threadIdx.x; p < rv * H; p += kThreads) out[row0 * H + p] = agg[p];
}

template <typename T>
static int launch(const void* wi, const void* wj, const void* idx,
                  const void* radial, const void* dist0, const void* kmask,
                  const void* we, const void* W2, const void* b2,
                  const void* att_k, const void* att_b, int attention,
                  float norm_factor, void* out, int B, int N, int K, int H,
                  cudaStream_t stream) {
  int R = K >= kTileEdges ? 1 : kTileEdges / K;
  while (R > 1 && MsgpassSmem<T>(R, K, H).total > (size_t)kMaxSmem) --R;
  const size_t smem = MsgpassSmem<T>(R, K, H).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      gcl_message_agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + R - 1) / R, B);
  gcl_message_agg_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)wi, (const T*)wj, (const int*)idx, (const float*)radial,
      (const float*)dist0, (const float*)kmask, (const T*)we, (const T*)W2,
      (const float*)b2, (const T*)att_k, (const float*)att_b, attention,
      norm_factor, N, K, H, R, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace egnn

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int egnn_msgpass_launch(int dtype, const void* wi, const void* wj,
                                   const void* idx, const void* radial,
                                   const void* dist0, const void* kmask,
                                   const void* we, const void* W2,
                                   const void* b2, const void* att_k,
                                   const void* att_b, int attention,
                                   float norm_factor, void* out, int B, int N,
                                   int K, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return egnn::launch<float>(wi, wj, idx, radial, dist0, kmask, we, W2, b2,
                               att_k, att_b, attention, norm_factor, out, B, N,
                               K, H, s);
  if (dtype == 1)
    return egnn::launch<egnn::bf16>(wi, wj, idx, radial, dist0, kmask, we,
                                       W2, b2, att_k, att_b, attention,
                                       norm_factor, out, B, N, K, H, s);
  return (int)cudaErrorInvalidValue;
}
