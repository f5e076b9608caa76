// K2: the whole L-layer EGNN stack for one sample per block, hand-written
// for Hopper (sm_90a).
//
// Replaces: cmdgen_tpu/ops/egnn_fused.py:egnn_forward_fused (pallas_call at
// :342, kernel body _make_fused_kernel :48-206), with inv_sublayers=1, the
// neighbor list, sum aggregation, attention and the tanh coordinate gate.
//
// Each layer does
//   1. the GCL message pass of K1 (egnn_msgpass.cu), on a radial computed
//      from x rounded to the compute dtype, as the JAX kernel does;
//   2. the node MLP residual, node_in split into its h and agg halves,
//      then h *= node_mask;
//   3. the coordinate pass on the first update_rows receivers, with an f32
//      x gather: x += sum_k diff / (sqrt(radial + 1e-8) + norm_constant)
//      * tanh(gate) * coords_range * kmask / normalization_factor;
//      then x *= node_mask.
// The neighbor list, dist0 and the input and output embeddings are computed
// outside the kernel (ops/egnn_fused.py), as in the JAX package.
//
// Bound on an H100 SXM: at the flagship shape (B=48, N=118, K=12, H=256,
// L=5, 8 movable rows, bf16) each sample and layer does 1,416 edge rows of
// the 256x256 edge_out product (186 MFLOP), six N x H x H node-level
// products (93 MFLOP) and the coord_mid product on 96 edges (13 MFLOP):
// about 292 MFLOP, or 70 GFLOP per call, 71 us at 989 TFLOP/s. The weights
// (5.9 MB in bf16) stay resident in the 50 MB L2. The kernel is bound by
// operations.
//
// Design: one block per sample loops over the layers. h (in the compute
// dtype) and x (float) stay in shared memory for the whole stack; the block
// raises its dynamic shared memory limit to 227 KB. Each layer first
// projects every node (w_j h + b and w_i h) into global scratch arrays of
// the sample, which stay in L2; then runs the message tile that K1 uses
// (egnn_common.cuh) over receiver tiles of R (R * K <= 128 edges), summing
// into a third scratch array; then the node MLP over all N rows at once,
// so each weight matrix streams through the block once per layer, not once
// per receiver tile. Products run on the tensor cores for bf16 (WMMA,
// weights streamed through shared memory by cp.async) and as float FMAs
// for float (weights read from L2). Phases are separated by block
// barriers. Only B blocks of 512 threads run (48 on 132 SMs at the
// flagship batch), and one block's latency sets the kernel's time
// (PERF.md): splitting a sample over several blocks (a cluster) and wgmma
// are the first things a later version changes.
// 512 threads per block: one block holds an SM alone, and its phases are
// latency-bound. A sweep over 256-1024 (PERF.md) found 512 the fastest in
// float and within 7% of 1024 in bf16; at 1024 the float path spills.
#define EGNN_THREADS 512
#include "egnn_common.cuh"

namespace egnn {

// Per-layer weight stacks, each contiguous over the L layers.
template <typename T>
struct FusedWeights {
  const T* wi;      // [L, H, H] edge_in w_i
  const T* wj;      // [L, H, H] edge_in w_j
  const float* wjb; // [L, H]
  const T* we;      // [L, 2, H] edge_in w_e rows (radial, dist0)
  const T* w2;      // [L, H, H] edge_out
  const float* w2b; // [L, H]
  const T* att;     // [L, H]    att kernel
  const float* attb;// [L]
  const T* nih;     // [L, H, H] node_in, h half
  const T* nia;     // [L, H, H] node_in, agg half
  const float* nib; // [L, H]
  const T* no;      // [L, H, H] node_out
  const float* nob; // [L, H]
  const T* cwi;     // [L, H, H] coord_in w_i
  const T* cwj;     // [L, H, H] coord_in w_j
  const float* cwjb;// [L, H]
  const T* cwe;     // [L, 2, H]
  const T* cm;      // [L, H, H] coord_mid
  const float* cmb; // [L, H]
  const T* cg;      // [L, H]    coord_gate (no bias)
};

// edges per receiver tile: R * K <= kTileEdges, fewer where shared memory
// runs short (float at large N)
constexpr int kTileEdges = 128;

template <typename T>
struct FusedSmem {
  size_t hs, buf, xs, xn, nm, ekm, escale, erad, ed0, ediff, eidx, gemm, total;
  __host__ __device__ FusedSmem(int N, int R, int K, int H) {
    const size_t E = (size_t)R * K;
    const size_t ld = H + row_pad<T>();
    Carver c;
    hs = c.take(sizeof(T) * tile_rows<T>(N) * ld);
    buf = c.take(sizeof(T) * tile_rows<T>(E) * ld);
    xs = c.take(4 * (size_t)N * 3);
    xn = c.take(4 * (size_t)N * 3);
    nm = c.take(4 * (size_t)N);
    ekm = c.take(4 * E);
    escale = c.take(4 * E);
    erad = c.take(4 * E);
    ed0 = c.take(4 * E);
    ediff = c.take(4 * E * 3);
    eidx = c.take(4 * E);
    gemm = c.take(gemm_smem_bytes<T>(H));
    total = c.off;
  }
};

// Rows of each of the three [rows, H] scratch arrays of one sample in
// global memory (row count rounded up to whole 16-row tiles).
__host__ __device__ inline size_t scratch_rows(int N) { return (N + 15) / 16 * 16; }

// Loads the K edges of receivers [i0, i0 + rv) into shared memory: the
// clamped neighbor index, kmask, dist0 rounded to T, and the squared
// distance from x -- rounded to T at every step for the GCL (the JAX
// kernel gathers x in the compute dtype), in float for the coordinate pass
// (which also keeps the difference vectors).
template <typename T>
__device__ void load_edges(const int* idx, const float* kmask,
                           const float* dist0, const float* xs, size_t row0,
                           int i0, int E, int K, int N, bool coord_pass,
                           int* eidx, float* ekm, float* ed0, float* erad,
                           float* ediff) {
  using C = Cvt<T>;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const size_t off = row0 * K + e;
    const int i = i0 + e / K;
    const int j = min(max(idx[off], 0), N - 1);
    eidx[e] = j;
    ekm[e] = kmask[off];
    ed0[e] = C::rnd(dist0[off]);
    float s = 0.0f;
    for (int c = 0; c < 3; ++c) {
      if (coord_pass) {
        const float d = xs[i * 3 + c] - xs[j * 3 + c];
        ediff[e * 3 + c] = d;
        s += d * d;
      } else {
        const float d = C::rnd(C::rnd(xs[i * 3 + c]) - C::rnd(xs[j * 3 + c]));
        s += C::rnd(d * d);
      }
    }
    erad[e] = coord_pass ? s : C::rnd(s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
egnn_fused_kernel(const T* __restrict__ h0, const float* __restrict__ x0,
                  const int* __restrict__ idx,
                  const float* __restrict__ kmask,
                  const float* __restrict__ dist0,
                  const float* __restrict__ nmask, FusedWeights<T> w,
                  T* scratch, float* __restrict__ hout,
                  float* __restrict__ xout, int N, int K, int H, int L,
                  int R, int r_true, float norm_constant,
                  float coords_range, float norm_factor, int use_tanh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using C = Cvt<T>;
  const FusedSmem<T> S(N, R, K, H);
  T* hs = reinterpret_cast<T*>(smem_raw + S.hs);
  T* buf = reinterpret_cast<T*>(smem_raw + S.buf);
  float* xs = reinterpret_cast<float*>(smem_raw + S.xs);
  float* xn = reinterpret_cast<float*>(smem_raw + S.xn);
  float* nm = reinterpret_cast<float*>(smem_raw + S.nm);
  float* ekm = reinterpret_cast<float*>(smem_raw + S.ekm);
  float* escale = reinterpret_cast<float*>(smem_raw + S.escale);
  float* erad = reinterpret_cast<float*>(smem_raw + S.erad);
  float* ed0 = reinterpret_cast<float*>(smem_raw + S.ed0);
  float* ediff = reinterpret_cast<float*>(smem_raw + S.ediff);
  int* eidx = reinterpret_cast<int*>(smem_raw + S.eidx);
  const GemmSmem gs{reinterpret_cast<float*>(smem_raw + S.gemm),
                    reinterpret_cast<bf16*>(smem_raw + S.gemm + 4 * kWarps * 256)};

  const int b = blockIdx.x;
  const size_t nb = (size_t)b * N;
  // this sample's three [N, H] arrays in global memory (L2 resident),
  // written and read by this block only, so read with plain loads:
  //   proj: the gathered projection (w_j h + b, then coord w_j h + b)
  //   wia:  the receiver projection (w_i h, then coord w_i h)
  //   aggu: the summed messages, then the node MLP's hidden layer
  const size_t srows = scratch_rows(N);
  T* proj = scratch + (size_t)b * 3 * srows * H;
  T* wia = proj + srows * H;
  T* aggu = wia + srows * H;
  const T* none = nullptr;
  const int ld = H + row_pad<T>();  // row stride of hs and buf

  for (int p = threadIdx.x; p < N * H; p += kThreads)
    hs[(size_t)(p / H) * ld + p % H] = h0[nb * H + p];
  for (int p = threadIdx.x; p < N * 3; p += kThreads) xs[p] = x0[nb * 3 + p];
  for (int i = threadIdx.x; i < N; i += kThreads) nm[i] = nmask[nb + i];
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t oHH = (size_t)l * H * H, oH = (size_t)l * H;
    const float* Wjb = w.wjb + oH;
    const float* Nib = w.nib + oH;
    const float* Nob = w.nob + oH;
    const float* Cwjb = w.cwjb + oH;
    const float* Cmb = w.cmb + oH;
    const T* Cg = w.cg + oH;

    // ---- GCL: both projections of every node, then the messages of each
    // receiver tile into aggu
    block_gemm<T>(hs, ld, w.wj + oHH, none, 0, none, N, H, gs,
                  [&](int m, int n, float acc) {
                    proj[(size_t)m * H + n] = C::from_f(acc + Wjb[n]);
                  });
    block_gemm<T>(hs, ld, w.wi + oHH, none, 0, none, N, H, gs,
                  [&](int m, int n, float acc) {
                    wia[(size_t)m * H + n] = C::from_f(acc);
                  });
    for (int i0 = 0; i0 < N; i0 += R) {
      const int rv = min(R, N - i0);
      const int E = rv * K;
      load_edges<T>(idx, kmask, dist0, xs, nb + i0, i0, E, K, N, false, eidx,
                    ekm, ed0, erad, ediff);
      __syncthreads();
      pair_layer<T>(wia + (size_t)i0 * H, proj, w.we + 2 * oH, eidx, erad, ed0,
                    E, K, H, buf, ld);
      __syncthreads();
      gcl_message_tile<T>(buf, ld, rv, K, H, w.w2 + oHH, w.w2b + oH,
                          w.att + oH, w.attb + l, 1, ekm, escale, norm_factor,
                          aggu + (size_t)i0 * H, H, gs);
    }
    // node MLP residual on every row; the hidden layer overwrites aggu
    // row by row, after the product has read those rows
    block_gemm<T>(hs, ld, w.nih + oHH, aggu, H, w.nia + oHH, N, H, gs,
                  [&](int m, int n, float acc) {
                    aggu[(size_t)m * H + n] = C::from_f(silu_c<T>(C::rnd(acc + Nib[n])));
                  });
    block_gemm<T>(aggu, H, w.no + oHH, none, 0, none, N, H, gs,
                  [&](int m, int n, float acc) {
                    T* hp = hs + (size_t)m * ld + n;
                    const float hv = C::rnd(C::to_f(*hp) + C::rnd(acc + Nob[n]));
                    *hp = C::from_f(hv * nm[m]);
                  });

    // ---- coordinate pass on the movable receivers [0, r_true)
    block_gemm<T>(hs, ld, w.cwj + oHH, none, 0, none, N, H, gs,
                  [&](int m, int n, float acc) {
                    proj[(size_t)m * H + n] = C::from_f(acc + Cwjb[n]);
                  });
    block_gemm<T>(hs, ld, w.cwi + oHH, none, 0, none, r_true, H, gs,
                  [&](int m, int n, float acc) {
                    wia[(size_t)m * H + n] = C::from_f(acc);
                  });
    for (int i0 = 0; i0 < r_true; i0 += R) {
      const int rv = min(R, r_true - i0);
      const int E = rv * K;
      load_edges<T>(idx, kmask, dist0, xs, nb + i0, i0, E, K, N, true, eidx,
                    ekm, ed0, erad, ediff);
      __syncthreads();
      pair_layer<T>(wia + (size_t)i0 * H, proj, w.cwe + 2 * oH, eidx, erad, ed0,
                    E, K, H, buf, ld);
      __syncthreads();
      block_gemm<T>(buf, ld, w.cm + oHH, none, 0, none, E, H, gs,
                    [&](int m, int n, float acc) {
                      buf[(size_t)m * ld + n] = C::from_f(silu_c<T>(C::rnd(acc + Cmb[n])));
                    });
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int e = warp; e < E; e += kWarps) {
        float g = 0.0f;
        for (int c = lane; c < H; c += 32)
          g = fmaf(C::to_f(buf[(size_t)e * ld + c]), C::to_f(Cg[c]), g);
        g = warp_sum(g);
        if (use_tanh) g = tanhf(g) * coords_range;
        if (lane == 0) {
          const float norm = sqrtf(erad[e] + 1e-8f);
          for (int c = 0; c < 3; ++c)
            ediff[e * 3 + c] = ediff[e * 3 + c] / (norm + norm_constant) * g * ekm[e];
        }
      }
      __syncthreads();
      for (int p = threadIdx.x; p < rv * 3; p += kThreads) {
        const int r = p / 3, c = p % 3;
        float s = ediff[(r * K) * 3 + c];
        for (int k = 1; k < K; ++k) s += ediff[(r * K + k) * 3 + c];
        xn[(i0 + r) * 3 + c] = xs[(i0 + r) * 3 + c] + s / norm_factor;
      }
      __syncthreads();
    }
    for (int p = threadIdx.x; p < N * 3; p += kThreads) {
      const int i = p / 3;
      xs[p] = (i < r_true ? xn[p] : xs[p]) * nm[i];
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < N * H; p += kThreads)
    hout[nb * H + p] = C::to_f(hs[(size_t)(p / H) * ld + p % H]);
  for (int p = threadIdx.x; p < N * 3; p += kThreads) xout[nb * 3 + p] = xs[p];
}

template <typename T>
static int launch(const void* h0, const void* x0, const void* idx,
                  const void* kmask, const void* dist0, const void* nmask,
                  const void* const* wp, void* scratch, void* hout, void* xout,
                  int B, int N, int K, int H, int L, int r_true,
                  float norm_constant, float coords_range, float norm_factor,
                  int use_tanh, cudaStream_t stream) {
  int R = K >= kTileEdges ? 1 : kTileEdges / K;
  while (R > 1 && FusedSmem<T>(N, R, K, H).total > (size_t)kMaxSmem) --R;
  const size_t smem = FusedSmem<T>(N, R, K, H).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      egnn_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  FusedWeights<T> w;
  w.wi = (const T*)wp[0];
  w.wj = (const T*)wp[1];
  w.wjb = (const float*)wp[2];
  w.we = (const T*)wp[3];
  w.w2 = (const T*)wp[4];
  w.w2b = (const float*)wp[5];
  w.att = (const T*)wp[6];
  w.attb = (const float*)wp[7];
  w.nih = (const T*)wp[8];
  w.nia = (const T*)wp[9];
  w.nib = (const float*)wp[10];
  w.no = (const T*)wp[11];
  w.nob = (const float*)wp[12];
  w.cwi = (const T*)wp[13];
  w.cwj = (const T*)wp[14];
  w.cwjb = (const float*)wp[15];
  w.cwe = (const T*)wp[16];
  w.cm = (const T*)wp[17];
  w.cmb = (const float*)wp[18];
  w.cg = (const T*)wp[19];
  egnn_fused_kernel<T><<<B, kThreads, smem, stream>>>(
      (const T*)h0, (const float*)x0, (const int*)idx, (const float*)kmask,
      (const float*)dist0, (const float*)nmask, w, (T*)scratch, (float*)hout,
      (float*)xout, N, K, H, L, R, r_true, norm_constant, coords_range,
      norm_factor, use_tanh);
  return (int)cudaGetLastError();
}

}  // namespace egnn

// dtype: 0 = float32, 1 = bfloat16. weights: the 20 device pointers of
// FusedWeights, in its order. scratch: B * 3 * scratch_rows(N) * H elements of the
// compute dtype. Returns a cudaError_t value (0 = ok).
extern "C" int egnn_fused_launch(int dtype, const void* h0, const void* x0,
                                 const void* idx, const void* kmask,
                                 const void* dist0, const void* nmask,
                                 const void* const* weights, void* scratch,
                                 void* hout, void* xout, int B, int N, int K,
                                 int H, int L, int r_true, float norm_constant,
                                 float coords_range, float norm_factor,
                                 int use_tanh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return egnn::launch<float>(h0, x0, idx, kmask, dist0, nmask, weights,
                               scratch, hout, xout, B, N, K, H, L, r_true,
                               norm_constant, coords_range, norm_factor,
                               use_tanh, s);
  if (dtype == 1)
    return egnn::launch<egnn::bf16>(h0, x0, idx, kmask, dist0, nmask,
                                       weights, scratch, hout, xout, B, N, K,
                                       H, L, r_true, norm_constant,
                                       coords_range, norm_factor, use_tanh, s);
  return (int)cudaErrorInvalidValue;
}
