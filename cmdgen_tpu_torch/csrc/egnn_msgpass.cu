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
// Design: a persistent grid of one 512-thread block per SM, capped at the
// number of work units, walks a list of work items in a strided loop. An
// item is R receivers of one sample with all their K edges, R * K <= rows
// (128 rows: R = 10 at K = 12, 576 items at the flagship shape); a last
// round that would leave blocks idle is taken as half items. The plan
// (R, the split, the grid) is egnn_plan.h's k1_plan, which the wrapper
// (ops/egnn_msgpass.py: launch_plan) passes in. Each item runs the message tile of egnn_message.cuh, the
// same routine as K2's message phase: the neighbor indices and edge
// scalars into shared memory, the pair layer gathering wj rows by address,
// the edge_out product, the SiLU epilogue and attention gate, and the
// K-sum in k order inside the block (no atomics). bf16 with H <= 256 runs
// the product on mma.sync with W2 loaded into shared memory once per block
// and launch (135 KB at H = 256) and epilogues from the accumulators;
// float keeps exact-float FMAs (block_gemm, W2 streamed through a ring of
// shared-memory chunks), and bf16 wider than 256 streams W2 through WMMA
// slabs (block_gemm). A receiver with more than `rows` edges takes them in
// chunks, its running K-sum carried from one to the next. Any H from 1 to
// 1024: the tile computes at Hp, H rounded up to 32 (bf16) or 4 (float),
// with zero columns in shared memory only (egnn_message.cuh); the inputs
// and agg keep their H columns, and a width that is not a whole number of
// vectors takes narrower loads and stores. `rows` shrinks where a wide
// tile would not fit in shared memory (the wrapper's plan). The mma route
// reads W2 as [out, in] in memory, the layout of the nn.Linear weight whose
// transpose the model passes, so the model's calls copy nothing;
// block_gemm reads it as [in, out]. With `stamps`, block 0 records its
// clock at each stage of its tiles (StageClock).

#include "egnn_common.cuh"
#include "egnn_message.cuh"
#include "egnn_tiles.cuh"

// The launch's arguments, as the wrapper's ctypes structure lays them out
// (ops/egnn_msgpass.py: _Params).
struct K1Params {
  int dtype;            // 0 float32, 1 bfloat16 (T)
  int mma;              // 1: mma.sync route (bf16, H <= 256); 0: block_gemm
  const void* wi;       // [B*N, H] T
  const void* wj;       // [B*N, H] T
  const long long* idx; // [B*N*K]
  const void* radial;   // [B*N*K] T at element strides s_rad, s_d0, s_km
  const void* dist0;
  const void* kmask;
  int s_rad, s_d0, s_km;
  const float* we;      // [2, H] at strides (we_s0, we_s1)
  int we_s0, we_s1;
  const void* w2;       // [H, H] T: [out, in] in memory with mma, else [in, out]
  const float* b2;      // [H]
  const float* att;     // [H]; unused without attention
  const float* att_b;   // [1]
  int attention;
  float norm_factor;
  void* out;            // [B*N, H] T
  long long* stamps;    // null, or [kStages + 1] (StageClock)
  int B, N, K, H;
  int Hp;               // the tile's width: H rounded up to 32 (bf16) or 4 (float)
  int R;                // receivers per item
  int rows;             // rows of the edge tile
  int kc, chunks;       // edges per tile, tiles per item (K = kc when chunks = 1)
  int whole, units;     // items [0, whole) whole, then half items; units of work
  int grid;
};

namespace egnn {

template <typename T, bool kMma, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1) gcl_message_agg_kernel(const K1Params a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using C = Cvt<T>;
  const int H = a.H, Hp = a.Hp, N = a.N, K = a.K, R = a.R;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const TileSmem L(Hp, a.rows, kMma, kBf16, false);
  MsgSmem<T> sm;
  sm.buf = reinterpret_cast<T*>(smem_raw + L.buf);
  sm.ld = Hp + row_pad<T>();
  sm.rows = a.rows;
  sm.wsm = reinterpret_cast<bf16*>(smem_raw + L.wsm);
  sm.part = reinterpret_cast<float*>(smem_raw + L.part);
  sm.gs = GemmSmem{reinterpret_cast<float*>(smem_raw + L.gemm),
                   reinterpret_cast<bf16*>(smem_raw + L.gemm + 4 * kWarps * 256),
                   reinterpret_cast<float*>(smem_raw + L.gemm)};
  float* vec = reinterpret_cast<float*>(smem_raw + L.vec);
  sm.vec = GclVecs{vec, vec + Hp, vec + 2 * Hp, vec + 3 * Hp};
  sm.carry = reinterpret_cast<float*>(smem_raw + L.carry);
  EdgeTile& et = sm.et;
  et.eidx = reinterpret_cast<int*>(smem_raw + L.eidx);
  et.ercv = reinterpret_cast<int*>(smem_raw + L.ercv);
  et.ekm = reinterpret_cast<float*>(smem_raw + L.ekm);
  et.erad = reinterpret_cast<float*>(smem_raw + L.erad);
  et.ed0 = reinterpret_cast<float*>(smem_raw + L.ed0);
  et.escale = reinterpret_cast<float*>(smem_raw + L.escale);

  const T* W2 = static_cast<const T*>(a.w2);
  const T* wi = static_cast<const T*>(a.wi);
  const T* wj = static_cast<const T*>(a.wj);
  const T* radial = static_cast<const T*>(a.radial);
  const T* dist0 = static_cast<const T*>(a.dist0);
  const T* kmask = static_cast<const T*>(a.kmask);
  T* out = static_cast<T*>(a.out);
  StageClock clk(a.stamps);

  // the GCL's vectors, w_e and att rounded to T as the JAX kernel casts
  // them, zero past H
  for (int c = threadIdx.x; c < Hp; c += kThreads) {
    const bool in = c < H;
    sm.vec.we0[c] = in ? C::rnd(a.we[(size_t)c * a.we_s1]) : 0.0f;
    sm.vec.we1[c] = in ? C::rnd(a.we[a.we_s0 + (size_t)c * a.we_s1]) : 0.0f;
    sm.vec.b2[c] = in ? a.b2[c] : 0.0f;
    sm.vec.att[c] = in && a.attention ? C::rnd(a.att[c]) : 0.0f;
  }
  const float att_b = a.attention ? a.att_b[0] : 0.0f;
  const float inv = C::rnd(1.0f / a.norm_factor);
  const int per_sample = (N + R - 1) / R;
  const bf16* resident = nullptr;  // what sm.wsm holds

  // unit w -> (sample, receivers, chunks of edges); the tests walk the
  // plan the same way (tests/test_torch_egnn_msgpass.py: plan_tiles), so
  // a change here is made there too
  for (int w = blockIdx.x; w < a.units; w += gridDim.x) {
    int it = w, half = 0;
    if (w >= a.whole) {
      it = a.whole + (w - a.whole) / 2;
      half = 1 + (w - a.whole) % 2;
    }
    const int b = it / per_sample;
    int i0 = (it % per_sample) * R;
    int rv = min(R, N - i0);
    take_half(half, i0, rv);
    const size_t row0 = (size_t)b * N + i0;
    for (int ch = 0; ch < a.chunks; ++ch) {
      const int k0 = ch * a.kc;
      const int kc = min(a.kc, K - k0);
      const int E = rv * kc;
      __syncthreads();  // the previous tile is done with shared memory
      clk.tick(kKsum);
      // edge_out's weights stay in shared memory for the whole launch
      if constexpr (kMma)
        tiles::use_weights<kRagged>(resident, sm.wsm, sm.ld, reinterpret_cast<const bf16*>(W2),
                                    H, Hp);
      for (int e = threadIdx.x; e < E; e += kThreads) {
        const int r = e / kc;
        const size_t off = (row0 + r) * K + k0 + (e - r * kc);
        et.eidx[e] = (int)min(max(a.idx[off], 0LL), (long long)N - 1);
        et.ercv[e] = r;
        et.ekm[e] = C::to_f(kmask[off * a.s_km]);
        et.erad[e] = C::to_f(radial[off * a.s_rad]);
        et.ed0[e] = C::to_f(dist0[off * a.s_d0]);
      }
      __syncthreads();
      clk.tick(kEdgeLoad);
      message_tile<T, kMma, kMma, kRagged>(sm, wi + row0 * H, wj + (size_t)b * N * H, W2, att_b,
                                a.attention != 0, E, rv, kc, H, Hp, ch == 0,
                                ch == a.chunks - 1, inv, out + row0 * H, clk);
    }
  }
  __syncthreads();
  clk.tick(kKsum);
  clk.write();
}

template <typename T, bool kMma, bool kRagged>
static int launch_as(const K1Params& a, cudaStream_t stream) {
  const size_t smem = TileSmem(a.Hp, a.rows, kMma, std::is_same<T, bf16>::value, false).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(gcl_message_agg_kernel<T, kMma, kRagged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gcl_message_agg_kernel<T, kMma, kRagged><<<a.grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instantiations this build holds: every one, or with EGNN_VARIANT
// defined only the regular (0) or the ragged ones (1), so that
// ops/_build.py compiles them in parallel, one library each.
#ifdef EGNN_VARIANT
constexpr int kVariant = EGNN_VARIANT;
#else
constexpr int kVariant = -1;
#endif
constexpr bool holds(int v) { return kVariant < 0 || kVariant == v; }

template <typename T, bool kMma>
static int launch(const K1Params& a, cudaStream_t stream) {
  const int v = k1_variant(a.H, std::is_same<T, bf16>::value);
  if constexpr (holds(0))
    if (v == 0) return launch_as<T, kMma, false>(a, stream);
  if constexpr (holds(1))
    if (v == 1) return launch_as<T, kMma, true>(a, stream);
  return (int)cudaErrorNotSupported;  // the other variant's
}

}  // namespace egnn

// Launches K1 with the wrapper's arguments and plan. Returns a cudaError_t
// value (0 = ok); cudaErrorInvalidValue for a plan or shape the kernel
// does not take.
extern "C" int egnn_msgpass_launch(const K1Params* p, void* stream) {
  const K1Params& a = *p;
  cudaStream_t s = (cudaStream_t)stream;
  const bool shape_ok = a.B >= 1 && a.N >= 1 && a.K >= 1 && a.R >= 1 && a.kc >= 1 &&
                        a.R * a.kc <= a.rows && a.rows <= egnn::kEdgeRows &&
                        a.chunks * a.kc >= a.K && a.grid >= 1 && a.units >= a.whole &&
                        a.whole >= 0 && (a.dtype == 0 || a.dtype == 1) &&
                        a.Hp == egnn::padded_width(a.H, a.dtype == 1);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  if (a.dtype == 0) {
    if (a.mma) return (int)cudaErrorInvalidValue;
    return egnn::launch<float, false>(a, s);
  }
  if (!a.mma) return egnn::launch<egnn::bf16, false>(a, s);
  if (a.Hp > egnn::kMmaMaxH || a.rows != egnn::kEdgeRows) return (int)cudaErrorInvalidValue;
  return egnn::launch<egnn::bf16, true>(a, s);
}
