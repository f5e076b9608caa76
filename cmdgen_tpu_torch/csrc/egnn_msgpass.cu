// K1: one GCL's message pass and sum aggregation on the fixed-K neighbor
// list, and K3: the coordinate update of one EGNN block on the same list,
// hand-written for Hopper (sm_90a). One kernel body (edge_pass), two entry
// points: the two differ only in what they read for each edge and in their
// epilogue.
//
// K1 replaces: cmdgen_tpu/ops/egnn_msgpass.py:gcl_message_agg (pallas_call
// at :168, kernel body _make_kernel :51-102). It computes, for every
// receiver i and its K neighbors j = idx[i, k]:
//   pre = silu(wi_i + wj_j + radial * we0 + dist0 * we1)
//   m   = silu(pre @ W2 + b2)
//   s   = sigmoid(m . att + b_att) * kmask   (kmask alone without attention)
//   agg_i = (sum_k m * s) / normalization_factor
// with the casts of the JAX kernel (see egnn_common.cuh).
//
// K3 replaces: the PyTorch ops of models/egnn.py: EquivariantUpdate on the
// neighbor-list engine (the JAX package runs this sublayer in XLA,
// cmdgen_tpu/models/egnn.py:304; its only kernel for it is K2's phase D).
// It computes, for every receiver i of the first r rows of a sample (the
// rows that move), with W2 coord_mid's weights and att the gate's kernel:
//   d     = x_i - x_j (float32), rad = |d|^2
//   pre   = silu(wi_i + wj_j + rad * we0 + dist0 * we1)
//   m     = silu(pre @ W2 + b2)
//   g     = m . att, then tanh(g) * coords_range (with tanh)
//   agg_i = sum_k d / (sqrt(rad + 1e-8) + norm_constant) * g * kmask
//   out_i = x_i + agg_i / normalization_factor * update_coords_mask_i
// and out_i = x_i for the rows past r: the sublayer's x + agg, masked and
// padded as EquivariantUpdate builds it, with K1's casts up to the gate,
// the gate and its tanh rounded to the compute dtype, and the translation
// in float (K2's coordinate epilogue, egnn_message.cuh: coord_translate,
// coord_ksum). It reads no radial and no [B, N, K, 3] tensor: each edge's
// difference comes from an f32 gather of x, as in K2's phase D.
//
// Bound on an H100 SXM: at the flagship shape (B=48, N=118, K=12, H=256,
// bf16) K1's 67,968 edges each do a 256x256 product: 2 * 67,968 * 256^2 =
// 8.9 GFLOP, 9.0 us at 989 TFLOP/s, against ~10 MB of inputs and outputs
// (~3 us at 3.35 TB/s). K3 at the joint model's shape (B=64, N=126, every
// row moving, K=12, H=256, float32): 2 * 96,768 * 256^2 = 12.7 GFLOP,
// 0.19 ms at 67 TFLOP/s, against ~9 MB. Both are bound by operations.
//
// Design: a persistent grid of one 512-thread block per SM, capped at the
// number of work units, walks a list of work items in a strided loop. An
// item is R receivers of one sample with all their K edges, R * K <= rows
// (128 rows: R = 10 at K = 12, 576 items at the flagship shape); a last
// round that would leave blocks idle is taken as half items. The plan
// (R, the split, the grid) is egnn_plan.h's edge_plan, which the wrapper
// (ops/egnn_msgpass.py: launch_plan, ops/egnn_coord.py: launch_plan)
// passes in: K1's over every row, K3's over the rows that move. Each item
// runs the message tile of egnn_message.cuh, the same routine as K2's
// message phase: the neighbor indices and edge scalars into shared memory,
// the pair layer gathering wj rows by address, the edge_out product, the
// SiLU epilogue and the per-edge dot (K1's attention gate, K3's coordinate
// gate), and the K-sum in k order inside the block (no atomics; K1 sums
// the H-vector m, K3 the 3-vector translations). bf16 with H <= 256 runs
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
// block_gemm reads it as [in, out]. K3's blocks also copy the rows that do
// not move. With `stamps`, block 0 records its clock at each stage of its
// tiles (StageClock).

#include "egnn_common.cuh"
#include "egnn_message.cuh"
#include "egnn_tiles.cuh"

// The launch's arguments, as the wrappers' ctypes structure lays them out
// (ops/egnn_msgpass.py: _Params).
struct K1Params {
  int dtype;            // 0 float32, 1 bfloat16 (T)
  int mma;              // 1: mma.sync route (bf16, H <= 256); 0: block_gemm
  int coords;           // 0: K1, the message pass; 1: K3, the coordinate update
  const void* wi;       // [B*r, H] T: w_i h of the receivers
  const void* wj;       // [B*N, H] T: w_j h (+ b) of every row
  const long long* idx; // [B*N*K]
  const void* radial;   // [B*N*K] T at element strides s_rad, s_d0, s_km (K3: no radial)
  const void* dist0;
  const void* kmask;
  int s_rad, s_d0, s_km;
  const float* we;      // [2, H] at strides (we_s0, we_s1)
  int we_s0, we_s1;
  const void* w2;       // [H, H] T, edge_out or coord_mid: [out, in] in memory with mma, else [in, out]
  const float* b2;      // [H]
  const float* att;     // [H]: K1's attention kernel (unused without attention), K3's gate
  const float* att_b;   // [1]: K1's attention bias
  int attention;        // K1: the attention gate
  int use_tanh;         // K3: tanh on the gate
  float coords_range, norm_constant;  // K3
  float norm_factor;
  const float* x;       // K3: [B*N, 3]
  const float* ucm;     // K3: [B*N] update_coords_mask, or null
  void* out;            // K1: agg [B*N, H] T; K3: x + agg [B*N, 3] float32
  long long* stamps;    // null, or [kStages + 1] (StageClock)
  int B, N, K, H;
  int Hp;               // the tile's width: H rounded up to 32 (bf16) or 4 (float)
  int r;                // receivers of a sample, its first r rows: K1 N, K3 the rows that move
  int R;                // receivers per item
  int rows;             // rows of the edge tile
  int kc, chunks;       // edges per tile, tiles per item (K = kc when chunks = 1)
  int whole, units;     // items [0, whole) whole, then half items; units of work
  int grid;
};

namespace egnn {

template <typename T, bool kMma, bool kRagged, bool kCoords>
__device__ __forceinline__ void edge_pass(const K1Params& a, unsigned char* smem_raw) {
  using C = Cvt<T>;
  const int H = a.H, Hp = a.Hp, N = a.N, K = a.K, R = a.R, r = a.r;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const TileSmem L(Hp, a.rows, kMma, kBf16, kCoords);
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
  float* ediff = reinterpret_cast<float*>(smem_raw + L.ediff);    // K3
  float* xcarry = reinterpret_cast<float*>(smem_raw + L.xcarry);  // K3

  const T* W2 = static_cast<const T*>(a.w2);
  const T* wi = static_cast<const T*>(a.wi);
  const T* wj = static_cast<const T*>(a.wj);
  const T* radial = static_cast<const T*>(a.radial);
  const T* dist0 = static_cast<const T*>(a.dist0);
  const T* kmask = static_cast<const T*>(a.kmask);
  const float* x = a.x;
  StageClock clk(a.stamps);

  if constexpr (kCoords) {  // the rows that do not move keep their x
    const int still = N - r;
    float* out = static_cast<float*>(a.out);
    for (int p = blockIdx.x * kThreads + threadIdx.x; p < a.B * still * 3;
         p += gridDim.x * kThreads) {
      const int q = p / 3;
      const size_t row = (size_t)(q / still) * N + r + q % still;
      out[row * 3 + p % 3] = x[row * 3 + p % 3];
    }
  }
  // the pair layer's w_e rows, the product's bias and the dot's kernel
  // (K1's attention, K3's gate), w_e and the dot's kernel rounded to T as
  // the JAX kernel casts them, zero past H
  const bool dot = kCoords || a.attention;
  for (int c = threadIdx.x; c < Hp; c += kThreads) {
    const bool in = c < H;
    sm.vec.we0[c] = in ? C::rnd(a.we[(size_t)c * a.we_s1]) : 0.0f;
    sm.vec.we1[c] = in ? C::rnd(a.we[a.we_s0 + (size_t)c * a.we_s1]) : 0.0f;
    sm.vec.b2[c] = in ? a.b2[c] : 0.0f;
    sm.vec.att[c] = in && dot ? C::rnd(a.att[c]) : 0.0f;
  }
  const float att_b = !kCoords && a.attention ? a.att_b[0] : 0.0f;
  const float inv = C::rnd(1.0f / a.norm_factor);
  const int per_sample = (r + R - 1) / R;
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
    int rv = min(R, r - i0);
    take_half(half, i0, rv);
    const size_t row0 = (size_t)b * N + i0;
    for (int ch = 0; ch < a.chunks; ++ch) {
      const int k0 = ch * a.kc;
      const int kc = min(a.kc, K - k0);
      const int E = rv * kc;
      __syncthreads();  // the previous tile is done with shared memory
      clk.tick(kKsum);
      // W2 stays in shared memory for the whole launch
      if constexpr (kMma)
        tiles::use_weights<kRagged>(resident, sm.wsm, sm.ld, reinterpret_cast<const bf16*>(W2),
                                    H, Hp);
      for (int e = threadIdx.x; e < E; e += kThreads) {
        const int q = e / kc;
        const size_t off = (row0 + q) * K + k0 + (e - q * kc);
        const int j = (int)min(max(a.idx[off], 0LL), (long long)N - 1);
        et.eidx[e] = j;
        et.ercv[e] = q;
        et.ekm[e] = C::to_f(kmask[off * a.s_km]);
        if constexpr (kCoords) {
          // the difference from an f32 gather of x and the squared distance
          // in float (the pair layer rounds it to T)
          const float* xs = x + (size_t)b * N * 3;
          float s = 0.0f;
          for (int c = 0; c < 3; ++c) {
            const float d = xs[(i0 + q) * 3 + c] - xs[j * 3 + c];
            ediff[e * 3 + c] = d;
            s += d * d;
          }
          et.erad[e] = s;
        } else {
          et.erad[e] = C::to_f(radial[off * a.s_rad]);
        }
        et.ed0[e] = C::to_f(dist0[off * a.s_d0]);
      }
      __syncthreads();
      clk.tick(kEdgeLoad);
      const T* wrows = wi + ((size_t)b * r + i0) * H;
      if constexpr (kCoords) {
        // m = silu(silu(pair) @ W2 + b2), its gate and each edge's
        // translation, then their sum
        edge_messages<T, kMma, kMma, kRagged, false>(
            sm, wrows, wj + (size_t)b * N * H, W2, true, E, H, Hp, clk, [&](int e, float g) {
              g = C::rnd(g);  // the gate's output in T
              if (a.use_tanh) g = C::rnd(tanhf(g)) * a.coords_range;
              coord_translate(ediff, e, et.erad[e], et.ekm[e], g, a.norm_constant);
            });
        __syncthreads();
        clk.tick(kEpilogue);
        float* out = static_cast<float*>(a.out);
        coord_ksum(ediff, xcarry, rv, kc, ch == 0, ch == a.chunks - 1,
                   [&](int i, int c, float s) {
                     const size_t row = row0 + i;
                     float v = s / a.norm_factor;
                     if (a.ucm != nullptr) v *= a.ucm[row];
                     out[row * 3 + c] = x[row * 3 + c] + v;
                   });
      } else {
        message_tile<T, kMma, kMma, kRagged>(sm, wrows, wj + (size_t)b * N * H, W2, att_b,
                                             a.attention != 0, E, rv, kc, H, Hp, ch == 0,
                                             ch == a.chunks - 1, inv,
                                             static_cast<T*>(a.out) + row0 * H, clk);
      }
    }
  }
  __syncthreads();
  clk.tick(kKsum);
  clk.write();
}

template <typename T, bool kMma, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1) gcl_message_agg_kernel(const K1Params a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  edge_pass<T, kMma, kRagged, false>(a, smem_raw);
}

template <typename T, bool kMma, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1) coord_update_agg_kernel(const K1Params a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  edge_pass<T, kMma, kRagged, true>(a, smem_raw);
}

static int start(void (*kernel)(const K1Params), const K1Params& a, size_t smem,
                 cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kMma, bool kRagged, bool kCoords>
static int launch_as(const K1Params& a, cudaStream_t stream) {
  const size_t smem = TileSmem(a.Hp, a.rows, kMma, std::is_same<T, bf16>::value, kCoords).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  if constexpr (kCoords)
    return start(coord_update_agg_kernel<T, kMma, kRagged>, a, smem, stream);
  else
    return start(gcl_message_agg_kernel<T, kMma, kRagged>, a, smem, stream);
}

// The instantiations this build holds: every one, or with EGNN_VARIANT
// defined only those of one variant (egnn_plan.h: edge_variant: K1's
// regular and ragged widths, then K3's), so that ops/_build.py compiles
// them in parallel, one library each.
#ifdef EGNN_VARIANT
constexpr int kVariant = EGNN_VARIANT;
#else
constexpr int kVariant = -1;
#endif
constexpr bool holds(int v) { return kVariant < 0 || kVariant == v; }

template <typename T, bool kMma, bool kCoords>
static int launch(const K1Params& a, cudaStream_t stream) {
  const int v = edge_variant(a.H, std::is_same<T, bf16>::value, kCoords);
  constexpr int v0 = kCoords ? 2 : 0;
  if constexpr (holds(v0))
    if (v == v0) return launch_as<T, kMma, false, kCoords>(a, stream);
  if constexpr (holds(v0 + 1))
    if (v == v0 + 1) return launch_as<T, kMma, true, kCoords>(a, stream);
  return (int)cudaErrorNotSupported;  // another variant's
}

template <bool kCoords>
static int launch_dtype(const K1Params& a, cudaStream_t s) {
  if (a.dtype == 0) {
    if (a.mma) return (int)cudaErrorInvalidValue;
    return launch<float, false, kCoords>(a, s);
  }
  if (!a.mma) return launch<bf16, false, kCoords>(a, s);
  if (a.Hp > kMmaMaxH || a.rows != kEdgeRows) return (int)cudaErrorInvalidValue;
  return launch<bf16, true, kCoords>(a, s);
}

}  // namespace egnn

// Launches K1 (coords 0) or K3 (coords 1) with the wrapper's arguments and
// plan. Returns a cudaError_t value (0 = ok); cudaErrorInvalidValue for a
// plan or shape the kernel does not take.
extern "C" int egnn_msgpass_launch(const K1Params* p, void* stream) {
  const K1Params& a = *p;
  cudaStream_t s = (cudaStream_t)stream;
  const bool shape_ok = a.B >= 1 && a.N >= 1 && a.K >= 1 && a.r >= 0 && a.r <= a.N &&
                        (a.coords == 1 || a.r == a.N) && (a.coords == 0 || a.coords == 1) &&
                        a.R >= 1 && a.kc >= 1 && a.R * a.kc <= a.rows &&
                        a.rows <= egnn::kEdgeRows && a.chunks * a.kc >= a.K &&
                        (a.chunks == 1 || a.R == 1) && a.grid >= 1 &&
                        a.units >= a.whole && a.whole >= 0 && (a.dtype == 0 || a.dtype == 1) &&
                        a.Hp == egnn::padded_width(a.H, a.dtype == 1);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  return a.coords ? egnn::launch_dtype<true>(a, s) : egnn::launch_dtype<false>(a, s);
}
