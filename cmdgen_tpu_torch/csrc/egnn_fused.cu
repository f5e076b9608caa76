// K2: the whole L-layer EGNN stack over the whole batch in one cooperative
// launch, hand-written for Hopper (sm_90a).
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
// Design: one persistent block per SM (a cooperative grid, capped at the
// largest phase's work-item count) walks the layers in four batch-wide
// phases separated by grid barriers:
//   A. node projections proj = h w_j + b, wia = h w_i, one item per
//      rows-row tile and matrix;
//   B. GCL messages, one item per R receivers x K edges of one sample
//      (R * K <= rows): edge load, pair layer, edge_out product, silu,
//      attention gate and the K-sum into agg, all inside the block (no
//      atomics: the summation order is fixed); a last round that would
//      leave blocks idle is taken in half items (SplitTail);
//   C. node MLP residual and h *= node_mask, one item per rows/2-row
//      tile (the h and agg tiles side by side; the hidden layer stays in
//      shared memory between its two products), then the coordinate
//      projections of the new h from shared memory: coord w_j over the
//      tile, coord w_i stored for its movable rows;
//   D. coordinate pass, one item per R movable receivers of one sample,
//      reading x from one buffer and writing the other (movable rows read
//      their neighbors' x from before the update); rows that do not move
//      are copied times node_mask.
// h (compute dtype), proj, wia, agg ([B*N, H] each, ~2.9 MB in bf16 at the
// flagship shape) and the two x buffers live in global memory, in L2.
// bf16 products up to H = 256 run on the tensor cores by mma.sync from
// shared memory (egnn_tiles.cuh), epilogues straight from the accumulator
// registers: edge_out's and coord_mid's weights are loaded once per phase
// and stay resident beside the 128-row edge tile; the node phases stream
// each matrix through the same buffer in 64-row chunks, the next matrix
// loading while the current one multiplies. float products stay
// exact-float FMAs (block_gemm<float>, weights through a ring of
// shared-memory chunks), and wider bf16 ones stream every matrix through
// WMMA slabs (block_gemm<bf16>), in the same phases.
//
// Shapes (egnn_plan.h: k2_plan, passed in by the wrapper): the tile holds
// `rows` rows (128 on the mma route; on the block_gemm routes the most, a
// multiple of 32, that fits in shared memory beside the products' buffers),
// a node MLP tile half as many; the layout of shared memory is egnn_plan.h's
// TileSmem. A receiver
// with more edges than a tile holds takes them in chunks of kc in phases B
// and D, one receiver an item, its running sums (the K-sum of messages,
// the coordinate pass's translation) carried from chunk to chunk in k
// order. The stack runs at the width H that the wrapper gives it, a
// multiple of 32 (bf16) or 4 (float): a model whose width is not one runs
// with its stacked weights zero-padded once (ops/egnn_fused.py:
// fused_params) and its entry h padded; the padded columns stay zero
// through every layer (silu(0) = 0, zero weights and biases) and are
// dropped on the way out.
#include <cooperative_groups.h>

#include "egnn_common.cuh"
#include "egnn_message.cuh"
#include "egnn_tiles.cuh"

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

constexpr int kPhases = 4;  // per layer

template <typename T>
struct FusedArgs {
  const T* h0;          // [B*N, H] entry h
  const float* x0;      // [B*N, 3] entry x
  const int* idx;       // [B*N, K] neighbor indices within the sample
  const float* kmask;   // [B*N, K]
  const float* dist0;   // [B*N, K]
  const float* nmask;   // [B*N]
  FusedWeights<T> w;
  // workspace, written and read inside the launch: never read through the
  // read-only cache
  T* hw;                // [B*N, H] h after each layer's node MLP
  T* proj;              // [B*N, H] w_j h + b, then coord w_j h + b
  T* wia;               // [B*N, H] w_i h, then coord w_i h (movable rows)
  T* agg;               // [B*N, H] summed messages
  float* xw;            // [2, B*N, 3] x between layers
  float* hout;          // [B*N, H] f32
  float* xout;          // [B*N, 3] f32
  // optional: block 0's clock64() at the start and after each phase's grid
  // barrier, [1 + kPhases * L] (phase p of layer l ends at 1 + kPhases * l + p)
  long long* stamps;
  int B, N, K, H, L, r_true, R;
  int rows;             // rows of a message, coordinate or phase A tile; node tiles: half
  int kc, chunks;       // edges per tile, tiles per receiver (chunks > 1: R = 1)
  float norm_constant, coords_range, norm_factor;
  int use_tanh;
};

// Loads edges [k0, k0 + kc) of receivers [i0, i0 + rv) of one sample
// (E = rv * kc) into shared memory: the clamped neighbor index, the
// receiver within the tile, kmask, dist0 rounded to T, and the squared
// distance from the sample's x (xs) -- rounded to T at every step for the
// GCL (the JAX kernel gathers x in the compute dtype), in float for the
// coordinate pass (which also keeps the difference vectors).
template <typename T>
__device__ void load_edges(const int* idx, const float* kmask,
                           const float* dist0, const float* xs, size_t row0,
                           int i0, int E, int K, int k0, int kc, int N, bool coord_pass,
                           const EdgeTile& et, float* ediff) {
  using C = Cvt<T>;
  int* eidx = et.eidx;
  float *ekm = et.ekm, *ed0 = et.ed0, *erad = et.erad;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int q = e / kc;
    const size_t off = (row0 + q) * K + k0 + (e - q * kc);
    const int i = i0 + q;
    const int j = min(max(idx[off], 0), N - 1);
    eidx[e] = j;
    et.ercv[e] = q;
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

// The work of a phase of n items over the grid's G blocks, with its tail
// split: the last n % G items (all n when n < G), which would run as a
// round that leaves blocks idle, are taken as two halves each when twice as
// many still fit in one round and an item has receivers to split, so that
// round ends sooner. Work unit w < total is item(w, half), half 0 for a
// whole item, 1 or 2 for its first or second half (take_half).
struct SplitTail {
  int whole, total;
  __device__ SplitTail(int n, bool splittable) {
    const int tail = n % (int)gridDim.x;
    const int split = splittable && 2 * tail <= (int)gridDim.x ? tail : 0;
    whole = n - split;
    total = n + split;
  }
  __device__ int item(int w, int& half) const {
    if (w < whole) {
      half = 0;
      return w;
    }
    half = 1 + (w - whole) % 2;
    return whole + (w - whole) / 2;
  }
};

// Copies `rows` rows of a [*, H] array in T into dst (row stride ld) by
// 16-byte cp.async, committed as one group: dst row m takes src row
// row_of(m) for m < valid and row row_of(valid - 1) after it.
template <typename T, typename RowOf>
__device__ void load_rows(T* dst, int ld, const T* src, int H, int rows, int valid,
                          RowOf row_of) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = H / kVec;
  for (int p = threadIdx.x; p < rows * per_row; p += kThreads) {
    const int m = p / per_row, q = p % per_row;
    const size_t g = row_of(min(m, valid - 1));
    __pipeline_memcpy_async(dst + (size_t)m * ld + q * kVec, src + g * H + q * kVec, 16);
  }
  __pipeline_commit();
}

template <typename T, bool kMma, bool kRagged, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
egnn_fused_kernel(const FusedArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using C = Cvt<T>;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int H = a.H, N = a.N, K = a.K, R = a.R, r = a.r_true;
  // rows of an edge / A tile and of a node tile: 128 and 64 on the mma
  // route and for float at H <= 256 (the regular float instantiation)
  constexpr bool kFullTile = kMma || (std::is_same<T, float>::value && !kRagged);
  const int erows = kFullTile ? 128 : a.rows, nrows = erows / 2;
  // tiles per receiver in phases B and D: one (all K edges) unless
  // kChunked; a chunk loop compiled beside the one-tile path costs the
  // whole kernel a few percent, so the regular instantiations have both
  const int chunks = kChunked ? a.chunks : 1;
  const TileSmem S(H, erows, kMma, std::is_same<T, bf16>::value, true);
  T* abuf = reinterpret_cast<T*>(smem_raw + S.buf);
  float* ediff = reinterpret_cast<float*>(smem_raw + S.ediff);
  float* xcarry = reinterpret_cast<float*>(smem_raw + S.xcarry);
  bf16* wsm = reinterpret_cast<bf16*>(smem_raw + S.wsm);
  float* part = reinterpret_cast<float*>(smem_raw + S.part);
  const int ld = H + row_pad<T>();  // row stride of the tiles

  // the block_gemm routes' buffers: the float weight ring, or the bf16
  // staging tiles and weight slabs
  const GemmSmem gs{reinterpret_cast<float*>(smem_raw + S.gemm),
                    reinterpret_cast<bf16*>(smem_raw + S.gemm + 4 * kWarps * 256),
                    reinterpret_cast<float*>(smem_raw + S.gemm)};
  const bf16* resident = nullptr;       // the weight matrix wsm holds
  // the message and coordinate tiles (egnn_message.cuh)
  MsgSmem<T> sm;
  sm.buf = abuf;
  sm.ld = ld;
  sm.rows = erows;
  sm.wsm = wsm;
  sm.part = part;
  sm.gs = gs;
  float* vec = reinterpret_cast<float*>(smem_raw + S.vec);
  sm.vec = GclVecs{vec, vec + H, vec + 2 * H, vec + 3 * H};
  sm.carry = reinterpret_cast<float*>(smem_raw + S.carry);
  EdgeTile& et = sm.et;
  et.eidx = reinterpret_cast<int*>(smem_raw + S.eidx);
  et.ercv = reinterpret_cast<int*>(smem_raw + S.ercv);
  et.ekm = reinterpret_cast<float*>(smem_raw + S.ekm);
  et.erad = reinterpret_cast<float*>(smem_raw + S.erad);
  et.ed0 = reinterpret_cast<float*>(smem_raw + S.ed0);
  et.escale = reinterpret_cast<float*>(smem_raw + S.escale);
  float* const ekm = et.ekm;
  float* const erad = et.erad;
  StageClock no_clock(nullptr);
  // a phase's pair-MLP vectors into sm.vec (the first item's barrier
  // orders them before their use)
  auto use_vecs = [&](const T* we, const float* b2, const T* att) {
    for (int c = threadIdx.x; c < H; c += kThreads) {
      sm.vec.we0[c] = C::to_f(we[c]);
      sm.vec.we1[c] = C::to_f(we[H + c]);
      if (b2 != nullptr) sm.vec.b2[c] = b2[c];
      if (att != nullptr) sm.vec.att[c] = C::to_f(att[c]);
    }
  };

  T* const tile2 = abuf + (size_t)nrows * ld;      // second node tile
  const int BN = a.B * N;
  const int tiles = cdiv(BN, nrows);               // node MLP tiles
  const int wtiles = cdiv(BN, erows);              // A tiles
  const int tps = cdiv(N, R);                      // message items per sample
  const int cps = cdiv(r, R);                      // coordinate items per sample
  const T* none = nullptr;
  const bool stamp = a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) a.stamps[0] = clock64();
  auto phase_end = [&](int i) {
    grid.sync();
    if (stamp) a.stamps[i] = clock64();
  };
  auto all_rows = [](int row0) {
    return [row0](int m) { return (size_t)(row0 + m); };
  };

  for (int l = 0; l < a.L; ++l) {
    const size_t oHH = (size_t)l * H * H, oH = (size_t)l * H;
    const bool last = l == a.L - 1;
    const T* h_in = l == 0 ? a.h0 : a.hw;
    const float* x_in = l == 0 ? a.x0 : a.xw + (size_t)((l + 1) & 1) * BN * 3;
    float* x_out = last ? a.xout : a.xw + (size_t)(l & 1) * BN * 3;

    // ---- A: proj = h w_j + b and wia = h w_i over every row
    for (int it = blockIdx.x; it < 2 * wtiles; it += gridDim.x) {
      const int row0 = (it % wtiles) * erows;
      const int rows = min(erows, BN - row0);
      const float* bias = a.w.wjb + oH;
      __syncthreads();
      load_rows(abuf, ld, h_in, H, erows, rows, all_rows(row0));
      if constexpr (kMma) {
        tiles::use_weights(resident, wsm, ld, (it < wtiles ? a.w.wj : a.w.wi) + oHH, H);
        tiles::Acc<2> acc;
        acc.zero();
        tiles::mma_streamed<2>(acc, abuf, ld, wsm, ld, H, resident, nullptr);
        T* out = it < wtiles ? a.proj : a.wia;
        const bool with_bias = it < wtiles;
        tiles::for_each_pair<2>(acc, H, [&](int m, int n, float v0, float v1) {
          if (m < rows) {
            if (with_bias) {
              v0 += bias[n];
              v1 += bias[n + 1];
            }
            store2(out + (size_t)(row0 + m) * H + n, v0, v1);
          }
        });
        continue;
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      if (it < wtiles) {
        block_gemm<T, kRagged>(abuf, ld, a.w.wj + oHH, none, 0, none, rows, H, gs,
                      [&](int m, int n, float acc) {
                        a.proj[(size_t)(row0 + m) * H + n] = C::from_f(acc + bias[n]);
                      });
      } else {
        block_gemm<T, kRagged>(abuf, ld, a.w.wi + oHH, none, 0, none, rows, H, gs,
                      [&](int m, int n, float acc) {
                        a.wia[(size_t)(row0 + m) * H + n] = C::from_f(acc);
                      });
      }
    }
    phase_end(1 + kPhases * l + 0);  // A

    // ---- B: messages of R receivers of one sample into agg
    use_vecs(a.w.we + 2 * oH, a.w.w2b + oH, a.w.att + oH);
    const float inv = C::rnd(1.0f / a.norm_factor);
    const SplitTail msg_items(a.B * tps, R >= 2);
    for (int w = blockIdx.x; w < msg_items.total; w += gridDim.x) {
      int half;
      const int it = msg_items.item(w, half);
      const size_t nb = (size_t)(it / tps) * N;
      int i0 = (it % tps) * R;
      int rv = min(R, N - i0);
      take_half(half, i0, rv);
      // the item's receivers' edges in chunks of kc, in k order (one chunk
      // where K fits in a tile)
      for (int ch = 0; ch < chunks; ++ch) {
        const int k0 = kChunked ? ch * a.kc : 0;
        const int kc = kChunked ? min(a.kc, K - k0) : K;
        const bool first = ch == 0, last = ch == chunks - 1;
        const int E = rv * kc;
        __syncthreads();
        // edge_out's weights stay in shared memory for the whole phase
        if constexpr (kMma) tiles::use_weights(resident, wsm, ld, a.w.w2 + oHH, H);
        load_edges<T>(a.idx, a.kmask, a.dist0, x_in + nb * 3, nb + i0, i0, E, K, k0, kc, N,
                      false, et, ediff);
        __syncthreads();
        message_tile<T, kMma, false, kRagged>(sm, a.wia + (nb + i0) * H, a.proj + nb * H,
                                              a.w.w2 + oHH, a.w.attb[l], true, E, rv, kc, H, H,
                                              first, last, inv, a.agg + (nb + i0) * H,
                                              no_clock);
      }
    }
    phase_end(1 + kPhases * l + 1);  // B

    // ---- C: node MLP residual, then the coordinate projections of the new
    // h: proj = h coord_w_j + b, and wia = h coord_w_i on the movable rows
    // (row g moves when g % N < r)
    for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
      const int row0 = it * nrows;
      const int rows = min(nrows, BN - row0);
      const float* nib = a.w.nib + oH;
      const float* nob = a.w.nob + oH;
      const float* cwjb = a.w.cwjb + oH;
      auto moves = [&](int m) { return m < rows && (row0 + m) % N < r; };
      __syncthreads();
      load_rows(abuf, ld, h_in, H, nrows, rows, all_rows(row0));
      load_rows(tile2, ld, a.agg, H, nrows, rows, all_rows(row0));
      if constexpr (kMma) {
        // node_in's halves, node_out, coord w_j and coord w_i stream through
        // wsm, each loading while the one before it multiplies
        const T* cwi = r > 0 ? a.w.cwi + oHH : nullptr;
        tiles::use_weights(resident, wsm, ld, a.w.nih + oHH, H);
        tiles::Acc<1> acc;
        acc.zero();
        tiles::mma_streamed<1>(acc, abuf, ld, wsm, ld, H, resident, a.w.nia + oHH);
        tiles::mma_streamed<1>(acc, tile2, ld, wsm, ld, H, resident, a.w.no + oHH);
        // the hidden layer replaces the h tile, which only node_in read
        tiles::for_each_pair<1>(acc, H, [&](int m, int n, float v0, float v1) {
          store2(abuf + (size_t)m * ld + n, silu_c<T>(C::rnd(v0 + nib[n])),
                 silu_c<T>(C::rnd(v1 + nib[n + 1])));
        });
        acc.zero();
        tiles::mma_streamed<1>(acc, abuf, ld, wsm, ld, H, resident, a.w.cwj + oHH);
        // the new h, also into the agg tile, which only node_in read
        tiles::for_each_pair<1>(acc, H, [&](int m, int n, float v0, float v1) {
          const size_t g = (size_t)(row0 + min(m, rows - 1)) * H + n;
          const float nm = a.nmask[row0 + min(m, rows - 1)];
          const float2 hv = load2(h_in + g);
          const float h0 = C::rnd(C::rnd(hv.x + C::rnd(v0 + nob[n])) * nm);
          const float h1 = C::rnd(C::rnd(hv.y + C::rnd(v1 + nob[n + 1])) * nm);
          store2(tile2 + (size_t)m * ld + n, h0, h1);
          if (m < rows) {
            store2(a.hw + g, h0, h1);
            if (last) store2(a.hout + g, h0, h1);
          }
        });
        acc.zero();
        tiles::mma_streamed<1>(acc, tile2, ld, wsm, ld, H, resident, cwi);
        tiles::for_each_pair<1>(acc, H, [&](int m, int n, float v0, float v1) {
          if (m < rows)
            store2(a.proj + (size_t)(row0 + m) * H + n, v0 + cwjb[n], v1 + cwjb[n + 1]);
        });
        if (r == 0) continue;
        acc.zero();
        tiles::mma_streamed<1>(acc, tile2, ld, wsm, ld, H, resident, nullptr);
        tiles::for_each_pair<1>(acc, H, [&](int m, int n, float v0, float v1) {
          if (moves(m)) store2(a.wia + (size_t)(row0 + m) * H + n, v0, v1);
        });
        continue;
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      block_gemm<T, kRagged>(abuf, ld, a.w.nih + oHH, tile2, ld, a.w.nia + oHH, rows, H, gs,
                    [&](int m, int n, float acc) {
                      tile2[(size_t)m * ld + n] = C::from_f(silu_c<T>(C::rnd(acc + nib[n])));
                    });
      // the new h replaces the hidden layer row by row, after the product
      // has read those rows
      block_gemm<T, kRagged>(tile2, ld, a.w.no + oHH, none, 0, none, rows, H, gs,
                    [&](int m, int n, float acc) {
                      const size_t g = (size_t)(row0 + m) * H + n;
                      const float hv = C::rnd(C::to_f(h_in[g]) + C::rnd(acc + nob[n]));
                      const T hn = C::from_f(hv * a.nmask[row0 + m]);
                      tile2[(size_t)m * ld + n] = hn;
                      a.hw[g] = hn;
                      if (last) a.hout[g] = C::to_f(hn);
                    });
      block_gemm<T, kRagged>(tile2, ld, a.w.cwj + oHH, none, 0, none, rows, H, gs,
                    [&](int m, int n, float acc) {
                      a.proj[(size_t)(row0 + m) * H + n] = C::from_f(acc + cwjb[n]);
                    });
      if (r == 0) continue;
      block_gemm<T, kRagged>(tile2, ld, a.w.cwi + oHH, none, 0, none, rows, H, gs,
                    [&](int m, int n, float acc) {
                      if (moves(m)) a.wia[(size_t)(row0 + m) * H + n] = C::from_f(acc);
                    });
    }
    phase_end(1 + kPhases * l + 2);  // C

    // ---- D: coordinate pass of R movable receivers of one sample
    const int still = N - r;
    for (int p = blockIdx.x * kThreads + threadIdx.x; p < a.B * still * 3;
         p += gridDim.x * kThreads) {
      const int q = p / 3;
      const size_t row = (size_t)(q / still) * N + r + q % still;
      x_out[row * 3 + p % 3] = x_in[row * 3 + p % 3] * a.nmask[row];
    }
    const T* cg = a.w.cg + oH;
    const float* cmb = a.w.cmb + oH;
    use_vecs(a.w.cwe + 2 * oH, nullptr, nullptr);
    const SplitTail coord_items(a.B * cps, R >= 2);
    for (int w = blockIdx.x; w < coord_items.total; w += gridDim.x) {
      int half;
      const int it = coord_items.item(w, half);
      const size_t nb = (size_t)(it / cps) * N;
      int i0 = (it % cps) * R;
      int rv = min(R, r - i0);
      take_half(half, i0, rv);
      // the item's receivers' edges in chunks of kc, in k order (one chunk
      // where K fits in a tile)
      for (int ch = 0; ch < chunks; ++ch) {
        const int k0 = kChunked ? ch * a.kc : 0;
        const int kc = kChunked ? min(a.kc, K - k0) : K;
        const bool first = ch == 0, last = ch == chunks - 1;
        const int E = rv * kc;
        __syncthreads();
        // coord_mid's weights stay in shared memory for the whole phase
        if constexpr (kMma) tiles::use_weights(resident, wsm, ld, a.w.cm + oHH, H);
        load_edges<T>(a.idx, a.kmask, a.dist0, x_in + nb * 3, nb + i0, i0, E, K, k0, kc, N,
                      true, et, ediff);
        __syncthreads();
        pair_layer<T, kRagged>(a.wia + (nb + i0) * H, a.proj + nb * H, sm.vec, et, E, H, H,
                               abuf, ld);
        // edge e's gate g = silu(buf @ coord_mid + b) . coord_gate, into its
        // translation ediff[e] (times kmask, over the normalised distance)
        auto translate = [&](int e, float g) {
          if (a.use_tanh) g = tanhf(g) * a.coords_range;
          coord_translate(ediff, e, erad[e], ekm[e], g, a.norm_constant);
        };
        if constexpr (kMma) {
          __pipeline_wait_prior(0);
          __syncthreads();
          tiles::Acc<2> acc;
          acc.zero();
          tiles::mma_tile<2>(acc, abuf, ld, wsm, ld, H);
          tiles::row_partials<2>(acc, H, part, erows, [&](int m, int n, float v0, float v1) {
            if (m >= E) return 0.0f;
            return silu_c<T>(C::rnd(v0 + cmb[n])) * C::to_f(cg[n]) +
                   silu_c<T>(C::rnd(v1 + cmb[n + 1])) * C::to_f(cg[n + 1]);
          });
          __syncthreads();
          for (int e = threadIdx.x; e < E; e += kThreads) {
            float g = part[e];
            for (int w = 1; w < tiles::kWarpCols; ++w) g += part[w * erows + e];
            translate(e, g);
          }
        } else {
          __syncthreads();
          block_gemm<T, kRagged>(abuf, ld, a.w.cm + oHH, none, 0, none, E, H, gs,
                                 [&](int m, int n, float acc) {
                                   abuf[(size_t)m * ld + n] =
                                       C::from_f(silu_c<T>(C::rnd(acc + cmb[n])));
                                 });
          const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
          for (int e = warp; e < E; e += kWarps) {
            float g = 0.0f;
            for (int c = lane; c < H; c += 32)
              g = fmaf(C::to_f(abuf[(size_t)e * ld + c]), C::to_f(cg[c]), g);
            g = warp_sum(g);
            if (lane == 0) translate(e, g);
          }
        }
        __syncthreads();
        // each receiver's translations summed in k order, carried from one
        // chunk to the next (one receiver an item when chunked)
        coord_ksum(ediff, xcarry, rv, kc, first, last, [&](int i, int c, float s) {
          const size_t row = nb + i0 + i;
          x_out[row * 3 + c] = (x_in[row * 3 + c] + s / a.norm_factor) * a.nmask[row];
        });
      }
    }
    phase_end(1 + kPhases * l + 3);  // D
  }
}

template <typename T, bool kMma, bool kRagged, bool kChunked>
static int launch(const FusedArgs<T>& a, int max_items, cudaStream_t stream, int* grid_out) {
  const bool shape_ok = a.B >= 1 && a.N >= 1 && a.K >= 1 && a.L >= 1 && a.R >= 1 &&
                        a.kc >= 1 && a.R * a.kc <= a.rows && a.chunks * a.kc >= a.K &&
                        (a.chunks == 1 || a.R == 1) && a.rows % 32 == 0 &&
                        a.rows <= kEdgeRows && (!kMma || a.rows == kEdgeRows) &&
                        (!std::is_same<T, float>::value || kRagged || a.rows == kEdgeRows) &&
                        (kChunked || a.chunks == 1) &&
                        a.H == padded_width(a.H, std::is_same<T, bf16>::value) &&
                        (!kMma || a.H <= kMmaMaxH);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  const size_t smem = TileSmem(a.H, a.rows, kMma, std::is_same<T, bf16>::value, true).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      egnn_fused_kernel<T, kMma, kRagged, kChunked>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, egnn_fused_kernel<T, kMma, kRagged, kChunked>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = max(1, min(sms * per_sm, max_items));
  grid_out[0] = blocks;
  grid_out[1] = per_sm;
  grid_out[2] = (int)smem;
  FusedArgs<T> args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(egnn_fused_kernel<T, kMma, kRagged, kChunked>, dim3(blocks), dim3(kThreads),
                                    params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiations this build holds: every one, or with EGNN_VARIANT
// defined only the one of that number (egnn_plan.h: k2_variant), so that
// ops/_build.py compiles them in parallel, one library each.
#ifdef EGNN_VARIANT
constexpr int kVariant = EGNN_VARIANT;
#else
constexpr int kVariant = -1;
#endif
constexpr bool holds(int v) { return kVariant < 0 || kVariant == v; }

template <typename T>
static int launch_typed(int mma, const void* h0, const void* x0, const void* idx,
                        const void* kmask, const void* dist0, const void* nmask,
                        const void* const* wp, void* work, void* coords,
                        void* hout, void* xout, int B, int N, int K, int H,
                        int L, int r_true, int R, int rows, int kc, int chunks,
                        int max_items, float norm_constant, float coords_range,
                        float norm_factor, int use_tanh, void* stamps,
                        cudaStream_t stream, int* grid_out) {
  FusedArgs<T> a;
  a.h0 = (const T*)h0;
  a.x0 = (const float*)x0;
  a.idx = (const int*)idx;
  a.kmask = (const float*)kmask;
  a.dist0 = (const float*)dist0;
  a.nmask = (const float*)nmask;
  FusedWeights<T>& w = a.w;
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
  const size_t plane = (size_t)B * N * H;
  a.hw = (T*)work;
  a.proj = a.hw + plane;
  a.wia = a.proj + plane;
  a.agg = a.wia + plane;
  a.xw = (float*)coords;
  a.hout = (float*)hout;
  a.xout = (float*)xout;
  a.stamps = (long long*)stamps;
  a.B = B;
  a.N = N;
  a.K = K;
  a.H = H;
  a.L = L;
  a.r_true = r_true;
  a.R = R;
  a.rows = rows;
  a.kc = kc;
  a.chunks = chunks;
  a.norm_constant = norm_constant;
  a.coords_range = coords_range;
  a.norm_factor = norm_factor;
  a.use_tanh = use_tanh;
  if (mma && !std::is_same<T, bf16>::value) return (int)cudaErrorInvalidValue;
  switch (k2_variant(std::is_same<T, bf16>::value, mma != 0, H, chunks > 1)) {
    case 0:
      if constexpr (holds(0) && !std::is_same<T, bf16>::value)
        return launch<T, false, false, false>(a, max_items, stream, grid_out);
      break;
    case 1:
      if constexpr (holds(1) && !std::is_same<T, bf16>::value)
        return launch<T, false, true, true>(a, max_items, stream, grid_out);
      break;
    case 2:
      if constexpr (holds(2) && std::is_same<T, bf16>::value)
        return launch<T, true, false, false>(a, max_items, stream, grid_out);
      break;
    case 3:
      if constexpr (holds(3) && std::is_same<T, bf16>::value)
        return launch<T, false, false, true>(a, max_items, stream, grid_out);
      break;
    case 4:
      if constexpr (holds(4) && !std::is_same<T, bf16>::value)
        return launch<T, false, false, true>(a, max_items, stream, grid_out);
      break;
    case 5:
      if constexpr (holds(5) && std::is_same<T, bf16>::value)
        return launch<T, true, false, true>(a, max_items, stream, grid_out);
      break;
  }
  return (int)cudaErrorNotSupported;  // another variant's
}

}  // namespace egnn

// dtype: 0 = float32, 1 = bfloat16; mma: 1 for the mma.sync route (bf16,
// H <= 256, rows = 128), 0 for block_gemm. weights: the 20 device pointers
// of FusedWeights, in its order, at width H. work: [4, B*N, H] in the
// compute dtype (h, proj, wia, agg); coords: [2, B*N, 3] float. H: the
// stack's width, a multiple of 32 (bf16) or 4 (float), at most 1024. R:
// receivers per message tile, rows: rows of a tile (a multiple of 32, at
// most 128), kc: edges per tile and chunks: tiles per receiver (R * kc <=
// rows; chunks > 1 only with R = 1); max_items: the largest phase's
// work-item count, which caps the grid. stamps: null, or [1 + 4 * L] int64
// for block 0's clock at the start and at the end of each phase. grid_out
// receives the grid launched: blocks, blocks per SM, dynamic shared memory
// per block. Returns a cudaError_t value (0 = ok).
extern "C" int egnn_fused_launch(int dtype, int mma, const void* h0, const void* x0,
                                 const void* idx, const void* kmask,
                                 const void* dist0, const void* nmask,
                                 const void* const* weights, void* work,
                                 void* coords, void* hout, void* xout, int B,
                                 int N, int K, int H, int L, int r_true, int R,
                                 int rows, int kc, int chunks,
                                 int max_items, float norm_constant,
                                 float coords_range, float norm_factor,
                                 int use_tanh, void* stamps, void* stream,
                                 int* grid_out) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return egnn::launch_typed<float>(mma, h0, x0, idx, kmask, dist0, nmask, weights,
                                     work, coords, hout, xout, B, N, K, H, L,
                                     r_true, R, rows, kc, chunks, max_items, norm_constant,
                                     coords_range, norm_factor, use_tanh,
                                     stamps, s, grid_out);
  if (dtype == 1)
    return egnn::launch_typed<egnn::bf16>(mma, h0, x0, idx, kmask, dist0, nmask,
                                          weights, work, coords, hout, xout, B,
                                          N, K, H, L, r_true, R, rows, kc, chunks, max_items,
                                          norm_constant, coords_range,
                                          norm_factor, use_tanh, stamps, s,
                                          grid_out);
  return (int)cudaErrorInvalidValue;
}
