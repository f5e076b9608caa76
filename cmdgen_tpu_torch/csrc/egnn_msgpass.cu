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
// Design: the tiles hold only the live slots of the neighbor list (kmask
// non-zero). A masked slot adds m * 0 to K1's K-sum and a translation
// times 0 to K3's, which leaves a float sum as it is, and every row of a
// product is computed apart from the tile's other rows, so leaving the
// masked slots out and packing several receivers' live edges into a tile
// gives the same values (a receiver with no live slot sums to +0). A
// pre-pass (edge_worklist_kernel, one block a sample, in the same stream
// and graph) builds a work list at every launch: each receiver's live k in
// k order, and items of consecutive receivers of one sample, kept whole,
// whose live edges fit in `cap` rows (the plan's: the tile's rows, or half
// of them where a float launch fits in one round of full tiles); a
// receiver with more than `cap` live edges is an item alone. A persistent
// grid of one 512-thread block per SM, capped at the most items there can
// be, walks the items of every sample in a strided loop (each block scans
// the samples' item counts to find an item's sample). The plan (the width,
// the route, the rows, the cap, the list's size, the grid) is
// egnn_plan.h's edge_plan, which the wrapper (ops/egnn_msgpass.py:
// launch_plan, ops/egnn_coord.py: launch_plan) passes in: K1's over every
// row, K3's over the rows that move. Each tile loads its edges' neighbor
// indices and scalars into shared memory and runs K2's message routine
// (egnn_message.cuh: edge_messages): the pair layer gathering wj rows by
// address, the edge_out product, the SiLU epilogue and the per-edge dot
// (K1's attention gate, K3's coordinate gate); then the K-sum in k order
// inside the block over each receiver's edges of the tile (no atomics; K1
// sums the H-vector m, ksum_ragged, K3 the 3-vector translations,
// coord_ksum_ragged). bf16 with H <= 256 runs the product on mma.sync with
// W2 loaded into shared memory once per block and launch (135 KB at H =
// 256) and epilogues from the accumulators; float keeps exact-float FMAs
// (block_gemm, W2 streamed through a ring of shared-memory chunks; a tile
// of M rows takes M / 64 passes at H = 256), and bf16 wider than 256
// streams W2 through WMMA slabs (block_gemm). A receiver with more than
// `cap` live edges takes them in chunks, its running K-sum carried from
// one to the next. Any H from 1 to 1024: the tile computes at Hp, H
// rounded up to 32 (bf16) or 4 (float), with zero columns in shared
// memory only (egnn_message.cuh); the inputs
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
  int* list;            // the work list's buffer, WorkList(B, r, K).ints int32 (egnn_plan.h)
  long long* edge_rows; // null, or [2]: adds the live edges taken and the B * r * K slots
  int B, N, K, H;
  int Hp;               // the tile's width: H rounded up to 32 (bf16) or 4 (float)
  int r;                // receivers of a sample, its first r rows: K1 N, K3 the rows that move
  int rows;             // rows of the edge tile
  int cap;              // edges of a work item at most (<= rows)
  int grid;
};

namespace egnn {

// The work list's arrays in the launch's buffer (egnn_plan.h: WorkList).
struct ListPtrs {
  int4* items;
  int *slots, *poff, *sample_items;
  __device__ explicit ListPtrs(const K1Params& a) {
    const WorkList L(a.B, a.r, a.K);
    items = reinterpret_cast<int4*>(a.list + L.items);
    slots = a.list + L.slots;
    poff = a.list + L.poff;
    sample_items = a.list + L.sample_items;
  }
};

// Inclusive scan of one value a thread over the block (warp shuffles, then
// the warps' totals through part [kWarps]); total: the block's sum. Every
// thread calls it; it ends with a barrier after its last read of part.
__device__ int block_scan(int x, int* part, int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 1; o < 32; o *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? part[lane] : 0;
    for (int o = 1; o < kWarps; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) part[lane] = w;
  }
  __syncthreads();
  x += warp ? part[warp - 1] : 0;
  total = part[kWarps - 1];
  __syncthreads();
  return x;
}

// Exclusive scan of v[0, n) in place by the block, kThreads at a time;
// returns the total. Every thread calls it.
__device__ int block_exclusive_scan(int* v, int n, int* part) {
  const int t = threadIdx.x;
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int x = c0 + t < n ? v[c0 + t] : 0;
    int total;
    const int s = block_scan(x, part, total);
    if (c0 + t < n) v[c0 + t] = carry + s - x;
    carry += total;
  }
  return carry;
}

// The pre-pass: one block a sample, before K1 or K3 in the same stream.
// 1. Each thread takes a receiver's K slots, 16 loads in flight at a time,
//    and keeps its live k (kmask non-zero) in k order, and their count.
// 2. The counts' exclusive scan, each receiver's first live edge among its
//    sample's (poff), and for each receiver i the end of the item it would
//    open: the most receivers from i, at most `cap`, whose live edges fit
//    in `cap` (a binary search of the scan), or i + 1 where i alone has
//    more.
// 3. The items follow those ends from receiver 0, receivers kept whole:
//    item t starts at end applied t times to 0, which each thread finds
//    from the ends doubled (jump[l][i], 2**l items on from i) in log2(r)
//    steps. egnn_plan.h: item_chunks takes an item of more than `cap`
//    edges in chunks. A receiver with no live edge joins an item too, whose
//    K-sum writes its output.
// The launch's live edges and slots go to the counter where there is one.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) edge_worklist_kernel(const K1Params a) {
  constexpr int kBatch = 16;
  extern __shared__ int smem_list[];  // egnn_plan.h: worklist_smem
  __shared__ int part[kWarps];
  const ListPtrs L(a);
  const T* kmask = static_cast<const T*>(a.kmask);
  const int b = blockIdx.x, r = a.r, K = a.K, cap = a.cap;
  const int levels = worklist_levels(r);
  int* count = smem_list;          // [r + 1]: live counts, then their scan
  int* jump = smem_list + r + 1;   // [levels][r + 1]
  const T* sample = kmask + (size_t)b * a.N * K * a.s_km;
  for (int i = threadIdx.x; i < r; i += kThreads) {
    const T* km = sample + (size_t)i * K * a.s_km;
    int* slots = L.slots + ((size_t)b * r + i) * K;
    int c = 0;
    for (int k0 = 0; k0 < K; k0 += kBatch) {
      float v[kBatch];  // every load of the batch issued before any is used
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = Cvt<T>::to_f(km[(size_t)min(k0 + u, K - 1) * a.s_km]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + u < K && v[u] != 0.0f) slots[c++] = k0 + u;
    }
    count[i] = c;
  }
  __syncthreads();
  const int live = block_exclusive_scan(count, r, part);
  if (threadIdx.x == 0) count[r] = live;
  __syncthreads();
  for (int i = threadIdx.x; i <= r; i += kThreads) {
    int lo = i + 1;  // the last j <= i + cap with count[j] - count[i] <= cap
    if (i == r) {
      lo = r;
    } else {
      L.poff[(size_t)b * r + i] = count[i];
      if (count[i + 1] - count[i] <= cap) {
        int hi = min(r, i + cap);
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (count[mid] - count[i] <= cap)
            lo = mid;
          else
            hi = mid - 1;
        }
      }
    }
    jump[i] = lo;
  }
  for (int l = 1; l < levels; ++l) {
    __syncthreads();
    const int* from = jump + (l - 1) * (r + 1);
    for (int i = threadIdx.x; i <= r; i += kThreads) jump[l * (r + 1) + i] = from[from[i]];
  }
  __syncthreads();
  int4* items = L.items + (size_t)b * r;
  for (int t = threadIdx.x; t < r; t += kThreads) {
    int i = 0;
    for (int l = 0; l < levels && i < r; ++l)
      if ((t >> l) & 1) i = jump[l * (r + 1) + i];
    if (i >= r) continue;
    const int j = jump[i];
    items[t] = make_int4(b, i, j - i, count[j] - count[i]);
    if (j >= r) L.sample_items[b] = t + 1;  // the last item
  }
  if (r == 0 && threadIdx.x == 0) L.sample_items[b] = 0;
  if (a.edge_rows != nullptr && threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.edge_rows), (unsigned long long)live);
    if (b == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.edge_rows + 1),
                (unsigned long long)a.B * r * K);
  }
}

// The receiver of edge e in a tile: the last q < rv whose first edge
// eoff[q] is at most e (receivers with no edge in the tile share their
// first edge with the next).
__device__ __forceinline__ int tile_receiver(const int* eoff, int rv, int e) {
  int lo = 0, hi = rv - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (eoff[mid] <= e)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <typename T, bool kMma, bool kRagged, bool kCoords>
__device__ __forceinline__ void edge_pass(const K1Params& a, unsigned char* smem_raw) {
  using C = Cvt<T>;
  const int H = a.H, Hp = a.Hp, N = a.N, K = a.K, r = a.r;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const TileSmem L(Hp, a.rows, kMma, kBf16, kCoords, true);
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
  int* eoff = reinterpret_cast<int*>(smem_raw + L.eoff);          // [rv + 1]
  int* iscan = reinterpret_cast<int*>(smem_raw + L.iscan);  // [kThreads + kWarps]

  const T* W2 = static_cast<const T*>(a.w2);
  const T* wi = static_cast<const T*>(a.wi);
  const T* wj = static_cast<const T*>(a.wj);
  const T* radial = static_cast<const T*>(a.radial);
  const T* dist0 = static_cast<const T*>(a.dist0);
  const T* kmask = static_cast<const T*>(a.kmask);
  const float* x = a.x;
  const ListPtrs list(a);
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
  const bf16* resident = nullptr;  // what sm.wsm holds

  // item w of the list -> (sample, receivers, chunks of their live edges):
  // the samples' item counts scanned kThreads samples at a time, the item's
  // sample found in the scan; the tests walk the list the same way
  // (tests/test_torch_egnn_msgpass.py: plan_tiles), so a change here is
  // made there too
  int w = blockIdx.x, first_item = 0;
  for (int b0 = 0; b0 < a.B; b0 += kThreads) {
    __syncthreads();  // every thread is done with the previous samples' scan
    int items;
    iscan[threadIdx.x] = block_scan(
        b0 + (int)threadIdx.x < a.B ? list.sample_items[b0 + threadIdx.x] : 0, iscan + kThreads,
        items);
    __syncthreads();
    for (; w < first_item + items; w += gridDim.x) {
      int lo = 0, hi = kThreads - 1;  // the first sample whose scan passes w
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (iscan[mid] > w - first_item)
          hi = mid;
        else
          lo = mid + 1;
      }
      const int b = b0 + lo;
      const int4 item = list.items[(size_t)b * r + (w - first_item) - (lo ? iscan[lo - 1] : 0)];
      const int i0 = item.y, rv = item.z, live = item.w;
      const int chunks = item_chunks(live, a.cap);
      const int kc = cdiv(live, chunks);
      const size_t row0 = (size_t)b * N + i0;   // the first receiver's row
      const size_t rcv0 = (size_t)b * r + i0;   // ... and its place in the list
      for (int ch = 0; ch < chunks; ++ch) {
        const int t0 = ch * kc;
        const int E = min(kc, live - t0);
        __syncthreads();  // the previous tile is done with shared memory
        clk.tick(kKsum);
        // W2 stays in shared memory for the whole launch
        if constexpr (kMma)
          tiles::use_weights<kRagged>(resident, sm.wsm, sm.ld, reinterpret_cast<const bf16*>(W2),
                                      H, Hp);
        for (int q = threadIdx.x; q <= rv; q += kThreads)
          eoff[q] = q == rv ? E : chunks > 1 ? 0 : list.poff[rcv0 + q] - list.poff[rcv0];
        __syncthreads();
        for (int e = threadIdx.x; e < E; e += kThreads) {
          const int q = tile_receiver(eoff, rv, e);
          const int k = list.slots[(rcv0 + q) * K + t0 + e - eoff[q]];
          const size_t off = (row0 + q) * K + k;
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
        const T* wrows = wi + rcv0 * H;
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
          coord_ksum_ragged(ediff, xcarry, eoff, rv, ch == 0, ch == chunks - 1,
                            [&](int i, int c, float s) {
                              const size_t row = row0 + i;
                              float v = s / a.norm_factor;
                              if (a.ucm != nullptr) v *= a.ucm[row];
                              out[row * 3 + c] = x[row * 3 + c] + v;
                            });
        } else {
          // m, the attention gate as each edge's weight in the K-sum, then
          // the K-sum over each receiver's edges of the tile
          edge_messages<T, kMma, kMma, kRagged, true>(
              sm, wrows, wj + (size_t)b * N * H, W2, a.attention != 0, E, H, Hp, clk,
              [&](int e, float d) {
                float s = et.ekm[e];
                if (a.attention) s *= sigmoid_f(d + att_b);
                et.escale[e] = C::rnd(s);
              });
          __syncthreads();
          clk.tick(kEpilogue);
          ksum_ragged<T, kRagged>(sm, eoff, rv, H, Hp, ch == 0, ch == chunks - 1, inv,
                                  static_cast<T*>(a.out) + row0 * H);
        }
      }
    }
    first_item += items;
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

// The pre-pass, then the pass over the list it builds.
template <typename T, bool kMma, bool kRagged, bool kCoords>
static int launch_as(const K1Params& a, cudaStream_t stream) {
  const size_t smem =
      TileSmem(a.Hp, a.rows, kMma, std::is_same<T, bf16>::value, kCoords, true).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const int list_smem = worklist_smem(a.r);
  cudaError_t err = cudaFuncSetAttribute(
      edge_worklist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, list_smem);
  if (err != cudaSuccess) return (int)err;
  edge_worklist_kernel<T><<<a.B, kThreads, list_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
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
                        egnn::worklist_smem(a.r) <= egnn::kMaxSmem && a.cap >= 1 &&
                        a.cap <= a.rows &&
                        (a.coords == 1 || a.r == a.N) && (a.coords == 0 || a.coords == 1) &&
                        a.rows >= 1 && a.rows <= egnn::kEdgeRows && a.grid >= 1 &&
                        a.list != nullptr && (a.dtype == 0 || a.dtype == 1) &&
                        a.Hp == egnn::padded_width(a.H, a.dtype == 1);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  return a.coords ? egnn::launch_dtype<true>(a, s) : egnn::launch_dtype<false>(a, s);
}
