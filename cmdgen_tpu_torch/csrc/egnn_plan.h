// The EGNN kernels' launch plans and shared-memory layout, in plain C++:
// the kernels (egnn_msgpass.cu, egnn_fused.cu) include this header for
// their constants, layout and launch checks, and egnn_plan.cpp exports it
// to the wrappers (ops/egnn_msgpass.py, ops/egnn_coord.py, ops/egnn_fused.py)
// through ctypes, so that every decision here has one owner: the widths taken and
// the width the tiles compute at, the route, the tile's rows, the split of
// a receiver's edges into chunks, the work items and the library variant
// that holds a launch's instantiation.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define EGNN_HD __host__ __device__
#else
#define EGNN_HD
#endif

namespace egnn {

constexpr int kThreads = 512;     // threads per block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCols = 4;      // mma.sync tiles: a 4 x 4 grid of warps
constexpr int kSlabK = 16;        // bf16 block_gemm: weight rows per shared-memory slab
constexpr int kF32Stages = 2;     // float block_gemm: W chunks in the ring
constexpr int kF32Chunk = 8192;   // floats per W chunk (32 KB)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kEdgeRows = 128;    // rows of a message tile at most
constexpr int kMaxH = 1024;       // the widest stack: 64 bf16 16x16 tiles a warp pass
// the widest bf16 stack on the mma.sync route, W2 resident in shared
// memory beside the edge tile (135 KB at 256). Wider, a column split would
// need a second edge tile for m, whose every column the attention gate
// reads before the K-sum: both kernels take the block_gemm route there
constexpr int kMmaMaxH = 256;

EGNN_HD inline int imin(int a, int b) { return a < b ? a : b; }
EGNN_HD inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row padding, in elements, of bf16 operands in shared memory. +8 shifts
// consecutive rows by 4 banks, so a WMMA fragment load (8 rows of 16 bytes
// per phase) touches 32 distinct banks instead of 4.
EGNN_HD constexpr int row_pad(bool bf16) { return bf16 ? 8 : 0; }

// W rows per chunk of the float ring: a multiple of 4, at most H
// (H % 4 == 0, 4 <= H <= 2048; H / rows chunks for a power of two).
EGNN_HD inline int f32_chunk_rows(int H) { return imin(H, (kF32Chunk / H) & ~3); }

// The width Hp at which the kernels' products run for a stack of width H:
// H rounded up to 32 for bf16 (tensor-core tiles), to 4 for float (4-column
// register tiles); 0 for a width the kernels do not take (1 <= H <= kMaxH).
EGNN_HD inline int padded_width(int H, bool bf16) {
  if (H < 1 || H > kMaxH) return 0;
  const int g = bf16 ? 32 : 4;
  return cdiv(H, g) * g;
}

// Widths: a kernel instantiated with kRagged = false takes only the widths
// its tiles divide evenly (float: a power of two, 4 <= H <= 1024; bf16:
// H % 32 == 0), on the same code as before any other width was taken;
// kRagged = true takes every H up to 1024: float column groups that do not
// divide the block, partial weight chunks, weight matrices narrower than
// the tile (zero-padded on their way into shared memory), vectors of 2 and
// 1 in the pair layer and single-column stores.
EGNN_HD inline bool ragged_width(int H, bool bf16) {
  return bf16 ? H % 32 != 0 : (H < 4 || (H & (H - 1)) != 0);
}

// Bytes of block_gemm's shared memory (GemmSmem) at width H: bf16's
// staging tiles and two weight slabs, or float's ring of weight chunks.
EGNN_HD inline size_t gemm_smem_bytes(int H, bool bf16) {
  return bf16 ? 4 * (size_t)kWarps * 256 + 2 * (size_t)2 * kSlabK * (H + row_pad(true))
              : 4 * (size_t)kF32Stages * f32_chunk_rows(H) * H;
}

// Offsets of 128-byte-aligned arrays in dynamic shared memory; the same
// sequence of take() calls sizes the allocation on the host.
struct Carver {
  size_t off = 0;
  EGNN_HD size_t take(size_t bytes) {
    const size_t o = off;
    off += (bytes + 127) / 128 * 128;
    return o;
  }
};

// Rows to allocate for an A operand of `rows` rows: the bf16 products read
// whole 16-row tiles, the float products only the rows they use.
EGNN_HD inline size_t alloc_rows(size_t rows, bool bf16) {
  return bf16 ? (rows + 15) / 16 * 16 : rows;
}

// Shared memory of one block of any of the kernels at width H (the tile's, Hp)
// with tiles of `rows` rows: the tile (K2: also the row tile of phase A and
// two node MLP tiles of rows / 2 rows in phase C), on the mma route the
// weight matrix [H, H] and the per-row partial sums of the epilogues' dot
// products, on the block_gemm route the products' buffers (GemmSmem), the
// vectors of the pair MLP (GclVecs), the running K-sum of a chunked
// receiver, the per-edge arrays of one tile, with `coords` (K2's
// coordinate pass, K3) the edges' coordinate differences and running sum
// and, with `ragged` (K1 and K3, whose receivers hold any number of a
// tile's edges), each receiver's first edge in the tile and the scan that
// finds an item's sample in the work list.
struct TileSmem {
  size_t buf, wsm, part, gemm, vec, carry, eidx, ercv, ekm, erad, ed0, escale, ediff, xcarry,
      eoff, iscan, total;
  EGNN_HD TileSmem(int H, int rows, bool mma, bool bf16, bool coords, bool ragged = false) {
    const size_t ld = H + row_pad(bf16);
    Carver c;
    buf = c.take((bf16 ? 2 : 4) * alloc_rows(rows, bf16) * ld);
    wsm = c.take(mma ? 2 * (size_t)H * ld : 0);
    part = c.take(mma ? 4 * kWarpCols * (size_t)rows : 0);
    gemm = c.take(mma ? 0 : gemm_smem_bytes(H, bf16));
    vec = c.take(4 * 4 * (size_t)H);
    carry = c.take(4 * (size_t)H);
    eidx = c.take(4 * (size_t)rows);
    ercv = c.take(4 * (size_t)rows);
    ekm = c.take(4 * (size_t)rows);
    erad = c.take(4 * (size_t)rows);
    ed0 = c.take(4 * (size_t)rows);
    escale = c.take(4 * (size_t)rows);
    ediff = c.take(coords ? 4 * 3 * (size_t)rows : 0);
    xcarry = c.take(coords ? 4 * 3 : 0);
    eoff = c.take(ragged ? 4 * ((size_t)rows + 1) : 0);
    iscan = c.take(ragged ? 4 * (size_t)(kThreads + kWarps) : 0);
    total = c.off;
  }
};

// ---- plans (host)

enum PlanStatus { kPlanOk = 0, kPlanEmpty, kPlanWidth, kPlanNoTile, kPlanRows };

// The route: mma.sync (bf16, Hp <= kMmaMaxH) wherever it runs, unless
// `block_gemm` asks for the block_gemm route, which runs at every width.
inline bool takes_mma(int hp, bool bf16, bool block_gemm) {
  return bf16 && hp <= kMmaMaxH && !block_gemm;
}

// The most rows, a multiple of `step` up to kEdgeRows, whose block_gemm
// tile fits in shared memory; 0 if none does.
inline int fit_rows(int hp, bool bf16, bool coords, int step, bool ragged = false) {
  for (int rows = kEdgeRows; rows > 0; rows -= step)
    if (TileSmem(hp, rows, false, bf16, coords, ragged).total <= (size_t)kMaxSmem) return rows;
  return 0;
}

// K2's message item: `receivers` receivers of one sample with all their K
// edges (receivers * K <= rows); a receiver with more than `rows` edges is
// an item of its own, taken in `chunks` tiles of `chunk` edges, in k order.
struct Chunking {
  int receivers, chunk, chunks;
};

inline Chunking chunking(int K, int rows) {
  if (K <= rows) return {rows / K, K, 1};
  const int chunks = cdiv(K, rows);
  return {1, cdiv(K, chunks), chunks};
}

// The work list of K1 and K3 (egnn_msgpass.cu), which their pre-pass
// (edge_worklist_kernel, one block a sample) builds on the device at every
// launch from kmask, in one int32 buffer of `ints` elements laid out here:
// `items`, each sample's items at [b * rcv][4] (sample, first receiver,
// receivers, live edges); `slots`, each receiver's live k (kmask non-zero)
// in k order at [(b * rcv + i) * K]; `poff`, each receiver's first live
// edge among its sample's (an exclusive scan of the live counts); and each
// sample's number of items. Every size is the worst case (an item a
// receiver), so a graph that holds the launch stays valid whatever the
// mask. The kernel walks the items of every sample in order.
struct WorkList {
  size_t items, slots, poff, sample_items, ints;
  EGNN_HD WorkList(int B, int rcv, int K) {
    const size_t rows = (size_t)B * rcv;
    items = 0;
    slots = items + 4 * rows;
    poff = slots + rows * K;
    sample_items = poff + rows;
    ints = sample_items + B;
  }
};

// The rows of an item of K1's or K3's work list: consecutive receivers of
// one sample, kept whole, whose live edges together fit (at most `cap`,
// and at most `cap` receivers); a receiver with more than `cap` live edges
// is an item of its own, taken in chunks of at most `cap` edges in k order
// (item_chunks).
EGNN_HD inline int item_chunks(int edges, int cap) { return edges > cap ? cdiv(edges, cap) : 1; }

// The pre-pass's shared memory for `rcv` receivers a sample: their live
// counts (then the counts' scan, rcv + 1) and the item ends doubled
// worklist_levels times (jump[l][i]: where the item 2**l items on from
// receiver i starts), levels enough to reach any of rcv items.
EGNN_HD inline int worklist_levels(int rcv) {
  int l = 1;
  while ((1 << l) < rcv) ++l;
  return l;
}
EGNN_HD inline size_t worklist_smem(int rcv) {
  return 4 * ((size_t)rcv + 1) * (1 + worklist_levels(rcv));
}

// The float product's rows a pass (egnn_common.cuh: gemm_f32 at its widest
// register tile) at a power-of-two width hp; 0 at other widths.
EGNN_HD inline int f32_pass_rows(int hp) {
  return (hp & (hp - 1)) == 0 && hp >= 4 ? kThreads / (hp / 4) * 8 : 0;
}

// The plan of a pass over the edges of `rcv` receivers of each sample, the
// first rcv of its N rows (egnn_msgpass.cu): K1's message pass (every row)
// or, with `coords`, K3's coordinate update (the rows that move; its tile
// keeps each edge's coordinate difference). The tiles are packed on the
// device from the live edges (WorkList); the host plans the width, the
// route, the rows of a tile, the list's size and the grid: one block per
// SM walking the items in a strided loop, capped at the most items there
// can be (one a receiver), one block at least (K3 copies the rows that do
// not move even where none moves). rows: kEdgeRows on the mma route, else
// the most rows, a multiple of 16, that fit. cap: the edges of an item at
// most, `rows`, or half of them where every slot of the launch fits in one
// round of full tiles and a float tile multiplies its rows in passes of
// half a tile: the list then spreads over twice as many blocks, and the
// round's one pass takes half the time of two (where every slot is live,
// two rounds of one pass take what one of two did). variant: the library
// that holds the launch's instantiation (edge_variant). list_smem: the
// pre-pass's dynamic shared memory (worklist_smem).
struct K1Plan {
  int hp, mma, variant, rows, cap, items, grid, smem_bytes, list_ints, list_smem;
};

// egnn_msgpass.cu's EGNN_VARIANT: K1 at the regular widths (0) and the
// ragged ones (1), K3 at the same (2, 3).
EGNN_HD inline int edge_variant(int H, bool bf16, bool coords) {
  return (ragged_width(H, bf16) ? 1 : 0) + (coords ? 2 : 0);
}

inline int edge_plan(int B, int N, int rcv, int K, int H, bool bf16, int sms, bool block_gemm,
                     bool coords, K1Plan* p) {
  if (B < 1 || N < 1 || K < 1 || sms < 1) return kPlanEmpty;
  if (rcv < 0 || rcv > N || worklist_smem(rcv) > (size_t)kMaxSmem) return kPlanRows;
  const int hp = padded_width(H, bf16);
  if (!hp) return kPlanWidth;
  const bool mma = takes_mma(hp, bf16, block_gemm);
  const int rows = mma ? kEdgeRows : fit_rows(hp, bf16, coords, 16, true);
  if (!rows) return kPlanNoTile;
  const WorkList list(B, rcv, K);
  if (list.ints > (size_t)0x7fffffff) return kPlanEmpty;
  const int items = B * rcv;
  const bool halve = !mma && !bf16 && 2 * f32_pass_rows(hp) == rows &&
                     (size_t)items * K <= (size_t)sms * rows;
  *p = {hp, mma, edge_variant(H, bf16, coords), rows, halve ? rows / 2 : rows, items,
        imin(sms, items > 0 ? items : 1), (int)TileSmem(hp, rows, mma, bf16, coords, true).total,
        (int)list.ints, (int)worklist_smem(rcv)};
  return kPlanOk;
}

// K2's plan (egnn_fused.cu): four phases a layer, each a list of work
// items: A, the node projections (two matrices a `rows`-row tile); B, the
// GCL messages (an item per Chunking item); C, the node MLP and the
// coordinate projections (a tile of rows / 2 rows); D, the coordinate pass
// on the r_true movable receivers. rows: kEdgeRows on the mma route, else
// the most, a multiple of 32, that fit (kEdgeRows for float at a power of
// two up to 256, which the regular instantiations take with their tiles
// fixed). max_items caps the cooperative grid. variant (egnn_fused.cu:
// EGNN_VARIANT): 0 float at a power of two up to 256, 1 float at other
// widths, 2 bf16 mma, 3 bf16 block_gemm, 4 and 5 the builds of 0 and 2
// whose receivers take their edges in chunks.
struct K2Plan {
  int hp, mma, variant, rows, node_rows, receivers, chunk, chunks, items[4], max_items,
      smem_bytes;
};

inline int k2_variant(bool bf16, bool mma, int hp, bool chunked) {
  if (bf16) return mma ? (chunked ? 5 : 2) : 3;
  return ragged_width(hp, false) || hp > 256 ? 1 : (chunked ? 4 : 0);
}

inline int k2_plan(int B, int N, int K, int H, int r_true, bool bf16, bool block_gemm,
                   K2Plan* p) {
  if (B < 1 || N < 1 || K < 1) return kPlanEmpty;
  if (r_true < 0 || r_true > N) return kPlanRows;
  const int hp = padded_width(H, bf16);
  if (!hp) return kPlanWidth;
  const bool mma = takes_mma(hp, bf16, block_gemm);
  const int rows = mma ? kEdgeRows : fit_rows(hp, bf16, true, 32);
  if (!rows) return kPlanNoTile;
  const Chunking c = chunking(K, rows);
  const int items[4] = {2 * cdiv(B * N, rows), B * cdiv(N, c.receivers), cdiv(B * N, rows / 2),
                        B * cdiv(r_true, c.receivers)};
  int most = 0;
  for (int v : items) most = v > most ? v : most;
  *p = {hp, mma, k2_variant(bf16, mma, hp, c.chunks > 1), rows, rows / 2, c.receivers, c.chunk,
        c.chunks, {items[0], items[1], items[2], items[3]}, most,
        (int)TileSmem(hp, rows, mma, bf16, true).total};
  return kPlanOk;
}

}  // namespace egnn
