// The GCL message tile shared by the EGNN kernels: K2 (egnn_fused.cu) runs
// one per item of its message phase (message_tile); K1 and K3
// (egnn_msgpass.cu) run its pair layer and product (edge_messages) on
// tiles of live edges, with K-sums over receivers that hold any number of
// a tile's edges (ksum_ragged; coord_ksum_ragged, beside the coordinate
// epilogue that K2's coordinate phase shares: coord_translate, coord_ksum,
// at the end of this file). K2's tile is rv receivers of one sample times
// kc of their edges (edge e = r * kc + k, at most `rows` edges), and does
//   pair layer  buf[e] = silu(wi_r + proj_j + radial * we0 + dist0 * we1)
//   product     m = silu(buf @ W2 + b2), back into buf
//   attention   escale[e] = sigmoid(m . att + att_b) * kmask (or kmask)
//   K-sum       agg_r = (sum over k of m * escale) / normalization_factor
// with the JAX kernels' roundings to the compute dtype T (egnn_common.cuh).
// The caller fills the tile's edge arrays (EdgeTile) and the GCL's vectors
// (GclVecs) in shared memory first.
//
// Two routes for the product: bf16 tiles of at most 128 rows with H <= 256
// run on mma.sync with W2 resident in shared memory and epilogues from the
// accumulators (egnn_tiles.cuh); float, and bf16 wider than 256, run
// block_gemm (exact-float FMAs; WMMA for bf16), the weights streamed
// through shared memory, and one warp per edge for the attention dot.
//
// Widths: the tile runs its product at Hp, H rounded up to the product's
// granule (32 for bf16, 4 for float); kRagged (egnn_plan.h:
// ragged_width) compiles the paths that widths other than a power of two
// (float) or a multiple of 32 (bf16) need. Columns [H, Hp) of the edge tile and
// of the shared-memory vectors hold zeros, and so do W2's rows and columns
// past H on their way into shared memory (copy_weight_rows): a padded
// column of m is silu(0 + 0) = 0, adds 0 to the attention dot and to the
// K-sum, and is never stored. wi, proj, W2 and agg keep their H columns in
// global memory; nothing is padded there.
//
// A receiver with more edges than a tile holds is taken in chunks of kc
// edges, one tile each, in k order: the K-sum carries its running sum from
// one chunk to the next (`carry`) and writes agg after the last, so the
// summation order is that of a single tile.
#pragma once

#include "egnn_common.cuh"
#include "egnn_tiles.cuh"

namespace egnn {

// Per-edge arrays of one tile in shared memory, `rows` entries each.
struct EdgeTile {
  int* eidx;      // neighbor row within the sample, clamped to [0, N)
  int* ercv;      // receiver within the tile: the edge's row of wi
  float* ekm;     // kmask
  float* erad;    // radial (the pair layer rounds it to T)
  float* ed0;     // dist0, rounded to T
  float* escale;  // out: the edge's weight in the K-sum
};

// A GCL's vectors as float in shared memory, H each: the edge-feature rows
// of w_e, the edge_out bias and the attention kernel.
struct GclVecs {
  float *we0, *we1, *b2, *att;
};

// Block 0's clock (clock64, thread 0) summed over the stages of its tiles:
// stamps[s] for stage s, stamps[kStages] the number of tiles. A stage ends
// at the block barrier that closes it; a disabled clock does nothing.
enum Stage { kEdgeLoad, kPairLayer, kProduct, kEpilogue, kKsum, kStages };

struct StageClock {
  long long* out;
  long long t = -1, acc[kStages] = {0, 0, 0, 0, 0};
  int tiles = 0;
  __device__ explicit StageClock(long long* stamps)
      : out(stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? stamps : nullptr) {}
  // Ends stage s here (the first call only starts the clock).
  __device__ __forceinline__ void tick(int s) {
    if (out == nullptr) return;
    const long long now = clock64();
    if (t >= 0) acc[s] += now - t;
    t = now;
    if (s == kEdgeLoad) ++tiles;
  }
  __device__ void write() const {
    if (out == nullptr) return;
    for (int s = 0; s < kStages; ++s) out[s] = acc[s];
    out[kStages] = tiles;
  }
};

// Narrows receivers [i0, i0 + rv) to half 1 or 2 of them (0: all).
__device__ inline void take_half(int half, int& i0, int& rv) {
  if (half == 0) return;
  const int first = (rv + 1) / 2;
  if (half == 1) {
    rv = first;
  } else {
    i0 += first;
    rv -= first;
  }
}

// V consecutive values (V = 8, 4, 2, 1; p aligned to V elements) as float,
// and back rounded to T, in one access of V elements (two 16-byte ones for
// float at V = 8).
template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float (&o)[V]) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "bf16 vectors of 1, 2, 4 or 8");
  if constexpr (V == 1) {
    o[0] = __bfloat162float(*p);
  } else {
    uint32_t u[V / 2];
    if constexpr (V == 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
    } else if constexpr (V == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      u[0] = w.x; u[1] = w.y;
    } else {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[q]));
      o[2 * q] = f.x;
      o[2 * q + 1] = f.y;
    }
  }
}
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&o)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + q);
      o[q] = w.x; o[q + 1] = w.y; o[q + 2] = w.z; o[q + 3] = w.w;
    }
  } else if constexpr (V == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    o[0] = w.x; o[1] = w.y;
  } else {
    o[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void storev(bf16* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16(v[0]);
  } else {
    uint32_t u[V / 2];
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      u[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (V == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = u[0];
  }
}
template <int V>
__device__ __forceinline__ void storev(float* p, const float (&v)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Rounds two values to T at once (bf16: one cvt.rn.bf16x2.f32).
template <typename T>
__device__ __forceinline__ void rnd2(float& a, float& b) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
}

// The message tile's SiLU: silu_c's steps and roundings, with the
// exponential and the quotient from the hardware's fast approximations
// where T is bf16 (about 2 float ulps each, under the bf16 rounding that
// follows; d >= 1). kRound = false leaves the last rounding to the
// caller's store. float keeps silu_c.
template <typename T, bool kRound = true>
__device__ __forceinline__ float silu_m(float v) {
  if constexpr (std::is_same<T, bf16>::value) {
    const float e = Cvt<T>::rnd(__expf(-v));
    const float q = __fdividef(v, Cvt<T>::rnd(1.0f + e));
    return kRound ? Cvt<T>::rnd(q) : q;
  } else {
    return silu_c<T>(v);
  }
}

// silu_m of two values, each rounding taken for both at once.
template <typename T, bool kRound = true>
__device__ __forceinline__ void silu_m2(float& v0, float& v1) {
  if constexpr (std::is_same<T, bf16>::value) {
    float e0 = __expf(-v0), e1 = __expf(-v1);
    rnd2<T>(e0, e1);
    float d0 = 1.0f + e0, d1 = 1.0f + e1;
    rnd2<T>(d0, d1);
    v0 = __fdividef(v0, d0);
    v1 = __fdividef(v1, d1);
    if (kRound) rnd2<T>(v0, v1);
  } else {
    v0 = silu_c<T>(v0);
    v1 = silu_c<T>(v1);
  }
}

// Two adjacent values, rounded to T on the store.
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One vector of V channels (columns c..c+V) of edge e's pair layer into
// buf, each add rounded to T as the JAX kernels do (two channels per
// rounding where V >= 2).
template <typename T, int V>
__device__ __forceinline__ void pair_vector(const T* wi, const T* proj, const EdgeTile& et,
                                            int e, int c, int H, const float (&w0)[V],
                                            const float (&w1)[V], T* __restrict__ buf,
                                            int ldb) {
  using C = Cvt<T>;
  float a[V], p[V], o[V];
  loadv<V>(wi + (size_t)et.ercv[e] * H + c, a);
  loadv<V>(proj + (size_t)et.eidx[e] * H + c, p);
  const float rad = C::rnd(et.erad[e]), d0 = et.ed0[e];
  if constexpr (V == 1) {
    float v = C::rnd(a[0] + p[0]);
    v = C::rnd(v + C::rnd(rad * w0[0]));
    v = C::rnd(v + C::rnd(d0 * w1[0]));
    o[0] = silu_m<T, false>(v);  // storev rounds
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      float v0 = a[j] + p[j], v1 = a[j + 1] + p[j + 1];
      rnd2<T>(v0, v1);
      float t0 = rad * w0[j], t1 = rad * w0[j + 1];
      rnd2<T>(t0, t1);
      v0 += t0;
      v1 += t1;
      rnd2<T>(v0, v1);
      t0 = d0 * w1[j];
      t1 = d0 * w1[j + 1];
      rnd2<T>(t0, t1);
      v0 += t0;
      v1 += t1;
      rnd2<T>(v0, v1);
      silu_m2<T, false>(v0, v1);  // storev rounds
      o[j] = v0;
      o[j + 1] = v1;
    }
  }
  storev<V>(buf + (size_t)e * ldb + c, o);
}

// The pair layer of E edges into buf (row stride ldb), V channels per
// thread (H % V == 0): each thread keeps one group of V columns, so its we
// values stay in registers and no index is divided inside the loop; where
// a row has more groups than the block has threads (V = 1 past 512
// columns) the threads walk (edge, group) pairs instead. wi holds the
// tile's receiver rows, proj the sample's rows (both [*, H] in T, read with
// plain loads: K2 writes them earlier in the same launch).
template <typename T, int V>
__device__ void pair_layer_v(const T* wi, const T* proj, const GclVecs& g,
                             const EdgeTile& et, int E, int H, T* __restrict__ buf,
                             int ldb) {
  const int cpr = H / V;  // vectors per row
  float w0[V], w1[V];
  if constexpr (V == 1) {  // the only vector that leaves a row wider than the block
    if (cpr > kThreads) {
      for (int q = threadIdx.x; q < E * cpr; q += kThreads) {
        const int e = q / cpr;
        w0[0] = g.we0[q - e * cpr];
        w1[0] = g.we1[q - e * cpr];
        pair_vector<T, V>(wi, proj, et, e, q - e * cpr, H, w0, w1, buf, ldb);
      }
      return;
    }
  }
  const int step = kThreads / cpr;  // rows per pass
  if ((int)threadIdx.x >= step * cpr) return;
  const int c = (threadIdx.x % cpr) * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    w0[j] = g.we0[c + j];
    w1[j] = g.we1[c + j];
  }
  for (int e = threadIdx.x / cpr; e < E; e += step)
    pair_vector<T, V>(wi, proj, et, e, c, H, w0, w1, buf, ldb);
}

// The pair layer, its vector the widest that divides H (8 or 4 where
// kRagged is false); with kRagged, columns [H, Hp) of the E rows of buf are
// zeroed.
template <typename T, bool kRagged>
__device__ void pair_layer(const T* wi, const T* proj, const GclVecs& g, const EdgeTile& et,
                           int E, int H, int Hp, T* buf, int ldb) {
  if (H % 8 == 0) {
    pair_layer_v<T, 8>(wi, proj, g, et, E, H, buf, ldb);
  } else if (!kRagged || H % 4 == 0) {
    pair_layer_v<T, 4>(wi, proj, g, et, E, H, buf, ldb);
  } else if constexpr (kRagged) {
    if (H % 2 == 0)
      pair_layer_v<T, 2>(wi, proj, g, et, E, H, buf, ldb);
    else
      pair_layer_v<T, 1>(wi, proj, g, et, E, H, buf, ldb);
  }
  if constexpr (kRagged) {
    const int pad = Hp - H;
    for (int q = threadIdx.x; q < E * pad; q += kThreads)
      buf[(size_t)(q / pad) * ldb + H + q % pad] = Cvt<T>::from_f(0.0f);
  }
}

// Shared memory and layout of one message tile.
template <typename T>
struct MsgSmem {
  T* buf;           // the edge tile [rows, ld]
  int ld, rows;
  bf16* wsm;        // mma route: W2 resident, [H, ld]
  float* part;      // mma route: attention partials [kWarpCols, rows]
  GemmSmem gs;      // block_gemm route, bf16: its staging
  GclVecs vec;
  EdgeTile et;
  float* carry;     // [Hp] the running K-sum between chunks (chunked tiles only)
};

// The messages of one tile after its edge load, up to each edge's dot
// product: the pair layer, m = silu(buf @ W2 + b2) and, with `dot`, m .
// vec.att; then edge(e, d) for each edge e < E from one thread, d the dot
// (0 without `dot`). The caller has filled sm.et and sm.vec (Hp each, zero
// past H) and put a block barrier after them; with kMma the W2 copies into
// sm.wsm (as [k, n], or [n, k] with WT; Hp x Hp, zero past H) are the last
// cp.async groups in flight, or complete. wi: the tile's receiver rows;
// proj: the sample's rows (both [*, H]); W2 [H, H] in global memory ([in,
// out]; the block_gemm route reads it from there). kKeepM: m is left in
// the tile's rows of buf for the caller (the block_gemm route leaves it
// there always: its dot reads it back). Ends without a barrier after the
// edge calls; the clock ticks the pair layer and the product.
template <typename T, bool kMma, bool WT, bool kRagged, bool kKeepM, typename EdgeFn>
__device__ void edge_messages(const MsgSmem<T>& sm, const T* wi, const T* proj, const T* W2,
                              bool dot, int E, int H, int Hp, StageClock& clk, EdgeFn edge) {
  using C = Cvt<T>;
  T* const buf = sm.buf;
  const int ld = sm.ld;
  const EdgeTile& et = sm.et;
  pair_layer<T, kRagged>(wi, proj, sm.vec, et, E, H, Hp, buf, ld);
  if constexpr (kMma) __pipeline_wait_prior(0);
  __syncthreads();
  clk.tick(kPairLayer);

  if constexpr (kMma) {
    tiles::Acc<2> acc;
    acc.zero();
    tiles::mma_tile<2, WT>(acc, buf, ld, sm.wsm, ld, Hp);
    __syncthreads();  // every warp has read the edge tile
    clk.tick(kProduct);
    // m = silu(acc + b2), back into the edge tile, and its dot
    const float* b2 = sm.vec.b2;
    const float* att = sm.vec.att;
    if (dot) {
      tiles::row_partials<2>(acc, Hp, sm.part, sm.rows, [&](int m, int n, float v0, float v1) {
        if (m >= E) return 0.0f;  // rows past the tile's edges
        v0 += b2[n];
        v1 += b2[n + 1];
        rnd2<T>(v0, v1);
        silu_m2<T>(v0, v1);
        if constexpr (kKeepM) store2(buf + (size_t)m * ld + n, v0, v1);
        return v0 * att[n] + v1 * att[n + 1];
      });
    } else if constexpr (kKeepM) {
      tiles::for_each_pair<2>(acc, Hp, [&](int m, int n, float v0, float v1) {
        if (m >= E) return;
        v0 += b2[n];
        v1 += b2[n + 1];
        rnd2<T>(v0, v1);
        silu_m2<T, false>(v0, v1);  // store2 rounds
        store2(buf + (size_t)m * ld + n, v0, v1);
      });
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) {
      float d = 0.0f;
      if (dot) {
        d = sm.part[e];
        for (int w = 1; w < tiles::kWarpCols; ++w) d += sm.part[w * sm.rows + e];
      }
      edge(e, d);
    }
  } else {
    const float* b2 = sm.vec.b2;
    block_gemm<T, kRagged>(buf, ld, W2, (const T*)nullptr, 0, (const T*)nullptr, E, Hp, H, sm.gs,
                  [&](int m, int n, float acc) {
                    // from_f rounds
                    buf[(size_t)m * ld + n] = C::from_f(silu_m<T, false>(C::rnd(acc + b2[n])));
                  });
    clk.tick(kProduct);  // this route's SiLU epilogue runs inside block_gemm
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int e = warp; e < E; e += kWarps) {
      float d = 0.0f;
      if (dot) {
        for (int c = lane; c < H; c += 32)
          d = fmaf(C::to_f(buf[(size_t)e * ld + c]), sm.vec.att[c], d);
        d = warp_sum(d);
      }
      if (lane == 0) edge(e, d);
    }
  }
}

// One message tile after its edge load (see the top of this file):
// edge_messages with m kept and the attention gate as each edge's weight in
// the K-sum, then the K-sum. att_b: the attention bias. first / last: this
// tile is its receivers' first / last chunk of edges. out: agg row of the
// tile's first receiver (row stride H). Ends without a barrier after the
// K-sum; the clock ticks at every stage but the K-sum, whose end the caller
// marks at its next barrier.
template <typename T, bool kMma, bool WT, bool kRagged>
__device__ void message_tile(const MsgSmem<T>& sm, const T* wi, const T* proj, const T* W2,
                             float att_b, bool attention, int E, int rv, int kc, int H, int Hp,
                             bool first, bool last, float inv, T* out, StageClock& clk) {
  using C = Cvt<T>;
  T* const buf = sm.buf;
  const int ld = sm.ld;
  const EdgeTile& et = sm.et;
  edge_messages<T, kMma, WT, kRagged, true>(sm, wi, proj, W2, attention, E, H, Hp, clk,
                                            [&](int e, float d) {
                                              float s = et.ekm[e];
                                              if (attention) s *= sigmoid_f(d + att_b);
                                              et.escale[e] = C::rnd(s);
                                            });
  __syncthreads();
  clk.tick(kEpilogue);

  // the K-sum in T, in k order, two columns per thread (Hp is even)
  const int cp = Hp / 2;
  const int rpp = kThreads / cp;  // receivers per pass
  if ((int)threadIdx.x >= rpp * cp) return;
  const int c = 2 * (threadIdx.x % cp);
  for (int i = threadIdx.x / cp; i < rv; i += rpp) {
    const T* col = buf + (size_t)i * kc * ld + c;
    const float* sc = et.escale + i * kc;
    float s0, s1;
    int k = 0;
    if (first) {
      const float2 v = load2(col);
      s0 = v.x * sc[0];
      s1 = v.y * sc[0];
      rnd2<T>(s0, s1);
      k = 1;
    } else {
      s0 = sm.carry[c];
      s1 = sm.carry[c + 1];
    }
    for (; k < kc; ++k) {
      const float2 v = load2(col + (size_t)k * ld);
      float t0 = v.x * sc[k], t1 = v.y * sc[k];
      rnd2<T>(t0, t1);
      s0 += t0;
      s1 += t1;
      rnd2<T>(s0, s1);
    }
    if (last) {
      T* o = out + (size_t)i * H + c;
      if (!kRagged || H % 2 == 0) {  // c < H holds c + 1 < H, the pair aligned
        if (!kRagged || c < H) store2(o, s0 * inv, s1 * inv);
      } else {
        if (c < H) o[0] = C::from_f(s0 * inv);
        if (c + 1 < H) o[1] = C::from_f(s1 * inv);
      }
    } else {  // one receiver per chunked tile: this thread reads it back
      sm.carry[c] = s0;
      sm.carry[c + 1] = s1;
    }
  }
}

// The K-sum of a tile of K1's work list (egnn_msgpass.cu), whose rv
// receivers hold any number of its edges: receiver i's are edges
// [eoff[i], eoff[i + 1]) of the tile, in k order, eoff[rv] the tile's
// edges. As message_tile's K-sum otherwise: m kept in buf, each edge's
// weight in et.escale, the sum in T, carried between the chunks of a
// receiver taken in several tiles. A receiver with no edge sums to zero.
template <typename T, bool kRagged>
__device__ void ksum_ragged(const MsgSmem<T>& sm, const int* eoff, int rv, int H, int Hp,
                            bool first, bool last, float inv, T* out) {
  using C = Cvt<T>;
  const int ld = sm.ld;
  const float* sc = sm.et.escale;
  const int cp = Hp / 2;
  const int rpp = kThreads / cp;  // receivers per pass
  if ((int)threadIdx.x >= rpp * cp) return;
  const int c = 2 * (threadIdx.x % cp);
  for (int i = threadIdx.x / cp; i < rv; i += rpp) {
    const T* col = sm.buf + c;
    int e = eoff[i];
    const int e1 = eoff[i + 1];
    float s0 = 0.0f, s1 = 0.0f;
    if (!first) {
      s0 = sm.carry[c];
      s1 = sm.carry[c + 1];
    } else if (e < e1) {
      const float2 v = load2(col + (size_t)e * ld);
      s0 = v.x * sc[e];
      s1 = v.y * sc[e];
      rnd2<T>(s0, s1);
      ++e;
    }
    for (; e < e1; ++e) {
      const float2 v = load2(col + (size_t)e * ld);
      float t0 = v.x * sc[e], t1 = v.y * sc[e];
      rnd2<T>(t0, t1);
      s0 += t0;
      s1 += t1;
      rnd2<T>(s0, s1);
    }
    if (last) {
      T* o = out + (size_t)i * H + c;
      if (!kRagged || H % 2 == 0) {  // c < H holds c + 1 < H, the pair aligned
        if (!kRagged || c < H) store2(o, s0 * inv, s1 * inv);
      } else {
        if (c < H) o[0] = C::from_f(s0 * inv);
        if (c + 1 < H) o[1] = C::from_f(s1 * inv);
      }
    } else {  // one receiver per chunked tile: this thread reads it back
      sm.carry[c] = s0;
      sm.carry[c + 1] = s1;
    }
  }
}

// ---- the coordinate update's epilogue (K2's phase D, K3): each edge's
// translation from its difference vector, and their sum over a receiver's
// edges in k order

// Edge e's translation into ediff[e], which holds its difference x_i - x_j
// on the way in: the difference over the normalised distance
// sqrt(rad + 1e-8) + norm_constant (rad: the squared distance in float),
// times the gate g (the caller's tanh and coords_range applied) and kmask.
__device__ __forceinline__ void coord_translate(float* ediff, int e, float rad, float km,
                                                float g, float norm_constant) {
  const float norm = sqrtf(rad + 1e-8f);
  for (int c = 0; c < 3; ++c)
    ediff[e * 3 + c] = ediff[e * 3 + c] / (norm + norm_constant) * g * km;
}

// The translations of rv receivers' kc edges (ediff, edge i * kc + k)
// summed in k order, each component by one thread, carried from one chunk
// to the next in xcarry (one receiver a tile when chunked): on the last
// chunk done(i, c, s) takes receiver i's sum s of component c.
template <typename Done>
__device__ __forceinline__ void coord_ksum(const float* ediff, float* xcarry, int rv, int kc,
                                           bool first, bool last, Done done) {
  for (int p = threadIdx.x; p < rv * 3; p += kThreads) {
    const int i = p / 3, c = p % 3;
    const float* d = ediff + (size_t)i * kc * 3 + c;
    float s = first ? d[0] : xcarry[c];
    for (int k = first ? 1 : 0; k < kc; ++k) s += d[k * 3];
    if (last)
      done(i, c, s);
    else
      xcarry[c] = s;
  }
}

// coord_ksum over a tile of K3's work list, whose receiver i holds edges
// [eoff[i], eoff[i + 1]) of the tile (ksum_ragged): a receiver with no
// edge sums to zero.
template <typename Done>
__device__ __forceinline__ void coord_ksum_ragged(const float* ediff, float* xcarry,
                                                  const int* eoff, int rv, bool first,
                                                  bool last, Done done) {
  for (int p = threadIdx.x; p < rv * 3; p += kThreads) {
    const int i = p / 3, c = p % 3;
    int e = eoff[i];
    const int e1 = eoff[i + 1];
    float s = 0.0f;
    if (!first)
      s = xcarry[c];
    else if (e < e1)
      s = ediff[(size_t)e++ * 3 + c];
    for (; e < e1; ++e) s += ediff[(size_t)e * 3 + c];
    if (last)
      done(i, c, s);
    else
      xcarry[c] = s;
  }
}

}  // namespace egnn
