// The GCL message tile shared by both EGNN kernels: K1 (egnn_msgpass.cu)
// runs one per work item, K2 (egnn_fused.cu) one per item of its message
// phase. A tile is rv receivers of one sample times kc of their edges
// (edge e = r * kc + k, at most `rows` edges), and does
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

// V consecutive values as float, and back rounded to T, in one or two
// 16-byte accesses (8-byte for bf16 at V = 4).
template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float (&o)[V]) {
  static_assert(V == 4 || V == 8, "bf16 vectors of 4 or 8");
  uint32_t u[V / 2];
  if constexpr (V == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    u[0] = w.x; u[1] = w.y;
  }
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[q]));
    o[2 * q] = f.x;
    o[2 * q + 1] = f.y;
  }
}
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&o)[V]) {
#pragma unroll
  for (int q = 0; q < V; q += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + q);
    o[q] = w.x; o[q + 1] = w.y; o[q + 2] = w.z; o[q + 3] = w.w;
  }
}
template <int V>
__device__ __forceinline__ void storev(bf16* p, const float (&v)[V]) {
  uint32_t u[V / 2];
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    u[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
}
template <int V>
__device__ __forceinline__ void storev(float* p, const float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V; q += 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
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

// The pair layer of E edges into buf (row stride ldb), V channels per
// thread: each thread keeps one group of V columns, so its we values stay
// in registers and no index is divided inside the loop. wi holds the tile's
// receiver rows, proj the sample's rows (both [*, H] in T, read with plain
// loads: K2 writes them earlier in the same launch). Each add is rounded to
// T as the JAX kernels do.
template <typename T, int V>
__device__ void pair_layer_v(const T* wi, const T* proj, const GclVecs& g,
                             const EdgeTile& et, int E, int H, T* __restrict__ buf,
                             int ldb) {
  using C = Cvt<T>;
  const int cpr = H / V;            // vectors per row
  const int step = kThreads / cpr;  // rows per pass
  if ((int)threadIdx.x >= step * cpr) return;
  const int c = (threadIdx.x % cpr) * V;
  float w0[V], w1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    w0[j] = g.we0[c + j];
    w1[j] = g.we1[c + j];
  }
  for (int e = threadIdx.x / cpr; e < E; e += step) {
    float a[V], p[V], o[V];
    loadv<V>(wi + (size_t)et.ercv[e] * H + c, a);
    loadv<V>(proj + (size_t)et.eidx[e] * H + c, p);
    const float rad = C::rnd(et.erad[e]), d0 = et.ed0[e];
#pragma unroll
    for (int j = 0; j < V; j += 2) {  // two channels per rounding
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
    storev<V>(buf + (size_t)e * ldb + c, o);
  }
}

template <typename T>
__device__ void pair_layer(const T* wi, const T* proj, const GclVecs& g, const EdgeTile& et,
                           int E, int H, T* buf, int ldb) {
  if (H % 8 == 0)
    pair_layer_v<T, 8>(wi, proj, g, et, E, H, buf, ldb);
  else
    pair_layer_v<T, 4>(wi, proj, g, et, E, H, buf, ldb);
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
  float* carry;     // [H] the running K-sum between chunks (chunked tiles only)
};

// One message tile after its edge load (see the top of this file). The
// caller has filled sm.et and sm.vec and put a block barrier after them;
// with kMma the W2 copies into sm.wsm (as [k, n], or [n, k] with WT) are the
// last cp.async groups in flight, or complete. wi: the tile's receiver
// rows; proj: the sample's rows; W2 [H, H] in global memory ([in, out]; the
// block_gemm route reads it from there); att_b: the attention bias.
// first / last: this tile is its receivers' first / last chunk of edges.
// out: agg row of the tile's first receiver (row stride H). Ends without a
// barrier after the K-sum; the clock ticks at every stage but the K-sum,
// whose end the caller marks at its next barrier.
template <typename T, bool kMma, bool WT>
__device__ void message_tile(const MsgSmem<T>& sm, const T* wi, const T* proj, const T* W2,
                             float att_b, bool attention, int E, int rv, int kc, int H,
                             bool first, bool last, float inv, T* out, StageClock& clk) {
  using C = Cvt<T>;
  T* const buf = sm.buf;
  const int ld = sm.ld;
  const EdgeTile& et = sm.et;
  pair_layer<T>(wi, proj, sm.vec, et, E, H, buf, ld);
  if constexpr (kMma) __pipeline_wait_prior(0);
  __syncthreads();
  clk.tick(kPairLayer);

  if constexpr (kMma) {
    tiles::Acc<2> acc;
    acc.zero();
    tiles::mma_tile<2, WT>(acc, buf, ld, sm.wsm, ld, H);
    __syncthreads();  // every warp has read the edge tile
    clk.tick(kProduct);
    // m = silu(acc + b2) back into the edge tile, and its attention dot
    const float* b2 = sm.vec.b2;
    const float* att = sm.vec.att;
    if (attention) {
      tiles::row_partials<2>(acc, H, sm.part, sm.rows, [&](int m, int n, float v0, float v1) {
        if (m >= E) return 0.0f;  // rows past the tile's edges
        v0 += b2[n];
        v1 += b2[n + 1];
        rnd2<T>(v0, v1);
        silu_m2<T>(v0, v1);
        store2(buf + (size_t)m * ld + n, v0, v1);
        return v0 * att[n] + v1 * att[n + 1];
      });
    } else {
      tiles::for_each_pair<2>(acc, H, [&](int m, int n, float v0, float v1) {
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
      float s = et.ekm[e];
      if (attention) {
        float d = sm.part[e];
        for (int w = 1; w < tiles::kWarpCols; ++w) d += sm.part[w * sm.rows + e];
        s *= sigmoid_f(d + att_b);
      }
      et.escale[e] = C::rnd(s);
    }
  } else {
    const float* b2 = sm.vec.b2;
    block_gemm<T>(buf, ld, W2, (const T*)nullptr, 0, (const T*)nullptr, E, H, sm.gs,
                  [&](int m, int n, float acc) {
                    // from_f rounds
                    buf[(size_t)m * ld + n] = C::from_f(silu_m<T, false>(C::rnd(acc + b2[n])));
                  });
    clk.tick(kProduct);  // this route's SiLU epilogue runs inside block_gemm
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int e = warp; e < E; e += kWarps) {
      float s = et.ekm[e];
      if (attention) {
        float d = 0.0f;
        for (int c = lane; c < H; c += 32)
          d = fmaf(C::to_f(buf[(size_t)e * ld + c]), sm.vec.att[c], d);
        s *= sigmoid_f(warp_sum(d) + att_b);
      }
      if (lane == 0) et.escale[e] = C::rnd(s);
    }
  }
  __syncthreads();
  clk.tick(kEpilogue);

  // the K-sum in T, in k order, two columns per thread
  const int cp = H / 2;
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
      store2(out + (size_t)i * H + c, s0 * inv, s1 * inv);
    } else {  // one receiver per chunked tile: this thread reads it back
      sm.carry[c] = s0;
      sm.carry[c + 1] = s1;
    }
  }
}

}  // namespace egnn
