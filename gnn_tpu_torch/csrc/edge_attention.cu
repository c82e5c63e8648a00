// Edge-stream attention for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see gnn_tpu_torch/ops/esattn.py).
//
// Replaces the TPU kernels of gnn_tpu/ops/pallas_esattn.py:
//   K3 cold_attention_rowmax  (Pallas _esattn_kernel, mode "max")
//   K4 cold_attention_terms   (modes "terms", "bwd_q", "bwd_kv")
// over one packed tile set, with heads as column slices of width
// d = n_out / H and the softmax scale folded into q. Per counted edge
// (r, c) and head h:
//   s  = q[r,h,:]·k[c,h,:]
//   e  = exp(s - rm[r,h])
//   t  = gd[r,h] + gn[r,h,:]·v[c,h,:]
//   ds = (e > 0) ? e*t : 0          (select, not multiply)
//   rowmax: m[r,h] = max s          (NEG_SENTINEL for rows with no edge)
//   terms:  den[r,h] += e, num[r,h,:] += e*v[c,h,:]
//   bwd_q:  dq[r] += ds*k[c]
//   bwd_kv: dk[c] += ds*q[r], dv[c] += e*gn[r] (0 where e == 0)
// An edge whose weight is exactly 0 adds nothing (select), so a NaN or inf
// operand of such an edge never leaks.
//
// The additive score source (GAT of arXiv:1710.10903; kernels named
// edge_attention_additive_kernel, entry points esattn_add_*): per-row
// el[R,H], per-column er[C,H], u = el[r,h] + er[c,h], s = lrelu(u) with
// the given slope, and v the columns' features:
//   rowmax: m[r,h] = max s          (gathers er only)
//   terms:  den[r,h] += e, num[r,h,:] += e*v[c,h,:]
//   bwd_q:  del[r,h] += du          du = ds * (u > 0 ? 1 : slope)
//   bwd_kv: der[c,h] += du, dv[c] += e*gn[r] (0 where e == 0)
// with t = gn[r,h,:]·v[c,h,:] and ds as above. A row's self edge
// (r, self[r]) is the model's own term of the softmax, so these kernels
// drop it where the tiles hold it.
//
// Layout (as the TPU kernel's): int16 coords (lr << log2 bk) | lc local
// to the edge's (bm x bk) tile, decoded as uint16; entries blk_rc =
// rt << 16 | ct sorted rt-major; off[2, nb + 1] = (edge offset, count);
// t_order = the ct-major visit permutation. Sentinel and pad entries have
// count 0. A local row >= bm is dropped, and a coordinate repeated within
// one entry counts once (the TPU kernel masks its densified tile with
// A01 > 0). Entries hold at most CAP (2048) edges, the packers' largest
// cap; a longer entry is de-duplicated within CAP-edge pieces only.
//
// The TPU kernel densifies each tile on the MXU from one-hot operands
// because the TPU has no gather hardware. The H100 gathers rows cheaply,
// so here every edge is one or two gathered rows.
//
// Bound on this card: bytes. Each call must read the coords (2 B/edge),
// the entry tables, q/k/v (and the cotangents) once and write its outputs
// once; its 2 * n_out flops per edge and dot product are far below the
// float32 rate. The per-edge row gathers (4 KB an edge at n_out 512, more
// than the operands' size) come from L2 or device memory.
//
// Design: one launch per call. A cluster of `split` blocks (1 to 8, by
// output tiles and packed edges per tile) owns one output tile: a row tile
// (rt-major blk_rc) for rowmax, terms and bwd_q, a column tile (t_order)
// for bwd_kv. It walks the tile's run of entries once, in passes (the
// walk of the edge-stream SpMM, edge_stream.cu):
//   1. decode: entries are read a window of 256 at a time; a pass takes
//      whole entries, an even share of the window's rest a block (at most
//      CAP edges); each block decodes its
//      share into (output row, gathered row), drops repeats with a
//      shared-memory hash set of (entry, coordinate) (every entry lies in
//      one block, so the set need not span the cluster), and counts the
//      edges per output row;
//   2. sort: the blocks read each other's counts (distributed shared
//      memory), so every block knows the pass's row CSR, and each edge is
//      written to its slot in the sorted order, in the block that
//      computes that slot;
//   3. compute: each block takes an even share of the sorted edges and
//      its warps an even share of that. A warp holds one output row at a
//      time: the row's own operands (q[r], and gn[r] for bwd_q; k[c] and
//      v[c] for bwd_kv) and its sums live in registers, LF floats a lane
//      across the whole width (16 at n_out <= 512, 32 up to 1024) from
//      16 B loads (float4; scalar where d is not a multiple of 4: one
//      fallback keeps the build short). Per edge the warp gathers the other side's rows once, computes
//      the scores once (one warp reduction at H = 1; per head through
//      shared memory otherwise), and adds into the row's sums;
//   4. rows that continue past a warp, then past a block, combine through
//      shared memory, then distributed shared memory, in a fixed order.
// A row is written once a pass (a later pass adds into it, or takes the
// max); rows no edge reaches read 0 (NEG_SENTINEL for the row max). No
// global float atomics, no scratch in device memory.
//
// Determinism: a row's edges are ordered within a pass by shared-memory
// int atomics, so float32 sums may differ in the last bits from run to run
// (not bitwise reproducible). The row max is exact.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;            // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 2048;               // edge positions a block decodes a pass
constexpr int EPT = CAP / THREADS;      // edge positions per thread per pass
constexpr int EW = THREADS;             // entries per window
constexpr int HBITS = 12;               // de-duplication hash set: 2^HBITS
constexpr int HCAP = 1 << HBITS;        //   slots, at most half full
constexpr int ROWMAX_EDGES = 2;         // gathered edges in flight a warp
                                        //   (rowmax; 1 for the others)
constexpr int MIN_BLOCKS = 264;         // 2 per SM
constexpr int MAX_SPLIT = 8;            // blocks (one cluster) per output tile
constexpr int TARGET_EDGES = 2048;      // mean edges a block, at most (split)
constexpr float NEG_SENTINEL = -FLT_MAX;

enum Mode { ROWMAX = 0, TERMS = 1, BWD_Q = 2, BWD_KV = 3 };
// the score source: DOT s = q·k (scale folded into q); ADD s = lrelu(el +
// er)
enum Score { DOT = 0, ADD = 1 };

// NG gathered operand rows an edge, NO own operand rows an output row, NA
// feature sums a row, HS a per-head scalar a row (the max, den, d el or
// d er); COLS: output rows are columns (t_order). The additive source
// gathers v (terms, bwd_q) or gn (bwd_kv) and holds gn (bwd_q) or v
// (bwd_kv); its per-head scalars el, er, rm and gd ride beside the rows.
template <int MODE, int SC = DOT>
struct Traits {
  static constexpr bool A = SC == ADD;
  static constexpr int NG = A ? (MODE == ROWMAX ? 0 : 1)
                              : (MODE == ROWMAX ? 1 : 2);
  static constexpr int NO = A ? (MODE == BWD_Q || MODE == BWD_KV ? 1 : 0)
                              : (MODE == ROWMAX || MODE == TERMS ? 1 : 2);
  static constexpr int NA = A ? (MODE == TERMS || MODE == BWD_KV ? 1 : 0)
                              : (MODE == ROWMAX ? 0
                                                : (MODE == BWD_KV ? 2 : 1));
  static constexpr int HS = A ? 1 : (MODE == ROWMAX || MODE == TERMS ? 1
                                                                     : 0);
  static constexpr bool COLS = MODE == BWD_KV;
};

// The block's shared memory (dynamic: more than 48 KB). NS floats of row
// state a lane: NA * LF sums, then the head scalar.
template <int NS, int LF>
struct alignas(16) Smem {
  int in_row[CAP];                    // the block's share of the pass's
  uint8_t row[CAP];                   //   edges sorted by row: gathered
                                      //   row, output row
  int ptr[256];                       // the block's edges per row
  int base[256];                      // a row's first slot for this block
  int bstart[MAX_SPLIT + 1];          // each block's first sorted slot
  int rng[MAX_SPLIT + 1];             // each block's window positions
  int ent_pre[EW + 1];                // window: prefix of edge counts
  int ent_off[EW];                    // window: first edge
  int ent_in[EW];                     // window: first gathered row
  int scan_tot[WARPS];
  int first_row[WARPS];               // warp's first / last row (-1: none)
  int last_row[WARPS];
  int blk_first, blk_last;            // the block's first / last row
  uint8_t written[256];               // row written by an earlier pass
  union {
    uint32_t hash[HCAP];              // decode: (entry, coord) + 1, 0 empty
    float red[WARPS][32 * LF];        // compute: per-head sums (H > 1)
  };
  // row state of each warp's first and last row, and of the block's (read
  // by the cluster's other blocks), [slot][i][lane]
  float comb[WARPS][2][NS][32];
  float bcomb[2][NS][32];
};

// Exclusive prefix sum of one int per thread over the block; *total gets
// the sum. Every thread calls it; it synchronises on entry and exit.
__device__ int block_scan(int v, int* scan_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  __syncthreads();
  if (lane == 31) scan_tot[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const int t = scan_tot[i];
    before += i < warp ? t : 0;
    all += t;
  }
  *total = all;
  __syncthreads();
  return before + inc - v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// V (4 or 1) floats at p (aligned to 4V bytes) into v / from v (adding to
// what p holds when `add`); outputs are stored with an evict-first hint.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v, bool add) {
  if constexpr (V == 4) {
    float4 t = make_float4(v[0], v[1], v[2], v[3]);
    if (add) {
      const float4 o = *reinterpret_cast<const float4*>(p);
      t.x += o.x; t.y += o.y; t.z += o.z; t.w += o.w;
    }
    __stcs(reinterpret_cast<float4*>(p), t);
  } else {
    __stcs(p, add ? p[0] + v[0] : v[0]);
  }
}

// The lane's LF floats of row `r` of x: columns lane * V + j * 32 * V ..
// + V for j < LF / V; zeros past n_out or when !ok.
template <int LF, int V>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int r,
                                         int n_out, bool ok, float (&v)[LF]) {
  const int col0 = (threadIdx.x & 31) * V;
  const float* p = x + (size_t)r * n_out + col0;
#pragma unroll
  for (int j = 0; j < LF / V; ++j) {
    if (ok && col0 + j * 32 * V < n_out) {
      load_vec<V>(p + j * 32 * V, v + j * V);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) v[j * V + t] = 0.f;
    }
  }
}

// A launch's operands (order = t_order for bwd_kv; split = blocks per
// output tile). y0 / y1: feature outputs; yh: the per-head output.
struct Args {
  const int16_t* coords;
  const int32_t* blk_rc;
  const int32_t* off;
  const int32_t* order;
  int nb;
  const float* q;
  const float* k;
  const float* v;
  const float* rm;
  const float* gd;
  const float* gn;
  float* y0;
  float* y1;
  float* yh;
  int n_out, H, bm, bk, shift, split;
  // the additive source: el [nrows, H], er [ncols, H], each row's self
  // column, the LeakyReLU slope
  const float* el;
  const float* er;
  const int32_t* self;
  float slope;
};

template <int MODE, int LF, int V, int SC = DOT>
struct Kernel {
  using T = Traits<MODE, SC>;
  static constexpr int NG = T::NG, NO = T::NO, NA = T::NA, HS = T::HS;
  static constexpr bool COLS = T::COLS, A = T::A;
  // array extents (a mode without gathered or own rows keeps one unused)
  static constexpr int NGA = NG > 0 ? NG : 1, NOA = NO > 0 ? NO : 1;
  static constexpr int NS = NA * LF + HS;
  static constexpr int NJ = LF / V;
  // gathered edges in flight a warp
  static constexpr int U = MODE == ROWMAX ? ROWMAX_EDGES : 1;
  using S = Smem<NS, LF>;

  // the identity of the head scalar's combine (max or sum)
  static __device__ __forceinline__ float hs_zero() {
    return MODE == ROWMAX ? NEG_SENTINEL : 0.f;
  }
  static __device__ __forceinline__ float hs_comb(float a, float b) {
    return MODE == ROWMAX ? fmaxf(a, b) : a + b;
  }
  static __device__ __forceinline__ void reset(float (&st)[NS]) {
#pragma unroll
    for (int i = 0; i < NA * LF; ++i) st[i] = 0.f;
    if (HS) st[NS - 1] = hs_zero();
  }
  static __device__ __forceinline__ void put(float (*dst)[32],
                                             const float (&a)[NS]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < NS; ++i) dst[i][lane] = a[i];
  }
  static __device__ __forceinline__ void add_from(float (&a)[NS],
                                                  const float (*src)[32]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < NA * LF; ++i) a[i] += src[i][lane];
    if (HS) a[NS - 1] = hs_comb(a[NS - 1], src[NS - 1][lane]);
  }

  // Writes the row state into tile-local row r (adds to / takes the max
  // with what an earlier pass wrote). One warp calls it for a row, once a
  // pass.
  static __device__ void flush(const Args& a, const S& s, int r,
                               int row_base, const float (&state)[NS]) {
    const int lane = threadIdx.x & 31, col0 = lane * V;
    const bool add = s.written[r];
    const size_t g = (size_t)(row_base + r);
#pragma unroll
    for (int o = 0; o < NA; ++o) {
      float* p = (o == 0 ? a.y0 : a.y1) + g * a.n_out + col0;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (col0 + j * 32 * V < a.n_out)
          store_vec<V>(p + j * 32 * V, &state[o * LF + j * V], add);
    }
    if (HS && lane < a.H) {
      float* p = a.yh + g * a.H + lane;
      *p = add ? hs_comb(*p, state[NS - 1]) : state[NS - 1];
    }
  }

  // Per head (H > 1): lane h < H gets the sum of head h's V-groups of the
  // lane partials pg (group j * 32 + lane), through the warp's buffer red.
  static __device__ float head_sum(const float (&pg)[NJ], float* red,
                                   int n_groups, int gph, int H) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j * 32 + lane < n_groups) red[j * 32 + lane] = pg[j];
    __syncwarp();
    float x = 0.f;
    if (lane < H)
      for (int i = lane * gph; i < (lane + 1) * gph; ++i) x += red[i];
    __syncwarp();
    return x;
  }
  // ...and back: wg[j] = w of the head of group j * 32 + lane.
  static __device__ void head_spread(float w, float (&wg)[NJ], float* red,
                                     int n_groups, int gph, int H) {
    const int lane = threadIdx.x & 31;
    if (lane < H)
      for (int i = lane * gph; i < (lane + 1) * gph; ++i) red[i] = w;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wg[j] = j * 32 + lane < n_groups ? red[j * 32 + lane] : 0.f;
    __syncwarp();
  }

  // st[O * LF + i] += w * x[i], one weight for the row (H = 1) or one a
  // V-group (wg); a weight of exactly 0 adds nothing
  template <int O>
  static __device__ __forceinline__ void axpy(float (&st)[NS], float w,
                                              const float (&x)[LF]) {
    if (w == 0.f) return;
#pragma unroll
    for (int i = 0; i < LF; ++i) st[O * LF + i] = fmaf(w, x[i], st[O * LF + i]);
  }
  template <int O>
  static __device__ __forceinline__ void axpy(float (&st)[NS],
                                              const float (&wg)[NJ],
                                              const float (&x)[LF]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (wg[j] == 0.f) continue;
#pragma unroll
      for (int u = 0; u < V; ++u)
        st[O * LF + j * V + u] = fmaf(wg[j], x[j * V + u],
                                      st[O * LF + j * V + u]);
    }
  }
  // the lane's V-group partials of a · b
  static __device__ __forceinline__ void group_dots(const float (&a)[LF],
                                                    const float (&b)[LF],
                                                    float (&pg)[NJ]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float x = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) x = fmaf(a[j * V + u], b[j * V + u], x);
      pg[j] = x;
    }
  }

  // One edge into the row state. own / g: the row's and the edge's
  // operand rows (own: q [gn] or k v; g: k v or q gn); rmv / gdv: the
  // row max and gden of the edge's row, for the lane's head. Scores are
  // per head: one warp reduction at H = 1, sums of V-groups through the
  // warp's buffer red otherwise.
  static __device__ __forceinline__ void edge(
      float (&st)[NS], const float (&own)[NOA][LF], const float (&g)[NGA][LF],
      float rmv, float gdv, float* red, int n_groups, int gph, int H) {
    constexpr bool BWD = MODE == BWD_Q || MODE == BWD_KV;
    // s = q·k; t = gn·v (backward)
    const float(&qa)[LF] = COLS ? g[0] : own[0];
    const float(&ka)[LF] = COLS ? own[0] : g[0];
    const float(&ga)[LF] = COLS ? g[NG - 1] : own[NO - 1];
    const float(&va)[LF] = COLS ? own[NO - 1] : g[NG - 1];
    float s, t = 0.f;
    if (H == 1) {
      s = 0.f;
#pragma unroll
      for (int i = 0; i < LF; ++i) {
        s = fmaf(qa[i], ka[i], s);
        if constexpr (BWD) t = fmaf(ga[i], va[i], t);
      }
      // every lane takes lane 0's sums, so all columns see one weight
      s = __shfl_sync(0xffffffffu, warp_sum(s), 0);
      if constexpr (BWD) t = __shfl_sync(0xffffffffu, warp_sum(t), 0);
    } else {
      float pg[NJ];
      group_dots(qa, ka, pg);
      s = head_sum(pg, red, n_groups, gph, H);
      if constexpr (BWD) {
        group_dots(ga, va, pg);
        t = head_sum(pg, red, n_groups, gph, H);
      }
    }
    if constexpr (MODE == ROWMAX) {
      st[NS - 1] = fmaxf(st[NS - 1], s);
    } else {
      const float e = expf(s - rmv);
      // the weights of the feature sums: e * v (terms), ds * k (bwd_q),
      // ds * q and e * gn (bwd_kv)
      const float w0 = MODE == TERMS ? e : (e > 0.f ? e * (gdv + t) : 0.f);
      if constexpr (MODE == TERMS) st[NS - 1] += e;
      constexpr int X0 = MODE == TERMS ? 1 : 0;
      if (H == 1) {
        axpy<0>(st, w0, g[X0]);
        if constexpr (MODE == BWD_KV) axpy<1>(st, e > 0.f ? e : 0.f, g[1]);
      } else {
        float wg[NJ];
        head_spread(w0, wg, red, n_groups, gph, H);
        axpy<0>(st, wg, g[X0]);
        if constexpr (MODE == BWD_KV) {
          head_spread(e > 0.f ? e : 0.f, wg, red, n_groups, gph, H);
          axpy<1>(st, wg, g[1]);
        }
      }
    }
  }

  // One edge of the additive source into the row state: u = el + er for
  // the lane's head (every lane's at H = 1; 0 on lanes past H), s =
  // lrelu(u); rmv / gdv: the row max and gden of the edge's row. The
  // backward's t = gn·v is per head, as in edge().
  static __device__ __forceinline__ void edge_add(
      float (&st)[NS], const float (&own)[NOA][LF], const float (&g)[NGA][LF],
      float u, float rmv, float gdv, float slope, float* red, int n_groups,
      int gph, int H) {
    const float s = u > 0.f ? u : u * slope;
    if constexpr (MODE == ROWMAX) {
      st[NS - 1] = fmaxf(st[NS - 1], s);
    } else {
      const float e = expf(s - rmv);
      // the weight of the feature sum: e * v (terms), e * gn (bwd_kv)
      float w = e;
      if constexpr (MODE == TERMS) {
        st[NS - 1] += e;
      } else {
        const float(&ga)[LF] = COLS ? g[0] : own[0];
        const float(&va)[LF] = COLS ? own[0] : g[0];
        float t;
        if (H == 1) {
          t = 0.f;
#pragma unroll
          for (int i = 0; i < LF; ++i) t = fmaf(ga[i], va[i], t);
          t = __shfl_sync(0xffffffffu, warp_sum(t), 0);
        } else {
          float pg[NJ];
          group_dots(ga, va, pg);
          t = head_sum(pg, red, n_groups, gph, H);
        }
        const float ds = e > 0.f ? e * (gdv + t) : 0.f;
        st[NS - 1] += u > 0.f ? ds : ds * slope;
        w = e > 0.f ? e : 0.f;
      }
      if constexpr (NA > 0) {
        if (H == 1) {
          axpy<0>(st, w, g[0]);
        } else {
          float wg[NJ];
          head_spread(w, wg, red, n_groups, gph, H);
          axpy<0>(st, wg, g[0]);
        }
      }
    }
  }

  // The additive source's own row (gn for bwd_q, v for bwd_kv) and the
  // lane's head of its scalars: el (er for bwd_kv) into ow, and in the
  // row-tile modes its row max and gden.
  static __device__ __forceinline__ void load_own_add(
      const Args& a, int r, float (&own)[NOA][LF], float& ow, float& rmv,
      float& gdv) {
    const int lane = threadIdx.x & 31;
    const int hl = a.H == 1 ? 0 : lane;
    const bool hk = hl < a.H;
    const size_t hi = (size_t)r * a.H + hl;
    if (COLS) {
      load_row<LF, V>(a.v, r, a.n_out, true, own[0]);
      ow = hk ? __ldg(a.er + hi) : 0.f;
    } else {
      if (MODE == BWD_Q) load_row<LF, V>(a.gn, r, a.n_out, true, own[0]);
      ow = hk ? __ldg(a.el + hi) : 0.f;
      if (MODE != ROWMAX && hk) rmv = __ldg(a.rm + hi);
      if (MODE == BWD_Q && hk) gdv = __ldg(a.gd + hi);
    }
  }

  // Whether a decoded edge is its row's self edge (the additive source's
  // own term): output row r and gathered column, or output column and
  // gathered row r (bwd_kv).
  static __device__ __forceinline__ bool self_edge(const Args& a,
                                                   int row_base, int in0,
                                                   int lr, int lc) {
    if constexpr (!A) {
      return false;
    } else {
      const int r = COLS ? in0 + lr : row_base + lr;
      const int c = COLS ? row_base + lc : in0 + lc;
      return __ldg(a.self + r) == c;
    }
  }

  // The row's own operands and, in the row-tile modes, its row max and
  // gden for the lane's head.
  static __device__ __forceinline__ void load_own(const Args& a, int r,
                                                  float (&own)[NOA][LF],
                                                  float& rmv, float& gdv) {
    const int lane = threadIdx.x & 31;
    const int hl = a.H == 1 ? 0 : lane;
    if (COLS) {
      load_row<LF, V>(a.k, r, a.n_out, true, own[0]);
      load_row<LF, V>(a.v, r, a.n_out, true, own[NO - 1]);
    } else {
      load_row<LF, V>(a.q, r, a.n_out, true, own[0]);
      if (MODE == BWD_Q) load_row<LF, V>(a.gn, r, a.n_out, true, own[1]);
      if (MODE != ROWMAX && hl < a.H) {
        rmv = __ldg(a.rm + (size_t)r * a.H + hl);
        if (MODE == BWD_Q) gdv = __ldg(a.gd + (size_t)r * a.H + hl);
      }
    }
  }

  static __device__ void run(const Args& a) {
    const int16_t* __restrict__ coords = a.coords;
    const int32_t* __restrict__ blk_rc = a.blk_rc;
    const int32_t* __restrict__ off = a.off;
    const int32_t* __restrict__ order = a.order;
    const int nb = a.nb, bm = a.bm, bk = a.bk, shift = a.shift;
    const int split = a.split, H = a.H, n_out = a.n_out;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S& s = *reinterpret_cast<S*>(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b_out = COLS ? bk : bm;
    const int tile = blockIdx.x / split;
    const int part = blockIdx.x % split;          // rank in the cluster
    const int row_base = tile * b_out;
    // per-head sums (H > 1): n_groups V-groups of gph each a head
    const int n_groups = n_out / V, gph = n_groups / H;
    float* red = s.red[warp];

    if (tid < b_out) s.written[tid] = 0;
    // the run of entries with this tile's key, from two lower bounds; all
    // threads search at once, one load a round
    auto key_at = [&](int kk) {
      return COLS ? (blk_rc[order[kk]] & 0xFFFF) : (blk_rc[kk] >> 16);
    };
    auto lower_bound = [&](int target) {
      int lo = 0, hi = nb;                      // the bound is in [lo, hi]
      while (hi - lo > THREADS) {
        const int qq = lo + static_cast<int>((long)tid * (hi - lo) / THREADS);
        const int c = __syncthreads_count(key_at(qq) < target);
        const int span = hi - lo;
        if (c < THREADS)
          hi = lo + static_cast<int>((long)c * span / THREADS);
        if (c > 0)
          lo += static_cast<int>((long)(c - 1) * span / THREADS) + 1;
      }
      return lo + __syncthreads_count(lo + tid < hi &&
                                      key_at(lo + tid) < target);
    };
    const int k_lo = lower_bound(tile);
    const int k_hi = lower_bound(tile + 1);

    for (int kw = k_lo; kw < k_hi; kw += EW) {
      const int nw = min(EW, k_hi - kw);
      int cnt = 0;
      if (tid < nw) {
        const int e = COLS ? order[kw + tid] : kw + tid;
        cnt = max(off[nb + 1 + e], 0);
        const int rc = blk_rc[e];
        s.ent_off[tid] = off[e];
        s.ent_in[tid] = COLS ? (rc >> 16) * bm : (rc & 0xFFFF) * bk;
      }
      int tot;
      const int ex = block_scan(cnt, s.scan_tot, &tot);
      s.ent_pre[tid] = ex;
      if (tid == 0) s.ent_pre[nw] = tot;
      __syncthreads();

      // a pass takes whole entries, at most CAP edges a block; the cluster
      // sorts them by output row together, and each block computes its
      // share of the sorted order
      for (int c0 = 0; c0 < tot;) {
        // 1. this block's positions; decode, drop repeats, count per row
        if (tid < b_out) s.ptr[tid] = 0;
        for (int i = tid; i < HCAP; i += THREADS) s.hash[i] = 0u;
        if (tid == 0) {
          // the blocks share the rest of the window evenly: each range
          // ends at the last entry start within its share (the last
          // block's share is CAP), or takes the whole entry that begins
          // it (cut at CAP positions only for an entry over CAP edges)
          const int share = min((tot - c0 + split - 1) / split, CAP);
          int p = c0;
          for (int b = 0; b < split; ++b) {
            s.rng[b] = p;
            if (p < tot) {
              const int lim = p + (b + 1 < split ? share : CAP);
              int lo = 0, hi = nw;
              while (lo < hi) {
                const int mid = (lo + hi + 1) >> 1;
                if (s.ent_pre[mid] <= lim) lo = mid; else hi = mid - 1;
              }
              const int end = s.ent_pre[lo + 1];
              p = s.ent_pre[lo] > p ? s.ent_pre[lo]
                                    : (end - p <= CAP ? end
                                                      : min(p + CAP, tot));
            }
          }
          s.rng[split] = p;
        }
        __syncthreads();
        const int p0 = s.rng[part];
        const int n_pos = s.rng[part + 1] - p0;
        const int c_next = s.rng[split];
        int my_idx[EPT], my_in[EPT], my_key[EPT], my_ent[EPT];
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          if (i * THREADS >= n_pos) break;
          const int p = p0 + i * THREADS + tid;
          my_idx[i] = -1;
          if (i * THREADS + tid < n_pos) {
            // the entry holding p: the last j with ent_pre[j] <= p
            int lo = 0;
#pragma unroll
            for (int step = EW / 2; step > 0; step >>= 1)
              if (lo + step < nw && s.ent_pre[lo + step] <= p) lo += step;
            my_idx[i] = s.ent_off[lo] + (p - s.ent_pre[lo]);
            my_in[i] = s.ent_in[lo];
            my_ent[i] = lo;
          }
        }
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          if (i * THREADS >= n_pos) break;
          my_key[i] = my_idx[i] >= 0
                          ? static_cast<uint16_t>(coords[my_idx[i]]) : -1;
        }
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          if (i * THREADS >= n_pos) break;
          int o = -1;
          if (my_key[i] >= 0) {
            const int lr = my_key[i] >> shift;
            const int lc = my_key[i] & (bk - 1);
            // a row past the tile is dropped, as the TPU kernel's one-hot
            // does; of a coordinate's copies in one entry, the first to
            // enter the hash set counts
            if (lr < bm && !self_edge(a, row_base, my_in[i], lr, lc)) {
              const uint32_t key =
                  ((static_cast<uint32_t>(my_ent[i]) << 16) | my_key[i]) + 1u;
              uint32_t h = (key * 2654435761u) >> (32 - HBITS);
              bool first;
              while (true) {
                const uint32_t old = atomicCAS(&s.hash[h], 0u, key);
                if (old == 0u || old == key) {
                  first = old == 0u;
                  break;
                }
                h = (h + 1) & (HCAP - 1);
              }
              if (first) {
                o = COLS ? lc : lr;
                my_in[i] += COLS ? lr : lc;
              }
            }
          }
          // one shared-memory atomic per distinct row in the warp
          const unsigned peers = __match_any_sync(0xffffffffu, o);
          my_key[i] = -1;
          if (o >= 0) {
            const int leader = __ffs(peers) - 1;
            int b0 = 0;
            if (lane == leader) b0 = atomicAdd(&s.ptr[o], __popc(peers));
            b0 = __shfl_sync(peers, b0, leader);
            my_key[i] = (b0 + __popc(peers & ((1u << lane) - 1))) << 8 | o;
          }
        }
        // 2. the cluster's row CSR: a row's edges take the blocks' counts
        //    in block order, so every edge has one slot in the sorted order
        cluster.sync();                         // every count is final
        int cnt_all = 0, cnt_before = 0;
        if (tid < b_out) {
          for (int p2 = 0; p2 < split; ++p2) {
            const int c = cluster.map_shared_rank(s.ptr, p2)[tid];
            cnt_all += c;
            cnt_before += p2 < part ? c : 0;
          }
        }
        int n;
        const int start = block_scan(cnt_all, s.scan_tot, &n);
        if (tid < b_out) s.base[tid] = start + cnt_before;
        if (tid <= split) s.bstart[tid] = n * tid / split;
        const bool row_has = cnt_all > 0;
        __syncthreads();
        // each edge to its slot, in the block that computes that slot
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          if (i * THREADS >= n_pos) break;
          if (my_key[i] >= 0) {
            const int o = my_key[i] & 0xFF;
            const int g = s.base[o] + (my_key[i] >> 8);
            int d = 0;
            while (s.bstart[d + 1] <= g) ++d;
            const int li = g - s.bstart[d];
            S* dst = cluster.map_shared_rank(&s, d);
            dst->in_row[li] = my_in[i];
            dst->row[li] = static_cast<uint8_t>(o);
          }
        }
        cluster.sync();                         // every edge is in place

        // 3. this block's share of the sorted edges, split evenly over its
        //    warps; a row's state lives in registers
        const int m = s.bstart[part + 1] - s.bstart[part];
        const int eb = m * warp / WARPS, ee = m * (warp + 1) / WARPS;
        float stt[NS];
        float own[NOA][LF];
        float rmv = 0.f, gdv = 0.f, ow = 0.f;
        int cur = -1, first = -1;
        for (int e = eb; e < ee; e += U) {
          float g[U][NGA][LF];
          float erm[U], egd[U], ew[U];
          int rr[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool ok = e + u < ee;
            const int in = ok ? s.in_row[e + u] : 0;
            rr[u] = ok ? s.row[e + u] : -1;
            if constexpr (A) {
              // the edge's head scalars: er (el, rm, gd for bwd_kv) and
              // its gathered row, v (gn for bwd_kv)
              const int hl = H == 1 ? 0 : lane;
              const bool hk = ok && hl < H;
              const size_t hi = (size_t)in * H + hl;
              if (COLS) {
                load_row<LF, V>(a.gn, in, n_out, ok, g[u][0]);
                ew[u] = hk ? __ldg(a.el + hi) : 0.f;
                erm[u] = hk ? __ldg(a.rm + hi) : 0.f;
                egd[u] = hk ? __ldg(a.gd + hi) : 0.f;
              } else {
                if (NG > 0) load_row<LF, V>(a.v, in, n_out, ok, g[u][0]);
                ew[u] = hk ? __ldg(a.er + hi) : 0.f;
              }
            } else if (COLS) {
              load_row<LF, V>(a.q, in, n_out, ok, g[u][0]);
              load_row<LF, V>(a.gn, in, n_out, ok, g[u][1]);
              const int hl = H == 1 ? 0 : lane;
              erm[u] = ok && hl < H ? __ldg(a.rm + (size_t)in * H + hl) : 0.f;
              egd[u] = ok && hl < H ? __ldg(a.gd + (size_t)in * H + hl) : 0.f;
            } else {
              load_row<LF, V>(a.k, in, n_out, ok, g[u][0]);
              if (NG > 1) load_row<LF, V>(a.v, in, n_out, ok, g[u][NG - 1]);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (rr[u] < 0) continue;
            if (rr[u] != cur) {
              if (cur >= 0) {
                if (first < 0) {
                  first = cur;
                  put(s.comb[warp][0], stt);
                } else {
                  // an interior row: this warp holds all of its edges
                  flush(a, s, cur, row_base, stt);
                }
              }
              cur = rr[u];
              reset(stt);
              if constexpr (A)
                load_own_add(a, row_base + cur, own, ow, rmv, gdv);
              else
                load_own(a, row_base + cur, own, rmv, gdv);
            }
            if constexpr (A)
              edge_add(stt, own, g[u], ow + ew[u], COLS ? erm[u] : rmv,
                       COLS ? egd[u] : gdv, a.slope, red, n_groups, gph, H);
            else
              edge(stt, own, g[u], COLS ? erm[u] : rmv, COLS ? egd[u] : gdv,
                   red, n_groups, gph, H);
          }
        }
        // 4. rows that continue past a warp: partial states through shared
        //    memory, combined in warp order
        if (cur >= 0) {
          if (first < 0) first = cur;            // the warp saw one row
          put(s.comb[warp][cur == first ? 0 : 1], stt);
        }
        if (lane == 0) {
          s.first_row[warp] = first;
          s.last_row[warp] = cur;
        }
        if (tid == 0) {
          s.blk_first = m > 0 ? s.row[0] : -1;
          s.blk_last = m > 0 ? s.row[m - 1] : -1;
        }
        __syncthreads();
        if (first >= 0) {
          // slot 0: the first row; slot 1: the last row when it differs.
          // A warp combines a boundary row unless an earlier warp ends on
          // it.
          for (int slot = 0; slot < 2; ++slot) {
            const int r = slot ? cur : first;
            if (slot == 1 && cur == first) break;
            if (slot == 0) {
              bool mine = true;
              for (int w2 = warp - 1; w2 >= 0; --w2) {
                if (s.first_row[w2] >= 0) {
                  mine = s.last_row[w2] != r;
                  break;
                }
              }
              if (!mine) continue;
            }
            float sum[NS];
            reset(sum);
            add_from(sum, s.comb[warp][slot]);
            for (int w2 = warp + 1; w2 < WARPS; ++w2) {
              if (s.first_row[w2] < 0) continue;
              if (s.first_row[w2] != r) break;
              add_from(sum, s.comb[w2][0]);
              if (s.last_row[w2] != r) break;
            }
            // the block's first and last row may continue in the
            // cluster's neighbouring blocks
            if (r == s.blk_first) put(s.bcomb[0], sum);
            else if (r == s.blk_last) put(s.bcomb[1], sum);
            else flush(a, s, r, row_base, sum);
          }
        }
        // 5. the same one level up: rows that continue past a block,
        //    combined in block order through the cluster's shared memory
        __threadfence();
        cluster.sync();
        if (warp == 0 && s.blk_first >= 0) {
          for (int slot = 0; slot < 2; ++slot) {
            const int r = slot ? s.blk_last : s.blk_first;
            if (slot == 1 && s.blk_last == s.blk_first) break;
            if (slot == 0) {
              bool mine = true;
              for (int p2 = part - 1; p2 >= 0; --p2) {
                const S* o = cluster.map_shared_rank(&s, p2);
                if (o->blk_first >= 0) {
                  mine = o->blk_last != r;
                  break;
                }
              }
              if (!mine) continue;
            }
            float sum[NS];
            reset(sum);
            add_from(sum, s.bcomb[slot]);
            for (int p2 = part + 1; p2 < split; ++p2) {
              const S* o = cluster.map_shared_rank(&s, p2);
              if (o->blk_first < 0) continue;
              if (o->blk_first != r) break;
              add_from(sum, o->bcomb[0]);
              if (o->blk_last != r) break;
            }
            flush(a, s, r, row_base, sum);
          }
        }
        // a row counts as written once every flush of the pass read the
        // flag (the next pass's cluster barriers order the rest)
        __threadfence();
        __syncthreads();
        if (row_has) s.written[tid] = 1;
        c0 = c_next;
      }
    }
    // no block leaves while the cluster may still read its shared memory
    cluster.sync();

    // rows no edge reaches read 0 (NEG_SENTINEL for the row max); the
    // cluster's blocks share them out
    __syncthreads();
    float zero[NS];
    reset(zero);
    for (int r = part * WARPS + warp; r < b_out; r += split * WARPS)
      if (!s.written[r]) flush(a, s, r, row_base, zero);
  }
};

template <int MODE, int LF, int V>
__global__ void __launch_bounds__(THREADS, LF > 16 ? 1 : 2)
edge_attention_kernel(const Args a) {
  Kernel<MODE, LF, V>::run(a);
}

// The additive score source's walk: a kernel of its own name, so that a
// trace tells it from the dot product's.
template <int MODE, int LF, int V>
__global__ void __launch_bounds__(THREADS, LF > 16 ? 1 : 2)
edge_attention_additive_kernel(const Args a) {
  Kernel<MODE, LF, V, ADD>::run(a);
}

// Floats a lane holds across the width: 16 up to n_out 512, 32 up to 1024.
int lane_floats(int n_out) { return n_out <= 512 ? 16 : 32; }

// Blocks (one cluster) per output tile: the fewest (a power of two, at
// most MAX_SPLIT) that give MIN_BLOCKS blocks (halved at 32 floats a lane:
// one block an SM) and at most TARGET_EDGES of the e_slots packed edge
// slots a block on average.
int tile_split(int n_out_tiles, int n_out, long e_slots) {
  const int min_blocks = lane_floats(n_out) > 16 ? MIN_BLOCKS / 2
                                                 : MIN_BLOCKS;
  int split = 1;
  while (split < MAX_SPLIT &&
         ((long)n_out_tiles * split < min_blocks ||
          e_slots > (long)TARGET_EDGES * n_out_tiles * split))
    split *= 2;
  return split;
}

// The vector width (4 floats, else 1) that d and every row base allow.
int vec_width(int d, const Args& a) {
  const uintptr_t p =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.gn) |
      reinterpret_cast<uintptr_t>(a.y0) | reinterpret_cast<uintptr_t>(a.y1);
  return d % 4 == 0 && p % 16 == 0 ? 4 : 1;
}

// One launch of a kernel variant, with a cluster of `split` blocks per
// output tile; its shared memory is over the 48 KB default, so the first
// launch raises the variant's limit.
template <int MODE, int LF, int V, int SC>
int run(const Args& a, int grid, cudaStream_t stream) {
  auto kernel = edge_attention_kernel<MODE, LF, V>;
  if constexpr (SC == ADD)
    kernel = edge_attention_additive_kernel<MODE, LF, V>;
  constexpr size_t smem = sizeof(typename Kernel<MODE, LF, V, SC>::S);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int LF, int SC>
int launch_lf(const Args& a, int grid, cudaStream_t s) {
  return vec_width(a.n_out / a.H, a) == 4 ? run<MODE, LF, 4, SC>(a, grid, s)
                                          : run<MODE, LF, 1, SC>(a, grid, s);
}

// One call: n_out_tiles output tiles of nrows / bm rows (ncols / bk
// columns for bwd_kv).
template <int MODE, int SC = DOT>
int launch(Args a, int nrows, int ncols, long e_slots, void* stream) {
  if (a.n_out <= 0 || a.H <= 0 || a.H > 32 || a.n_out % a.H != 0 ||
      a.n_out > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_out_tiles = Traits<MODE>::COLS ? ncols / a.bk : nrows / a.bm;
  if (n_out_tiles <= 0) return 0;
  while ((1 << a.shift) < a.bk) ++a.shift;
  a.split = tile_split(n_out_tiles, a.n_out, e_slots);
  const int grid = n_out_tiles * a.split;
  auto s = static_cast<cudaStream_t>(stream);
  return lane_floats(a.n_out) > 16 ? launch_lf<MODE, 32, SC>(a, grid, s)
                                   : launch_lf<MODE, 16, SC>(a, grid, s);
}

Args make_args(const void* coords, const void* blk_rc, const void* off,
               const void* t_order, int nb, int n_out, int H, int bm,
               int bk) {
  Args a = {};
  a.coords = static_cast<const int16_t*>(coords);
  a.blk_rc = static_cast<const int32_t*>(blk_rc);
  a.off = static_cast<const int32_t*>(off);
  a.order = static_cast<const int32_t*>(t_order);
  a.nb = nb;
  a.n_out = n_out;
  a.H = H;
  a.bm = bm;
  a.bk = bk;
  a.split = 1;
  return a;
}

}  // namespace

// Every entry point takes (tiles, nb, inputs..., outputs..., nrows, ncols,
// n_out, H, bm, bk, e_slots, stream), makes one launch and returns
// cudaGetLastError() after it (0 = launched; cudaErrorInvalidValue for
// H > 32 or n_out > 1024). nrows / ncols are multiples of bm / bk; e_slots
// = coords' element count (the packed edge slots, which size the
// clusters); t_order is read by bwd_kv only.

// K3: m[nrows, H]
extern "C" int esattn_rowmax_f32(const void* coords, const void* blk_rc,
                                 const void* off, const void* t_order, int nb,
                                 const void* q, const void* k, void* m,
                                 int nrows, int ncols, int n_out, int H,
                                 int bm, int bk, long e_slots, void* stream) {
  Args a = make_args(coords, blk_rc, off, t_order, nb, n_out, H, bm, bk);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.yh = static_cast<float*>(m);
  return launch<ROWMAX>(a, nrows, ncols, e_slots, stream);
}

// K4 forward: den[nrows, H], num[nrows, n_out]
extern "C" int esattn_terms_f32(const void* coords, const void* blk_rc,
                                const void* off, const void* t_order, int nb,
                                const void* q, const void* k, const void* v,
                                const void* rm, void* den, void* num,
                                int nrows, int ncols, int n_out, int H,
                                int bm, int bk, long e_slots, void* stream) {
  Args a = make_args(coords, blk_rc, off, t_order, nb, n_out, H, bm, bk);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.yh = static_cast<float*>(den);
  a.y0 = static_cast<float*>(num);
  return launch<TERMS>(a, nrows, ncols, e_slots, stream);
}

// K4 backward, row tiles: dq[nrows, n_out]
extern "C" int esattn_bwd_q_f32(const void* coords, const void* blk_rc,
                                const void* off, const void* t_order, int nb,
                                const void* q, const void* k, const void* v,
                                const void* rm, const void* gd,
                                const void* gn, void* dq, int nrows,
                                int ncols, int n_out, int H, int bm, int bk,
                                long e_slots, void* stream) {
  Args a = make_args(coords, blk_rc, off, t_order, nb, n_out, H, bm, bk);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.y0 = static_cast<float*>(dq);
  return launch<BWD_Q>(a, nrows, ncols, e_slots, stream);
}

// K4 backward, column tiles (t_order): dk, dv [ncols, n_out]
extern "C" int esattn_bwd_kv_f32(const void* coords, const void* blk_rc,
                                 const void* off, const void* t_order, int nb,
                                 const void* q, const void* k, const void* v,
                                 const void* rm, const void* gd,
                                 const void* gn, void* dk, void* dv,
                                 int nrows, int ncols, int n_out, int H,
                                 int bm, int bk, long e_slots, void* stream) {
  Args a = make_args(coords, blk_rc, off, t_order, nb, n_out, H, bm, bk);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.y0 = static_cast<float*>(dk);
  a.y1 = static_cast<float*>(dv);
  return launch<BWD_KV>(a, nrows, ncols, e_slots, stream);
}

// The additive source's entry points take (tiles, nb, inputs...,
// outputs..., nrows, ncols, n_out, H, bm, bk, e_slots, slope, stream):
// el [nrows, H], er [ncols, H], self [nrows] (each row's self column, an
// edge to it dropped), v [ncols, n_out]; the rowmax has no v and takes
// n_out = H.

static Args make_add_args(const void* coords, const void* blk_rc, const void* off,
                   const void* t_order, int nb, const void* el,
                   const void* er, const void* self, int n_out, int H,
                   int bm, int bk, float slope) {
  Args a = make_args(coords, blk_rc, off, t_order, nb, n_out, H, bm, bk);
  a.el = static_cast<const float*>(el);
  a.er = static_cast<const float*>(er);
  a.self = static_cast<const int32_t*>(self);
  a.slope = slope;
  return a;
}

// K3, additive: m[nrows, H]
extern "C" int esattn_add_rowmax_f32(const void* coords, const void* blk_rc,
                                     const void* off, const void* t_order,
                                     int nb, const void* el, const void* er,
                                     const void* self, void* m, int nrows,
                                     int ncols, int n_out, int H, int bm,
                                     int bk, long e_slots, float slope,
                                     void* stream) {
  Args a = make_add_args(coords, blk_rc, off, t_order, nb, el, er, self,
                         n_out, H, bm, bk, slope);
  a.yh = static_cast<float*>(m);
  return launch<ROWMAX, ADD>(a, nrows, ncols, e_slots, stream);
}

// K4 forward, additive: den[nrows, H], num[nrows, n_out]
extern "C" int esattn_add_terms_f32(const void* coords, const void* blk_rc,
                                    const void* off, const void* t_order,
                                    int nb, const void* el, const void* er,
                                    const void* self, const void* v,
                                    const void* rm, void* den, void* num,
                                    int nrows, int ncols, int n_out, int H,
                                    int bm, int bk, long e_slots, float slope,
                                    void* stream) {
  Args a = make_add_args(coords, blk_rc, off, t_order, nb, el, er, self,
                         n_out, H, bm, bk, slope);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.yh = static_cast<float*>(den);
  a.y0 = static_cast<float*>(num);
  return launch<TERMS, ADD>(a, nrows, ncols, e_slots, stream);
}

// K4 backward, additive, row tiles: d el[nrows, H]
extern "C" int esattn_add_bwd_q_f32(const void* coords, const void* blk_rc,
                                    const void* off, const void* t_order,
                                    int nb, const void* el, const void* er,
                                    const void* self, const void* v,
                                    const void* rm, const void* gd,
                                    const void* gn, void* del, int nrows,
                                    int ncols, int n_out, int H, int bm,
                                    int bk, long e_slots, float slope,
                                    void* stream) {
  Args a = make_add_args(coords, blk_rc, off, t_order, nb, el, er, self,
                         n_out, H, bm, bk, slope);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.yh = static_cast<float*>(del);
  return launch<BWD_Q, ADD>(a, nrows, ncols, e_slots, stream);
}

// K4 backward, additive, column tiles (t_order): d er[ncols, H],
// dv[ncols, n_out]
extern "C" int esattn_add_bwd_kv_f32(const void* coords, const void* blk_rc,
                                     const void* off, const void* t_order,
                                     int nb, const void* el, const void* er,
                                     const void* self, const void* v,
                                     const void* rm, const void* gd,
                                     const void* gn, void* der, void* dv,
                                     int nrows, int ncols, int n_out, int H,
                                     int bm, int bk, long e_slots,
                                     float slope, void* stream) {
  Args a = make_add_args(coords, blk_rc, off, t_order, nb, el, er, self,
                         n_out, H, bm, bk, slope);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.yh = static_cast<float*>(der);
  a.y0 = static_cast<float*>(dv);
  return launch<BWD_KV, ADD>(a, nrows, ncols, e_slots, stream);
}

// Thread blocks of one launch over n_out_tiles output tiles at width n_out
// with e_slots packed edge slots (clusters of blocks / n_out_tiles).
extern "C" int esattn_blocks(int n_out_tiles, long e_slots, int n_out) {
  if (n_out_tiles <= 0 || n_out <= 0) return 0;
  return n_out_tiles * tile_split(n_out_tiles, n_out, e_slots);
}
