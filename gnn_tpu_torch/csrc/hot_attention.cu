// Hot-block additive attention on its live entries, for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes; see
// gnn_tpu_torch/ops/hotattn.py).
//
// Replaces no TPU kernel. The additive score of the published GAT
// (arXiv:1710.10903, `gatv1`) has no Pallas kernel in gnn_tpu: its hot
// part was a dense [H, rh, ch] float32 grid over the resident block's
// batch-present rows and columns (outer sum, LeakyReLU, mask, exp, row
// sums, an e·v matmul, and the same again backward). At the cell's
// sizes about 3% of that grid holds an edge, so every pass wrote and
// read some 31 float32 entries for each one that carried weight. These
// kernels do the per-entry work on the live entries alone and keep no
// grid: nothing [H, rh, ch] is stored, forward or backward.
//
// Per live hot entry (r, c) of a layer's present grid and head h, with
// el [rh, H] of the present rows, er [ch, H] and v [ch, H d] of the
// present columns, rm [rh, H] the combined (hot, cold, self) row max:
//   u  = el[r,h] + er[c,h]          s = lrelu(u)     e = exp(s - rm[r,h])
//   t  = gd[r,h] + gn[r,h,:]·v[c,h,:]
//   ds = (e > 0) ? e*t : 0          (select, not multiply)
//   dx = (u > 0) ? ds : ds*slope    (torch's LeakyReLU derivative at 0)
//   rowmax:  m[r,h]   = lrelu(el[r,h] + max er[c,h])  (-inf: no entry;
//            LeakyReLU is monotone, so this is max s exactly)
//   terms:   den[r,h] = sum e,   num[r,h,:] = sum e*v[c,h,:]
//   bwd_row: d el[r,h] = sum dx
//   bwd_col: d er[c,h] = sum dx, dv[c,h,:] = sum e*gn[r,h,:] (0 where
//            e == 0)
//
// The live set is a bit mask of the present grid, built once a layer and
// step by the mask pass (hotattn_mask): entry (r, c) is live iff the
// resident block holds an edge between their slots (a nonzero, bf16 or
// float32), r and c are true present positions (not the pads that
// repeat slot 0), and c is not r's own column (the model's self term).
// Words [rh, ceil(ch/32)] for the row side and their bit transpose
// [ch, ceil(rh/32)] for the column side; the backward keeps these (about
// 6 MB at the cell's layer 0) instead of float32 grids.
//
// Bound on this card: the gather. A row pass reads v (or gn) of every
// live entry's other side: 4 KB an entry at width 1024, about 6 GB at
// the cell's layer 0 for 1.5 M entries, from L2 (v of the present
// columns, 28 MB there, fits the 50 MB L2), against 2 flops a float.
// The mask pass reads each true present row of the block once, whole
// (32 KB a bf16 row at k = 16384), coalesced.
//
// Design: a block of WARPS_* warps owns one output row (a column for
// bwd_col) and splits the row's mask words among its warps; each warp
// walks its words (each 32-column word shuffled to the whole warp, then
// its set bits in order) and for each live entry gathers the other
// side's row once, the live entries taken in pairs so that two gathers
// are in flight at a time (at the cost of a second width slice in
// registers; an odd entry left over is taken alone). Lanes split across the heads: L = the largest
// power of 2 <= 32 / H lanes a head, each holding its head's slice of
// the width (16 B loads where d is a multiple of 4, scalar loads
// otherwise) and computing its head's score itself, so a head's dot
// product (bwd) is a log2(L)-step shuffle within its lanes. At the end
// the warps' sums are added through shared memory in warp order, and
// warp 0 writes the row. Rows are skewed (at the cell's layer 0 a median
// of about 110 live entries a row, a maximum of about 6,600): the mask
// pass counts each row's and column's entries, and the blocks take the
// rows heaviest first (`order`, sorted by the caller), so a hub row's
// block starts early and its tail runs beside the many short rows.
// Every sum is owned by one block and taken in a fixed order: results
// are bitwise reproducible, whatever the block order, and no global
// float atomics are used (integer atomics count: the live entries of the
// row max and of the mask's columns). Grids are static over rh / ch
// (CUDA graph capture); the kernels allocate nothing and do not
// synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // warps a block: the mask pass
constexpr int THREADS = 32 * WARPS;
constexpr int MAXF = 32;                // width floats a lane, at most
constexpr unsigned FULL = 0xffffffffu;

enum Mode { ROWMAX = 0, TERMS = 1, BWD_ROW = 2, BWD_COL = 3 };

__device__ __forceinline__ float lrelu(float u, float slope) {
  return u > 0.f ? u : u * slope;
}

// A lane's slice of one head's features of row `row` (VEC: 16 B vectors
// 4 * (g + L t); else scalars g + L t); zeros past d and on idle lanes.
template <bool VEC, int F = MAXF>
__device__ __forceinline__ void load_slice(const float* __restrict__ row,
                                           int g, int L, int d, int nv,
                                           bool act, float (&x)[F]) {
  if (VEC) {
#pragma unroll
    for (int t = 0; t < F / 4; ++t) {
      const int p = 4 * (g + L * t);
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (act && t < nv && p < d)
        q = __ldg(reinterpret_cast<const float4*>(row + p));
      x[4 * t] = q.x;
      x[4 * t + 1] = q.y;
      x[4 * t + 2] = q.z;
      x[4 * t + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < F; ++t) {
      const int p = g + L * t;
      x[t] = (act && t < nv && p < d) ? __ldg(row + p) : 0.f;
    }
  }
}

template <bool VEC, int F = MAXF>
__device__ __forceinline__ void store_slice(float* __restrict__ row, int g,
                                            int L, int d, int nv, bool act,
                                            const float (&x)[F]) {
  if (!act) return;
  if (VEC) {
#pragma unroll
    for (int t = 0; t < F / 4; ++t) {
      const int p = 4 * (g + L * t);
      if (t < nv && p < d)
        *reinterpret_cast<float4*>(row + p) =
            make_float4(x[4 * t], x[4 * t + 1], x[4 * t + 2], x[4 * t + 3]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < F; ++t) {
      const int p = g + L * t;
      if (t < nv && p < d) row[p] = x[t];
    }
  }
}

// the sum over a head's L lanes (aligned groups of a power of 2)
__device__ __forceinline__ float head_sum(float x, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// One warp's share of an output row's live entries: of the row's
// `n_words` words, warp `warp` of NW walks its slice in order (a word
// shuffled to the whole warp, then its set bits) and hands `row` the
// entries (their index on the other side, below `n_other`) two at a
// time, an odd one left over alone.
template <int NW, typename RowT>
__device__ __forceinline__ void walk_live(const uint32_t* words, int n_words,
                                          int n_other, int warp, int lane,
                                          RowT& row) {
  const int per = (n_words + NW - 1) / NW;
  const int w0 = warp * per;
  const int w1 = min(n_words, w0 + per);
  int pend = -1;    // an entry waiting for its pair (warp-uniform)
  for (int base = w0; base < w1; base += 32) {
    const uint32_t mine = base + lane < w1 ? words[base + lane] : 0u;
    if (!__any_sync(FULL, mine)) continue;
    for (int src = 0; src < 32; ++src) {
      uint32_t m = __shfl_sync(FULL, mine, src);
      while (m) {
        const int idx = (base + src) * 32 + __ffs(m) - 1;
        m &= m - 1;
        if (idx >= n_other) break;
        if (pend < 0) {
          pend = idx;
        } else {
          const int two[2] = {pend, idx};
          row.template take<2>(two);
          pend = -1;
        }
      }
    }
  }
  if (pend >= 0) {
    const int one[1] = {pend};
    row.template take<1>(one);
  }
}

struct Args {
  const uint32_t* bits;   // the output side's words [n_out_rows, n_words]
  int n_words, n_other;   // words a row; entries on the other side
  const float* el;        // [rh, H]
  const float* er;        // [ch, H]
  const float* v;         // [ch, H d]
  const float* rm;        // [rh, H]
  const float* gd;        // [rh, H]
  const float* gn;        // [rh, H d]
  const int* order;       // the output rows, heaviest first (or null)
  float* y_h;             // per-head output [out rows, H]
  float* y_f;             // width output [out rows, H d]
  unsigned long long* counter;  // rowmax: += H * live entries (or null)
  int H, d, L, nv;
  float slope;
};

// One lane's state over one output row o (a present row; a present
// column for BWD_COL): its own operands, its sums, and the per-entry
// work, NB entries at a time (their gathers in flight together; the
// sums still take the entries in order).
template <int MODE, bool VEC>
struct Row {
  const Args& a;
  int h, g;
  bool act;
  float own_s = 0.f, rm_o = 0.f, gd_o = 0.f;  // el[o] (er[o]: BWD_COL)
  float own_f[MAXF];                           // gn[o] (v[o]: BWD_COL)
  float acc[MAXF];
  float sc;      // max er, den, d el or d er
  int cnt = 0;   // live entries (ROWMAX)

  __device__ Row(const Args& a_, int o, int lane) : a(a_) {
    h = lane / a.L;
    g = lane % a.L;
    act = h < a.H;
    const int H = a.H, n = a.H * a.d;
    if (act) {
      own_s = MODE == BWD_COL ? a.er[o * H + h] : a.el[o * H + h];
      if (MODE == TERMS || MODE == BWD_ROW) rm_o = a.rm[o * H + h];
      if (MODE == BWD_ROW) gd_o = a.gd[o * H + h];
    }
    if (MODE == BWD_ROW)
      load_slice<VEC>(a.gn + (size_t)o * n + h * a.d, g, a.L, a.d, a.nv, act,
                      own_f);
    else if (MODE == BWD_COL)
      load_slice<VEC>(a.v + (size_t)o * n + h * a.d, g, a.L, a.d, a.nv, act,
                      own_f);
#pragma unroll
    for (int t = 0; t < MAXF; ++t) acc[t] = 0.f;
    sc = MODE == ROWMAX ? -INFINITY : 0.f;
  }

  template <int NB>
  __device__ __forceinline__ void take(const int (&idx)[NB]) {
    const int H = a.H, d = a.d, L = a.L, nv = a.nv, n = H * d;
    const float slope = a.slope;
    if constexpr (MODE == ROWMAX) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        ++cnt;
        if (act) sc = fmaxf(sc, __ldg(a.er + idx[b] * H + h));
      }
    } else {
      take_entries<NB>(idx, H, d, L, nv, n, slope);
    }
  }

  template <int NB>
  __device__ __forceinline__ void take_entries(const int (&idx)[NB], int H,
                                               int d, int L, int nv, int n,
                                               float slope) {
    // the other side's scalars and width slice of each entry, all loads
    // issued before any is used
    float s0[NB], s1[NB], s2[NB];
    float x[NB][MAXF];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s0[b] = s1[b] = s2[b] = 0.f;
      if (MODE == BWD_COL) {
        if (act) {
          s0[b] = __ldg(a.el + idx[b] * H + h);
          s1[b] = __ldg(a.rm + idx[b] * H + h);
          s2[b] = __ldg(a.gd + idx[b] * H + h);
        }
        load_slice<VEC>(a.gn + (size_t)idx[b] * n + h * d, g, L, d, nv, act,
                        x[b]);
      } else {
        if (act) s0[b] = __ldg(a.er + idx[b] * H + h);
        load_slice<VEC>(a.v + (size_t)idx[b] * n + h * d, g, L, d, nv, act,
                        x[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (MODE == BWD_COL) {
        const float u = s0[b] + own_s;
        const float e = expf(lrelu(u, slope) - s1[b]);
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < MAXF; ++t) part = fmaf(x[b][t], own_f[t], part);
        const float tt = s2[b] + head_sum(part, L);
        const float ds = e > 0.f ? e * tt : 0.f;
        sc += u > 0.f ? ds : ds * slope;
        if (e > 0.f) {
#pragma unroll
          for (int t = 0; t < MAXF; ++t) acc[t] = fmaf(e, x[b][t], acc[t]);
        }
      } else {
        const float u = own_s + s0[b];
        const float e = expf(lrelu(u, slope) - rm_o);
        if (MODE == TERMS) {
          sc += e;
#pragma unroll
          for (int t = 0; t < MAXF; ++t) acc[t] = fmaf(e, x[b][t], acc[t]);
        } else {  // BWD_ROW
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < MAXF; ++t)
            part = fmaf(own_f[t], x[b][t], part);
          const float tt = gd_o + head_sum(part, L);
          const float ds = e > 0.f ? e * tt : 0.f;
          sc += u > 0.f ? ds : ds * slope;
        }
      }
    }
  }
};

// warps a block (one output row), by mode: more split a hub row further,
// fewer leave more registers a thread (bwd_col holds three width slices)
constexpr int WARPS_ROWMAX = 8;
constexpr int WARPS_TERMS = 8;
constexpr int WARPS_BWD_ROW = 8;
constexpr int WARPS_BWD_COL = 4;

template <int MODE>
__host__ __device__ constexpr int warps_of() {
  return MODE == TERMS ? WARPS_TERMS
         : MODE == BWD_ROW ? WARPS_BWD_ROW
         : MODE == BWD_COL ? WARPS_BWD_COL : WARPS_ROWMAX;
}

// One block per output row o, the rows with the most live entries first
// (`order`), so that a hub row's block starts early and its tail runs
// beside the many short rows.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(32 * warps_of<MODE>())
hot_additive_kernel(const Args a) {
  constexpr int NW = warps_of<MODE>();
  constexpr bool FEAT = MODE == TERMS || MODE == BWD_COL;
  __shared__ float red[MAXF + 2][32];
  const int o = a.order != nullptr ? a.order[blockIdx.x] : blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Row<MODE, VEC> row(a, o, lane);
  walk_live<NW>(a.bits + (size_t)o * a.n_words, a.n_words, a.n_other, warp,
                lane, row);

  // the warps' sums, added in warp order (ROWMAX: max and count)
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
      if (FEAT) {
#pragma unroll
        for (int t = 0; t < MAXF; ++t)
          red[t][lane] = w == 0 ? row.acc[t] : red[t][lane] + row.acc[t];
      }
      if (MODE == ROWMAX) {
        red[MAXF][lane] = w == 0 ? row.sc : fmaxf(red[MAXF][lane], row.sc);
        red[MAXF + 1][lane] = __int_as_float(
            w == 0 ? row.cnt : __float_as_int(red[MAXF + 1][lane]) + row.cnt);
      } else {
        red[MAXF][lane] = w == 0 ? row.sc : red[MAXF][lane] + row.sc;
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;
  const int H = a.H, n = a.H * a.d;
  const int h = row.h, g = row.g;
  const float sc = red[MAXF][lane];
  if (MODE == ROWMAX) {
    const int total = __float_as_int(red[MAXF + 1][lane]);
    if (row.act && g == 0)
      a.y_h[o * H + h] =
          total > 0 ? lrelu(row.own_s + sc, a.slope) : -INFINITY;
    if (lane == 0 && a.counter != nullptr && total > 0)
      atomicAdd(a.counter, (unsigned long long)total * H);
    return;
  }
  if (row.act && g == 0) a.y_h[o * H + h] = sc;
  if (FEAT) {
    float out[MAXF];
#pragma unroll
    for (int t = 0; t < MAXF; ++t) out[t] = red[t][lane];
    store_slice<VEC>(a.y_f + (size_t)o * n + h * a.d, g, a.L, a.d, a.nv,
                     row.act, out);
  }
}

// ---------------------------------------------------------------------------
// The dot-product source (gat: per head s = q_r·k_c / sqrt(d)) on the same
// live set. Replaces no TPU kernel: in gnn_tpu its hot part is a dense
// [H, rh, ch] float32 grid that XLA computes outside any Pallas kernel
// (two matmuls forward, four backward, the mask, exp and row sums); at
// gat-reddit's sizes about 3% of that grid holds an edge. These kernels
// keep no grid either. Per live entry (r, c) and head h, with q [rh, H d]
// and gn [rh, H d] of the present rows, k, v [ch, H d] of the present
// columns, rm [rh, H] the combined (hot, cold) row max, `scale` 1/sqrt(d):
//   s  = scale * q[r,h,:]·k[c,h,:]        e = exp(s - rm[r,h])
//   t  = gd[r,h] + gn[r,h,:]·v[c,h,:]     ds = (e > 0) ? e*t : 0
//   dot_rowmax:  m[r,h]    = max s                 (-inf: no entry)
//   dot_terms:   den[r,h]  = sum e,   num[r,h,:] = sum e*v[c,h,:]
//   dot_bwd_row: dq[r,h,:] = scale * sum ds*k[c,h,:]
//   dot_bwd_col: dk[c,h,:] = scale * sum ds*q[r,h,:],
//                dv[c,h,:] = sum e*gn[r,h,:]       (0 where e == 0)
//
// The arithmetic differs from the additive kind's: a d-deep product an
// entry (d = 512 at gat-reddit) where that has a scalar sum, so the score
// is a head_sum over the head's lanes and every pass gathers whole rows.
// They share the mask pass, the row walk (walk_live) and the block order.
//
// Bound on this card: the gather, 2 KB a row at width 512, from L2 (k and
// v of the present columns, about 25 MB at gat-reddit's layer 0). Rows
// gathered a live entry: k (rowmax), k and v (terms: the score is
// recomputed, no per-entry array is kept), k and v (bwd_row), q and gn
// (bwd_col): 7, 14 KB an entry, against about 9 flops a gathered float.
//
// Design: as the additive kernels' (one block an output row, its words
// split among the warps, entries in pairs, heaviest rows first, the warps'
// sums added in warp order, no float atomics), with each lane holding F
// floats of its head's slice of every row (F a template parameter: 16 at
// one head of 512, so the bwd_col pass's six slices stay in registers).
enum DotMode { DOT_ROWMAX = 0, DOT_TERMS = 1, DOT_BWD_ROW = 2, DOT_BWD_COL = 3 };

struct DotArgs {
  const uint32_t* bits;   // the output side's words [n_out_rows, n_words]
  int n_words, n_other;   // words a row; entries on the other side
  const float* q;         // [rh, H d]
  const float* k;         // [ch, H d]
  const float* v;         // [ch, H d]
  const float* rm;        // [rh, H]
  const float* gd;        // [rh, H]
  const float* gn;        // [rh, H d]
  const int* order;       // the output rows, heaviest first (or null)
  float* y_h;             // per-head output [rh, H]: m or den
  float* y_f;             // width output [out rows, H d]: num, dq or dk
  float* y_g;             // dv [ch, H d] (dot_bwd_col)
  unsigned long long* counter;  // dot_rowmax: += H * live entries (or null)
  int H, d, L, nv;
  float scale;
};

// One lane's state over one output row o (a present row; a present
// column for DOT_BWD_COL): its own slices, its sums and the per-entry work.
template <int MODE, bool VEC, int F>
struct DotRow {
  const DotArgs& a;
  int h, g;
  bool act;
  float rm_o = 0.f, gd_o = 0.f;
  float own[F];    // q[o] (k[o]: DOT_BWD_COL)
  float own2[F];   // gn[o] (DOT_BWD_ROW), v[o] (DOT_BWD_COL)
  float acc[F];    // num, dq or dk (unscaled)
  float acc2[F];   // dv
  float sc;        // max s (DOT_ROWMAX) or den
  int cnt = 0;     // live entries (DOT_ROWMAX)

  __device__ DotRow(const DotArgs& a_, int o, int lane) : a(a_) {
    h = lane / a.L;
    g = lane % a.L;
    act = h < a.H;
    const int H = a.H;
    const size_t off = (size_t)o * H * a.d + (size_t)h * a.d;
    if (act && (MODE == DOT_TERMS || MODE == DOT_BWD_ROW))
      rm_o = a.rm[o * H + h];
    if (act && MODE == DOT_BWD_ROW) gd_o = a.gd[o * H + h];
    load_slice<VEC, F>((MODE == DOT_BWD_COL ? a.k : a.q) + off, g, a.L, a.d,
                       a.nv, act, own);
    if (MODE == DOT_BWD_ROW)
      load_slice<VEC, F>(a.gn + off, g, a.L, a.d, a.nv, act, own2);
    else if (MODE == DOT_BWD_COL)
      load_slice<VEC, F>(a.v + off, g, a.L, a.d, a.nv, act, own2);
#pragma unroll
    for (int t = 0; t < F; ++t) acc[t] = acc2[t] = 0.f;
    sc = MODE == DOT_ROWMAX ? -INFINITY : 0.f;
  }

  template <int NB>
  __device__ __forceinline__ void take(const int (&idx)[NB]) {
    const int H = a.H, d = a.d, L = a.L, nv = a.nv;
    const size_t n = (size_t)H * d;
    // the other side's slices of each entry (and its scalars for
    // DOT_BWD_COL), all loads issued before any is used
    float x[NB][F], y[NB][F];
    float r_m[NB], r_d[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const size_t off = (size_t)idx[b] * n + (size_t)h * d;
      r_m[b] = r_d[b] = 0.f;
      if (MODE == DOT_BWD_COL) {
        if (act) {
          r_m[b] = __ldg(a.rm + idx[b] * H + h);
          r_d[b] = __ldg(a.gd + idx[b] * H + h);
        }
        load_slice<VEC, F>(a.q + off, g, L, d, nv, act, x[b]);
        load_slice<VEC, F>(a.gn + off, g, L, d, nv, act, y[b]);
      } else {
        load_slice<VEC, F>(a.k + off, g, L, d, nv, act, x[b]);
        if (MODE != DOT_ROWMAX)
          load_slice<VEC, F>(a.v + off, g, L, d, nv, act, y[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float p = 0.f;
#pragma unroll
      for (int t = 0; t < F; ++t) p = fmaf(own[t], x[b][t], p);
      const float s = head_sum(p, L) * a.scale;
      if (MODE == DOT_ROWMAX) {
        ++cnt;
        sc = fmaxf(sc, s);
        continue;
      }
      const float e = expf(s - (MODE == DOT_BWD_COL ? r_m[b] : rm_o));
      if (MODE == DOT_TERMS) {
        sc += e;
#pragma unroll
        for (int t = 0; t < F; ++t) acc[t] = fmaf(e, y[b][t], acc[t]);
        continue;
      }
      float p2 = 0.f;
#pragma unroll
      for (int t = 0; t < F; ++t) p2 = fmaf(own2[t], y[b][t], p2);
      const float tt = (MODE == DOT_BWD_COL ? r_d[b] : gd_o) + head_sum(p2, L);
      const float ds = e > 0.f ? e * tt : 0.f;
#pragma unroll
      for (int t = 0; t < F; ++t) acc[t] = fmaf(ds, x[b][t], acc[t]);
      if (MODE == DOT_BWD_COL && e > 0.f) {
#pragma unroll
        for (int t = 0; t < F; ++t) acc2[t] = fmaf(e, y[b][t], acc2[t]);
      }
    }
  }
};

// warps a block, by mode (as the additive kernels')
constexpr int DOT_WARPS_ROWMAX = 8;
constexpr int DOT_WARPS_TERMS = 8;
constexpr int DOT_WARPS_BWD_ROW = 8;
constexpr int DOT_WARPS_BWD_COL = 4;

template <int MODE>
__host__ __device__ constexpr int dot_warps_of() {
  return MODE == DOT_TERMS ? DOT_WARPS_TERMS
         : MODE == DOT_BWD_ROW ? DOT_WARPS_BWD_ROW
         : MODE == DOT_BWD_COL ? DOT_WARPS_BWD_COL : DOT_WARPS_ROWMAX;
}

// One block per output row o, heaviest first (`order`).
template <int MODE, bool VEC, int F>
__global__ void __launch_bounds__(32 * dot_warps_of<MODE>())
hot_dot_kernel(const DotArgs a) {
  constexpr int NW = dot_warps_of<MODE>();
  // width sums a lane carries out: num / dq / dk, and dv
  constexpr int NF = MODE == DOT_ROWMAX ? 0 : MODE == DOT_BWD_COL ? 2 : 1;
  __shared__ float red[2 * F + 2][32];
  const int o = a.order != nullptr ? a.order[blockIdx.x] : blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  DotRow<MODE, VEC, F> row(a, o, lane);
  walk_live<NW>(a.bits + (size_t)o * a.n_words, a.n_words, a.n_other, warp,
                lane, row);

  // the warps' sums, added in warp order (DOT_ROWMAX: max and count)
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
      if (NF >= 1) {
#pragma unroll
        for (int t = 0; t < F; ++t)
          red[t][lane] = w == 0 ? row.acc[t] : red[t][lane] + row.acc[t];
      }
      if (NF == 2) {
#pragma unroll
        for (int t = 0; t < F; ++t)
          red[F + t][lane] =
              w == 0 ? row.acc2[t] : red[F + t][lane] + row.acc2[t];
      }
      if (MODE == DOT_ROWMAX) {
        red[2 * F][lane] = w == 0 ? row.sc : fmaxf(red[2 * F][lane], row.sc);
        red[2 * F + 1][lane] = __int_as_float(
            w == 0 ? row.cnt
                   : __float_as_int(red[2 * F + 1][lane]) + row.cnt);
      } else if (MODE == DOT_TERMS) {
        red[2 * F][lane] = w == 0 ? row.sc : red[2 * F][lane] + row.sc;
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;
  const int H = a.H;
  const size_t off = (size_t)o * H * a.d + (size_t)row.h * a.d;
  if (MODE == DOT_ROWMAX) {
    const int total = __float_as_int(red[2 * F + 1][lane]);
    if (row.act && row.g == 0)
      a.y_h[o * H + row.h] = total > 0 ? red[2 * F][lane] : -INFINITY;
    if (lane == 0 && a.counter != nullptr && total > 0)
      atomicAdd(a.counter, (unsigned long long)total * H);
    return;
  }
  if (MODE == DOT_TERMS && row.act && row.g == 0)
    a.y_h[o * H + row.h] = red[2 * F][lane];
  const float f = MODE == DOT_TERMS ? 1.f : a.scale;
  float out[F];
#pragma unroll
  for (int t = 0; t < F; ++t) out[t] = f * red[t][lane];
  store_slice<VEC, F>(a.y_f + off, row.g, a.L, a.d, a.nv, row.act, out);
  if (NF == 2) {
#pragma unroll
    for (int t = 0; t < F; ++t) out[t] = red[F + t][lane];
    store_slice<VEC, F>(a.y_g + off, row.g, a.L, a.d, a.nv, row.act, out);
  }
}

// The mask pass, rows: warp i reads the block's row prs[i] whole and sets
// bit j of row i for each nonzero slot s with j = cmp_c[s] (the slot's
// present column, -1 if none) other than own[i]; rows that are pads
// (cmp_r[prs[i]] != i) stay empty; cnt_r[i] = the row's live entries.
// T: the block's raw bits (uint16_t for bf16 / fp16, uint32_t for
// float32).
template <typename T>
__global__ void __launch_bounds__(THREADS)
hot_mask_kernel(const T* __restrict__ dense, int k,
                const int* __restrict__ prs, int rh,
                const int* __restrict__ cmp_r,
                const int* __restrict__ cmp_c,
                const int* __restrict__ own, int ch, int chw,
                uint32_t* __restrict__ bits, int* __restrict__ cnt_r) {
  extern __shared__ uint32_t sm[];      // chw words a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  uint32_t* w = sm + warp * chw;
  for (int q = lane; q < chw; q += 32) w[q] = 0u;
  __syncwarp();
  if (i < rh) {
    const int slot = prs[i];
    if (slot >= 0 && slot < k && cmp_r[slot] == i) {
      const int own_i = own[i];
      constexpr int VE = 16 / sizeof(T);
      constexpr T MAG = sizeof(T) == 2 ? T(0x7fff) : T(0x7fffffff);
      const T* row = dense + (size_t)slot * k;
#pragma unroll 4
      for (int s0 = lane * VE; s0 < k; s0 += 32 * VE) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + s0));
        const T* vals = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          if (vals[e] & MAG) {
            const int j = __ldg(cmp_c + s0 + e);
            if (j >= 0 && j < ch && j != own_i)
              atomicOr(&w[j >> 5], 1u << (j & 31));
          }
        }
      }
    }
  }
  __syncwarp();
  if (i < rh) {
    int n = 0;
    for (int q = lane; q < chw; q += 32) {
      bits[(size_t)i * chw + q] = w[q];
      n += __popc(w[q]);
    }
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
    if (lane == 0) cnt_r[i] = n;
  }
}

// The mask pass, columns: a warp transposes one 32 x 32 tile of bits
// (rows 32 ti.., word tj) into bits_t (rows 32 tj.., word ti), one
// ballot a column; cnt_c[c] (zeroed before) += the column's live entries
// (integer atomics: the sum is exact in any order).
__global__ void __launch_bounds__(THREADS)
hot_mask_transpose_kernel(const uint32_t* __restrict__ bits, int rh,
                          int chw, uint32_t* __restrict__ bits_t, int ch,
                          int rhw, int* __restrict__ cnt_c) {
  const int lane = threadIdx.x & 31;
  const long tile = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= (long)rhw * chw) return;
  const int ti = tile / chw, tj = tile % chw;
  const int r = 32 * ti + lane;
  const uint32_t x = r < rh ? bits[(size_t)r * chw + tj] : 0u;
  uint32_t y = 0u;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const uint32_t b = __ballot_sync(FULL, (x >> c) & 1u);
    if (lane == c) y = b;
  }
  const int col = 32 * tj + lane;
  if (col < ch) {
    bits_t[(size_t)col * rhw + ti] = y;
    if (y) atomicAdd(cnt_c + col, __popc(y));
  }
}

// lanes a head: the largest power of 2 <= 32 / H
int lanes_per_head(int H) {
  int L = 1;
  while (2 * L * H <= 32) L *= 2;
  return L;
}

template <int MODE>
int launch(Args a, int n_out_rows, int H, int d, cudaStream_t stream) {
  a.H = H;
  a.d = d;
  a.L = lanes_per_head(H);
  const bool vec = d % 4 == 0;
  a.nv = vec ? (d + 4 * a.L - 1) / (4 * a.L) : (d + a.L - 1) / a.L;
  if (H < 1 || H > 32 || a.nv > (vec ? MAXF / 4 : MAXF))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out_rows > 0) {
    if (vec)
      hot_additive_kernel<MODE, true>
          <<<n_out_rows, 32 * warps_of<MODE>(), 0, stream>>>(a);
    else
      hot_additive_kernel<MODE, false>
          <<<n_out_rows, 32 * warps_of<MODE>(), 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// floats a lane holds of a head's width: the dot kernels' F, rounded up
// to 4, 16 or 32 (0: wider than 32)
int dot_floats(int floats) {
  return floats <= 4 ? 4 : floats <= 16 ? 16 : floats <= 32 ? 32 : 0;
}

template <int MODE, bool VEC>
void launch_dot_f(const DotArgs& a, int f, int blocks, cudaStream_t stream) {
  const int threads = 32 * dot_warps_of<MODE>();
  if (f == 4)
    hot_dot_kernel<MODE, VEC, 4><<<blocks, threads, 0, stream>>>(a);
  else if (f == 16)
    hot_dot_kernel<MODE, VEC, 16><<<blocks, threads, 0, stream>>>(a);
  else
    hot_dot_kernel<MODE, VEC, 32><<<blocks, threads, 0, stream>>>(a);
}

template <int MODE>
int launch_dot(DotArgs a, int n_out_rows, cudaStream_t stream) {
  a.L = lanes_per_head(a.H);
  const bool vec = a.d % 4 == 0;
  a.nv = vec ? (a.d + 4 * a.L - 1) / (4 * a.L) : (a.d + a.L - 1) / a.L;
  const int f = dot_floats(vec ? 4 * a.nv : a.nv);
  if (a.H < 1 || a.H > 32 || a.d < 1 || f == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out_rows > 0) {
    if (vec)
      launch_dot_f<MODE, true>(a, f, n_out_rows, stream);
    else
      launch_dot_f<MODE, false>(a, f, n_out_rows, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

DotArgs make_dot_args(const void* bits, const void* order, int n_words,
                      int n_other, const void* q, const void* k, int H,
                      int d, float scale) {
  DotArgs a = {};
  a.bits = static_cast<const uint32_t*>(bits);
  a.order = static_cast<const int*>(order);
  a.n_words = n_words;
  a.n_other = n_other;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.H = H;
  a.d = d;
  a.scale = scale;
  return a;
}

Args make_args(const void* bits, const void* order, int n_words,
               int n_other, const void* el, const void* er, float slope) {
  Args a = {};
  a.bits = static_cast<const uint32_t*>(bits);
  a.order = static_cast<const int*>(order);
  a.n_words = n_words;
  a.n_other = n_other;
  a.el = static_cast<const float*>(el);
  a.er = static_cast<const float*>(er);
  a.slope = slope;
  return a;
}

}  // namespace

// Every entry point launches on `stream`, returns cudaGetLastError()
// after its launches (0 = launched; cudaErrorInvalidValue for a shape it
// does not take, nothing launched). Words are uint32 rows: bits [rh,
// chw = ceil(ch / 32)], bits_t [ch, rhw = ceil(rh / 32)]. `order` (int32
// [rows of the output], or null) is the order in which blocks take the
// output rows: any permutation gives the same results.

// The mask pass: dense [k, k] (elem_bytes 2 or 4, rows 16 B aligned),
// prs [rh] the present row slots, cmp_r / cmp_c [k] each slot's present
// row / column (-1 if none), own [rh] each row's own column (any other
// value: none); writes bits, bits_t and each row's / column's live
// entries cnt_r [rh], cnt_c [ch] (int32).
extern "C" int hotattn_mask(const void* dense, int elem_bytes, int k,
                            const void* prs, int rh, const void* cmp_r,
                            const void* cmp_c, const void* own, int ch,
                            void* bits, void* bits_t, void* cnt_r,
                            void* cnt_c, void* stream) {
  const int chw = (ch + 31) / 32, rhw = (rh + 31) / 32;
  const size_t smem = sizeof(uint32_t) * WARPS * chw;
  if ((elem_bytes != 2 && elem_bytes != 4) || (k * elem_bytes) % 16 ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rh + WARPS - 1) / WARPS;
  if (blocks > 0) {
    if (elem_bytes == 2)
      hot_mask_kernel<uint16_t><<<blocks, THREADS, smem, s>>>(
          static_cast<const uint16_t*>(dense), k,
          static_cast<const int*>(prs), rh, static_cast<const int*>(cmp_r),
          static_cast<const int*>(cmp_c), static_cast<const int*>(own), ch,
          chw, static_cast<uint32_t*>(bits), static_cast<int*>(cnt_r));
    else
      hot_mask_kernel<uint32_t><<<blocks, THREADS, smem, s>>>(
          static_cast<const uint32_t*>(dense), k,
          static_cast<const int*>(prs), rh, static_cast<const int*>(cmp_r),
          static_cast<const int*>(cmp_c), static_cast<const int*>(own), ch,
          chw, static_cast<uint32_t*>(bits), static_cast<int*>(cnt_r));
  }
  if (ch > 0) cudaMemsetAsync(cnt_c, 0, sizeof(int) * ch, s);
  const long tiles = (long)rhw * chw;
  if (tiles > 0)
    hot_mask_transpose_kernel<<<(tiles + WARPS - 1) / WARPS, THREADS, 0,
                                s>>>(static_cast<const uint32_t*>(bits), rh,
                                     chw, static_cast<uint32_t*>(bits_t), ch,
                                     rhw, static_cast<int*>(cnt_c));
  return static_cast<int>(cudaGetLastError());
}

// rowmax: m [rh, H]; counter (int64 on the device, or null) += H * live
// entries
extern "C" int hotattn_rowmax(const void* bits, const void* order, int rh,
                              int ch, const void* el, const void* er,
                              void* m, int H, float slope, void* counter,
                              void* stream) {
  Args a = make_args(bits, order, (ch + 31) / 32, ch, el, er, slope);
  a.y_h = static_cast<float*>(m);
  a.counter = static_cast<unsigned long long*>(counter);
  // the row max reads no width: one slice of one float a head
  return launch<ROWMAX>(a, rh, H, 1, static_cast<cudaStream_t>(stream));
}

// terms: den [rh, H], num [rh, H d]
extern "C" int hotattn_terms(const void* bits, const void* order, int rh,
                             int ch, const void* el, const void* er,
                             const void* v, const void* rm, void* den,
                             void* num, int H, int d, float slope,
                             void* stream) {
  Args a = make_args(bits, order, (ch + 31) / 32, ch, el, er, slope);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.y_h = static_cast<float*>(den);
  a.y_f = static_cast<float*>(num);
  return launch<TERMS>(a, rh, H, d, static_cast<cudaStream_t>(stream));
}

// bwd_row: d el [rh, H]
extern "C" int hotattn_bwd_row(const void* bits, const void* order, int rh,
                               int ch, const void* el, const void* er,
                               const void* v, const void* rm, const void* gd,
                               const void* gn, void* d_el, int H, int d,
                               float slope, void* stream) {
  Args a = make_args(bits, order, (ch + 31) / 32, ch, el, er, slope);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.y_h = static_cast<float*>(d_el);
  return launch<BWD_ROW>(a, rh, H, d, static_cast<cudaStream_t>(stream));
}

// bwd_col over bits_t (order: of the columns): d er [ch, H], dv [ch, H d]
extern "C" int hotattn_bwd_col(const void* bits_t, const void* order, int rh,
                               int ch, const void* el, const void* er,
                               const void* v, const void* rm, const void* gd,
                               const void* gn, void* d_er, void* dv, int H,
                               int d, float slope, void* stream) {
  Args a = make_args(bits_t, order, (rh + 31) / 32, rh, el, er, slope);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.y_h = static_cast<float*>(d_er);
  a.y_f = static_cast<float*>(dv);
  return launch<BWD_COL>(a, ch, H, d, static_cast<cudaStream_t>(stream));
}

// The dot-product source's modes (q [rh, H d], k, v [ch, H d], rm, gd [rh,
// H], gn [rh, H d]; scale = 1 / sqrt(d)):
// dot_rowmax: m [rh, H]; counter (int64 on the device, or null) += H *
// live entries
extern "C" int hotattn_dot_rowmax(const void* bits, const void* order,
                                  int rh, int ch, const void* q,
                                  const void* k, void* m, int H, int d,
                                  float scale, void* counter, void* stream) {
  DotArgs a = make_dot_args(bits, order, (ch + 31) / 32, ch, q, k, H, d,
                            scale);
  a.y_h = static_cast<float*>(m);
  a.counter = static_cast<unsigned long long*>(counter);
  return launch_dot<DOT_ROWMAX>(a, rh, static_cast<cudaStream_t>(stream));
}

// dot_terms: den [rh, H], num [rh, H d]
extern "C" int hotattn_dot_terms(const void* bits, const void* order, int rh,
                                 int ch, const void* q, const void* k,
                                 const void* v, const void* rm, void* den,
                                 void* num, int H, int d, float scale,
                                 void* stream) {
  DotArgs a = make_dot_args(bits, order, (ch + 31) / 32, ch, q, k, H, d,
                            scale);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.y_h = static_cast<float*>(den);
  a.y_f = static_cast<float*>(num);
  return launch_dot<DOT_TERMS>(a, rh, static_cast<cudaStream_t>(stream));
}

// dot_bwd_row: dq [rh, H d]
extern "C" int hotattn_dot_bwd_row(const void* bits, const void* order,
                                   int rh, int ch, const void* q,
                                   const void* k, const void* v,
                                   const void* rm, const void* gd,
                                   const void* gn, void* dq, int H, int d,
                                   float scale, void* stream) {
  DotArgs a = make_dot_args(bits, order, (ch + 31) / 32, ch, q, k, H, d,
                            scale);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.y_f = static_cast<float*>(dq);
  return launch_dot<DOT_BWD_ROW>(a, rh, static_cast<cudaStream_t>(stream));
}

// dot_bwd_col over bits_t (order: of the columns): dk, dv [ch, H d]
extern "C" int hotattn_dot_bwd_col(const void* bits_t, const void* order,
                                   int rh, int ch, const void* q,
                                   const void* k, const void* v,
                                   const void* rm, const void* gd,
                                   const void* gn, void* dk, void* dv, int H,
                                   int d, float scale, void* stream) {
  DotArgs a = make_dot_args(bits_t, order, (rh + 31) / 32, rh, q, k, H, d,
                            scale);
  a.v = static_cast<const float*>(v);
  a.rm = static_cast<const float*>(rm);
  a.gd = static_cast<const float*>(gd);
  a.gn = static_cast<const float*>(gn);
  a.y_f = static_cast<float*>(dk);
  a.y_g = static_cast<float*>(dv);
  return launch_dot<DOT_BWD_COL>(a, ch, static_cast<cudaStream_t>(stream));
}
