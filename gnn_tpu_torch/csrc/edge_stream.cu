// Edge-stream SpMM for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes; see gnn_tpu_torch/ops/edgestream.py).
//
// Replaces two TPU kernels of gnn_tpu/ops/pallas_edgestream.py:
//   * edge_stream_spmm (Pallas kernel _edge_stream_kernel), K1, both
//     orientations;
//   * edge_stream_spmm_seg (Pallas kernel _edge_stream_seg_kernel), K6,
//     the segment-grid forward.
// Both compute, over one packed tile set,
//
//     y = out_fac * (A01 @ (in_fac * x))     (forward,   y has nrows rows)
//     y = out_fac * (A01^T @ (in_fac * x))   (transpose, K1 only)
//
// where A01 holds one entry per packed edge (times its per-edge value when
// `vals` is given, K1 only; duplicate edges sum) and in_fac / out_fac are
// the rank-1 factors (nf / rv forward, rv / nf transpose), applied here:
// x is read once and y written once, with no scaled copy of either.
//
// Layout (identical to the TPU kernels'): int16 coords (lr << log2 bk) | lc
// local to the edge's (bm x bk) tile, decoded as uint16 so 256x256 tiles
// with rows >= 128 do not sign-extend; entries blk_rc = rt << 16 | ct sorted
// rt-major; off[2, nb + 1] = (edge offset, edge count) per entry; t_order
// = the ct-major visit permutation for the transpose; seg_ptr = K6's
// segment boundaries. Sentinel and pad entries have count 0.
//
// The TPU kernels densify each tile on the MXU from one-hot operands over a
// sequential grid, because the TPU has no gather hardware. The H100
// gathers rows cheaply, so here every edge is one gathered row of x.
//
// Bound on this card: bytes. The function must move x (n_in x F), y
// (n_out x F), 2 B of coords per edge and the factors; its 2 flops per
// edge and feature are far below the float32 rate. The per-edge row
// gathers (E x F x 4 B, several times x's size) are meant to hit L2: the
// grid runs over tiles fastest, so the blocks resident together share one
// 256-float slab of x (27 MB at the default batch's widest input, within
// the 50 MB L2), and y is stored with an evict-first hint.
//
// Design. A cluster of `split` blocks (1, 2 or 4, by edges per tile) owns
// (output tile, 256-float feature slab); 8 warps a block, 8 floats a lane.
// The cluster finds its run of entries (rt-major blk_rc forward, t_order
// transpose, the segments' row tiles for K6) with a search in which every
// thread loads, and walks the run once, in passes of split * CAP edge
// positions:
//   1. decode: entries are read a window of 256 at a time (edge counts
//      prefix-summed); each block decodes CAP of the pass's positions into
//      (output-local row, input row, per-edge value) with all their coords
//      in flight, and counts them per row (one shared-memory int atomic
//      per distinct row of a warp);
//   2. sort: the blocks read each other's counts (distributed shared
//      memory), so every block knows the pass's row CSR, and each edge is
//      written to its slot in the sorted order, in the block that gathers
//      that slot;
//   3. gather: each block takes an even share of the sorted edges and its
//      warps an even share of that (by edges, not rows, so a hub row does
//      not idle the others); each lane sums its 8 floats of a row in
//      registers from 16 B loads (float4; float2 where F is only 8
//      B-aligned, scalar for odd F), gathering in_fac of the row beside it,
//      and writes a row once it ends;
//   4. rows that continue past a warp, then past a block, combine through
//      shared memory, then distributed shared memory, in a fixed order.
// A row is written with out_fac applied; a later pass adds into rows an
// earlier pass wrote; rows no edge reaches are written as 0. Every output
// element is written by one block of one cluster at a time: no global
// float atomics, no scratch.
//
// What this does about the per-chunk design it replaces (a block per
// output tile and 32 features, shared-memory float atomics, barriers per
// entry, the factors folded in by the wrapper, K6 with a slab pass): the
// coords are decoded once per 256 features and once per cluster, not once
// per 32 features; a window of entries decodes at once; loads are 16 B a
// lane and the sums live in registers; the factors cost 4 B per edge and
// per output row instead of a copy of x and a pass over y; output tiles
// split over a cluster of up to 4 blocks by edge count (at the default
// batch every case but layer 2's forward launches >= 264 blocks); K6 is one
// launch whose clusters walk all segments of their row tile.
//
// Determinism: a row's edges are ordered within a pass by shared-memory
// int atomics, so float32 sums may differ in the last bits from run to run
// (not bitwise reproducible).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LANE_FLOATS = 8;        // feature columns a lane accumulates
constexpr int SLAB = 32 * LANE_FLOATS;  // feature columns per block
constexpr int CAP = 2048;             // edge positions a block decodes a pass
constexpr int EPT = CAP / THREADS;    // edge positions per thread per pass
constexpr int EW = THREADS;           // entries per window
constexpr int UNROLL = 4;             // gathered rows in flight per warp
constexpr int BLOCKS_PER_SM = 2;      // the register budget's occupancy
constexpr int MIN_BLOCKS = 264;       // 2 per SM
constexpr int MAX_SPLIT = 4;          // blocks (one cluster) per output tile
constexpr int TARGET_EDGES = 2048;    // mean edges a block, at most (split)

enum Mode { FWD = 0, TRANS = 1, SEG = 2 };

// The block's shared memory (dynamic: more than 48 KB).
struct alignas(16) Smem {
  int in_row[CAP];                    // the block's share of the pass's
  float w[CAP];                       //   edges sorted by row: input row,
  uint8_t row[CAP];                   //   per-edge value, output row
  int ptr[256];                       // the block's edges per row
  int base[256];                      // a row's first slot for this block
  int bstart[MAX_SPLIT + 1];          // each block's first sorted slot
  int ent_pre[EW];                    // window: prefix of edge counts
  int ent_off[EW];                    // window: first edge
  int ent_in[EW];                     // window: first input row
  int scan_tot[WARPS];
  int first_row[WARPS];               // warp's first / last row (-1: none)
  int last_row[WARPS];
  int blk_first, blk_last;            // the block's first / last row
  uint8_t written[256];               // row written by an earlier pass
  float out_fac[256];                 // out_fac of the tile's rows
  // partial sums of each warp's first and last row, and of the block's
  // (read by the cluster's other blocks), [slot][q][lane]
  float comb[WARPS][2][LANE_FLOATS][32];
  float bcomb[2][LANE_FLOATS][32];
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

// V floats at p (aligned to 4V bytes) into v / from v (adding to what p
// holds when `add`); y is written with an evict-first hint, so the L2
// keeps x's slab.
template <int V>
__device__ __forceinline__ void ld(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void st(float* p, const float* v, bool add) {
  if constexpr (V == 4) {
    float4 t = make_float4(v[0], v[1], v[2], v[3]);
    if (add) {
      const float4 o = *reinterpret_cast<const float4*>(p);
      t.x += o.x; t.y += o.y; t.z += o.z; t.w += o.w;
    }
    __stcs(reinterpret_cast<float4*>(p), t);
  } else if constexpr (V == 2) {
    float2 t = make_float2(v[0], v[1]);
    if (add) {
      const float2 o = *reinterpret_cast<const float2*>(p);
      t.x += o.x; t.y += o.y;
    }
    __stcs(reinterpret_cast<float2*>(p), t);
  } else {
    __stcs(p, add ? p[0] + v[0] : v[0]);
  }
}

// The lane's LANE_FLOATS floats of row `in` of x within the slab: columns
// col0 + j * 32 * V .. + V for j < LANE_FLOATS / V; zeros past F or when
// !ok.
template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         int in, int F, int col0, bool ok,
                                         float (&v)[LANE_FLOATS]) {
  const float* p = x + (size_t)in * F + col0;
#pragma unroll
  for (int j = 0; j < LANE_FLOATS / V; ++j) {
    if (ok && col0 + j * 32 * V < F) {
      ld<V>(p + j * 32 * V, v + j * V);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[j * V + k] = 0.f;
    }
  }
}

// Writes out_fac * a into tile-local row r of y (the lane's columns), or
// adds it where an earlier pass wrote the row. One warp calls it for a
// row, once per pass.
template <int V>
__device__ __forceinline__ void flush_row(const Smem& s, float* y, int r,
                                          int row_base, int F, int col0,
                                          const float (&a)[LANE_FLOATS]) {
  float* p = y + (size_t)(row_base + r) * F + col0;
  const float scale = s.out_fac[r];
  const bool add = s.written[r];
#pragma unroll
  for (int j = 0; j < LANE_FLOATS / V; ++j) {
    if (col0 + j * 32 * V >= F) continue;
    float t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = scale * a[j * V + k];
    st<V>(p + j * 32 * V, t, add);
  }
}

__device__ __forceinline__ void put(float (*dst)[32],
                                    const float (&a)[LANE_FLOATS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < LANE_FLOATS; ++q) dst[q][lane] = a[q];
}

__device__ __forceinline__ void add_from(float (&a)[LANE_FLOATS],
                                         const float (*src)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < LANE_FLOATS; ++q) a[q] += src[q][lane];
}

// A launch's operands (order = t_order for the transpose, seg_ptr for
// K6; ns = K6's segment count; split = blocks per output tile).
struct Args {
  const int16_t* coords;
  const float* vals;
  const int32_t* blk_rc;
  const int32_t* off;
  const int32_t* order;
  int nb, ns;
  const float* x;
  const float* in_fac;
  const float* out_fac;
  float* y;
  int F, bm, bk, shift, split;
};

template <int MODE, bool HAS_VALS, int V>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
edge_stream_kernel(const Args a) {
  const int16_t* __restrict__ coords = a.coords;
  const float* __restrict__ vals = a.vals;
  const int32_t* __restrict__ blk_rc = a.blk_rc;
  const int32_t* __restrict__ off = a.off;
  const int32_t* __restrict__ order = a.order;
  const float* __restrict__ x = a.x;
  const float* __restrict__ in_fac = a.in_fac;
  float* y = a.y;
  const int nb = a.nb, ns = a.ns, F = a.F, bm = a.bm, bk = a.bk;
  const int shift = a.shift, split = a.split;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b_out = MODE == TRANS ? bk : bm;
  const int tile = blockIdx.x / split;
  const int part = blockIdx.x % split;          // rank in the cluster
  const int row_base = tile * b_out;
  const int col0 = blockIdx.y * SLAB + lane * V;

  if (tid < b_out) {
    s.written[tid] = 0;
    s.out_fac[tid] = a.out_fac[row_base + tid];
  }
  // the run of entries (segments for K6) with this tile's key, from two
  // lower bounds; all threads search at once, one load a round
  const int n_keys = MODE == SEG ? ns : nb;
  auto key_at = [&](int k) {
    if (MODE == SEG) {
      const int e = order[k];
      return e >= nb ? INT_MAX : (blk_rc[e] >> 16);
    }
    return MODE == TRANS ? (blk_rc[order[k]] & 0xFFFF) : (blk_rc[k] >> 16);
  };
  auto lower_bound = [&](int target) {
    int lo = 0, hi = n_keys;                  // the bound is in [lo, hi]
    while (hi - lo > THREADS) {
      // THREADS evenly spaced samples; the bound follows the last one
      // below target
      const int q = lo + static_cast<int>((long)tid * (hi - lo) / THREADS);
      const int c = __syncthreads_count(key_at(q) < target);
      const int span = hi - lo;
      if (c < THREADS)
        hi = lo + static_cast<int>((long)c * span / THREADS);
      if (c > 0)
        lo += static_cast<int>((long)(c - 1) * span / THREADS) + 1;
    }
    return lo + __syncthreads_count(lo + tid < hi &&
                                    key_at(lo + tid) < target);
  };
  int k_lo = lower_bound(tile);
  int k_hi = lower_bound(tile + 1);
  if (MODE == SEG) {
    // the row tile's segments [k_lo, k_hi) cover entries
    // [seg_ptr[k_lo], seg_ptr[k_hi]); no segment: nothing
    if (k_lo < k_hi) {
      k_hi = min(order[k_hi], nb);
      k_lo = order[k_lo];
    } else {
      k_lo = k_hi = 0;
    }
  }

  for (int kw = k_lo; kw < k_hi; kw += EW) {
    const int nw = min(EW, k_hi - kw);
    int cnt = 0;
    if (tid < nw) {
      const int e = MODE == TRANS ? order[kw + tid] : kw + tid;
      cnt = max(off[nb + 1 + e], 0);
      const int rc = blk_rc[e];
      s.ent_off[tid] = off[e];
      s.ent_in[tid] = MODE == TRANS ? (rc >> 16) * bm : (rc & 0xFFFF) * bk;
    }
    int tot;
    const int ex = block_scan(cnt, s.scan_tot, &tot);
    s.ent_pre[tid] = ex;
    __syncthreads();

    // a pass covers split * CAP edge positions: each block of the cluster
    // decodes CAP of them, the cluster sorts them by output row together,
    // and each block gathers its share of the sorted order
    for (int c0 = 0; c0 < tot; c0 += split * CAP) {
      // 1. decode this block's positions, count them per output row
      if (tid < b_out) s.ptr[tid] = 0;
      __syncthreads();
      // positions first, then all their coords in flight at once, then
      // the counts (loops end with the block's positions)
      const int n_pos = min(CAP, tot - c0 - part * CAP);
      int my_idx[EPT], my_in[EPT], my_key[EPT];   // key: rank << 8 | row
      float my_w[EPT];
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (i * THREADS >= n_pos) break;
        const int p = c0 + part * CAP + i * THREADS + tid;
        my_idx[i] = -1;
        if (i * THREADS + tid < n_pos) {
          // the entry holding p: the last j with ent_pre[j] <= p
          int lo = 0;
#pragma unroll
          for (int step = EW / 2; step > 0; step >>= 1)
            if (lo + step < nw && s.ent_pre[lo + step] <= p) lo += step;
          my_idx[i] = s.ent_off[lo] + (p - s.ent_pre[lo]);
          my_in[i] = s.ent_in[lo];
        }
      }
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (i * THREADS >= n_pos) break;
        my_key[i] = my_idx[i] >= 0 ? static_cast<uint16_t>(coords[my_idx[i]])
                                   : -1;
        if (HAS_VALS && my_idx[i] >= 0) my_w[i] = __ldg(vals + my_idx[i]);
      }
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (i * THREADS >= n_pos) break;
        int o = -1;
        if (my_key[i] >= 0) {
          const int lr = my_key[i] >> shift;
          const int lc = my_key[i] & (bk - 1);
          // a row past the tile is dropped, as the TPU kernel's one-hot does
          if (lr < bm) {
            o = MODE == TRANS ? lc : lr;
            my_in[i] += MODE == TRANS ? lr : lc;
          }
        }
        // one shared-memory atomic per distinct row in the warp
        const unsigned peers = __match_any_sync(0xffffffffu, o);
        my_key[i] = -1;
        if (o >= 0) {
          const int leader = __ffs(peers) - 1;
          int base = 0;
          if (lane == leader) base = atomicAdd(&s.ptr[o], __popc(peers));
          base = __shfl_sync(peers, base, leader);
          my_key[i] = (base + __popc(peers & ((1u << lane) - 1))) << 8 | o;
        }
      }
      // 2. the cluster's row CSR: a row's edges take the blocks' counts in
      //    block order, so every edge has one slot in the sorted order
      cluster.sync();                           // every count is final
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
      // each edge to its slot, in the block that gathers that slot
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (i * THREADS >= n_pos) break;
        if (my_key[i] >= 0) {
          const int o = my_key[i] & 0xFF;
          const int g = s.base[o] + (my_key[i] >> 8);
          int d = 0;
          while (s.bstart[d + 1] <= g) ++d;
          const int li = g - s.bstart[d];
          Smem* dst = cluster.map_shared_rank(&s, d);
          dst->in_row[li] = my_in[i];
          if (HAS_VALS) dst->w[li] = my_w[i];
          dst->row[li] = static_cast<uint8_t>(o);
        }
      }
      cluster.sync();                           // every edge is in place

      // 3. this block's share of the sorted edges, split evenly over its
      //    warps; rows are summed in registers
      const int m = s.bstart[part + 1] - s.bstart[part];
      const int eb = m * warp / WARPS, ee = m * (warp + 1) / WARPS;
      float acc[LANE_FLOATS];
      int cur = -1, first = -1;
      for (int e = eb; e < ee; e += UNROLL) {
        float v[UNROLL][LANE_FLOATS];
        float ww[UNROLL];
        int rr[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const bool ok = e + u < ee;
          const int in = ok ? s.in_row[e + u] : 0;
          rr[u] = ok ? s.row[e + u] : -1;
          // the weight: value * in_fac, loaded beside the row
          ww[u] = ok ? __ldg(in_fac + in) : 0.f;
          if (HAS_VALS && ok) ww[u] *= s.w[e + u];
          load_row<V>(x, in, F, col0, ok, v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (rr[u] < 0) continue;
          if (rr[u] != cur) {
            if (cur >= 0) {
              if (first < 0) {
                first = cur;
                put(s.comb[warp][0], acc);
              } else {
                // an interior row: this warp holds all of its edges
                flush_row<V>(s, y, cur, row_base, F, col0, acc);
              }
            }
            cur = rr[u];
#pragma unroll
            for (int q = 0; q < LANE_FLOATS; ++q) acc[q] = 0.f;
          }
#pragma unroll
          for (int q = 0; q < LANE_FLOATS; ++q) acc[q] += ww[u] * v[u][q];
        }
      }
      // 4. rows that continue past a warp: partials through shared
      //    memory, summed in warp order
      if (cur >= 0) {
        if (first < 0) first = cur;            // the warp saw one row
        put(s.comb[warp][cur == first ? 0 : 1], acc);
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
        // A warp sums a boundary row unless an earlier warp ends on it.
        for (int slot = 0; slot < 2; ++slot) {
          const int r = slot ? cur : first;
          if (slot == 1 && cur == first) break;
          if (slot == 0) {
            bool own = true;
            for (int w2 = warp - 1; w2 >= 0; --w2) {
              if (s.first_row[w2] >= 0) {
                own = s.last_row[w2] != r;
                break;
              }
            }
            if (!own) continue;
          }
          float sum[LANE_FLOATS];
#pragma unroll
          for (int q = 0; q < LANE_FLOATS; ++q) sum[q] = 0.f;
          add_from(sum, s.comb[warp][slot]);
          for (int w2 = warp + 1; w2 < WARPS; ++w2) {
            if (s.first_row[w2] < 0) continue;
            if (s.first_row[w2] != r) break;
            add_from(sum, s.comb[w2][0]);
            if (s.last_row[w2] != r) break;
          }
          // the block's first and last row may continue in the cluster's
          // neighbouring blocks
          if (r == s.blk_first) put(s.bcomb[0], sum);
          else if (r == s.blk_last) put(s.bcomb[1], sum);
          else flush_row<V>(s, y, r, row_base, F, col0, sum);
        }
      }
      // 5. the same one level up: rows that continue past a block, summed
      //    in block order through the cluster's shared memory
      __threadfence();
      cluster.sync();
      if (warp == 0 && s.blk_first >= 0) {
        for (int slot = 0; slot < 2; ++slot) {
          const int r = slot ? s.blk_last : s.blk_first;
          if (slot == 1 && s.blk_last == s.blk_first) break;
          if (slot == 0) {
            bool own = true;
            for (int p2 = part - 1; p2 >= 0; --p2) {
              const Smem* o = cluster.map_shared_rank(&s, p2);
              if (o->blk_first >= 0) {
                own = o->blk_last != r;
                break;
              }
            }
            if (!own) continue;
          }
          float sum[LANE_FLOATS];
#pragma unroll
          for (int q = 0; q < LANE_FLOATS; ++q) sum[q] = 0.f;
          add_from(sum, s.bcomb[slot]);
          for (int p2 = part + 1; p2 < split; ++p2) {
            const Smem* o = cluster.map_shared_rank(&s, p2);
            if (o->blk_first < 0) continue;
            if (o->blk_first != r) break;
            add_from(sum, o->bcomb[0]);
            if (o->blk_last != r) break;
          }
          flush_row<V>(s, y, r, row_base, F, col0, sum);
        }
      }
      // a row counts as written once every flush of the pass read the flag
      // (the next pass's cluster barriers order the rest: the rows' writes
      // before their next read, the shared arrays' reads before reuse)
      __threadfence();
      __syncthreads();
      if (row_has) s.written[tid] = 1;
    }
  }
  // no block leaves while the cluster may still read its shared memory
  cluster.sync();

  // rows no edge reaches read 0; the cluster's blocks share them out
  __syncthreads();
  const float zero[LANE_FLOATS] = {};
  for (int r = part * WARPS + warp; r < b_out; r += split * WARPS)
    if (!s.written[r]) flush_row<V>(s, y, r, row_base, F, col0, zero);
}

// Blocks (one cluster) per output tile: the fewest (a power of two, at
// most MAX_SPLIT) that give MIN_BLOCKS blocks and at most TARGET_EDGES of
// the e_slots packed edge slots a block on average.
int tile_split(int n_out_tiles, int F, long e_slots) {
  const long n_slabs = (F + SLAB - 1) / SLAB;
  int split = 1;
  while (split < MAX_SPLIT &&
         ((long)n_out_tiles * split * n_slabs < MIN_BLOCKS ||
          e_slots > (long)TARGET_EDGES * n_out_tiles * split))
    split *= 2;
  return split;
}

// The widest vector (4, 2 or 1 floats) that F and both row bases allow.
int vec_width(int F, const void* x, const void* y) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y);
  if (F % 4 == 0 && a % 16 == 0) return 4;
  if (F % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// One launch of a kernel variant, with a cluster of `split` blocks per
// output tile; its shared memory is over the 48 KB default, so the first
// launch raises the variant's limit.
template <int MODE, bool HAS_VALS, int V>
int run(const Args& a, dim3 grid, cudaStream_t stream) {
  auto kernel = edge_stream_kernel<MODE, HAS_VALS, V>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(Smem);
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

template <int MODE, bool HAS_VALS>
int launch(Args a, int n_out_tiles, long e_slots, cudaStream_t stream) {
  while ((1 << a.shift) < a.bk) ++a.shift;
  a.split = tile_split(n_out_tiles, a.F, e_slots);
  const dim3 grid(n_out_tiles * a.split, (a.F + SLAB - 1) / SLAB);
  switch (vec_width(a.F, a.x, a.y)) {
    case 4: return run<MODE, HAS_VALS, 4>(a, grid, stream);
    case 2: return run<MODE, HAS_VALS, 2>(a, grid, stream);
    default: return run<MODE, HAS_VALS, 1>(a, grid, stream);
  }
}

}  // namespace

// K1 on n_out_tiles output tiles; e_slots = coords' element count (the
// packed edge slots, which size the split). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int edge_stream_spmm_f32(const void* coords, const void* vals,
                                    const void* blk_rc, const void* off,
                                    const void* t_order, int nb,
                                    const void* x, const void* in_fac,
                                    const void* out_fac, void* y,
                                    int n_out_tiles, long e_slots, int F,
                                    int bm, int bk, int transpose,
                                    void* stream) {
  if (n_out_tiles <= 0 || F <= 0) return 0;
  const Args a{static_cast<const int16_t*>(coords),
               static_cast<const float*>(vals),
               static_cast<const int32_t*>(blk_rc),
               static_cast<const int32_t*>(off),
               static_cast<const int32_t*>(t_order), nb, 0,
               static_cast<const float*>(x),
               static_cast<const float*>(in_fac),
               static_cast<const float*>(out_fac), static_cast<float*>(y),
               F, bm, bk, 0, 1};
  auto s = static_cast<cudaStream_t>(stream);
  if (transpose)
    return vals ? launch<TRANS, true>(a, n_out_tiles, e_slots, s)
                : launch<TRANS, false>(a, n_out_tiles, e_slots, s);
  return vals ? launch<FWD, true>(a, n_out_tiles, e_slots, s)
              : launch<FWD, false>(a, n_out_tiles, e_slots, s);
}

// K6: the forward over the segments seg_ptr[0..ns], one launch. Returns
// cudaGetLastError() after it.
extern "C" int edge_stream_spmm_seg_f32(const void* coords,
                                        const void* blk_rc, const void* off,
                                        const void* seg_ptr, int nb, int ns,
                                        const void* x, const void* in_fac,
                                        const void* out_fac, void* y,
                                        int n_row_tiles, long e_slots, int F,
                                        int bm, int bk, void* stream) {
  if (n_row_tiles <= 0 || F <= 0) return 0;
  const Args a{static_cast<const int16_t*>(coords), nullptr,
               static_cast<const int32_t*>(blk_rc),
               static_cast<const int32_t*>(off),
               static_cast<const int32_t*>(seg_ptr), nb, ns,
               static_cast<const float*>(x),
               static_cast<const float*>(in_fac),
               static_cast<const float*>(out_fac), static_cast<float*>(y),
               F, bm, bk, 0, 1};
  return launch<SEG, false>(a, n_row_tiles, e_slots,
                            static_cast<cudaStream_t>(stream));
}

// Thread blocks one K1 / K6 launch runs for n_out_tiles output tiles at
// width F over e_slots packed edge slots.
extern "C" int edge_stream_blocks(int n_out_tiles, long e_slots, int F) {
  if (n_out_tiles <= 0 || F <= 0) return 0;
  return n_out_tiles * tile_split(n_out_tiles, F, e_slots) *
         ((F + SLAB - 1) / SLAB);
}
