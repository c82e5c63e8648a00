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
//   bwd_kv: dk[c] += ds*q[r], dv[c] += e*gn[r]
//
// Layout (as the TPU kernel's): int16 coords (lr << log2 bk) | lc local
// to the edge's (bm x bk) tile, decoded as uint16; entries blk_rc =
// rt << 16 | ct sorted rt-major; off[2, nb + 1] = (edge offset, count);
// t_order = the ct-major visit permutation. Sentinel and pad entries have
// count 0. A local row >= bm is dropped, and a coordinate repeated within
// one entry counts once (the TPU kernel masks its densified tile with
// A01 > 0); a shared-memory bitmap of the tile finds the repeats.
//
// The TPU kernel densifies each tile on the MXU from one-hot operands
// because the TPU has no gather hardware; the cold tiles are sparse (tens
// of edges in a 256 x 256 tile), and the H100 gathers rows cheaply, so
// these kernels work per edge. Each call runs two passes, without global
// float atomics:
//   1. edge pass, one block per entry: decode the entry's edges, then one
//      warp per edge computes the full-width dot products per head and
//      writes the per-edge terms (s, e or ds and e) in flat edge order to
//      a scratch array [n_edges, H] (about 1.2 MB at the main path's
//      first layer). Every output block of pass 2 reads these scores
//      instead of recomputing them for each feature chunk.
//   2. reduction, one block per output tile, found by binary search in
//      the visit order (rt-major for rows, t_order for columns):
//      - row terms (m, den): [bm, H] accumulators in shared memory
//        (shared-memory atomic max / add), one warp per entry;
//      - feature outputs (num, dq, dk, dv): one block per (output tile,
//        32-column chunk), the structure of edge_stream.cu (K1): warps
//        split the edges, lane l gathers src[in_row, f0 + l] and adds
//        w[edge, head(f)] * src into a float32 [b_out, 32] shared tile;
//        an edge whose weight is exactly 0 adds nothing (select).
//   Every output element is written exactly once; tiles without edges
//   write NEG_SENTINEL (m) or zeros. Shared-memory atomics sum in an
//   order that varies from run to run, so results agree with the plain
//   version to float32 rounding, not bit for bit.
//
// Bound on this card: each call must read the coords (2 B/edge), the
// entry tables, q/k/v and the row terms once and write its outputs once;
// it does 2*n_out flops per edge and dot product on float32 CUDA cores.
// At the main path's shapes (n_out 512, tens of edges per tile) the bytes
// dominate. The kernels read each edge's q/k/v rows again per edge (and
// per 32-column chunk in pass 2); a tile's rows stay in L2, so most of
// those reads hit the cache rather than device memory.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 256;   // edges decoded into shared memory at once
constexpr int FC = 32;       // feature columns per pass-2 block: one per lane
constexpr float NEG_SENTINEL = -FLT_MAX;

enum EdgeMode { SCORE = 0, EXP = 1, BWD = 2 };

#define RETURN_ON_ERROR()                         \
  do {                                            \
    cudaError_t err_ = cudaGetLastError();        \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max on a float in shared memory: integer max for values with the sign
// bit clear, unsigned min for values with it set
__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

// lower bound of `target` over the visit order's tile key
template <bool TRANSPOSE>
__device__ int run_start(const int32_t* blk_rc, const int32_t* t_order,
                         int nb, int target) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int rc = blk_rc[TRANSPOSE ? t_order[mid] : mid];
    const int key = TRANSPOSE ? (rc & 0xFFFF) : (rc >> 16);
    if (key < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 1: one block per entry; per-edge terms into w0 (and w1) at
// [flat edge index * H + h].
template <int MODE>
__global__ void __launch_bounds__(THREADS)
edge_kernel(const int16_t* __restrict__ coords,
            const int32_t* __restrict__ blk_rc,
            const int32_t* __restrict__ off, int nb,
            const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ rm,
            const float* __restrict__ gd, const float* __restrict__ gn,
            float* __restrict__ w0, float* __restrict__ w1, int n_out,
            int H, int d, int bm, int bk, int shift) {
  extern __shared__ uint32_t seen[];   // [bm * bk / 32] bits of the tile
  __shared__ int s_r[CHUNK];           // global row, -1 = not counted
  __shared__ int s_c[CHUNK];           // global col
  const int ent = blockIdx.x;
  const int cnt = off[nb + 1 + ent];
  if (cnt <= 0) return;                // sentinel / pad entry
  const int base = off[ent];
  const int rc = blk_rc[ent];
  const int r0 = (rc >> 16) * bm, c0 = (rc & 0xFFFF) * bk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < (bm * bk) >> 5; i += THREADS) seen[i] = 0u;

  for (int j0 = 0; j0 < cnt; j0 += CHUNK) {
    const int n = min(CHUNK, cnt - j0);
    __syncthreads();   // bitmap cleared / previous chunk consumed
    if (threadIdx.x < n) {
      const uint32_t code =
          static_cast<uint16_t>(coords[base + j0 + threadIdx.x]);
      const int lr = static_cast<int>(code >> shift);
      const int lc = static_cast<int>(code & (bk - 1));
      bool ok = lr < bm;   // a row past the tile is dropped
      if (ok) {
        const int bit = lr * bk + lc;
        const uint32_t mask = 1u << (bit & 31);
        ok = (atomicOr(&seen[bit >> 5], mask) & mask) == 0u;  // first copy
      }
      s_r[threadIdx.x] = ok ? r0 + lr : -1;
      s_c[threadIdx.x] = c0 + lc;
    }
    __syncthreads();
    for (int j = warp; j < n; j += WARPS) {   // one warp per edge
      const int r = s_r[j], c = s_c[j];
      const size_t slot = (size_t)(base + j0 + j) * H;
      if (r < 0) {
        if (lane < H) {
          w0[slot + lane] = MODE == SCORE ? NEG_SENTINEL : 0.f;
          if (MODE == BWD && w1 != nullptr) w1[slot + lane] = 0.f;
        }
        continue;
      }
      const float* qr = q + (size_t)r * n_out;
      const float* kc = k + (size_t)c * n_out;
      const float* vc = MODE == BWD ? v + (size_t)c * n_out : nullptr;
      const float* gr = MODE == BWD ? gn + (size_t)r * n_out : nullptr;
      for (int h = 0; h < H; ++h) {
        float s = 0.f, t = 0.f;
        for (int f = h * d + lane; f < (h + 1) * d; f += 32) {
          s = fmaf(__ldg(qr + f), __ldg(kc + f), s);
          if (MODE == BWD) t = fmaf(__ldg(gr + f), __ldg(vc + f), t);
        }
        s = warp_sum(s);
        if (MODE == BWD) t = warp_sum(t);
        if (lane == 0) {
          if (MODE == SCORE) {
            w0[slot + h] = s;
          } else {
            const float e = expf(s - rm[(size_t)r * H + h]);
            if (MODE == EXP) {
              w0[slot + h] = e;
            } else {
              const float tt = gd[(size_t)r * H + h] + t;
              w0[slot + h] = e > 0.f ? e * tt : 0.f;
              if (w1 != nullptr) w1[slot + h] = e;
            }
          }
        }
      }
    }
  }
}

// Pass 2, row terms: one block per row tile; out[r, h] = max (IS_MAX) or
// sum of w[edge, h] over the tile's edges, one warp per entry.
template <bool IS_MAX>
__global__ void __launch_bounds__(THREADS)
row_reduce_kernel(const int16_t* __restrict__ coords,
                  const int32_t* __restrict__ blk_rc,
                  const int32_t* __restrict__ off, int nb,
                  const float* __restrict__ w, float* __restrict__ out,
                  int H, int bm, int shift) {
  extern __shared__ float acc[];   // [bm * H]
  __shared__ int run[2];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < bm * H; i += THREADS)
    acc[i] = IS_MAX ? NEG_SENTINEL : 0.f;
  if (threadIdx.x < 2)
    run[threadIdx.x] = run_start<false>(blk_rc, nullptr, nb,
                                          tile + threadIdx.x);
  __syncthreads();
  for (int e = run[0] + warp; e < run[1]; e += WARPS) {
    const int cnt = off[nb + 1 + e];
    const int base = off[e];
    for (int j = lane; j < cnt; j += 32) {
      const uint32_t code = static_cast<uint16_t>(coords[base + j]);
      const int lr = static_cast<int>(code >> shift);
      if (lr >= bm) continue;
      for (int h = 0; h < H; ++h) {
        const float x = w[(size_t)(base + j) * H + h];
        if (IS_MAX) atomic_max_f32(&acc[lr * H + h], x);
        else if (x != 0.f) atomicAdd(&acc[lr * H + h], x);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bm * H; i += THREADS)
    out[(size_t)tile * bm * H + i] = acc[i];
}

// Pass 2, feature outputs: one block per (output tile, 32-column chunk);
// y[out, f] = sum over the tile's edges of w[edge, f / d] * src[in, f].
template <bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
agg_kernel(const int16_t* __restrict__ coords,
           const int32_t* __restrict__ blk_rc,
           const int32_t* __restrict__ off,
           const int32_t* __restrict__ t_order, int nb,
           const float* __restrict__ w, const float* __restrict__ src,
           float* __restrict__ y, int F, int H, int d, int bm, int bk,
           int shift) {
  extern __shared__ float smem[];
  __shared__ int run[2];
  const int b_out = TRANSPOSE ? bk : bm;
  float* acc = smem;                                          // [b_out][FC]
  int* s_out = reinterpret_cast<int*>(acc + b_out * FC);      // [CHUNK]
  int* s_in = s_out + CHUNK;                                  // [CHUNK]
  int* s_e = s_in + CHUNK;                                    // [CHUNK]

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.y * FC + lane;
  const bool f_ok = f < F;
  const int head = f_ok ? f / d : 0;

  for (int i = threadIdx.x; i < b_out * FC; i += THREADS) acc[i] = 0.f;
  if (threadIdx.x < 2)
    run[threadIdx.x] = run_start<TRANSPOSE>(blk_rc, t_order, nb,
                                              tile + threadIdx.x);
  __syncthreads();
  const int k_lo = run[0], k_hi = run[1];

  for (int kk = k_lo; kk < k_hi; ++kk) {
    const int e = TRANSPOSE ? t_order[kk] : kk;
    const int cnt = off[nb + 1 + e];   // uniform over the block
    if (cnt <= 0) continue;            // sentinel / pad entry
    const int base = off[e];
    const int rc = blk_rc[e];
    const int in_base = TRANSPOSE ? (rc >> 16) * bm : (rc & 0xFFFF) * bk;
    for (int c0 = 0; c0 < cnt; c0 += CHUNK) {
      const int n = min(CHUNK, cnt - c0);
      __syncthreads();                 // the previous chunk is consumed
      if (threadIdx.x < n) {
        const int idx = base + c0 + threadIdx.x;
        const uint32_t code = static_cast<uint16_t>(coords[idx]);
        const int lr = static_cast<int>(code >> shift);
        const int lc = static_cast<int>(code & (bk - 1));
        // a dropped edge (row past the tile) carries weight 0 from pass 1
        const bool ok = lr < bm;
        s_out[threadIdx.x] = ok ? (TRANSPOSE ? lc : lr) : 0;
        s_in[threadIdx.x] = in_base + (ok ? (TRANSPOSE ? lr : lc) : 0);
        s_e[threadIdx.x] = idx;
      }
      __syncthreads();
      if (f_ok) {
        int j = warp;
        // two independent gathers in flight per warp before the adds
        for (; j + WARPS < n; j += 2 * WARPS) {
          const float a0 = w[(size_t)s_e[j] * H + head];
          const float a1 = w[(size_t)s_e[j + WARPS] * H + head];
          const float x0 = __ldg(src + (size_t)s_in[j] * F + f);
          const float x1 = __ldg(src + (size_t)s_in[j + WARPS] * F + f);
          if (a0 != 0.f) atomicAdd(&acc[s_out[j] * FC + lane], a0 * x0);
          if (a1 != 0.f)
            atomicAdd(&acc[s_out[j + WARPS] * FC + lane], a1 * x1);
        }
        for (; j < n; j += WARPS) {
          const float a = w[(size_t)s_e[j] * H + head];
          if (a != 0.f)
            atomicAdd(&acc[s_out[j] * FC + lane],
                      a * __ldg(src + (size_t)s_in[j] * F + f));
        }
      }
    }
  }
  __syncthreads();
  if (f_ok) {
    for (int r = warp; r < b_out; r += WARPS)
      y[(size_t)(tile * b_out + r) * F + f] = acc[r * FC + lane];
  }
}

struct Tiles {
  const int16_t* coords;
  const int32_t* blk_rc;
  const int32_t* off;
  const int32_t* t_order;
  int nb, bm, bk, shift;
};

Tiles make_tiles(const void* coords, const void* blk_rc, const void* off,
                 const void* t_order, int nb, int bm, int bk) {
  int shift = 0;
  while ((1 << shift) < bk) ++shift;
  return Tiles{static_cast<const int16_t*>(coords),
               static_cast<const int32_t*>(blk_rc),
               static_cast<const int32_t*>(off),
               static_cast<const int32_t*>(t_order), nb, bm, bk, shift};
}

template <int MODE>
int edge_pass(const Tiles& t, const float* q, const float* k, const float* v,
              const float* rm, const float* gd, const float* gn, float* w0,
              float* w1, int n_out, int H, cudaStream_t s) {
  if (t.nb <= 0) return 0;
  const size_t smem = (size_t)t.bm * t.bk / 8;
  edge_kernel<MODE><<<t.nb, THREADS, smem, s>>>(
      t.coords, t.blk_rc, t.off, t.nb, q, k, v, rm, gd, gn, w0, w1, n_out,
      H, n_out / H, t.bm, t.bk, t.shift);
  RETURN_ON_ERROR();
  return 0;
}

template <bool IS_MAX>
int row_reduce(const Tiles& t, const float* w, float* out, int nrows, int H,
               cudaStream_t s) {
  const size_t smem = (size_t)t.bm * H * sizeof(float);
  row_reduce_kernel<IS_MAX><<<nrows / t.bm, THREADS, smem, s>>>(
      t.coords, t.blk_rc, t.off, t.nb, w, out, H, t.bm, t.shift);
  RETURN_ON_ERROR();
  return 0;
}

template <bool TRANSPOSE>
int aggregate(const Tiles& t, const float* w, const float* src, float* y,
              int n_out_rows, int F, int H, cudaStream_t s) {
  const int b_out = TRANSPOSE ? t.bk : t.bm;
  const size_t smem = (size_t)b_out * FC * sizeof(float) +
                      (size_t)CHUNK * 3 * sizeof(int);
  dim3 grid(n_out_rows / b_out, (F + FC - 1) / FC);
  agg_kernel<TRANSPOSE><<<grid, THREADS, smem, s>>>(
      t.coords, t.blk_rc, t.off, t.t_order, t.nb, w, src, y, F, H, F / H,
      t.bm, t.bk, t.shift);
  RETURN_ON_ERROR();
  return 0;
}

#define CHECK(call)                  \
  do {                               \
    const int err_ = (call);         \
    if (err_ != 0) return err_;      \
  } while (0)

}  // namespace

// Every entry point takes (tiles, nb, inputs..., scratch..., outputs...,
// nrows, ncols, n_out, H, bm, bk, stream) and returns 0 when every launch
// was accepted, else the cudaError_t of the first refused launch. `w` /
// `w_e` are per-edge scratch arrays of [coords.numel(), H] floats; nrows /
// ncols are multiples of bm / bk; t_order is read by bwd_kv only.

// K3: m[nrows, H]
extern "C" int esattn_rowmax_f32(const void* coords, const void* blk_rc,
                                 const void* off, const void* t_order, int nb,
                                 const void* q, const void* k, void* w,
                                 void* m, int nrows, int ncols, int n_out,
                                 int H, int bm, int bk, void* stream) {
  if (nrows <= 0 || n_out <= 0 || H <= 0) return 0;
  const Tiles t = make_tiles(coords, blk_rc, off, t_order, nb, bm, bk);
  auto s = static_cast<cudaStream_t>(stream);
  auto ww = static_cast<float*>(w);
  CHECK(edge_pass<SCORE>(t, static_cast<const float*>(q),
                         static_cast<const float*>(k), nullptr, nullptr,
                         nullptr, nullptr, ww, nullptr, n_out, H, s));
  return row_reduce<true>(t, ww, static_cast<float*>(m), nrows, H, s);
}

// K4 forward: den[nrows, H], num[nrows, n_out]
extern "C" int esattn_terms_f32(const void* coords, const void* blk_rc,
                                const void* off, const void* t_order, int nb,
                                const void* q, const void* k, const void* v,
                                const void* rm, void* w, void* den, void* num,
                                int nrows, int ncols, int n_out, int H, int bm,
                                int bk, void* stream) {
  if (nrows <= 0 || n_out <= 0 || H <= 0) return 0;
  const Tiles t = make_tiles(coords, blk_rc, off, t_order, nb, bm, bk);
  auto s = static_cast<cudaStream_t>(stream);
  auto ww = static_cast<float*>(w);
  CHECK(edge_pass<EXP>(t, static_cast<const float*>(q),
                       static_cast<const float*>(k), nullptr,
                       static_cast<const float*>(rm), nullptr, nullptr, ww,
                       nullptr, n_out, H, s));
  CHECK(row_reduce<false>(t, ww, static_cast<float*>(den), nrows, H, s));
  return aggregate<false>(t, ww, static_cast<const float*>(v),
                          static_cast<float*>(num), nrows, n_out, H, s);
}

// K4 backward, rt-major: dq[nrows, n_out]
extern "C" int esattn_bwd_q_f32(const void* coords, const void* blk_rc,
                                const void* off, const void* t_order, int nb,
                                const void* q, const void* k, const void* v,
                                const void* rm, const void* gd,
                                const void* gn, void* w, void* dq, int nrows,
                                int ncols, int n_out, int H, int bm, int bk,
                                void* stream) {
  if (nrows <= 0 || n_out <= 0 || H <= 0) return 0;
  const Tiles t = make_tiles(coords, blk_rc, off, t_order, nb, bm, bk);
  auto s = static_cast<cudaStream_t>(stream);
  auto ww = static_cast<float*>(w);
  CHECK(edge_pass<BWD>(t, static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(rm),
                       static_cast<const float*>(gd),
                       static_cast<const float*>(gn), ww, nullptr, n_out, H,
                       s));
  return aggregate<false>(t, ww, static_cast<const float*>(k),
                          static_cast<float*>(dq), nrows, n_out, H, s);
}

// K4 backward, t_order (col-tile-major): dk, dv [ncols, n_out]
extern "C" int esattn_bwd_kv_f32(const void* coords, const void* blk_rc,
                                 const void* off, const void* t_order, int nb,
                                 const void* q, const void* k, const void* v,
                                 const void* rm, const void* gd,
                                 const void* gn, void* w, void* w_e, void* dk,
                                 void* dv, int nrows, int ncols, int n_out,
                                 int H, int bm, int bk, void* stream) {
  if (ncols <= 0 || n_out <= 0 || H <= 0) return 0;
  const Tiles t = make_tiles(coords, blk_rc, off, t_order, nb, bm, bk);
  auto s = static_cast<cudaStream_t>(stream);
  auto ww = static_cast<float*>(w);
  auto we = static_cast<float*>(w_e);
  CHECK(edge_pass<BWD>(t, static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(rm),
                       static_cast<const float*>(gd),
                       static_cast<const float*>(gn), ww, we, n_out, H, s));
  CHECK(aggregate<true>(t, ww, static_cast<const float*>(q),
                        static_cast<float*>(dk), ncols, n_out, H, s));
  return aggregate<true>(t, we, static_cast<const float*>(gn),
                         static_cast<float*>(dv), ncols, n_out, H, s);
}
