// Edge-stream SpMM for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes; see gnn_tpu_torch/ops/edgestream.py).
//
// Replaces two TPU kernels of gnn_tpu/ops/pallas_edgestream.py:
//   * edge_stream_spmm (Pallas kernel _edge_stream_kernel), K1 below;
//   * edge_stream_spmm_seg (Pallas kernel _edge_stream_seg_kernel), K6,
//     the segment-grid forward.
// Both compute, over one packed tile set,
//
//     y = A01 @ x          (forward,   y has nrows rows)
//     y = A01^T @ x        (transpose, K1 only, y has ncols rows)
//
// where A01 holds one entry per packed edge (times its per-edge value when
// `vals` is given, K1 only; duplicate edges sum). The rank-1 factors rv / nf
// are folded into x and y by the wrapper, as on the TPU.
//
// Layout (identical to the TPU kernels'): int16 coords (lr << log2 bk) | lc
// local to the edge's (bm x bk) tile, decoded as uint16 so 256x256 tiles
// with rows >= 128 do not sign-extend; entries blk_rc = rt << 16 | ct sorted
// rt-major; off[2, nb + 1] = (edge offset, edge count) per entry; t_order
// = the ct-major visit permutation for the transpose. Sentinel and pad
// entries have count 0.
//
// The TPU kernels densify each tile on the MXU from one-hot operands
// because the TPU has no gather hardware. The H100 gathers rows cheaply,
// so these kernels do the per-edge work directly (add_entry_edges): each
// entry's edges are decoded into shared memory, then 8 warps split the
// edges; lane l gathers x[in_row, f0 + l] and adds it into a float32
// shared-memory tile acc[b_out][32] with a shared-memory atomic. The order
// of those additions varies from run to run, so results agree with the
// plain version to float32 rounding, not bit for bit.
//
// K1: one thread block per (output tile, 32-wide feature chunk); the block
// finds its run of entries by binary search in the visit order (rt-major
// blk_rc forward, t_order transpose), so no global atomics are needed and
// every output element is written exactly once (tiles without edges get
// zeros).
//
// K6: the TPU kernel walks the segments of seg_ptr (runs of one row tile
// whose edges fit a 2 x 2048-edge coord window, gnn_tpu segment_tiles) in
// order, zeroing an output block on the first segment of its row tile and
// adding the later ones into it. The card's blocks run in no order, so the
// segment is the unit of parallel work: one block per (segment, 32-wide
// feature chunk) accumulates the segment in shared memory. A segment alone
// in its row tile writes y directly; segments that share a row tile each
// write a partial slab, and a second kernel sums the slabs in segment order
// (and writes zeros for row tiles no segment covers). No global float
// atomics; every output row is written exactly once; trailing padding
// segments (seg_ptr[j] == nb) do nothing.
//
// Bound on this card: the function must move x (n_in x F), y (n_out x F)
// and 2 bytes of coords per edge, and does 2 flops per edge and feature
// on float32 CUDA cores. At the main path's shapes the bytes dominate
// (memory-bound). The kernels read each edge's 128-byte row segment of x;
// a tile's edges fall in one bk-row window of x (at most 32 KB per block),
// which stays in L1/L2, so the repeated reads are served from cache rather
// than from device memory. K6's slabs add traffic only for row tiles split
// over several segments.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int FC = 32;       // feature columns per block: one per lane
constexpr int WARPS = 8;     // warps per block; they split the edges
constexpr int CHUNK = 256;   // edges decoded into shared memory at once

// Adds one entry's `cnt` edges (coords[base, base + cnt)) into acc. Every
// thread of the block calls it (it synchronises). in_base = first x row of
// the entry's input tile.
template <bool TRANSPOSE, bool HAS_VALS>
__device__ void add_entry_edges(const int16_t* __restrict__ coords,
                                const float* __restrict__ vals, int base,
                                int cnt, int in_base,
                                const float* __restrict__ x, int F, int f,
                                bool f_ok, int bm, int bk, int shift,
                                float* acc, int* s_out, int* s_in,
                                float* s_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < cnt; c0 += CHUNK) {
    const int n = min(CHUNK, cnt - c0);
    __syncthreads();                      // the previous chunk is consumed
    if (threadIdx.x < n) {
      const int idx = base + c0 + threadIdx.x;
      const uint32_t c = static_cast<uint16_t>(coords[idx]);
      const int lr = static_cast<int>(c >> shift);
      const int lc = static_cast<int>(c & (bk - 1));
      // a row past the tile is dropped, as the TPU kernel's one-hot does
      const bool ok = lr < bm;
      s_out[threadIdx.x] = ok ? (TRANSPOSE ? lc : lr) : 0;
      s_in[threadIdx.x] = in_base + (ok ? (TRANSPOSE ? lr : lc) : 0);
      s_w[threadIdx.x] = ok ? (HAS_VALS ? vals[idx] : 1.f) : 0.f;
    }
    __syncthreads();
    if (f_ok) {
      int j = warp;
      // four independent gathers in flight per warp before the adds
      for (; j + 3 * WARPS < n; j += 4 * WARPS) {
        const float v0 = __ldg(x + (size_t)s_in[j] * F + f);
        const float v1 = __ldg(x + (size_t)s_in[j + WARPS] * F + f);
        const float v2 = __ldg(x + (size_t)s_in[j + 2 * WARPS] * F + f);
        const float v3 = __ldg(x + (size_t)s_in[j + 3 * WARPS] * F + f);
        atomicAdd(&acc[s_out[j] * FC + lane], s_w[j] * v0);
        atomicAdd(&acc[s_out[j + WARPS] * FC + lane], s_w[j + WARPS] * v1);
        atomicAdd(&acc[s_out[j + 2 * WARPS] * FC + lane],
                  s_w[j + 2 * WARPS] * v2);
        atomicAdd(&acc[s_out[j + 3 * WARPS] * FC + lane],
                  s_w[j + 3 * WARPS] * v3);
      }
      for (; j < n; j += WARPS) {
        const float v = __ldg(x + (size_t)s_in[j] * F + f);
        atomicAdd(&acc[s_out[j] * FC + lane], s_w[j] * v);
      }
    }
  }
}

template <bool TRANSPOSE, bool HAS_VALS>
__global__ void __launch_bounds__(WARPS * 32)
edge_stream_kernel(const int16_t* __restrict__ coords,
                   const float* __restrict__ vals,
                   const int32_t* __restrict__ blk_rc,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ t_order, int nb,
                   const float* __restrict__ x, float* __restrict__ y,
                   int F, int bm, int bk, int shift) {
  extern __shared__ float smem[];
  __shared__ int run[2];
  const int b_out = TRANSPOSE ? bk : bm;
  float* acc = smem;                                          // [b_out][FC]
  int* s_out = reinterpret_cast<int*>(acc + b_out * FC);      // [CHUNK]
  int* s_in = s_out + CHUNK;                                  // [CHUNK]
  float* s_w = reinterpret_cast<float*>(s_in + CHUNK);        // [CHUNK]

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.y * FC + lane;
  const bool f_ok = f < F;

  for (int i = threadIdx.x; i < b_out * FC; i += blockDim.x) acc[i] = 0.f;
  if (threadIdx.x < 2) {
    // lower bound of (tile + threadIdx.x) over the visit order's tile key
    const int target = tile + threadIdx.x;
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int rc = blk_rc[TRANSPOSE ? t_order[mid] : mid];
      const int key = TRANSPOSE ? (rc & 0xFFFF) : (rc >> 16);
      if (key < target) lo = mid + 1; else hi = mid;
    }
    run[threadIdx.x] = lo;
  }
  __syncthreads();
  const int k_lo = run[0], k_hi = run[1];

  for (int k = k_lo; k < k_hi; ++k) {
    const int e = TRANSPOSE ? t_order[k] : k;
    const int cnt = off[nb + 1 + e];      // uniform over the block
    if (cnt <= 0) continue;               // sentinel / pad entry
    const int rc = blk_rc[e];
    const int in_base = TRANSPOSE ? (rc >> 16) * bm : (rc & 0xFFFF) * bk;
    add_entry_edges<TRANSPOSE, HAS_VALS>(coords, vals, off[e], cnt, in_base,
                                         x, F, f, f_ok, bm, bk, shift, acc,
                                         s_out, s_in, s_w);
  }
  __syncthreads();
  if (f_ok) {
    for (int r = warp; r < b_out; r += WARPS)
      y[(size_t)(tile * b_out + r) * F + f] = acc[r * FC + lane];
  }
}

template <bool TRANSPOSE, bool HAS_VALS>
void launch(const int16_t* coords, const float* vals, const int32_t* blk_rc,
            const int32_t* off, const int32_t* t_order, int nb,
            const float* x, float* y, int n_out_tiles, int F, int bm,
            int bk, int shift, cudaStream_t stream) {
  const int b_out = TRANSPOSE ? bk : bm;
  const size_t smem = (size_t)b_out * FC * sizeof(float) +
                      (size_t)CHUNK * (2 * sizeof(int) + sizeof(float));
  dim3 grid(n_out_tiles, (F + FC - 1) / FC);
  edge_stream_kernel<TRANSPOSE, HAS_VALS><<<grid, WARPS * 32, smem, stream>>>(
      coords, vals, blk_rc, off, t_order, nb, x, y, F, bm, bk, shift);
}

// Row tile of segment j: that of its first entry; INT_MAX for a trailing
// padding segment (seg_ptr[j] >= nb). Non-decreasing in j for a seg_ptr
// from segment_tiles, since blk_rc is rt-major.
__device__ __forceinline__ int seg_row_tile(const int32_t* __restrict__ seg_ptr,
                                            const int32_t* __restrict__ blk_rc,
                                            int nb, int j) {
  const int e = seg_ptr[j];
  return e >= nb ? INT_MAX : (blk_rc[e] >> 16);
}

// K6, pass 1: one block per (segment, 32-wide feature chunk).
__global__ void __launch_bounds__(WARPS * 32)
edge_stream_seg_kernel(const int16_t* __restrict__ coords,
                       const int32_t* __restrict__ blk_rc,
                       const int32_t* __restrict__ off,
                       const int32_t* __restrict__ seg_ptr, int nb, int ns,
                       const float* __restrict__ x, float* __restrict__ y,
                       float* __restrict__ slab, int F, int bm, int bk,
                       int shift) {
  extern __shared__ float smem[];
  float* acc = smem;                                          // [bm][FC]
  int* s_out = reinterpret_cast<int*>(acc + bm * FC);         // [CHUNK]
  int* s_in = s_out + CHUNK;                                  // [CHUNK]
  float* s_w = reinterpret_cast<float*>(s_in + CHUNK);        // [CHUNK]

  const int s = blockIdx.x;
  const int lo = seg_ptr[s];
  if (lo >= nb) return;                   // trailing padding segment
  const int hi = min(seg_ptr[s + 1], nb);
  const int rt = blk_rc[lo] >> 16;
  // a segment alone in its row tile owns that tile of y
  const bool alone =
      !(s > 0 && seg_row_tile(seg_ptr, blk_rc, nb, s - 1) == rt) &&
      !(s + 1 < ns && seg_row_tile(seg_ptr, blk_rc, nb, s + 1) == rt);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.y * FC + lane;
  const bool f_ok = f < F;

  for (int i = threadIdx.x; i < bm * FC; i += blockDim.x) acc[i] = 0.f;
  for (int e = lo; e < hi; ++e) {
    const int cnt = off[nb + 1 + e];      // uniform over the block
    if (cnt <= 0) continue;               // sentinel / pad entry
    const int in_base = (blk_rc[e] & 0xFFFF) * bk;
    add_entry_edges<false, false>(coords, nullptr, off[e], cnt, in_base, x,
                                  F, f, f_ok, bm, bk, shift, acc, s_out,
                                  s_in, s_w);
  }
  __syncthreads();
  if (f_ok) {
    float* out = alone ? y + (size_t)rt * bm * F : slab + (size_t)s * bm * F;
    for (int r = warp; r < bm; r += WARPS)
      out[(size_t)r * F + f] = acc[r * FC + lane];
  }
}

// K6, pass 2: one block per (row tile, 32-wide feature chunk). A row tile
// with no segment reads 0; with several, the sum of their slabs in
// segment order; with one, pass 1 already wrote it.
__global__ void __launch_bounds__(WARPS * 32)
edge_stream_seg_sum_kernel(const int32_t* __restrict__ blk_rc,
                           const int32_t* __restrict__ seg_ptr, int nb,
                           int ns, const float* __restrict__ slab,
                           float* __restrict__ y, int F, int bm) {
  __shared__ int run[2];
  const int tile = blockIdx.x;
  if (threadIdx.x < 2) {
    // lower bound of (tile + threadIdx.x) over the segments' row tiles
    const int target = tile + threadIdx.x;
    int lo = 0, hi = ns;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (seg_row_tile(seg_ptr, blk_rc, nb, mid) < target) lo = mid + 1;
      else hi = mid;
    }
    run[threadIdx.x] = lo;
  }
  __syncthreads();
  const int j_lo = run[0], j_hi = run[1];
  if (j_hi - j_lo == 1) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.y * FC + lane;
  if (f >= F) return;
  for (int r = warp; r < bm; r += WARPS) {
    float sum = 0.f;
    for (int j = j_lo; j < j_hi; ++j)
      sum += slab[((size_t)j * bm + r) * F + f];
    y[((size_t)tile * bm + r) * F + f] = sum;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int edge_stream_spmm_f32(const void* coords, const void* vals,
                                    const void* blk_rc, const void* off,
                                    const void* t_order, int nb,
                                    const void* x, void* y, int n_out_tiles,
                                    int F, int bm, int bk, int transpose,
                                    void* stream) {
  if (n_out_tiles <= 0 || F <= 0) return 0;
  int shift = 0;
  while ((1 << shift) < bk) ++shift;
  auto c = static_cast<const int16_t*>(coords);
  auto v = static_cast<const float*>(vals);
  auto rc = static_cast<const int32_t*>(blk_rc);
  auto o = static_cast<const int32_t*>(off);
  auto t = static_cast<const int32_t*>(t_order);
  auto xx = static_cast<const float*>(x);
  auto yy = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (transpose) {
    if (v) launch<true, true>(c, v, rc, o, t, nb, xx, yy, n_out_tiles, F, bm, bk, shift, s);
    else launch<true, false>(c, v, rc, o, t, nb, xx, yy, n_out_tiles, F, bm, bk, shift, s);
  } else {
    if (v) launch<false, true>(c, v, rc, o, t, nb, xx, yy, n_out_tiles, F, bm, bk, shift, s);
    else launch<false, false>(c, v, rc, o, t, nb, xx, yy, n_out_tiles, F, bm, bk, shift, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6 forward over the segments seg_ptr[0..ns]; slab holds ns x bm x F
// floats of scratch. Returns cudaGetLastError() after both launches.
extern "C" int edge_stream_spmm_seg_f32(const void* coords,
                                        const void* blk_rc, const void* off,
                                        const void* seg_ptr, int nb, int ns,
                                        const void* x, void* y, void* slab,
                                        int n_row_tiles, int F, int bm,
                                        int bk, void* stream) {
  if (n_row_tiles <= 0 || F <= 0) return 0;
  int shift = 0;
  while ((1 << shift) < bk) ++shift;
  auto c = static_cast<const int16_t*>(coords);
  auto rc = static_cast<const int32_t*>(blk_rc);
  auto o = static_cast<const int32_t*>(off);
  auto sp = static_cast<const int32_t*>(seg_ptr);
  auto xx = static_cast<const float*>(x);
  auto yy = static_cast<float*>(y);
  auto sl = static_cast<float*>(slab);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_fc = (F + FC - 1) / FC;
  if (ns > 0) {
    const size_t smem = (size_t)bm * FC * sizeof(float) +
                        (size_t)CHUNK * (2 * sizeof(int) + sizeof(float));
    edge_stream_seg_kernel<<<dim3(ns, n_fc), WARPS * 32, smem, s>>>(
        c, rc, o, sp, nb, ns, xx, yy, sl, F, bm, bk, shift);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  edge_stream_seg_sum_kernel<<<dim3(n_row_tiles, n_fc), WARPS * 32, 0, s>>>(
      rc, sp, nb, ns, sl, yy, F, bm);
  return static_cast<int>(cudaGetLastError());
}
