// Edge-stream SpMM for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes; see gnn_tpu_torch/ops/edgestream.py).
//
// Replaces the TPU kernel gnn_tpu/ops/pallas_edgestream.py::
// edge_stream_spmm (Pallas kernel _edge_stream_kernel). It computes, over
// one packed tile set,
//
//     y = A01 @ x          (forward,   y has nrows rows)
//     y = A01^T @ x        (transpose, y has ncols rows)
//
// where A01 holds one entry per packed edge (times its per-edge value when
// `vals` is given; duplicate edges sum). The rank-1 factors rv / nf are
// folded into x and y by the wrapper, as on the TPU.
//
// Layout (identical to the TPU kernel's): int16 coords (lr << log2 bk) | lc
// local to the edge's (bm x bk) tile, decoded as uint16 so 256x256 tiles
// with rows >= 128 do not sign-extend; entries blk_rc = rt << 16 | ct sorted
// rt-major; off[2, nb + 1] = (edge offset, edge count) per entry; t_order
// = the ct-major visit permutation for the transpose. Sentinel and pad
// entries have count 0.
//
// The TPU kernel densifies each tile on the MXU from one-hot operands
// because the TPU has no gather hardware. The H100 gathers rows cheaply,
// so this kernel does the per-edge work directly:
//   * one thread block per (output tile, 32-wide feature chunk); the
//     block finds its run of entries by binary search in the visit order
//     (rt-major blk_rc forward, t_order transpose), so no global atomics
//     are needed and every output element is written exactly once
//     (tiles without edges get zeros);
//   * each entry's edges are decoded into shared memory, then 8 warps
//     split the edges; lane l gathers x[in_row, f0 + l] and adds it into a
//     float32 shared-memory tile acc[b_out][32] with a shared-memory
//     atomic. The order of those additions varies from run to run, so
//     results agree with the plain version to float32 rounding, not bit
//     for bit.
//
// Bound on this card: the function must move x (n_in x F), y (n_out x F)
// and 2 bytes of coords per edge, and does 2 flops per edge and feature
// on float32 CUDA cores. At the main path's shapes the bytes dominate
// (memory-bound). The kernel itself reads each edge's 128-byte row
// segment of x; a tile's edges fall in one bk-row window of x (at most
// 32 KB per block), which stays in L1/L2, so the repeated reads are served
// from cache rather than from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FC = 32;       // feature columns per block: one per lane
constexpr int WARPS = 8;     // warps per block; they split the edges
constexpr int CHUNK = 256;   // edges decoded into shared memory at once

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
    const int base = off[e];
    const int rc = blk_rc[e];
    const int in_base = TRANSPOSE ? (rc >> 16) * bm : (rc & 0xFFFF) * bk;
    for (int c0 = 0; c0 < cnt; c0 += CHUNK) {
      const int n = min(CHUNK, cnt - c0);
      __syncthreads();                    // the previous chunk is consumed
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
