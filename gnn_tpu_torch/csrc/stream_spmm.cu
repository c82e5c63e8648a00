// Occupied-tile stream SpMM (K2, both orientations) and SDDMM (K5) for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes;
// see gnn_tpu_torch/ops/spmm.py and gnn_tpu_torch/ops/sddmm.py).
//
// Replaces two TPU kernels:
//   * gnn_tpu/ops/pallas_spmm.py::stream_spmm (Pallas kernel
//     _stream_kernel): over a stream of dense (bm x bk) tiles with
//     blk_rc[j] = rt_j << 16 | ct_j sorted by row tile,
//         forward    y[rt_j tile] += vals[j]   @ x[ct_j tile]   (y: n_rt*bm rows)
//         transpose  y[ct_j tile] += vals[j]^T @ x[rt_j tile]   (y: n_ct*bk rows)
//     The TPU kernel has only the forward; the port adds the transpose so
//     GAT's tile route differentiates through K2 with no plain-PyTorch
//     product. The transpose visits the entries in column-tile order
//     through t_order (a permutation of the entries, ct-major), as K1's
//     transpose does; the tiles themselves are read in place.
//   * gnn_tpu/ops/pallas_sddmm.py::stream_sddmm (Pallas kernel
//     _sddmm_kernel): out[j] = x[rt_j tile] @ y[ct_j tile]^T.
//
// All three are float32 matrix products on CUDA cores (the TPU kernels
// run at precision="highest"; TF32 would keep about three digits). One
// shared core: a thread block computes a 128 x 128 output block in
// registers (256 threads, 8 x 8 outputs each) and walks the reduction
// depth in stages of 16, staging each operand's 16-deep slice in shared
// memory; the next stage's global loads are issued before the current
// stage's products, so they overlap.
//   * K2: one block per (output tile, 128-row part of it, 128-column
//     feature chunk). The block finds its run of entries by binary search
//     in the visit order (blk_rc forward, t_order transpose) and chains
//     every entry's tile into one reduction: depth = entries x bk (bm for
//     the transpose). No global atomics; every output element is written
//     exactly once, so row tiles without an entry and rows past the
//     tiles' contents get zeros without the packer's sentinel tiles, and
//     padding tiles (zero values) add nothing. Where that gives too few
//     blocks to fill the card (GAT's tile layer has 16 row tiles: 64
//     blocks at F = 512), the wrapper splits each run into nsplit parts
//     (blockIdx.z); each part writes its own partial output and a second
//     kernel sums the parts in a fixed order, so results do not vary from
//     run to run.
//   * K5: one block per (entry, 128 x 128 part of its tile); depth = F.
// Loads are masked at every ragged edge (bm or bk not a multiple of 128,
// F not a multiple of 128 or 16), so any tile shape and width works; the
// main paths use 128 x 128 tiles.
//
// Bound on this card: at the main paths' shapes the tiles are dense, so
// each call is a chain of dense products of 2 * NB * bm * bk * F flops
// (36.9 GFLOP for blocked layer 0 at F = 602, 21.5 GFLOP for GAT's tile
// layer at F = 512) against about 0.1-0.6 GB of bytes: operations bound
// at the 67 TFLOP/s float32 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 16;       // reduction depth per shared-memory stage
constexpr int PAD = 4;       // shared-memory row padding (keeps float4 alignment)
constexpr int THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int PER = BK * BM / THREADS;  // elements each thread stages per operand

static_assert(BM == BN && PER == 8, "the staging maps assume 128 x 128 x 16");

// Stage one 16-deep operand slice S[k][m] (k < BK, m < BM) into registers.
// KFAST: the source is row-major with k contiguous, element (m, k) at
// src[m * ld + k] (a tile or x read along its rows); otherwise m is
// contiguous, element (m, k) at src[k * ld + m]. Elements past m_lim or
// k_lim read as 0.
template <bool KFAST>
__device__ __forceinline__ void load_stage(const float* __restrict__ src,
                                           int ld, int m_lim, int k_lim,
                                           float (&r)[PER]) {
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int k = KFAST ? (idx & (BK - 1)) : (idx / BM);
    const int m = KFAST ? (idx / BK) : (idx & (BM - 1));
    r[p] = (m < m_lim && k < k_lim)
               ? __ldg(src + (KFAST ? (size_t)m * ld + k : (size_t)k * ld + m))
               : 0.f;
  }
}

template <bool KFAST>
__device__ __forceinline__ void store_stage(float (*S)[BM + PAD],
                                            const float (&r)[PER]) {
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int k = KFAST ? (idx & (BK - 1)) : (idx / BM);
    const int m = KFAST ? (idx / BK) : (idx & (BM - 1));
    S[k][m] = r[p];
  }
}

// Row (or column) of the block owned by a thread's i-th accumulator:
// two groups of four, 64 apart, so a warp's float4 reads of a stage row
// hit consecutive shared-memory addresses.
__device__ __forceinline__ int owned(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

__device__ __forceinline__ void stage_products(const float (*As)[BM + PAD],
                                               const float (*Bs)[BN + PAD],
                                               int ty, int tx,
                                               float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The shared core: acc = sum over n_stages of A_s @ B_s, where load(s)
// stages operand slices of stage s into (ra, rb) and A_KFAST / B_KFAST
// say how each is laid out. The next stage's loads are in flight while
// the current stage's products run.
template <bool A_KFAST, bool B_KFAST, typename Load>
__device__ __forceinline__ void reduce_stages(int n_stages, Load load,
                                              float (&acc)[8][8]) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float ra[PER], rb[PER];
  if (n_stages <= 0) return;
  load(0, ra, rb);
  store_stage<A_KFAST>(As, ra);
  store_stage<B_KFAST>(Bs, rb);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const bool more = s + 1 < n_stages;
    if (more) load(s + 1, ra, rb);
    stage_products(As, Bs, ty, tx, acc);
    __syncthreads();
    if (more) {
      store_stage<A_KFAST>(As, ra);
      store_stage<B_KFAST>(Bs, rb);
    }
    __syncthreads();
  }
}

// Lower bound of `target` over the visit order's tile key (row tile of
// blk_rc[k] forward, column tile of blk_rc[t_order[k]] transposed).
template <bool TRANSPOSE>
__device__ int lower_bound(const int32_t* __restrict__ blk_rc,
                           const int32_t* __restrict__ t_order, int nb,
                           int target) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int rc = blk_rc[TRANSPOSE ? t_order[mid] : mid];
    const int key = TRANSPOSE ? (rc & 0xFFFF) : (rc >> 16);
    if (key < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS, 2)
stream_spmm_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ blk_rc,
                   const int32_t* __restrict__ t_order, int nb,
                   const float* __restrict__ x, float* __restrict__ y, int F,
                   int bm, int bk, int n_out_rows) {
  __shared__ int run[2];
  const int b_out = TRANSPOSE ? bk : bm;   // rows of one output tile
  const int depth = TRANSPOSE ? bm : bk;   // reduction depth of one tile
  const int parts = (b_out + BM - 1) / BM;
  const int tile = blockIdx.x / parts;
  const int m0 = (blockIdx.x % parts) * BM;
  const int f0 = blockIdx.y * BN;
  if (threadIdx.x < 2)
    run[threadIdx.x] = lower_bound<TRANSPOSE>(blk_rc, t_order, nb,
                                              tile + threadIdx.x);
  __syncthreads();
  int k_lo = run[0], k_hi = run[1];
  if (gridDim.z > 1) {
    // part blockIdx.z of the run, into its own partial output
    const int per = (k_hi - k_lo + gridDim.z - 1) / gridDim.z;
    k_lo = min(k_hi, k_lo + (int)blockIdx.z * per);
    k_hi = min(k_hi, k_lo + per);
    y += (size_t)blockIdx.z * n_out_rows * F;
  }
  const int kst = (depth + BK - 1) / BK;   // stages per tile
  const int n_stages = (k_hi - k_lo) * kst;

  auto load = [&](int s, float (&ra)[PER], float (&rb)[PER]) {
    const int e = TRANSPOSE ? t_order[k_lo + s / kst] : k_lo + s / kst;
    const int d0 = (s % kst) * BK;
    const int rc = blk_rc[e];
    const float* tv = vals + (size_t)e * bm * bk;
    if constexpr (TRANSPOSE) {
      // A[m = tile col][k = tile row] = vals[e][k][m]: m contiguous
      load_stage<false>(tv + (size_t)d0 * bk + m0, bk, bk - m0, bm - d0, ra);
      load_stage<false>(x + ((size_t)(rc >> 16) * bm + d0) * F + f0, F,
                        F - f0, bm - d0, rb);
    } else {
      // A[m = tile row][k = tile col] = vals[e][m][k]: k contiguous
      load_stage<true>(tv + (size_t)m0 * bk + d0, bk, bm - m0, bk - d0, ra);
      load_stage<false>(x + ((size_t)(rc & 0xFFFF) * bk + d0) * F + f0, F,
                        F - f0, bk - d0, rb);
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if constexpr (TRANSPOSE)
    reduce_stages<false, false>(n_stages, load, acc);
  else
    reduce_stages<true, false>(n_stages, load, acc);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + owned(ty, i);
    if (m >= b_out) continue;
    float* yr = y + ((size_t)tile * b_out + m) * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + owned(tx, j);
      if (f < F) yr[f] = acc[i][j];
    }
  }
}

// y[i] = sum over the nsplit partial outputs, in a fixed order.
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ y, size_t n,
                                 int nsplit) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nsplit; ++z) s += parts[(size_t)z * n + i];
    y[i] = s;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
stream_sddmm_kernel(const int32_t* __restrict__ blk_rc,
                    const float* __restrict__ x, const float* __restrict__ yv,
                    float* __restrict__ out, int F, int bm, int bk) {
  const int n_parts = (bk + BN - 1) / BN;
  const int j = blockIdx.x;
  const int m0 = (blockIdx.y / n_parts) * BM;
  const int n0 = (blockIdx.y % n_parts) * BN;
  const int rc = blk_rc[j];
  const float* xa = x + ((size_t)(rc >> 16) * bm + m0) * F;
  const float* yb = yv + ((size_t)(rc & 0xFFFF) * bk + n0) * F;

  // both operands are rows of length F: the reduction index is contiguous
  auto load = [&](int s, float (&ra)[PER], float (&rb)[PER]) {
    const int f = s * BK;
    load_stage<true>(xa + f, F, bm - m0, F - f, ra);
    load_stage<true>(yb + f, F, bk - n0, F - f, rb);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  reduce_stages<true, true>((F + BK - 1) / BK, load, acc);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + owned(ty, i);
    if (m >= bm) continue;
    float* o = out + ((size_t)j * bm + m) * bk;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = n0 + owned(tx, jj);
      if (n < bk) o[n] = acc[i][jj];
    }
  }
}

}  // namespace

// K2. Returns cudaGetLastError() after the launches (0 = launched).
// n_out_tiles = n_rt (forward) or n_ct (transpose); t_order may be null
// for the forward. With nsplit > 1, `parts` holds nsplit x n_out x F
// floats of scratch.
extern "C" int stream_spmm_f32(const void* vals, const void* blk_rc,
                               const void* t_order, int nb, const void* x,
                               void* y, void* parts, int n_out_tiles, int F,
                               int bm, int bk, int transpose, int nsplit,
                               void* stream) {
  if (n_out_tiles <= 0 || F <= 0) return 0;
  nsplit = nsplit < 1 ? 1 : nsplit;
  const int b_out = transpose ? bk : bm;
  const int n_out_rows = n_out_tiles * b_out;
  dim3 grid(n_out_tiles * ((b_out + BM - 1) / BM), (F + BN - 1) / BN,
            nsplit);
  auto v = static_cast<const float*>(vals);
  auto rc = static_cast<const int32_t*>(blk_rc);
  auto t = static_cast<const int32_t*>(t_order);
  auto xx = static_cast<const float*>(x);
  auto out = static_cast<float*>(nsplit > 1 ? parts : y);
  auto s = static_cast<cudaStream_t>(stream);
  if (transpose)
    stream_spmm_kernel<true><<<grid, THREADS, 0, s>>>(v, rc, t, nb, xx, out,
                                                     F, bm, bk, n_out_rows);
  else
    stream_spmm_kernel<false><<<grid, THREADS, 0, s>>>(v, rc, t, nb, xx, out,
                                                      F, bm, bk, n_out_rows);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t n = (size_t)n_out_rows * F;
    const size_t blocks = (n + 255) / 256;
    sum_parts_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(
        static_cast<const float*>(parts), static_cast<float*>(y), n, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int stream_sddmm_f32(const void* blk_rc, int nb, const void* x,
                                const void* y, void* out, int F, int bm,
                                int bk, void* stream) {
  if (nb <= 0) return 0;
  dim3 grid(nb, ((bm + BM - 1) / BM) * ((bk + BN - 1) / BN));
  stream_sddmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blk_rc), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<float*>(out), F, bm, bk);
  return static_cast<int>(cudaGetLastError());
}
