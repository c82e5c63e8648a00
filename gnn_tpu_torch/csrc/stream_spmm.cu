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
// K2: a tile scan that multiplies only the nonzeros. The tiles are stored
// dense, as the TPU's matrix unit wants them, but on the main paths almost
// every entry is zero: one blocked batch (50k nodes / degree 30, batch
// 512, samp_num 2048) holds 0.62% / 0.95% / 0.39% nonzeros in its three
// layers' 128 x 128 tiles (at most 314 in one tile), GAT's tile layer
// 0.19% (its attention tiles are zero outside the edge mask). The
// function's work is 2 * nnz * F flops, microseconds at the float32
// rate, so the bound is bytes: every tile read once (4 * bm * bk B), x
// and y. One block of SCAN_THREADS per (output tile, part of `rows` of
// its rows, F-chunk, split part). The wrapper's plan gives a block a
// chunk as wide as F where one fits (128, 256, 512, 640 or 1024 floats,
// LF = chunk / 32 a lane) and as many output rows as ACC_FLOATS allows
// (32 at F = 602 and 1024, 64 at 512, 128 up to 256), so in the forward
// each tile row is staged and scanned by one block only. The block finds
// its run of entries by binary search (blk_rc forward, t_order transpose),
// reads the run's entries and their blk_rc into shared memory RUN_WIN at a
// time, and walks it:
//   1. stage: warp 0 copies each slab into shared memory with 1-D bulk
//      async copies (cp.async.bulk, completion on an mbarrier): forward,
//      the block's rows of the tile in one copy; transposed, the block's
//      columns of every tile row, one copy a row. A slab is at most
//      STAGE_FLOATS floats; STAGES buffers, so the next slab's copy
//      overlaps this one's work;
//   2. scan: the block lists the slab's nonzeros in (output row, input
//      row) order. Forward, each warp takes a contiguous share of the
//      slab's rows and reads 4 floats a lane (__ballot_sync / __popc place
//      each nonzero); transposed, each lane reads one column down a share
//      of the rows (a warp reads 32 consecutive floats: no bank
//      conflicts). One barrier after the counts (per warp forward, per row
//      share and column transposed); every warp then finds its list places
//      itself and writes the list, LCAP places at a time;
//   3. gather: the warps take even shares of the list, each boundary moved
//      on to the next row's start, so every output row is summed by one
//      warp (a hub row makes one warp's share longer). A warp gathers the
//      x row chunk of each nonzero (16 B, 8 B or 4 B a lane by F's
//      alignment; GATHER_FLOATS a lane in flight), sums each output row in
//      registers and adds it into the block's output rows in shared memory;
//   4. every row of the block's part is written once: rows without a
//      nonzero, and row tiles without an entry, read 0; padding tiles
//      (zero values) add nothing.
// Where too few blocks would fill the card (GAT's tile layer has 16 row
// tiles), the wrapper splits each run into nsplit parts; each part writes
// its own partial output and a second kernel sums them in part order.
// Determinism: every sum runs in a fixed order (run order, then list
// order within a slab, then part order), so two calls on the same inputs
// give the same bits.
// Zeros: entries equal to 0 are skipped. That differs from the dense
// product only where x holds inf or NaN (0 * inf): the TPU kernel and the
// plain version give NaN there and this kernel does not, as
// torch.sparse.mm does not. The port's paths feed finite x.
// The bulk copy moves 16-byte units: bk % 4 == 0 and 16-byte-aligned tile
// values are required (the wrapper checks both and raises).
//
// K5: its output is every entry of each tile, so its dense products are
// its work: 2 * NB * bm * bk * F flops (21.5 GFLOP at GAT's tile layer at
// F = 512), operations bound at the 67 TFLOP/s float32 rate (the TPU
// kernel runs at precision="highest"; TF32 would keep about three
// digits). A dense core on CUDA cores: one block per (entry, 128 x 128
// part of its tile) computes the block in registers (256 threads, 8 x 8
// outputs each) and walks the depth F in stages of 16, staging each
// operand's 16-deep slice in shared memory; the next stage's global loads
// are issued before the current stage's products, so they overlap. Loads
// are masked at every ragged edge, so any tile shape and width works.
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

// ---------------------------------------------------------------- K2 ----

constexpr int SCAN_THREADS = 256;     // 8 warps
constexpr int BLOCKS_PER_SM = 1;      // the register budget's occupancy
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int MAX_ROWS = 128;         // output rows a block may own
constexpr int ACC_FLOATS = 32768;     // a block's output rows x chunk (128 KB)
constexpr int STAGE_FLOATS = 8192;    // 32 KB at most a staging buffer
constexpr int SMEM_MAX = 232448;      // shared memory a block may take
constexpr int STAGES = 2;             // staging buffers (copies in flight + 1)
constexpr int LCAP = 1024;            // nonzeros listed at once
constexpr int RUN_WIN = 512;          // entries of the run read at once
constexpr int GATHER_FLOATS = 64;     // gathered floats in flight a lane

static_assert(SCAN_THREADS >= MAX_ROWS && SCAN_WARPS <= 32 &&
                  SCAN_WARPS >= 4 && STAGES >= 2,
              "the scan maps assume these shapes");

// x rows gathered at once by a warp at LF floats a lane
template <int LF>
__host__ __device__ constexpr int unroll() {
  return GATHER_FLOATS / LF < 1 ? 1
         : GATHER_FLOATS / LF > 8 ? 8 : GATHER_FLOATS / LF;
}

// The block's shared memory (dynamic: over 48 KB): this, then the float
// arrays carved per launch, STAGES staging buffers of stage_f floats (the
// bulk copies' targets), the block's output rows x chunk, and a slot of
// chunk floats a warp for the partial of a row continued from an
// earlier warp.
struct alignas(128) ScanSmem {
  int list_oi[LCAP];                  // nonzeros: out row << 16 | in row
  float list_v[LCAP];                 //   and their values
  int cnt[SCAN_THREADS];              // transposed: per (row share, column)
  int wcnt[SCAN_WARPS];               // forward: per warp
  int ent[RUN_WIN];                   // the run's entries (window) and
  int erc[RUN_WIN];                   //   their blk_rc
  int first_row[SCAN_WARPS];          // a warp's share: first / last row
  int last_row[SCAN_WARPS];           //   (-1: empty share), and whether
  int cont[SCAN_WARPS];               //   its first row began earlier
  int run[2];
  unsigned long long full[STAGES];    // mbarriers: a slab has arrived
};

// A launch's operands (n_out_rows: rows of one partial output; rows:
// output rows a block owns).
struct ScanArgs {
  const float* vals;
  const int32_t* blk_rc;
  const int32_t* t_order;
  const float* x;
  float* y;
  int nb, F, bm, bk, n_out_rows, rows, n_parts, n_chunks, nsplit;
  int srows, stage_f;     // rows of a slab at most; floats of a buffer
};

// Bytes of shared memory a launch takes.
size_t scan_smem(int stage_f, int rows, int chunk) {
  return sizeof(ScanSmem) +
         4 * ((size_t)STAGES * stage_f + (size_t)(rows + SCAN_WARPS) * chunk);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// src into shared memory at dst, completing that many bytes of the
// mbarrier's expected transfer.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same as the mbarrier's one arrival: it expects `bytes`, and its
// phase completes when they have arrived. One thread calls it.
__device__ __forceinline__ void bulk_stage(float* dst, const float* src,
                                           uint32_t bytes,
                                           unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  bulk_copy(dst, src, bytes, bar);
}

// Waits until the mbarrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// V consecutive floats (aligned to 4V bytes): p += a / p = a / a = p.
template <int V>
__device__ __forceinline__ void vadd(float* p, const float* a) {
  if constexpr (V == 4) {
    float4 t = *reinterpret_cast<float4*>(p);
    t.x += a[0]; t.y += a[1]; t.z += a[2]; t.w += a[3];
    *reinterpret_cast<float4*>(p) = t;
  } else if constexpr (V == 2) {
    float2 t = *reinterpret_cast<float2*>(p);
    t.x += a[0]; t.y += a[1];
    *reinterpret_cast<float2*>(p) = t;
  } else {
    p[0] += a[0];
  }
}

template <int V>
__device__ __forceinline__ void vput(float* p, const float* a) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  else
    p[0] = a[0];
}

template <int V>
__device__ __forceinline__ void vget(float* a, const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    a[0] = t.x; a[1] = t.y;
  } else {
    a[0] = p[0];
  }
}

// A lane's LF floats of its chunk sit at j * 32 * V + lane * V + k
// (j < LF / V, k < V) of a chunk-wide row, and at v[j * V + k].

// The lane's floats of row `in` of x (global columns col0 + j * 32 * V
// + k); zeros past F or when !ok.
template <int V, int LF>
__device__ __forceinline__ void gather_row(const float* __restrict__ x,
                                           int in, int F, int col0, bool ok,
                                           float (&v)[LF]) {
  const float* p = x + (size_t)in * F + col0;
#pragma unroll
  for (int j = 0; j < LF / V; ++j) {
    if (ok && col0 + j * 32 * V < F) {
      if constexpr (V == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p + j * 128));
        v[j * 4] = t.x; v[j * 4 + 1] = t.y; v[j * 4 + 2] = t.z;
        v[j * 4 + 3] = t.w;
      } else if constexpr (V == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p + j * 64));
        v[j * 2] = t.x; v[j * 2 + 1] = t.y;
      } else {
        v[j] = __ldg(p + j * 32);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[j * V + k] = 0.f;
    }
  }
}

// row[lane's places] += a (or = a when !add)
template <int V, int LF>
__device__ __forceinline__ void row_add(float* row, const float (&a)[LF],
                                        bool add) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < LF / V; ++j) {
    float* p = row + j * 32 * V + lane * V;
    if (add) vadd<V>(p, a + j * V); else vput<V>(p, a + j * V);
  }
}

// A lane's 4 tile entries at row + c (zeros past bk), how many nonzeros
// of the warp's 128 columns come before the lane's first, and in all.
struct Quad {
  float v[4];
  int before, total;
};

__device__ __forceinline__ Quad read_quad(const float* row, int c, int bk) {
  Quad q;
  const int lane = threadIdx.x & 31;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < bk) t = *reinterpret_cast<const float4*>(row + c);
  q.v[0] = t.x; q.v[1] = t.y; q.v[2] = t.z; q.v[3] = t.w;
  const unsigned lt = (1u << lane) - 1;
  q.before = q.total = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = __ballot_sync(0xffffffffu, q.v[k] != 0.f);
    q.before += __popc(m & lt);
    q.total += __popc(m);
  }
  return q;
}

#ifdef STREAM_SPMM_PROFILE
// blocks, slabs, cycles in: wait, scan, gather, run windows, set-up +
// write; total, slowest block (thread 0's clock at the block's barriers)
__device__ unsigned long long g_prof[9];
#define PROF_MARK(slot)                                        \
  if (threadIdx.x == 0) {                                      \
    const long long t_ = clock64();                            \
    p_ph[slot] += t_ - p_m;                                    \
    p_m = t_;                                                  \
  }
#else
#define PROF_MARK(slot)
#endif

template <bool TRANSPOSE, int LF, int V>
__global__ void __launch_bounds__(SCAN_THREADS, BLOCKS_PER_SM)
stream_spmm_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ScanSmem& s = *reinterpret_cast<ScanSmem*>(smem_raw);
  constexpr int CW = 32 * LF;                  // chunk width
  float* const stage = reinterpret_cast<float*>(smem_raw + sizeof(ScanSmem));
  float* const acc_s = stage + STAGES * a.stage_f;
  float* const comb = acc_s + a.rows * CW;
  constexpr int U = unroll<LF>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = a.F, bm = a.bm, bk = a.bk;
  const int b_out = TRANSPOSE ? bk : bm;       // rows of one output tile
#ifdef STREAM_SPMM_PROFILE
  long long p_t0 = clock64(), p_m = p_t0, p_ph[5] = {}, p_items = 0;
#endif
  // block index: chunk fastest, then split part, row part, tile
  int b = blockIdx.x;
  const int chunk = b % a.n_chunks;
  b /= a.n_chunks;
  const int z = b % a.nsplit;
  b /= a.nsplit;
  const int m0 = (b % a.n_parts) * a.rows;
  const int tile = b / a.n_parts;
  const int n_rows = min(a.rows, b_out - m0);  // output rows here
  const int col0 = chunk * CW + lane * V;

  for (int i = tid; i < n_rows * CW; i += SCAN_THREADS) acc_s[i] = 0.f;
  if (tid < 2)
    s.run[tid] = lower_bound<TRANSPOSE>(a.blk_rc, a.t_order, a.nb,
                                        tile + tid);
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(&s.full[i])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int k_lo = s.run[0], k_hi = s.run[1];
  if (a.nsplit > 1) {
    // part z of the run, into its own partial output
    const int per = (k_hi - k_lo + a.nsplit - 1) / a.nsplit;
    k_lo = min(k_hi, k_lo + z * per);
    k_hi = min(k_hi, k_lo + per);
  }
  // A slab is rows [r0, r0 + nr) of one tile: forward only the block's
  // rows, [m0, m0 + n_rows), whole; transposed every row, only the
  // block's columns [m0, m0 + n_rows). It is staged with row stride ld.
  const int ld = TRANSPOSE ? n_rows : bk;
  const int r_lo = TRANSPOSE ? 0 : m0;
  const int r_hi = TRANSPOSE ? bm : m0 + n_rows;
  const int srows = min(a.srows, r_hi - r_lo);
  const int n_sl = (r_hi - r_lo + srows - 1) / srows;
  // transposed scan: lanes along a 32-column group (G groups), warps
  // split the slab's rows into H shares
  const int G = (n_rows + 31) >> 5, H = SCAN_WARPS / G;
  const int tg = warp % G, th = warp / G, to = tg * 32 + lane;
  int g0 = 0;                                  // slabs staged so far
  PROF_MARK(4);

  for (int kw = k_lo; kw < k_hi; kw += RUN_WIN) {
    // the window's entries and their blk_rc, read once
    const int nw = min(RUN_WIN, k_hi - kw);
    for (int i = tid; i < nw; i += SCAN_THREADS) {
      const int e = TRANSPOSE ? a.t_order[kw + i] : kw + i;
      s.ent[i] = e;
      s.erc[i] = __ldg(a.blk_rc + e);
    }
    __syncthreads();
    PROF_MARK(3);
    const int n_items = nw * n_sl;
    // warp 0 stages slab `it` of the window into buffer (g0 + it) % STAGES
    auto issue = [&](int it) {
      const int r0 = r_lo + (it % n_sl) * srows;
      const int nr = min(srows, r_hi - r0);
      const int g = g0 + it;
      float* dst = stage + (g % STAGES) * a.stage_f;
      const float* src = a.vals + ((size_t)s.ent[it / n_sl] * bm + r0) * bk
                         + (TRANSPOSE ? m0 : 0);
      unsigned long long* bar = &s.full[g % STAGES];
      // the buffer's last reads (generic proxy) before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (ld == bk) {               // contiguous rows: one copy
        if (lane == 0) bulk_stage(dst, src, (uint32_t)(nr * bk * 4), bar);
      } else {                      // a column range: one copy a row
        if (lane == 0)
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
              :: "r"(smem_u32(bar)), "r"((uint32_t)(nr * ld * 4))
              : "memory");
        __syncwarp();
        for (int r = lane; r < nr; r += 32)
          bulk_copy(dst + r * ld, src + (size_t)r * bk,
                    (uint32_t)(ld * 4), bar);
      }
    };
    if (warp == 0)
      for (int it = 0; it < STAGES - 1 && it < n_items; ++it) issue(it);

    for (int it = 0; it < n_items; ++it) {
      if (warp == 0 && it + STAGES - 1 < n_items) issue(it + STAGES - 1);
      const int rc = s.erc[it / n_sl];
      const int in_base = TRANSPOSE ? (rc >> 16) * bm : (rc & 0xFFFF) * bk;
      const int r0 = r_lo + (it % n_sl) * srows;
      const int nr = min(srows, r_hi - r0);
      // forward: each warp scans a contiguous share of the slab's rows
      const int lr_lo = nr * warp / SCAN_WARPS;
      const int lr_hi = nr * (warp + 1) / SCAN_WARPS;
      const int g = g0 + it;
      const float* st = stage + (g % STAGES) * a.stage_f;
      bar_wait(&s.full[g % STAGES], (g / STAGES) & 1);
      PROF_MARK(0);

      // 2. count the slab's nonzeros (forward per warp; transposed per
      //    row share and column), then every warp finds its list places
      if constexpr (TRANSPOSE) {
        if (th < H) {
          int c = 0;
          if (to < n_rows) {
#pragma unroll 4
            for (int r = nr * th / H; r < nr * (th + 1) / H; ++r)
              c += st[r * ld + to] != 0.f;
          }
          s.cnt[th * G * 32 + to] = c;
        }
      } else {
        int c = 0;
        for (int lr = lr_lo; lr < lr_hi; ++lr)
          for (int c0 = 0; c0 < bk; c0 += 128)
            c += read_quad(st + lr * ld, c0 + 4 * lane, bk).total;
        if (lane == 0) s.wcnt[warp] = c;
      }
      __syncthreads();
      int n = 0, start = 0;      // the slab's nonzeros; this lane's place
      if constexpr (TRANSPOSE) {
        // the columns' exclusive prefix, group by group, in every warp
        for (int gg = 0; gg < G; ++gg) {
          const int o = gg * 32 + lane;
          int t = 0, mine = 0;
          if (o < n_rows)
            for (int h = 0; h < H; ++h) {
              const int c = s.cnt[h * G * 32 + o];
              t += c;
              mine += h < th ? c : 0;
            }
          int inc = t;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += u;
          }
          if (gg == tg) start = n + inc - t + mine;
          n += __shfl_sync(0xffffffffu, inc, 31);
        }
      } else {
#pragma unroll
        for (int w = 0; w < SCAN_WARPS; ++w) {
          const int t = s.wcnt[w];
          start += w < warp ? t : 0;
          n += t;
        }
      }

      for (int w0 = 0; w0 < n; w0 += LCAP) {
        // the list's places [w0, w0 + LCAP)
        if constexpr (TRANSPOSE) {
          if (th < H && to < n_rows) {
            int p = start - w0;
#pragma unroll 4
            for (int r = nr * th / H; r < nr * (th + 1) / H && p < LCAP;
                 ++r) {
              const float v = st[r * ld + to];
              if (v != 0.f) {
                if (p >= 0) {
                  s.list_oi[p] = to << 16 | (r0 + r);
                  s.list_v[p] = v;
                }
                ++p;
              }
            }
          }
        } else {
          int p = start - w0;
          for (int lr = lr_lo; lr < lr_hi && p < LCAP; ++lr) {
            const int o = r0 + lr - m0;
            for (int c0 = 0; c0 < bk && p < LCAP; c0 += 128) {
              const int c = c0 + 4 * lane;
              const Quad q = read_quad(st + lr * ld, c, bk);
              int pos = p + q.before;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (q.v[k] != 0.f) {
                  if (pos >= 0 && pos < LCAP) {
                    s.list_oi[pos] = o << 16 | (c + k);
                    s.list_v[pos] = q.v[k];
                  }
                  ++pos;
                }
              }
              p += q.total;
            }
          }
        }
        __syncthreads();
        PROF_MARK(1);

        // 3. each warp's even share of the list, rows summed in registers
        const int m = min(LCAP, n - w0);
        const int eb = m * warp / SCAN_WARPS;
        const int ee = m * (warp + 1) / SCAN_WARPS;
        const bool cont = eb > 0 && eb < ee &&
                          (s.list_oi[eb - 1] >> 16) == (s.list_oi[eb] >> 16);
        float acc[LF];
        int cur = -1;
        bool first = true;
        // a finished row: the warp's continued first row to its slot, any
        // other into the block's rows
        auto finish = [&](int r) {
          if (first && cont)
            row_add<V, LF>(comb + warp * CW, acc, false);
          else
            row_add<V, LF>(acc_s + r * CW, acc, true);
          first = false;
        };
        for (int e = eb; e < ee; e += U) {
          float v[U][LF];
          float w[U];
          int rr[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool ok = e + u < ee;
            const int oi = ok ? s.list_oi[e + u] : 0;
            rr[u] = ok ? oi >> 16 : -1;
            w[u] = ok ? s.list_v[e + u] : 0.f;
            gather_row<V, LF>(a.x, in_base + (oi & 0xFFFF), F, col0, ok,
                              v[u]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (rr[u] < 0) continue;
            if (rr[u] != cur) {
              if (cur >= 0) finish(cur);
              cur = rr[u];
#pragma unroll
              for (int q = 0; q < LF; ++q) acc[q] = 0.f;
            }
#pragma unroll
            for (int q = 0; q < LF; ++q)
              acc[q] = fmaf(w[u], v[u][q], acc[q]);
          }
        }
        if (cur >= 0) finish(cur);
        if (lane == 0) {
          s.first_row[warp] = eb < ee ? s.list_oi[eb] >> 16 : -1;
          s.last_row[warp] = eb < ee ? s.list_oi[ee - 1] >> 16 : -1;
          s.cont[warp] = cont;
        }
        PROF_MARK(2);
        // every warp has read the list and published its share; the slab's
        // buffer and counts are free (the next slab's barriers order what
        // follows before any other write of these rows and slots)
        __syncthreads();
        // rows continued past a warp: the warp that began the row adds the
        // later warps' slots, in warp order
        if (eb < ee && !(cont && s.first_row[warp] == s.last_row[warp])) {
          const int r = s.last_row[warp];
          float sum[LF];
#pragma unroll
          for (int q = 0; q < LF; ++q) sum[q] = 0.f;
          bool any = false;
          for (int w2 = warp + 1; w2 < SCAN_WARPS; ++w2) {
            if (s.first_row[w2] < 0) continue;   // an empty share
            if (!s.cont[w2]) break;
            float t[LF];
#pragma unroll
            for (int j = 0; j < LF / V; ++j)
              vget<V>(t + j * V, comb + w2 * CW + j * 32 * V + lane * V);
#pragma unroll
            for (int q = 0; q < LF; ++q) sum[q] += t[q];
            any = true;
            if (s.last_row[w2] != r) break;
          }
          if (any) row_add<V, LF>(acc_s + r * CW, sum, true);
        }
      }
      // no nonzero: the slab's buffer and counts are free once all read
      if (n == 0) __syncthreads();
#ifdef STREAM_SPMM_PROFILE
      ++p_items;
#endif
    }
    g0 += n_items;
  }

  // 4. the block's rows, each written once
  __syncthreads();
  float* y = a.y + (size_t)z * a.n_out_rows * F;
  for (int r = warp; r < n_rows; r += SCAN_WARPS) {
    float* yr = y + ((size_t)tile * b_out + m0 + r) * F;
#pragma unroll
    for (int j = 0; j < LF / V; ++j) {
      const int c = col0 + j * 32 * V;
      if (c >= F) continue;
      float t[V];
      vget<V>(t, acc_s + r * CW + j * 32 * V + lane * V);
      vput<V>(yr + c, t);
    }
  }
#ifdef STREAM_SPMM_PROFILE
  PROF_MARK(4);
  if (tid == 0) {
    using u64 = unsigned long long;
    const u64 t = clock64() - p_t0;
    atomicAdd(&g_prof[0], 1ull);
    atomicAdd(&g_prof[1], (u64)p_items);
    for (int i = 0; i < 5; ++i) atomicAdd(&g_prof[2 + i], (u64)p_ph[i]);
    atomicAdd(&g_prof[7], t);
    atomicMax(&g_prof[8], t);
  }
#endif
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

// One launch of a kernel variant; its shared memory is over the 48 KB
// default, so the first launch raises the variant's limit.
template <bool TRANSPOSE, int LF, int V>
int scan_run(const ScanArgs& a, int n_blocks, cudaStream_t stream) {
  auto kernel = stream_spmm_scan_kernel<TRANSPOSE, LF, V>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<n_blocks, SCAN_THREADS, scan_smem(a.stage_f, a.rows, 32 * LF),
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector (4, 2 or 1 floats) that F and both row bases allow.
int vec_width(int F, const void* x, const void* y) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y);
  if (F % 4 == 0 && p % 16 == 0) return 4;
  if (F % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

template <bool TRANSPOSE, int LF>
int scan_launch(const ScanArgs& a, int n_blocks, cudaStream_t stream) {
  switch (vec_width(a.F, a.x, a.y)) {
    case 4: return scan_run<TRANSPOSE, LF, 4>(a, n_blocks, stream);
    case 2: return scan_run<TRANSPOSE, LF, 2>(a, n_blocks, stream);
    default: return scan_run<TRANSPOSE, LF, 1>(a, n_blocks, stream);
  }
}

// The chunk widths a launch may take (floats; 640 fits a 602-wide input)
template <bool TRANSPOSE>
int scan_chunk(const ScanArgs& a, int chunk, int n_blocks,
               cudaStream_t stream) {
  switch (chunk) {
    case 128: return scan_launch<TRANSPOSE, 4>(a, n_blocks, stream);
    case 256: return scan_launch<TRANSPOSE, 8>(a, n_blocks, stream);
    case 512: return scan_launch<TRANSPOSE, 16>(a, n_blocks, stream);
    case 640: return scan_launch<TRANSPOSE, 20>(a, n_blocks, stream);
    case 1024: return scan_launch<TRANSPOSE, 32>(a, n_blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// K2. Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for operands the kernel does not take (bk % 4,
// bk over one staging buffer, a chunk other than 128 / 256 / 512 / 640 /
// 1024, rows x chunk over ACC_FLOATS, vals not 16-byte aligned).
// n_out_tiles = n_rt (forward) or n_ct (transpose); t_order may be null
// for the forward. A block owns `rows` output rows of a tile and `chunk`
// columns. With nsplit > 1, `parts` holds nsplit x n_out x F floats of
// scratch.
extern "C" int stream_spmm_f32(const void* vals, const void* blk_rc,
                               const void* t_order, int nb, const void* x,
                               void* y, void* parts, int n_out_tiles, int F,
                               int bm, int bk, int transpose, int nsplit,
                               int chunk, int rows, void* stream) {
  if (n_out_tiles <= 0 || F <= 0) return 0;
  if (bm <= 0 || bk <= 0 || bk % 4 != 0 || bk > STAGE_FLOATS ||
      rows <= 0 || rows > MAX_ROWS || (long)rows * chunk > ACC_FLOATS ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  nsplit = nsplit < 1 ? 1 : nsplit;
  const int b_out = transpose ? bk : bm;
  const int n_out_rows = n_out_tiles * b_out;
  ScanArgs a{static_cast<const float*>(vals),
             static_cast<const int32_t*>(blk_rc),
             static_cast<const int32_t*>(t_order),
             static_cast<const float*>(x),
             static_cast<float*>(nsplit > 1 ? parts : y),
             nb, F, bm, bk, n_out_rows, rows, (b_out + rows - 1) / rows,
             (F + chunk - 1) / chunk, nsplit, 0, 0};
  // slabs of at most STAGE_FLOATS floats, fewer rows where the block's
  // other shared memory leaves less (row stride ld: the block's columns
  // transposed, the tile's forward)
  const int ld = transpose ? (rows < bk ? rows : bk) : bk;
  const int span = transpose ? bm : (rows < bm ? rows : bm);
  a.srows = STAGE_FLOATS / ld < span ? STAGE_FLOATS / ld : span;
  auto stage_f = [&](int sr) { return (sr * ld + 31) / 32 * 32; };
  while (a.srows > 1 && scan_smem(stage_f(a.srows), rows, chunk) > SMEM_MAX)
    a.srows = (a.srows + 1) / 2;
  a.stage_f = stage_f(a.srows);
  if (scan_smem(a.stage_f, rows, chunk) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_blocks = (long)n_out_tiles * a.n_parts * a.n_chunks * nsplit;
  if (n_blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int err = transpose ? scan_chunk<true>(a, chunk, (int)n_blocks, s)
                            : scan_chunk<false>(a, chunk, (int)n_blocks, s);
  if (err != 0 || nsplit == 1) return err;
  const size_t n = (size_t)n_out_rows * F;
  const size_t blocks = (n + 255) / 256;
  sum_parts_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(
      static_cast<const float*>(parts), static_cast<float*>(y), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

#ifdef STREAM_SPMM_PROFILE
extern "C" int prof_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));
}
extern "C" int prof_zero() {
  unsigned long long z[9] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
}
#endif

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
