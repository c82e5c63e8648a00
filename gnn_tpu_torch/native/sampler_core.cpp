// Native host-side sampling core for gnn_tpu_torch (a copy of gnn_tpu's).
//
// Plays the role the CUDA extension plays in the reference
// (reference `spmm_cpp/` — the reference's only native component),
// but aimed at the *host* hot loop, which is where a TPU trainer's cycles
// go: the device side is XLA/Pallas, while LADIES sampling
// (reference `sampler.py:113-139`) — CSR row slicing, column-count
// probabilities, weighted sampling without replacement, column slicing
// with debias weights — runs on a handful of host cores and must feed
// multiple chips.
//
// Everything here is exact-equivalent to the numpy path (same math,
// Gumbel top-k == successive sampling without replacement) but fused,
// allocation-free per call, and OpenMP-parallel. The Python wrapper
// (`gnn_tpu_torch/native/__init__.py`) builds this JIT like the reference does
// (`custom_sparse_ops.py:8`) and falls back to numpy when unavailable.
//
// Exposed C ABI (ctypes):
//   count_cols       — pi = per-column nonzero counts of U = A[prev, :]
//   gumbel_topk      — top-k of log(p) + Gumbel noise over p > 0
//   slice_cols_count — row lengths of U[:, after]
//   slice_cols_fill  — COO of U[:, after] with w = data * normfact[col]

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Per-call OpenMP width. The pipeline tunes this so that
// (pool workers x OMP threads) ~= 2x physical cores — oversubscription
// measurably collapses throughput (127 -> 40 ms/batch on a 4-core host
// going from 4x4 to 4x2).
static int g_threads = 0;

void set_threads(int n) { g_threads = n; }

static int eff_threads() {
#ifdef _OPENMP
  return g_threads > 0 ? g_threads : omp_get_max_threads();
#else
  return 1;
#endif
}

// pi[c] = |{(r, c) in U}| for U = A[prev, :].
// indptr: int64[N+1], indices: int32[nnz], prev: int32[n_prev]
// out_pi: float64[n_cols] (pre-zeroed by caller)
void count_cols(const int64_t* indptr, const int32_t* indices,
                const int32_t* prev, int64_t n_prev, int64_t n_cols,
                double* out_pi) {
  int nt = eff_threads();
  if (nt > 1 && n_prev > 256 && n_prev < 65536) {
    // uint16 per-thread partials (counts <= n_prev < 65536, enforced
    // by the branch guard): half the table footprint of float
    // partials = fewer L2 misses on the random col increments.
    // Layers with >= 64K prev rows (far above any LADIES config here)
    // take the serial exact path below.
    std::vector<std::vector<uint16_t>> partial(nt);
#pragma omp parallel num_threads(nt)
    {
      int t = 0;
#ifdef _OPENMP
      t = omp_get_thread_num();
#endif
      partial[t].assign(n_cols, 0);
      uint16_t* mine = partial[t].data();
#pragma omp for schedule(dynamic, 64)
      for (int64_t i = 0; i < n_prev; ++i) {
        int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
        for (int64_t j = s; j < e; ++j) mine[indices[j]]++;
      }
#pragma omp for schedule(static)
      for (int64_t c = 0; c < n_cols; ++c) {
        int64_t acc = 0;
        for (int tt = 0; tt < nt; ++tt) acc += partial[tt][c];
        out_pi[c] = (double)acc;
      }
    }
  } else {
    for (int64_t i = 0; i < n_prev; ++i) {
      int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
      for (int64_t j = s; j < e; ++j) out_pi[indices[j]] += 1.0;
    }
  }
}

// Scale pi on a skew set (locality-aware sampling, `sampler.py:119-121`).
void scale_skew(double* pi, const int32_t* skew, int64_t n_skew,
                double factor) {
  for (int64_t i = 0; i < n_skew; ++i) pi[skew[i]] *= factor;
}

// Sample k indices without replacement with prob ~ pi (Gumbel top-k).
// Returns the actual count (= min(k, #nonzero)). out: int32[k].
// Key generation is OpenMP-parallel (per-thread RNG streams seeded from
// `seed` + thread id — deterministic for a fixed seed and thread count).
int64_t gumbel_topk(const double* pi, int64_t n, int64_t k, uint64_t seed,
                    int32_t* out) {
  int nt = eff_threads();
  std::vector<std::vector<std::pair<float, int32_t>>> parts(nt);
#pragma omp parallel num_threads(nt)
  {
    int t = 0;
#ifdef _OPENMP
    t = omp_get_thread_num();
#endif
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + t);
    std::uniform_real_distribution<double> unif(1e-300, 1.0);
    auto& mine = parts[t];
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    // worst case every candidate has pi > 0: reserving the full span
    // avoids up to ~4 realloc copies of ~100K pairs per call
    mine.reserve(hi - lo);
    for (int64_t i = lo; i < hi; ++i) {
      if (pi[i] > 0) {
        double g = -std::log(-std::log(unif(rng)));
        mine.emplace_back((float)(std::log(pi[i]) + g), (int32_t)i);
      }
    }
    // per-thread pre-selection: only a thread's own top-k can be in
    // the global top-k, so shrink each part to k before the merge
    // (identical keys => identical final selection; the serial
    // nth_element over all candidates was the fn's biggest cost)
    if ((int64_t)mine.size() > k) {
      std::nth_element(
          mine.begin(), mine.begin() + k, mine.end(),
          [](auto& a, auto& b) { return a.first > b.first; });
      mine.resize(k);
    }
  }
  std::vector<std::pair<float, int32_t>> keys;
  size_t total = 0;
  for (auto& p : parts) total += p.size();
  keys.reserve(total);
  for (auto& p : parts) keys.insert(keys.end(), p.begin(), p.end());
  int64_t m = (int64_t)keys.size();
  int64_t take = std::min(k, m);
  if (take < m) {
    std::nth_element(keys.begin(), keys.begin() + take, keys.end(),
                     [](auto& a, auto& b) { return a.first > b.first; });
  }
  for (int64_t i = 0; i < take; ++i) out[i] = keys[i].second;
  std::sort(out, out + take);
  return take;
}

// Per-row output lengths of U[:, after]: pos[c] >= 0 iff c in after.
void slice_cols_count(const int64_t* indptr, const int32_t* indices,
                      const int32_t* prev, int64_t n_prev,
                      const int32_t* pos, int64_t* out_rowlen) {
#pragma omp parallel for schedule(dynamic, 64) num_threads(eff_threads())
  for (int64_t i = 0; i < n_prev; ++i) {
    int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
    int64_t c = 0;
    for (int64_t j = s; j < e; ++j) c += (pos[indices[j]] >= 0);
    out_rowlen[i] = c;
  }
}

// Fill COO of U[:, after] with weights data * normfact[newcol]
// (`sampler.py:133-139` + `cuda_spmm.cu:800` semantics).
// row_off: exclusive prefix sum of rowlen (int64[n_prev+1]).
void slice_cols_fill(const int64_t* indptr, const int32_t* indices,
                     const float* data, const int32_t* prev, int64_t n_prev,
                     const int32_t* pos, const float* normfact,
                     const int64_t* row_off, int32_t* out_rows,
                     int32_t* out_cols, float* out_vals) {
#pragma omp parallel for schedule(dynamic, 64) num_threads(eff_threads())
  for (int64_t i = 0; i < n_prev; ++i) {
    int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
    int64_t w = row_off[i];
    for (int64_t j = s; j < e; ++j) {
      int32_t c = pos[indices[j]];
      if (c >= 0) {
        out_rows[w] = (int32_t)i;
        out_cols[w] = c;
        out_vals[w] = data[j] * normfact[c];
        ++w;
      }
    }
  }
}

// Cold-only variants for the resident-graph lite format
// (gnn_tpu/ops/residentgraph.py): the hot-hot edges live in the
// device-resident dense block and never need materializing on host, so
// fold the hotness test into the slice — writes shrink to the cold
// fraction (~30%) and the separate numpy mask pass disappears.
// hot_prev: uint8[n_prev] (row hot?); hot_node: uint8[N] over GLOBAL
// column ids (hot_node[indices[j]] == hot(after[newcol])).
void slice_cols_count_cold(const int64_t* indptr, const int32_t* indices,
                           const int32_t* prev, int64_t n_prev,
                           const int32_t* pos, const uint8_t* hot_prev,
                           const uint8_t* hot_node, int64_t* out_rowlen) {
#pragma omp parallel for schedule(dynamic, 64) num_threads(eff_threads())
  for (int64_t i = 0; i < n_prev; ++i) {
    int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
    int64_t c = 0;
    if (hot_prev[i]) {
      for (int64_t j = s; j < e; ++j)
        c += (pos[indices[j]] >= 0) && !hot_node[indices[j]];
    } else {
      for (int64_t j = s; j < e; ++j) c += (pos[indices[j]] >= 0);
    }
    out_rowlen[i] = c;
  }
}

void slice_cols_fill_cold(const int64_t* indptr, const int32_t* indices,
                          const float* data, const int32_t* prev,
                          int64_t n_prev, const int32_t* pos,
                          const float* normfact, const uint8_t* hot_prev,
                          const uint8_t* hot_node, const int64_t* row_off,
                          int32_t* out_rows, int32_t* out_cols,
                          float* out_vals) {
#pragma omp parallel for schedule(dynamic, 64) num_threads(eff_threads())
  for (int64_t i = 0; i < n_prev; ++i) {
    int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
    int64_t w = row_off[i];
    const bool rh = hot_prev[i];
    for (int64_t j = s; j < e; ++j) {
      int32_t c = pos[indices[j]];
      if (c >= 0 && !(rh && hot_node[indices[j]])) {
        out_rows[w] = (int32_t)i;
        out_cols[w] = c;
        out_vals[w] = data[j] * normfact[c];
        ++w;
      }
    }
  }
}

// Fused cold-only count+fill in ONE scan of the row spans (the
// count/fill pair rescans ~8M CSR entries per canonical layer; the
// second scan was ~40% of the whole sample cost). Threads take
// contiguous row blocks, append their cold edges to thread-local
// scratch, then copy into place after a serial prefix over block
// totals. Also emits per-row cold counts (out_rowlen, int32) — the
// resident-lite payload ships those instead of row indices.
// Returns n_cold, or -(needed) when the caller's buffers (capacity
// `cap`) are too small — retry with bigger buffers.
int64_t slice_cols_cold_fused(
    const int64_t* indptr, const int32_t* indices, const float* data,
    const int32_t* prev, int64_t n_prev, const int32_t* pos,
    const float* normfact, const uint8_t* hot_prev,
    const uint8_t* hot_node, int64_t cap, int32_t* out_rows,
    int32_t* out_cols, float* out_vals, int32_t* out_rowlen) {
  const int nt = eff_threads();
  static thread_local std::vector<int32_t> tl_r, tl_c;
  static thread_local std::vector<float> tl_v;
  std::vector<int64_t> block_count(nt + 1, 0);
  std::vector<std::vector<int32_t>*> rbufs(nt), cbufs(nt);
  std::vector<std::vector<float>*> vbufs(nt);
  const int64_t chunk = (n_prev + nt - 1) / std::max(nt, 1);
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    tl_r.clear();
    tl_c.clear();
    tl_v.clear();
    rbufs[t] = &tl_r;
    cbufs[t] = &tl_c;
    vbufs[t] = &tl_v;
    const int64_t lo = t * chunk, hi = std::min(n_prev, lo + chunk);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t s = indptr[prev[i]], e = indptr[prev[i] + 1];
      const bool rh = hot_prev[i];
      int32_t cnt = 0;
      for (int64_t j = s; j < e; ++j) {
        int32_t c = pos[indices[j]];
        if (c >= 0 && !(rh && hot_node[indices[j]])) {
          tl_r.push_back((int32_t)i);
          tl_c.push_back(c);
          tl_v.push_back(data[j] * normfact[c]);
          ++cnt;
        }
      }
      out_rowlen[i] = cnt;
    }
    block_count[t + 1] = (int64_t)tl_r.size();
  }
  for (int t = 0; t < nt; ++t) block_count[t + 1] += block_count[t];
  const int64_t n_cold = block_count[nt];
  if (n_cold > cap) return -n_cold;
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t w = block_count[t];
    const size_t m = rbufs[t]->size();
    std::memcpy(out_rows + w, rbufs[t]->data(), m * sizeof(int32_t));
    std::memcpy(out_cols + w, cbufs[t]->data(), m * sizeof(int32_t));
    std::memcpy(out_vals + w, vbufs[t]->data(), m * sizeof(float));
  }
  return n_cold;
}

// Split-CSR variant of the fused cold extraction: the caller provides
// a per-row REORDERED index/data copy (cold-column edges first) and
// hsplit[r] = absolute index of the first hot-column edge in row r.
// Hot rows then scan only their cold-col prefix (their hot-col edges
// are hot-hot by definition and live in the resident dense block) and
// the per-edge hotness test disappears for BOTH row kinds — only the
// sampled-column test remains. At canonical shapes the hub-hub bulk
// this skips is ~60-70% of the scanned entries.
int64_t slice_cols_cold_fused_split(
    const int64_t* indptr, const int64_t* hsplit, const int32_t* indices,
    const float* data, const int32_t* prev, int64_t n_prev,
    const int32_t* pos, const float* normfact, const uint8_t* hot_prev,
    int64_t cap, int32_t* out_rows, int32_t* out_cols, float* out_vals,
    int32_t* out_rowlen) {
  const int nt = eff_threads();
  static thread_local std::vector<int32_t> tl_r2, tl_c2;
  static thread_local std::vector<float> tl_v2;
  std::vector<int64_t> block_count(nt + 1, 0);
  std::vector<std::vector<int32_t>*> rbufs(nt), cbufs(nt);
  std::vector<std::vector<float>*> vbufs(nt);
  const int64_t chunk = (n_prev + nt - 1) / std::max(nt, 1);
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    tl_r2.clear();
    tl_c2.clear();
    tl_v2.clear();
    rbufs[t] = &tl_r2;
    cbufs[t] = &tl_c2;
    vbufs[t] = &tl_v2;
    const int64_t lo = t * chunk, hi = std::min(n_prev, lo + chunk);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t s = indptr[prev[i]];
      const int64_t e = hot_prev[i] ? hsplit[prev[i]]
                                    : indptr[prev[i] + 1];
      int32_t cnt = 0;
      for (int64_t j = s; j < e; ++j) {
        int32_t c = pos[indices[j]];
        if (c >= 0) {
          tl_r2.push_back((int32_t)i);
          tl_c2.push_back(c);
          tl_v2.push_back(data[j] * normfact[c]);
          ++cnt;
        }
      }
      out_rowlen[i] = cnt;
    }
    block_count[t + 1] = (int64_t)tl_r2.size();
  }
  for (int t = 0; t < nt; ++t) block_count[t + 1] += block_count[t];
  const int64_t n_cold = block_count[nt];
  if (n_cold > cap) return -n_cold;
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t w = block_count[t];
    const size_t m = rbufs[t]->size();
    std::memcpy(out_rows + w, rbufs[t]->data(), m * sizeof(int32_t));
    std::memcpy(out_cols + w, cbufs[t]->data(), m * sizeof(int32_t));
    std::memcpy(out_vals + w, vbufs[t]->data(), m * sizeof(float));
  }
  return n_cold;
}

// Cold slice STRAIGHT to tile-grouped coords (the stream-tiles
// resident payload): ONE scan of the split-CSR cold spans emitting
// packed int16 tile-local coords + per-tile counts — no per-edge
// values (val-free rank-1 graphs recompute them on device), no
// row/col arrays, no separate counting-sort pass. Roughly halves the
// cold-extraction memory traffic vs slice_cols_cold_fused_split +
// pack_tiles (no data[] stream, 6 thread-local bytes/edge vs 12).
// Phase 1: threads scan contiguous row blocks, appending (tile, coord)
// to thread-local scratch and counting per (thread, tile). Phase 2:
// a serial two-level prefix gives each (tile, thread) a disjoint
// cursor and threads scatter their own pairs — output is tile-major,
// stable by (tile, thread, visit order), which equals pack_tiles'
// order on the same edges (threads own contiguous row ranges).
// Returns n_cold, or -(needed) when `cap` is too small.
int64_t slice_cols_cold_tiles(
    const int64_t* indptr, const int64_t* hsplit, const int32_t* indices,
    const int32_t* prev, int64_t n_prev, const int32_t* pos,
    const uint8_t* hot_prev, int64_t n_ct, int64_t n_tiles,
    int log2_bm, int log2_bk, int64_t cap,
    int32_t* tile_cnt /* [n_tiles], pre-zeroed */,
    int16_t* coords_out) {
  const int nt = eff_threads();
  const int32_t bm_mask = (1 << log2_bm) - 1;
  const int32_t bk_mask = (1 << log2_bk) - 1;
  static thread_local std::vector<int32_t> tl_tile;
  static thread_local std::vector<int16_t> tl_co;
  static thread_local std::vector<int32_t> tl_tc;
  std::vector<std::vector<int32_t>*> tbufs(nt), tcnts(nt);
  std::vector<std::vector<int16_t>*> cbufs(nt);
  const int64_t chunk = (n_prev + nt - 1) / std::max(nt, 1);
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    tl_tile.clear();
    tl_co.clear();
    tl_tc.assign(n_tiles, 0);
    tbufs[t] = &tl_tile;
    cbufs[t] = &tl_co;
    tcnts[t] = &tl_tc;
    const int64_t lo = t * chunk, hi = std::min(n_prev, lo + chunk);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t s = indptr[prev[i]];
      const int64_t e = hot_prev[i] ? hsplit[prev[i]]
                                    : indptr[prev[i] + 1];
      const int64_t rt_base = (i >> log2_bm) * n_ct;
      const int16_t lr_sh =
          (int16_t)(uint16_t)(((int32_t)i & bm_mask) << log2_bk);
      for (int64_t j = s; j < e; ++j) {
        const int32_t c = pos[indices[j]];
        if (c >= 0) {
          const int64_t tile = rt_base + (c >> log2_bk);
          tl_tile.push_back((int32_t)tile);
          tl_co.push_back((int16_t)(lr_sh | (c & bk_mask)));
          tl_tc[tile]++;
        }
      }
    }
  }
  int64_t n_cold = 0;
  for (int t = 0; t < nt; ++t) n_cold += (int64_t)tbufs[t]->size();
  if (n_cold > cap) return -n_cold;
  // two-level prefix: cur[t][tile] = global start of (tile, thread t)
  std::vector<std::vector<int64_t>> cur(nt);
  for (int t = 0; t < nt; ++t) cur[t].resize(n_tiles);
  int64_t acc = 0;
  for (int64_t T = 0; T < n_tiles; ++T) {
    int64_t tot = 0;
    for (int t = 0; t < nt; ++t) {
      cur[t][T] = acc + tot;
      tot += (*tcnts[t])[T];
    }
    tile_cnt[T] = (int32_t)tot;
    acc += tot;
  }
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const auto& tiles = *tbufs[t];
    const auto& cos = *cbufs[t];
    auto& c = cur[t];
    for (size_t m = 0; m < tiles.size(); ++m)
      coords_out[c[tiles[m]]++] = cos[m];
  }
  return n_cold;
}

// Tile-grouping counting sort for the edge-stream SpMM kernel
// (gnn_tpu/ops/pallas_edgestream.py): scatter a local-id COO into
// tile-major order as packed int16 coords ((lr << 8) | lc), emitting
// per-tile counts. The numpy formulation (argsort of E int64 keys)
// costs ~75 ms at canonical cold-layer scale; two passes of counting
// sort over ~13K tiles cost ~2 ms. bm/bk must be powers of two
// (log2 passed); caller pre-zeroes tile_cnt[n_rt * n_ct].
void pack_tiles(const int32_t* rows, const int32_t* cols, int64_t e,
                int64_t n_ct, int64_t n_tiles, int log2_bm, int log2_bk,
                int32_t* tile_cnt, int16_t* coords_out) {
  const int32_t bm_mask = (1 << log2_bm) - 1;
  const int32_t bk_mask = (1 << log2_bk) - 1;
  for (int64_t i = 0; i < e; ++i)
    tile_cnt[((int64_t)(rows[i] >> log2_bm)) * n_ct +
             (cols[i] >> log2_bk)]++;
  static thread_local std::vector<int64_t> cur;
  cur.resize(n_tiles);
  int64_t acc = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    cur[t] = acc;
    acc += tile_cnt[t];
  }
  for (int64_t i = 0; i < e; ++i) {
    const int32_t r = rows[i], c = cols[i];
    const int64_t key = ((int64_t)(r >> log2_bm)) * n_ct + (c >> log2_bk);
    coords_out[cur[key]++] =
        (int16_t)(uint16_t)(((r & bm_mask) << log2_bk) | (c & bk_mask));
  }
}

// pack_tiles + the tile-order PERMUTATION (perm[w] = input index of the
// edge at output slot w) — lets the caller reorder per-edge VALUES into
// tile order for the weighted (non-rank-1) edge-stream payload.
void pack_tiles_perm(const int32_t* rows, const int32_t* cols, int64_t e,
                     int64_t n_ct, int64_t n_tiles, int log2_bm,
                     int log2_bk, int32_t* tile_cnt, int16_t* coords_out,
                     int32_t* perm_out) {
  const int32_t bm_mask = (1 << log2_bm) - 1;
  const int32_t bk_mask = (1 << log2_bk) - 1;
  for (int64_t i = 0; i < e; ++i)
    tile_cnt[((int64_t)(rows[i] >> log2_bm)) * n_ct +
             (cols[i] >> log2_bk)]++;
  static thread_local std::vector<int64_t> cur;
  cur.resize(n_tiles);
  int64_t acc = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    cur[t] = acc;
    acc += tile_cnt[t];
  }
  for (int64_t i = 0; i < e; ++i) {
    const int32_t r = rows[i], c = cols[i];
    const int64_t key = ((int64_t)(r >> log2_bm)) * n_ct + (c >> log2_bk);
    const int64_t w = cur[key]++;
    coords_out[w] =
        (int16_t)(uint16_t)(((r & bm_mask) << log2_bk) | (c & bk_mask));
    perm_out[w] = (int32_t)i;
  }
}

// Convenience: exclusive prefix sum.
void prefix_sum(const int64_t* in, int64_t n, int64_t* out) {
  int64_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = acc;
    acc += in[i];
  }
  out[n] = acc;
}

// Hot/cold split for the persistent hot-subgraph aggregation
// (gnn_tpu/ops/hotdense.py): from a row-sorted COO layer, extract the
// cold edges (row or col not hot) preserving row order, and also emit a
// col-sorted copy (counting sort) for the backward direction. Plays the
// role the reference's device-side COO build plays
// (`cuda_spmm.cu:787-827`) for the residual part. Returns n_cold;
// caller provides nnz-sized output buffers and slices to the count.
int64_t hot_split(const int32_t* rows, const int32_t* cols,
                  const float* vals, int64_t nnz, const uint8_t* hot_row,
                  const uint8_t* hot_col, int64_t n_cols, int32_t* cr,
                  int32_t* cc, float* cv, int32_t* crt, int32_t* cct,
                  float* cvt) {
  const int nt = eff_threads();
  // pass 1: per-chunk cold counts (parallel), then stable compaction
  std::vector<int64_t> chunk_count(nt + 1, 0);
  const int64_t chunk = (nnz + nt - 1) / std::max(nt, 1);
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = t * chunk, hi = std::min(nnz, lo + chunk);
    int64_t c = 0;
    for (int64_t i = lo; i < hi; ++i)
      c += !(hot_row[rows[i]] && hot_col[cols[i]]);
    chunk_count[t + 1] = c;
  }
  for (int t = 0; t < nt; ++t) chunk_count[t + 1] += chunk_count[t];
  const int64_t n_cold = chunk_count[nt];
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = t * chunk, hi = std::min(nnz, lo + chunk);
    int64_t w = chunk_count[t];
    for (int64_t i = lo; i < hi; ++i) {
      if (!(hot_row[rows[i]] && hot_col[cols[i]])) {
        cr[w] = rows[i];
        cc[w] = cols[i];
        cv[w] = vals[i];
        ++w;
      }
    }
  }
  // pass 2: counting sort by column for the transpose copy (stable)
  std::vector<int64_t> cnt(n_cols + 1, 0);
  for (int64_t i = 0; i < n_cold; ++i) cnt[cc[i] + 1]++;
  for (int64_t c = 0; c < n_cols; ++c) cnt[c + 1] += cnt[c];
  for (int64_t i = 0; i < n_cold; ++i) {
    const int64_t w = cnt[cc[i]]++;
    cct[w] = cc[i];
    crt[w] = cr[i];
    cvt[w] = cv[i];
  }
  return n_cold;
}

}  // extern "C"
