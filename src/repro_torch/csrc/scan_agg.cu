// Scans over host-located row slabs, with rows outer or queries outer.
//
// Replaces the TPU kernels repro/kernels/scan_agg.py:scan_agg_rowstream_kernel
// (rows outer; also the Q = 1 scan_agg_pallas) and
// repro/kernels/scan_agg.py:scan_agg_qgrid_kernel (queries outer). Per
// query, over the rows of its [slab_lo, slab_hi) slab: the float32 sum of
// the selected value row over the rows passing the residual predicate
// (per logical column, value in [lo, hi); wide columns as lexicographic
// lane pairs), and the count of those rows. A selector outside
// [0, n_vals) sums nothing but still counts, as in the reference.
//
// Rows outer (rowstream_*). One CTA per staging tile of rows: it loads the
// tile's key lanes and live value rows from device memory into shared
// memory once, then serves every query of the batch from it, one warp per
// query at a time. So the columns stream once per batch, whatever Q is,
// and a tile that no query's slab meets is not read at all. What bounds
// it on an H100: the compares of the (query, row) pairs inside the slabs
// (about 2 * n_lanes + 4 integer operations each) against the bytes of the
// rows those slabs cover; at SF 5 with a batch of 256 the slabs of the
// Q1/Q2 templates are short on the replica that suits them and long on the
// others, so the bound shifts between the two with the data.
//
// Queries outer (qgrid_*). One CTA per (query, row block), row blocks
// fastest, as the TPU kernel's grid: every CTA reads its block's key lanes
// and value row from device memory and compares every row, in or out of
// the slab. Key traffic therefore scales with Q (Q * N * (K + 1) * 4
// bytes); that is the point of this baseline and nothing here avoids it.
// Narrow columns and one value row only, as the TPU kernel.
//
// Float order: each (query, tile or block) partial is reduced in a fixed
// order (lanes in row order, then a fixed warp butterfly, and for qgrid
// per-warp slots folded in warp order), and a second launch folds the
// partials of each query strictly sequentially in ascending row order, one
// warp per query so that the loads of the partials overlap.
// No float atomics, so results are identical run to run. Counts are int32
// partials folded in int32 and converted to float32 at the end: exact to
// 2**24 like the reference's float32 count lane.
#include "predicates.cuh"

using namespace repro;

namespace {

// Queries whose bounds one rowstream CTA stages in shared memory at a time.
constexpr int kRowstreamChunk = 256;
// Rows of one qgrid block (the TPU kernel's default block_n).
constexpr int kQgridRows = 2048;
// Key lanes a qgrid CTA keeps in shared memory.
constexpr int kQgridMaxLanes = 64;

inline size_t rowstream_fixed_smem(int n_lanes) {
  return (size_t)kRowstreamChunk * (2 * n_lanes + 3) * 4;
}

inline int rowstream_tile(int n_lanes, int n_vals) {
  return pick_tile(rowstream_fixed_smem(n_lanes), n_lanes + n_vals);
}

__global__ void __launch_bounds__(kThreads)
rowstream_partials(const int32_t* __restrict__ keys, int64_t n_pad, int64_t n,
                   int n_lanes, int n_cols, uint32_t wide_mask,
                   const float* __restrict__ values, int n_vals,
                   const int32_t* __restrict__ col_lo,
                   const int32_t* __restrict__ col_hi,
                   const int32_t* __restrict__ slabs,
                   const int32_t* __restrict__ sel, int n_q, int tile,
                   float* __restrict__ part_s, int32_t* __restrict__ part_c) {
  extern __shared__ int32_t smem[];
  const int L = n_lanes;
  int32_t* tile_k = smem;
  float* tile_v = reinterpret_cast<float*>(tile_k + L * tile);
  int32_t* q_lo = reinterpret_cast<int32_t*>(tile_v + n_vals * tile);
  int32_t* q_hi = q_lo + kRowstreamChunk * L;
  int32_t* q_slab = q_hi + kRowstreamChunk * L;
  int32_t* q_sel = q_slab + 2 * kRowstreamChunk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * tile;
  const int64_t row1 = min(row0 + tile, n);

  // a tile that no slab meets is neither read nor given partials: the fold
  // reads only the tiles each query's slab meets
  int hit = 0;
  for (int q = tid; q < n_q; q += kThreads) {
    const int64_t s0 = max((int64_t)slabs[2 * q], row0);
    const int64_t s1 = min((int64_t)slabs[2 * q + 1], row1);
    hit |= s0 < s1;
  }
  if (!__syncthreads_or(hit)) return;

  const int rows = (int)(row1 - row0);
  for (int l = 0; l < L; ++l) {
    for (int i = tid; i < rows; i += kThreads) {
      tile_k[l * tile + i] = keys[l * n_pad + row0 + i];
    }
  }
  for (int v = 0; v < n_vals; ++v) {
    for (int i = tid; i < rows; i += kThreads) {
      tile_v[v * tile + i] = values[v * n_pad + row0 + i];
    }
  }

  for (int c0 = 0; c0 < n_q; c0 += kRowstreamChunk) {
    const int cn = min(kRowstreamChunk, n_q - c0);
    __syncthreads();  // the tile staged; the previous chunk consumed
    for (int i = tid; i < cn * L; i += kThreads) {
      q_lo[i] = col_lo[(int64_t)c0 * L + i];
      q_hi[i] = col_hi[(int64_t)c0 * L + i];
    }
    for (int i = tid; i < cn; i += kThreads) {
      q_slab[2 * i] = slabs[2 * (int64_t)(c0 + i)];
      q_slab[2 * i + 1] = slabs[2 * (int64_t)(c0 + i) + 1];
      q_sel[i] = sel[c0 + i];
    }
    __syncthreads();
    for (int j = warp; j < cn; j += kWarps) {
      const int i0 = (int)(max((int64_t)q_slab[2 * j], row0) - row0);
      const int i1 = (int)(min((int64_t)q_slab[2 * j + 1], row1) - row0);
      if (i0 >= i1) continue;  // uniform across the warp
      const int sv = q_sel[j];
      const float* vrow = (sv >= 0 && sv < n_vals) ? tile_v + sv * tile : nullptr;
      const int32_t* lo = q_lo + j * L;
      const int32_t* hi = q_hi + j * L;
      float s = 0.f;
      int c = 0;
      for (int i = i0 + lane; i < i1; i += 32) {
        if (residual_ok(tile_k, tile, i, lo, hi, n_cols, wide_mask)) {
          ++c;
          if (vrow != nullptr) s += vrow[i];
        }
      }
      s = warp_sum(s);
      c = warp_sum(c);
      if (lane == 0) {
        const int64_t o = (int64_t)blockIdx.x * n_q + c0 + j;
        part_s[o] = s;
        part_c[o] = c;
      }
    }
  }
}

// The second launch of both scans: one warp per query folds that query's
// partials. The lanes load 32 consecutive partials at a time and every lane
// adds them in ascending order, shuffled to it one by one, so the sum is
// the strictly sequential float32 fold while the loads overlap; the int32
// counts reduce in any order.
__device__ __forceinline__ void fold_partials(const float* __restrict__ part_s,
                                              const int32_t* __restrict__ part_c,
                                              int64_t b0, int64_t b1,
                                              int64_t stride, int64_t offset,
                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  int c = 0;
  for (int64_t base = b0; base < b1; base += 32) {
    const int64_t b = base + lane;
    float v = 0.f;
    if (b < b1) {
      v = part_s[b * stride + offset];
      c += part_c[b * stride + offset];
    }
    const int m = (int)min((int64_t)32, b1 - base);
    for (int l = 0; l < m; ++l) s += __shfl_sync(0xffffffffu, v, l);
  }
  c = warp_sum(c);
  if (lane == 0) {
    out[0] = s;
    out[1] = (float)c;
  }
}

// Per query, the partials of the tiles its slab meets, in ascending tile
// order ([n_tiles, n_q] layout).
__global__ void rowstream_fold(const float* __restrict__ part_s,
                               const int32_t* __restrict__ part_c,
                               const int32_t* __restrict__ slabs, int64_t n,
                               int tile, int n_q, float* __restrict__ out) {
  const int64_t q = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (q >= n_q) return;  // uniform across the warp
  const int64_t s0 = max((int64_t)slabs[2 * q], (int64_t)0);
  const int64_t s1 = min((int64_t)slabs[2 * q + 1], n);
  const int64_t b0 = s0 < s1 ? s0 / tile : 0;
  const int64_t b1 = s0 < s1 ? (s1 - 1) / tile + 1 : 0;
  fold_partials(part_s, part_c, b0, b1, n_q, q, out + 2 * q);
}

__global__ void __launch_bounds__(kThreads)
qgrid_partials(const int32_t* __restrict__ keys, int64_t n_pad, int64_t n,
               int n_lanes, const float* __restrict__ vals,
               const int32_t* __restrict__ col_lo,
               const int32_t* __restrict__ col_hi,
               const int32_t* __restrict__ slabs, int n_blocks,
               float* __restrict__ part_s, int32_t* __restrict__ part_c) {
  __shared__ int32_t s_lo[kQgridMaxLanes];
  __shared__ int32_t s_hi[kQgridMaxLanes];
  __shared__ float slot_s[kWarps];
  __shared__ int32_t slot_c[kWarps];
  const int64_t cta = blockIdx.x;
  const int64_t q = cta / n_blocks;  // queries outer,
  const int64_t b = cta % n_blocks;  // row blocks fastest
  const int tid = threadIdx.x;
  for (int l = tid; l < n_lanes; l += kThreads) {
    s_lo[l] = col_lo[q * n_lanes + l];
    s_hi[l] = col_hi[q * n_lanes + l];
  }
  __syncthreads();
  const int64_t slab0 = slabs[2 * q];
  const int64_t slab1 = slabs[2 * q + 1];
  const int64_t row0 = b * kQgridRows;
  float s = 0.f;
  int c = 0;
  for (int i = tid; i < kQgridRows; i += kThreads) {
    const int64_t r = row0 + i;
    if (r >= n) break;
    // every lane of every row is read, in the slab or not
    bool ok = (r >= slab0) & (r < slab1);
    for (int l = 0; l < n_lanes; ++l) {
      const int32_t k = keys[l * n_pad + r];
      ok &= (k >= s_lo[l]) & (k < s_hi[l]);
    }
    const float v = vals[r];
    if (ok) {
      s += v;
      ++c;
    }
  }
  s = warp_sum(s);
  c = warp_sum(c);
  if ((tid & 31) == 0) {
    slot_s[tid >> 5] = s;
    slot_c[tid >> 5] = c;
  }
  __syncthreads();
  if (tid == 0) {
    float bs = 0.f;
    int bc = 0;
    for (int w = 0; w < kWarps; ++w) {
      bs += slot_s[w];
      bc += slot_c[w];
    }
    part_s[cta] = bs;
    part_c[cta] = bc;
  }
}

// Per query, its [n_blocks] partials in ascending block order ([n_q,
// n_blocks] layout).
__global__ void qgrid_fold(const float* __restrict__ part_s,
                           const int32_t* __restrict__ part_c, int n_blocks,
                           int n_q, float* __restrict__ out) {
  const int64_t q = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (q >= n_q) return;  // uniform across the warp
  fold_partials(part_s, part_c, 0, n_blocks, 1, q * n_blocks, out + 2 * q);
}

}  // namespace

// Rows of the rowstream staging tile for n_lanes key lanes and n_vals live
// value rows (0 if even the smallest tile does not fit): the wrapper sizes
// the [ceil(n / tile), n_q] partials by it.
extern "C" int rowstream_tile_rows(int n_lanes, int n_vals) {
  return rowstream_tile(n_lanes, n_vals);
}

// keys int32[>=n_lanes, n_pad], values float32[>=n_vals, n_pad], rows
// [0, n) scanned; col_lo / col_hi int32[n_q, n_lanes], slabs int32[n_q, 2],
// sel int32[n_q]; part_* [ceil(n / tile), n_q] scratch; out float32[n_q, 2].
// Returns cudaGetLastError() (0 = ok).
extern "C" int rowstream_launch(const int32_t* keys, int64_t n_pad, int64_t n,
                                int n_lanes, int n_cols, uint32_t wide_mask,
                                const float* values, int n_vals,
                                const int32_t* col_lo, const int32_t* col_hi,
                                const int32_t* slabs, const int32_t* sel,
                                int n_q, float* part_s, int32_t* part_c,
                                float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0) return 0;
  if (n_lanes < 1 || n_cols < 1 || n_cols > 32 || n_vals < 1 || n < 0 ||
      n > n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = rowstream_tile(n_lanes, n_vals);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (n + tile - 1) / tile;
  if (n_tiles > 0) {
    const size_t smem =
        rowstream_fixed_smem(n_lanes) + (size_t)tile * (n_lanes + n_vals) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        rowstream_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    rowstream_partials<<<(unsigned)n_tiles, kThreads, smem, st>>>(
        keys, n_pad, n, n_lanes, n_cols, wide_mask, values, n_vals, col_lo,
        col_hi, slabs, sel, n_q, tile, part_s, part_c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rowstream_fold<<<(unsigned)(((int64_t)n_q * 32 + 255) / 256), 256, 0, st>>>(
      part_s, part_c, slabs, n, tile, n_q, out);
  return static_cast<int>(cudaGetLastError());
}

// Rows of one qgrid block: the wrapper sizes the [n_q, n_blocks] partials.
extern "C" int qgrid_block_rows() { return kQgridRows; }

// keys int32[>=n_lanes, n_pad] (narrow lanes), vals float32[n_pad] (one
// value row), rows [0, n) scanned; col_lo / col_hi int32[n_q, n_lanes],
// slabs int32[n_q, 2]; part_* [n_q, n_blocks] scratch with n_blocks =
// ceil(n / qgrid_block_rows()); out float32[n_q, 2].
extern "C" int qgrid_launch(const int32_t* keys, int64_t n_pad, int64_t n,
                            int n_lanes, const float* vals,
                            const int32_t* col_lo, const int32_t* col_hi,
                            const int32_t* slabs, int n_q, int n_blocks,
                            float* part_s, int32_t* part_c, float* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kQgridMaxLanes || n < 0 || n > n_pad ||
      n_blocks != (int)((n + kQgridRows - 1) / kQgridRows) ||
      (int64_t)n_q * n_blocks >= ((int64_t)1 << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    qgrid_partials<<<(unsigned)((int64_t)n_q * n_blocks), kThreads, 0, st>>>(
        keys, n_pad, n, n_lanes, vals, col_lo, col_hi, slabs, n_blocks,
        part_s, part_c);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  qgrid_fold<<<(unsigned)(((int64_t)n_q * 32 + 255) / 256), 256, 0, st>>>(
      part_s, part_c, n_blocks, n_q, out);
  return static_cast<int>(cudaGetLastError());
}
