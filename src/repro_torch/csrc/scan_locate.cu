// Fused locate+scan for the device read path.
//
// Replaces the TPU kernel repro/kernels/slab_locate.py:scan_agg_locate_kernel.
// Per query, over its [start, stop) row window: the float32 sum of the
// selected value row over rows passing the residual [lo, hi) predicate,
// the int32 count of those rows, and the int32 count of rows whose key
// tuple lies lexicographically inside [slab_lo, slab_hi] (both inclusive).
//
// What bounds it on an H100: integer compares. Every (row, query) pair
// evaluates the slab and residual predicates, so at 7.5 M rows and 256
// queries the work is ~2e9 predicate evaluations against 180 MB of key and
// value lanes: the kernel is far above the card's bytes-per-operation
// line. The design therefore reads each row's lanes from device memory
// once per 128-query chunk into a shared-memory tile and evaluates every
// query of the chunk against the tile, with the query bounds broadcast
// from shared memory.
//
// Float order (the parity contract): one CTA owns one 8192-row block and
// reduces each query's block partial in the in-block order that
// predicates.cuh defines (tile_sum_into, fold_warp_slots, over tiles of
// scan_tile() rows); the view kernels in block_sums.cu reduce a block the
// same way. A second pass folds the block partials sequentially in
// ascending block order in float32. No float atomics, no split of the sum
// lane, so results are identical run to run.
#include "predicates.cuh"

using namespace repro;

namespace {

__global__ void __launch_bounds__(kThreads)
scan_partials(const int32_t* __restrict__ keys, int64_t n_pad, int n_lanes,
              int n_cols, uint32_t wide_mask, const float* __restrict__ values,
              int n_vals, const int32_t* __restrict__ res_lo,
              const int32_t* __restrict__ res_hi,
              const int32_t* __restrict__ slab_lo,
              const int32_t* __restrict__ slab_hi,
              const int32_t* __restrict__ limits,
              const int32_t* __restrict__ sel, int n_q, int tile,
              float* __restrict__ part_s, int32_t* __restrict__ part_m,
              int32_t* __restrict__ part_c) {
  extern __shared__ int32_t smem[];
  const int L = n_lanes;
  int32_t* q_lo = smem;
  int32_t* q_hi = q_lo + kQueryChunk * L;
  int32_t* s_lo = q_hi + kQueryChunk * L;
  int32_t* s_hi = s_lo + kQueryChunk * L;
  int32_t* q_lim = s_hi + kQueryChunk * L;
  int32_t* q_sel = q_lim + 2 * kQueryChunk;
  float* red_s = reinterpret_cast<float*>(q_sel + kQueryChunk);
  int32_t* red_m = reinterpret_cast<int32_t*>(red_s + kQueryChunk * kWarps);
  int32_t* red_c = red_m + kQueryChunk * kWarps;
  int32_t* tile_k = red_c + kQueryChunk * kWarps;
  float* tile_v = reinterpret_cast<float*>(tile_k + L * tile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t block_row0 = (int64_t)blockIdx.x * kBlockRows;
  const int q0 = blockIdx.y * kQueryChunk;
  const int qn = min(kQueryChunk, n_q - q0);

  for (int i = tid; i < qn * L; i += kThreads) {
    const int64_t g = (int64_t)q0 * L + i;
    q_lo[i] = res_lo[g];
    q_hi[i] = res_hi[g];
    s_lo[i] = slab_lo[g];
    s_hi[i] = slab_hi[g];
  }
  for (int i = tid; i < qn; i += kThreads) {
    q_lim[2 * i] = limits[2 * (int64_t)(q0 + i)];
    q_lim[2 * i + 1] = limits[2 * (int64_t)(q0 + i) + 1];
    q_sel[i] = sel[q0 + i];
  }
  for (int i = tid; i < qn * kWarps; i += kThreads) {
    red_s[i] = 0.f;
    red_m[i] = 0;
    red_c[i] = 0;
  }

  for (int t0 = 0; t0 < kBlockRows; t0 += tile) {
    const int64_t row0 = block_row0 + t0;
    if (row0 >= n_pad) break;  // uniform across the CTA
    __syncthreads();           // previous tile fully consumed
    for (int l = 0; l < L; ++l) {
      for (int i = tid; i < tile; i += kThreads) {
        const int64_t r = row0 + i;
        tile_k[l * tile + i] = r < n_pad ? keys[l * n_pad + r] : 0;
      }
    }
    for (int v = 0; v < n_vals; ++v) {
      for (int i = tid; i < tile; i += kThreads) {
        const int64_t r = row0 + i;
        tile_v[v * tile + i] = r < n_pad ? values[v * n_pad + r] : 0.f;
      }
    }
    __syncthreads();
    for (int q = 0; q < qn; ++q) {
      const int64_t lo = q_lim[2 * q];
      const int64_t hi = q_lim[2 * q + 1];
      if (hi <= row0 || lo >= row0 + tile) continue;  // uniform per q
      const int32_t* rlo = q_lo + q * L;
      const int32_t* rhi = q_hi + q * L;
      const int32_t* slo = s_lo + q * L;
      const int32_t* shi = s_hi + q * L;
      const int sv = q_sel[q];
      const float* vrow = (sv >= 0 && sv < n_vals) ? tile_v + sv * tile : nullptr;
      int m = 0;
      int c = 0;
      tile_sum_into(
          tile,
          [&](int i, float& v) {
            const int64_t r = row0 + i;
            if (r < lo || r >= hi) return false;
            if (lex_ge(tile_k, tile, i, slo, L) && lex_le(tile_k, tile, i, shi, L)) ++c;
            if (!residual_ok(tile_k, tile, i, rlo, rhi, n_cols, wide_mask)) return false;
            ++m;
            if (vrow == nullptr) return false;
            v = vrow[i];
            return true;
          },
          red_s + q * kWarps);
      m = warp_sum(m);
      c = warp_sum(c);
      if (lane == 0) {
        red_m[q * kWarps + warp] += m;
        red_c[q * kWarps + warp] += c;
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < qn; q += kThreads) {
    int m = 0;
    int c = 0;
    for (int w = 0; w < kWarps; ++w) {
      m += red_m[q * kWarps + w];
      c += red_c[q * kWarps + w];
    }
    const int64_t o = (int64_t)blockIdx.x * n_q + q0 + q;
    part_s[o] = fold_warp_slots(red_s + q * kWarps);
    part_m[o] = m;
    part_c[o] = c;
  }
}

// Sequential float32 fold of the [n_blocks, Q] partials in ascending block
// order, one thread per query (coalesced across queries).
__global__ void scan_fold(const float* __restrict__ part_s,
                          const int32_t* __restrict__ part_m,
                          const int32_t* __restrict__ part_c, int n_blocks,
                          int n_q, float* __restrict__ out_s,
                          int32_t* __restrict__ out_m,
                          int32_t* __restrict__ out_c) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  float s = 0.f;
  int m = 0;
  int c = 0;
#pragma unroll 8
  for (int b = 0; b < n_blocks; ++b) {
    const int64_t o = (int64_t)b * n_q + q;
    s += part_s[o];
    m += part_m[o];
    c += part_c[o];
  }
  out_s[q] = s;
  out_m[q] = m;
  out_c[q] = c;
}

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
// keys int32[>=n_lanes, n_pad], values float32[>=n_vals, n_pad], the four
// bound arrays int32[n_q, n_lanes], limits int32[n_q, 2], sel int32[n_q];
// part_* are [n_blocks, n_q] scratch, out_* are [n_q].
extern "C" int scan_locate_launch(
    const int32_t* keys, int64_t n_pad, int n_lanes, int n_cols,
    uint32_t wide_mask, const float* values, int n_vals, const int32_t* res_lo,
    const int32_t* res_hi, const int32_t* slab_lo, const int32_t* slab_hi,
    const int32_t* limits, const int32_t* sel, int n_q, int n_blocks,
    float* part_s, int32_t* part_m, int32_t* part_c, float* out_s,
    int32_t* out_m, int32_t* out_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0 || n_blocks <= 0) return 0;
  if (n_lanes < 1 || n_cols < 1 || n_cols > 32 || n_vals < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the tile sets the in-block float order: block_sums.cu takes the same
  const int tile = scan_tile(n_lanes, n_vals);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scan_fixed_smem(n_lanes) + (size_t)tile * (n_lanes + n_vals) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      scan_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_blocks, (n_q + kQueryChunk - 1) / kQueryChunk);
  scan_partials<<<grid, kThreads, smem, st>>>(
      keys, n_pad, n_lanes, n_cols, wide_mask, values, n_vals, res_lo, res_hi,
      slab_lo, slab_hi, limits, sel, n_q, tile, part_s, part_m, part_c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_fold<<<(n_q + 255) / 256, 256, 0, st>>>(part_s, part_m, part_c,
                                                n_blocks, n_q, out_s, out_m,
                                                out_c);
  return static_cast<int>(cudaGetLastError());
}
