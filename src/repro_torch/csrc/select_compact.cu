// Select compaction: per query, the ascending indices of the rows inside
// its [start, stop) window that pass the residual [lo, hi) predicate.
//
// Replaces the TPU kernel repro/kernels/slab_locate.py:select_compact_kernel
// (block-local exclusive prefix sum plus a carried per-query base over a
// sequential grid). Hopper has no sequential grid, so the carry becomes
// three passes:
//   1. select_counts: per (8192-row block, query) match counts, with the
//      block's key lanes staged in shared memory for a chunk of queries;
//   2. select_scan: per query, an exclusive scan of its block counts in
//      ascending block order, seeded with the query's output offset;
//   3. select_scatter: one CTA per (block, query) that has matches; each
//      warp owns a contiguous 1024-row segment, counts it with ballots,
//      and the warps write their rows at base + warp prefix + ballot rank,
//      so indices land in ascending row order.
// The output is one flat int32 array; offsets[q] .. offsets[q + 1] is
// query q's slice (sized on the host from the fused scan's match counts),
// so one launch serves every width.
//
// What bounds it on an H100: like the fused scan, the predicate over
// every (row, query) pair in pass 1; the scatter touches only blocks that
// hold matches, and the output is as many int32 as there are matches.
#include "predicates.cuh"

using namespace repro;

namespace {

__global__ void __launch_bounds__(kThreads)
select_counts(const int32_t* __restrict__ keys, int64_t n_pad, int n_lanes,
              int n_cols, uint32_t wide_mask, const int32_t* __restrict__ res_lo,
              const int32_t* __restrict__ res_hi,
              const int32_t* __restrict__ limits, int n_q, int tile,
              int64_t* __restrict__ base) {
  extern __shared__ int32_t smem[];
  const int L = n_lanes;
  int32_t* q_lo = smem;
  int32_t* q_hi = q_lo + kQueryChunk * L;
  int32_t* q_lim = q_hi + kQueryChunk * L;
  int32_t* red_m = q_lim + 2 * kQueryChunk;
  int32_t* tile_k = red_m + kQueryChunk * kWarps;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t block_row0 = (int64_t)blockIdx.x * kBlockRows;
  const int q0 = blockIdx.y * kQueryChunk;
  const int qn = min(kQueryChunk, n_q - q0);

  for (int i = tid; i < qn * L; i += kThreads) {
    q_lo[i] = res_lo[(int64_t)q0 * L + i];
    q_hi[i] = res_hi[(int64_t)q0 * L + i];
  }
  for (int i = tid; i < qn; i += kThreads) {
    q_lim[2 * i] = limits[2 * (int64_t)(q0 + i)];
    q_lim[2 * i + 1] = limits[2 * (int64_t)(q0 + i) + 1];
  }
  for (int i = tid; i < qn * kWarps; i += kThreads) red_m[i] = 0;

  for (int t0 = 0; t0 < kBlockRows; t0 += tile) {
    const int64_t row0 = block_row0 + t0;
    if (row0 >= n_pad) break;  // uniform across the CTA
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      for (int i = tid; i < tile; i += kThreads) {
        const int64_t r = row0 + i;
        tile_k[l * tile + i] = r < n_pad ? keys[l * n_pad + r] : 0;
      }
    }
    __syncthreads();
    for (int q = 0; q < qn; ++q) {
      const int64_t lo = q_lim[2 * q];
      const int64_t hi = q_lim[2 * q + 1];
      if (hi <= row0 || lo >= row0 + tile) continue;  // uniform per q
      const int32_t* rlo = q_lo + q * L;
      const int32_t* rhi = q_hi + q * L;
      int m = 0;
      for (int i = tid; i < tile; i += kThreads) {
        const int64_t r = row0 + i;
        if (r < lo || r >= hi) continue;
        m += residual_ok(tile_k, tile, i, rlo, rhi, n_cols, wide_mask);
      }
      m = warp_sum(m);
      if (lane == 0) red_m[q * kWarps + warp] += m;
    }
  }
  __syncthreads();
  for (int q = tid; q < qn; q += kThreads) {
    int m = 0;
    for (int w = 0; w < kWarps; ++w) m += red_m[q * kWarps + w];
    base[(int64_t)blockIdx.x * n_q + q0 + q] = m;
  }
}

// In place: counts -> each block's first output slot, per query in
// ascending block order starting at offsets[q].
__global__ void select_scan(int64_t* __restrict__ base,
                            const int64_t* __restrict__ offsets, int n_blocks,
                            int n_q) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  int64_t acc = offsets[q];
  for (int b = 0; b < n_blocks; ++b) {
    const int64_t o = (int64_t)b * n_q + q;
    const int64_t c = base[o];
    base[o] = acc;
    acc += c;
  }
}

__global__ void __launch_bounds__(kThreads)
select_scatter(const int32_t* __restrict__ keys, int64_t n_pad, int n_lanes,
               int n_cols, uint32_t wide_mask,
               const int32_t* __restrict__ res_lo,
               const int32_t* __restrict__ res_hi,
               const int32_t* __restrict__ limits,
               const int64_t* __restrict__ base,
               const int64_t* __restrict__ offsets, int n_blocks, int n_q,
               int q_base, int32_t* __restrict__ out) {
  __shared__ int32_t q_lo[32];
  __shared__ int32_t q_hi[32];
  __shared__ int64_t w_count[kWarps];
  const int b = blockIdx.x;
  const int q = q_base + blockIdx.y;
  const int64_t start = base[(int64_t)b * n_q + q];
  const int64_t end =
      b + 1 < n_blocks ? base[(int64_t)(b + 1) * n_q + q] : offsets[q + 1];
  if (end <= start) return;  // uniform: no match of q in this block

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid < n_lanes) {
    q_lo[tid] = res_lo[(int64_t)q * n_lanes + tid];
    q_hi[tid] = res_hi[(int64_t)q * n_lanes + tid];
  }
  __syncthreads();
  const int64_t lo = limits[2 * (int64_t)q];
  const int64_t hi = limits[2 * (int64_t)q + 1];
  constexpr int kSeg = kBlockRows / kWarps;
  const int64_t seg0 = (int64_t)b * kBlockRows + (int64_t)warp * kSeg;
  const uint32_t lt_mask = (1u << lane) - 1u;

  // pass 1: this warp's match count over its segment
  int64_t cnt = 0;
  for (int it = 0; it < kSeg; it += 32) {
    const int64_t r = seg0 + it + lane;
    const bool p = r < n_pad && r >= lo && r < hi &&
                   residual_ok(keys, n_pad, r, q_lo, q_hi, n_cols, wide_mask);
    cnt += __popc(__ballot_sync(0xffffffffu, p));
  }
  if (lane == 0) w_count[warp] = cnt;
  __syncthreads();
  int64_t pos0 = start;
  for (int w = 0; w < warp; ++w) pos0 += w_count[w];

  // pass 2: write in ascending row order
  for (int it = 0; it < kSeg; it += 32) {
    const int64_t r = seg0 + it + lane;
    const bool p = r < n_pad && r >= lo && r < hi &&
                   residual_ok(keys, n_pad, r, q_lo, q_hi, n_cols, wide_mask);
    const uint32_t mask = __ballot_sync(0xffffffffu, p);
    if (p) {
      const int64_t pos = pos0 + __popc(mask & lt_mask);
      if (pos < end) out[pos] = static_cast<int32_t>(r);
    }
    pos0 += __popc(mask);
  }
}

}  // namespace

// Launches the three passes on `stream`; returns cudaGetLastError().
// keys int32[>=n_lanes, n_pad], res_lo/res_hi int32[n_q, n_lanes] (n_lanes
// <= 32), limits int32[n_q, 2], offsets int64[n_q + 1] (exclusive prefix
// of the match counts), base int64[n_blocks, n_q] scratch, out
// int32[offsets[n_q]].
extern "C" int select_compact_launch(
    const int32_t* keys, int64_t n_pad, int n_lanes, int n_cols,
    uint32_t wide_mask, const int32_t* res_lo, const int32_t* res_hi,
    const int32_t* limits, int n_q, const int64_t* offsets, int n_blocks,
    int64_t* base, int32_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0 || n_blocks <= 0) return 0;
  if (n_lanes < 1 || n_lanes > 32 || n_cols < 1 || n_cols > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t fixed = (size_t)kQueryChunk * (2 * n_lanes + 2 + kWarps) * 4;
  const int tile = pick_tile(fixed, n_lanes);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + (size_t)tile * n_lanes * 4;
  cudaError_t e = cudaFuncSetAttribute(
      select_counts, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_blocks, (n_q + kQueryChunk - 1) / kQueryChunk);
  select_counts<<<grid, kThreads, smem, st>>>(keys, n_pad, n_lanes, n_cols,
                                              wide_mask, res_lo, res_hi, limits,
                                              n_q, tile, base);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  select_scan<<<(n_q + 255) / 256, 256, 0, st>>>(base, offsets, n_blocks, n_q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // grid.y is capped at 65535: launch the scatter in query slices
  for (int q_base = 0; q_base < n_q; q_base += 65535) {
    const int qs = min(65535, n_q - q_base);
    select_scatter<<<dim3(n_blocks, qs), kThreads, 0, st>>>(
        keys, n_pad, n_lanes, n_cols, wide_mask, res_lo, res_hi, limits, base,
        offsets, n_blocks, n_q, q_base, out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
