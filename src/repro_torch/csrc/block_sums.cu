// Per-block partial sums of the value tile: the device half of the
// materialized per-slab views (core/storage/views.py).
//
// block_sums replaces the TPU kernel repro/kernels/block_agg.py:
// block_sums_kernel (one float32 partial per 8192-row block and value row,
// carried in one output block across a sequential grid). Here one CTA owns
// one (block, value row) pair and writes its partial; there is nothing to
// carry. boundary_sums replaces the jit'd jnp companion
// repro/kernels/block_agg.py:_boundary_call: per (selector, block) pair,
// the sum of one value row over the block's rows that lie inside any of
// the pair's row windows (one window per resident run; lo >= hi is empty).
//
// The contract: both reduce a block in the fused scan's in-block order
// (predicates.cuh: owned_row, thread_tile_sum, warp_slot_add,
// fold_warp_slots, over tiles of scan_tile(n_lanes, n_vals) rows, for the
// table's key lanes and live value rows). So a stored partial equals the
// fused scan's block partial for a query that takes every live row of the
// block, and a boundary partial equals it for a query whose slab is the
// union of the windows: the view fold on the host then reproduces the
// fused scan's sum bit for bit. Only rows < n_rows count: an older state's
// capacity padding may hold rows a later append wrote in place
// (kernels/ops.py:device_state_append).
//
// What bounds them on an H100: bytes. Each reads every live row of its
// block once (4 bytes a row, coalesced across the CTA) and does one add
// per row, far below the card's operations-per-byte line. A full build at
// TPC-H SF 5 reads 3 value rows x 7.5 M rows (90 MB), ~0.03 ms at
// 3.35 TB/s. The card reaches that rate only with enough bytes in flight
// (Little's law: ~18 KB an SM at ~0.7 us latency), so a thread first
// decides which of its 32 rows of the block it takes, then issues the
// loads of all 32 unconditionally, and only then adds the taken ones in
// the contract's order, tile by tile, without a branch (thread_tile_sum):
// a CTA keeps 32 KB in flight. (Loads predicated on the take bits ran
// slower on an H100.) The rows stay out of shared memory (the order, not
// the staging, is the contract), and one CTA per output covers the card:
// ~2,700 CTAs at SF 5; a boundary launch has one CTA per pair, each
// reading one block (32 KB).
#include "predicates.cuh"

using namespace repro;

namespace {

// Rows a thread owns in one block: owned_row(0 .. kOwned - 1).
constexpr int kOwned = kBlockRows / kThreads;

// One block partial in the contract order: tiles of RPT * kThreads rows
// from block_row0, rows below n_live taken when `in(r)` says so.
template <int RPT, typename In>
__device__ __forceinline__ float block_partial(const float* __restrict__ vrow,
                                               int64_t block_row0, int64_t n_pad,
                                               int64_t n_live, In in, float* slots) {
  uint32_t take = 0;
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int64_t r = block_row0 + owned_row(j);
    if (r < n_live && in(r)) take |= 1u << j;
  }
  // every load unconditional (a row past the tensor reads the thread's
  // first row, or the tensor's last), so all 32 are in flight before the
  // first add
  const int64_t first = block_row0 + owned_row(0);
  const float* mine = vrow + (first < n_pad ? first : n_pad - 1);
  const int64_t room = n_pad - 1 - first;  // the largest offset in the tensor
  float v[kOwned];
#pragma unroll
  for (int j = 0; j < kOwned; ++j) v[j] = __ldg(mine + (j * kThreads <= room ? j * kThreads : 0));
  float slot = 0.f;
#pragma unroll
  for (int t = 0; t < kOwned / RPT; ++t) {
    const uint32_t took = (take >> (t * RPT)) & ((1u << RPT) - 1u);
    warp_slot_add(thread_tile_sum<RPT>(v, take, t * RPT), took != 0, slot);
  }
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = slot;
  __syncthreads();
  return fold_warp_slots(slots);
}

// grid (n_blocks - first_block, n_vals): out[v, b - first_block] is the
// partial of value row v over block b.
template <int RPT>
__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const float* __restrict__ values, int64_t n_pad, int64_t n_live,
                  int first_block, int n_out, float* __restrict__ out) {
  __shared__ float slots[kWarps];
  const int b = first_block + blockIdx.x;
  const int v = blockIdx.y;
  const float s = block_partial<RPT>(
      values + (int64_t)v * n_pad, (int64_t)b * kBlockRows, n_pad, n_live,
      [](int64_t) { return true; }, slots);
  if (threadIdx.x == 0) out[(int64_t)v * n_out + blockIdx.x] = s;
}

// grid (n_pairs): out[p] is the partial of value row sel[p] over block
// blocks[p], taking the rows inside any of the pair's n_win windows.
template <int RPT>
__global__ void __launch_bounds__(kThreads)
boundary_sums_kernel(const float* __restrict__ values, int64_t n_pad, int64_t n_live,
                     const int32_t* __restrict__ sel, const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ win_lo, const int32_t* __restrict__ win_hi,
                     int n_win, float* __restrict__ out) {
  extern __shared__ int32_t win[];  // [2 * n_win]: lo, then hi
  __shared__ float slots[kWarps];
  const int p = blockIdx.x;
  for (int w = threadIdx.x; w < n_win; w += kThreads) {
    win[w] = win_lo[(int64_t)p * n_win + w];
    win[n_win + w] = win_hi[(int64_t)p * n_win + w];
  }
  __syncthreads();
  const float s = block_partial<RPT>(
      values + (int64_t)sel[p] * n_pad, (int64_t)blocks[p] * kBlockRows, n_pad, n_live,
      [&](int64_t r) {
        for (int w = 0; w < n_win; ++w) {
          if (r >= win[w] && r < win[n_win + w]) return true;
        }
        return false;
      },
      slots);
  if (threadIdx.x == 0) out[p] = s;
}

}  // namespace

// Rows of the fused scan's staging tile for a table of n_lanes key lanes
// and n_vals live value rows (0 = no tile fits): the tile the view kernels
// reduce in.
extern "C" int scan_tile_rows(int n_lanes, int n_vals) {
  return scan_tile(n_lanes, n_vals);
}

// values float32[>=n_vals, n_pad]; out float32[n_vals, n_blocks -
// first_block]. n_lanes and n_vals are the table's key lanes and live value
// rows (they set the tile). Returns cudaGetLastError() (0 = ok).
extern "C" int block_sums_launch(const float* values, int64_t n_pad,
                                 int64_t n_rows, int n_vals, int n_lanes,
                                 int first_block, int n_blocks, float* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = n_blocks - first_block;
  if (n_out <= 0) return 0;
  if (n_vals < 1 || n_vals > 65535 || n_lanes < 1 || first_block < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_live = n_rows < n_pad ? n_rows : n_pad;
  const dim3 grid(n_out, n_vals);
  switch (scan_tile(n_lanes, n_vals) / kThreads) {
    case 1: block_sums_kernel<1><<<grid, kThreads, 0, st>>>(values, n_pad, n_live, first_block, n_out, out); break;
    case 2: block_sums_kernel<2><<<grid, kThreads, 0, st>>>(values, n_pad, n_live, first_block, n_out, out); break;
    case 4: block_sums_kernel<4><<<grid, kThreads, 0, st>>>(values, n_pad, n_live, first_block, n_out, out); break;
    case 8: block_sums_kernel<8><<<grid, kThreads, 0, st>>>(values, n_pad, n_live, first_block, n_out, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);  // no tile fits
  }
  return static_cast<int>(cudaGetLastError());
}

// values float32[>=n_vals, n_pad]; sel, blocks int32[n_pairs]; win_lo,
// win_hi int32[n_pairs, n_win]; out float32[n_pairs].
extern "C" int boundary_sums_launch(const float* values, int64_t n_pad,
                                    int64_t n_rows, int n_vals, int n_lanes,
                                    const int32_t* sel, const int32_t* blocks,
                                    const int32_t* win_lo,
                                    const int32_t* win_hi, int n_pairs,
                                    int n_win, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pairs <= 0) return 0;
  if (n_vals < 1 || n_lanes < 1 || n_win < 1 || n_win > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_live = n_rows < n_pad ? n_rows : n_pad;
  const size_t smem = (size_t)2 * n_win * sizeof(int32_t);
  switch (scan_tile(n_lanes, n_vals) / kThreads) {
    case 1: boundary_sums_kernel<1><<<n_pairs, kThreads, smem, st>>>(values, n_pad, n_live, sel, blocks, win_lo, win_hi, n_win, out); break;
    case 2: boundary_sums_kernel<2><<<n_pairs, kThreads, smem, st>>>(values, n_pad, n_live, sel, blocks, win_lo, win_hi, n_win, out); break;
    case 4: boundary_sums_kernel<4><<<n_pairs, kThreads, smem, st>>>(values, n_pad, n_live, sel, blocks, win_lo, win_hi, n_win, out); break;
    case 8: boundary_sums_kernel<8><<<n_pairs, kThreads, smem, st>>>(values, n_pad, n_live, sel, blocks, win_lo, win_hi, n_win, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);  // no tile fits
  }
  return static_cast<int>(cudaGetLastError());
}
