// Shared device helpers for the read-path kernels (scan_locate.cu,
// select_compact.cu, block_sums.cu, scan_agg.cu, slab_rank.cu): the
// resident key layout, the residual predicate, a column's value as one
// int64, the warp reduction, and the in-block float order of the sum
// contract with the staging tile that order depends on.
//
// Layout (kernels/ops.py): key lanes are int32 rows of a [K_pad, N_pad]
// row-major tensor, lane l of row r at keys[l * n_pad + r]. A logical key
// column of <= 30 bits occupies one lane; a column of 31-60 bits occupies
// a (v >> 30, v & (2^30 - 1)) lane pair whose lexicographic order is the
// numeric order. Bit c of `wide_mask` says logical column c is a pair.
// All comparisons are signed int32, as in the reference.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// Rows of one row block: the unit of the float-sum order contract (the
// reference's DEVICE_BLOCK_N). A block's partial sum is reduced inside one
// CTA; partials are folded across blocks in ascending block order.
constexpr int kBlockRows = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Queries whose bounds one CTA holds in shared memory.
constexpr int kQueryChunk = 128;
// Dynamic shared memory one CTA may take (the card allows 227 KB).
constexpr size_t kSmemBudget = 200 * 1024;

// Residual predicate: per logical column, value in [lo, hi) (hi
// exclusive), wide columns compared lexicographically over their lane
// pair. Lane l of row i is tk[l * ts + i]: `tk` is either a shared-memory
// tile (ts = tile rows) or the resident tensor itself (ts = n_pad).
template <typename I>
__device__ __forceinline__ bool residual_ok(const int32_t* tk, I ts, I i,
                                            const int32_t* lo, const int32_t* hi,
                                            int n_cols, uint32_t wide_mask) {
  int lane = 0;
  for (int c = 0; c < n_cols; ++c) {
    const int32_t k = tk[lane * ts + i];
    if ((wide_mask >> c) & 1u) {
      const int32_t kl = tk[(lane + 1) * ts + i];
      if (!(k > lo[lane] || (k == lo[lane] && kl >= lo[lane + 1]))) return false;
      if (!(k < hi[lane] || (k == hi[lane] && kl < hi[lane + 1]))) return false;
      lane += 2;
    } else {
      if (k < lo[lane] || k >= hi[lane]) return false;
      lane += 1;
    }
  }
  return true;
}

// A logical column's value at its first lane as one int64 whose order is
// the column's: a wide column (hi, lo) maps to hi * 2^32 + (lo + 2^31), so
// comparing it compares the lane pair lexicographically. The fused scan's
// and the select compaction's range reductions reduce these.
__device__ __forceinline__ int64_t col_value(int32_t hi, int32_t lo, bool pair) {
  return pair ? (int64_t)hi * 4294967296LL + ((int64_t)lo + 2147483648LL) : (int64_t)hi;
}

// Butterfly reduction over a full warp; the shuffle pattern is fixed, so
// the float result does not depend on timing.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of one shared-memory key tile: the largest power of two in
// [kThreads, 2048] whose tile fits the budget next to `fixed` bytes, or 0.
inline int pick_tile(size_t fixed, int words_per_row) {
  for (int tile = 2048; tile >= kThreads; tile >>= 1) {
    if (fixed + (size_t)tile * words_per_row * 4 <= kSmemBudget) return tile;
  }
  return 0;
}

// ---- The sum contract's in-block order ----------------------------------
//
// A block partial (the float32 sum of one value row over the taken rows of
// one 8192-row block) is reduced in this order, and in no other:
//   1. the block is walked in staging tiles of scan_tile() rows, ascending,
//      skipping the tiles that miss the query's row window; on the read
//      path that window is [0, n_rows), the table's live rows;
//   2. per tile, thread t sums the tile rows t, t + kThreads, ... (its
//      owned_row()s) in ascending order, starting from +0.0, adding the
//      value of each row it takes (thread_tile_sum);
//   3. a fixed warp butterfly reduces each warp, and lane 0 adds the warp's
//      tile sum into that warp's slot; slots start at +0.0 (warp_slot_add);
//   4. the kWarps slots fold in warp order into the block partial
//      (fold_warp_slots).
// The fused scan (scan_locate.cu) and the view kernels (block_sums.cu) all
// take this order from the helpers below, so a view-served sum equals the
// fused scan's bit for bit on every schema: the tile, and with it the
// order, depends on the table's key lanes and live value rows.
//
// A kernel may leave out work that adds nothing. A thread sum starts at
// +0.0 and a warp slot at +0.0, and in round-to-nearest x + y is -0.0 only
// when both are -0.0, so no thread sum, butterfly result or slot is ever
// -0.0; adding +0.0 to any of them changes no bit. A warp in which no lane
// took a row of the tile holds +0.0 in every lane, so it may skip its
// butterfly, and a (tile, query) pair in which no row is taken may be
// skipped whole: the stored partials are the same.

// Rows of the staging tile that fixes the order, for a table of `n_lanes`
// key lanes and `n_vals` live value rows: the largest power of two in
// [kThreads, kMaxTileRows] whose tile fits a 200 KB budget beside 128
// queries' bounds, windows, selectors and per-warp partials, as the first
// fused scan laid out its shared memory (0 if even 256 rows do not fit).
// The formula is frozen, written out here on its own: every stored view
// partial was reduced in the order it gives, so no kernel's shared-memory
// layout may move it.
constexpr int kMaxTileRows = 2048;
inline int scan_tile(int n_lanes, int n_vals) {
  const size_t fixed = (size_t)128 * (4 * n_lanes + 27) * 4;
  for (int tile = kMaxTileRows; tile >= 256; tile >>= 1) {
    if (fixed + (size_t)tile * (n_lanes + n_vals) * 4 <= (size_t)200 * 1024) return tile;
  }
  return 0;
}

// Rows a thread owns in the largest tile.
constexpr int kMaxRowsPerThread = kMaxTileRows / kThreads;

// Step 2's row ownership: the k-th row thread threadIdx.x owns, counted
// from the start of a tile (or of a block: a block's tiles are contiguous,
// so thread t's rows of a block are t + kThreads * k, tile by tile).
__device__ __forceinline__ int owned_row(int k) { return threadIdx.x + k * kThreads; }

// Step 2 for one tile: the thread's sum over its rows first .. first + N - 1
// of `v`, ascending from +0.0, adding v[k] where bit k of `take` is set.
// A row not taken adds +0.0, which changes no bit (see above); the adds
// carry no branch, so a caller's loads of v are all issued before the
// first add and none is sunk behind a take test.
template <int N, int M>
__device__ __forceinline__ float thread_tile_sum(const float (&v)[M], uint32_t take, int first) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += ((take >> (first + k)) & 1u) ? v[first + k] : 0.f;
  return s;
}

// Step 3 for one tile: the warp's butterfly of the thread sums `s`, added
// by lane 0 into `slot` (the warp's slot). `took` says whether this lane
// took a row of the tile; a warp in which none did skips the butterfly.
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_slot_add(float s, bool took, float& slot) {
  if (__any_sync(0xffffffffu, took)) {
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0) slot += s;
  }
}

// Step 4: the block partial from the kWarps slots, folded in warp order.
__device__ __forceinline__ float fold_warp_slots(const float* warp_slots) {
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += warp_slots[w];
  return s;
}

}  // namespace repro
