// Histograms of col // bin_width for the Cost Evaluator's ECDF refresh:
// every key column of a write batch in one launch.
//
// Replaces the TPU kernel repro/kernels/ecdf_hist.py:ecdf_hist_kernel,
// which accumulates a one-hot compare (n_bins x block) per grid step in
// float32. Rows with a negative value or a bin >= n_bins count nowhere, as
// in the reference (its -1 padding never matches a bin). Counts are int32
// until the last store, so they are exact at any size and do not depend on
// the order the atomics land in.
//
// What bounds it on an H100: latency, not bytes. A write batch of 20,000
// rows is 80 KB a column, 0.02 us at the card's memory rate, while a
// launch costs microseconds. The port's first kernel took three launches
// a column (zero a global histogram, count into it, convert to float32)
// and its caller one launch set, one upload and one readback per column.
// The design here is one launch for all columns, grid (CTAs a column,
// columns), each column with its own bin count and width:
//   * one CTA a column (the wrapper's choice at a write batch's size,
//     kernels/ecdf_hist.py SINGLE_CTA_ROWS): the CTA counts its column
//     into a shared-memory int32 histogram of up to 4096 bins (16 KB) with
//     shared-memory atomics, and writes the float32 counts itself: no zero
//     pass, no global atomics, no conversion pass. Eight 16-byte loads are
//     in flight a thread (a 20,000-row column in one round trip), and the
//     bin comes from a multiply, not a division;
//   * more CTAs a column (larger columns): each counts its slice the same
//     way, adds its non-empty bins to an int32 histogram in scratch with
//     global atomics, fences, and takes a ticket; the column's last CTA
//     converts the sums to float32 and leaves the scratch histogram and
//     the ticket zeroed for the next launch (the wrapper keeps one zeroed
//     scratch per device and stream).
// hist_empty is the yardstick: an empty kernel launched the same way, the
// floor a launch of this shape cannot go under.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBins = 4096;
constexpr int kMaxCols = 64;
constexpr int kDepth = 8;  // 16-byte loads in flight a thread

// v / bin_width for 0 <= v < 2^31 as (v * magic) >> shift, with shift =
// 31 + ceil(log2 bin_width) and magic = ceil(2^shift / bin_width), exact
// for every such v (Granlund and Montgomery, 1994, theorem 4.2): one wide
// multiply where an integer division takes ~20 instructions.
struct ColParams {
  unsigned long long magic[kMaxCols];
  int shift[kMaxCols];
  int n_bins[kMaxCols];
  int out_off[kMaxCols];  // where column c's counts start in out
};

__device__ __forceinline__ void count(int32_t v, int n_bins, unsigned long long magic, int shift,
                                      int32_t* h) {
  if (v >= 0) {
    const int32_t b = (int32_t)(((unsigned long long)v * magic) >> shift);
    if (b < n_bins) atomicAdd(&h[b], 1);
  }
}

__global__ void __launch_bounds__(kThreads)
hist_cols(const int32_t* __restrict__ cols, int64_t n, ColParams p, int32_t* __restrict__ acc,
          int32_t* __restrict__ tickets, float* __restrict__ out) {
  __shared__ int32_t h[kMaxBins];
  __shared__ bool last;
  const int c = blockIdx.y;
  const int nb = p.n_bins[c];
  const unsigned long long mg = p.magic[c];
  const int sh = p.shift[c];
  for (int i = threadIdx.x; i < nb; i += kThreads) h[i] = 0;
  __syncthreads();
  // this CTA's slice of the column, [lo, hi), a multiple of 4 rows long
  const int32_t* col = cols + (int64_t)c * n;
  const int64_t per = ((n + gridDim.x - 1) / gridDim.x + 3) & ~(int64_t)3;
  const int64_t lo = min(n, (int64_t)blockIdx.x * per);
  const int64_t hi = min(n, lo + per);
  // scalar rows up to a 16-byte boundary, then 16-byte loads, then the tail
  const int64_t skew = (int64_t)((16 - ((uintptr_t)(col + lo) & 15)) & 15) / 4;
  const int64_t head = min(hi, lo + skew);
  for (int64_t i = lo + threadIdx.x; i < head; i += kThreads) count(col[i], nb, mg, sh, h);
  const int64_t n4 = (hi - head) / 4;
  const int4* v4 = reinterpret_cast<const int4*>(col + head);
  for (int64_t k = threadIdx.x; k < n4; k += kDepth * kThreads) {
    int4 q[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int64_t j = k + (int64_t)u * kThreads;
      q[u] = j < n4 ? __ldg(v4 + j) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      count(q[u].x, nb, mg, sh, h);
      count(q[u].y, nb, mg, sh, h);
      count(q[u].z, nb, mg, sh, h);
      count(q[u].w, nb, mg, sh, h);
    }
  }
  for (int64_t i = head + 4 * n4 + threadIdx.x; i < hi; i += kThreads) count(col[i], nb, mg, sh, h);
  __syncthreads();
  float* o = out + p.out_off[c];
  if (gridDim.x == 1) {
    for (int i = threadIdx.x; i < nb; i += kThreads) o[i] = static_cast<float>(h[i]);
    return;
  }
  int32_t* a = acc + (int64_t)c * kMaxBins;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    if (h[i] != 0) atomicAdd(&a[i], h[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[c], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < nb; i += kThreads) o[i] = static_cast<float>(atomicExch(&a[i], 0));
  if (threadIdx.x == 0) tickets[c] = 0;
}

__global__ void hist_empty() {}

}  // namespace

// cols int32[n_cols, n] on the device; n_bins / bin_widths int32[n_cols]
// on the host (1 <= n_bins <= 4096, bin_width >= 1); ctas_per_col >= 1;
// scratch int32[64 * 4096 + 64] on the device, zeroed, needed (and left
// zeroed) when ctas_per_col > 1; out float32[sum(n_bins)]. Returns
// cudaGetLastError().
extern "C" int ecdf_hist_launch(const int32_t* cols, int64_t n, int n_cols,
                                const int32_t* n_bins, const int32_t* bin_widths,
                                int ctas_per_col, int32_t* scratch, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n_cols < 1 || n_cols > kMaxCols || ctas_per_col < 1 ||
      (ctas_per_col > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ColParams p;
  int off = 0;
  for (int c = 0; c < n_cols; ++c) {
    if (n_bins[c] < 1 || n_bins[c] > kMaxBins || bin_widths[c] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int l = 0;
    while ((1ll << l) < bin_widths[c]) ++l;
    p.shift[c] = 31 + l;
    p.magic[c] = ((1ull << (31 + l)) + (unsigned long long)bin_widths[c] - 1) / (unsigned long long)bin_widths[c];
    p.n_bins[c] = n_bins[c];
    p.out_off[c] = off;
    off += n_bins[c];
  }
  int32_t* acc = scratch;
  int32_t* tickets = scratch == nullptr ? nullptr : scratch + kMaxCols * kMaxBins;
  hist_cols<<<dim3((unsigned)ctas_per_col, (unsigned)n_cols), kThreads, 0, st>>>(cols, n, p, acc,
                                                                                 tickets, out);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the single-CTA path's grid for n_cols columns.
extern "C" int ecdf_empty_launch(int n_cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hist_empty<<<dim3(1u, (unsigned)n_cols), kThreads, 0, st>>>();
  return static_cast<int>(cudaGetLastError());
}
