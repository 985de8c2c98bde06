// Histogram of col // bin_width for the Cost Evaluator's ECDF refresh.
//
// Replaces the TPU kernel repro/kernels/ecdf_hist.py:ecdf_hist_kernel,
// which accumulates a one-hot compare (n_bins x block) per grid step in
// float32. Here each CTA keeps a private int32 histogram of up to 4096
// bins (16 KB) in shared memory, filled with shared-memory atomics over a
// grid-strided slice of the column, then merged into a global int32
// histogram with one atomic per non-empty bin; a last pass writes the
// float32 counts. Integer counts are exact at any size and the result is
// independent of the order the atomics land in.
//
// What bounds it on an H100: reading the column (4 bytes a row) — a few
// integer operations per row, far below the card's operations-per-byte
// line. Rows with a negative value or a bin >= n_bins count nowhere, as
// in the reference (its -1 padding never matches a bin).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 4096;

__global__ void hist_zero(int32_t* __restrict__ acc, int n_bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_bins) acc[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
hist_count(const int32_t* __restrict__ col, int64_t n, int n_bins,
           int bin_width, int32_t* __restrict__ acc) {
  __shared__ int32_t h[kMaxBins];
  for (int i = threadIdx.x; i < n_bins; i += kThreads) h[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int32_t v = col[i];
    if (v < 0) continue;
    const int32_t b = v / bin_width;
    if (b < n_bins) atomicAdd(&h[b], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += kThreads) {
    if (h[i] != 0) atomicAdd(&acc[i], h[i]);
  }
}

__global__ void hist_to_float(const int32_t* __restrict__ acc,
                              float* __restrict__ out, int n_bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_bins) out[i] = static_cast<float>(acc[i]);
}

}  // namespace

// col int32[n]; acc int32[n_bins] scratch; out float32[n_bins]. Returns
// cudaGetLastError().
extern "C" int ecdf_hist_launch(const int32_t* col, int64_t n, int n_bins,
                                int bin_width, int32_t* acc, float* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bins < 1 || n_bins > kMaxBins || bin_width < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bin_blocks = (n_bins + kThreads - 1) / kThreads;
  hist_zero<<<bin_blocks, kThreads, 0, st>>>(acc, n_bins);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    // enough CTAs to fill the card; each merges its private histogram once
    int64_t blocks = (n + kThreads * 16 - 1) / (kThreads * 16);
    if (blocks > 528) blocks = 528;
    hist_count<<<(unsigned)blocks, kThreads, 0, st>>>(col, n, n_bins, bin_width,
                                                      acc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_to_float<<<bin_blocks, kThreads, 0, st>>>(acc, out, n_bins);
  return static_cast<int>(cudaGetLastError());
}
