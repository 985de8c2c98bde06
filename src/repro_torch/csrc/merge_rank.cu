// Merge ranks: the k-way merge permutation of a resident run stack.
//
// Replaces the TPU kernel repro/kernels/merge_runs.py:merge_rank_kernel.
// For a row e of run r (runs are contiguous in device order and each is
// sorted by its key tuple), its merged position is
//   local(e) + |{rows of earlier runs with key <  key(e)}|
//            + |{rows of later runs   with key <= key(e)}|,
// so a freshly written row lands before equal rows of older runs and rows
// keep their order within a run: the host merge order.
//
// The TPU kernel counts these with two masked popcounts per (probe, row)
// pair, O(N * M) compares: at 7.5 M base rows and 160 k appended rows that
// is ~2.4e12 tuple compares. Here one thread per row binary-searches its
// key tuple in each other run (lower bound for earlier runs, upper bound
// for later ones): O(N * runs * log N), ~9e8 search steps at that size.
// What bounds it on an H100: the dependent loads of the searches. Base
// rows search the small appended runs, which stay in L2; appended rows
// search the base.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 16;
constexpr int kMaxRuns = 64;

// -1 / 0 / 1 as key(row) compares to the probe tuple, lexicographically.
__device__ __forceinline__ int cmp_row(const int32_t* __restrict__ keys,
                                       int64_t n_pad, int64_t row,
                                       const int32_t* probe, int n_lanes) {
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l >= n_lanes) break;
    const int32_t k = keys[l * n_pad + row];
    if (k != probe[l]) return k < probe[l] ? -1 : 1;
  }
  return 0;
}

__global__ void merge_rank(const int32_t* __restrict__ keys, int64_t n_pad,
                           int n_lanes, const int64_t* __restrict__ run_starts,
                           int n_runs, int64_t n_rows,
                           int64_t* __restrict__ out_pos) {
  __shared__ int64_t starts[kMaxRuns + 1];
  for (int i = threadIdx.x; i <= n_runs; i += blockDim.x) starts[i] = run_starts[i];
  __syncthreads();
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_rows) return;

  int32_t probe[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    probe[l] = l < n_lanes ? keys[l * n_pad + e] : 0;
  }
  int r = 0;
  while (r + 1 < n_runs && starts[r + 1] <= e) ++r;

  int64_t pos = e - starts[r];
  for (int rr = 0; rr < n_runs; ++rr) {
    if (rr == r) continue;
    const bool strict = rr < r;  // earlier run: count rows strictly below
    int64_t lo = starts[rr];
    int64_t hi = starts[rr + 1];
    const int64_t a = lo;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      const int c = cmp_row(keys, n_pad, mid, probe, n_lanes);
      if (strict ? c < 0 : c <= 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos += lo - a;
  }
  out_pos[e] = pos;
}

}  // namespace

// keys int32[>=n_lanes, n_pad]; run_starts int64[n_runs + 1] on the device
// (run_starts[n_runs] == n_rows); out_pos int64[n_rows]. Returns
// cudaGetLastError().
extern "C" int merge_rank_launch(const int32_t* keys, int64_t n_pad,
                                 int n_lanes, const int64_t* run_starts,
                                 int n_runs, int64_t n_rows, int64_t* out_pos,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_runs < 1 || n_runs > kMaxRuns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kThreads = 256;
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  merge_rank<<<(unsigned)blocks, kThreads, 0, st>>>(keys, n_pad, n_lanes,
                                                    run_starts, n_runs, n_rows,
                                                    out_pos);
  return static_cast<int>(cudaGetLastError());
}
