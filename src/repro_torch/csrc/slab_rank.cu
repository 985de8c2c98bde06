// Device slab location: a binary search per query and side.
//
// Replaces the TPU kernel repro/kernels/slab_locate.py:slab_locate_kernel.
// Per query, inside its [start, stop) row window of one sorted run: side 0
// counts the rows whose key tuple lies lexicographically below slab_lo,
// side 1 the rows at or below slab_hi (both keys inclusive). On a sorted
// run these are searchsorted(left) and searchsorted(right) minus start,
// which is what the TPU kernel's rank form (two masked popcounts over every
// row) computes. An empty query comes as slab_hi = -1 lanes (no key lies at
// or below it) or a (0, 0) window and gives (0, 0).
//
// What bounds it on an H100: latency, not bytes or operations. A batch of
// Q queries needs 2 * Q * log2(N) dependent probes of n_lanes int32 each,
// about 90 KB at SF 5 and Q = 256; the TPU kernel's rank form would read
// every key lane once and compare it against every query instead. The
// design is therefore one thread per (query, side), each walking its own
// search straight through device memory (the resident [n_lanes, n_pad]
// lanes at row stride n_pad); the launch is a single wave of threads and
// its time is the chain of probe latencies.
#include "predicates.cuh"

using namespace repro;

namespace {

__global__ void slab_rank(const int32_t* __restrict__ keys, int64_t n_pad,
                          int n_lanes, const int32_t* __restrict__ slab_lo,
                          const int32_t* __restrict__ slab_hi,
                          const int32_t* __restrict__ limits, int n_q,
                          int32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * (int64_t)n_q) return;
  const int64_t q = t >> 1;
  const int side = (int)(t & 1);
  const int32_t* b = (side == 0 ? slab_lo : slab_hi) + q * n_lanes;
  // the window, clipped to the lanes as the rank form's row mask clips it
  const int64_t start = max((int64_t)limits[2 * q], (int64_t)0);
  int64_t lo = start;
  int64_t hi = min((int64_t)limits[2 * q + 1], n_pad);
  if (hi < lo) hi = lo;
  // first window row whose key is not below the side's bound: side 0
  // "below" is key < slab_lo, side 1 it is key <= slab_hi
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const bool below = side == 0 ? !lex_ge(keys, n_pad, mid, b, n_lanes)
                                 : lex_le(keys, n_pad, mid, b, n_lanes);
    if (below) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[t] = (int32_t)(lo - start);
}

}  // namespace

// keys int32[>=n_lanes, n_pad] (one sorted run inside every window),
// slab_lo / slab_hi int32[n_q, n_lanes], limits int32[n_q, 2];
// out int32[n_q, 2]. Returns cudaGetLastError() (0 = ok).
extern "C" int slab_rank_launch(const int32_t* keys, int64_t n_pad,
                                int n_lanes, const int32_t* slab_lo,
                                const int32_t* slab_hi, const int32_t* limits,
                                int n_q, int32_t* out, void* stream) {
  if (n_q <= 0) return 0;
  if (n_lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = 2 * (int64_t)n_q;
  const int per_block = 128;
  slab_rank<<<(unsigned)((threads + per_block - 1) / per_block), per_block, 0,
              static_cast<cudaStream_t>(stream)>>>(keys, n_pad, n_lanes,
                                                   slab_lo, slab_hi, limits,
                                                   n_q, out);
  return static_cast<int>(cudaGetLastError());
}
