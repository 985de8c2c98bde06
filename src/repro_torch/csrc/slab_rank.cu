// Device slab location: a warp-wide k-ary search per query and side.
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
// 256 queries at 7.5 M rows reads a few hundred KB, but each search is a
// chain of dependent probes, each a round trip to device memory. A binary
// search with one thread per side makes ~23 such trips, more where its
// lexicographic compare stops lane by lane on ties. The design here cuts
// the chain instead:
//   * one warp per (query, side); while more than 32 rows are left, its 32
//     lanes probe 32 evenly spaced rows of the interval at once, and the
//     ballot of "below" (a prefix of the lanes on a sorted run) keeps one
//     of the 33 parts between them, at most n / 33 rows; a last round reads
//     the <= 32 rows left and counts them. At 7.5 M rows that is
//     ceil(log33 7.5 M) = 5 dependent rounds (kernels/slab_locate.py
//     kary_rounds), so the latency bound is 5 x the latency of one
//     dependent load: load_chase below measures it (chip_smoke.py's
//     row_slab line, load_latency_ns and latency_bound_ms), from device
//     memory and from L2 (the first rounds probe the same rows for every
//     query of a window, so they can hit L2). On an H100 80GB HBM3 at
//     700 W a dependent load took 350.5 ns from device memory and 171.8 ns
//     from L2, so the bound is 1.75 us (0.86 us from L2); a launch of 256
//     queries at TPC-H SF 5 takes about 3.1 us of device time
//     (chip_smoke.py), against 11-15 us for the binary search it replaced;
//   * each lane loads every key lane of its probe row before any compare
//     (a compile-time lane count, 1 to 8, keeps them in registers; more
//     lanes take a generic instance), and compares branch-free from the
//     last lane up, so a probe is one round trip.
// kernels/slab_locate.py kary_ranks_emulated writes these steps out in
// numpy for the tests.
#include "predicates.cuh"

using namespace repro;

namespace {

constexpr int kProbes = 32;

// LANES: the key lane count, unrolled into registers; 0 takes any count.
template <int LANES>
__global__ void __launch_bounds__(kThreads)
slab_rank(const int32_t* __restrict__ keys, int64_t n_pad, int n_lanes,
          const int32_t* __restrict__ slab_lo, const int32_t* __restrict__ slab_hi,
          const int32_t* __restrict__ limits, int n_q, int32_t* __restrict__ out) {
  const int64_t t = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;  // 2 * query + side
  const int lane = threadIdx.x & 31;
  if (t >= 2 * (int64_t)n_q) return;  // whole warps
  const int64_t q = t >> 1;
  const int side = (int)(t & 1);
  const int NL = LANES > 0 ? LANES : n_lanes;
  const int32_t* b = (side == 0 ? slab_lo : slab_hi) + q * NL;
  constexpr int BL = LANES > 0 ? LANES : 1;
  int32_t bound[BL];
  if constexpr (LANES > 0) {
#pragma unroll
    for (int l = 0; l < LANES; ++l) bound[l] = b[l];
  }
  // side 0: key < bound; side 1: key <= bound (lexicographic)
  auto below = [&](int64_t r) -> bool {
    bool lt = side == 1;
    if constexpr (LANES > 0) {
      int32_t x[LANES];
#pragma unroll
      for (int l = 0; l < LANES; ++l) x[l] = keys[l * n_pad + r];
#pragma unroll
      for (int l = LANES - 1; l >= 0; --l) lt = (x[l] < bound[l]) | ((x[l] == bound[l]) & lt);
    } else {
#pragma unroll 8
      for (int l = NL - 1; l >= 0; --l) {
        const int32_t x = keys[l * n_pad + r];
        lt = (x < b[l]) | ((x == b[l]) & lt);
      }
    }
    return lt;
  };
  // the window, clipped to the lanes as the rank form's row mask clips it
  const int64_t start = max((int64_t)limits[2 * q], (int64_t)0);
  int64_t lo = start;
  int64_t hi = min((int64_t)limits[2 * q + 1], n_pad);
  if (hi < lo) hi = lo;
  // the answer (the first row not below) lies in [lo, hi]
  while (hi - lo > kProbes) {
    const int64_t n = hi - lo;
    const int64_t p = lo + (int64_t)(lane + 1) * n / (kProbes + 1);
    const int j = __popc(__ballot_sync(0xffffffffu, below(p)));
    const int64_t new_lo = j > 0 ? lo + (int64_t)j * n / (kProbes + 1) + 1 : lo;
    const int64_t new_hi = j < kProbes ? lo + (int64_t)(j + 1) * n / (kProbes + 1) : hi;
    lo = new_lo;
    hi = new_hi;
  }
  const int64_t m = hi - lo;
  // the rows left, one a lane; a lane past them reads a row inside (clamped)
  const bool hit = m > 0 && below(lo + min((int64_t)lane, m - 1)) && lane < m;
  const int j = __popc(__ballot_sync(0xffffffffu, hit));
  if (lane == 0) out[t] = (int32_t)(lo + j - start);
}

// The latency yardstick: one thread follows a cycle of indices, one
// dependent load after another, bypassing L1 (the probes of slab_rank
// come from many CTAs, so L1 holds little of them). It resumes where its
// last launch stopped (*at), so repeated launches walk new rows.
__global__ void load_chase(const int32_t* __restrict__ next, int64_t steps, int32_t* at) {
  int32_t j = *at;
  for (int64_t s = 0; s < steps; ++s) j = __ldcg(next + j);
  *at = j;
}

template <int LANES>
cudaError_t launch(const int32_t* keys, int64_t n_pad, int n_lanes, const int32_t* slab_lo,
                   const int32_t* slab_hi, const int32_t* limits, int n_q, int32_t* out,
                   cudaStream_t st) {
  const int64_t warps = 2 * (int64_t)n_q;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  slab_rank<LANES><<<grid, kThreads, 0, st>>>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits,
                                              n_q, out);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (n_lanes) {
    case 1: e = launch<1>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 2: e = launch<2>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 3: e = launch<3>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 4: e = launch<4>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 5: e = launch<5>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 6: e = launch<6>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 7: e = launch<7>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    case 8: e = launch<8>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
    default: e = launch<0>(keys, n_pad, n_lanes, slab_lo, slab_hi, limits, n_q, out, st); break;
  }
  return static_cast<int>(e);
}

// next int32[n]: a cycle of indices; at int32[1]: where the walk stands.
// `steps` dependent loads on one thread. Returns cudaGetLastError().
extern "C" int load_chase_launch(const int32_t* next, int64_t steps, int32_t* at, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  load_chase<<<1, 1, 0, st>>>(next, steps, at);
  return static_cast<int>(cudaGetLastError());
}
