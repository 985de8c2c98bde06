// Select compaction: per query, the ascending indices of the rows inside
// its [start, stop) window that pass the residual [lo, hi) predicate.
//
// Replaces the TPU kernel repro/kernels/slab_locate.py:select_compact_kernel
// (block-local exclusive prefix sum plus a carried per-query base over a
// sequential grid). Hopper has no sequential grid, so the carry becomes
// three passes. The output is one flat int32 array; offsets[q] ..
// offsets[q + 1] is query q's slice (sized on the host from the fused
// scan's match counts), so one launch serves every width.
//
// What bounds it on an H100. The read path's windows are whole tables, so
// evaluated naively the predicate runs on every (row, select) pair: 7.5 M
// rows x up to 128 selects at TPC-H SF 5, although a routed Q1/Q2 select
// matches a few rows of one slab. The design spends compares only where a
// select can match, which leaves the key lanes, read once, as the bound:
//   1. select_counts: one CTA per (8192-row block, chunk of kQueryChunk
//      queries); each warp owns four 256-row segments of the block. Per
//      segment the warp loads its rows' key lanes (every lane issued
//      before any compare, one segment ahead; a compile-time lane count,
//      1 to 8, keeps them in registers), reduces each logical column's minimum and maximum
//      over the rows inside the chunk's window hull by butterfly (a wide
//      column as one int64, col_value), and tests the chunk's queries
//      against them: a query is live on the segment only if its window
//      meets it and every column's range meets its [res_lo, res_hi). Only
//      live queries evaluate the rows, so a pair that is not live matches
//      nothing and counts 0. A segment is a warp's unit, so on a run stack
//      only the segment that straddles two runs spans every key (the fused
//      scan's run-boundary straggler, refined there by segment, does not
//      arise). kernels/slab_locate.py select_live_pairs is this rule in
//      PyTorch. The per-(query, block) counts are stored query-major.
//   2. select_scan: one warp per query walks its contiguous block counts,
//      32 at a time with kInFlight loads in flight, computes the exclusive
//      scan seeded with offsets[q] by warp shuffles, and appends every
//      (query, block) pair with a match to a list (one atomic per warp
//      step), with its first output slot and count.
//   3. select_scatter: CTAs walk the list; for a pair, each warp evaluates
//      its 1024 rows of the block (loads before compares, as in pass 1),
//      the warps' counts give each its base, and the rows land at base +
//      ballot rank, so indices come out in ascending row order.
// More than 8 key lanes take a generic instance that reads the lanes from
// device memory and evaluates every pair inside the windows: correct, not
// fast.
#include <climits>

#include "predicates.cuh"

using namespace repro;

namespace {

// Key lanes the generic instance takes (32 columns of two lanes).
constexpr int kMaxLanes = 64;
// Rows of one warp's segment in pass 1 (select_live_pairs' default).
constexpr int kSegRows = 256;
constexpr int kSegRowsPerLane = kSegRows / 32;
constexpr int kSegsPerWarp = kBlockRows / kSegRows / kWarps;
// Rows of one warp's share of a block in pass 3.
constexpr int kWarpRows = kBlockRows / kWarps;
// Chunks of 32 counts one scan warp loads at once.
constexpr int kInFlight = 8;
// CTAs that walk the pair list.
constexpr int kScatterCtas = 528;
static_assert(kQueryChunk == 4 * 32, "a warp tests a chunk's queries four to a lane");

struct SelArgs {
  const int32_t* keys;
  int64_t n_pad;
  int n_lanes;
  int n_cols;
  uint32_t wide_mask;
  uint64_t pair_hi;    // bit l: lanes l, l + 1 hold one wide column
  uint64_t col_first;  // bit l: lane l is a column's first lane
  const int32_t* res_lo;
  const int32_t* res_hi;
  const int32_t* limits;
  int n_q;
  int n_blocks;
};

// One entry of the pair list: a (query, block) pair holding `count`
// matches, the first at output slot `start`.
struct Pair {
  int64_t start;
  int32_t q;
  int32_t b;
  int32_t count;
  int32_t pad;
};

// Row r's residual test against one query's column bounds (qlo, qhi: the
// int64 column values of res_lo / res_hi at each column's first lane),
// from the row's lanes in registers.
template <int LANES>
__device__ __forceinline__ bool row_ok(const int32_t (&x)[LANES], const int64_t (&qlo)[LANES],
                                       const int64_t (&qhi)[LANES], const SelArgs& a) {
  bool ok = true;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    if ((a.col_first >> l) & 1u) {
      const int l2 = l + 1 < LANES ? l + 1 : l;
      const int64_t v = col_value(x[l], x[l2], (a.pair_hi >> l) & 1u);
      ok &= (v >= qlo[l]) & (v < qhi[l]);
    }
  }
  return ok;
}

// Loads query q's bounds as column values at each column's first lane.
template <int LANES>
__device__ __forceinline__ void query_cols(const SelArgs& a, int64_t q, int64_t (&qlo)[LANES],
                                           int64_t (&qhi)[LANES]) {
  const int32_t* lo = a.res_lo + q * LANES;
  const int32_t* hi = a.res_hi + q * LANES;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    const int l2 = l + 1 < LANES ? l + 1 : l;
    const bool pair = (a.pair_hi >> l) & 1u;
    qlo[l] = col_value(lo[l], lo[l2], pair);
    qhi[l] = col_value(hi[l], hi[l2], pair);
  }
}

// Pass 1. LANES: the key lane count, unrolled into registers; 0 takes any
// count up to kMaxLanes and skips nothing.
template <int LANES>
__global__ void __launch_bounds__(kThreads)
select_counts(const SelArgs a, int32_t* __restrict__ counts) {
  constexpr int AL = LANES > 0 ? LANES : 1;
  constexpr int R = kSegRowsPerLane;
  __shared__ int64_t q_col[2][AL][kQueryChunk];  // res_lo / res_hi column values
  __shared__ int32_t q_lim[kQueryChunk][2];
  __shared__ int32_t q_cnt[kQueryChunk];
  __shared__ int32_t hull[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int64_t block_row0 = (int64_t)b * kBlockRows;
  const int q0 = blockIdx.y * kQueryChunk;
  const int qn = min(kQueryChunk, a.n_q - q0);

  // segment i's key lanes of this lane's rows (clamped into the tensor),
  // loaded one segment ahead of the one the warp works on: the first is
  // issued before the prologue, each next one before the current one's
  // reduction, so a load's latency overlaps work
  int32_t kbuf[2][R][AL];
  auto load_seg = [&](int32_t (&dst)[R][AL], int i) {
    if constexpr (LANES > 0) {
      const int64_t s0 = block_row0 + (int64_t)(warp * kSegsPerWarp + i) * kSegRows;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int64_t r = min(s0 + k * 32 + lane, a.n_pad - 1);
#pragma unroll
        for (int l = 0; l < LANES; ++l) dst[k][l] = a.keys[l * a.n_pad + r];
      }
    }
  };
  load_seg(kbuf[0], 0);

  if (tid == 0) {
    hull[0] = INT_MAX;
    hull[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < qn) {
    const int lo = a.limits[2 * (int64_t)(q0 + tid)];
    const int hi = a.limits[2 * (int64_t)(q0 + tid) + 1];
    q_lim[tid][0] = lo;
    q_lim[tid][1] = hi;
    q_cnt[tid] = 0;
    if (lo < hi) {
      atomicMin(&hull[0], lo);
      atomicMax(&hull[1], hi);
    }
    if constexpr (LANES > 0) {
      int64_t qlo[AL], qhi[AL];
      query_cols<LANES>(a, q0 + tid, qlo, qhi);
#pragma unroll
      for (int l = 0; l < AL; ++l) {
        q_col[0][l][tid] = qlo[l];
        q_col[1][l][tid] = qhi[l];
      }
    }
  }
  __syncthreads();

  // rows of this block the chunk's windows take: the hull, inside the tensor
  const int64_t h_lo = max(block_row0, (int64_t)hull[0]);
  const int64_t h_hi = min(min(block_row0 + kBlockRows, (int64_t)hull[1]), a.n_pad);

#pragma unroll
  for (int i = 0; i < kSegsPerWarp; ++i) {
    if (i + 1 < kSegsPerWarp) load_seg(kbuf[(i + 1) & 1], i + 1);
    const int64_t s0 = block_row0 + (int64_t)(warp * kSegsPerWarp + i) * kSegRows;
    if (s0 >= h_hi || s0 + kSegRows <= h_lo) continue;  // uniform per warp
    uint32_t valid = 0;  // rows of this lane inside the hull
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t r = s0 + k * 32 + lane;
      valid |= (uint32_t)(r >= h_lo && r < h_hi) << k;
    }
    if constexpr (LANES > 0) {
      const int32_t (&kr)[R][LANES] = kbuf[i & 1];
      // each column's range over the lane's valid rows, then the warp's
      int64_t cmin[LANES], cmax[LANES];
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        cmin[l] = LLONG_MAX;
        cmax[l] = LLONG_MIN;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const bool in = (valid >> k) & 1u;
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const int l2 = l + 1 < LANES ? l + 1 : l;
          const int64_t v = col_value(kr[k][l], kr[k][l2], (a.pair_hi >> l) & 1u);
          cmin[l] = in ? min(cmin[l], v) : cmin[l];
          cmax[l] = in ? max(cmax[l], v) : cmax[l];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          if ((a.col_first >> l) & 1u) {
            cmin[l] = min(cmin[l], (int64_t)__shfl_xor_sync(0xffffffffu, (long long)cmin[l], o));
            cmax[l] = max(cmax[l], (int64_t)__shfl_xor_sync(0xffffffffu, (long long)cmax[l], o));
          }
        }
      }
      // the live queries: four to a lane, one ballot each
      uint32_t live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = j * 32 + lane;
        bool ok = q < qn;
        if (ok) {
          const int lo = q_lim[q][0], hi = q_lim[q][1];
          ok = lo < hi && lo < s0 + kSegRows && hi > s0;
#pragma unroll
          for (int l = 0; l < LANES; ++l) {
            if ((a.col_first >> l) & 1u) ok &= (cmin[l] < q_col[1][l][q]) & (cmax[l] >= q_col[0][l][q]);
          }
        }
        live[j] = __ballot_sync(0xffffffffu, ok);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        for (uint32_t m = live[j]; m; m &= m - 1) {  // uniform
          const int q = j * 32 + __ffs(m) - 1;
          int64_t qlo[LANES], qhi[LANES];
#pragma unroll
          for (int l = 0; l < LANES; ++l) {
            qlo[l] = q_col[0][l][q];
            qhi[l] = q_col[1][l][q];
          }
          const int lo = q_lim[q][0], hi = q_lim[q][1];
          int c = 0;
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const int64_t r = s0 + k * 32 + lane;
            const bool ok = ((valid >> k) & 1u) & (r >= lo) & (r < hi) & row_ok<LANES>(kr[k], qlo, qhi, a);
            c += __popc(__ballot_sync(0xffffffffu, ok));
          }
          if (lane == 0 && c) atomicAdd(&q_cnt[q], c);
        }
      }
    } else {
      // generic: every query whose window meets the segment, lanes read
      // from device memory
      for (int q = 0; q < qn; ++q) {
        const int lo = q_lim[q][0], hi = q_lim[q][1];
        if (!(lo < hi && lo < s0 + kSegRows && hi > s0)) continue;  // uniform
        const int32_t* rlo = a.res_lo + (int64_t)(q0 + q) * a.n_lanes;
        const int32_t* rhi = a.res_hi + (int64_t)(q0 + q) * a.n_lanes;
        int c = 0;
        for (int k = 0; k < R; ++k) {
          const int64_t r = s0 + k * 32 + lane;
          const bool ok = ((valid >> k) & 1u) && r >= lo && r < hi &&
                          residual_ok(a.keys, a.n_pad, r, rlo, rhi, a.n_cols, a.wide_mask);
          c += __popc(__ballot_sync(0xffffffffu, ok));
        }
        if (lane == 0 && c) atomicAdd(&q_cnt[q], c);
      }
    }
  }
  __syncthreads();
  if (tid < qn) counts[(int64_t)(q0 + tid) * a.n_blocks + b] = q_cnt[tid];
}

// Pass 2: one warp per query; counts [n_q, n_blocks] -> the pair list.
__global__ void __launch_bounds__(kThreads)
select_scan(const int32_t* __restrict__ counts, const int64_t* __restrict__ offsets,
            int n_blocks, int n_q, Pair* __restrict__ pairs, int64_t cap,
            int* __restrict__ n_pairs) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n_q) return;  // whole warps
  const int32_t* c = counts + (int64_t)q * n_blocks;
  const uint32_t lt_mask = (1u << lane) - 1u;
  int64_t carry = offsets[q];
  for (int b0 = 0; b0 < n_blocks; b0 += 32 * kInFlight) {
    int v[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int b = b0 + 32 * i + lane;
      v[i] = b < n_blocks ? c[b] : 0;
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      int x = v[i];  // inclusive scan over the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const uint32_t bal = __ballot_sync(0xffffffffu, v[i] > 0);
      if (bal) {
        int base = 0;
        if (lane == 0) base = atomicAdd(n_pairs, __popc(bal));
        base = __shfl_sync(0xffffffffu, base, 0);
        const int64_t at = (int64_t)base + __popc(bal & lt_mask);
        if (v[i] > 0 && at < cap) {
          Pair p;
          p.start = carry + x - v[i];
          p.q = q;
          p.b = b0 + 32 * i + lane;
          p.count = v[i];
          p.pad = 0;
          pairs[at] = p;
        }
      }
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

// Pass 3: the CTAs walk the pair list.
template <int LANES>
__global__ void __launch_bounds__(kThreads)
select_scatter(const SelArgs a, const Pair* __restrict__ pairs, int64_t cap,
               const int* __restrict__ n_pairs, const int64_t* __restrict__ offsets,
               int32_t* __restrict__ out) {
  constexpr int R = kWarpRows / 32;  // rows of one lane
  constexpr int kStep = LANES > 0 && LANES <= 4 ? 16 : 8;  // rows of a lane loaded at once
  __shared__ int32_t w_count[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int64_t np = min((int64_t)*n_pairs, cap);
  for (int64_t p = blockIdx.x; p < np; p += gridDim.x) {
    const Pair pr = pairs[p];
    const int64_t q = pr.q;
    const int64_t lo = a.limits[2 * q];
    const int64_t hi = a.limits[2 * q + 1];
    const int64_t end = min(pr.start + pr.count, offsets[q + 1]);
    const int64_t w0 = (int64_t)pr.b * kBlockRows + (int64_t)warp * kWarpRows;
    uint32_t pm = 0;  // bit k: row w0 + 32 k + lane matches
    if constexpr (LANES > 0) {
      int64_t qlo[LANES], qhi[LANES];
      query_cols<LANES>(a, q, qlo, qhi);
#pragma unroll
      for (int k0 = 0; k0 < R; k0 += kStep) {
        int32_t kr[kStep][LANES];
#pragma unroll
        for (int k = 0; k < kStep; ++k) {
          const int64_t r = min(w0 + (k0 + k) * 32 + lane, a.n_pad - 1);
#pragma unroll
          for (int l = 0; l < LANES; ++l) kr[k][l] = a.keys[l * a.n_pad + r];
        }
#pragma unroll
        for (int k = 0; k < kStep; ++k) {
          const int64_t r = w0 + (k0 + k) * 32 + lane;
          const bool ok = (r < a.n_pad) & (r >= lo) & (r < hi) & row_ok<LANES>(kr[k], qlo, qhi, a);
          pm |= (uint32_t)ok << (k0 + k);
        }
      }
    } else {
      const int32_t* rlo = a.res_lo + q * a.n_lanes;
      const int32_t* rhi = a.res_hi + q * a.n_lanes;
      for (int k = 0; k < R; ++k) {
        const int64_t r = w0 + k * 32 + lane;
        const bool ok = r < a.n_pad && r >= lo && r < hi &&
                        residual_ok(a.keys, a.n_pad, r, rlo, rhi, a.n_cols, a.wide_mask);
        pm |= (uint32_t)ok << k;
      }
    }
    const int cnt = warp_sum(__popc(pm));
    if (lane == 0) w_count[warp] = cnt;
    __syncthreads();
    int64_t pos0 = pr.start;
    for (int w = 0; w < warp; ++w) pos0 += w_count[w];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool ok = (pm >> k) & 1u;
      const uint32_t bal = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int64_t pos = pos0 + __popc(bal & lt_mask);
        if (pos < end) out[pos] = static_cast<int32_t>(w0 + k * 32 + lane);
      }
      pos0 += __popc(bal);
    }
    __syncthreads();  // w_count is read before the next pair's
  }
}

template <int LANES>
cudaError_t launch(const SelArgs& a, const int64_t* offsets, int32_t* counts, Pair* pairs,
                   int64_t cap, int* n_pairs, int32_t* out, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(n_pairs, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  select_counts<LANES><<<dim3(a.n_blocks, (a.n_q + kQueryChunk - 1) / kQueryChunk), kThreads, 0, st>>>(a, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  select_scan<<<(a.n_q + kWarps - 1) / kWarps, kThreads, 0, st>>>(counts, offsets, a.n_blocks, a.n_q,
                                                                   pairs, cap, n_pairs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)max(min(cap, (int64_t)kScatterCtas), (int64_t)1);
  select_scatter<LANES><<<grid, kThreads, 0, st>>>(a, pairs, cap, n_pairs, offsets, out);
  return cudaGetLastError();
}

}  // namespace

// Launches the three passes on `stream`; returns cudaGetLastError().
// keys int32[>=n_lanes, n_pad], res_lo/res_hi int32[n_q, n_lanes], limits
// int32[n_q, 2], offsets int64[n_q + 1] (exclusive prefix of the match
// counts); scratch: counts int32[n_q, n_blocks], `cap` pairs of 24 bytes
// (a pair holds at least one match and is one (query, block) pair: cap =
// min(offsets[n_q], n_q * n_blocks) is enough), n_pairs
// int32[1]; out int32[offsets[n_q]].
extern "C" int select_compact_launch(
    const int32_t* keys, int64_t n_pad, int n_lanes, int n_cols,
    uint32_t wide_mask, const int32_t* res_lo, const int32_t* res_hi,
    const int32_t* limits, int n_q, const int64_t* offsets, int n_blocks,
    int32_t* counts, void* pairs, int64_t cap, int32_t* n_pairs, int32_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0 || n_blocks <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_cols < 1 || n_cols > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint64_t pair_hi = 0, col_first = 0;
  int lane = 0;
  for (int c = 0; c < n_cols; ++c) {
    col_first |= 1ull << lane;
    if ((wide_mask >> c) & 1u) pair_hi |= 1ull << lane;
    lane += ((wide_mask >> c) & 1u) ? 2 : 1;
    if (lane > n_lanes) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lane != n_lanes) return static_cast<int>(cudaErrorInvalidValue);
  const SelArgs a{keys, n_pad, n_lanes, n_cols, wide_mask, pair_hi, col_first,
                  res_lo, res_hi, limits, n_q, n_blocks};
  Pair* pl = static_cast<Pair*>(pairs);
  cudaError_t e;
  switch (n_lanes) {
    case 1: e = launch<1>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 2: e = launch<2>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 3: e = launch<3>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 4: e = launch<4>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 5: e = launch<5>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 6: e = launch<6>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 7: e = launch<7>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    case 8: e = launch<8>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
    default: e = launch<0>(a, offsets, counts, pl, cap, n_pairs, out, st); break;
  }
  return static_cast<int>(e);
}
