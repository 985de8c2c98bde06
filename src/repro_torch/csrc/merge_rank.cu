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
// pair. The port's first kernel gave every row one thread that
// binary-searched its key tuple in every other run: at TPC-H SF 5 each of
// the 7.5 M base rows made 8 searches of the small appended runs, ~9e8
// dependent loads for a function whose answer needs the base's keys read
// at most once. The design here rests on one fact: for two runs s and t,
// one search gives both directions. Let idx(f) be where a row f of s
// falls in t: the lower bound of key(f) in t if t is earlier than s, its
// upper bound if t is later. Then f counts idx(f) - start(t) rows of t,
// and a row e of t counts f exactly when e >= idx(f). So:
//   * merge_search: only the smaller run of each pair searches the larger
//     (ties in size go to the higher run index, so each pair is searched
//     once); the largest run, the base, searches nothing. One thread per
//     (row of another run, run it searches), so no thread chains two
//     searches: a branch-free binary search (every key lane of a probe
//     row loaded before the compare), its count added to the row's own
//     partial position (a 64-bit atomic into the zeroed output), and a +1
//     dropped into a difference array over the searched run at idx(f)
//     (int32 atomics, exact; a warp merges equal insertion points first).
//     An insertion point at a run's end counts for no row and is dropped.
//     At SF 5 that is 160,000 rows searching ~4.5 runs each, 720,000
//     searches of 15-24 dependent steps (~13 M probes, the top steps
//     shared by many searches and in cache): not what bounds the kernel,
//     so a plain per-thread binary search, not slab_rank.cu's warp-wide
//     k-ary search, whose 32 probes a round would multiply the probes by
//     eight. (Two rows a thread in lockstep, two probes in flight, took
//     75 registers and was slower: 0.063 ms against 0.046 on an H100.)
//   * merge_scan: one pass over the difference array, a single-pass scan
//     with decoupled look-back (tiles of 4096 rows taken in ticket order,
//     each publishing its sum and then its inclusive prefix), so a row of
//     run t reads the increments dropped at or before it, less those of
//     earlier runs (per-run totals counted by merge_search), and writes
//     pos = local + own partial + that, once, as int64. Loads and stores
//     go through a padded shared-memory transpose, so both are coalesced.
// What bounds it on an H100: bytes. The scan reads the 4-byte difference
// array and writes the 8-byte position of every row, and the array is
// zeroed first: 16 bytes a row, against the searches' few MB.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRuns = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                        // rows a thread scans
constexpr int kTileRows = kThreads * kItems;      // rows a CTA scans
constexpr int kWarpRows = 32 * kItems;            // rows a warp scans
constexpr int kWarpBuf = kWarpRows + kWarpRows / 32;  // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;
// tile status word: flag in the high half, the tile's sum in the low half
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

struct RunStack {
  int64_t start[kMaxRuns + 1];  // start[n_runs] == n_rows
  int n_runs;
  int big;  // the largest run (ties to the higher index): searches nothing
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* s, int64_t i) {
  return *reinterpret_cast<const volatile unsigned long long*>(s + i);
}

__device__ __forceinline__ void store_status(unsigned long long* s, int64_t i, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(s + i) = v;
}

// One thread per (searching row, searched run): CTA (x, t) takes 256 of
// the rows outside the big run against run t. MAXL: key lanes held in
// registers (n_lanes <= MAXL).
template <int MAXL>
__global__ void __launch_bounds__(kThreads)
merge_search(const int32_t* __restrict__ keys, int64_t n_pad, int n_lanes, RunStack rs,
             int64_t n_search, int32_t* __restrict__ diff, int32_t* __restrict__ run_inc,
             unsigned long long* __restrict__ own) {
  __shared__ int64_t start[kMaxRuns + 1];
  __shared__ int32_t inc;
  const int n_runs = rs.n_runs;
  const int t = blockIdx.y;
  for (int i = threadIdx.x; i <= n_runs; i += kThreads) start[i] = rs.start[i];
  if (threadIdx.x == 0) inc = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t lo = start[t];
  const int64_t len = start[t + 1] - lo;
  // the searching rows are every row outside the big run
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n_search;
  const int64_t big_lo = start[rs.big];
  const int64_t e = i < big_lo ? i : i + (start[rs.big + 1] - big_lo);
  int r = 0;
  if (valid) {
    while (r + 1 < n_runs && start[r + 1] <= e) ++r;
  }
  const int64_t my_len = valid ? start[r + 1] - start[r] : 0;
  // run t is searched from row e iff (len_t, t) > (len_r, r)
  const bool searches = valid && len > 0 && (len > my_len || (len == my_len && t > r));
  if (!__syncthreads_or(searches)) return;
  int64_t idx = lo;
  if (searches) {
    int32_t probe[MAXL];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) probe[l] = l < n_lanes ? keys[l * n_pad + e] : 0;
    // below(row): key(row) < probe for an earlier run t (lower bound),
    // key(row) <= probe for a later one (upper bound)
    const bool at_or_below = t > r;
    auto below = [&](int64_t row) -> bool {
      int32_t x[MAXL];
#pragma unroll
      for (int l = 0; l < MAXL; ++l) x[l] = l < n_lanes ? __ldg(keys + l * n_pad + row) : 0;
      bool lt = at_or_below;
#pragma unroll
      for (int l = MAXL - 1; l >= 0; --l) {
        if (l < n_lanes) lt = (x[l] < probe[l]) | ((x[l] == probe[l]) & lt);
      }
      return lt;
    };
    int64_t b = lo;
    int64_t n = len;
    while (n > 1) {
      const int64_t half = n >> 1;
      b = below(b + half) ? b + half : b;
      n -= half;
    }
    idx = b + (below(b) ? 1 : 0);
    if (idx > lo) atomicAdd(own + e, (unsigned long long)(idx - lo));
  }
  const bool drop = searches && idx < lo + len;
  const unsigned m = __ballot_sync(kFull, drop);
  if (drop) {
    const unsigned peers = __match_any_sync(m, (unsigned long long)idx);
    if (lane == __ffs(peers) - 1) atomicAdd(diff + idx, __popc(peers));
  }
  if (lane == 0 && m) atomicAdd(&inc, __popc(m));
  __syncthreads();
  if (threadIdx.x == 0 && inc) atomicAdd(run_inc + t, inc);
}

__global__ void __launch_bounds__(kThreads)
merge_scan(const int32_t* __restrict__ diff, const int32_t* __restrict__ run_inc, RunStack rs,
           int64_t n_rows, int32_t* __restrict__ ticket, unsigned long long* __restrict__ status,
           int64_t* __restrict__ out_pos) {
  __shared__ int64_t start[kMaxRuns + 1];
  __shared__ uint32_t corr[kMaxRuns];  // -start(t) - increments into runs before t
  __shared__ uint32_t buf[kWarps][kWarpBuf];
  __shared__ uint32_t warp_sum[kWarps];
  __shared__ uint32_t tile_excl;
  __shared__ int tile_id;
  const int n_runs = rs.n_runs;
  for (int i = threadIdx.x; i <= n_runs; i += kThreads) start[i] = rs.start[i];
  for (int i = threadIdx.x; i < n_runs; i += kThreads) corr[i] = (uint32_t)run_inc[i];
  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t before = 0;
    for (int t = 0; t < n_runs; ++t) {
      const uint32_t n_inc = corr[t];
      corr[t] = 0u - (uint32_t)start[t] - before;
      before += n_inc;
    }
  }
  const int tile = tile_id;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = (int64_t)tile * kTileRows + (int64_t)w * kWarpRows;
  uint32_t* b = buf[w];
  // coalesced load (row chunk + 32 j + lane), then each lane takes 16
  // consecutive rows (chunk + 16 lane + j); the pad word per 32 keeps
  // both sides free of bank conflicts. The array is padded to whole
  // tiles with zeros.
#pragma unroll
  for (int j = 0; j < kItems; ++j) b[33 * j + lane] = (uint32_t)__ldcs(diff + chunk + 32 * j + lane);
  __syncwarp();
  uint32_t x[kItems];
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = kItems * lane + j;
    x[j] = b[k + (k >> 5)];
    sum += x[j];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  uint32_t warp_excl = 0;
  uint32_t total = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const uint32_t s = warp_sum[v];
    if (v < w) warp_excl += s;
    total += s;
  }
  if (w == 0) {
    // decoupled look-back over the tiles before this one, a window of 32
    // predecessors a step, up to the nearest one with an inclusive prefix
    uint32_t excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, 0, kInclusive | total);
    } else {
      if (lane == 0) store_status(status, tile, kAggregate | total);
      int64_t p = tile - 1;
      while (true) {
        const int64_t q = p - lane;
        unsigned long long s = q >= 0 ? load_status(status, q) : kInclusive;
        while (__any_sync(kFull, (s >> 32) == 0)) {
          if ((s >> 32) == 0) s = load_status(status, q);
        }
        const unsigned inc_mask = __ballot_sync(kFull, (s >> 32) == 2);
        const int stop = inc_mask ? __ffs(inc_mask) - 1 : 31;
        uint32_t v = lane <= stop ? (uint32_t)s : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        excl += v;
        if (inc_mask) break;
        p -= 32;
      }
      if (lane == 0) store_status(status, tile, kInclusive | (uint32_t)(excl + total));
    }
    if (lane == 0) tile_excl = excl;
  }
  __syncthreads();
  // a row's value: row - start(t) + (increments at or before it) -
  // (increments into runs before t), in wrapping 32-bit arithmetic (the
  // true value lies in [0, n_rows))
  uint32_t acc = tile_excl + warp_excl + incl - sum;
  const int64_t row0 = chunk + (int64_t)kItems * lane;
  int r = 0;
  while (r + 1 < n_runs && start[r + 1] <= row0) ++r;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t row = row0 + j;
    while (r + 1 < n_runs && start[r + 1] <= row) ++r;
    acc += x[j];
    const int k = kItems * lane + j;
    b[k + (k >> 5)] = (uint32_t)row + acc + corr[r];
  }
  __syncwarp();
  const int64_t big_lo = start[rs.big];
  const int64_t big_hi = start[rs.big + 1];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t row = chunk + 32 * j + lane;
    if (row < n_rows) {
      int64_t v = (int32_t)b[33 * j + lane];
      if (row < big_lo || row >= big_hi) v += out_pos[row];  // merge_search's partial
      __stcs(reinterpret_cast<long long*>(out_pos + row), (long long)v);
    }
  }
}

template <int MAXL>
cudaError_t launch_search(const int32_t* keys, int64_t n_pad, int n_lanes, const RunStack& rs,
                          int64_t n_search, int32_t* diff, int32_t* run_inc, int64_t* out_pos,
                          cudaStream_t st) {
  const dim3 grid((unsigned)((n_search + kThreads - 1) / kThreads), (unsigned)rs.n_runs);
  merge_search<MAXL><<<grid, kThreads, 0, st>>>(keys, n_pad, n_lanes, rs, n_search, diff, run_inc,
                                                reinterpret_cast<unsigned long long*>(out_pos));
  return cudaGetLastError();
}

int64_t n_tiles(int64_t n_rows) { return (n_rows + kTileRows - 1) / kTileRows; }

// int32 words of scratch for n_rows rows (kernels/merge_runs.py
// _scratch_words computes the same): the difference array (whole tiles),
// the per-run totals, the tile ticket and a pad word, and one 64-bit
// status word per tile.
int64_t scratch_words(int64_t n_rows) {
  return n_tiles(n_rows) * (kTileRows + 2) + kMaxRuns + 2;
}

}  // namespace

// keys int32[>=n_lanes, n_pad] on the device; run_starts int64[n_runs] on
// the host (ascending from 0, each run sorted by its key tuple); scratch
// int32[n_scratch] on the device (at least scratch_words(n_rows)),
// zeroed here; out_pos int64[n_rows]. Returns cudaGetLastError().
extern "C" int merge_rank_launch(const int32_t* keys, int64_t n_pad, int n_lanes,
                                 const int64_t* run_starts, int n_runs, int64_t n_rows,
                                 int32_t* scratch, int64_t n_scratch, int64_t* out_pos,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  if (n_lanes < 1 || n_lanes > 16 || n_runs < 1 || n_runs > kMaxRuns || n_rows > INT32_MAX ||
      n_scratch < scratch_words(n_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RunStack rs;
  rs.n_runs = n_runs;
  rs.big = 0;
  for (int t = 0; t < n_runs; ++t) rs.start[t] = run_starts[t];
  rs.start[n_runs] = n_rows;
  for (int t = 1; t < n_runs; ++t) {
    if (rs.start[t + 1] - rs.start[t] >= rs.start[rs.big + 1] - rs.start[rs.big]) rs.big = t;
  }
  const int64_t tiles = n_tiles(n_rows);
  int32_t* diff = scratch;
  int32_t* run_inc = diff + tiles * kTileRows;
  int32_t* ticket = run_inc + kMaxRuns;
  auto* status = reinterpret_cast<unsigned long long*>(ticket + 2);
  // the searching rows' positions accumulate their own counts in out_pos
  const int64_t big_lo = rs.start[rs.big];
  const int64_t big_hi = rs.start[rs.big + 1];
  cudaError_t e = cudaMemsetAsync(scratch, 0, scratch_words(n_rows) * sizeof(int32_t), st);
  if (e == cudaSuccess && big_lo > 0) e = cudaMemsetAsync(out_pos, 0, big_lo * sizeof(int64_t), st);
  if (e == cudaSuccess && big_hi < n_rows) {
    e = cudaMemsetAsync(out_pos + big_hi, 0, (n_rows - big_hi) * sizeof(int64_t), st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_search = n_rows - (big_hi - big_lo);
  if (n_search > 0) {
    if (n_lanes <= 4) {
      e = launch_search<4>(keys, n_pad, n_lanes, rs, n_search, diff, run_inc, out_pos, st);
    } else if (n_lanes <= 8) {
      e = launch_search<8>(keys, n_pad, n_lanes, rs, n_search, diff, run_inc, out_pos, st);
    } else {
      e = launch_search<16>(keys, n_pad, n_lanes, rs, n_search, diff, run_inc, out_pos, st);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  merge_scan<<<(unsigned)tiles, kThreads, 0, st>>>(diff, run_inc, rs, n_rows, ticket, status,
                                                   out_pos);
  return static_cast<int>(cudaGetLastError());
}
