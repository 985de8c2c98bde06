// Scans over located row slabs, with rows outer or queries outer.
//
// Replaces the TPU kernels repro/kernels/scan_agg.py:scan_agg_rowstream_kernel
// (rows outer; also the Q = 1 scan_agg_pallas) and
// repro/kernels/scan_agg.py:scan_agg_qgrid_kernel (queries outer). Per
// query, over the rows of its [slab_lo, slab_hi) slab: the float32 sum of
// the selected value row over the rows passing the residual predicate
// (per logical column, value in [lo, hi); wide columns as lexicographic
// lane pairs), and the count of those rows. A selector outside
// [0, n_vals) sums nothing but still counts, as in the reference.
//
// Both cut the rows into 2048-row units (a rowstream tile, a qgrid block),
// and in both thread t of a CTA owns the eight rows 4t .. 4t + 3 and
// 1024 + 4t .. 1024 + 4t + 3 of a unit (row_off), which it reads as two
// 16-byte groups a key lane.
//
// Rows outer (rowstream_partials). One CTA per tile. What bounds it on an
// H100 is the compares: at TPC-H SF 5 a batch of 256 holds 128 queries
// whose slab is the whole 7.5 M-row table on the custkey-led replicas,
// ~9.6e8 (query, row) pairs a launch, against ~1.4e8 key bytes. So:
//   * the CTA first lists, in shared memory, the queries of a chunk whose
//     slab meets its tile (a ballot and a prefix count over the warps),
//     with their bounds; a tile no slab meets is left before a key is read
//     (in a launch of up to 32 queries each warp finds that alone);
//   * each thread loads its eight rows' key lanes once into registers;
//   * per live query every thread reads the bounds from the list (16-byte
//     shared-memory loads, the same address across the warp) and compares
//     its rows branch-free: each lane k >= lo & k < hi (a compile-time lane
//     count, 1 to 8, unrolls them; a wide pair takes the lexicographic
//     form), the slab edge as two compares on the row, left out where the
//     slab covers the tile. The taken rows go to a bit mask; the count is
//     its population count, summed over the warp in one reduction; a value
//     is loaded only for a taken row of a query that sums one (a count
//     query's selector is the ones row, whose partial is its count).
// A generic instantiation takes more lanes, reading them from device
// memory per query.
//
// Queries outer (qgrid_*). The baseline: each query reads its own rows and
// no query shares another's reads, so key traffic grows with the queries
// (sum over queries of slab rows x (lanes + 1) x 4 bytes); it visits only
// the blocks its slab meets. qgrid_offsets turns the slabs into per-query
// block counts and their exclusive scan on the device. Persistent CTAs
// walk the (query, block) pairs query-major, mapping a pair to its query
// by probing the scan 32 entries a step, so the host never waits for the
// total. A CTA issues all of a block's 16-byte loads (key lanes and the
// value row; only the groups that meet the slab) before any compare, and
// masks the slab edges by row. Narrow columns and one value row only, as
// the TPU kernel.
//
// Float order: a (query, unit) partial is each thread's taken rows in
// ascending order from +0.0, then a fixed warp butterfly, then the warp
// slots in warp order; slab_fold folds each query's partials of the units
// its slab meets ([n_q, n_units], query-major, so they lie contiguous):
// lane j of a warp adds the partials j, j + 32, ... of that range in
// ascending order from +0.0, then a fixed warp butterfly adds the lanes.
// No float atomics, so results are identical run to run. Counts are int32,
// exact; the output count lane is float32, exact to 2**24 like the
// reference's.
#include "predicates.cuh"

using namespace repro;

namespace {

// Rows of one rowstream tile and one qgrid block.
constexpr int kUnitRows = 2048;
constexpr int kRowsPerThread = kUnitRows / kThreads;  // 8: two groups of four
constexpr int kHalf = kUnitRows / 2;
// Key lanes of the generic instantiations (32 columns of two lanes).
constexpr int kMaxLanes = 64;
// Queries a rowstream CTA tests for its tile at a time, one per thread.
constexpr int kChunk = kThreads;
// Partials folded per warp load round in slab_fold.
constexpr int kInFlight = 32;
static_assert(kRowsPerThread == 8, "row_off assumes two groups of four rows");

// Offset from the unit's first row of the k-th row (ascending) a thread owns.
__device__ __forceinline__ int row_off(int k) {
  return (k >> 2) * kHalf + 4 * threadIdx.x + (k & 3);
}

// Four consecutive int32 (or float) from `p` at row r: one 16-byte load
// where the caller has proved alignment, else element by element; rows at
// or past `end` read as 0.
__device__ __forceinline__ int4 load4(const int32_t* p, int64_t r, int64_t end, bool vec16) {
  if (vec16 && r + 4 <= end) return __ldg(reinterpret_cast<const int4*>(p + r));
  int4 v;
  v.x = r < end ? __ldg(p + r) : 0;
  v.y = r + 1 < end ? __ldg(p + r + 1) : 0;
  v.z = r + 2 < end ? __ldg(p + r + 2) : 0;
  v.w = r + 3 < end ? __ldg(p + r + 3) : 0;
  return v;
}

__device__ __forceinline__ int32_t comp(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Count over the warp (one reduction instruction on sm_80 and later).
__device__ __forceinline__ int warp_count(int v) { return __reduce_add_sync(0xffffffffu, v); }

// ---- rows outer -------------------------------------------------------------

struct RowArgs {
  const int32_t* keys;
  int64_t n_pad;
  int64_t n;
  int n_lanes;
  uint64_t pair_hi;    // bit l: lanes l, l + 1 hold one wide column
  uint64_t col_first;  // bit l: lane l is a column's first lane
  int vec16;           // key lanes 16-byte aligned
  const float* values;
  int n_vals;
  int ones_row;  // a value row of ones (its sums are counts), or -1
  const int32_t* col_lo;
  const int32_t* col_hi;
  const int32_t* slabs;
  const int32_t* sel;
  int n_q;
  int n_units;
  float* part_s;  // [n_q, n_units]
  int32_t* part_c;
};

// Record value of a query whose value row is the ones row: its partial sum
// is its count, and no value is read.
constexpr int kOnesRow = -2;

// One live query's record in shared memory: query, slab [s0, s1) relative
// to the tile and clipped to it, value row (-1: none; kOnesRow), then for a
// compile-time lane count its lo and hi bounds; padded to 16 bytes.
template <int LANES>
struct Rec {
  static constexpr int kInts = LANES > 0 ? (4 + 2 * LANES + 3) / 4 * 4 : 4;
};

// Whether the residual box takes a row whose lanes are x: narrow lanes as
// lo <= x < hi; with WIDE, the lanes from last to first, a pair's first
// lane (pair_hi) compared lexicographically with the second.
template <int AL, bool WIDE>
__device__ __forceinline__ bool box_ok(const int32_t (&x)[AL], const int32_t (&lo)[AL],
                                       const int32_t (&hi)[AL], int nl, uint64_t pair_hi,
                                       uint64_t col_first) {
  bool ok = true;
  if constexpr (!WIDE) {
#pragma unroll
    for (int l = 0; l < AL; ++l) {
      if (l < nl) ok &= (x[l] >= lo[l]) & (x[l] < hi[l]);
    }
  } else {
    bool rge = true, rlt = true;
#pragma unroll
    for (int l = AL - 1; l >= 0; --l) {
      if (l < nl) {
        const bool cont = (pair_hi >> l) & 1u;
        rge = (x[l] > lo[l]) | ((x[l] == lo[l]) & (!cont | rge));
        rlt = (x[l] < hi[l]) | ((x[l] == hi[l]) & cont & rlt);
        ok &= (rge & rlt) | !((col_first >> l) & 1u);
      }
    }
  }
  return ok;
}

// LANES: the key lane count, held in registers (1 to 8); 0 takes any count
// up to kMaxLanes, reading rows and bounds from device memory per query.
// Up to three lanes the registers are capped so that three CTAs share an
// SM (80 a thread, no spills; at four lanes the cap spilled).
template <int LANES, bool WIDE>
__global__ void __launch_bounds__(kThreads, LANES >= 1 && LANES <= 3 ? 3 : 1)
rowstream_partials(const RowArgs a) {
  constexpr int KL = LANES > 0 ? LANES : 1;
  constexpr int REC = Rec<LANES>::kInts;
  constexpr int R = kRowsPerThread;
  __shared__ __align__(16) int32_t rec[kChunk * REC];
  __shared__ float slot_s[kWarps * kChunk];
  __shared__ int32_t slot_c[kWarps * kChunk];
  __shared__ int32_t warp_live[2][kWarps];

  const int L = LANES > 0 ? LANES : a.n_lanes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int64_t row0 = (int64_t)tile * kUnitRows;
  const int64_t row1 = min(row0 + kUnitRows, a.n);

  // With a warp's worth of queries or fewer (a Q = 1 launch), each warp
  // finds a tile no slab meets alone and leaves: no barrier, no shared
  // memory. More queries take the chunk test below, a load a thread.
  if (a.n_q <= 32) {
    bool hit = false;
    if (lane < a.n_q) {
      hit = max((int64_t)a.slabs[2 * lane], row0) < min((int64_t)a.slabs[2 * lane + 1], row1);
    }
    if (!__any_sync(0xffffffffu, hit)) return;  // the same in every warp
  }

  int32_t kr[R][KL];  // this thread's rows, lane by lane
  bool loaded = false;
  int parity = 0;
  for (int c0 = 0; c0 < a.n_q; c0 += kChunk, parity ^= 1) {
    // the queries of this chunk whose slab meets the tile
    const int q = c0 + tid;
    int s0 = 0, s1 = 0;
    if (q < a.n_q) {
      s0 = (int)(max((int64_t)a.slabs[2 * (int64_t)q], row0) - row0);
      s1 = (int)(min((int64_t)a.slabs[2 * (int64_t)q + 1], row1) - row0);
    }
    const bool live = s0 < s1;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[parity][warp] = __popc(bal);
    // the previous chunk's list and slots are consumed (the warp_live
    // buffer alternates, so this chunk's counts do not race its readers)
    __syncthreads();
    int n_live = 0, pos = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_live[parity][w];
      pos += w < warp ? c : 0;
      n_live += c;
    }
    if (n_live == 0) continue;  // uniform
    if (!loaded) {  // uniform: the first chunk with a live query
      loaded = true;
      if constexpr (LANES > 0) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const int32_t* p = a.keys + l * a.n_pad + row0;
          const int64_t end = a.n_pad - row0;
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int4 v = load4(p, g * kHalf + 4 * tid, end, a.vec16);
            kr[4 * g][l] = v.x;
            kr[4 * g + 1][l] = v.y;
            kr[4 * g + 2][l] = v.z;
            kr[4 * g + 3][l] = v.w;
          }
        }
      }
    }
    if (live) {
      int32_t* r = rec + (pos + __popc(bal & ((1u << lane) - 1u))) * REC;
      const int sv = a.sel[q];
      r[0] = q;
      r[1] = s0;
      r[2] = s1;
      r[3] = (sv >= 0 && sv < a.n_vals) ? (sv == a.ones_row ? kOnesRow : sv) : -1;
      if constexpr (LANES > 0) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          r[4 + l] = a.col_lo[(int64_t)q * LANES + l];
          r[4 + LANES + l] = a.col_hi[(int64_t)q * LANES + l];
        }
      }
    }
    __syncthreads();

    for (int j = 0; j < n_live; ++j) {  // uniform
      // the record in 16-byte loads, the same address across the warp
      int32_t w[REC];
#pragma unroll
      for (int i = 0; i < REC; i += 4) {
        const int4 v = *reinterpret_cast<const int4*>(rec + j * REC + i);
        w[i] = v.x;
        w[i + 1] = v.y;
        w[i + 2] = v.z;
        w[i + 3] = v.w;
      }
      const int4 head = make_int4(w[0], w[1], w[2], w[3]);
      constexpr int AL = LANES > 0 ? LANES : kMaxLanes;
      int32_t lo[AL], hi[AL];
      if constexpr (LANES > 0) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          lo[l] = w[4 + l];
          hi[l] = w[4 + LANES + l];
        }
      } else {
        for (int l = 0; l < L; ++l) {
          lo[l] = __ldg(a.col_lo + (int64_t)head.x * L + l);
          hi[l] = __ldg(a.col_hi + (int64_t)head.x * L + l);
        }
      }
      // the taken rows of this thread, bit k for its k-th row
      uint32_t take = 0;
      auto eval = [&](bool edge) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          int32_t x[AL];
          if constexpr (LANES > 0) {
#pragma unroll
            for (int l = 0; l < LANES; ++l) x[l] = kr[k][l];
          } else {
            const int64_t rr = row0 + row_off(k);
            for (int l = 0; l < L; ++l) x[l] = rr < a.n_pad ? __ldg(a.keys + l * a.n_pad + rr) : 0;
          }
          bool ok = box_ok<AL, WIDE>(x, lo, hi, L, a.pair_hi, a.col_first);
          if (edge) ok &= (row_off(k) >= head.y) & (row_off(k) < head.z);
          take |= (uint32_t)ok << k;
        }
      };
      if (head.y == 0 && head.z == kUnitRows) {
        eval(false);  // the slab covers the tile
      } else {
        eval(true);
      }
      const int c = warp_count(__popc(take));
      // a sum of ones is exact in float32 in any order: the count
      float s = head.w == kOnesRow ? (float)c : 0.f;
      if (head.w >= 0 && __any_sync(0xffffffffu, take != 0u)) {  // uniform
        const float* vrow = a.values + (int64_t)head.w * a.n_pad + row0;
        float v[R];
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = ((take >> k) & 1u) ? __ldg(vrow + row_off(k)) : 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) s += ((take >> k) & 1u) ? v[k] : 0.f;
        s = warp_sum(s);
      }
      if (lane == 0) {
        slot_s[warp * kChunk + j] = s;
        slot_c[warp * kChunk + j] = c;
      }
    }
    __syncthreads();
    for (int j = tid; j < n_live; j += kThreads) {
      float s = 0.f;
      int c = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += slot_s[w * kChunk + j];
        c += slot_c[w * kChunk + j];
      }
      const int64_t o = (int64_t)rec[j * REC] * a.n_units + tile;
      a.part_s[o] = s;
      a.part_c[o] = c;
    }
  }
}

// ---- the fold of both scans -------------------------------------------------

// Per query (one warp), its partials of the units its slab meets, which lie
// contiguous in [n_q, n_units]: the lanes load 32 partials side by side,
// kInFlight rounds at a time, each lane adds its own in ascending order, and
// the butterfly adds the lanes. A whole-table query at TPC-H SF 5 folds
// 3,662 partials; added one after another they were a chain of dependent
// adds that set a Q = 1 launch's time.
__global__ void __launch_bounds__(kThreads)
slab_fold(const float* __restrict__ part_s, const int32_t* __restrict__ part_c,
          const int32_t* __restrict__ slabs, int64_t n, int n_units, int n_q,
          float* __restrict__ out) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n_q) return;  // whole warps
  const int64_t s0 = max((int64_t)slabs[2 * (int64_t)q], (int64_t)0);
  const int64_t s1 = min((int64_t)slabs[2 * (int64_t)q + 1], n);
  const int b0 = s0 < s1 ? (int)(s0 / kUnitRows) : 0;
  const int b1 = s0 < s1 ? (int)((s1 - 1) / kUnitRows) + 1 : 0;
  const int64_t base = (int64_t)q * n_units;
  float s = 0.f;
  int c = 0;
  for (int c0 = b0; c0 < b1; c0 += 32 * kInFlight) {
    float p[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int b = c0 + 32 * i + lane;
      const bool in = b < b1;
      p[i] = in ? part_s[base + b] : 0.f;
      c += in ? part_c[base + b] : 0;
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) s += p[i];  // + 0.0 past the range changes no bit
  }
  s = warp_sum(s);
  c = warp_count(c);
  if (lane == 0) {
    out[2 * (int64_t)q] = s;
    out[2 * (int64_t)q + 1] = (float)c;
  }
}

// ---- queries outer ----------------------------------------------------------

constexpr int kScanThreads = 1024;

// Per query the number of blocks its slab meets, and their exclusive scan:
// offs[q] is query q's first pair, offs[n_q] the total. One CTA.
__global__ void __launch_bounds__(kScanThreads)
qgrid_offsets(const int32_t* __restrict__ slabs, int64_t n, int n_q, int32_t* __restrict__ offs) {
  __shared__ int32_t warp_tot[kScanThreads / 32];
  __shared__ int32_t carry;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) carry = 0;
  for (int c0 = 0; c0 < n_q; c0 += kScanThreads) {
    const int q = c0 + tid;
    int cnt = 0;
    if (q < n_q) {
      const int64_t s0 = max((int64_t)slabs[2 * (int64_t)q], (int64_t)0);
      const int64_t s1 = min((int64_t)slabs[2 * (int64_t)q + 1], n);
      cnt = s0 < s1 ? (int)((s1 - 1) / kUnitRows - s0 / kUnitRows) + 1 : 0;
    }
    int x = cnt;  // inclusive scan over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();  // also: the previous chunk's carry is written
    if (warp == 0) {
      int t = warp_tot[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += y;
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    const int incl = carry + (warp > 0 ? warp_tot[warp - 1] : 0) + x;
    if (q < n_q) offs[q] = incl - cnt;
    __syncthreads();  // every thread has read carry and warp_tot
    if (tid == kScanThreads - 1) carry = incl;
  }
  __syncthreads();
  if (tid == 0) offs[n_q] = carry;
}

struct GridArgs {
  const int32_t* keys;
  int64_t n_pad;
  int64_t n;
  int n_lanes;
  int vec16;  // key lanes and the value row 16-byte aligned
  const float* vals;
  const int32_t* col_lo;
  const int32_t* col_hi;
  const int32_t* slabs;
  const int32_t* offs;  // [n_q + 1], from qgrid_offsets
  int n_q;
  int n_units;
  float* part_s;  // [n_q, n_units]
  int32_t* part_c;
};

// LANES: the key lane count, unrolled (1 to 8); 0 takes any count up to
// kMaxLanes, a lane at a time.
template <int LANES>
__global__ void __launch_bounds__(kThreads) qgrid_partials(const GridArgs a) {
  __shared__ float slot_s[2][kWarps];
  __shared__ int32_t slot_c[2][kWarps];
  constexpr int KL = LANES > 0 ? LANES : 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int L = LANES > 0 ? LANES : a.n_lanes;
  const int total = __ldg(a.offs + a.n_q);
  int q = 0;  // the current pair's query: a CTA's pairs ascend, so q only grows
  int buf = 0;
  for (int p = blockIdx.x; p < total; p += gridDim.x, buf ^= 1) {
    // q = the last query whose first pair is <= p: the offsets past p form
    // a suffix, so a warp counts the probed ones at or below p
    for (;;) {
      const int i = q + 1 + lane;
      const bool past = i <= a.n_q && __ldg(a.offs + i) <= p;
      const unsigned bal = __ballot_sync(0xffffffffu, past);
      q += __popc(bal);
      if (bal != 0xffffffffu) break;
    }
    const int64_t s0 = max((int64_t)__ldg(a.slabs + 2 * (int64_t)q), (int64_t)0);
    const int64_t s1 = min((int64_t)__ldg(a.slabs + 2 * (int64_t)q + 1), a.n);
    const int64_t b = s0 / kUnitRows + (p - __ldg(a.offs + q));
    const int64_t row0 = b * kUnitRows;
    // every load of the block before any compare: the groups of four rows
    // that meet the slab, each key lane and the value row
    int4 kv[2][KL];
    int4 vv[2];
    bool meet[2];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int64_t r = row0 + g * kHalf + 4 * tid;
      meet[g] = r < s1 && r + 4 > s0;
      vv[g] = meet[g] ? load4(reinterpret_cast<const int32_t*>(a.vals), r, a.n_pad, a.vec16)
                      : make_int4(0, 0, 0, 0);
      if constexpr (LANES > 0) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          kv[g][l] = meet[g] ? load4(a.keys + l * a.n_pad, r, a.n_pad, a.vec16) : make_int4(0, 0, 0, 0);
        }
      }
    }
    uint32_t take = 0;  // bit k: the k-th row (row_off) in the slab
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t r = row0 + row_off(k);
      take |= (uint32_t)((r >= s0) & (r < s1)) << k;
    }
    if constexpr (LANES > 0) {
      int32_t lo[KL], hi[KL];
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        lo[l] = __ldg(a.col_lo + (int64_t)q * LANES + l);
        hi[l] = __ldg(a.col_hi + (int64_t)q * LANES + l);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        bool ok = true;
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const int32_t x = comp(kv[k >> 2][l], k & 3);
          ok &= (x >= lo[l]) & (x < hi[l]);
        }
        take &= ~((uint32_t)!ok << k);
      }
    } else {
      for (int l = 0; l < L; ++l) {
        const int32_t lo = __ldg(a.col_lo + (int64_t)q * L + l);
        const int32_t hi = __ldg(a.col_hi + (int64_t)q * L + l);
        int4 v[2];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          v[g] = meet[g] ? load4(a.keys + l * a.n_pad, row0 + g * kHalf + 4 * tid, a.n_pad, a.vec16)
                         : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const int32_t x = comp(v[k >> 2], k & 3);
          take &= ~((uint32_t)!((x >= lo) & (x < hi)) << k);
        }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      s += ((take >> k) & 1u) ? __int_as_float(comp(vv[k >> 2], k & 3)) : 0.f;
    }
    s = warp_sum(s);
    const int c = warp_count(__popc(take));
    if (lane == 0) {
      slot_s[buf][warp] = s;
      slot_c[buf][warp] = c;
    }
    // the slots of this pair are written; the other buffer's were read a
    // pair ago, before this barrier's predecessor
    __syncthreads();
    if (tid == 0) {
      float bs = 0.f;
      int bc = 0;
      for (int w = 0; w < kWarps; ++w) {
        bs += slot_s[buf][w];
        bc += slot_c[buf][w];
      }
      const int64_t o = (int64_t)q * a.n_units + b;
      a.part_s[o] = bs;
      a.part_c[o] = bc;
    }
  }
}

// CTAs of `Kernel` that fit the card at once, counted on the first call.
template <auto Kernel>
int resident_ctas() {
  static const int ctas = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  return ctas;
}

template <auto Kernel, typename Args>
cudaError_t launch_grid(int64_t ctas, const Args& a, cudaStream_t st) {
  auto k = Kernel;
  k<<<(unsigned)ctas, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// Launches a kernel whose CTAs stride over `work` items: as many CTAs as
// fit the card at once, and no more than the items.
template <auto Kernel, typename Args>
cudaError_t launch_resident(int64_t work, const Args& a, cudaStream_t st) {
  const int ctas = resident_ctas<Kernel>();
  if (ctas <= 0) return cudaErrorInvalidValue;
  return launch_grid<Kernel>(min((int64_t)ctas, work), a, st);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// keys int32[>=n_lanes, n_pad], values float32[>=n_vals, n_pad] (row
// ones_row, if in [0, n_vals), holds 1.0 at every row a slab covers), rows [0, n)
// scanned; col_lo / col_hi int32[n_q, n_lanes], slabs int32[n_q, 2], sel
// int32[n_q]; part_* [n_q, n_units] scratch with n_units = ceil(n / 2048);
// out float32[n_q, 2]. Returns cudaGetLastError() (0 = ok).
extern "C" int rowstream_launch(const int32_t* keys, int64_t n_pad, int64_t n,
                                int n_lanes, int n_cols, uint32_t wide_mask,
                                const float* values, int n_vals, int ones_row,
                                const int32_t* col_lo, const int32_t* col_hi,
                                const int32_t* slabs, const int32_t* sel,
                                int n_q, int n_units, float* part_s, int32_t* part_c,
                                float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_cols < 1 || n_cols > 32 || n_vals < 1 ||
      n < 0 || n > n_pad || n_units != (int)((n + kUnitRows - 1) / kUnitRows)) {
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
  RowArgs a{keys, n_pad, n, n_lanes, pair_hi, col_first,
            aligned16(keys) && n_pad % 4 == 0, values, n_vals,
            ones_row >= 0 && ones_row < n_vals ? ones_row : -1, col_lo, col_hi,
            slabs, sel, n_q, n_units, part_s, part_c};
  if (n_units > 0) {
    const bool wide = pair_hi != 0;
    cudaError_t e;
#define ROWSTREAM_CASE(L)                                                          \
  case L:                                                                          \
    e = wide ? launch_grid<rowstream_partials<L, true>>(n_units, a, st)            \
             : launch_grid<rowstream_partials<L, false>>(n_units, a, st);          \
    break;
    switch (n_lanes) {
      case 1: e = launch_grid<rowstream_partials<1, false>>(n_units, a, st); break;
      ROWSTREAM_CASE(2)
      ROWSTREAM_CASE(3)
      ROWSTREAM_CASE(4)
      ROWSTREAM_CASE(5)
      ROWSTREAM_CASE(6)
      ROWSTREAM_CASE(7)
      ROWSTREAM_CASE(8)
      default: e = launch_grid<rowstream_partials<0, true>>(n_units, a, st); break;
    }
#undef ROWSTREAM_CASE
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  slab_fold<<<(unsigned)((n_q + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      part_s, part_c, slabs, n, n_units, n_q, out);
  return static_cast<int>(cudaGetLastError());
}

// keys int32[>=n_lanes, n_pad] (narrow lanes), vals float32[n_pad] (one
// value row), rows [0, n) scanned; col_lo / col_hi int32[n_q, n_lanes],
// slabs int32[n_q, 2]; offs int32[n_q + 1] and part_* [n_q, n_units]
// scratch with n_units = ceil(n / 2048); out float32[n_q, 2].
extern "C" int qgrid_launch(const int32_t* keys, int64_t n_pad, int64_t n,
                            int n_lanes, const float* vals,
                            const int32_t* col_lo, const int32_t* col_hi,
                            const int32_t* slabs, int n_q, int n_units,
                            int32_t* offs, float* part_s, int32_t* part_c,
                            float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes || n < 0 || n > n_pad ||
      n_units != (int)((n + kUnitRows - 1) / kUnitRows) ||
      (int64_t)n_q * n_units >= ((int64_t)1 << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  qgrid_offsets<<<1, kScanThreads, 0, st>>>(slabs, n, n_q, offs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_units > 0) {
    GridArgs a{keys, n_pad, n, n_lanes, aligned16(keys) && aligned16(vals) && n_pad % 4 == 0,
               vals, col_lo, col_hi, slabs, offs, n_q, n_units, part_s, part_c};
    const int64_t most = (int64_t)n_q * n_units;  // the pairs, at most
    switch (n_lanes) {
      case 1: e = launch_resident<qgrid_partials<1>>(most, a, st); break;
      case 2: e = launch_resident<qgrid_partials<2>>(most, a, st); break;
      case 3: e = launch_resident<qgrid_partials<3>>(most, a, st); break;
      case 4: e = launch_resident<qgrid_partials<4>>(most, a, st); break;
      case 5: e = launch_resident<qgrid_partials<5>>(most, a, st); break;
      case 6: e = launch_resident<qgrid_partials<6>>(most, a, st); break;
      case 7: e = launch_resident<qgrid_partials<7>>(most, a, st); break;
      case 8: e = launch_resident<qgrid_partials<8>>(most, a, st); break;
      default: e = launch_resident<qgrid_partials<0>>(most, a, st); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  slab_fold<<<(unsigned)((n_q + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      part_s, part_c, slabs, n, n_units, n_q, out);
  return static_cast<int>(cudaGetLastError());
}
