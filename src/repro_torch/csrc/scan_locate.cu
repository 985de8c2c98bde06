// Fused locate+scan for the device read path.
//
// Replaces the TPU kernel repro/kernels/slab_locate.py:scan_agg_locate_kernel.
// Per query, over its [start, stop) row window: the float32 sum of the
// selected value row over rows passing the residual [lo, hi) predicate,
// the int32 count of those rows, and the int32 count of rows whose key
// tuple lies lexicographically inside [slab_lo, slab_hi] (both inclusive).
//
// What bounds it on an H100. Evaluated naively, every (row, query) pair
// runs the slab and residual predicates: ~2e9 integer compares a batch of
// 256 at 7.5 M rows, far above the card's operations-per-byte line. But a
// routed query's slab is short (a few rows of one clerk and date, or one
// customer's orders), so almost every (tile, query) pair can contribute
// nothing. The design reads each staging tile's key lanes from device
// memory once per chunk of kQueryChunk queries and spends compares only
// where a row can count, which leaves the key bytes as the bound:
//   * staging: cp.async copies tile i + 1's key lanes into the second of
//     two shared-memory buffers while the CTA works on tile i;
//   * skipping: the CTA reduces the tile's key lanes over the rows inside
//     the chunk's window hull to the lexicographic minimum and maximum key
//     tuple and each logical column's minimum and maximum (a wide column
//     compared as its lane pair). Query q is live on the tile only if its
//     window meets the tile and either the tuple range meets
//     [slab_lo, slab_hi] or every column's range meets [res_lo, res_hi).
//     A pair that is not live has no row in the slab and none matched, so
//     its partials stay as they are; the live queries go to a list in
//     shared memory and the warps loop over that list only;
//   * refining: a tile live for nearly every query of its chunk (on a run
//     stack, the tile that straddles two runs spans almost every key) is
//     tested again per kThreads-row segment, so that each query evaluates
//     only the segments it can count in; without it the one CTA holding
//     such a tile evaluated 128 queries x 2048 rows and set the kernel's
//     time on a run stack (0.28 against 0.22 ms a launch of 128 on an
//     H100 at TPC-H SF 5);
//   * evaluating: each thread holds its rows of the tile in registers (a
//     compile-time lane count, 1 to 8, unrolls the compares; more lanes
//     take a generic instantiation that reads shared memory), the bounds
//     are broadcast from shared memory, the compares are branch-free, the
//     counts are ballots, and a value is loaded from device memory only
//     for a row that is taken.
//
// Float order (the parity contract): one CTA owns one 8192-row block and
// reduces each query's block partial in the in-block order that
// predicates.cuh defines (owned_row, thread_tile_sum, warp_slot_add,
// fold_warp_slots, over tiles of scan_tile() rows); the view kernels in
// block_sums.cu reduce a block the same way, and predicates.cuh says why
// the skipped pairs and butterflies change no bit. A second pass folds the
// block partials sequentially in ascending block order in float32, one
// warp per query. No float atomics, no split of the sum lane, so results
// are identical run to run.
#include <climits>
#include <cstdint>

#include "predicates.cuh"

using namespace repro;

namespace {

// Key lanes the generic instantiation takes (32 columns of two lanes).
constexpr int kMaxLanes = 64;
// Dynamic shared memory one CTA may opt into on an H100.
constexpr size_t kMaxSmem = 232448;
// Live queries above which a tile may be refined by segment (see the kernel).
constexpr int kRefineLive = 8;
static_assert(kQueryChunk <= kThreads, "one thread tests each query of a chunk");

struct ScanArgs {
  const int32_t* keys;
  int64_t n_pad;
  int n_lanes;
  uint64_t pair_hi;    // bit l: lanes l, l + 1 hold one wide column
  uint64_t col_first;  // bit l: lane l is a column's first lane
  int vec16;           // key lanes 16-byte aligned: stage in 16-byte copies
  int n_bufs;          // staging buffers, 2 (double buffered) or 1
  const float* values;
  int n_vals;
  const int32_t* res_lo;
  const int32_t* res_hi;
  const int32_t* slab_lo;
  const int32_t* slab_hi;
  const int32_t* limits;
  const int32_t* sel;
  int n_q;
  int tile;
  int n_blocks;
  float* part_s;  // [n_q, n_blocks]
  int32_t* part_m;
  int32_t* part_c;
};

// Shared ints beside the per-query arrays: the live count, a pad, and
// each warp's window hull (lo, hi) and count of nonempty windows.
constexpr int kMisc = 2 + 3 * kWarps;

// Dynamic shared memory of one CTA: the staging buffers, then per query
// its four bound rows, window, selector, per-warp sum slots, match and
// slab counts and live-list entry, then kMisc ints and the per-warp tile
// ranges (int64 column ranges, int32 tuple ranges). Every region before
// the int64 one is a multiple of 8 bytes.
size_t scan_smem(int n_lanes, int tile, int n_bufs) {
  return (size_t)n_bufs * tile * n_lanes * 4
         + (size_t)kQueryChunk * (4 * n_lanes + 3 + kWarps + 3) * 4
         + kMisc * 4
         + (size_t)kWarps * 2 * n_lanes * (8 + 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of key lanes [0, nl) of rows [row0, row0 + tile) into
// `buf` (lane l at buf[l * tile]); rows at or past n_pad are zero-filled.
__device__ __forceinline__ void stage_tile(int32_t* buf, const ScanArgs& a, int nl,
                                           int64_t row0) {
  const int tile = a.tile;
  for (int l = 0; l < nl; ++l) {
    const int32_t* lane = a.keys + l * a.n_pad;
    if (a.vec16) {
      for (int c = threadIdx.x; c < tile / 4; c += kThreads) {
        const int64_t left = a.n_pad - (row0 + 4 * c);
        const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
        cp_async16(buf + l * tile + 4 * c, lane + (bytes ? row0 + 4 * c : 0), bytes);
      }
    } else {
      for (int i = threadIdx.x; i < tile; i += kThreads) {
        const bool in = row0 + i < a.n_pad;
        cp_async4(buf + l * tile + i, lane + (in ? row0 + i : 0), in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// x < y for key tuples over lanes [0, nl), MSB lane first, branch-free
// from the last lane up.
template <int AL>
__device__ __forceinline__ bool lex_less(const int32_t (&x)[AL], const int32_t (&y)[AL], int nl) {
  bool lt = false;
#pragma unroll
  for (int l = AL - 1; l >= 0; --l) {
    if (l < nl) lt = (x[l] < y[l]) | ((x[l] == y[l]) & lt);
  }
  return lt;
}

// A logical column's value at its first lane l as one int64 whose order is
// the column's: a wide column (hi, lo) maps to hi * 2^32 + (lo + 2^31).
__device__ __forceinline__ int64_t col_value(int32_t hi, int32_t lo, bool pair) {
  return pair ? (int64_t)hi * 4294967296LL + ((int64_t)lo + 2147483648LL) : (int64_t)hi;
}

// LANES: the key lane count, unrolled into registers; 0 takes any count up
// to kMaxLanes and reads the rows from the staging buffer.
template <int LANES>
__global__ void __launch_bounds__(kThreads) scan_partials(const ScanArgs a) {
  constexpr int AL = LANES > 0 ? LANES : kMaxLanes;  // extent of per-lane arrays
  constexpr int KL = LANES > 0 ? LANES : 1;          // extent of the row registers
  constexpr int R = kMaxRowsPerThread;
  const int NL = LANES > 0 ? LANES : a.n_lanes;
  const int tile = a.tile;
  const int rpt = tile / kThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* bufs = reinterpret_cast<int32_t*>(smem_raw);
  // bound row `which` (0 slab_lo, 1 slab_hi, 2 res_lo, 3 res_hi), lane l of
  // query q at qb[(which * NL + l) * kQueryChunk + q]: a thread per query
  // reads its own without bank conflicts, a query's bounds broadcast
  int32_t* qb = bufs + (size_t)a.n_bufs * tile * NL;
  int32_t* q_lim = qb + kQueryChunk * 4 * NL;
  int32_t* q_sel = q_lim + 2 * kQueryChunk;
  float* red_s = reinterpret_cast<float*>(q_sel + kQueryChunk);
  int32_t* red_m = reinterpret_cast<int32_t*>(red_s + kQueryChunk * kWarps);
  int32_t* red_c = red_m + kQueryChunk;
  int32_t* live = red_c + kQueryChunk;
  int32_t* misc = live + kQueryChunk;  // [0] live count, [2 + 3w ...]: warp w's hull, nonempty
  int64_t* w_col = reinterpret_cast<int64_t*>(misc + kMisc);  // [warp][min|max][lane]
  int32_t* w_tup = reinterpret_cast<int32_t*>(w_col + kWarps * 2 * NL);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t block_row0 = (int64_t)blockIdx.x * kBlockRows;
  const int q0 = blockIdx.y * kQueryChunk;
  const int qn = min(kQueryChunk, a.n_q - q0);

  for (int i = tid; i < qn * NL; i += kThreads) {
    const int q = i / NL;
    const int l = i - q * NL;
    const int64_t g = (int64_t)(q0 + q) * NL + l;
    qb[l * kQueryChunk + q] = a.slab_lo[g];
    qb[(NL + l) * kQueryChunk + q] = a.slab_hi[g];
    qb[(2 * NL + l) * kQueryChunk + q] = a.res_lo[g];
    qb[(3 * NL + l) * kQueryChunk + q] = a.res_hi[g];
  }
  for (int i = tid; i < qn * kWarps; i += kThreads) red_s[i] = 0.f;
  // the hull of the chunk's nonempty windows: the rows the ranges take
  int h_lo = INT_MAX;
  int h_hi = INT_MIN;
  for (int q = tid; q < qn; q += kThreads) {
    const int lo = a.limits[2 * (int64_t)(q0 + q)];
    const int hi = a.limits[2 * (int64_t)(q0 + q) + 1];
    q_lim[2 * q] = lo;
    q_lim[2 * q + 1] = hi;
    q_sel[q] = a.sel[q0 + q];
    red_m[q] = 0;
    red_c[q] = 0;
    if (lo < hi) {
      h_lo = min(h_lo, lo);
      h_hi = max(h_hi, hi);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    h_lo = min(h_lo, __shfl_xor_sync(0xffffffffu, h_lo, o));
    h_hi = max(h_hi, __shfl_xor_sync(0xffffffffu, h_hi, o));
  }
  // kQueryChunk <= kThreads: thread q wrote query q's window above
  const int nonempty = __popc(__ballot_sync(0xffffffffu, tid < qn && q_lim[2 * tid] < q_lim[2 * tid + 1]));
  if (lane == 0) {
    misc[2 + 3 * warp] = h_lo;
    misc[3 + 3 * warp] = h_hi;
    misc[4 + 3 * warp] = nonempty;
  }
  __syncthreads();
  int n_nonempty = 0;
  for (int w = 0; w < kWarps; ++w) {
    h_lo = min(h_lo, misc[2 + 3 * w]);
    h_hi = max(h_hi, misc[3 + 3 * w]);
    n_nonempty += misc[4 + 3 * w];
  }
  // rows of this block the ranges take: the hull, inside the tensor
  const int64_t b_lo = max(block_row0, (int64_t)h_lo);
  const int64_t b_hi = min(min(block_row0 + kBlockRows, (int64_t)h_hi), a.n_pad);
  const int64_t t_first = block_row0 + (b_lo - block_row0) / tile * tile;

  int32_t kr[R][KL];  // this thread's rows of the tile, lane by lane
  int it = 0;
  if (a.n_bufs == 2 && t_first < b_hi) stage_tile(bufs, a, NL, t_first);
  for (int64_t row0 = t_first; row0 < b_hi; row0 += tile, ++it) {
    int32_t* cur = bufs + (size_t)(a.n_bufs == 2 ? (it & 1) : 0) * tile * NL;
    if (a.n_bufs == 1) {
      __syncthreads();  // the previous tile is consumed
      stage_tile(cur, a, NL, row0);
    }
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; the previous tile is consumed
    if (a.n_bufs == 2 && row0 + tile < b_hi) {
      stage_tile(bufs + (size_t)((it + 1) & 1) * tile * NL, a, NL, row0 + tile);
    }
    auto key = [&](int k, int l) -> int32_t {
      if constexpr (LANES > 0) {
        return kr[k][l];
      } else {
        return cur[l * tile + owned_row(k)];
      }
    };
    uint32_t valid = 0;  // rows this thread owns inside the hull
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t r = row0 + owned_row(k);
      if (k < rpt && r >= b_lo && r < b_hi) valid |= 1u << k;
      if constexpr (LANES > 0) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) kr[k][l] = k < rpt ? cur[l * tile + owned_row(k)] : 0;
      }
    }

    // The key ranges of this thread's rows in `rows` (a mask of k), reduced
    // by butterfly over the warp, then over the CTA from the warps' ranges
    // in shared memory; afterwards the lanes of the warps with
    // `n_testers` > 32 * warp hold the CTA's range (each group of kWarps
    // lanes loads all the warps' ranges, so three steps reduce them).
    int32_t tmin[AL], tmax[AL];
    int64_t cmin[AL], cmax[AL];
    auto butterfly = [&](int first) {
      for (int o = first; o > 0; o >>= 1) {
        int32_t omin[AL], omax[AL];
#pragma unroll
        for (int l = 0; l < AL; ++l) {
          if (l < NL) {
            omin[l] = __shfl_xor_sync(0xffffffffu, tmin[l], o);
            omax[l] = __shfl_xor_sync(0xffffffffu, tmax[l], o);
            if ((a.pair_hi >> l) & 1u) {
              cmin[l] = min(cmin[l], (int64_t)__shfl_xor_sync(0xffffffffu, (long long)cmin[l], o));
              cmax[l] = max(cmax[l], (int64_t)__shfl_xor_sync(0xffffffffu, (long long)cmax[l], o));
            } else {
              cmin[l] = min(cmin[l], (int64_t)__shfl_xor_sync(0xffffffffu, (int32_t)cmin[l], o));
              cmax[l] = max(cmax[l], (int64_t)__shfl_xor_sync(0xffffffffu, (int32_t)cmax[l], o));
            }
          } else {
            omin[l] = omax[l] = 0;
          }
        }
        const bool lt = lex_less(omin, tmin, NL);
        const bool gt = lex_less(tmax, omax, NL);
#pragma unroll
        for (int l = 0; l < AL; ++l) {
          if (l < NL) {
            tmin[l] = lt ? omin[l] : tmin[l];
            tmax[l] = gt ? omax[l] : tmax[l];
          }
        }
      }
    };
    auto cta_range = [&](uint32_t rows, int n_testers) {
#pragma unroll
      for (int l = 0; l < AL; ++l) {  // a narrow column's range stays in int32
        const bool pair = (a.pair_hi >> l) & 1u;
        tmin[l] = INT_MAX;
        tmax[l] = INT_MIN;
        cmin[l] = pair ? LLONG_MAX : INT_MAX;
        cmax[l] = pair ? LLONG_MIN : INT_MIN;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (!((rows >> k) & 1u)) continue;
        int32_t row[AL];
#pragma unroll
        for (int l = 0; l < AL; ++l) row[l] = l < NL ? key(k, l) : 0;
        const bool lt = lex_less(row, tmin, NL);
        const bool gt = lex_less(tmax, row, NL);
#pragma unroll
        for (int l = 0; l < AL; ++l) {
          if (l < NL) {
            tmin[l] = lt ? row[l] : tmin[l];
            tmax[l] = gt ? row[l] : tmax[l];
            const int l2 = l + 1 < NL ? l + 1 : l;
            const int64_t v = col_value(row[l], row[l2], (a.pair_hi >> l) & 1u);
            cmin[l] = min(cmin[l], v);
            cmax[l] = max(cmax[l], v);
          }
        }
      }
      butterfly(16);
      if (lane == 0) {
        for (int l = 0; l < NL; ++l) {
          w_tup[(warp * 2) * NL + l] = tmin[l];
          w_tup[(warp * 2 + 1) * NL + l] = tmax[l];
          w_col[(warp * 2) * NL + l] = cmin[l];
          w_col[(warp * 2 + 1) * NL + l] = cmax[l];
        }
      }
      __syncthreads();
      if (warp * 32 < n_testers) {
        const int w = lane % kWarps;
#pragma unroll
        for (int l = 0; l < AL; ++l) {
          if (l < NL) {
            tmin[l] = w_tup[(w * 2) * NL + l];
            tmax[l] = w_tup[(w * 2 + 1) * NL + l];
            cmin[l] = w_col[(w * 2) * NL + l];
            cmax[l] = w_col[(w * 2 + 1) * NL + l];
          }
        }
        butterfly(kWarps / 2);
      }
    };
    // The rule: query q may count a row of rows [r_lo, r_hi) with the range
    // just reduced only if its window meets them and either the tuple
    // range meets [slab_lo, slab_hi] or every column's range meets
    // [res_lo, res_hi).
    auto is_live = [&](int q, int64_t r_lo, int64_t r_hi) -> bool {
      const int lo = q_lim[2 * q];
      const int hi = q_lim[2 * q + 1];
      if (!(lo < hi && lo < r_hi && hi > r_lo)) return false;
      auto b = [&](int which, int l) { return qb[(which * NL + l) * kQueryChunk + q]; };
      bool le = true, ge = true, res = true;  // tmin <= slab_hi, tmax >= slab_lo
#pragma unroll
      for (int l = AL - 1; l >= 0; --l) {
        if (l < NL) {
          const int32_t s0 = b(0, l), s1 = b(1, l);
          le = (tmin[l] < s1) | ((tmin[l] == s1) & le);
          ge = (tmax[l] > s0) | ((tmax[l] == s0) & ge);
          if ((a.col_first >> l) & 1u) {
            const bool pair = (a.pair_hi >> l) & 1u;
            const int l2 = l + 1 < NL ? l + 1 : l;
            const int64_t rlo = col_value(b(2, l), b(2, l2), pair);
            const int64_t rhi = col_value(b(3, l), b(3, l2), pair);
            res &= (cmin[l] < rhi) & (cmax[l] >= rlo);
          }
        }
      }
      return (le & ge) | res;
    };

    // the tile's range over the rows inside the hull, and the live list
    if (tid == 0) misc[0] = 0;
    cta_range(valid, qn);
    if (warp * 32 < qn) {
      const bool live_q = tid < qn && is_live(tid, row0, row0 + tile);
      const unsigned bal = __ballot_sync(0xffffffffu, live_q);
      if (bal) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&misc[0], __popc(bal));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (live_q) live[base + __popc(bal & ((1u << lane) - 1u))] = tid;
      }
    }
    __syncthreads();
    const int n_live = misc[0];

    // A tile live for nearly every query of the chunk is refined: each of
    // its kThreads-row segments (row k of every thread) gets its own range
    // and each live query its own mask of the segments the rule leaves
    // live, so that the query evaluates those rows only (exact by the same
    // argument). Such a tile straddles two runs of a run stack, so its
    // range spans nearly every key while the queries' own slabs lie apart,
    // and one CTA evaluating all of it was the kernel's straggler. A tile
    // live for only part of the chunk is live because those queries' slabs
    // are long, and refining it would prune nothing.
    const bool refine = LANES > 0 && n_live > kRefineLive && 4 * n_live > 3 * n_nonempty;
    if (refine) {
      const int e = tid < n_live ? live[tid] : 0;
      uint32_t segs = 0;
      for (int k = 0; k < rpt; ++k) {
        const int64_t s_lo = row0 + k * kThreads;
        cta_range(valid & (1u << k), n_live);
        if (tid < n_live && s_lo + kThreads > b_lo && s_lo < b_hi && is_live(e, s_lo, s_lo + kThreads)) {
          segs |= 1u << k;
        }
        __syncthreads();  // the warps' ranges are read before the next segment's
      }
      if (tid < n_live) live[tid] = e | (int)(segs << 8);
      __syncthreads();
    }

    // every live query on this thread's rows of the tile
    for (int j = 0; j < n_live; ++j) {
      const int q = live[j] & 0xff;  // a refined tile's entry: segment mask << 8
      const uint32_t segs = refine ? (uint32_t)live[j] >> 8 : 0xffu;
      const int32_t* b = qb + q;  // bound (which, l) at b[(which * NL + l) * kQueryChunk]
      int32_t slo[KL], shi[KL], rlo[KL], rhi[KL];
      if constexpr (LANES > 0) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          slo[l] = b[l * kQueryChunk];
          shi[l] = b[(NL + l) * kQueryChunk];
          rlo[l] = b[(2 * NL + l) * kQueryChunk];
          rhi[l] = b[(3 * NL + l) * kQueryChunk];
        }
      }
      auto bound = [&](const int32_t (&reg)[KL], int which, int l) -> int32_t {
        if constexpr (LANES > 0) {
          return reg[l];
        } else {
          return b[(which * NL + l) * kQueryChunk];
        }
      };
      const int lo = q_lim[2 * q];
      const int hi = q_lim[2 * q + 1];
      const int sv = q_sel[q];
      const bool has_v = sv >= 0 && sv < a.n_vals;
      const float* vrow = a.values + (int64_t)(has_v ? sv : 0) * a.n_pad + row0;
      int m = 0, c = 0;
      uint32_t matched = 0;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k >= rpt || !((segs >> k) & 1u)) continue;  // uniform
        const int64_t r = row0 + owned_row(k);
        bool sge = true, sle = true, rge = true, rlt = false, ok = true;
#pragma unroll
        for (int l = AL - 1; l >= 0; --l) {
          if (l < NL) {
            const int32_t x = key(k, l);
            const int32_t s0 = bound(slo, 0, l), s1 = bound(shi, 1, l);
            const int32_t r0 = bound(rlo, 2, l), r1 = bound(rhi, 3, l);
            const bool cont = (a.pair_hi >> l) & 1u;
            sge = (x > s0) | ((x == s0) & sge);
            sle = (x < s1) | ((x == s1) & sle);
            rge = (x > r0) | ((x == r0) & (!cont | rge));
            rlt = (x < r1) | ((x == r1) & cont & rlt);
            ok &= (rge & rlt) | !((a.col_first >> l) & 1u);
          }
        }
        const bool inw = ((valid >> k) & 1u) & (r >= lo) & (r < hi);  // in the hull and the window
        c += __popc(__ballot_sync(0xffffffffu, inw & sge & sle));
        m += __popc(__ballot_sync(0xffffffffu, inw & ok));
        matched |= (uint32_t)(inw & ok) << k;
      }
      const uint32_t take = has_v ? matched : 0u;
      float v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        v[k] = ((take >> k) & 1u) ? __ldg(vrow + owned_row(k)) : 0.f;
      }
      warp_slot_add(thread_tile_sum<R>(v, take, 0), take != 0, red_s[q * kWarps + warp]);
      if (lane == 0) {
        if (m) atomicAdd(&red_m[q], m);
        if (c) atomicAdd(&red_c[q], c);
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < qn; q += kThreads) {
    const int64_t o = (int64_t)(q0 + q) * a.n_blocks + blockIdx.x;
    a.part_s[o] = fold_warp_slots(red_s + q * kWarps);
    a.part_m[o] = red_m[q];
    a.part_c[o] = red_c[q];
  }
}

// Sequential float32 fold of each query's [n_blocks] partials in ascending
// block order, one warp per query: the lanes load 32 partials of a chunk
// side by side, kInFlight chunks at a time, and every lane adds them in
// block order from shuffles, so each holds the same sequential sum.
constexpr int kInFlight = 8;

__global__ void __launch_bounds__(kThreads)
scan_fold(const float* __restrict__ part_s, const int32_t* __restrict__ part_m,
          const int32_t* __restrict__ part_c, int n_blocks, int n_q,
          float* __restrict__ out_s, int32_t* __restrict__ out_m,
          int32_t* __restrict__ out_c) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n_q) return;  // whole warps
  const int64_t base = (int64_t)q * n_blocks;
  float s = 0.f;
  int m = 0, c = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += 32 * kInFlight) {
    float p[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int b = b0 + 32 * i + lane;
      const bool in = b < n_blocks;
      p[i] = in ? part_s[base + b] : 0.f;
      m += in ? part_m[base + b] : 0;
      c += in ? part_c[base + b] : 0;
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int nb = min(32, n_blocks - (b0 + 32 * i));
      for (int j = 0; j < nb; ++j) s += __shfl_sync(0xffffffffu, p[i], j);
    }
  }
  m = warp_sum(m);
  c = warp_sum(c);
  if (lane == 0) {
    out_s[q] = s;
    out_m[q] = m;
    out_c[q] = c;
  }
}

template <int LANES>
cudaError_t launch_partials(const ScanArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(scan_partials<LANES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  scan_partials<LANES><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
// keys int32[>=n_lanes, n_pad], values float32[>=n_vals, n_pad], the four
// bound arrays int32[n_q, n_lanes], limits int32[n_q, 2], sel int32[n_q];
// part_* are [n_q, n_blocks] scratch, out_* are [n_q].
extern "C" int scan_locate_launch(
    const int32_t* keys, int64_t n_pad, int n_lanes, int n_cols,
    uint32_t wide_mask, const float* values, int n_vals, const int32_t* res_lo,
    const int32_t* res_hi, const int32_t* slab_lo, const int32_t* slab_hi,
    const int32_t* limits, const int32_t* sel, int n_q, int n_blocks,
    float* part_s, int32_t* part_m, int32_t* part_c, float* out_s,
    int32_t* out_m, int32_t* out_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0 || n_blocks <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_cols < 1 || n_cols > 32 || n_vals < 1) {
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
  // the tile sets the in-block float order: block_sums.cu takes the same
  const int tile = scan_tile(n_lanes, n_vals);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  int n_bufs = 2;
  if (scan_smem(n_lanes, tile, 2) > kMaxSmem) n_bufs = 1;
  const size_t smem = scan_smem(n_lanes, tile, n_bufs);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = reinterpret_cast<uintptr_t>(keys) % 16 == 0 && n_pad % 4 == 0;
  ScanArgs a{keys, n_pad, n_lanes, pair_hi, col_first, vec16, n_bufs,
             values, n_vals, res_lo, res_hi, slab_lo, slab_hi, limits, sel, n_q, tile,
             n_blocks, part_s, part_m, part_c};
  dim3 grid(n_blocks, (n_q + kQueryChunk - 1) / kQueryChunk);
  cudaError_t e;
  switch (n_lanes) {
    case 1: e = launch_partials<1>(a, grid, smem, st); break;
    case 2: e = launch_partials<2>(a, grid, smem, st); break;
    case 3: e = launch_partials<3>(a, grid, smem, st); break;
    case 4: e = launch_partials<4>(a, grid, smem, st); break;
    case 5: e = launch_partials<5>(a, grid, smem, st); break;
    case 6: e = launch_partials<6>(a, grid, smem, st); break;
    case 7: e = launch_partials<7>(a, grid, smem, st); break;
    case 8: e = launch_partials<8>(a, grid, smem, st); break;
    default: e = launch_partials<0>(a, grid, smem, st); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_fold<<<(n_q + kWarps - 1) / kWarps, kThreads, 0, st>>>(part_s, part_m, part_c,
                                                              n_blocks, n_q, out_s, out_m,
                                                              out_c);
  return static_cast<int>(cudaGetLastError());
}
