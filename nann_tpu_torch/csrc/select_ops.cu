// Row sort and row top-k of the search's filter half, for NVIDIA Hopper
// (sm_90a).
//
// Replaces two Mosaic probe kernels of scripts/probe_kernel_ops.py, which
// compiled the primitives of a fused per-hop filter on the TPU:
//
//   row_sort    out[b, :] = sort(x[b, :]), ascending and stable (equal keys
//               keep the lower index first), with the permutation on request
//               build_sort (:212, pallas_call :215). The list backend's merge
//               of tagged keys, the byte-map's expansion sort, the "exact"
//               fresh-node selection, the wide hop's stable id sort.
//   row_topk    (values, indices) of the k largest (or smallest) of each row,
//               in the order of a stable sort: ties go to the lower index, as
//               lax.top_k breaks them
//               build_topk (:222, :226). Every masked top-k of the search, the
//               "topk" and "approx" selections, the wide hop's selection and
//               the brute-force oracle's global top-k.
//
// The third, build_take_along (:186), a lane gather within rows, is
// gather_elems of csrc/visited_ops.cu with the row's last index as its clip
// bound.
//
// Keys are int32 or float32, mapped to unsigned radix keys whose unsigned
// order is the value order: the sign bit of an int32 flipped; a float's bits
// flipped whole when negative, or its sign bit set when not, after -0.0 is
// made +0.0 (the two compare equal, so they tie and keep their index order)
// and every NaN one NaN that sorts above +inf. A top-k of the largest takes
// the complement of that key, so one ascending order serves both directions
// and ties keep their index order in both.
//
// Bound on an H100: each is data movement with a few integer operations per
// element, so its least time is the bytes it must move over 3.35 TB/s: the
// input read once and the outputs written once. A sort of B rows of W keys
// moves 8 B W bytes (12 B W with the permutation).
//
// row_sort: an LSD radix sort of 32-bit keys in four 8-bit digits. A digit
// every key of the row shares is skipped (a row of small ids shares its
// high digits). The last pass that runs writes the
// permutation and the values: an int32's from its key, a float's read back
// from the input through the permutation, so their bits are the input's
// (-0.0 stays -0.0). Two paths, chosen by width
// (mirrored by `_sort_plan` in kernels/select_ops.py):
//
// - short rows (W <= kShortRow = 8192): one block of 512 threads a row holds
//   the row in registers (16 keys a thread) and runs every pass inside the
//   block: global memory is read once and written once. 84,032 bytes of
//   dynamic shared memory: two blocks an SM.
// - tiled rows (W > 8192): the row is cut into tiles of kSortTile = 4096
//   keys (512 threads x 8), and the grid is (B, tiles): [64, 33,992] gives
//   64 x 9 = 576 blocks on the 132 SMs, where one block a row used 64. One
//   call launches, on the caller's stream:
//   1. prepare: each tile's histograms of all four digits ([B, tiles, 4,
//      256]), counted with shared atomics and stored whole, so nothing in
//      global memory is zeroed or added to by two blocks;
//   2. plan (one block a row): the row's histograms (the tiles' summed),
//      each digit's bucket base (their exclusive scan) and which digits the
//      row must sort by ([B] flags);
//   3. for each digit that runs: an upsweep (the tile's counts of the
//      digit; the first pass takes prepare's) and a downsweep. A tile's
//      base for a digit is its bucket base plus that digit's counts in the
//      row's earlier tiles: a short read (9 tiles at 33,992; 25 at 100,000),
//      no look-back and no spin-wait, so a key's place never depends on
//      which block ran first. The downsweep ranks its tile's keys stably in
//      shared memory, stages the tile in digit order there and writes each
//      digit's run to its contiguous place, so neighbouring threads store to
//      neighbouring addresses. The first pass reads the input (the index is
//      the position), the last writes out and perm; between them the keys
//      and indices ping-pong in the scratch (the wrapper allocates it:
//      tiled_scratch_words), which fits the 50 MB L2 at the search's
//      widths.
//   51,264 bytes of dynamic shared memory a downsweep block: shared memory
//   would let four blocks share an SM, its registers let two
//   (nann_row_sort_blocks_per_sm says).
//
// What each path does about the old kernel's costs (one block of 1024
// threads a row, 140 KB of shared memory): the tiles fill all 132 SMs and
// several blocks share an SM; a key's rank costs eight ballots and one
// shared atomic per group of equal digits in a warp (its warp's running
// count), and the block's scan is over [16 warps x 256 digits] counters, an
// eighth of the old [128 slices x 256] for the same 4096 keys; the stores
// are runs of equal digits, coalesced, where the old kernel wrote each key
// alone.
//
// row_topk is a radix select over the row: four passes of a histogram of
// one digit among the keys that share the digits found so far give the
// k-th key T and how many of its ties are taken. One more pass compacts the
// winners in index order (the keys below T, then T's ties while they last,
// with block-wide ballot scans), and a block radix sort (one block of 1024
// threads, 32-key slices ranked by ballots) orders those k winners. The row
// is only read, so a row of 100,000 (the oracle's) needs no room in shared
// memory.
//
// Every kernel above 48 KB of dynamic shared memory opts in once per device
// (nann_select_init), not on every launch.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC   (plain C interface, loaded by ctypes)

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// One argument struct for the two entry points; mirrored field for field by
// `SelectArgs` in nann_tpu_torch/kernels/select_ops.py.
struct NannSelectArgs {
  const void* x;          // keys [B, W]
  void* out;              // row_sort: [B, W]; row_topk: [B, K]
  int32_t* perm;          // row_sort: permutation [B, W] or null;
                          // row_topk: indices [B, K]
  uint32_t* scratch;      // row_sort: scratch_words (rows above
                          // kShortRow, else none); row_topk: [4, B, K]
  int64_t B;              // rows
  int64_t W;              // keys per row
  int64_t K;              // row_topk: k
  int64_t scratch_words;  // row_sort: words of the scratch
  int32_t is_float;       // 1: float32 keys, 0: int32 keys
  int32_t largest;        // row_topk: 1 = the k largest, 0 = the k smallest
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kItems = 4;                     // keys a thread moves a round
constexpr int kTile = kItems * kThreads;      // keys a round moves
constexpr int kSlices = kItems * kWarps;      // 32-key slices of a round
constexpr int kQuarters = kThreads / kBins;   // threads per digit in a scan
constexpr unsigned kFull = 0xffffffffu;

// 140,560 bytes: dynamic shared memory, one block per SM
struct Smem {
  uint32_t slice_cnt[kSlices][kBins];    // per-slice digit counts, then offsets
  uint32_t quarter_tot[kQuarters][kBins];  // digit counts of a quarter's slices
  uint32_t hist[4][kBins];               // digit histograms of the keys sorted
  uint32_t bucket[kBins];                // running base of each digit's bucket
  uint32_t warp_tot[2][kWarps];          // per-warp totals of the compaction
  uint32_t scal[4];                      // values one warp hands the block
};

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The unsigned key whose order is the value order of an int32 or float32.
__device__ __forceinline__ uint32_t radix_key(uint32_t bits, bool is_float) {
  if (!is_float) return bits ^ 0x80000000u;
  const uint32_t mag = bits & 0x7fffffffu;
  if (mag == 0) bits = 0;                        // -0.0 ties with +0.0
  else if (mag > 0x7f800000u) bits = 0x7fc00000u;   // one NaN, above +inf
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// The bits of the value a sorted key came from: an int32's from its key
// alone; a float's (whose key maps -0.0 and every NaN to one key) read back
// from the row x at its index.
__device__ __forceinline__ uint32_t value_of(uint32_t key, uint32_t idx,
                                             const uint32_t* x,
                                             bool is_float) {
  return is_float ? x[idx] : key ^ 0x80000000u;
}

// The lanes of the warp whose d agrees with this lane's in the low kBits
// bits: one ballot a bit, which on a full warp of random digits is cheaper
// than __match_any_sync. Every lane of the warp calls it.
template <int kBits>
__device__ __forceinline__ unsigned warp_peers(uint32_t d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const unsigned bal = __ballot_sync(kFull, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? bal : ~bal;
  }
  return peers;
}

// hist[bin] += 1 for each lane with pred, one atomic per distinct bin of the
// warp. Every lane of the warp calls it. A full warp groups its lanes by
// ballots; a partial one (the later passes of the top-k's select, where few
// keys still match) by __match_any_sync over its active lanes, which is
// cheaper there.
__device__ __forceinline__ void warp_hist_add(uint32_t* hist, uint32_t bin,
                                              bool pred) {
  const unsigned active = __ballot_sync(kFull, pred);
  unsigned peers;
  if (active == kFull) {
    peers = warp_peers<8>(bin);
  } else {
    if (!pred) return;
    peers = __match_any_sync(active, bin);
  }
  if ((peers & lanemask_lt()) == 0) atomicAdd(hist + bin, __popc(peers));
}

// Warp 0 only. out[b] = in[0] + ... + in[b - 1] over 256 bins (in and out may
// be the same array). Returns (on every lane) whether one bin holds all n.
__device__ bool warp_scan_bins(const uint32_t* in, uint32_t* out,
                               uint32_t n) {
  const int lane = threadIdx.x & 31;
  uint32_t v[kBins / 32], sum = 0;
  bool whole = false;
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {
    v[j] = in[lane * (kBins / 32) + j];
    sum += v[j];
    whole |= v[j] == n;
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  uint32_t run = incl - sum;
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {
    out[lane * (kBins / 32) + j] = run;
    run += v[j];
  }
  return __any_sync(kFull, whole);
}

// Stable LSD radix sort of n (key, index) pairs of one row, by the whole
// block. The pairs are in (ka, ia), kb and ib are as long; s.hist holds the
// four digits' histograms and s.slice_cnt is zero. Returns 0 when the sorted
// pairs end in (ka, ia), 1 when in (kb, ib). Global memory is read and
// written by other threads of the block between passes, so it is read with
// plain loads, after a barrier.
//
// A round moves kTile keys: thread t holds keys base + j * kThreads + t, so
// slice j * kWarps + warp holds 32 consecutive keys and the slices run in
// index order. A key's rank among equal digits of its slice comes from nine
// ballots (warp_peers); the slices' counts of each digit are scanned in slice
// order by kQuarters threads (a quarter of the slices each) on top of the
// digit's bucket base.
__device__ int block_radix_sort(uint32_t* ka, uint32_t* ia, uint32_t* kb,
                                uint32_t* ib, int n, Smem& s) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int digit = tid & (kBins - 1), quarter = tid / kBins;
  constexpr int kPerQuarter = kSlices / kQuarters;
  uint32_t *src_k = ka, *src_i = ia, *dst_k = kb, *dst_i = ib;
  int cur = 0;
  for (int p = 0; p < 4; ++p) {
    __syncthreads();
    if (warp == 0) {
      const bool whole = warp_scan_bins(s.hist[p], s.bucket, (uint32_t)n);
      if (tid == 0) s.scal[0] = whole;
    }
    __syncthreads();
    if (s.scal[0]) continue;          // every key has this digit: no move
    const int shift = 8 * p;
    for (int base = 0; base < n; base += kTile) {
      uint32_t key[kItems], id[kItems], d[kItems], rank[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = base + j * kThreads + tid;
        d[j] = kBins;
        if (i < n) {
          key[j] = src_k[i];
          id[j] = src_i[i];
          d[j] = (key[j] >> shift) & (kBins - 1);
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const unsigned peers = warp_peers<9>(d[j]);   // d = kBins: no key
        rank[j] = __popc(peers & lanemask_lt());
        if (d[j] < kBins && rank[j] == 0)
          s.slice_cnt[j * kWarps + warp][d[j]] = __popc(peers);
      }
      __syncthreads();
      uint32_t* cnt = &s.slice_cnt[quarter * kPerQuarter][digit];
      uint32_t sum = 0;
#pragma unroll
      for (int v = 0; v < kPerQuarter; ++v) sum += cnt[v * kBins];
      s.quarter_tot[quarter][digit] = sum;
      __syncthreads();
      // the slices' offsets for this digit, in slice order, on top of its
      // bucket's base; counts of 0 stay 0 (no key reads them)
      uint32_t run = s.bucket[digit];
      for (int q = 0; q < quarter; ++q) run += s.quarter_tot[q][digit];
#pragma unroll
      for (int v = 0; v < kPerQuarter; ++v) {
        const uint32_t c = cnt[v * kBins];
        if (c) {
          cnt[v * kBins] = run;
          run += c;
        }
      }
      __syncthreads();
      if (quarter == kQuarters - 1) s.bucket[digit] = run;
      uint32_t dst[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (d[j] < kBins) dst[j] = s.slice_cnt[j * kWarps + warp][d[j]] + rank[j];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (d[j] < kBins) {
          if (rank[j] == 0) s.slice_cnt[j * kWarps + warp][d[j]] = 0;
          dst_k[dst[j]] = key[j];
          dst_i[dst[j]] = id[j];
        }
      }
      __syncwarp();   // the resets land before another lane's next count
    }
    uint32_t* t = src_k; src_k = dst_k; dst_k = t;
    t = src_i; src_i = dst_i; dst_i = t;
    cur ^= 1;
  }
  __syncthreads();
  return cur;
}

__device__ void zero_counts(Smem& s) {
  uint32_t* cnt = &s.slice_cnt[0][0];
  for (int t = threadIdx.x; t < kSlices * kBins; t += kThreads) cnt[t] = 0;
  uint32_t* hist = &s.hist[0][0];
  for (int t = threadIdx.x; t < 4 * kBins; t += kThreads) hist[t] = 0;
}

__global__ void __launch_bounds__(kThreads) row_topk_kernel(NannSelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t row = blockIdx.x;
  const int n = (int)a.W, k = (int)a.K;
  const bool is_float = a.is_float != 0;
  const uint32_t flip = a.largest ? kFull : 0u;
  const uint32_t* x = static_cast<const uint32_t*>(a.x) + row * n;

  // radix select: the k-th key T, from the top digit down, and kk, the
  // number of T's ties among the k
  uint32_t prefix = 0, mask = 0, kk = (uint32_t)k;
  for (int p = 3; p >= 0; --p) {
    const int shift = 8 * p;
    for (int t = tid; t < kBins; t += kThreads) s.hist[0][t] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      const uint32_t u = i < n ? radix_key(x[i], is_float) ^ flip : 0;
      warp_hist_add(s.hist[0], (u >> shift) & (kBins - 1),
                    i < n && (u & mask) == prefix);
    }
    __syncthreads();
    if (warp == 0) {
      uint32_t v[kBins / 32], sum = 0;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        v[j] = s.hist[0][lane * (kBins / 32) + j];
        sum += v[j];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      uint32_t below = incl - sum;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        if (below < kk && below + v[j] >= kk) {
          s.scal[0] = lane * (kBins / 32) + j;
          s.scal[1] = below;
        }
        below += v[j];
      }
    }
    __syncthreads();
    prefix |= s.scal[0] << shift;
    mask |= (uint32_t)(kBins - 1) << shift;
    kk -= s.scal[1];
  }
  const uint32_t T = prefix, n_less = (uint32_t)k - kk;

  // compaction of the winners in index order, with the histograms of their
  // keys for the sort
  uint32_t* ka = a.scratch + (0 * a.B + row) * k;
  uint32_t* ia = a.scratch + (1 * a.B + row) * k;
  uint32_t* kb = a.scratch + (2 * a.B + row) * k;
  uint32_t* ib = a.scratch + (3 * a.B + row) * k;
  zero_counts(s);
  if (tid == 0) s.scal[2] = s.scal[3] = 0;   // keys below T, T's ties so far
  __syncthreads();
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const uint32_t u = i < n ? radix_key(x[i], is_float) ^ flip : 0;
    const bool less = i < n && u < T, tie = i < n && u == T;
    const unsigned bl = __ballot_sync(kFull, less);
    const unsigned bt = __ballot_sync(kFull, tie);
    if (lane == 0) {
      s.warp_tot[0][warp] = __popc(bl);
      s.warp_tot[1][warp] = __popc(bt);
    }
    __syncthreads();
    if (warp == 0) {
      const uint32_t cl = s.warp_tot[0][lane], ct = s.warp_tot[1][lane];
      uint32_t il = cl, it = ct;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t tl = __shfl_up_sync(kFull, il, o);
        const uint32_t tt = __shfl_up_sync(kFull, it, o);
        if (lane >= o) {
          il += tl;
          it += tt;
        }
      }
      const uint32_t run_l = s.scal[2], run_t = s.scal[3];
      s.warp_tot[0][lane] = run_l + il - cl;
      s.warp_tot[1][lane] = run_t + it - ct;
      const uint32_t tot_l = __shfl_sync(kFull, il, 31);
      const uint32_t tot_t = __shfl_sync(kFull, it, 31);
      __syncwarp();
      if (lane == 0) {
        s.scal[2] = run_l + tot_l;
        s.scal[3] = run_t + tot_t;
      }
    }
    __syncthreads();
    const uint32_t less_before = s.warp_tot[0][warp] + __popc(bl & lanemask_lt());
    const uint32_t tie_before = s.warp_tot[1][warp] + __popc(bt & lanemask_lt());
    const bool take = less || (tie && tie_before < kk);
    if (take) {
      const uint32_t pos = less_before + (tie_before < kk ? tie_before : kk);
      ka[pos] = u;
      ia[pos] = (uint32_t)i;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      warp_hist_add(s.hist[p], (u >> (8 * p)) & (kBins - 1), take);
    const bool done = s.scal[2] == n_less && s.scal[3] >= kk;
    __syncthreads();
    if (done) break;
  }

  const uint32_t* order = block_radix_sort(ka, ia, kb, ib, k, s) ? ib : ia;
  uint32_t* out = static_cast<uint32_t*>(a.out) + row * k;
  int32_t* perm = a.perm + row * k;
  for (int i = tid; i < k; i += kThreads) {
    const uint32_t j = order[i];
    out[i] = x[j];
    perm[i] = (int32_t)j;
  }
}

// ---------------------------------------------------------------- row_sort

constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kTileItems = 8;                            // keys a thread, tiled
constexpr int kSortTile = kTileItems * kSortThreads;     // 4096 keys a tile
constexpr int kShortItems = 16;                          // keys a thread, short
constexpr int kShortRow = kShortItems * kSortThreads;    // 8192: one block

// A block's ranking room: its warps' running digit counts (then their
// offsets), the block's keys and indices staged in digit order, and each
// digit's start in the stage and (tiled) in the row. 51,264 bytes for a
// tile, 84,032 for a short row.
template <int kItems>
struct RankSmem {
  uint32_t warp_cnt[kSortWarps][kBins];
  uint32_t key[kItems * kSortThreads];
  uint32_t idx[kItems * kSortThreads];
  uint32_t start[kBins];
  uint32_t base[kBins];
  uint32_t warp_sum[kSortWarps];
};

// Where the tiled path's pieces lie in the scratch (uint32 words): keys and
// indices twice [B, tiles * kSortTile], the tiles' histograms of every
// digit [B, tiles, 4, kBins], one digit's tile counts [B, tiles, kBins], the
// bucket bases [B, 4, kBins] and the digits to sort by [B]. Every word a
// kernel reads was written earlier in the same call: nothing is zeroed.
struct SortPlan {
  const uint32_t* x;
  uint32_t* out;
  int32_t* perm;
  uint32_t* keys[2];
  uint32_t* ids[2];
  uint32_t* tile_all;
  uint32_t* tile_cnt;
  uint32_t* bucket;
  uint32_t* flags;
  int64_t W;
  int64_t stride;     // tiles * kSortTile
  int32_t tiles;
  int32_t is_float;
};

int64_t tiles_of(int64_t w) { return (w + kSortTile - 1) / kSortTile; }

int64_t tiled_scratch_words(int64_t B, int64_t W) {
  const int64_t tiles = tiles_of(W);
  return 4 * B * tiles * kSortTile + B * tiles * 5 * kBins + B * 4 * kBins
         + B;
}

SortPlan sort_plan(const NannSelectArgs& a) {
  SortPlan p;
  p.x = static_cast<const uint32_t*>(a.x);
  p.out = static_cast<uint32_t*>(a.out);
  p.perm = a.perm;
  p.W = a.W;
  p.tiles = (int32_t)tiles_of(a.W);
  p.stride = (int64_t)p.tiles * kSortTile;
  p.is_float = a.is_float;
  uint32_t* s = a.scratch;
  const int64_t row_words = a.B * p.stride;
  p.keys[0] = s;
  p.ids[0] = s + row_words;
  p.keys[1] = s + 2 * row_words;
  p.ids[1] = s + 3 * row_words;
  p.tile_all = s + 4 * row_words;
  p.tile_cnt = p.tile_all + a.B * p.tiles * 4 * kBins;
  p.bucket = p.tile_cnt + a.B * p.tiles * kBins;
  p.flags = p.bucket + a.B * 4 * kBins;
  return p;
}

// The exclusive prefix sum of v over threads 0..255 (v of the others is
// ignored). Every thread of the block calls it; it ends on a barrier, so
// warp_sum may be used again at once.
__device__ uint32_t scan_bins(uint32_t v, uint32_t* warp_sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid >= kBins) v = 0;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31 && warp < kBins / 32) warp_sum[warp] = incl;
  __syncthreads();
  uint32_t off = 0;
  for (int w = 0; w < warp && w < kBins / 32; ++w) off += warp_sum[w];
  __syncthreads();
  return off + incl - v;
}

// A warp's keys in index order (item j of lane l is the warp's key
// j * 32 + l, j < items <= kItems, the same on every thread of the block):
// rank[j] = the keys of a lower index with digit d[j], counted on top of
// cnt[d] (the warp's running counts, zero at the start; its totals at the
// end). Eight ballots group the lanes of equal digits, and the group's
// lowest lane adds the group to the count.
template <int kItems>
__device__ __forceinline__ void warp_rank(const uint32_t (&d)[kItems],
                                          uint32_t (&rank)[kItems],
                                          uint32_t* cnt, int items) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j >= items) break;
    const unsigned peers = warp_peers<8>(d[j]);
    const uint32_t below = __popc(peers & lanemask_lt());
    uint32_t prior = 0;
    if (below == 0) prior = atomicAdd(cnt + d[j], __popc(peers));
    rank[j] = __shfl_sync(kFull, prior, __ffs(peers) - 1) + below;
  }
}

// The block's ranks: afterwards s.start[d] is where digit d's run begins in
// the stage and s.warp_cnt[w][d] where warp w's keys of digit d begin
// within the run. Returns (threads 0..255, for their digit) the block's
// count of the digit. Slots past the row carry d = kBins - 1 and, being
// last in index order, come last.
template <int kItems>
__device__ uint32_t block_rank(const uint32_t (&d)[kItems],
                               uint32_t (&rank)[kItems],
                               RankSmem<kItems>& s, int items = kItems) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* cnt = s.warp_cnt[warp];
  for (int k = lane; k < kBins; k += 32) cnt[k] = 0;
  __syncwarp();
  warp_rank<kItems>(d, rank, cnt, items);
  __syncthreads();
  uint32_t total = 0;
  if (tid < kBins) {
    for (int w = 0; w < kSortWarps; ++w) {
      const uint32_t c = s.warp_cnt[w][tid];
      s.warp_cnt[w][tid] = total;
      total += c;
    }
  }
  const uint32_t start = scan_bins(total, s.warp_sum);
  if (tid < kBins) s.start[tid] = start;
  return total;
}

// Each key and index into its place of the stage, in digit order. The
// caller puts a barrier between block_rank and this.
template <int kItems>
__device__ __forceinline__ void stage(const uint32_t (&key)[kItems],
                                      const uint32_t (&id)[kItems],
                                      const uint32_t (&d)[kItems],
                                      const uint32_t (&rank)[kItems],
                                      RankSmem<kItems>& s,
                                      int items = kItems) {
  const uint32_t* cnt = s.warp_cnt[threadIdx.x >> 5];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j >= items) break;
    const uint32_t pos = s.start[d[j]] + cnt[d[j]] + rank[j];
    s.key[pos] = key[j];
    s.idx[pos] = id[j];
  }
}

// Short rows: one block a row, every pass inside it. With m = ceil(n /
// 512) <= 16 keys a thread, thread (warp w, lane l) holds the row's slots
// w * 32 m + j * 32 + l, j < m, in registers; a pass stages them in digit
// order and reads them back at the same slots. A slot's index is below n
// exactly when it holds a key of the row. At most 64 registers a thread,
// so that two blocks fit an SM.
__global__ void __launch_bounds__(kSortThreads, 2)
    row_sort_short_kernel(NannSelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  RankSmem<kShortItems>& s = *reinterpret_cast<RankSmem<kShortItems>*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const int n = (int)a.W;
  const int m = (n + kSortThreads - 1) / kSortThreads;
  const bool is_float = a.is_float != 0;
  const uint32_t* x = static_cast<const uint32_t*>(a.x) + row * n;
  uint32_t key[kShortItems], id[kShortItems], d[kShortItems],
      rank[kShortItems];
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = warp * 32 * m + j * 32 + lane;
    key[j] = j < m && i < n ? radix_key(x[i], is_float) : 0;
    id[j] = i;
  }
  for (int p = 0; p < 4; ++p) {
    const int shift = 8 * p;
#pragma unroll
    for (int j = 0; j < kShortItems; ++j)
      d[j] = id[j] < (uint32_t)n ? (key[j] >> shift) & (kBins - 1)
                                 : kBins - 1;
    uint32_t total = block_rank<kShortItems>(d, rank, s, m);
    if (tid == kBins - 1) total -= kSortThreads * m - n;   // the padding
    if (__syncthreads_or(tid < kBins && total == (uint32_t)n)) continue;
    stage<kShortItems>(key, id, d, rank, s, m);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kShortItems; ++j) {
      if (j >= m) break;
      const int i = warp * 32 * m + j * 32 + lane;
      key[j] = s.key[i];
      id[j] = s.idx[i];
    }
    __syncthreads();
  }
  uint32_t* out = static_cast<uint32_t*>(a.out) + row * n;
  int32_t* perm = a.perm ? a.perm + row * n : nullptr;
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = warp * 32 * m + j * 32 + lane;
    if (j < m && i < n) {
      out[i] = value_of(key[j], id[j], x, is_float);
      if (perm) perm[i] = (int32_t)id[j];
    }
  }
}

// Tiled rows, 1: each tile's histograms of all four digits, one shared
// atomic a key and digit (grouping a warp's equal digits by ballots first,
// as the top-k does, took 3-4 times as long here).
__global__ void __launch_bounds__(kSortThreads)
    row_sort_prepare_kernel(SortPlan a) {
  __shared__ uint32_t hist[4 * kBins];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x, tile = blockIdx.y;
  const bool is_float = a.is_float != 0;
  for (int t = tid; t < 4 * kBins; t += kSortThreads) hist[t] = 0;
  __syncthreads();
  const uint32_t* x = a.x + row * a.W;
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int64_t i = tile * kSortTile + r * kSortThreads + tid;
    const bool valid = i < a.W;
    const uint32_t key = valid ? radix_key(x[i], is_float) : 0;
    if (valid) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        atomicAdd(hist + p * kBins + ((key >> (8 * p)) & (kBins - 1)), 1u);
    }
  }
  __syncthreads();
  uint32_t* dst = a.tile_all + (row * a.tiles + tile) * 4 * kBins;
  for (int t = tid; t < 4 * kBins; t += kSortThreads) dst[t] = hist[t];
}

// Tiled rows, 2 (one block of 256 threads a row): the row's histograms,
// the bucket bases of every digit and the digits the row sorts by (bit p of
// flags: digit p varies).
__global__ void __launch_bounds__(kBins) row_sort_plan_kernel(SortPlan a) {
  __shared__ uint32_t warp_sum[kBins / 32];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const uint32_t* cnt = a.tile_all + row * a.tiles * 4 * kBins + tid;
  uint32_t flags = 0;
  for (int p = 0; p < 4; ++p) {
    uint32_t total = 0;
    for (int t = 0; t < a.tiles; ++t) total += cnt[(t * 4 + p) * kBins];
    const bool whole = __syncthreads_or(total == (uint32_t)a.W);
    a.bucket[(row * 4 + p) * kBins + tid] = scan_bins(total, warp_sum);
    if (!whole) flags |= 1u << p;
  }
  if (tid == 0) a.flags[row] = flags;
}

// Pass p of one row: whether it runs, whether it is the first or the last
// that runs, and which of the two buffers it writes (it reads the other).
struct Pass {
  bool runs, first, last;
  int dst;
};

__device__ __forceinline__ Pass pass_of(uint32_t flags, int p) {
  const uint32_t before = flags & ((1u << p) - 1);
  return {((flags >> p) & 1) != 0, before == 0, (flags >> (p + 1)) == 0,
          __popc(before) & 1};
}

// Tiled rows, 3a: the tile's counts of digit p, for a pass that is not the
// row's first (whose counts prepare wrote).
__global__ void __launch_bounds__(kSortThreads)
    row_sort_upsweep_kernel(SortPlan a, int p) {
  __shared__ uint32_t hist[kBins];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x, tile = blockIdx.y;
  const Pass ps = pass_of(a.flags[row], p);
  if (!ps.runs || ps.first) return;
  if (tid < kBins) hist[tid] = 0;
  __syncthreads();
  const uint32_t* src = (ps.dst ? a.keys[0] : a.keys[1]) + row * a.stride;
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int64_t i = tile * kSortTile + r * kSortThreads + tid;
    const bool valid = i < a.W;
    if (valid) atomicAdd(hist + ((src[i] >> (8 * p)) & (kBins - 1)), 1u);
  }
  __syncthreads();
  if (tid < kBins)
    a.tile_cnt[(row * a.tiles + tile) * kBins + tid] = hist[tid];
}

// Tiled rows, 3b: pass p over one tile. Thread (warp w, lane l) holds the
// tile's keys w * 256 + j * 32 + l, j < 8. The tile's base for digit d is
// the row's bucket base plus d's counts in the row's earlier tiles; the
// tile is ranked and staged in digit order in shared memory, and each
// digit's run is written to its place in one coalesced sweep. The first
// pass that runs reads the input, the last writes out and perm; where no
// digit varies, pass 3 writes the row as it is.
__global__ void __launch_bounds__(kSortThreads)
    row_sort_downsweep_kernel(SortPlan a, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  RankSmem<kTileItems>& s = *reinterpret_cast<RankSmem<kTileItems>*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x, tile = blockIdx.y;
  const int64_t lo = tile * kSortTile;
  const int n = (int)(a.W - lo < kSortTile ? a.W - lo : kSortTile);
  const uint32_t flags = a.flags[row];
  const Pass ps = pass_of(flags, p);
  const uint32_t* x = a.x + row * a.W;
  uint32_t* out = a.out + row * a.W;
  int32_t* perm = a.perm ? a.perm + row * a.W : nullptr;
  if (!ps.runs) {
    if (p == 3 && flags == 0) {        // every key equal: the row as it is
      for (int k = tid; k < n; k += kSortThreads) {
        out[lo + k] = x[lo + k];
        if (perm) perm[lo + k] = (int32_t)(lo + k);
      }
    }
    return;
  }
  const int shift = 8 * p;
  // the buffers as constants: a parameter array indexed at run time would
  // be copied to local memory
  const uint32_t* src_k = (ps.dst ? a.keys[0] : a.keys[1]) + row * a.stride
                          + lo;
  const uint32_t* src_i = (ps.dst ? a.ids[0] : a.ids[1]) + row * a.stride + lo;
  const bool is_float = a.is_float != 0;
  // the tile's base for digit tid, read first so that its loads overlap
  // the keys' and the ranking
  uint32_t base = 0;
  if (tid < kBins) {
    const int step = ps.first ? 4 * kBins : kBins;
    const uint32_t* cnt = ps.first
        ? a.tile_all + row * a.tiles * 4 * kBins + p * kBins + tid
        : a.tile_cnt + row * a.tiles * kBins + tid;
    base = a.bucket[(row * 4 + p) * kBins + tid];
#pragma unroll 8
    for (int t = 0; t < tile; ++t) base += cnt[t * step];
  }
  uint32_t key[kTileItems], id[kTileItems], d[kTileItems], rank[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int k = warp * (kTileItems * 32) + j * 32 + lane;
    key[j] = id[j] = 0;
    if (k < n) {
      key[j] = ps.first ? radix_key(x[lo + k], is_float) : src_k[k];
      id[j] = ps.first ? (uint32_t)(lo + k) : src_i[k];
    }
    d[j] = k < n ? (key[j] >> shift) & (kBins - 1) : kBins - 1;
  }
  block_rank<kTileItems>(d, rank, s);
  if (tid < kBins) s.base[tid] = base;
  __syncthreads();
  stage<kTileItems>(key, id, d, rank, s);
  __syncthreads();
  uint32_t* dst_k = (ps.dst ? a.keys[1] : a.keys[0]) + row * a.stride;
  uint32_t* dst_i = (ps.dst ? a.ids[1] : a.ids[0]) + row * a.stride;
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int k = r * kSortThreads + tid;
    if (k < n) {
      const uint32_t kk = s.key[k], ii = s.idx[k];
      const uint32_t dd = (kk >> shift) & (kBins - 1);
      const uint32_t g = s.base[dd] + ((uint32_t)k - s.start[dd]);
      if (ps.last) {
        out[g] = value_of(kk, ii, x, is_float);
        if (perm) perm[g] = (int32_t)ii;
      } else {
        dst_k[g] = kk;
        dst_i[g] = ii;
      }
    }
  }
}

bool row_fits(int64_t w) { return w <= INT32_MAX; }

}  // namespace

extern "C" {

// Opts every kernel above 48 KB of dynamic shared memory in to what it
// takes, on the current device; called once per device before its first
// launch. Returns 0 or the CUDA error.
int nann_select_init(void) {
  const struct {
    const void* kernel;
    size_t bytes;
  } kernels[] = {
      {(const void*)row_topk_kernel, sizeof(Smem)},
      {(const void*)row_sort_short_kernel, sizeof(RankSmem<kShortItems>)},
      {(const void*)row_sort_downsweep_kernel, sizeof(RankSmem<kTileItems>)}};
  for (const auto& k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Each launches on `stream` and returns 0 or the first launch's error
// (cudaGetLastError() after each launch); arguments it does not take return
// cudaErrorInvalidValue and launch nothing.

// row_sort: rows of up to kShortRow keys sort one block a row and need no
// scratch; wider rows take the tiled path, which needs scratch_words of
// tiled_scratch_words(B, W) and launches prepare, plan, then an upsweep
// (but for digit 0) and a downsweep for each digit: nine kernels.
int nann_row_sort(const NannSelectArgs* a, void* stream) {
  if (a->B == 0 || a->W == 0) return 0;
  if (!row_fits(a->W) || a->B > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->W <= kShortRow) {
    row_sort_short_kernel<<<(unsigned)a->B, kSortThreads,
                            sizeof(RankSmem<kShortItems>), st>>>(*a);
    return (int)cudaGetLastError();
  }
  if (a->scratch == nullptr ||
      a->scratch_words < tiled_scratch_words(a->B, a->W) ||
      tiles_of(a->W) > 65535)
    return (int)cudaErrorInvalidValue;
  const SortPlan plan = sort_plan(*a);
  const dim3 grid((unsigned)a->B, (unsigned)plan.tiles);
  row_sort_prepare_kernel<<<grid, kSortThreads, 0, st>>>(plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sort_plan_kernel<<<(unsigned)a->B, kBins, 0, st>>>(plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int p = 0; p < 4; ++p) {
    if (p > 0) {
      row_sort_upsweep_kernel<<<grid, kSortThreads, 0, st>>>(plan, p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    row_sort_downsweep_kernel<<<grid, kSortThreads,
                                sizeof(RankSmem<kTileItems>), st>>>(plan, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

int nann_row_topk(const NannSelectArgs* a, void* stream) {
  if (a->B == 0 || a->K == 0) return 0;
  if (!row_fits(a->W) || a->K > a->W) return (int)cudaErrorInvalidValue;
  row_topk_kernel<<<(unsigned)a->B, kThreads, sizeof(Smem),
                    static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// The tiled path's scratch in uint32 words, as the wrapper sizes it.
int64_t nann_row_sort_scratch_words(int64_t B, int64_t W) {
  return tiled_scratch_words(B, W);
}

// Blocks of a row_sort path (0 short, 1 the tiled downsweep) that fit an
// SM at once, after nann_select_init; a negative number is a CUDA error.
int nann_row_sort_blocks_per_sm(int path) {
  int n = 0;
  const cudaError_t err =
      path == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, row_sort_short_kernel, kSortThreads,
                      sizeof(RankSmem<kShortItems>))
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, row_sort_downsweep_kernel, kSortThreads,
                      sizeof(RankSmem<kTileItems>));
  return err == cudaSuccess ? n : -(int)err;
}

// The struct's size and its last field's offset, held against SelectArgs
// when the library is loaded.
size_t nann_select_args_size(void) { return sizeof(NannSelectArgs); }
size_t nann_select_args_largest_offset(void) {
  return offsetof(NannSelectArgs, largest);
}

const char* nann_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
