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
// moves 8 B W bytes (12 B W with the permutation); a top-k 4 B W + 8 B k.
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
// row_topk: a radix select of the k-th key from the top digit down, then a
// stable sort of the k winners. Two paths, by width as the sort's (mirrored
// by `_topk_plan`):
//
// - short rows (W <= kShortRow, every top-k of a search's hops): one block
//   of 512 threads a row holds the row in registers, as the short sort does.
//   Digits every key shares (the AND and the OR of the keys agree there) are
//   taken without a pass; each other digit costs a histogram, in shared
//   memory, of the keys that share the digits found so far, and the select
//   stops when the bucket's keys are all taken. The winners are compacted in
//   index order into shared memory and sorted there by the short sort's own
//   passes (block_sort_short). k == W is the sort alone. One device kernel a
//   call; global memory is read once and written once. Rows of 90 or 400
//   keys take the same block: 64 such rows are one wave on 132 SMs, so
//   several rows a block would not shorten it.
// - tiled rows (W > kShortRow: the oracle, the "topk" and "approx"
//   selections, the wide selection): the grid is (B, tiles of 4096) as in the
//   tiled sort, so every SM works. For each digit from the top: a histogram
//   kernel (each tile's counts of the digit among the keys that share the
//   row's prefix so far, stored whole) and a plan kernel (one block a row:
//   the tiles' counts summed, the bucket of the k-th key, each tile's keys
//   below it and in it). A lower digit that the keys in the bucket all share
//   (their AND and OR, stored by the histogram kernel, agree there) is taken
//   without a pass, so a tie group of any size costs one histogram after the
//   one that found it. A row is done when its bucket's keys are all taken,
//   or when every digit is known (then the bucket is the k-th key's ties:
//   both "exact"), or, for k <= kShortRow, when the bucket fits one block
//   (kCandidates keys). Later passes of a done row return at once. A filter
//   kernel then writes, in index order, the certain winners (below the
//   bucket, and in exact rows the first ties while they last) and the
//   bucket's keys as candidates; a tile's place is the sum of the row's
//   earlier tiles' counts, so no atomics cross blocks and nothing depends on
//   which block ran first. A finish block a row selects among the
//   candidates as the short path does and sorts the k winners on chip. For
//   k > kShortRow the winners go through the tiled row sort instead, and a
//   gather kernel writes the values and indices. Ten device kernels a call
//   (nineteen for k > kShortRow).
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
  uint32_t* scratch;      // rows above kShortRow: scratch_words (row_sort:
                          // tiled_scratch_words; row_topk:
                          // topk_scratch_words), else none
  int64_t B;              // rows
  int64_t W;              // keys per row
  int64_t K;              // row_topk: k
  int64_t scratch_words;  // words of the scratch
  int32_t is_float;       // 1: float32 keys, 0: int32 keys
  int32_t largest;        // row_topk: 1 = the k largest, 0 = the k smallest
};

namespace {

constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSignBit = 0x80000000u;

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The unsigned key whose order is the value order of an int32 or float32.
__device__ __forceinline__ uint32_t radix_key(uint32_t bits, bool is_float) {
  if (!is_float) return bits ^ kSignBit;
  const uint32_t mag = bits & 0x7fffffffu;
  if (mag == 0) bits = 0;                        // -0.0 ties with +0.0
  else if (mag > 0x7f800000u) bits = 0x7fc00000u;   // one NaN, above +inf
  return (bits & kSignBit) ? ~bits : (bits | kSignBit);
}

// The bits of the value a sorted key came from: an int32's from its key
// alone; a float's (whose key maps -0.0 and every NaN to one key) read back
// from the row x at its index.
__device__ __forceinline__ uint32_t value_of(uint32_t key, uint32_t idx,
                                             const uint32_t* x,
                                             bool is_float) {
  return is_float ? x[idx] : key ^ kSignBit;
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

// The slot of item j of this thread in a block that holds m keys a thread:
// thread (warp w, lane l) holds slots w * 32 m + j * 32 + l, so the slots
// run in (warp, item, lane) order.
__device__ __forceinline__ int slot_of(int j, int m) {
  return (threadIdx.x >> 5) * 32 * m + j * 32 + (threadIdx.x & 31);
}

// Stable LSD sort of the n (key, id) pairs a block holds in registers, m <=
// kShortItems a thread at slot_of(j, m), the first n slots holding them: a
// slot holds a key when its id is below id_end, and the slots past n carry
// ids that are not. Afterwards slot i holds the i-th smallest key, equal
// keys in slot order. Each pass stages the block in digit order and reads
// it back at the same slots; a digit every key shares is skipped. Every
// thread calls it.
__device__ __forceinline__ void block_sort_short(
    uint32_t (&key)[kShortItems], uint32_t (&id)[kShortItems], int n, int m,
    uint32_t id_end, RankSmem<kShortItems>& s) {
  const int tid = threadIdx.x;
  uint32_t d[kShortItems], rank[kShortItems];
  for (int p = 0; p < 4; ++p) {
    const int shift = 8 * p;
#pragma unroll
    for (int j = 0; j < kShortItems; ++j)
      d[j] = id[j] < id_end ? (key[j] >> shift) & (kBins - 1) : kBins - 1;
    uint32_t total = block_rank<kShortItems>(d, rank, s, m);
    if (tid == kBins - 1) total -= kSortThreads * m - n;   // the padding
    if (__syncthreads_or(tid < kBins && total == (uint32_t)n)) continue;
    stage<kShortItems>(key, id, d, rank, s, m);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kShortItems; ++j) {
      if (j >= m) break;
      const int i = slot_of(j, m);
      key[j] = s.key[i];
      id[j] = s.idx[i];
    }
    __syncthreads();
  }
}

// Short rows: one block a row, every pass inside it. With m = ceil(n /
// 512) <= 16 keys a thread, the row's key i is held at slot i, its id i
// (the slots past the row: ids from n). At most 64 registers a thread, so
// that two blocks fit an SM.
__global__ void __launch_bounds__(kSortThreads, 2)
    row_sort_short_kernel(NannSelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  RankSmem<kShortItems>& s = *reinterpret_cast<RankSmem<kShortItems>*>(smem);
  const int64_t row = blockIdx.x;
  const int n = (int)a.W;
  const int m = (n + kSortThreads - 1) / kSortThreads;
  const bool is_float = a.is_float != 0;
  const uint32_t* x = static_cast<const uint32_t*>(a.x) + row * n;
  uint32_t key[kShortItems], id[kShortItems];
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = slot_of(j, m);
    key[j] = j < m && i < n ? radix_key(x[i], is_float) : 0;
    id[j] = i;
  }
  block_sort_short(key, id, n, m, (uint32_t)n, s);
  uint32_t* out = static_cast<uint32_t*>(a.out) + row * n;
  int32_t* perm = a.perm ? a.perm + row * n : nullptr;
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = slot_of(j, m);
    if (j < m && i < n) {
      out[i] = value_of(key[j], id[j], x, is_float);
      if (perm) perm[i] = (int32_t)id[j];
    }
  }
}

// Tiled rows, 1: each tile's histograms of all four digits, one shared
// atomic a key and digit (grouping a warp's equal digits by ballots first
// took 3-4 times as long here).
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

// ---------------------------------------------------------------- row_topk

// Candidates a finish block takes: the keys of one short row.
constexpr int kCandidates = kShortRow;

// Where a radix select stands: a key u lies below the k-th when (u & mask)
// < prefix and ties with it when (u & mask) == prefix; `bucket` keys tie and
// the first `need` of them (in index order) are taken.
struct Select {
  uint32_t prefix, mask, need, bucket;
};

// A tiled row's state between kernels ([B, kStateWords] in the scratch).
constexpr int kStateWords = 8;
enum StateWord { kPrefix, kMask, kNeed, kBucket, kDone, kExact };

// The top-k's room in a short or finish block: the short sort's, one
// digit's histogram, the warps' AND and OR of their keys, the warps' counts
// of keys below and tying in the compaction, a scan's warp sums and what
// one thread hands the block.
struct TopkSmem {
  RankSmem<kShortItems> rank;
  uint32_t hist[kBins];
  uint32_t warp_and[kSortWarps];
  uint32_t warp_or[kSortWarps];
  uint32_t warp_less[kSortWarps];
  uint32_t warp_tie[kSortWarps];
  uint32_t warp_sum[kBins / 32];
  uint32_t pick[3];
};

// hist[bin] += 1 for each lane with pred. Every lane of the warp calls it.
// A warp whose counted lanes share one bin (a run of -inf, of equal pads, a
// digit every key shares) adds once; otherwise each lane adds its own, the
// sort's cheaper way on spread digits.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin,
                                         bool pred) {
  const unsigned active = __ballot_sync(kFull, pred);
  if (active == 0) return;
  const int first = __ffs(active) - 1;
  const uint32_t b0 = __shfl_sync(kFull, bin, first);
  if (__all_sync(kFull, !pred || bin == b0)) {
    if ((int)(threadIdx.x & 31) == first) atomicAdd(hist + b0, __popc(active));
  } else if (pred) {
    atomicAdd(hist + bin, 1u);
  }
}

// The bucket of the need-th key of a histogram: threads 0..255 hold their
// digit's count h; the thread whose bucket holds it writes (digit, keys
// below, keys in it) to pick. Every thread calls it; it ends on a barrier.
__device__ __forceinline__ void pick_bucket(uint32_t h, uint32_t need,
                                            uint32_t* warp_sum,
                                            uint32_t* pick) {
  const uint32_t below = scan_bins(h, warp_sum);
  if (threadIdx.x < kBins && below < need && below + h >= need) {
    pick[0] = threadIdx.x;
    pick[1] = below;
    pick[2] = h;
  }
  __syncthreads();
}

// Radix select of the k < n smallest of the n keys a block holds (m a
// thread at slot_of(j, m); slots at or past n hold none), ties to the lower
// slot: the digits of the k-th key from the top. A digit every key shares is
// taken from their AND; each other costs a histogram of the keys that share
// the digits found so far. The select stops when the bucket's keys are all
// taken. Every thread calls it and gets the same result.
__device__ Select block_select(const uint32_t (&u)[kShortItems], int n, int m,
                               int k, TopkSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Select sel{0u, 0u, (uint32_t)k, (uint32_t)n};
  uint32_t all_and = kFull, all_or = 0;
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    if (j >= m) break;
    if (slot_of(j, m) < n) {
      all_and &= u[j];
      all_or |= u[j];
    }
  }
  all_and = __reduce_and_sync(kFull, all_and);
  all_or = __reduce_or_sync(kFull, all_or);
  if (lane == 0) {
    s.warp_and[warp] = all_and;
    s.warp_or[warp] = all_or;
  }
  __syncthreads();
  all_and = kFull;
  all_or = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    all_and &= s.warp_and[w];
    all_or |= s.warp_or[w];
  }
  const uint32_t varies = all_and ^ all_or;
  for (int p = 3; p >= 0; --p) {
    const int shift = 8 * p;
    const uint32_t dmask = (uint32_t)(kBins - 1) << shift;
    sel.mask |= dmask;
    if ((varies & dmask) == 0) {          // every key has this digit
      sel.prefix |= all_and & dmask;
      continue;
    }
    if (tid < kBins) s.hist[tid] = 0;
    __syncthreads();
    const uint32_t before = sel.mask ^ dmask;
#pragma unroll
    for (int j = 0; j < kShortItems; ++j) {
      if (j >= m) break;
      hist_add(s.hist, (u[j] >> shift) & (kBins - 1),
               slot_of(j, m) < n && (u[j] & before) == sel.prefix);
    }
    __syncthreads();
    pick_bucket(tid < kBins ? s.hist[tid] : 0, sel.need, s.warp_sum, s.pick);
    sel.prefix |= s.pick[0] << shift;
    sel.need -= s.pick[1];
    sel.bucket = s.pick[2];
    if (sel.need == sel.bucket) break;    // the bucket is taken whole
  }
  return sel;
}

// The keys sel takes, from the n a block holds, into the stage at base in
// index order: those below the k-th at base + their rank among them, its
// first sel.need ties at base + (k - sel.need) + their rank. The caller puts
// a barrier after it.
__device__ void block_compact(const uint32_t (&u)[kShortItems],
                              const uint32_t (&id)[kShortItems], int n,
                              int m, const Select& sel, int k, int base,
                              TopkSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t n_less = 0, n_tie = 0;
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    if (j >= m) break;
    const bool valid = slot_of(j, m) < n;
    const uint32_t mu = u[j] & sel.mask;
    n_less += __popc(__ballot_sync(kFull, valid && mu < sel.prefix));
    n_tie += __popc(__ballot_sync(kFull, valid && mu == sel.prefix));
  }
  if (lane == 0) {
    s.warp_less[warp] = n_less;
    s.warp_tie[warp] = n_tie;
  }
  __syncthreads();
  uint32_t less_at = base, tie_at = 0;
  for (int w = 0; w < warp; ++w) {
    less_at += s.warp_less[w];
    tie_at += s.warp_tie[w];
  }
  const uint32_t ties_from = base + (uint32_t)k - sel.need;
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    if (j >= m) break;
    const bool valid = slot_of(j, m) < n;
    const uint32_t mu = u[j] & sel.mask;
    const bool less = valid && mu < sel.prefix;
    const bool tie = valid && mu == sel.prefix;
    const unsigned bl = __ballot_sync(kFull, less);
    const unsigned bt = __ballot_sync(kFull, tie);
    const uint32_t r_tie = tie_at + __popc(bt & lanemask_lt());
    const uint32_t pos = less ? less_at + __popc(bl & lanemask_lt())
                              : ties_from + r_tie;
    if (less || (tie && r_tie < sel.need)) {
      s.rank.key[pos] = u[j];
      s.rank.idx[pos] = id[j];
    }
    less_at += __popc(bl);
    tie_at += __popc(bt);
  }
}

// The k winners staged at [0, k) into registers, m = ceil(k / 512) a
// thread at slot_of(j, m); the slots past k get the id kFull, past any
// row's index. The caller puts a barrier before it.
__device__ __forceinline__ void load_stage(const TopkSmem& s, int k, int m,
                                           uint32_t (&key)[kShortItems],
                                           uint32_t (&id)[kShortItems]) {
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = slot_of(j, m);
    if (j < m) {
      key[j] = i < k ? s.rank.key[i] : 0;
      id[j] = i < k ? s.rank.idx[i] : kFull;
    }
  }
}

// Sorts the k winners of a row of W keys that a block holds (m a thread at
// slot_of(j, m); the slots past k with ids of W or more) and writes them:
// values (their bits, from the row x at their index where float) and
// indices. flip undoes the largest's complement. Every thread calls it.
__device__ __forceinline__ void sort_and_write(
    uint32_t (&key)[kShortItems], uint32_t (&id)[kShortItems], int k, int m,
    int W, TopkSmem& s, const uint32_t* x, bool is_float, uint32_t flip,
    uint32_t* out, int32_t* perm) {
  block_sort_short(key, id, k, m, (uint32_t)W, s.rank);
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = slot_of(j, m);
    if (j < m && i < k) {
      out[i] = value_of(key[j] ^ flip, id[j], x, is_float);
      perm[i] = (int32_t)id[j];
    }
  }
}

// Short rows: one block a row holds the row (key i at slot i, its id i),
// selects the k winners, compacts them into the stage and sorts them
// there. k == W is the sort alone.
__global__ void __launch_bounds__(kSortThreads, 2)
    row_topk_short_kernel(NannSelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  TopkSmem& s = *reinterpret_cast<TopkSmem*>(smem);
  const int64_t row = blockIdx.x;
  const int n = (int)a.W, k = (int)a.K;
  int m = (n + kSortThreads - 1) / kSortThreads;
  const bool is_float = a.is_float != 0;
  const uint32_t flip = a.largest ? kFull : 0u;
  const uint32_t* x = static_cast<const uint32_t*>(a.x) + row * n;
  uint32_t u[kShortItems], id[kShortItems];
#pragma unroll
  for (int j = 0; j < kShortItems; ++j) {
    const int i = slot_of(j, m);
    u[j] = j < m && i < n ? radix_key(x[i], is_float) ^ flip : 0;
    id[j] = i;
  }
  if (k < n) {
    const Select sel = block_select(u, n, m, k, s);
    block_compact(u, id, n, m, sel, k, 0, s);
    __syncthreads();
    m = (k + kSortThreads - 1) / kSortThreads;
    load_stage(s, k, m, u, id);
  }
  sort_and_write(u, id, k, m, n, s, x, is_float, flip,
                 static_cast<uint32_t*>(a.out) + row * k, a.perm + row * k);
}

// Where the tiled top-k's pieces lie in the scratch (uint32 words): one
// digit's tile counts [B, tiles, kBins], each tile's keys below the bucket
// and in it [B, tiles] twice, the AND and the OR of each tile's keys that
// share the prefix [B, tiles, 2], the rows' state [B, kStateWords], the certain
// winners' keys and indices [B, K] twice, then for K <= kShortRow the
// candidates' [B, kCandidates] twice, else the sorted winners' keys and
// permutation [B, K] twice and the tiled sort's scratch of [B, K]. Keys in
// the winners and candidates are stored as int32 bits whose order is the
// key's (u ^ kSignBit), as the row sort takes them.
struct TopkPlan {
  const uint32_t* x;
  uint32_t* out;
  int32_t* perm;
  uint32_t* tile_hist;
  uint32_t* tile_less;
  uint32_t* tile_tie;
  uint32_t* tile_andor;
  uint32_t* state;
  uint32_t* win_key;
  uint32_t* win_id;
  uint32_t* cand_key;     // K <= kShortRow
  uint32_t* cand_id;
  uint32_t* sorted;       // K > kShortRow
  int32_t* sorted_perm;
  uint32_t* sort_scratch;
  int64_t W, K;
  int32_t tiles;
  int32_t is_float;
  uint32_t flip;
};

int64_t topk_scratch_words(int64_t B, int64_t W, int64_t K) {
  if (W <= kShortRow) return 0;
  const int64_t tiles = tiles_of(W);
  const int64_t words = B * tiles * kBins + 4 * B * tiles + B * kStateWords
                        + 2 * B * K;
  return words + (K <= kShortRow ? 2 * B * kCandidates
                                 : 2 * B * K + tiled_scratch_words(B, K));
}

TopkPlan topk_plan(const NannSelectArgs& a) {
  TopkPlan p;
  p.x = static_cast<const uint32_t*>(a.x);
  p.out = static_cast<uint32_t*>(a.out);
  p.perm = a.perm;
  p.W = a.W;
  p.K = a.K;
  p.tiles = (int32_t)tiles_of(a.W);
  p.is_float = a.is_float;
  p.flip = a.largest ? kFull : 0u;
  p.tile_hist = a.scratch;
  p.tile_less = p.tile_hist + a.B * p.tiles * kBins;
  p.tile_tie = p.tile_less + a.B * p.tiles;
  p.tile_andor = p.tile_tie + a.B * p.tiles;
  p.state = p.tile_andor + 2 * a.B * p.tiles;
  p.win_key = p.state + a.B * kStateWords;
  p.win_id = p.win_key + a.B * a.K;
  uint32_t* rest = p.win_id + a.B * a.K;
  p.cand_key = p.cand_id = p.sorted = p.sort_scratch = nullptr;
  p.sorted_perm = nullptr;
  if (a.K <= kShortRow) {
    p.cand_key = rest;
    p.cand_id = rest + a.B * kCandidates;
  } else {
    p.sorted = rest;
    p.sorted_perm = reinterpret_cast<int32_t*>(rest + a.B * a.K);
    p.sort_scratch = rest + 2 * a.B * a.K;
  }
  return p;
}

// Tiled rows, 1 (pass p, digit p from the top): the tile's counts of digit
// p among the keys that share the row's prefix, and their AND and OR. A
// done row returns, and so does one whose keys all share digit p; k == W
// selects nothing.
__global__ void __launch_bounds__(kSortThreads)
    row_topk_hist_kernel(TopkPlan a, int p) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_and[kSortWarps], warp_or[kSortWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x, tile = blockIdx.y;
  const int shift = 8 * p;
  uint32_t prefix = 0, mask = 0;
  if (p == 3) {
    if (a.K == a.W) return;
  } else {
    const uint32_t* st = a.state + row * kStateWords;
    prefix = st[kPrefix];
    mask = st[kMask];
    if (st[kDone] || ((mask >> shift) & (kBins - 1))) return;
  }
  if (tid < kBins) hist[tid] = 0;
  __syncthreads();
  const bool is_float = a.is_float != 0;
  const uint32_t* x = a.x + row * a.W;
  uint32_t all_and = kFull, all_or = 0;
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int64_t i = tile * kSortTile + r * kSortThreads + tid;
    const bool valid = i < a.W;
    const uint32_t u = valid ? radix_key(x[i], is_float) ^ a.flip : 0;
    const bool match = valid && (u & mask) == prefix;
    hist_add(hist, (u >> shift) & (kBins - 1), match);
    if (match) {
      all_and &= u;
      all_or |= u;
    }
  }
  all_and = __reduce_and_sync(kFull, all_and);
  all_or = __reduce_or_sync(kFull, all_or);
  if ((tid & 31) == 0) {
    warp_and[tid >> 5] = all_and;
    warp_or[tid >> 5] = all_or;
  }
  __syncthreads();
  const int64_t at = row * a.tiles + tile;
  if (tid < kBins) a.tile_hist[at * kBins + tid] = hist[tid];
  if (tid == 0) {
    for (int w = 0; w < kSortWarps; ++w) {
      all_and &= warp_and[w];
      all_or |= warp_or[w];
    }
    a.tile_andor[at * 2] = all_and;
    a.tile_andor[at * 2 + 1] = all_or;
  }
}

// Tiled rows, 2 (pass p, one block of 256 threads a row): the row's counts
// of digit p (the tiles' summed), the bucket of the k-th key, each tile's
// keys below the bucket (added to the passes before) and in it, and the
// row's new state. Every lower digit that the keys sharing the prefix all
// share (their AND and OR agree there) is taken at once, and its pass
// returns. Pass 3 starts the state; k == W takes every key.
__global__ void __launch_bounds__(kBins) row_topk_plan_kernel(TopkPlan a,
                                                              int p) {
  __shared__ uint32_t warp_sum[kBins / 32];
  __shared__ uint32_t pick[3];
  __shared__ uint32_t warp_and[kBins / 32], warp_or[kBins / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const int tiles = a.tiles;
  uint32_t* st = a.state + row * kStateWords;
  uint32_t* less = a.tile_less + row * tiles;
  uint32_t* tie = a.tile_tie + row * tiles;
  Select sel{0u, 0u, (uint32_t)a.K, (uint32_t)a.W};
  if (p == 3 && a.K == a.W) {
    for (int t = tid; t < tiles; t += kBins) {
      const int64_t left = a.W - (int64_t)t * kSortTile;
      less[t] = 0;
      tie[t] = (uint32_t)(left < kSortTile ? left : kSortTile);
    }
    if (tid == 0) {
      st[kPrefix] = st[kMask] = 0;
      st[kNeed] = st[kBucket] = (uint32_t)a.W;
      st[kDone] = st[kExact] = 1;
    }
    return;
  }
  if (p < 3) {
    if (st[kDone] || ((st[kMask] >> (8 * p)) & (kBins - 1))) return;
    sel = {st[kPrefix], st[kMask], st[kNeed], st[kBucket]};
  }
  // the tiles' AND and OR, loaded beside their counts so that the loads
  // overlap
  const uint32_t* ao = a.tile_andor + row * tiles * 2;
  uint32_t all_and = kFull, all_or = 0;
  for (int t = tid; t < tiles; t += kBins) {
    all_and &= ao[2 * t];
    all_or |= ao[2 * t + 1];
  }
  const uint32_t* h = a.tile_hist + row * tiles * kBins;
  uint32_t total = 0;
  for (int t = 0; t < tiles; ++t) total += h[t * kBins + tid];
  all_and = __reduce_and_sync(kFull, all_and);
  all_or = __reduce_or_sync(kFull, all_or);
  if (lane == 0) {
    warp_and[warp] = all_and;
    warp_or[warp] = all_or;
  }
  pick_bucket(total, sel.need, warp_sum, pick);
  const uint32_t b = pick[0];
  for (int t = warp; t < tiles; t += kBins / 32) {
    uint32_t c = 0;
    for (int d = lane; d < (int)b; d += 32) c += h[t * kBins + d];
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) {
      less[t] = (p == 3 ? 0 : less[t]) + c;
      tie[t] = h[t * kBins + b];
    }
  }
  if (tid == 0) {
    sel.prefix |= b << (8 * p);
    sel.mask |= (uint32_t)(kBins - 1) << (8 * p);
    sel.need -= pick[1];
    sel.bucket = pick[2];
    for (int w = 0; w < kBins / 32; ++w) {
      all_and &= warp_and[w];
      all_or |= warp_or[w];
    }
    const uint32_t varies = all_and ^ all_or;
    for (int q = p - 1; q >= 0; --q) {
      const uint32_t dmask = (uint32_t)(kBins - 1) << (8 * q);
      if ((varies & dmask) == 0) {
        sel.prefix |= all_and & dmask;
        sel.mask |= dmask;
      }
    }
    const bool exact = sel.need == sel.bucket || sel.mask == kFull;
    st[kPrefix] = sel.prefix;
    st[kMask] = sel.mask;
    st[kNeed] = sel.need;
    st[kBucket] = sel.bucket;
    st[kExact] = exact;
    st[kDone] = exact || (a.K <= kShortRow && sel.bucket <= kCandidates);
  }
}

// Tiled rows, 3: the tile's keys below the bucket to the winners, at the
// row's earlier tiles' count of them plus their rank in the tile; the keys
// in the bucket likewise to the candidates, or, in an exact row, the first
// `need` of them to the winners after those below. Thread t holds the
// tile's keys r * 512 + t, r < 8, so index order is (r, warp, lane).
__global__ void __launch_bounds__(kSortThreads)
    row_topk_filter_kernel(TopkPlan a) {
  __shared__ uint32_t cnt[2][kTileItems * kSortWarps];  // below, in bucket
  __shared__ uint32_t base[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x, tile = blockIdx.y;
  const int64_t lo = tile * kSortTile;
  const uint32_t* st = a.state + row * kStateWords;
  const uint32_t prefix = st[kPrefix], mask = st[kMask], need = st[kNeed];
  const bool exact = st[kExact] != 0;
  if (warp == 0) {
    const uint32_t* less = a.tile_less + row * a.tiles;
    const uint32_t* tie = a.tile_tie + row * a.tiles;
    uint32_t bl = 0, bt = 0;
    for (int t = lane; t < tile; t += 32) {
      bl += less[t];
      bt += tie[t];
    }
    bl = __reduce_add_sync(kFull, bl);
    bt = __reduce_add_sync(kFull, bt);
    if (lane == 0) {
      base[0] = bl;
      base[1] = bt;
    }
  }
  const bool is_float = a.is_float != 0;
  const uint32_t* x = a.x + row * a.W;
  uint32_t u[kTileItems];
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int64_t i = lo + r * kSortThreads + tid;
    const bool valid = i < a.W;
    u[r] = valid ? radix_key(x[i], is_float) ^ a.flip : 0;
    const uint32_t mu = u[r] & mask;
    const unsigned bl = __ballot_sync(kFull, valid && mu < prefix);
    const unsigned bt = __ballot_sync(kFull, valid && mu == prefix);
    if (lane == 0) {
      cnt[0][r * kSortWarps + warp] = __popc(bl);
      cnt[1][r * kSortWarps + warp] = __popc(bt);
    }
  }
  __syncthreads();
  if (warp < 2) {            // warp 0 scans the counts below, warp 1 ties
    uint32_t* c = cnt[warp] + lane * 4;
    const uint32_t v0 = c[0], v1 = c[1], v2 = c[2], v3 = c[3];
    const uint32_t sum = v0 + v1 + v2 + v3;
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const uint32_t run = base[warp] + incl - sum;
    c[0] = run;
    c[1] = run + v0;
    c[2] = run + v0 + v1;
    c[3] = run + v0 + v1 + v2;
  }
  __syncthreads();
  const uint32_t n_less = (uint32_t)a.K - need;
  uint32_t* win_key = a.win_key + row * a.K;
  uint32_t* win_id = a.win_id + row * a.K;
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int64_t i = lo + r * kSortThreads + tid;
    const bool valid = i < a.W;
    const uint32_t mu = u[r] & mask;
    const bool is_less = valid && mu < prefix;
    const bool is_tie = valid && mu == prefix;
    const unsigned bl = __ballot_sync(kFull, is_less);
    const unsigned bt = __ballot_sync(kFull, is_tie);
    if (is_less) {
      const uint32_t pos = cnt[0][r * kSortWarps + warp]
                           + __popc(bl & lanemask_lt());
      win_key[pos] = u[r] ^ kSignBit;
      win_id[pos] = (uint32_t)i;
    } else if (is_tie) {
      const uint32_t rt = cnt[1][r * kSortWarps + warp]
                          + __popc(bt & lanemask_lt());
      if (!exact) {
        a.cand_key[row * kCandidates + rt] = u[r] ^ kSignBit;
        a.cand_id[row * kCandidates + rt] = (uint32_t)i;
      } else if (rt < need) {
        win_key[n_less + rt] = u[r] ^ kSignBit;
        win_id[n_less + rt] = (uint32_t)i;
      }
    }
  }
}

// Tiled rows, 4 (K <= kShortRow, one block a row): the candidates' own
// select of the `need` the row still takes, compacted after the certain
// winners, then the short sort of the k winners and the output.
__global__ void __launch_bounds__(kSortThreads, 2)
    row_topk_finish_kernel(TopkPlan a) {
  extern __shared__ __align__(16) unsigned char smem[];
  TopkSmem& s = *reinterpret_cast<TopkSmem*>(smem);
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int k = (int)a.K;
  const uint32_t* st = a.state + row * kStateWords;
  const uint32_t need = st[kNeed];
  const bool exact = st[kExact] != 0;
  const int n_win = exact ? k : k - (int)need;
  if (!exact) {
    const int n = (int)st[kBucket];
    const int m = (n + kSortThreads - 1) / kSortThreads;
    const uint32_t* ck = a.cand_key + row * kCandidates;
    const uint32_t* ci = a.cand_id + row * kCandidates;
    uint32_t u[kShortItems], id[kShortItems];
#pragma unroll
    for (int j = 0; j < kShortItems; ++j) {
      const int i = slot_of(j, m);
      u[j] = id[j] = 0;
      if (j < m && i < n) {
        u[j] = ck[i] ^ kSignBit;
        id[j] = ci[i];
      }
    }
    const Select sel = block_select(u, n, m, (int)need, s);
    block_compact(u, id, n, m, sel, (int)need, n_win, s);
  }
  const uint32_t* wk = a.win_key + row * k;
  const uint32_t* wi = a.win_id + row * k;
  for (int i = tid; i < n_win; i += kSortThreads) {
    s.rank.key[i] = wk[i] ^ kSignBit;
    s.rank.idx[i] = wi[i];
  }
  __syncthreads();
  const int m = (k + kSortThreads - 1) / kSortThreads;
  uint32_t key[kShortItems], id[kShortItems];
  load_stage(s, k, m, key, id);
  sort_and_write(key, id, k, m, (int)a.W, s, a.x + row * a.W,
                 a.is_float != 0, a.flip, a.out + row * k, a.perm + row * k);
}

// Tiled rows, 4 (K > kShortRow, after the row sort of the winners' keys):
// each output slot's index through the sort's permutation, its value from
// its key (int32) or from x (float32).
__global__ void __launch_bounds__(kSortThreads)
    row_topk_gather_kernel(TopkPlan a, int64_t total) {
  const int64_t g = (int64_t)blockIdx.x * kSortThreads + threadIdx.x;
  if (g >= total) return;
  const int64_t row = g / a.K;
  const uint32_t id = a.win_id[row * a.K + a.sorted_perm[g]];
  a.out[g] = value_of((a.sorted[g] ^ kSignBit) ^ a.flip, id, a.x + row * a.W,
                      a.is_float != 0);
  a.perm[g] = (int32_t)id;
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
      {(const void*)row_sort_short_kernel, sizeof(RankSmem<kShortItems>)},
      {(const void*)row_sort_downsweep_kernel, sizeof(RankSmem<kTileItems>)},
      {(const void*)row_topk_short_kernel, sizeof(TopkSmem)},
      {(const void*)row_topk_finish_kernel, sizeof(TopkSmem)}};
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

// row_topk: rows of up to kShortRow keys take one block a row and no
// scratch; wider rows need scratch_words of topk_scratch_words(B, W, K) and
// launch a histogram and a plan kernel for each digit, the filter, and the
// finish (K <= kShortRow) or the tiled row sort of the winners and the
// gather.
int nann_row_topk(const NannSelectArgs* a, void* stream) {
  if (a->B == 0 || a->K == 0) return 0;
  if (!row_fits(a->W) || a->K > a->W || a->B > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->W <= kShortRow) {
    row_topk_short_kernel<<<(unsigned)a->B, kSortThreads, sizeof(TopkSmem),
                            st>>>(*a);
    return (int)cudaGetLastError();
  }
  if (a->scratch == nullptr ||
      a->scratch_words < topk_scratch_words(a->B, a->W, a->K) ||
      tiles_of(a->W) > 65535)
    return (int)cudaErrorInvalidValue;
  const TopkPlan plan = topk_plan(*a);
  const dim3 grid((unsigned)a->B, (unsigned)plan.tiles);
  cudaError_t err;
  for (int p = 3; p >= 0; --p) {
    row_topk_hist_kernel<<<grid, kSortThreads, 0, st>>>(plan, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    row_topk_plan_kernel<<<(unsigned)a->B, kBins, 0, st>>>(plan, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  row_topk_filter_kernel<<<grid, kSortThreads, 0, st>>>(plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a->K <= kShortRow) {
    row_topk_finish_kernel<<<(unsigned)a->B, kSortThreads, sizeof(TopkSmem),
                             st>>>(plan);
    return (int)cudaGetLastError();
  }
  NannSelectArgs sort{};
  sort.x = plan.win_key;
  sort.out = plan.sorted;
  sort.perm = plan.sorted_perm;
  sort.scratch = plan.sort_scratch;
  sort.B = a->B;
  sort.W = a->K;
  sort.scratch_words = tiled_scratch_words(a->B, a->K);
  if ((err = (cudaError_t)nann_row_sort(&sort, stream)) != cudaSuccess)
    return (int)err;
  const int64_t total = a->B * a->K;
  row_topk_gather_kernel<<<(unsigned)((total + kSortThreads - 1)
                                      / kSortThreads),
                           kSortThreads, 0, st>>>(plan, total);
  return (int)cudaGetLastError();
}

// The tiled paths' scratch in uint32 words, as the wrapper sizes it.
int64_t nann_row_sort_scratch_words(int64_t B, int64_t W) {
  return tiled_scratch_words(B, W);
}

int64_t nann_row_topk_scratch_words(int64_t B, int64_t W, int64_t K) {
  return topk_scratch_words(B, W, K);
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
