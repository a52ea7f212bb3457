// Gathers and scatters of the visited backends and the search's lane
// gathers, for NVIDIA Hopper (sm_90a).
//
// Replaces the Mosaic probe kernels of scripts/probe_kernel_ops.py, which
// compiled the primitives of a fused per-hop filter on the TPU; here they are
// the touchpoints of the byte-map backend (nann_tpu/search/beam.py:250-323):
//
//   gather_elems  out[b, j] = table[b?, clip(ids[b, j], 0, hi)]
//                 build_gather_flat (:173, pallas_call :178),
//                 build_gather_2d (:247, :255), which computes the same
//                 function as a row gather then a lane select, and
//                 build_take_along (:186, :190), take_along_axis within
//                 rows: a per-query table with hi = W - 1. The search uses
//                 it for `vis_unvisited` (uint8 epoch stamps, one row per
//                 query, hi = n), `take_ids` (int32 item ids, one row shared
//                 by the batch, hi = n - 1) and the id and key gathers behind
//                 its top-ks (int32, one row per query, hi = W - 1).
//   gather_rows   out[r, :] = table[clip(ids[r], 0, N - 1), :]
//                 build_gather_rows (:233, :239): `take_rows` of the
//                 neighbour table [N, deg].
//   scatter_set   table[b?, ids[b, j]] = value, in place
//                 build_scatter (:198, :204): `vis_mark` and
//                 `vis_reset_mark`, epoch stamps into [B, n + trash] uint8.
//                 Ids outside [0, n_cols) are dropped, as a JAX scatter drops
//                 them. The search's ids are unique (`_pad_trash` sends masked
//                 positions to distinct trash slots); where they are not,
//                 every writer stores the same value, so the result is still
//                 defined. No atomics.
//
// Bound on an H100: each is pure data movement, a few integer operations per
// element, so its least time is the bytes it must move over 3.35 TB/s: the
// ids read once, each distinct element gathered (or written) once, the output
// written once. A random access of one element still moves a 32-byte sector
// between L2 and the SM, so a gather in random order moves 8x (int32) to 32x
// (uint8) the bytes it keeps, and a scatter writes part of a sector per id.
//
// Design. `plan` picks one of two paths for gather_elems from the types and
// shapes alone (mirrored by `_visited_plan` in kernels/visited_ops.py);
// scatter_set always takes the first:
//
//   global  every shape. A 2-D grid, blockIdx.y the query row, so a row's
//           base needs no division; at most kGatherWaves (kScatterWaves)
//           resident waves of kThreads-thread blocks, the SM count read from
//           the device. Thread t of a row takes ids t, t + step, ..., so a
//           warp touches neighbouring ids: in the search's sorted order,
//           neighbouring elements. A scatter's thread has kUnroll ids in
//           flight; a gather's, where every thread has 4 ids, takes them 4 at
//           a time with one 16-byte load and stores 4 elements at once
//           (uchar4 / int4), with a scalar head and tail.
//   staged  a gather of int32 rows, one per query, small against its ids (the
//           wide hop's neighbour gather): one block a row stages the row's
//           span [0, hi] and its ids in shared memory with Hopper bulk copies
//           (cp.async.bulk global->shared, completed on an mbarrier; the
//           bytes before the first 16-byte boundary and after the last go by
//           plain loads), then serves every id from there: the row crosses
//           once instead of a sector an id.
//
// Measured and dropped (PERF.md §6): the staged path for the uint8
// byte-map (it loses at the search's sorted order, which has the same shapes
// as the wide hop's unsorted one), a staged scatter with a bulk write-back
// (it wins at random order only), a cluster of two blocks a row reading the
// partner's half through distributed shared memory (slower than one block),
// 4-wide ids for the scatter and for small gathers (more sectors per store
// instruction, fewer SMs).
//
// The row gather runs one warp per row; every lane loads the row's id (one
// broadcast), then the lanes copy the row with loads of 4, 8 or 16 bytes,
// picked so that the row fills the warp where it can (deg 32: 4 bytes,
// deg 64: 8 bytes, deg 128: 16 bytes).
//
// Dynamic shared memory above 48 KB is opted in once per device
// (nann_visited_init), which also records the device's SM count.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC   (plain C interface, loaded by ctypes)

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// One argument struct for the three entry points; mirrored field for field by
// `VisitedArgs` in nann_tpu_torch/kernels/visited_ops.py. Outside the unnamed
// namespace so the exported functions can name it.
struct NannVisitedArgs {
  void* table;          // gather: the source; scatter: written in place
  const int32_t* ids;   // [B, M]
  void* out;            // gathers: [B, M] or [B * M, width]; scatter: unused
  int64_t B;            // rows of ids
  int64_t M;            // ids per row
  int64_t row_stride;   // table elements between query rows; 0 = one shared row
  int64_t n_cols;       // scatter: ids in [0, n_cols) are written
  int64_t hi;           // gathers: ids are clipped to [0, hi]
  int64_t width;        // gather_rows: int32 elements per table row
  uint32_t value;       // scatter: the value stored
  int32_t elem_size;    // bytes per table element: 1 (uint8) or 4 (int32)
};

namespace {

constexpr int kThreads = 256;             // a block of the global path
constexpr int kWaveBlocksPerSm = 8;       // 2,048 threads an SM / kThreads
constexpr int kGatherWaves = 1;           // global grid, resident waves: gather
constexpr int kScatterWaves = 2;          // and scatter
constexpr int kUnroll = 4;                // ids a scatter thread has in flight
constexpr int kRowWaves = 2;              // gather_rows: two waves at most
constexpr int kStageThreads = 1024;       // a block of the staged path
constexpr int64_t kStageCost = 12;        // staged: see `plan`
constexpr int64_t kStageMinIds = 1 << 18; // staged: B x M at least
constexpr int64_t kBlockSmem = 232448;    // dynamic shared memory a block
constexpr int64_t kBarrierBytes = 16;     // the mbarrier, padded
constexpr int64_t kMaxGridY = 65535;
constexpr int kMaxDevices = 64;
constexpr uint32_t kBulkChunk = 32768;    // bytes a bulk copy instruction

int g_sms[kMaxDevices];                   // SM count, set by nann_visited_init

enum Path { kGlobal = 0, kStaged = 1 };

struct Plan {
  int path;
  int64_t gx, gy;
  int threads;
  int64_t smem;
};

__host__ __device__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Bytes a staged copy of `bytes` takes in shared memory: it sits at the
// offset its global address has within 16 bytes, so that the bulk copy's
// both ends are aligned.
__host__ __device__ int64_t staged_bytes(int64_t bytes) {
  return ceil_div(bytes, 16) * 16 + 16;
}

// The launch of an element kernel, from the types and shapes alone.
//
// Staged: a gather of int32 rows, one per query, of at most one row an SM
// (one wave of staged blocks) and at least kStageMinIds ids in all, whose
// span [0, hi] and ids fit a block's shared memory beside the mbarrier, and
// where (span + M) x kStageCost <= B x M: a staged block moves its span and
// its ids through one SM, the global path a 32-byte sector and an id for
// each of the B x M ids over all the SMs. The constants are where the two
// paths met on an H100 (PERF.md §6): below kStageMinIds ids the staged
// blocks' longer fixed latency (copy, wait, then gather) loses, and three
// waves of them lost where one did not. On 132 SMs a staged row has at least
// 1,986 ids, two for most of the block's kStageThreads threads.
// Global: a grid of at most kGatherWaves (kScatterWaves) resident waves, and
// no more blocks a row than its ids fill at one a thread.
Plan plan(const NannVisitedArgs& a, bool scatter, int sms) {
  if (!scatter && a.elem_size == 4 && a.row_stride != 0 && a.B <= sms &&
      a.B * a.M >= kStageMinIds &&
      (a.hi + 1 + a.M) * kStageCost <= a.B * a.M) {
    const int64_t smem = kBarrierBytes + staged_bytes((a.hi + 1) * 4) +
                         staged_bytes(a.M * 4);
    if (smem <= kBlockSmem) return {kStaged, 1, a.B, kStageThreads, smem};
  }
  const int64_t gy = a.B < kMaxGridY ? a.B : kMaxGridY;
  const int64_t per_row = ceil_div(a.M, kThreads);
  const int64_t grid_waves = scatter ? kScatterWaves : kGatherWaves;
  const int64_t most =
      ceil_div((int64_t)sms * kWaveBlocksPerSm * grid_waves, gy);
  const int64_t gx = most < per_row ? most : per_row;
  return {kGlobal, gx > 0 ? gx : 1, gy, kThreads, 0};
}

__device__ __forceinline__ int64_t clip(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

template <typename T> struct Quad;
template <> struct Quad<uint8_t> {
  using type = uchar4;
};
template <> struct Quad<int32_t> {
  using type = int4;
};

// ----------------------------------------------------------- global path

// Thread t of a row's step = gridDim.x * blockDim.x threads takes ids
// t, t + step, ..., so that a warp's loads and stores go to neighbouring ids:
// in the search's sorted order, neighbouring elements. Where every thread
// has 4 ids and the ids and out start on 16 bytes (`vec`), a thread takes 4
// neighbouring ids at a time instead, with one 16-byte load, and stores
// their 4 elements at once; then the 4 elements often share a sector. A row
// of ids starts at b * M, so its first (-b * M) & 3 ids come before its
// first 16-byte boundary; they, and the ids after the last whole quad, go
// one by one.
template <typename T>
__global__ void __launch_bounds__(kThreads, kWaveBlocksPerSm)
gather_elems_kernel(const T* __restrict__ table,
                    const int32_t* __restrict__ ids, T* __restrict__ out,
                    int64_t B, int64_t M, int64_t row_stride, int64_t hi,
                    bool vec) {
  using Q = typename Quad<T>::type;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* trow = table + b * row_stride;
    const int32_t* irow = ids + b * M;
    T* orow = out + b * M;
    if (vec) {
      const int64_t head = (-(b * M)) & 3;
      const int64_t quads = (M - head) >> 2;
      if (t0 < head) orow[t0] = __ldg(trow + clip(irow[t0], hi));
      const int64_t j = head + 4 * quads + t0;
      if (j < M) orow[j] = __ldg(trow + clip(irow[j], hi));
      const int4* iq = reinterpret_cast<const int4*>(irow + head);
      Q* oq = reinterpret_cast<Q*>(orow + head);
      for (int64_t q = t0; q < quads; q += step) {
        const int4 v = __ldg(iq + q);
        Q o;
        o.x = __ldg(trow + clip(v.x, hi));
        o.y = __ldg(trow + clip(v.y, hi));
        o.z = __ldg(trow + clip(v.z, hi));
        o.w = __ldg(trow + clip(v.w, hi));
        oq[q] = o;
      }
      continue;
    }
    for (int64_t j = t0; j < M; j += step)
      orow[j] = __ldg(trow + clip(__ldg(irow + j), hi));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kWaveBlocksPerSm)
scatter_set_kernel(T* __restrict__ table, const int32_t* __restrict__ ids,
                   int64_t B, int64_t M, int64_t row_stride, int64_t n_cols,
                   T value) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    T* trow = table + b * row_stride;
    const int32_t* irow = ids + b * M;
    for (int64_t j = t0; j < M; j += kUnroll * step) {
      int32_t v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        v[k] = j + k * step < M ? __ldg(irow + j + k * step) : -1;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (v[k] >= 0 && v[k] < n_cols) trow[v[k]] = value;
    }
  }
}

// ----------------------------------------------------------- staged path

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Arrive once, expecting `bytes` of bulk copies (0: the phase completes).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A staged copy of `bytes` global bytes at `g`: `pad` is g's offset within
// 16 bytes (the copy's byte i sits at buf + pad + i), `head` the bytes before
// g's first 16-byte boundary, `body` the whole 16-byte units after them; the
// head and the tail after the body go by plain loads and stores.
struct Staged {
  unsigned char* g;
  unsigned char* buf;
  int64_t bytes, head, body;
  int pad;
};

__device__ __forceinline__ Staged staged(void* g, unsigned char* buf,
                                         int64_t bytes) {
  Staged c;
  c.g = static_cast<unsigned char*>(g);
  c.buf = buf;
  c.bytes = bytes;
  c.pad = (int)(reinterpret_cast<uintptr_t>(g) & 15);
  const int64_t to16 = (16 - c.pad) & 15;
  c.head = to16 < bytes ? to16 : bytes;
  c.body = (bytes - c.head) & ~(int64_t)15;
  return c;
}

// One thread: the body's bulk copies, completed on `bar`.
__device__ __forceinline__ void bulk_in(const Staged& c, uint64_t* bar) {
  for (int64_t off = 0; off < c.body; off += kBulkChunk) {
    const int64_t left = c.body - off;
    bulk_load(c.buf + c.pad + c.head + off, c.g + c.head + off,
              (uint32_t)(left < kBulkChunk ? left : kBulkChunk), bar);
  }
}

// Every thread: its share of the head's and tail's bytes.
__device__ __forceinline__ void copy_edges(const Staged& c) {
  const int64_t n = c.bytes - c.body;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t off = i < c.head ? i : i + c.body;
    c.buf[c.pad + off] = c.g[off];
  }
}

// One block a query row: the row's span [0, hi] and its ids are staged in
// shared memory by bulk copies, then every id is served from there.
template <typename T>
__global__ void __launch_bounds__(kStageThreads, 1)
gather_elems_staged_kernel(const T* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           T* __restrict__ out, int64_t M, int64_t row_stride,
                           int64_t hi) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int64_t b = blockIdx.y;
  const Staged row = staged(const_cast<T*>(table + b * row_stride),
                            smem + kBarrierBytes, (hi + 1) * (int64_t)sizeof(T));
  const Staged idr = staged(const_cast<int32_t*>(ids + b * M),
                            row.buf + staged_bytes(row.bytes), M * 4);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_arrive_expect(bar, (uint32_t)(row.body + idr.body));
    bulk_in(row, bar);
    bulk_in(idr, bar);
  }
  copy_edges(row);
  copy_edges(idr);
  __syncthreads();            // the barrier is initialised, the edges copied
  mbar_wait(bar, 0);
  const T* srow = reinterpret_cast<const T*>(row.buf + row.pad);
  const int32_t* sids = reinterpret_cast<const int32_t*>(idr.buf + idr.pad);
  T* orow = out + b * M;
#pragma unroll 4
  for (int64_t j = threadIdx.x; j < M; j += blockDim.x)
    orow[j] = srow[clip(sids[j], hi)];
}

// ---------------------------------------------------------------- row gather

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table,
                   const int32_t* __restrict__ ids, V* __restrict__ out,
                   int64_t rows, int64_t hi, int vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < rows; r += warps) {
    const V* src = table + clip(ids[r], hi) * vecs_per_row;
    V* dst = out + r * vecs_per_row;
    for (int c = lane; c < vecs_per_row; c += 32) dst[c] = __ldg(src + c);
  }
}

// ------------------------------------------------------------------ launches

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int current_sms() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  return g_sms[dev];
}

template <typename T>
int launch_gather_elems(const NannVisitedArgs& a, cudaStream_t s) {
  const Plan p = plan(a, false, current_sms());
  const dim3 grid((unsigned)p.gx, (unsigned)p.gy);
  if (p.path == kStaged) {   // int32 rows only
    gather_elems_staged_kernel<int32_t><<<grid, p.threads, p.smem, s>>>(
        static_cast<const int32_t*>(a.table), a.ids,
        static_cast<int32_t*>(a.out), a.M, a.row_stride, a.hi);
  } else {
    const bool vec = a.M >= 4 * p.gx * kThreads && aligned(a.ids, 16) &&
                     aligned(a.out, 4 * sizeof(T));
    gather_elems_kernel<T><<<grid, p.threads, 0, s>>>(
        static_cast<const T*>(a.table), a.ids, static_cast<T*>(a.out), a.B,
        a.M, a.row_stride, a.hi, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter_set(const NannVisitedArgs& a, cudaStream_t s) {
  const Plan p = plan(a, true, current_sms());
  scatter_set_kernel<T><<<dim3((unsigned)p.gx, (unsigned)p.gy), p.threads, 0,
                          s>>>(
      static_cast<T*>(a.table), a.ids, a.B, a.M, a.row_stride, a.n_cols,
      static_cast<T>(a.value));
  return (int)cudaGetLastError();
}

template <typename V>
int launch_gather_rows(const NannVisitedArgs& a, cudaStream_t s) {
  const int64_t rows = a.B * a.M;
  const int vecs = (int)(a.width * 4 / sizeof(V));
  const int64_t most = (int64_t)current_sms() * kWaveBlocksPerSm * kRowWaves;
  const int64_t need = ceil_div(rows * 32, kThreads);
  const int64_t blocks = need < most ? need : most;
  gather_rows_kernel<V><<<(unsigned)(blocks > 0 ? blocks : 1), kThreads, 0,
                          s>>>(
      static_cast<const V*>(a.table), a.ids, static_cast<V*>(a.out), rows,
      a.hi, vecs);
  return (int)cudaGetLastError();
}

// The kernel of a plan, for the occupancy calculator.
const void* kernel_of(const Plan& p, bool scatter, int elem_size) {
  const bool u8 = elem_size == 1;
  if (scatter)
    return u8 ? (const void*)scatter_set_kernel<uint8_t>
              : (const void*)scatter_set_kernel<int32_t>;
  if (p.path == kStaged) return (const void*)gather_elems_staged_kernel<int32_t>;
  return u8 ? (const void*)gather_elems_kernel<uint8_t>
            : (const void*)gather_elems_kernel<int32_t>;
}

bool known(const NannVisitedArgs* a) {
  return a->elem_size == 1 || a->elem_size == 4;
}

}  // namespace

extern "C" {

// Opt the staged kernels in to a block's whole shared memory and record the
// SM count, on the current device; call once per device before launching.
// Returns a CUDA error (0 = ok).
int nann_visited_init(void) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      (const void*)gather_elems_staged_kernel<int32_t>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBlockSmem);
}

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok); an unknown element size returns cudaErrorInvalidValue, a device
// that nann_visited_init has not seen cudaErrorInitializationError.

int nann_gather_elems(const NannVisitedArgs* a, void* stream) {
  if (a->B * a->M == 0) return 0;
  if (!known(a)) return (int)cudaErrorInvalidValue;
  if (current_sms() <= 0) return (int)cudaErrorInitializationError;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->elem_size == 1) return launch_gather_elems<uint8_t>(*a, s);
  return launch_gather_elems<int32_t>(*a, s);
}

int nann_gather_rows(const NannVisitedArgs* a, void* stream) {
  if (a->B * a->M == 0 || a->width == 0) return 0;
  if (a->elem_size != 4) return (int)cudaErrorInvalidValue;
  if (current_sms() <= 0) return (int)cudaErrorInitializationError;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest load that divides the row and both pointers allow, and that
  // still gives every lane of the warp a piece of the row
  const int64_t row_bytes = a->width * 4;
  if (row_bytes % 16 == 0 && row_bytes / 16 >= 32 && aligned(a->table, 16) &&
      aligned(a->out, 16))
    return launch_gather_rows<int4>(*a, s);
  if (row_bytes % 8 == 0 && row_bytes / 8 >= 32 && aligned(a->table, 8) &&
      aligned(a->out, 8))
    return launch_gather_rows<int2>(*a, s);
  return launch_gather_rows<int32_t>(*a, s);
}

int nann_scatter_set(const NannVisitedArgs* a, void* stream) {
  if (a->B * a->M == 0) return 0;
  if (!known(a)) return (int)cudaErrorInvalidValue;
  if (current_sms() <= 0) return (int)cudaErrorInitializationError;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->elem_size == 1) return launch_scatter_set<uint8_t>(*a, s);
  return launch_scatter_set<int32_t>(*a, s);
}

// The plan of an element kernel (scatter = 0: gather_elems, 1: scatter_set)
// for these arguments on a device of `sms` SMs: path (0 global, 1 staged),
// grid, threads a block and bytes of dynamic shared memory.
void nann_visited_plan(const NannVisitedArgs* a, int scatter, int sms,
                       int* path, int64_t* grid_x, int64_t* grid_y,
                       int* threads, int64_t* smem) {
  const Plan p = plan(*a, scatter != 0, sms);
  *path = p.path;
  *grid_x = p.gx;
  *grid_y = p.gy;
  *threads = p.threads;
  *smem = p.smem;
}

// The SM count nann_visited_init recorded for the current device (0: none).
int nann_visited_sms(void) { return current_sms(); }

// Blocks of the plan's kernel that fit one SM of the current device at once,
// after nann_visited_init; a negative number is a CUDA error.
int nann_visited_blocks_per_sm(const NannVisitedArgs* a, int scatter) {
  if (!known(a)) return -(int)cudaErrorInvalidValue;
  const Plan p = plan(*a, scatter != 0, current_sms());
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of(p, scatter != 0, a->elem_size), p.threads, p.smem);
  return err == cudaSuccess ? n : -(int)err;
}

// The struct's size and its last field's offset, held against VisitedArgs
// when the library is loaded.
size_t nann_visited_args_size(void) { return sizeof(NannVisitedArgs); }
size_t nann_visited_args_elem_size_offset(void) {
  return offsetof(NannVisitedArgs, elem_size);
}

const char* nann_visited_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
