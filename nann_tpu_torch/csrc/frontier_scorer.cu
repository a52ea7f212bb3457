// Frontier scorer for NVIDIA Hopper (sm_90a): gather + folded NANN scorer.
//
// Replaces the TPU kernels built by `make_pallas_frontier_scorer`
// (nann_tpu/experimental/pallas_scorer.py, pallas_call at :159):
// `_score_kernel` (:47-81) on rows of the compute type T, and
// `_score_kernel_int8` (:84-89, dequantization at :52-56) on a packed int8
// table. It also does the row gather that the Pallas kernels leave to XLA
// (nann_tpu/search/beam.py:460). For every (query b, frontier row f) it
// computes, from the item row e = table[clip(ids[b,f])]:
//
//   q   = PReLU(e @ q1_k + q1_b) @ q2_k + q2_b
//   w   = softmax(q @ k_proj[b]^T / sqrt(DK))     over exactly L keys
//   x   = [w @ v[b], e]
//   x   = PReLU(x @ h_k * h_s + h_t)               for h1, h2, h3
//   out = (x @ h4_k) * h4_s + h4_t                 (-inf where !valid[b,f])
//
// with the rounding points of the plain version
// (nann_tpu_torch/ops/scorer_kernel.py: score_frontier_reference): each
// layer's output and the softmax weights are rounded to the compute type T,
// sums are float32, and attention runs over exactly L keys.
//
// Storage is the second template axis. A packed int8 row (index/quantize.py)
// is D int8 values followed by the row's float32 scale s in bytes D..D+3,
// D + 4 bytes in all (68 at D = 64, against 128 for a bf16 row), and
// e[c] = round_T(float(q[c]) * s): one float32 product, one rounding, as
// `dequantize_rows` does, never fused into the first layer. Rows are read as
// char4 and the scale as one aligned 4-byte load (D % 4 == 0 and a 4-byte
// aligned table, checked on the host).
//
// Bound on an H100: per scored row the chain is about
// 2*(64*128 + 128*256 + 256*L + L*64 + 128*128 + 128*64 + 64*32 + 32)
// = 167 kFLOP at L = 50, against 128 bytes of bf16 row (68 packed int8) plus
// 9 bytes of id, mask and score: over 1,200 FLOP per byte, far above the
// card's ~295 FLOP/byte balance point, so the work is bound by operations:
// FLOPs / 989 TFLOP/s on the bf16 tensor cores, FLOPs / 67 TFLOP/s for
// float32 on the CUDA cores.
//
// Design. A block scores R rows of one query; every block first reads its
// rows' valid bits and, when none is set, writes -inf and returns: the
// search puts a hop's valid rows first and its padding after them, so the
// padding is whole blocks at each query's tail (the level-1 hop fills about
// 1,516 of 2,880 slots). A row's sums run in a fixed order, with no atomics
// and tile shapes that depend only on the widths, so a row's score depends
// only on its row, its query and the weights, never on B, F or its
// neighbours. The two compute types take two bodies:
//
// - bfloat16 (the serving type): every product of the chain on the tensor
//   cores, mma.sync.m16n8k16 bf16 -> f32 with operands from ldmatrix. R = 128
//   rows and 8 warps; a warp owns 16 rows through the whole chain, so the
//   activations pass between layers through the warp's own rows of shared
//   memory (bf16, which is where the plain version rounds), or stay in
//   registers: the q-projection is made 32 columns at a time and fed at once
//   to the logits q @ k^T, which accumulate in registers over the columns of
//   q; the softmax runs on the logit fragments (a row's 64 lanes padded from
//   L and masked to -inf, as the Pallas kernel masks its padded lanes), and
//   its weights become the A fragments of w @ v without leaving registers.
//   Each layer's epilogue adds the bias (or the folded BN scale and shift),
//   applies PReLU and rounds to bf16. The weights (135 KB in bf16) do not fit
//   beside the activations of two blocks, so they are staged 32 columns at a
//   time into a double buffer by cp.async, one chunk in flight while the
//   warps multiply the previous one; every warp reads the whole chunk, so
//   each weight byte crosses from L2 once per 128 rows. A chunk of q2 brings
//   the same 32 columns of the query's keys k_proj[b] ([L, DK]; their layout
//   is the B fragment's, read by ldmatrix), so the keys too cross once per
//   block, not once per warp (read per warp from global memory they cost
//   37%: 0.69 against 0.50 ms at [64, 4096], scripts/bench_scorer.py on an
//   H100 80GB HBM3 at 700 W). The values are staged once. At the
//   serving width a block takes 111,104 bytes of dynamic shared memory: two
//   blocks (16 warps) an SM. Widths that are not multiples of 16 are padded
//   with zeros in shared memory (activations, staged weight rows and keys
//   alike). Wider models take fewer rows a block (64, 32, 16) where 128
//   would not fit (`plan_bf16`, mirrored by `_scorer_plan` in
//   kernels/frontier_scorer.py).
// - float32: on the CUDA cores (TF32 would break float32's tolerance).
//   R = 32 rows and 8 warps; activations in float32 in shared memory, each
//   buffer as wide as the layers it holds; a thread owns two adjacent
//   columns of 16 rows, so a float4 of activations feeds eight FMAs; the
//   query's keys are staged only after q2, into the space q1 used, and its
//   values are read through L1: 107,336 bytes at the serving width, two
//   blocks an SM.
//
// Shared memory is opted in once per device (nann_scorer_init), not on
// every launch.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC   (plain C interface, loaded by ctypes)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// Mirrors FrontierScorerArgs in nann_tpu_torch/kernels/frontier_scorer.py.
// Declared outside the unnamed namespace: the exported C functions take it,
// and a parameter type with internal linkage would hide them from dlsym.
struct NannScorerArgs {
  const int32_t* ids;    // [B, F]
  const uint8_t* valid;  // [B, F] (bool)
  const void* table;     // [n_rows, D] of T, or packed int8 [n_rows, D+4]
  const void* k_proj;    // [B, L, DK], type T
  const void* v;         // [B, L, DU], type T
  const void* q1_k;      // [D, H1], type T
  const float* q1_b;
  const float* q1_a;
  const void* q2_k;      // [H1, DK], type T
  const float* q2_b;
  const void* h1_k;      // [DU + D, G1], type T
  const float* h1_s;
  const float* h1_t;
  const float* h1_a;
  const void* h2_k;      // [G1, G2]
  const float* h2_s;
  const float* h2_t;
  const float* h2_a;
  const void* h3_k;      // [G2, G3]
  const float* h3_s;
  const float* h3_t;
  const float* h3_a;
  const void* h4_k;      // [G3, 1]
  const float* h4_s;
  const float* h4_t;
  float* out;            // [B, F]
  int64_t n_rows;
  int B, F, L, D, H1, DK, DU, G1, G2, G3;
  int dtype;             // compute type T: 0 = float32, 1 = bfloat16
  int storage;           // 0 = rows of T, 1 = packed int8 rows
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // the float32 body's block
constexpr int kRowsF32 = 32;         // rows a float32 block scores
constexpr int kRowsBf16 = 128;       // rows a bf16 block scores at most
constexpr int kChunk = 32;           // weight columns staged at a time
constexpr int kPad = 8;              // bf16 elements (16 bytes) a row pads
constexpr int kMaxSeq = 64;          // L <= kMaxSeq: 8 key tiles of 8
constexpr size_t kBlockSmem = 232448;   // dynamic shared memory a block
constexpr size_t kSmSmem = 233472;      // shared memory an SM
constexpr size_t kReserved = 1024;      // the runtime's own, a block

// ----------------------------------------------------------------- plans

__host__ __device__ inline int ru16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The bf16 body's shared memory for `rows` rows (bytes), as byte offsets:
// the rows' table offsets (int64) and scales (float), then, in bf16,
// X [rows][xw] (e and the attention output; later h2), P [rows][pw] (q1,
// h1, h3), the values V [lp][vw] and two chunk buffers, each a weight chunk
// [kmax][kChunk+kPad] and, for q2's chunks, the keys' matching columns
// [lp][kChunk+kPad].
// Every row stride is an odd multiple of 16 bytes, so the eight rows an
// ldmatrix reads fall in eight different bank groups.
struct Bf16Plan {
  int dp, dup, xk, h1p, g1p, g2p, lp;  // widths padded to 16
  int xw, pw, vw, kmax, ws;             // row strides, weight chunk rows
  size_t x_off, p_off, v_off, w_off, bytes;
};

__host__ __device__ inline Bf16Plan plan_bf16(const NannScorerArgs& a,
                                              int rows) {
  Bf16Plan p;
  p.dp = ru16(a.D);
  p.dup = ru16(a.DU);
  p.xk = p.dup + p.dp;
  p.h1p = ru16(a.H1);
  p.g1p = ru16(a.G1);
  p.g2p = ru16(a.G2);
  p.lp = ru16(a.L);
  p.xw = imax(p.xk, p.g2p) + kPad;
  p.pw = imax(imax(p.h1p, p.g1p), ru16(a.G3)) + kPad;
  p.vw = p.dup + kPad;
  p.kmax = imax(imax(p.dp, p.h1p), imax(p.xk, imax(p.g1p, p.g2p)));
  p.ws = kChunk + kPad;
  p.x_off = (size_t)rows * 12;
  p.p_off = p.x_off + (size_t)rows * p.xw * 2;
  p.v_off = p.p_off + (size_t)rows * p.pw * 2;
  p.w_off = p.v_off + (size_t)p.lp * p.vw * 2;
  p.bytes = p.w_off + (size_t)2 * (p.kmax + p.lp) * p.ws * 2;
  return p;
}

// The float32 body's shared memory (bytes), as float offsets after the
// rows' table offsets and scales: X [32][DU+D], Q [32][max(DK, G2)] and U,
// which holds q1 [32][H1], then the keys [L][DK+1] and the softmax weights
// [32][L], then h1 and h3 [32][max(G1, G3)].
struct F32Plan {
  int xw, qw, pw;
  size_t x_off, q_off, u_off, bytes;
};

__host__ __device__ inline F32Plan plan_f32(const NannScorerArgs& a) {
  F32Plan p;
  p.xw = a.DU + a.D;
  p.qw = imax(a.DK, a.G2);
  p.pw = imax(a.G1, a.G3);
  const int u = imax(imax(kRowsF32 * a.H1, kRowsF32 * p.pw),
                     a.L * (a.DK + 1) + kRowsF32 * a.L);
  p.x_off = (size_t)kRowsF32 * 12;
  p.q_off = p.x_off + (size_t)kRowsF32 * p.xw * 4;
  p.u_off = p.q_off + (size_t)kRowsF32 * p.qw * 4;
  p.bytes = p.u_off + (size_t)u * 4;
  return p;
}

// Rows a block, threads and bytes of shared memory of a launch: float32
// takes 32 rows; bf16 the most rows of {128, 64, 32, 16} that leave two
// blocks an SM, else the most that fit one. rows = 0: nothing fits.
struct LaunchPlan {
  int rows, threads;
  size_t smem;
};

LaunchPlan launch_plan(const NannScorerArgs& a) {
  if (a.dtype != 1) {
    const size_t bytes = plan_f32(a).bytes;
    return bytes <= kBlockSmem ? LaunchPlan{kRowsF32, kThreads, bytes}
                               : LaunchPlan{0, 0, bytes};
  }
  const size_t two = kSmSmem / 2 - kReserved;
  for (int pass = 0; pass < 2; ++pass) {
    for (int rows = kRowsBf16; rows >= 16; rows /= 2) {
      const size_t bytes = plan_bf16(a, rows).bytes;
      if (bytes <= (pass == 0 ? two : kBlockSmem)) {
        return LaunchPlan{rows, 2 * rows, bytes};
      }
    }
  }
  return LaunchPlan{0, 0, plan_bf16(a, 16).bytes};
}

// ---------------------------------------------------------------- common

__device__ __forceinline__ float prelu(float x, float a) {
  return fmaxf(x, 0.f) + a * fminf(x, 0.f);
}

__device__ __forceinline__ int64_t clip_id(const NannScorerArgs& a, int b,
                                           int f) {
  const int64_t id = f < a.F ? a.ids[(int64_t)b * a.F + f] : 0;
  return id < 0 ? 0 : (id >= a.n_rows ? a.n_rows - 1 : id);
}

__device__ __forceinline__ bool row_valid(const NannScorerArgs& a, int b,
                                          int f) {
  return f < a.F && a.valid[(int64_t)b * a.F + f];
}

// The rows' element offsets (rows of T) or byte offsets (packed rows) in
// the table, and the packed rows' scales.
template <bool kPacked>
__device__ void load_rows(const NannScorerArgs& a, int b, int f0, int rows,
                          int64_t* row_at, float* row_scale) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t id = clip_id(a, b, f0 + r);
    if constexpr (kPacked) {
      const int8_t* table = static_cast<const int8_t*>(a.table);
      row_at[r] = id * (a.D + 4);
      row_scale[r] = *reinterpret_cast<const float*>(table + row_at[r] + a.D);
    } else {
      row_at[r] = id * a.D;
      row_scale[r] = 1.f;
    }
  }
}

// ------------------------------------------------ the float32 body (CUDA cores)

// Y[r, n] = epi(sum_k X[r, k] * W[k, n], n) for the block's 32 rows: a
// thread owns CT adjacent columns of RT rows (r = g, g + G, ...); the lanes
// of a warp share g when a row group spans a warp, so their X reads are
// broadcasts. K is a multiple of 4, sums run over k in order.
template <int RT, int CT, class Epi>
__device__ void gemm_tile(const float* X, int xs, int K,
                          const float* __restrict__ W, int N, float* Y, int ys,
                          Epi epi) {
  const int cols = (N < kThreads * CT ? N : kThreads * CT) / CT;
  const int G = kThreads / cols;  // G * RT == kRowsF32
  const int g = threadIdx.x / cols;
  for (int n0 = 0; n0 < N; n0 += cols * CT) {
    const int n = n0 + (threadIdx.x % cols) * CT;
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
    }
    for (int k = 0; k < K; k += 4) {
      float w[4][CT];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (CT == 2) {
          const float2 p =
              *reinterpret_cast<const float2*>(W + (int64_t)(k + j) * N + n);
          w[j][0] = p.x;
          w[j][1] = p.y;
        } else {
          w[j][0] = W[(int64_t)(k + j) * N + n];
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (g + G * i) * xs + k);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          float s = acc[i][c];
          s = fmaf(x.x, w[0][c], s);
          s = fmaf(x.y, w[1][c], s);
          s = fmaf(x.z, w[2][c], s);
          s = fmaf(x.w, w[3][c], s);
          acc[i][c] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        Y[(g + G * i) * ys + n + c] = epi(acc[i][c], n + c);
      }
    }
  }
}

template <class Epi>
__device__ void gemm_f32(const float* X, int xs, int K, const void* Wv, int N,
                         float* Y, int ys, Epi epi) {
  const float* W = static_cast<const float*>(Wv);
  // widths are checked on the host: N divides 256 (>= 8) or is a multiple
  // of 256
  if (N > 256) {
    gemm_tile<32, 1>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 256) {
    gemm_tile<16, 2>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 128) {
    gemm_tile<8, 2>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 64) {
    gemm_tile<4, 2>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 32) {
    gemm_tile<2, 2>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 16) {
    gemm_tile<1, 2>(X, xs, K, W, N, Y, ys, epi);
  } else {
    gemm_tile<1, 1>(X, xs, K, W, N, Y, ys, epi);
  }
}

// One folded head layer: Y = PReLU(X @ W * scale + shift).
__device__ void head_f32(const float* X, int xs, int K, const void* W, int N,
                         float* Y, int ys, const float* scale,
                         const float* shift, const float* alpha) {
  gemm_f32(X, xs, K, W, N, Y, ys, [scale, shift, alpha](float acc, int n) {
    return prelu(acc * scale[n] + shift[n], alpha[n]);
  });
}

template <bool kPacked>
__device__ void score_f32(const NannScorerArgs& a, unsigned char* smem) {
  const F32Plan pl = plan_f32(a);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kRowsF32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int64_t* row_at = reinterpret_cast<int64_t*>(smem);
  float* row_scale = reinterpret_cast<float*>(row_at + kRowsF32);
  float* X = reinterpret_cast<float*>(smem + pl.x_off);  // [32, DU + D]
  float* Q = reinterpret_cast<float*>(smem + pl.q_off);  // [32, qw]
  float* U = reinterpret_cast<float*>(smem + pl.u_off);
  const int KS = a.DK + 1;  // padded key stride: conflict-free column reads
  float* Ks = U;                   // [L, KS] after q2
  float* S = U + a.L * KS;         // [32, L]
  const float* kp =
      static_cast<const float*>(a.k_proj) + (int64_t)b * a.L * a.DK;
  const float* vv = static_cast<const float*>(a.v) + (int64_t)b * a.L * a.DU;

  load_rows<kPacked>(a, b, f0, kRowsF32, row_at, row_scale);
  __syncthreads();
  // gather: e rows into X[:, DU:]; ids are clipped like the plain version
  if constexpr (kPacked) {
    const int8_t* table = static_cast<const int8_t*>(a.table);
    const int D4 = a.D / 4;
    for (int i = tid; i < kRowsF32 * D4; i += kThreads) {
      const int r = i / D4, c = 4 * (i % D4);
      const char4 q = *reinterpret_cast<const char4*>(table + row_at[r] + c);
      const float s = row_scale[r];
      float* x = X + r * pl.xw + a.DU + c;
      x[0] = __fmul_rn((float)q.x, s);
      x[1] = __fmul_rn((float)q.y, s);
      x[2] = __fmul_rn((float)q.z, s);
      x[3] = __fmul_rn((float)q.w, s);
    }
  } else {
    const float* table = static_cast<const float*>(a.table);
    for (int i = tid; i < kRowsF32 * a.D; i += kThreads) {
      const int r = i / a.D, c = i % a.D;
      X[r * pl.xw + a.DU + c] = table[row_at[r] + c];
    }
  }
  __syncthreads();

  // q1 = PReLU(e @ q1_k + q1_b) into U
  {
    const float* bias = a.q1_b;
    const float* alpha = a.q1_a;
    gemm_f32(X + a.DU, pl.xw, a.D, a.q1_k, a.H1, U, a.H1,
             [bias, alpha](float acc, int n) {
               return prelu(acc + bias[n], alpha[n]);
             });
  }
  __syncthreads();
  // q = q1 @ q2_k + q2_b into Q
  {
    const float* bias = a.q2_b;
    gemm_f32(U, a.H1, a.H1, a.q2_k, a.DK, Q, pl.qw,
             [bias](float acc, int n) { return acc + bias[n]; });
  }
  __syncthreads();
  for (int i = tid; i < a.L * a.DK; i += kThreads) {
    Ks[(i / a.DK) * KS + i % a.DK] = kp[i];
  }
  __syncthreads();

  // attention, one warp per row: logits over the L keys, softmax, w @ v
  const float scale = sqrtf((float)a.DK);
  for (int r = warp; r < kRowsF32; r += kThreads / 32) {
    const float* q = Q + r * pl.qw;
    float lg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = lane + 32 * h;
      float s = -INFINITY;
      if (l < a.L) {
        const float* key = Ks + l * KS;
        s = 0.f;
        for (int k = 0; k < a.DK; ++k) s = fmaf(q[k], key[k], s);
        s = s / scale;
      }
      lg[h] = s;
    }
    float m = fmaxf(lg[0], lg[1]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    const float e0 = lane < a.L ? expf(lg[0] - m) : 0.f;
    const float e1 = lane + 32 < a.L ? expf(lg[1] - m) : 0.f;
    float sum = e0 + e1;
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if (lane < a.L) S[r * a.L + lane] = e0 / sum;
    if (lane + 32 < a.L) S[r * a.L + lane + 32] = e1 / sum;
    __syncwarp();
    for (int j = lane; j < a.DU; j += 32) {
      float acc = 0.f;
      for (int l = 0; l < a.L; ++l) {
        acc = fmaf(S[r * a.L + l], vv[(int64_t)l * a.DU + j], acc);
      }
      X[r * pl.xw + j] = acc;
    }
  }
  __syncthreads();

  // head: three folded (dense, BN, PReLU) layers
  head_f32(X, pl.xw, pl.xw, a.h1_k, a.G1, U, pl.pw, a.h1_s, a.h1_t, a.h1_a);
  __syncthreads();
  head_f32(U, pl.pw, a.G1, a.h2_k, a.G2, Q, pl.qw, a.h2_s, a.h2_t, a.h2_a);
  __syncthreads();
  head_f32(Q, pl.qw, a.G2, a.h3_k, a.G3, U, pl.pw, a.h3_s, a.h3_t, a.h3_a);
  __syncthreads();

  // last layer (one output): a warp reduction per row
  const float* h4 = static_cast<const float*>(a.h4_k);
  for (int r = warp; r < kRowsF32; r += kThreads / 32) {
    float acc = 0.f;
    for (int k = lane; k < a.G3; k += 32) acc = fmaf(U[r * pl.pw + k], h4[k], acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
    const int f = f0 + r;
    if (lane == 0 && f < a.F) {
      const int64_t o = (int64_t)b * a.F + f;
      a.out[o] = a.valid[o] ? acc * a.h4_s[0] + a.h4_t[0] : -INFINITY;
    }
  }
}

// ------------------------------------------- the bf16 body (tensor cores)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The four 8x8 b16 matrices of rows p (thread t gives row t % 16 of the
// 16 x 16 tile at column (t / 16) * 8): an A fragment of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: from a row-major [k][n] tile, the B fragments of
// two n tiles of 8 (r[0], r[1] for columns 0-7; r[2], r[3] for 8-15).
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a @ b on a 16 x 8 x 16 tile, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !fill.
__device__ __forceinline__ void cp_async16(bf16* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Two floats rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The chain's layers in the bf16 body: q1 and q2 (fed to the logits), the
// three head layers; the chunks of kChunk output columns of each are staged
// and multiplied in turn.
enum Layer { kQ1 = 0, kQ2, kH1, kH2, kH3, kLayers };

struct LayerDesc {
  const bf16* w;  // [K, N]
  int K, N;       // weight rows and columns
  int kp;         // staged rows: K padded to 16 (h1: DU and D each padded)
};

__device__ __forceinline__ LayerDesc layer_desc(const NannScorerArgs& a,
                                                const Bf16Plan& pl, int l) {
  switch (l) {
    case kQ1:
      return {static_cast<const bf16*>(a.q1_k), a.D, a.H1, pl.dp};
    case kQ2:
      return {static_cast<const bf16*>(a.q2_k), a.H1, a.DK, pl.h1p};
    case kH1:
      return {static_cast<const bf16*>(a.h1_k), a.DU + a.D, a.G1, pl.xk};
    case kH2:
      return {static_cast<const bf16*>(a.h2_k), a.G1, a.G2, pl.g1p};
    default:
      return {static_cast<const bf16*>(a.h3_k), a.G2, a.G3, pl.g2p};
  }
}

// Stage columns n0 .. n0 + kChunk (or to N) of a layer's weights into a
// chunk buffer [kp][ws], rows padded with zeros. h1's rows follow
// x = [attention out (DU, padded to dup) | e (D, padded to dp)]. A chunk of
// q2 also stages the same columns of the query's keys k_proj[b] into
// [lp][ws] after the weights, zeros beyond L and DK: every warp's logits
// read them there.
__device__ void stage_chunk(const NannScorerArgs& a, const Bf16Plan& pl,
                            int layer, int n0, bf16* buf) {
  const LayerDesc d = layer_desc(a, pl, layer);
  const int nc = min(kChunk, d.N - n0);
  // 16-byte pieces of a staged row: 1, 2 or 4 (nc is 8, 16 or 32)
  const int lv = nc == 8 ? 0 : (nc == 16 ? 1 : 2);
  for (int i = threadIdx.x; i < d.kp << lv; i += blockDim.x) {
    const int r = i >> lv, c = 8 * (i & ((1 << lv) - 1));
    int src = r < d.K ? r : -1;
    if (layer == kH1) {
      src = r < pl.dup ? (r < a.DU ? r : -1)
                       : (r - pl.dup < a.D ? a.DU + r - pl.dup : -1);
    }
    const bf16* from = d.w + (int64_t)(src < 0 ? 0 : src) * d.N + n0 + c;
    cp_async16(buf + r * pl.ws + c, from, src >= 0);
  }
  if (layer == kQ2) {
    const bf16* keys =
        static_cast<const bf16*>(a.k_proj) + (int64_t)blockIdx.y * a.L * a.DK;
    bf16* kbuf = buf + pl.kmax * pl.ws;
    const int kv = lv < 1 ? 1 : lv;  // pieces, log 2: 16 columns at least
    for (int i = threadIdx.x; i < pl.lp << kv; i += blockDim.x) {
      const int l = i >> kv, c = 8 * (i & ((1 << kv) - 1));
      const bool fill = l < a.L && n0 + c < a.DK;
      cp_async16(kbuf + l * pl.ws + c,
                 keys + (fill ? (int64_t)l * a.DK + n0 + c : 0), fill);
    }
  }
}

// acc[t] = A[16 rows, kp] @ W[kp, 8t .. 8t + 8] for the chunk's n tiles
// t < nc / 8: A from shared memory (the warp's rows, stride as), W the
// staged chunk.
__device__ __forceinline__ void mma_chunk(float acc[4][4], const bf16* A,
                                          int as, int kp, const bf16* W,
                                          int ws, int nc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }
  const bf16* a_at = A + (lane & 15) * as + (lane >> 4) * 8;
  const bf16* w_at = W + (lane & 15) * ws + (lane >> 4) * 8;
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a_at + k0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (16 * j < nc) {
        uint32_t bf[4];
        ldsm_x4_t(bf, w_at + k0 * ws + 16 * j);
        mma_bf16(acc[2 * j], af, bf[0], bf[1]);
        if (16 * j + 8 < nc) mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// Store a chunk's outputs epi(acc, n) as bf16 into the warp's rows of Y
// (stride ys) at columns n0 + 8t + 2q, +1, rows g and g + 8.
template <class Epi>
__device__ __forceinline__ void store_chunk(const float acc[4][4], bf16* Y,
                                            int ys, int n0, int nc, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (8 * t < nc) {
      const int n = n0 + 8 * t + 2 * q;
      *reinterpret_cast<uint32_t*>(Y + g * ys + n) =
          pack_bf16(epi(acc[t][0], n), epi(acc[t][1], n + 1));
      *reinterpret_cast<uint32_t*>(Y + (g + 8) * ys + n) =
          pack_bf16(epi(acc[t][2], n), epi(acc[t][3], n + 1));
    }
  }
}

template <bool kPacked>
__device__ void score_bf16(const NannScorerArgs& a, unsigned char* smem) {
  const int R = blockDim.x / 2;
  const Bf16Plan pl = plan_bf16(a, R);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int m0 = (tid >> 5) * 16;  // the warp's first row
  int64_t* row_at = reinterpret_cast<int64_t*>(smem);
  float* row_scale = reinterpret_cast<float*>(row_at + R);
  bf16* X = reinterpret_cast<bf16*>(smem + pl.x_off);   // [R][xw]
  bf16* P = reinterpret_cast<bf16*>(smem + pl.p_off);   // [R][pw]
  bf16* Vs = reinterpret_cast<bf16*>(smem + pl.v_off);  // [lp][vw]
  bf16* Wb = reinterpret_cast<bf16*>(smem + pl.w_off);  // 2 x [kmax + lp][ws]
  const size_t wbuf = (size_t)(pl.kmax + pl.lp) * pl.ws;
  const bf16* vv = static_cast<const bf16*>(a.v) + (int64_t)b * a.L * a.DU;

  // the first weight chunk goes out while the rows are gathered
  stage_chunk(a, pl, kQ1, 0, Wb);
  cp_async_commit();
  load_rows<kPacked>(a, b, f0, R, row_at, row_scale);
  __syncthreads();
  // gather: e into X[:, dup : dup + dp], zeros to dp; 4 values a piece
  {
    const int pieces = pl.dp / 4;
    for (int i = tid; i < R * pieces; i += blockDim.x) {
      const int r = i / pieces, c = 4 * (i % pieces);
      uint2 e = make_uint2(0u, 0u);
      if (c < a.D) {
        if constexpr (kPacked) {
          const int8_t* table = static_cast<const int8_t*>(a.table);
          const char4 v =
              *reinterpret_cast<const char4*>(table + row_at[r] + c);
          const float s = row_scale[r];
          e.x = pack_bf16(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s));
          e.y = pack_bf16(__fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
        } else {
          e = *reinterpret_cast<const uint2*>(
              static_cast<const bf16*>(a.table) + row_at[r] + c);
        }
      }
      *reinterpret_cast<uint2*>(X + r * pl.xw + pl.dup + c) = e;
    }
    // the query's values into Vs [lp][dup], zeros beyond L and DU
    const int vp = pl.dup / 4;
    for (int i = tid; i < pl.lp * vp; i += blockDim.x) {
      const int l = i / vp, c = 4 * (i % vp);
      uint2 e = make_uint2(0u, 0u);
      if (l < a.L && c < a.DU) {
        e = *reinterpret_cast<const uint2*>(vv + (int64_t)l * a.DU + c);
      }
      *reinterpret_cast<uint2*>(Vs + l * pl.vw + c) = e;
    }
  }
  // a warp whose 16 rows are all padding only helps stage the weights
  const bool live = __any_sync(~0u, lane < 16 && row_valid(a, b, f0 + m0 + lane));

  float lg[kMaxSeq / 8][4];  // logits: [16 rows, 8 key tiles of 8]
#pragma unroll
  for (int t = 0; t < kMaxSeq / 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) lg[t][e] = 0.f;
  }
  const int LT = pl.lp / 8;  // key tiles: L padded to 16
  const float scale = sqrtf((float)a.DK);

  int layer = kQ1, n0 = 0;  // the chunk multiplied now
  for (int c = 0; layer < kLayers; ++c) {
    const LayerDesc d = layer_desc(a, pl, layer);
    const int nc = min(kChunk, d.N - n0);
    int next = layer, next_n0 = n0 + kChunk;
    if (next_n0 >= d.N) {
      ++next;
      next_n0 = 0;
    }
    // chunk c has landed, and every warp is done with chunk c - 1, whose
    // buffer takes chunk c + 1 while this one is multiplied: one barrier
    // a chunk
    cp_async_wait_all();
    __syncthreads();
    if (next < kLayers) {
      stage_chunk(a, pl, next, next_n0, Wb + ((c + 1) & 1) * wbuf);
    }
    cp_async_commit();
    const bf16* W = Wb + (c & 1) * wbuf;
    if (live) {
      float acc[4][4];
      if (layer == kQ1) {
        mma_chunk(acc, X + m0 * pl.xw + pl.dup, pl.xw, d.kp, W, pl.ws, nc);
        const float* bias = a.q1_b;
        const float* alpha = a.q1_a;
        store_chunk(acc, P + m0 * pl.pw, pl.pw, n0, nc,
                    [bias, alpha](float v, int n) {
                      return prelu(v + __ldg(bias + n), __ldg(alpha + n));
                    });
      } else if (layer == kQ2) {
        // q = q1 @ q2_k + q2_b for columns n0 .. n0 + nc, rounded to bf16
        // as A fragments, then logits += q[:, n0 : n0 + nc] @ k[:, n0 : ...]^T
        mma_chunk(acc, P + m0 * pl.pw, pl.pw, d.kp, W, pl.ws, nc);
        const float* bias = a.q2_b;
        // lane t addresses key row (t % 8) + 8 (t / 16), columns 8 ((t / 8) % 2)
        const bf16* k_at = W + pl.kmax * pl.ws +
                           ((lane & 7) + ((lane >> 4) << 3)) * pl.ws +
                           ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (16 * s < nc) {
            const int n = n0 + 16 * s + 2 * q;
            const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
            uint32_t qa[4];
            qa[0] = pack_bf16(acc[2 * s][0] + b0, acc[2 * s][1] + b1);
            qa[1] = pack_bf16(acc[2 * s][2] + b0, acc[2 * s][3] + b1);
            qa[2] = qa[3] = 0u;
            if (16 * s + 8 < nc) {
              const float b8 = __ldg(bias + n + 8), b9 = __ldg(bias + n + 9);
              qa[2] = pack_bf16(acc[2 * s + 1][0] + b8, acc[2 * s + 1][1] + b9);
              qa[3] = pack_bf16(acc[2 * s + 1][2] + b8, acc[2 * s + 1][3] + b9);
            }
            // the staged keys [l][dk] are the B fragments' [n][k]: two key
            // tiles of 8 an ldmatrix
#pragma unroll
            for (int t = 0; t < kMaxSeq / 8; t += 2) {
              if (t < LT) {
                uint32_t bk[4];
                ldsm_x4(bk, k_at + 8 * t * pl.ws + 16 * s);
                mma_bf16(lg[t], qa, bk[0], bk[1]);
                mma_bf16(lg[t + 1], qa, bk[2], bk[3]);
              }
            }
          }
        }
        if (n0 + kChunk >= a.DK) {
          // softmax over the L keys of rows g and g + 8 (a row's logits
          // lie in the four lanes of a quad), then w @ v into X[:, :dup]
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int t = 0; t < kMaxSeq / 8; ++t) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int l = 8 * t + 2 * q + (e & 1);
              lg[t][e] = t < LT && l < a.L ? lg[t][e] / scale : -INFINITY;
              mx[e >> 1] = fmaxf(mx[e >> 1], lg[t][e]);
            }
          }
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
          }
#pragma unroll
          for (int t = 0; t < kMaxSeq / 8; ++t) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              lg[t][e] = expf(lg[t][e] - mx[e >> 1]);
              sum[e >> 1] += lg[t][e];
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] += __shfl_xor_sync(~0u, sum[h], 1);
            sum[h] += __shfl_xor_sync(~0u, sum[h], 2);
          }
          uint32_t wa[kMaxSeq / 16][4];  // softmax weights as A fragments
#pragma unroll
          for (int s = 0; s < kMaxSeq / 16; ++s) {
            wa[s][0] = pack_bf16(lg[2 * s][0] / sum[0], lg[2 * s][1] / sum[0]);
            wa[s][1] = pack_bf16(lg[2 * s][2] / sum[1], lg[2 * s][3] / sum[1]);
            wa[s][2] = pack_bf16(lg[2 * s + 1][0] / sum[0],
                                 lg[2 * s + 1][1] / sum[0]);
            wa[s][3] = pack_bf16(lg[2 * s + 1][2] / sum[1],
                                 lg[2 * s + 1][3] / sum[1]);
          }
          const bf16* v_at = Vs + (lane & 15) * pl.vw + (lane >> 4) * 8;
          for (int j0 = 0; j0 < pl.dup; j0 += kChunk) {
            const int jc = min(kChunk, pl.dup - j0);
            float att[4][4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int e = 0; e < 4; ++e) att[t][e] = 0.f;
            }
#pragma unroll
            for (int s = 0; s < kMaxSeq / 16; ++s) {
              if (16 * s < pl.lp) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  if (16 * j < jc) {
                    uint32_t bf[4];
                    ldsm_x4_t(bf, v_at + 16 * s * pl.vw + j0 + 16 * j);
                    mma_bf16(att[2 * j], wa[s], bf[0], bf[1]);
                    mma_bf16(att[2 * j + 1], wa[s], bf[2], bf[3]);
                  }
                }
              }
            }
            store_chunk(att, X + m0 * pl.xw, pl.xw, j0, jc,
                        [](float v, int) { return v; });
          }
        }
      } else {
        // a head layer: PReLU(x @ W * scale + shift)
        const float *sc, *sh, *al;
        const bf16* A;
        bf16* Y;
        int as, ys;
        if (layer == kH1) {
          sc = a.h1_s, sh = a.h1_t, al = a.h1_a;
          A = X, as = pl.xw, Y = P, ys = pl.pw;
        } else if (layer == kH2) {
          sc = a.h2_s, sh = a.h2_t, al = a.h2_a;
          A = P, as = pl.pw, Y = X, ys = pl.xw;
        } else {
          sc = a.h3_s, sh = a.h3_t, al = a.h3_a;
          A = X, as = pl.xw, Y = P, ys = pl.pw;
        }
        mma_chunk(acc, A + m0 * as, as, d.kp, W, pl.ws, nc);
        store_chunk(acc, Y + m0 * ys, ys, n0, nc,
                    [sc, sh, al](float v, int n) {
                      return prelu(v * __ldg(sc + n) + __ldg(sh + n),
                                   __ldg(al + n));
                    });
      }
      // an output of width 8 is read as 16 columns by the next layer
      if ((d.N & 15) && n0 + kChunk >= d.N && layer != kQ2) {
        bf16* Y = (layer == kH2) ? X + m0 * pl.xw : P + m0 * pl.pw;
        const int ys = (layer == kH2) ? pl.xw : pl.pw;
        for (int i = lane; i < 16 * 8; i += 32) {
          Y[(i >> 3) * ys + d.N + (i & 7)] = __float2bfloat16_rn(0.f);
        }
      }
    }
    layer = next;
    n0 = next_n0;
  }

  // last layer (one output): a warp reduction per row; lane i keeps row i
  __syncwarp();  // h3's outputs, stored by the other lanes
  const bf16* h4 = static_cast<const bf16*>(a.h4_k);
  float res = 0.f;
  if (live) {
    for (int i = 0; i < 16; ++i) {
      float acc = 0.f;
      for (int k = lane; k < a.G3; k += 32) {
        acc = fmaf(__bfloat162float(P[(m0 + i) * pl.pw + k]),
                   __bfloat162float(__ldg(h4 + k)), acc);
      }
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
      if (lane == i) res = acc;
    }
  }
  const int f = f0 + m0 + lane;
  if (lane < 16 && f < a.F) {
    const int64_t o = (int64_t)b * a.F + f;
    a.out[o] = a.valid[o] ? res * a.h4_s[0] + a.h4_t[0] : -INFINITY;
  }
}

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kThreads, 2)
frontier_scorer_kernel(const NannScorerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  const int rows = kBf16 ? blockDim.x / 2 : kRowsF32;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * rows;
  // a block whose rows are all padding writes -inf and does nothing else
  bool any = false;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    any |= row_valid(a, b, f0 + r);
  }
  if (!__syncthreads_or(any)) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      if (f0 + r < a.F) a.out[(int64_t)b * a.F + f0 + r] = -INFINITY;
    }
    return;
  }
  if constexpr (kBf16) {
    score_bf16<kPacked>(a, smem);
  } else {
    score_f32<kPacked>(a, smem);
  }
}

template <typename T, bool kPacked>
int launch(const NannScorerArgs& a, const LaunchPlan& p, cudaStream_t stream) {
  const dim3 grid((a.F + p.rows - 1) / p.rows, a.B);
  frontier_scorer_kernel<T, kPacked><<<grid, p.threads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel instantiation of a launch, as a function pointer.
const void* kernel_of(const NannScorerArgs& a) {
  if (a.dtype == 1) {
    return a.storage == 1
               ? (const void*)frontier_scorer_kernel<bf16, true>
               : (const void*)frontier_scorer_kernel<bf16, false>;
  }
  return a.storage == 1 ? (const void*)frontier_scorer_kernel<float, true>
                        : (const void*)frontier_scorer_kernel<float, false>;
}

}  // namespace

extern "C" {

// Opt every instantiation in to a block's whole shared memory, and prefer
// shared memory over L1, on the current device; call once per device before
// launching. Returns a CUDA error (0 = ok).
int nann_scorer_init(void) {
  const void* kernels[] = {(const void*)frontier_scorer_kernel<float, false>,
                           (const void*)frontier_scorer_kernel<float, true>,
                           (const void*)frontier_scorer_kernel<bf16, false>,
                           (const void*)frontier_scorer_kernel<bf16, true>};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBlockSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// cudaErrorInvalidValue when no plan fits the widths.
int nann_frontier_scorer(const NannScorerArgs* a, void* stream) {
  if (a->B == 0 || a->F == 0) return 0;
  const LaunchPlan p = launch_plan(*a);
  if (p.rows == 0 || a->L < 1 || a->L > kMaxSeq) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) {
    return a->storage == 1 ? launch<bf16, true>(*a, p, s)
                           : launch<bf16, false>(*a, p, s);
  }
  return a->storage == 1 ? launch<float, true>(*a, p, s)
                         : launch<float, false>(*a, p, s);
}

// The launch plan of these arguments: rows a block, threads a block and
// bytes of dynamic shared memory (rows = 0: nothing fits).
void nann_scorer_plan(const NannScorerArgs* a, int* rows, int* threads,
                      int64_t* smem) {
  const LaunchPlan p = launch_plan(*a);
  *rows = p.rows;
  *threads = p.threads;
  *smem = (int64_t)p.smem;
}

// Blocks of this launch that fit one SM of the current device at once,
// after nann_scorer_init; a negative number is a CUDA error.
int nann_scorer_blocks_per_sm(const NannScorerArgs* a) {
  const LaunchPlan p = launch_plan(*a);
  if (p.rows == 0) return 0;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of(*a), p.threads, p.smem);
  return err == cudaSuccess ? n : -(int)err;
}

// The struct's size and its last field's offset, held against
// FrontierScorerArgs when the library is loaded.
size_t nann_scorer_args_size(void) { return sizeof(NannScorerArgs); }
size_t nann_scorer_args_storage_offset(void) {
  return offsetof(NannScorerArgs, storage);
}

const char* nann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
