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
// layer's output is rounded to the compute type T, sums are float32.
//
// Storage is the second template axis. A packed int8 row (index/quantize.py)
// is D int8 values followed by the row's float32 scale s in bytes D..D+3,
// D + 4 bytes in all (68 at D = 64, against 128 for a bf16 row), and
// e[c] = round_T(float(q[c]) * s): one float32 product, one rounding, as
// `dequantize_rows` does, never fused into the first layer. The Pallas
// kernel always dequantizes to bf16 (pallas_scorer.py:112); this one, like
// the JAX main path (beam.py:459-463), dequantizes to the compute type.
// Rows are read as char4 and the scale as one aligned 4-byte load per row
// (D % 4 == 0 and a 4-byte aligned table, checked on the host): rows of 68
// bytes are not 16-byte aligned, so no wider load is used.
//
// Bound on an H100: per scored row the chain is about
// 2*(64*128 + 128*256 + 256*L + L*64 + 128*128 + 128*64 + 64*32 + 32)
// = 167 kFLOP at L = 50, against 128 bytes of bf16 row (68 packed int8) plus
// 9 bytes of id, mask and score: over 1,200 FLOP per byte, far above the
// card's ~295 FLOP/byte balance point, so the work is compute-bound and its
// least time is FLOPs / 989 TFLOP/s (bf16 tensor cores); the int8 storage
// changes the bytes, not the bound.
//
// Design (the first, simple version; tensor cores come later): one block of
// 256 threads scores ROWS = 32 rows of one query. The query's k_proj and v are
// staged in shared memory once per block (k_proj with a padded row stride, so
// the lanes of a warp reading 32 different keys hit 32 banks); all
// activations of the 32 rows stay in shared memory in float32 between layers
// and never go back to device memory. Each layer is a small product on CUDA
// cores: a thread owns one output column and R rows, reads its weight column
// through L1/L2 (coalesced across the warp) and the rows' activations as
// float4 broadcasts from shared memory. Folded weights (about 135 KB in bf16,
// 270 KB in float32) do not fit a block's 227 KB next to the activations, so
// they are read through the cache rather than staged.
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

constexpr int kThreads = 256;
constexpr int kRows = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a float32 value to T and back (the plain version's `.to(dt)`).
template <typename T>
__device__ __forceinline__ float round_t(float x);
template <>
__device__ __forceinline__ float round_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float prelu(float x, float a) {
  return fmaxf(x, 0.f) + a * fminf(x, 0.f);
}

// Y[r, n] = epi(sum_k X[r, k] * W[k, n], n) for the kRows rows of the block.
// A thread owns column n of R rows (r = g, g + G, ...); the lanes of a warp
// share g, so their X reads are broadcasts. K is a multiple of 4.
template <int R, typename T, class Epi>
__device__ void gemm_rows(const float* X, int xs, int K, const T* __restrict__ W,
                          int N, float* Y, int ys, Epi epi) {
  const int ncols = N < kThreads ? N : kThreads;
  const int G = kThreads / ncols;  // == kRows / R
  const int g = threadIdx.x / ncols;
  for (int n0 = 0; n0 < N; n0 += kThreads) {
    const int n = n0 + threadIdx.x % ncols;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = to_f(W[(int64_t)(k + 0) * N + n]);
      const float w1 = to_f(W[(int64_t)(k + 1) * N + n]);
      const float w2 = to_f(W[(int64_t)(k + 2) * N + n]);
      const float w3 = to_f(W[(int64_t)(k + 3) * N + n]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (g + G * i) * xs + k);
        float a = acc[i];
        a = fmaf(x.x, w0, a);
        a = fmaf(x.y, w1, a);
        a = fmaf(x.z, w2, a);
        a = fmaf(x.w, w3, a);
        acc[i] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) Y[(g + G * i) * ys + n] = epi(acc[i], n);
  }
}

template <typename T, class Epi>
__device__ void gemm(const float* X, int xs, int K, const T* W, int N, float* Y,
                     int ys, Epi epi) {
  // widths are checked on the host: N divides 256 or is a multiple of it
  if (N >= 256) {
    gemm_rows<32>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 128) {
    gemm_rows<16>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 64) {
    gemm_rows<8>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 32) {
    gemm_rows<4>(X, xs, K, W, N, Y, ys, epi);
  } else if (N == 16) {
    gemm_rows<2>(X, xs, K, W, N, Y, ys, epi);
  } else {
    gemm_rows<1>(X, xs, K, W, N, Y, ys, epi);
  }
}

// One folded head layer: Y = round(PReLU(X @ W * scale + shift)).
template <typename T>
__device__ void head_layer(const float* X, int xs, int K, const void* W, int N,
                           float* Y, int ys, const float* scale,
                           const float* shift, const float* alpha) {
  gemm(X, xs, K, static_cast<const T*>(W), N, Y, ys,
       [scale, shift, alpha](float acc, int n) {
         return round_t<T>(prelu(acc * scale[n] + shift[n], alpha[n]));
       });
}

__device__ __forceinline__ int64_t clip_id(const NannScorerArgs& a, int b,
                                           int f) {
  const int64_t id = f < a.F ? a.ids[(int64_t)b * a.F + f] : 0;
  return id < 0 ? 0 : (id >= a.n_rows ? a.n_rows - 1 : id);
}

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kThreads)
frontier_scorer_kernel(const NannScorerArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int XW = a.DU + a.D;  // x = [attention out | e]
  int PW = a.H1;
  PW = max(PW, a.DK);
  PW = max(PW, a.G1);
  PW = max(PW, a.G2);
  PW = max(PW, a.G3);
  const int KS = a.DK + 1;  // padded key stride: conflict-free column reads

  float* X = smem;              // [kRows, XW]
  float* P = X + kRows * XW;    // [kRows, PW]
  float* Q = P + kRows * PW;    // [kRows, PW]
  float* Ks = Q + kRows * PW;   // [L, KS]
  float* Vs = Ks + a.L * KS;    // [L, DU]
  float* S = Vs + a.L * a.DU;   // [kRows, L]

  const T* kp = static_cast<const T*>(a.k_proj) + (int64_t)b * a.L * a.DK;
  const T* vv = static_cast<const T*>(a.v) + (int64_t)b * a.L * a.DU;

  // gather: e rows into X[:, DU:]; ids are clipped like the plain version
  if constexpr (kPacked) {
    __shared__ int64_t row_at[kRows];   // byte offset of each packed row
    __shared__ float row_scale[kRows];
    const int8_t* table = static_cast<const int8_t*>(a.table);
    if (tid < kRows) {
      const int64_t at = clip_id(a, b, f0 + tid) * (a.D + 4);
      row_at[tid] = at;
      row_scale[tid] = *reinterpret_cast<const float*>(table + at + a.D);
    }
    __syncthreads();
    const int D4 = a.D / 4;
    for (int i = tid; i < kRows * D4; i += kThreads) {
      const int r = i / D4, c = 4 * (i % D4);
      const char4 q = *reinterpret_cast<const char4*>(table + row_at[r] + c);
      const float s = row_scale[r];
      float* x = X + r * XW + a.DU + c;
      x[0] = round_t<T>(__fmul_rn((float)q.x, s));
      x[1] = round_t<T>(__fmul_rn((float)q.y, s));
      x[2] = round_t<T>(__fmul_rn((float)q.z, s));
      x[3] = round_t<T>(__fmul_rn((float)q.w, s));
    }
  } else {
    const T* table = static_cast<const T*>(a.table);
    for (int i = tid; i < kRows * a.D; i += kThreads) {
      const int r = i / a.D, c = i % a.D;
      X[r * XW + a.DU + c] = to_f(table[clip_id(a, b, f0 + r) * a.D + c]);
    }
  }
  for (int i = tid; i < a.L * a.DK; i += kThreads) {
    Ks[(i / a.DK) * KS + i % a.DK] = to_f(kp[i]);
  }
  for (int i = tid; i < a.L * a.DU; i += kThreads) Vs[i] = to_f(vv[i]);
  __syncthreads();

  // q1 = round(PReLU(e @ q1_k + q1_b))
  {
    const float* bias = a.q1_b;
    const float* alpha = a.q1_a;
    gemm(X + a.DU, XW, a.D, static_cast<const T*>(a.q1_k), a.H1, P, PW,
         [bias, alpha](float acc, int n) {
           return round_t<T>(prelu(acc + bias[n], alpha[n]));
         });
  }
  __syncthreads();
  // q2 = round(q1 @ q2_k + q2_b)
  {
    const float* bias = a.q2_b;
    gemm(P, PW, a.H1, static_cast<const T*>(a.q2_k), a.DK, Q, PW,
         [bias](float acc, int n) { return round_t<T>(acc + bias[n]); });
  }
  __syncthreads();

  // attention, one warp per row: logits over the L keys, softmax, w @ v
  const float inv_scale = 1.f / sqrtf((float)a.DK);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const float* q = Q + r * PW;
    float lg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = lane + 32 * h;
      float s = -INFINITY;
      if (l < a.L) {
        const float* key = Ks + l * KS;
        s = 0.f;
        for (int k = 0; k < a.DK; ++k) s = fmaf(q[k], key[k], s);
        s *= inv_scale;
      }
      lg[h] = s;
    }
    float m = fmaxf(lg[0], lg[1]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    float e0 = lane < a.L ? expf(lg[0] - m) : 0.f;
    float e1 = lane + 32 < a.L ? expf(lg[1] - m) : 0.f;
    float sum = e0 + e1;
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if (lane < a.L) S[r * a.L + lane] = round_t<T>(e0 / sum);
    if (lane + 32 < a.L) S[r * a.L + lane + 32] = round_t<T>(e1 / sum);
    __syncwarp();
    for (int j = lane; j < a.DU; j += 32) {
      float acc = 0.f;
      for (int l = 0; l < a.L; ++l) acc = fmaf(S[r * a.L + l], Vs[l * a.DU + j], acc);
      X[r * XW + j] = round_t<T>(acc);
    }
  }
  __syncthreads();

  // head: three folded (dense, BN, PReLU) layers
  head_layer<T>(X, XW, XW, a.h1_k, a.G1, P, PW, a.h1_s, a.h1_t, a.h1_a);
  __syncthreads();
  head_layer<T>(P, PW, a.G1, a.h2_k, a.G2, Q, PW, a.h2_s, a.h2_t, a.h2_a);
  __syncthreads();
  head_layer<T>(Q, PW, a.G2, a.h3_k, a.G3, P, PW, a.h3_s, a.h3_t, a.h3_a);
  __syncthreads();

  // last layer (one output): a warp reduction per row
  const T* h4 = static_cast<const T*>(a.h4_k);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float acc = 0.f;
    for (int k = lane; k < a.G3; k += 32) acc = fmaf(P[r * PW + k], to_f(h4[k]), acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
    const int f = f0 + r;
    if (lane == 0 && f < a.F) {
      const int64_t o = (int64_t)b * a.F + f;
      a.out[o] = a.valid[o] ? acc * a.h4_s[0] + a.h4_t[0] : -INFINITY;
    }
  }
}

size_t smem_bytes(const NannScorerArgs& a) {
  int pw = a.H1;
  pw = pw > a.DK ? pw : a.DK;
  pw = pw > a.G1 ? pw : a.G1;
  pw = pw > a.G2 ? pw : a.G2;
  pw = pw > a.G3 ? pw : a.G3;
  const size_t floats = (size_t)kRows * (a.DU + a.D) + 2 * (size_t)kRows * pw +
                        (size_t)a.L * (a.DK + 1) + (size_t)a.L * a.DU +
                        (size_t)kRows * a.L;
  return floats * sizeof(float);
}

template <typename T, bool kPacked>
int launch(const NannScorerArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_scorer_kernel<T, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.F + kRows - 1) / kRows, a.B);
  frontier_scorer_kernel<T, kPacked><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_storage(const NannScorerArgs& a, cudaStream_t stream) {
  return a.storage == 1 ? launch<T, true>(a, stream)
                        : launch<T, false>(a, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int nann_frontier_scorer(const NannScorerArgs* a, void* stream) {
  if (a->B == 0 || a->F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 1 ? launch_storage<__nv_bfloat16>(*a, s)
                       : launch_storage<float>(*a, s);
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
