// Fused LayerNorm -> Dense (-> ReLU) for Hopper (sm_90a).
//
// Replaces: mesm_tpu/ops/layer_pallas.py::fused_ln_dense / _ln_dense_kernel,
// the input projection of the raw video features (LinearBlock with a
// LayerNorm on the input; charades: N = NG*Lv ~ 10,282 rows, D = 2818,
// F = 256).
//
// What it computes, at the TPU kernel's rounding points:
//   per row: f32 mean and E[x^2]; var = E[x^2] - mean^2 (unclamped);
//   y = (x - mean) / sqrt(var + eps) * gamma + beta   (f32 gamma, beta)
//   y is rounded to the input dtype;
//   out = y @ W^T with f32 accumulation, + f32 bias, optional ReLU,
//   cast to the input dtype.
//
// What bounds it on the H100: in bf16 the bytes. x is read once (N*D*2 =
// 58 MB at the charades shape), out written once, W (1.4 MB) stays in L2:
// ~19 us at 3.35 TB/s against ~15 us of bf16 tensor-core work. In fp32 there
// is no TF32, so the product runs on the FMA pipes and the operations bound
// it (14.8 GFLOP at 67 TFLOP/s).
//
// Design: one block owns BM consecutive rows. Each warp streams its rows of
// x from device memory with 16-byte loads (a row of 2818 bf16 is 5,636
// bytes, so each row has its own unaligned head and tail, loaded as scalars:
// no vector load straddles a row start), accumulates the row statistics in
// registers and keeps the row in dynamic shared memory, where it is then
// normalised in place. So x is read from device memory exactly once, as on
// the TPU. The product then runs against W streamed from L2:
//   bf16: warp-level tensor-core tiles (WMMA 16x16x16, f32 accumulators),
//         BM = 32 rows, W padded by the wrapper to a row stride DP that is a
//         multiple of 16 with a zero tail, so the K tail (2818 is not a
//         multiple of 16) contributes nothing;
//   fp32: one output column per thread, BM = 16 rows of FMA accumulators.
// wgmma, TMA and a pipelined ring of x tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// Rows [row0, row0 + BM) of x -> normalised, dtype-rounded rows of ys
// (row stride DS, columns D..DS-1 zero). Rows past N are all zero.
template <typename T, int BM>
__device__ void load_normalize(const T* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, T* ys, int N, int D, int DS,
                               int row0, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int VEC = 16 / sizeof(T);
  for (int i = warp; i < BM; i += WARPS) {
    T* yrow = ys + (size_t)i * DS;
    const int n = row0 + i;
    if (n >= N) {
      for (int c = lane; c < DS; c += 32) yrow[c] = from_f<T>(0.f);
      continue;
    }
    const T* xrow = x + (size_t)n * D;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(xrow);
    int head = (int)(((16 - (addr & 15)) & 15) / sizeof(T));
    if (head > D) head = D;
    const int nvec = (D - head) / VEC;
    const int tail0 = head + nvec * VEC;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < head; c += 32) {
      const T e = xrow[c];
      const float v = to_f(e);
      yrow[c] = e;
      s += v;
      ss += v * v;
    }
    const uint4* xv = reinterpret_cast<const uint4*>(xrow + head);
    for (int j = lane; j < nvec; j += 32) {
      const uint4 u = __ldg(xv + j);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const float v = to_f(e[t]);
        yrow[head + j * VEC + t] = e[t];
        s += v;
        ss += v * v;
      }
    }
    for (int c = tail0 + lane; c < D; c += 32) {
      const T e = xrow[c];
      const float v = to_f(e);
      yrow[c] = e;
      s += v;
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / (float)D;
    const float var = ss / (float)D - mu * mu;  // unclamped, as the TPU kernel
    const float rstd = 1.0f / sqrtf(var + eps);
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      const float y = (to_f(yrow[c]) - mu) * rstd;
      yrow[c] = from_f<T>(y * gamma[c] + beta[c]);
    }
    for (int c = D + lane; c < DS; c += 32) yrow[c] = from_f<T>(0.f);
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
ln_dense_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const bf16* __restrict__ wp,
                     const float* __restrict__ bias, bf16* __restrict__ out, int N, int D,
                     int DP, int DS, int F, int relu, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  const int row0 = blockIdx.x * BM;
  load_normalize<bf16, BM>(x, gamma, beta, ys, N, D, DS, row0, eps);
  __syncthreads();

  constexpr int RT = BM / 16;  // row tiles
  const int CT = F / 16;       // column tiles, F <= 256 -> at most 2 per warp
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[r][j], 0.0f);

  for (int k0 = 0; k0 < DP; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::load_matrix_sync(a[r], ys + (size_t)r * 16 * DS + k0, DS);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = warp + WARPS * j;
      if (c < CT) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, wp + (size_t)c * 16 * DP + k0, DP);
#pragma unroll
        for (int r = 0; r < RT; ++r) wmma::mma_sync(acc[r][j], a[r], b, acc[r][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with ys: reuse it for the f32 tile

  float* cs = reinterpret_cast<float*>(smem);  // BM x F
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = warp + WARPS * j;
    if (c < CT) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        wmma::store_matrix_sync(cs + (size_t)r * 16 * F + c * 16, acc[r][j], F, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * F; idx += THREADS) {
    const int i = idx / F, f = idx - (idx / F) * F;
    const int n = row0 + i;
    if (n >= N) continue;
    float v = cs[idx] + bias[f];
    if (relu) v = fmaxf(v, 0.f);
    out[(size_t)n * F + f] = __float2bfloat16(v);
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
ln_dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ wp,
                    const float* __restrict__ bias, float* __restrict__ out, int N, int D,
                    int DP, int DS, int F, int relu, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);
  const int row0 = blockIdx.x * BM;
  load_normalize<float, BM>(x, gamma, beta, ys, N, D, DS, row0, eps);
  __syncthreads();

  const int f = threadIdx.x;  // one output column per thread, F <= THREADS
  if (f >= F) return;
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;
  const float4* wrow = reinterpret_cast<const float4*>(wp + (size_t)f * DP);
  for (int k4 = 0; k4 < DP / 4; ++k4) {
    const float4 w = __ldg(wrow + k4);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const float4 y = reinterpret_cast<const float4*>(ys + (size_t)i * DS)[k4];
      acc[i] = fmaf(y.x, w.x, acc[i]);
      acc[i] = fmaf(y.y, w.y, acc[i]);
      acc[i] = fmaf(y.z, w.z, acc[i]);
      acc[i] = fmaf(y.w, w.w, acc[i]);
    }
  }
  const float bf = bias[f];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int n = row0 + i;
    if (n < N) {
      float v = acc[i] + bf;
      if (relu) v = fmaxf(v, 0.f);
      out[(size_t)n * F + f] = v;
    }
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int bm, size_t smem, cudaStream_t stream, const void* x,
           const void* gamma, const void* beta, const void* wp, const void* bias, void* out,
           int N, int D, int DP, int DS, int F, int relu, float eps) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + bm - 1) / bm;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const T*>(wp), static_cast<const float*>(bias), static_cast<T*>(out), N, D, DP,
      DS, F, relu, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. x: (N, D) row-major in `dtype`
// (0 = float32, 1 = bfloat16); gamma, beta: (D,) f32; wp: (F, DP) in `dtype`,
// the Dense weight in torch layout with its rows padded to DP (a multiple of
// 16) by zeros; bias: (F,) f32; out: (N, F) in `dtype`. DS is the shared-memory
// row stride and bm the rows per block (bf16: 32 or 16; fp32: 16 or 8); the
// caller computes both, and the shared-memory size, from the same formula.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ln_dense_launch(const void* x, const void* gamma, const void* beta, const void* wp,
                               const void* bias, void* out, int N, int D, int DP, int DS, int F,
                               int relu, float eps, int dtype, int bm, long long smem,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 0 || F > THREADS || N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (F % 16 != 0) return (int)cudaErrorInvalidValue;
    if (bm == 32)
      return launch<bf16>(ln_dense_bf16_kernel<32>, 32, (size_t)smem, s, x, gamma, beta, wp, bias,
                          out, N, D, DP, DS, F, relu, eps);
    if (bm == 16)
      return launch<bf16>(ln_dense_bf16_kernel<16>, 16, (size_t)smem, s, x, gamma, beta, wp, bias,
                          out, N, D, DP, DS, F, relu, eps);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    if (bm == 16)
      return launch<float>(ln_dense_f32_kernel<16>, 16, (size_t)smem, s, x, gamma, beta, wp, bias,
                           out, N, D, DP, DS, F, relu, eps);
    if (bm == 8)
      return launch<float>(ln_dense_f32_kernel<8>, 8, (size_t)smem, s, x, gamma, beta, wp, bias,
                           out, N, D, DP, DS, F, relu, eps);
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaErrorInvalidValue;
}
