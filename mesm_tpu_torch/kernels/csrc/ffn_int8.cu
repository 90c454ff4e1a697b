// The fused int8 FFN for Hopper (sm_90a): out = linear2(prelu(linear1(x)))
// with int8 x int8 -> int32 tensor-core products and the hidden activation
// kept in shared memory.
//
// Replaces: mesm_tpu/ops/ffn_pallas.py::ffn_int8 -> _ffn_int8_kernel
// (:44-142), which the FFN of every eval transformer layer runs when the
// int8 switch is on (mesm_tpu/models/layers.py:298-325): x of (N, K = 256)
// rows in the model's dtype (charades bf16: N = 24,832-24,960; TACoS fp32:
// ~9,600), hidden width N1 = 1024, K2 = 256 outputs.
//
// What it computes, row by row, at the TPU kernel's rounding points
// (ops/ffn_int8.ffn_int8_reference is its plain version; bf() rounds to
// bf16, and every product and sum of bf16 values below is rounded to bf16):
//   xs = max(amax |x|, 1e-8) * (1/127)                      (f32)
//   xq = int8(round(bf(x) * bf(1 / xs)))
//   h = ((bf(xq . w1q) * s1) * bf(xs)) + b1;  h = h > 0 ? h : alpha * h
//   ah = amax |h|;  hq = int8(round(h * bf(127 / max(ah, 1e-8))))
//   out = ((bf(hq . w2q) * s2) * bf(max(ah, 1e-8) * (1/127))) + b2
// in the output's dtype. round() is half to even and int8() saturates to
// [-128, 127], as XLA's conversion does. The weights come quantized per
// output channel (w1q (N1, K), w2q (K2, N1) int8, torch's (out, in) layout;
// s1, s2, b1, b2, alpha as bf16), made by the wrapper in torch ops, as the
// TPU version makes them in XLA outside its pallas_call. The integer sums
// are exact, and below 2**24 for K, N1 <= 1040, so int -> f32 -> bf16 rounds
// once, as the plain version's.
//
// What bounds it on the H100: the operations. At the charades site,
// 4 * 24,960 * 256 * 1024 = 26.2 G int8 operations are 13 us at 1,979
// TOP/s; x and out in bf16 and the int8 weights are 26 MB, 8 us at
// 3.35 TB/s. The 51 MB bf16 hidden activation of the unfused FFN is never
// written: it lives only in shared memory.
//
// Design: one block of 8 warps per tile of R = 64 rows, 217 KB of shared
// memory (one block per SM). (1) Each warp quantizes 8 rows of x into
// shared memory (K + 16 bytes a row, so the mma fragment loads hit 32
// banks). (2) linear1: the warps split the N1 columns into pieces of 32;
// for a piece, a warp holds the 64 x 32 int32 sums of 16
// mma.sync.m16n8k32.s8.s8.s32 tiles in registers, reading A fragments from
// the quantized rows and B fragments straight from w1q, whose rows are the
// k-contiguous "col" operand the instruction takes (256 KB, resident in
// L2). The epilogue runs the bf16 dequant, bias and PReLU chain, writes h
// as bf16 into shared memory and folds |h| into each row's amax (warp
// shuffles, then a shared atomicMax on the float's bits). (3) Each row's
// requantization scale, then (4) hq into shared memory as int8. (5)
// linear2 the same way over hq and w2q, its epilogue writing the output.
// mma.sync is not Hopper's fastest path (wgmma with TMA is later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 64;       // rows per block
constexpr int MT = R / 16;  // m16 tiles: every warp covers all R rows
constexpr int NT = 4;       // n8 tiles per piece of 32 columns
constexpr float INV127 = (float)(1.0 / 127.0);  // the f32 the plain version multiplies by

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// round half to even, saturated to int8
__device__ __forceinline__ int8_t to_i8(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -128.f), 127.f);
}

template <typename T>
__device__ __forceinline__ float ldf(const T* p);
template <>
__device__ __forceinline__ float ldf<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float ldf<bf16>(const bf16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void st2(T* p, float a, float b);
template <>
__device__ __forceinline__ void st2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void st2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The int32 sums of rows [0, R) x columns [n0, n0 + 32) of A (R x kdim int8
// in shared memory, row stride lda bytes) times B^T (B: rows of kdim int8 in
// device memory, row stride kdim). Fragment layouts of m16n8k32 (PTX ISA):
// lane = 4 * g + t; A registers hold rows g / g + 8, bytes 4t..4t+3 (+16);
// B registers hold column g, k = 4t..4t+3 (+16); C holds rows g / g + 8,
// columns 2t, 2t + 1.
__device__ __forceinline__ void piece_product(int (&acc)[MT][NT][4], const int8_t* A, int lda,
                                              const int8_t* __restrict__ B, int kdim, int n0,
                                              int g, int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
#pragma unroll 2
  for (int k0 = 0; k0 < kdim; k0 += 32) {
    unsigned bq[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* br = B + (size_t)(n0 + nt * 8 + g) * kdim + k0 + 4 * t;
      bq[nt][0] = __ldg(reinterpret_cast<const unsigned*>(br));
      bq[nt][1] = __ldg(reinterpret_cast<const unsigned*>(br + 16));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* ar = A + (size_t)(mt * 16 + g) * lda + k0 + 4 * t;
      const unsigned a[4] = {*reinterpret_cast<const unsigned*>(ar),
                             *reinterpret_cast<const unsigned*>(ar + 8 * lda),
                             *reinterpret_cast<const unsigned*>(ar + 16),
                             *reinterpret_cast<const unsigned*>(ar + 8 * lda + 16)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a, bq[nt][0], bq[nt][1]);
    }
  }
}

struct Layout {
  size_t xq, h, hq, rows, total;
  int kp, hp, qp;  // row strides: xq bytes, h elements, hq bytes
  __host__ __device__ Layout(int K, int N1) {
    kp = K + 16;
    hp = N1 + 8;
    qp = N1 + 16;
    xq = 0;
    h = xq + (size_t)R * kp;
    hq = h + (size_t)R * hp * 2;
    rows = hq + (size_t)R * qp;
    total = rows + 4 * (size_t)R * 4;  // bf(xs), amax bits, bf(hr), bf(hs) per row
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ffn_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1q,
                const bf16* __restrict__ s1, const bf16* __restrict__ b1,
                const bf16* __restrict__ alpha, const int8_t* __restrict__ w2q,
                const bf16* __restrict__ s2, const bf16* __restrict__ b2, T* __restrict__ out,
                int N, int K, int N1, int K2) {
  const Layout lay(K, N1);
  const int r0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.xq);
  bf16* hsm = reinterpret_cast<bf16*>(smem + lay.h);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + lay.hq);
  float* row_xs = reinterpret_cast<float*>(smem + lay.rows);  // bf(xs)
  unsigned* row_ah = reinterpret_cast<unsigned*>(row_xs + R);  // amax |h|, float bits
  float* row_hr = reinterpret_cast<float*>(row_ah + R);        // bf(127 / max(ah, 1e-8))
  float* row_hs = row_hr + R;                                  // bf(max(ah, 1e-8) / 127)

  // (1) quantize the rows of x; rows past N repeat row N - 1 and are not
  // stored
  for (int r = warp; r < R; r += WARPS) {
    const T* xr = x + (size_t)min(r0 + r, N - 1) * K;
    float ax = 0.f;
    for (int d = lane; d < K; d += 32) ax = fmaxf(ax, fabsf(ldf(xr + d)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ax = fmaxf(ax, __shfl_xor_sync(0xffffffffu, ax, o));
    const float xs = fmaxf(ax, 1e-8f) * INV127;
    const float inv = rbf(1.0f / xs);
    for (int d = lane; d < K; d += 32) xq[r * lay.kp + d] = to_i8(rbf(rbf(ldf(xr + d)) * inv));
    if (lane == 0) {
      row_xs[r] = rbf(xs);
      row_ah[r] = 0u;
    }
  }
  __syncthreads();

  // (2) linear1, dequant, bias, PReLU into h, and each row's amax |h|
  const float al = __bfloat162float(alpha[0]);
  for (int p = warp; p < N1 / 32; p += WARPS) {
    const int n0 = p * 32;
    int acc[MT][NT][4];
    piece_product(acc, xq, lay.kp, w1q, K, n0, g, t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        const float xsr = row_xs[r];
        float amax = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = n0 + nt * 8 + 2 * t;
          float hv[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = rbf((float)acc[mt][nt][2 * half + i]);
            v = rbf(v * __bfloat162float(s1[c + i]));
            v = rbf(v * xsr);
            v = rbf(v + __bfloat162float(b1[c + i]));
            v = v > 0.f ? v : rbf(al * v);
            hv[i] = v;
            amax = fmaxf(amax, fabsf(v));
          }
          *reinterpret_cast<__nv_bfloat162*>(hsm + (size_t)r * lay.hp + c) =
              __floats2bfloat162_rn(hv[0], hv[1]);
        }
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        if (t == 0) atomicMax(row_ah + r, __float_as_uint(amax));  // amax >= 0: bits order as floats
      }
  }
  __syncthreads();

  // (3) each row's requantization and dequantization scales
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const float a = fmaxf(__uint_as_float(row_ah[r]), 1e-8f);
    row_hr[r] = rbf(127.0f / a);
    row_hs[r] = rbf(a * INV127);
  }
  __syncthreads();

  // (4) hq = int8(round(h * hr))
  const int half_n1 = N1 / 2;
  for (int idx = threadIdx.x; idx < R * half_n1; idx += THREADS) {
    const int r = idx / half_n1, c = 2 * (idx - r * half_n1);
    const float2 hv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(hsm + (size_t)r * lay.hp + c));
    const float hr = row_hr[r];
    hq[(size_t)r * lay.qp + c] = to_i8(rbf(hv.x * hr));
    hq[(size_t)r * lay.qp + c + 1] = to_i8(rbf(hv.y * hr));
  }
  __syncthreads();

  // (5) linear2, dequant and bias into the output
  for (int p = warp; p < K2 / 32; p += WARPS) {
    const int n0 = p * 32;
    int acc[MT][NT][4];
    piece_product(acc, hq, lay.qp, w2q, N1, n0, g, t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        if (r0 + r >= N) continue;
        const float hsr = row_hs[r];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = n0 + nt * 8 + 2 * t;
          float ov[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = rbf((float)acc[mt][nt][2 * half + i]);
            v = rbf(v * __bfloat162float(s2[c + i]));
            v = rbf(v * hsr);
            ov[i] = rbf(v + __bfloat162float(b2[c + i]));
          }
          st2(out + (size_t)(r0 + r) * K2 + c, ov[0], ov[1]);
        }
      }
  }
}

template <typename T>
int launch(const void* x, const void* w1q, const void* s1, const void* b1, const void* alpha,
           const void* w2q, const void* s2, const void* b2, void* out, int N, int K, int N1,
           int K2, cudaStream_t stream) {
  const size_t smem = Layout(K, N1).total;
  cudaError_t err = cudaFuncSetAttribute(ffn_int8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_int8_kernel<T><<<(N + R - 1) / R, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w1q), static_cast<const bf16*>(s1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(alpha),
      static_cast<const int8_t*>(w2q), static_cast<const bf16*>(s2),
      static_cast<const bf16*>(b2), static_cast<T*>(out), N, K, N1, K2);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a block needs for K inputs and N1 hidden units (bytes), so
// the wrapper can refuse before launching.
extern "C" long long ffn_int8_smem_bytes(int K, int N1) { return (long long)Layout(K, N1).total; }

// Plain C entry point, bound with ctypes. x: (N, K) and out: (N, K2), both
// bf16 (is_bf16 = 1) or both float32, contiguous; w1q: (N1, K) and w2q:
// (K2, N1) int8, contiguous; s1, b1: (N1,), s2, b2: (K2,) and alpha: (1,)
// bf16. K, N1 and K2 are multiples of 32, K and N1 at most 1040. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ffn_int8_launch(const void* x, const void* w1q, const void* s1, const void* b1,
                               const void* alpha, const void* w2q, const void* s2, const void* b2,
                               void* out, int N, int K, int N1, int K2, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || K <= 0 || N1 <= 0 || K2 <= 0 || K % 32 || N1 % 32 || K2 % 32 || K > 1040 ||
      N1 > 1040)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch<bf16>(x, w1q, s1, b1, alpha, w2q, s2, b2, out, N, K, N1, K2, s);
  return launch<float>(x, w1q, s1, b1, alpha, w2q, s2, b2, out, N, K, N1, K2, s);
}
