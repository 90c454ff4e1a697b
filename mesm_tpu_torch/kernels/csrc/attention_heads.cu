// Multi-head attention for Hopper (sm_90a) in the two layouts the attention
// dispatch reaches only through MESM_ATTN_VARIANT, float32 or bf16.
//
// Replaces two kernels of mesm_tpu/ops/attention_pallas.py (branches of
// _fused_attention_impl, :534-567):
//   - ALL_HEADS = false: _mha_kernel (:44), "per_head", one grid step per
//     (sample, head) over (B, H, L, hd) operands;
//   - ALL_HEADS = true: _mha_kernel_allheads (:66), "all_heads", one grid
//     step per sample that loops over the heads.
// Both sit where the bf16 packed or the fp32 batched kernel sits by default:
// the DETR encoder's self-attention (charades bf16: 128 x 195 x 195;
// TACoS fp32: 16 x 601 x 601; E = 256, H = 8, head_dim 32).
//
// What it computes, per (sample b, head h), as attention_batched_reference:
//   qs = round(q_h * round(scale))              (a product in the input dtype)
//   logits = qs . k_h^T                         (f32 sums)
//   masked keys -> -1e9, a finite value
//   p = round(softmax(logits))                  (exact two-pass f32 softmax)
//   out_h = round(p . v_h)                      (f32 sums)
// round() is to the input dtype: nothing in fp32, bf16 in bf16. A row whose
// keys are all masked gets the uniform average of v, never NaN.
//
// What bounds it on the H100: the operations in fp32 (TACoS: 5.9 GFLOP of
// FMA work, 88 us at 67 TFLOP/s, against 39 MB of q, k, v and out), the
// bytes in bf16 (charades: 51 MB, 15 us; 5 GFLOP are 5 us at the bf16
// tensor-core rate).
//
// Design: operands stay (B, L, E), the head split is the column slice
// [h*hd, (h+1)*hd) read and written in place, so none of the TPU wrapper's
// (B, H, L, hd) transposes is made around the call. A block of 8 warps takes
// a tile of ROWS query rows of one sample and, per head, stages K_h and V_h
// (Lk x hd, the K rows padded to an odd word stride) and the key mask in
// shared memory. per_head: one block per (sample, head, query tile), as the
// TPU grid's (b, h) steps; all_heads: one block per (sample, query tile),
// which walks the H heads in turn, restaging K_h and V_h for each. One warp
// owns one query row at a time: the scaled row sits in a per-warp buffer,
// the lanes split the keys for the logits, and the whole Lk-long logits row
// stays in a per-warp shared buffer for an exact two-pass softmax (max, then
// the sum of exp), as the TPU body's softmax: no online rescaling.
// For P.V each lane owns hd / 32 output columns. A CUDA-core kernel;
// tensor-core tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;  // query rows per block
constexpr float NEG_INF = -1e9f;

template <typename T>
struct IO;
template <>
struct IO<bf16> {
  static __device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16(x); }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static constexpr int KPAD = 2;  // K_h row stride HD + 2: an odd number of 32-bit words
};
template <>
struct IO<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static constexpr int KPAD = 1;
};

template <typename T, int HD>
struct Smem {
  static constexpr int KS = HD + IO<T>::KPAD;  // K_h row stride in elements
  static size_t bytes(int Lk) {
    size_t b = ((size_t)Lk * KS + (size_t)Lk * HD) * sizeof(T);  // K_h, V_h
    b = (b + 15) & ~(size_t)15;
    b += (size_t)WARPS * Lk * 4 + (size_t)WARPS * HD * 4;  // per-warp logits row, q row
    b += (size_t)Lk;                                        // key mask
    return b;
  }
};

template <typename T, int HD, bool ALL_HEADS>
__global__ void __launch_bounds__(THREADS)
attention_heads_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int Lq,
                       int Lk, int E, float scale) {
  constexpr int KS = Smem<T, HD>::KS;
  constexpr int PER_LANE = HD / 32;  // output columns per lane in P.V
  const int b = ALL_HEADS ? blockIdx.x : blockIdx.x / H;
  const int h0 = ALL_HEADS ? 0 : blockIdx.x - b * H;
  const int h1 = ALL_HEADS ? H : h0 + 1;
  const int q0 = blockIdx.y * ROWS, q1 = min(q0 + ROWS, Lq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)Lk * KS;
  const size_t off = (((size_t)Lk * KS + (size_t)Lk * HD) * sizeof(T) + 15) & ~(size_t)15;
  float* prow = reinterpret_cast<float*>(smem + off) + (size_t)warp * Lk;
  float* qrow = reinterpret_cast<float*>(smem + off) + (size_t)WARPS * Lk + warp * HD;
  uint8_t* ms = smem + off + ((size_t)WARPS * Lk + WARPS * HD) * 4;

  for (int j = threadIdx.x; j < Lk; j += THREADS) ms[j] = mask[(size_t)b * Lk + j];
  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the previous head's K_h and V_h are read
    const T* kb = k + (size_t)b * Lk * E + h * HD;
    const T* vb = v + (size_t)b * Lk * E + h * HD;
    for (int idx = threadIdx.x; idx < Lk * HD; idx += THREADS) {
      const int j = idx / HD, d = idx - (idx / HD) * HD;
      ks[(size_t)j * KS + d] = kb[(size_t)j * E + d];
      vs[(size_t)j * HD + d] = vb[(size_t)j * E + d];
    }
    __syncthreads();

    for (int qi = q0 + warp; qi < q1; qi += WARPS) {
      const T* qsrc = q + ((size_t)b * Lq + qi) * E + h * HD;
      for (int d = lane; d < HD; d += 32) qrow[d] = IO<T>::rnd(IO<T>::ld(qsrc + d) * scale);
      __syncwarp();
      float qr[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) qr[d] = qrow[d];

      // f32 logits, lanes split the keys
      float mx = -INFINITY;
      for (int j = lane; j < Lk; j += 32) {
        const T* kr = ks + (size_t)j * KS;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], IO<T>::ld(kr + d), acc);
        if (!ms[j]) acc = NEG_INF;
        prow[j] = acc;
        mx = fmaxf(mx, acc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));

      // exact two-pass softmax over the stored row, p rounded to the dtype
      float sum = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        const float e = expf(prow[j] - mx);
        prow[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < Lk; j += 32) prow[j] = IO<T>::rnd(prow[j] / sum);
      __syncwarp();

      // P.V: each lane owns PER_LANE output columns
      float acc[PER_LANE];
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) acc[t] = 0.f;
      for (int j = 0; j < Lk; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t)
          acc[t] = fmaf(p, IO<T>::ld(vs + (size_t)j * HD + lane + 32 * t), acc[t]);
      }
      T* dst = out + ((size_t)b * Lq + qi) * E + h * HD;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) IO<T>::st(dst + lane + 32 * t, acc[t]);
      __syncwarp();  // prow and qrow are rewritten by the next row
    }
  }
}

template <typename T, int HD, bool ALL_HEADS>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
           int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::bytes(Lk);
  auto kernel = attention_heads_kernel<T, HD, ALL_HEADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ALL_HEADS ? B : B * H, (Lq + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v),
                                          static_cast<const uint8_t*>(mask), static_cast<T*>(out),
                                          H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool ALL_HEADS>
int dispatch_hd(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  const int hd = E / H;
  if (hd == 32) return launch<T, 32, ALL_HEADS>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  if (hd == 64) return launch<T, 64, ALL_HEADS>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
long long smem_bytes(int hd, int Lk) {
  if (hd == 32) return (long long)Smem<T, 32>::bytes(Lk);
  if (hd == 64) return (long long)Smem<T, 64>::bytes(Lk);
  return 0;
}

}  // namespace

// Shared memory a block needs for bf16 (is_bf16 = 1) or float32 operands,
// head_dim `hd` and `Lk` keys (0 when hd is not one the kernel takes), so
// the wrapper can refuse before launching.
extern "C" long long attention_heads_smem_bytes(int is_bf16, int hd, int Lk) {
  return is_bf16 ? smem_bytes<bf16>(hd, Lk) : smem_bytes<float>(hd, Lk);
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k, v: (B, Lk, E),
// out: (B, Lq, E), all bf16 (is_bf16 = 1) or all float32, contiguous; mask:
// (B, Lk) uint8, 1 = attendable. Head h reads and writes columns
// [h*hd, (h+1)*hd) with hd = E / H, 32 or 64. all_heads: 0 = one block per
// (sample, head, query tile), 1 = one block per (sample, query tile) over
// every head. scale is the softmax scale rounded to the operand dtype.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int attention_heads_launch(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int B, int H, int Lq, int Lk,
                                      int E, int is_bf16, int all_heads, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (all_heads) return dispatch_hd<bf16, true>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
    return dispatch_hd<bf16, false>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  }
  if (all_heads) return dispatch_hd<float, true>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  return dispatch_hd<float, false>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
}
