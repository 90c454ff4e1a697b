// Short-key multi-head attention for Hopper (sm_90a): long video queries
// against a short text key sequence (Lk <= 64), all heads of a query row in
// one warp, with the factored pair mask optional.
//
// Replaces two kernel families of mesm_tpu/ops/attention_pallas.py at the
// T2V / enhance cross-attention sites (charades: 128 x 194 queries x 16 or 17
// keys; QVHighlights: 30 x 75 x 32 or 33; E = 256, H = 8, head_dim 32):
//   - ONEMATMUL = false: _mha_kernel_packed_shortkey and _shortkey_nopair
//     (the packed family's short-key kernel, :213-259). Per (b, h, q):
//       qs = f32(q_h) * scale; logits = qs . k_h^T (f32)
//       pair (q, k) with qf[b, h, q] and kf[b, h, k] -> -1e9; masked keys -> -1e9
//       p = round(softmax(logits)) over the row's Lk keys (f32 softmax)
//       out_h = round(p . v_h)                      (f32 accumulation)
//   - ONEMATMUL = true: fused_attention_shortkey -> _mha_kernel_shortkey_
//     onematmul and _shortkey_onematmul_nopair (:262-416). Per (b, q):
//       qs = round(q * round(scale)); logits[h, j] = qs_h . k_h[j] (f32)
//       the same masks; gmax = the max over ALL heads' logits of the row
//       e = exp(logits - gmax); s_h = sum_j e[h, j] (per-head segment sums)
//       p[h, j] = round(s_h > 0 ? e[h, j] / s_h : 1 / Lk)
//       out_h = round(p_h . v_h)                    (f32 accumulation)
//     A segment whose every e underflowed to 0 (fully masked, or far below
//     another head's maximum) takes 1/Lk for every key, padded keys
//     included.
// round() is to the operand dtype: bf16, or nothing in fp32. A (b, h, q) row
// whose keys are all masked gets the uniform average of v over all Lk keys
// (the padded keys' v rows are projected biases, not zeros), never NaN.
//
// The TPU kernel of ONEMATMUL packs k and v block-diagonally over heads,
// kp (E, H*Lk) and vp (H*Lk, E), so that one dense matmul gives every head's
// logits: a lane-layout device of the TPU. Here each head reads its own
// head_dim slice of the model-native (B, Lk, E) operands, and no packed copy
// is built.
//
// What bounds it on the H100: the bytes of q and out (12.7 MB each at the
// charades shape: ~8 us at 3.35 TB/s); k and v are tiny and the products
// (~0.2 GFLOP) cost nothing at the tensor-core rate. Nothing but q, k, v,
// the masks and out touches device memory.
//
// Design: one block of 8 warps per (sample, tile of 16 query rows). The
// sample's K and V (at most 64 x 256 bf16 each, 32 KB), the key mask and the
// key pair factors sit in shared memory (the K rows padded to an odd word
// stride, so the lanes that split the keys hit distinct banks). A warp owns a
// query row: the row, scaled, is staged in a per-warp buffer, lanes split the
// keys for every head's logits, which stay in a per-warp shared buffer of
// H x Lk floats; the softmax is warp reductions; for P.V each lane owns one
// column of the head. A CUDA-core kernel; tensor-core tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;  // query rows per block
constexpr int HD = 32;    // head_dim
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
  static constexpr int KPAD = 2;  // K row stride E + 2: an odd number of 32-bit words
};
template <>
struct IO<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static constexpr int KPAD = 1;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

template <typename T>
struct Layout {
  size_t k, v, mask, kf, qrow, lg, total;
  __host__ __device__ Layout(int H, int Lk, int E) {
    k = 0;
    v = align16(k + (size_t)Lk * (E + IO<T>::KPAD) * sizeof(T));
    mask = align16(v + (size_t)Lk * E * sizeof(T));
    kf = align16(mask + (size_t)Lk);
    qrow = align16(kf + (size_t)H * Lk);
    lg = align16(qrow + (size_t)WARPS * E * 4);
    total = align16(lg + (size_t)WARPS * H * Lk * 4);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool ONEMATMUL, bool PAIR>
__global__ void __launch_bounds__(THREADS)
attention_shortkey_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ mask,
                          const uint8_t* __restrict__ qf, const uint8_t* __restrict__ kf,
                          T* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  const Layout<T> lay(H, Lk, E);
  const int KS = E + IO<T>::KPAD;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * ROWS;
  const int q1 = min(q0 + ROWS, Lq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  uint8_t* ms = smem + lay.mask;
  uint8_t* kfs = smem + lay.kf;
  float* qrow = reinterpret_cast<float*>(smem + lay.qrow) + (size_t)warp * E;
  float* lg = reinterpret_cast<float*>(smem + lay.lg) + (size_t)warp * H * Lk;

  // stage the sample's K, V, key mask and key pair factors
  const T* kb = k + (size_t)b * Lk * E;
  const T* vb = v + (size_t)b * Lk * E;
  for (int idx = threadIdx.x; idx < Lk * E; idx += THREADS) {
    const int j = idx / E, c = idx - (idx / E) * E;
    ks[(size_t)j * KS + c] = kb[idx];
    vs[idx] = vb[idx];
  }
  for (int j = threadIdx.x; j < Lk; j += THREADS) ms[j] = mask[(size_t)b * Lk + j];
  if (PAIR)
    for (int idx = threadIdx.x; idx < H * Lk; idx += THREADS) kfs[idx] = kf[(size_t)b * H * Lk + idx];
  __syncthreads();

  for (int qi = q0 + warp; qi < q1; qi += WARPS) {
    const T* qsrc = q + ((size_t)b * Lq + qi) * E;
    for (int d = lane; d < E; d += 32) {
      const float x = IO<T>::ld(qsrc + d) * scale;
      qrow[d] = ONEMATMUL ? IO<T>::rnd(x) : x;
    }
    __syncwarp();

    // every head's logits; kernel 4 finishes each head's softmax at once
    float gmax = -INFINITY;
    for (int h = 0; h < H; ++h) {
      const bool qflag = PAIR && qf[((size_t)b * H + h) * Lq + qi] != 0;
      const float* qh = qrow + h * HD;
      float* lh = lg + (size_t)h * Lk;
      float hmax = -INFINITY;
      for (int j = lane; j < Lk; j += 32) {
        const T* kr = ks + (size_t)j * KS + h * HD;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(qh[d], IO<T>::ld(kr + d), acc);
        if (PAIR && qflag && kfs[h * Lk + j]) acc = NEG_INF;
        if (!ms[j]) acc = NEG_INF;
        lh[j] = acc;
        hmax = fmaxf(hmax, acc);
      }
      if (ONEMATMUL) {
        gmax = fmaxf(gmax, hmax);
      } else {
        hmax = warp_max(hmax);
        float s = 0.f;
        for (int j = lane; j < Lk; j += 32) {
          const float e = expf(lh[j] - hmax);
          lh[j] = e;
          s += e;
        }
        s = warp_sum(s);
        for (int j = lane; j < Lk; j += 32) lh[j] = IO<T>::rnd(lh[j] / s);
      }
    }
    if (ONEMATMUL) {
      // segment softmax under the row's global max, 1/Lk for an empty segment
      gmax = warp_max(gmax);
      const float uniform = 1.0f / (float)Lk;
      for (int h = 0; h < H; ++h) {
        float* lh = lg + (size_t)h * Lk;
        float s = 0.f;
        for (int j = lane; j < Lk; j += 32) {
          const float e = expf(lh[j] - gmax);
          lh[j] = e;
          s += e;
        }
        s = warp_sum(s);
        for (int j = lane; j < Lk; j += 32) lh[j] = IO<T>::rnd(s > 0.f ? lh[j] / s : uniform);
      }
    }
    __syncwarp();

    // P.V: lane c owns column c of each head
    T* dst = out + ((size_t)b * Lq + qi) * E;
    for (int h = 0; h < H; ++h) {
      const float* lh = lg + (size_t)h * Lk;
      const T* vc = vs + h * HD + lane;
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(lh[j], IO<T>::ld(vc + (size_t)j * E), acc);
      IO<T>::st(dst + h * HD + lane, acc);
    }
    __syncwarp();  // qrow and lg are rewritten by the next row
  }
}

template <typename T, bool ONEMATMUL, bool PAIR>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* qf,
           const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<T>(H, Lk, E).total;
  auto kernel = attention_shortkey_kernel<T, ONEMATMUL, PAIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + ROWS - 1) / ROWS, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(qf),
      static_cast<const uint8_t*>(kf), static_cast<T*>(out), H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool ONEMATMUL>
int dispatch_pair(const void* q, const void* k, const void* v, const void* mask, const void* qf,
                  const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
                  cudaStream_t s) {
  if (qf != nullptr)
    return launch<T, ONEMATMUL, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  return launch<T, ONEMATMUL, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
}

}  // namespace

// Shared memory the kernel needs (bytes), so the wrapper can refuse before
// launching. is_bf16: 1 for bf16 operands, 0 for fp32.
extern "C" long long attention_shortkey_smem_bytes(int is_bf16, int H, int Lk, int E) {
  return is_bf16 ? (long long)Layout<bf16>(H, Lk, E).total
                 : (long long)Layout<float>(H, Lk, E).total;
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k, v: (B, Lk, E),
// out: (B, Lq, E), contiguous, bf16 (is_bf16 = 1) or fp32; E = 32 * H.
// mask: (B, Lk) uint8, 1 = attendable. qf (B, H, Lq) and kf (B, H, Lk)
// uint8 pair factors, or both null for no pair mask. onematmul: 0 = the
// packed short-key kernel (scale in f32), 1 = the one-matmul segment-softmax
// kernel (scale already rounded to the operand dtype). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int attention_shortkey_launch(const void* q, const void* k, const void* v,
                                         const void* mask, const void* qf, const void* kf,
                                         void* out, int B, int H, int Lq, int Lk, int E,
                                         int is_bf16, int onematmul, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E != HD * H || (qf == nullptr) != (kf == nullptr))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (onematmul)
      return dispatch_pair<bf16, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
    return dispatch_pair<bf16, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  }
  if (onematmul)
    return dispatch_pair<float, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  return dispatch_pair<float, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
}
