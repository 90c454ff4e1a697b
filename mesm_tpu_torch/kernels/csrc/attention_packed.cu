// Packed multi-head attention for Hopper (sm_90a), bf16, with and without
// the factored pair mask.
//
// Replaces two kernels of mesm_tpu/ops/attention_pallas.py (the "packed"
// branch of _fused_attention_impl):
//   - _mha_kernel_packed together with _softmax_lastdim (PAIR = false): the
//     DETR encoder's self-attention (charades: B = 128, L = 195 with the
//     global token, E = 256, H = 8, head_dim 32; launched once per encoder
//     layer);
//   - _mha_kernel_packed_pair (PAIR = true): the T2V / enhance
//     cross-attention under the scrambled pair mask when the text has 64
//     keys or more (charades with long queries: 128 x 194 x 81).
//
// What it computes, per (sample b, head h), at the TPU kernels' rounding
// points. PAIR = false (all intermediate roundings are to bf16):
//   qs = q_h * bf16(scale)                      (bf16 product)
//   logits = bf16(qs . k_h^T)                   (f32 accumulation)
//   masked keys -> bf16(-1e9), a finite value
//   m = max(logits); e = bf16(exp(bf16(logits - m)))
//   s = sum(e) in f32; p = bf16(e / bf16(s))
//   out_h = bf16(p . v_h)                       (f32 accumulation)
// PAIR = true (an f32 softmax, only p rounded):
//   qs = f32(q_h) * scale                       (f32 product)
//   logits = qs . k_h^T                         (f32)
//   pair (q, k) with qf[b, h, q] and kf[b, h, k] -> -1e9; masked keys -> -1e9
//   p = bf16(exp(logits - max) / sum(exp(logits - max)))   (f32 softmax)
//   out_h = bf16(p . v_h)                       (f32 accumulation)
// A row whose keys are all masked gets the uniform average of v over all Lk
// keys (padded keys included), never NaN. Operands stay (B, L, E): the head
// split is the column slice [h*hd, (h+1)*hd), read and written in place,
// with no transposes around the call. The pair factors are the model's
// (B, H, Lq) and (B, H, Lk) masks as uint8; the TPU kernel's head-major float
// copies were a Mosaic restriction.
//
// What bounds it on the H100: the bytes. q, k, v and out are 51 MB at the
// charades encoder shape (~15 us at 3.35 TB/s); the 5 GFLOP of the two
// products are ~5 us of tensor-core work. The (L, L) logits never leave the
// SM.
//
// Design: one block of 8 warps per (b, h). K_h and V_h (L x 32 bf16, 12.5 KB
// each), the key mask and, with PAIR, the key factor row are staged once in
// shared memory, so k and v are read from device memory once per head and q
// and out exactly once. One warp owns one query row at a time: its lanes
// split the keys for the logits (the K_h rows are padded to an odd word
// stride, so the 32 lanes hit 32 banks), the softmax is two warp reductions,
// and for P.V each lane owns one output column. The row's logits sit in a
// per-warp shared buffer. This is a CUDA-core kernel; tensor-core
// (mma/wgmma) tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

template <int HD>
struct Smem {
  static constexpr int KS = HD + 2;  // K_h row stride in bf16: an odd number of 32-bit words
  static size_t bytes(int Lk) {
    size_t b = (size_t)Lk * KS * 2 + (size_t)Lk * HD * 2;  // K_h, V_h
    b = (b + 15) & ~(size_t)15;
    b += (size_t)WARPS * Lk * 4 + (size_t)WARPS * HD * 4;  // per-warp logits row, q row
    b += 2 * (size_t)Lk;                                    // key mask, key pair factor
    return b;
  }
};

template <int HD, bool PAIR>
__global__ void __launch_bounds__(THREADS)
attention_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ qf, const uint8_t* __restrict__ kf,
                        bf16* __restrict__ out, int H, int Lq, int Lk, int E, int Ev,
                        float scale) {
  constexpr int KS = Smem<HD>::KS;
  constexpr int HALF = HD / 2;
  constexpr int PER_LANE = HD / 32;  // output columns per lane in P.V
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)Lk * KS;
  size_t off = ((size_t)Lk * KS * 2 + (size_t)Lk * HD * 2 + 15) & ~(size_t)15;
  float* ps = reinterpret_cast<float*>(smem + off);
  float* qsm = ps + (size_t)WARPS * Lk;
  uint8_t* ms = reinterpret_cast<uint8_t*>(qsm + WARPS * HD);
  uint8_t* kfs = ms + Lk;

  // stage K_h, V_h (bf16 pairs), the mask row and the key factor row
  const bf16* kb = k + (size_t)b * Lk * E + h * HD;
  const bf16* vb = v + (size_t)b * Lk * Ev + h * HD;
  for (int idx = threadIdx.x; idx < Lk * HALF; idx += THREADS) {
    const int j = idx / HALF, d2 = idx - (idx / HALF) * HALF;
    reinterpret_cast<__nv_bfloat162*>(ks + (size_t)j * KS)[d2] =
        reinterpret_cast<const __nv_bfloat162*>(kb + (size_t)j * E)[d2];
    reinterpret_cast<__nv_bfloat162*>(vs + (size_t)j * HD)[d2] =
        reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)j * Ev)[d2];
  }
  for (int j = threadIdx.x; j < Lk; j += THREADS) {
    ms[j] = mask[(size_t)b * Lk + j];
    if (PAIR) kfs[j] = kf[((size_t)b * H + h) * Lk + j];
  }
  __syncthreads();

  float* prow = ps + (size_t)warp * Lk;
  float* qrow = qsm + warp * HD;
  const float neg = PAIR ? NEG_INF : rbf(NEG_INF);
  for (int qi = warp; qi < Lq; qi += WARPS) {
    const bf16* qsrc = q + ((size_t)b * Lq + qi) * E + h * HD;
    for (int d = lane; d < HD; d += 32) {
      const float x = __bfloat162float(qsrc[d]) * scale;
      qrow[d] = PAIR ? x : rbf(x);
    }
    const bool qflag = PAIR && qf[((size_t)b * H + h) * Lq + qi] != 0;
    __syncwarp();
    float qr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qrow[d];

    // logits, lanes split the keys
    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + (size_t)j * KS);
      float acc = 0.f;
#pragma unroll
      for (int d2 = 0; d2 < HALF; ++d2) {
        const float2 kk = __bfloat1622float2(kr[d2]);
        acc = fmaf(qr[2 * d2], kk.x, acc);
        acc = fmaf(qr[2 * d2 + 1], kk.y, acc);
      }
      float l = PAIR ? acc : rbf(acc);
      if (PAIR && qflag && kfs[j]) l = neg;
      if (!ms[j]) l = neg;
      prow[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));

    // exp (bf16 without PAIR, f32 with it), denominator summed in f32
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = PAIR ? expf(prow[j] - mx) : rbf(expf(rbf(prow[j] - mx)));
      prow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float sb = PAIR ? sum : rbf(sum);
    for (int j = lane; j < Lk; j += 32) prow[j] = rbf(prow[j] / sb);
    __syncwarp();

    // P.V: each lane owns PER_LANE output columns
    float acc[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) acc[t] = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t)
        acc[t] = fmaf(p, __bfloat162float(vs[(size_t)j * HD + lane + 32 * t]), acc[t]);
    }
    bf16* dst = out + ((size_t)b * Lq + qi) * Ev + h * HD;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) dst[lane + 32 * t] = __float2bfloat16(acc[t]);
    __syncwarp();  // prow and qrow are rewritten by the next row
  }
}

template <int HD, bool PAIR>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* qf,
           const void* kf, void* out, int B, int H, int Lq, int Lk, int E, int Ev, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes(Lk);
  cudaError_t err = cudaFuncSetAttribute(attention_packed_kernel<HD, PAIR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_packed_kernel<HD, PAIR><<<B * H, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(qf),
      static_cast<const uint8_t*>(kf), static_cast<bf16*>(out), H, Lq, Lk, E, Ev, scale);
  return (int)cudaGetLastError();
}

template <bool PAIR>
int dispatch(const void* q, const void* k, const void* v, const void* mask, const void* qf,
             const void* kf, void* out, int B, int H, int Lq, int Lk, int E, int Ev, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0 || Ev != E)
    return (int)cudaErrorInvalidValue;
  const int hd = E / H;
  if (hd == 32) return launch<32, PAIR>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, Ev, scale, s);
  if (hd == 64) return launch<64, PAIR>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, Ev, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory the kernel needs for head_dim `hd` and `Lk` keys (0 when hd
// is not one the kernel takes), so the wrapper can refuse before launching.
extern "C" long long attention_packed_smem_bytes(int hd, int Lk) {
  if (hd == 32) return (long long)Smem<32>::bytes(Lk);
  if (hd == 64) return (long long)Smem<64>::bytes(Lk);
  return 0;
}

// Plain C entry points, bound with ctypes. q: (B, Lq, E), k: (B, Lk, E),
// v: (B, Lk, Ev), out: (B, Lq, Ev), all bf16 and contiguous; mask: (B, Lk)
// uint8, 1 = attendable. Head h reads and writes columns [h*hd, (h+1)*hd)
// with hd = E / H = Ev / H, 32 or 64. Each returns the cudaError_t of the
// launch (0 = success).
//
// attention_packed_launch: scale_bf16 is the softmax scale already rounded
// to bf16.
extern "C" int attention_packed_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int B, int H, int Lq, int Lk,
                                       int E, int Ev, float scale_bf16, void* stream) {
  return dispatch<false>(q, k, v, mask, nullptr, nullptr, out, B, H, Lq, Lk, E, Ev, scale_bf16,
                         stream);
}

// attention_packed_pair_launch: qf (B, H, Lq) and kf (B, H, Lk) uint8 pair
// factors (pair (q, k) of head (b, h) is masked when both are 1); scale is
// the f32 softmax scale.
extern "C" int attention_packed_pair_launch(const void* q, const void* k, const void* v,
                                            const void* mask, const void* qf, const void* kf,
                                            void* out, int B, int H, int Lq, int Lk, int E, int Ev,
                                            float scale, void* stream) {
  return dispatch<true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, Ev, scale, stream);
}
