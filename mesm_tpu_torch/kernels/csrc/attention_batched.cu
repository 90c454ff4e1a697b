// Multi-head attention for Hopper (sm_90a), float32, heads split in the kernel.
//
// Replaces: mesm_tpu/ops/attention_pallas.py::_mha_kernel_batched (the
// "batched" branch of _fused_attention_impl, wrapper :503-533), the fp32 tier
// of the attention dispatch: the DETR encoder's self-attention at the TACoS
// geometry (B = 16 eval rows or 32 stacked train rows, L = 601 with the global
// token, E = 256, H = 8, head_dim 32; launched once per encoder layer). It is
// also the forward of the trainable attention (ops/attention_trainable.py)
// in fp32.
//
// What it computes, per (sample b, head h), all in float32 (no TF32):
//   qs = q_h * scale                            (f32 product, scale = hd^-0.5)
//   logits = qs . k_h^T                         (f32 sums over hd, in order)
//   masked keys -> -1e9, a finite value
//   out_h = softmax(logits) . v_h               (max-subtracted, f32)
// A row whose keys are all masked gets the uniform average of v, never NaN.
// Operands stay (B, L, E): the head split is the column slice
// [h*hd, (h+1)*hd), read and written in place; the TPU wrapper's
// (B, H, L, hd) transposes existed for Mosaic and are not carried over.
//
// What bounds it on the H100: the operations. At B = 16, L = 601, hd = 32
// the two products are 5.9 GFLOP of fp32 FMA work (88 us at 67 TFLOP/s)
// against 39 MB of q, k, v and out (12 us at 3.35 TB/s).
//
// Design: the FMA pipes have to be kept busy, so the work is cut into many
// small blocks with register tiles, flash-attention style. A block of 256
// threads takes one (b, h) and a tile of BM = 64 query rows, and walks the
// keys in tiles of BN = 64: the Q tile (scaled), each K tile (both stored
// d-major) and V tile sit in 43 KB of shared memory, so several blocks share
// an SM. Thread (ty, tx) of a 16 x 16 grid computes a 4 x 4 tile of the
// logits, each pair of 16-byte loads feeding 16 FMAs; the softmax is online
// (a running row max and sum, rescaling the output when the max grows),
// with the row reductions across the 16 threads of a half-warp by shuffles;
// the tile's probabilities go to shared memory transposed, and each thread
// accumulates 4 rows x hd/16 columns of the output, dividing by the row sum
// at the end. The online rescaling rounds at other points than the plain
// version's two-pass softmax, a few f32 ulps. Keys past Lk are left out
// (probability 0); masked keys take -1e9, as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per tile
constexpr float NEG_INF = -1e9f;
constexpr int STRIDE = 68;  // row stride (floats) of the d-major and P tiles: 16-byte rows

template <int HD>
struct Smem {
  // Qs [HD][STRIDE], Ks [HD][STRIDE], Vs [BN][HD], Ps [BN][STRIDE] floats,
  // then the key flags of the tile
  static constexpr size_t bytes = (size_t)(2 * HD * STRIDE + BN * HD + BN * STRIDE) * 4 + BN;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_batched_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ mask,
                         float* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  constexpr int D4 = HD / 4;
  constexpr int CT = HD / 16;  // output columns per thread
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int q0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + HD * STRIDE;
  float* Vs = Ks + HD * STRIDE;
  float* Ps = Vs + BN * HD;
  uint8_t* Fs = reinterpret_cast<uint8_t*>(Ps + BN * STRIDE);  // 0 masked, 1 valid, 2 no key

  // the query tile, scaled, d-major; rows past Lq repeat the last row and
  // are not stored
  for (int idx = tid; idx < BM * D4; idx += THREADS) {
    const int r = idx % BM, d4 = idx / BM;
    const int qi = min(q0 + r, Lq - 1);
    const float4 x = reinterpret_cast<const float4*>(q + ((size_t)b * Lq + qi) * E + h * HD)[d4];
    Qs[(4 * d4 + 0) * STRIDE + r] = x.x * scale;
    Qs[(4 * d4 + 1) * STRIDE + r] = x.y * scale;
    Qs[(4 * d4 + 2) * STRIDE + r] = x.z * scale;
    Qs[(4 * d4 + 3) * STRIDE + r] = x.w * scale;
  }

  float o[4][CT], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < CT; ++t) o[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and P are read
    for (int idx = tid; idx < BN * D4; idx += THREADS) {
      const int j = idx % BN, d4 = idx / BN;
      const int kj = min(k0 + j, Lk - 1);
      const float4 x = reinterpret_cast<const float4*>(k + ((size_t)b * Lk + kj) * E + h * HD)[d4];
      Ks[(4 * d4 + 0) * STRIDE + j] = x.x;
      Ks[(4 * d4 + 1) * STRIDE + j] = x.y;
      Ks[(4 * d4 + 2) * STRIDE + j] = x.z;
      Ks[(4 * d4 + 3) * STRIDE + j] = x.w;
    }
    for (int idx = tid; idx < BN * D4; idx += THREADS) {
      const int j = idx / D4, d4 = idx - (idx / D4) * D4;
      const int kj = min(k0 + j, Lk - 1);
      reinterpret_cast<float4*>(Vs + j * HD)[d4] =
          reinterpret_cast<const float4*>(v + ((size_t)b * Lk + kj) * E + h * HD)[d4];
    }
    for (int j = tid; j < BN; j += THREADS)
      Fs[j] = k0 + j < Lk ? (mask[(size_t)b * Lk + k0 + j] ? 1 : 0) : 2;
    __syncthreads();

    // logits of rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + d * STRIDE + 4 * ty);
      const float4 kk = *reinterpret_cast<const float4*>(Ks + d * STRIDE + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], kv[c], s[r][c]);
    }

    // online softmax: the running max and sum of each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint8_t f = Fs[4 * tx + c];
        s[r][c] = f == 2 ? -INFINITY : (f ? s[r][c] : NEG_INF);
        tmax = fmaxf(tmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mn = fmaxf(m[r], tmax);  // finite: a tile holds at least one key
      const float alpha = expf(m[r] - mn);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - mn);
        rs += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = mn;
#pragma unroll
      for (int t = 0; t < CT; ++t) o[r][t] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Ps + (4 * tx + c) * STRIDE + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // P.V: rows 4ty.., columns CT*tx..
    const int kn = min(BN, Lk - k0);
    for (int j = 0; j < kn; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + j * STRIDE + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[CT];
      if constexpr (CT == 2) {
        const float2 x = *reinterpret_cast<const float2*>(Vs + j * HD + 2 * tx);
        vv[0] = x.x;
        vv[1] = x.y;
      } else {
        const float4 x = *reinterpret_cast<const float4*>(Vs + j * HD + 4 * tx);
        vv[0] = x.x;
        vv[1] = x.y;
        vv[2] = x.z;
        vv[3] = x.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < CT; ++t) o[r][t] = fmaf(pv[r], vv[t], o[r][t]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi < Lq) {
      float* dst = out + ((size_t)b * Lq + qi) * E + h * HD + CT * tx;
#pragma unroll
      for (int t = 0; t < CT; ++t) dst[t] = o[r][t] / l[r];
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
           int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_batched_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + BM - 1) / BM);
  attention_batched_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a block takes for head_dim `hd` (0 when hd is not one the
// kernel takes); it does not depend on the lengths, since the keys stream
// through in tiles.
extern "C" long long attention_batched_smem_bytes(int hd, int Lk) {
  (void)Lk;
  if (hd == 32) return (long long)Smem<32>::bytes;
  if (hd == 64) return (long long)Smem<64>::bytes;
  return 0;
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k and v: (B, Lk, E),
// out: (B, Lq, E), all float32, contiguous and 16-byte aligned; mask: (B, Lk)
// uint8, 1 = attendable. Head h reads and writes columns [h*hd, (h+1)*hd)
// with hd = E / H, 32 or 64. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int attention_batched_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int H, int Lq, int Lk,
                                        int E, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0) return (int)cudaErrorInvalidValue;
  const int hd = E / H;
  if (hd == 32) return launch<32>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  if (hd == 64) return launch<64>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  return (int)cudaErrorInvalidValue;
}
