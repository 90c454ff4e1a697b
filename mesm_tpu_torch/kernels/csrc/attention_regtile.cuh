// Device code of attention_batched.cu: the register-tile body of bf16
// multi-head attention over (B, L, E) operands, for one (sample b, head h)
// and a tile of BM query rows, on the CUDA cores: the route of the bf16
// batched kernel for keys past what its tensor-core body stages (more than
// 3,536 keys at hd 16, 1,760 at 32, 864 at 64, 416 at 128).
//
// What it computes, per (sample b, head h), as attention_batched_reference
// in bf16, with bf() the rounding to bf16:
//   qs = bf(q_h * bf(scale))                    (a product in bf16)
//   logits = qs . k_h^T                         (f32 sums over hd, in order)
//   masked keys -> -1e9, a finite value
//   p = bf(softmax(logits))                     (f32 softmax)
//   out_h = bf(p . v_h)                         (f32 sums)
// A row whose keys are all masked gets the uniform average of v, never NaN.
// The head split is the column slice [h*hd, (h+1)*hd), read and written in
// place.
//
// Design: a block of 256 threads takes one (b, h) and a tile of BM = 64
// query rows, and walks the keys in tiles of BN = 64: the Q tile (scaled),
// each K tile (both stored d-major) and V tile sit in shared memory as
// floats. Thread (ty, tx) of a 16 x 16 grid computes a 4 x 4 tile of the
// logits, each pair of 16-byte loads feeding 16 FMAs. Each probability is
// rounded after it is normalised, which an online softmax cannot do: a
// first walk over the key tiles takes each row's max and sum (online, with
// the row reductions across the 16 threads of a half-warp by shuffles), the
// second recomputes the logits and accumulates bf(p) . v, each thread 4
// rows x hd/16 columns of the output. Keys past Lk are left out
// (probability 0); masked keys take -1e9, as in the plain version. q, k, v
// and out start on 16-byte boundaries (8-byte loads). head_dim 16, 32, 64
// or 128 (CT = hd / 16 output columns a thread). The float32 kernels run on
// the tensor cores (attention_fp32.cuh).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace regtile {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per tile
constexpr float NEG_INF = -1e9f;
constexpr int STRIDE = 68;  // row stride (floats) of the d-major and P tiles: 16-byte rows

struct IO {
  static __device__ __forceinline__ float4 ld4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, c.x, c.y);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16(x); }
};

template <int HD>
struct Smem {
  // Qs [HD][STRIDE], Ks [HD][STRIDE], Vs [BN][HD], Ps [BN][STRIDE] floats,
  // then the key flags of the tile
  static constexpr size_t bytes = (size_t)(2 * HD * STRIDE + BN * HD + BN * STRIDE) * 4 + BN;
};

// The output rows [q0, q0 + BM) of head h of sample b, by the THREADS
// threads of the block, with Smem<HD>::bytes of dynamic shared memory at
// `smem`.
template <int HD>
__device__ __forceinline__ void attend(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                                       int Lq, int Lk, int E, float scale, int b, int h, int q0,
                                       unsigned char* smem) {
  constexpr int D4 = HD / 4;
  constexpr int CT = HD / 16;  // output columns per thread
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

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
    const float4 x = IO::ld4(q + ((size_t)b * Lq + qi) * E + h * HD + 4 * d4);
    Qs[(4 * d4 + 0) * STRIDE + r] = IO::rnd(x.x * scale);
    Qs[(4 * d4 + 1) * STRIDE + r] = IO::rnd(x.y * scale);
    Qs[(4 * d4 + 2) * STRIDE + r] = IO::rnd(x.z * scale);
    Qs[(4 * d4 + 3) * STRIDE + r] = IO::rnd(x.w * scale);
  }

  float o[4][CT], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < CT; ++t) o[r][t] = 0.f;
  }

  // pass 0 takes each row's max and sum, pass 1 accumulates bf(p) . v
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < Lk; k0 += BN) {
      __syncthreads();  // the previous tile's K, V and P are read
      for (int idx = tid; idx < BN * D4; idx += THREADS) {
        const int j = idx % BN, d4 = idx / BN;
        const int kj = min(k0 + j, Lk - 1);
        const float4 x = IO::ld4(k + ((size_t)b * Lk + kj) * E + h * HD + 4 * d4);
        Ks[(4 * d4 + 0) * STRIDE + j] = x.x;
        Ks[(4 * d4 + 1) * STRIDE + j] = x.y;
        Ks[(4 * d4 + 2) * STRIDE + j] = x.z;
        Ks[(4 * d4 + 3) * STRIDE + j] = x.w;
      }
      if (pass == 1) {
        for (int idx = tid; idx < BN * D4; idx += THREADS) {
          const int j = idx / D4, d4 = idx - (idx / D4) * D4;
          const int kj = min(k0 + j, Lk - 1);
          reinterpret_cast<float4*>(Vs + j * HD)[d4] =
              IO::ld4(v + ((size_t)b * Lk + kj) * E + h * HD + 4 * d4);
        }
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
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint8_t f = Fs[4 * tx + c];
          s[r][c] = f == 2 ? -INFINITY : (f ? s[r][c] : NEG_INF);
        }

      if (pass == 1) {
        // the row's max and sum are final: p = bf(exp(s - m) / l)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = IO::rnd(expf(s[r][c] - m[r]) / l[r]);
      } else {
        // online softmax: the running max and sum of each row
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c) tmax = fmaxf(tmax, s[r][c]);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
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
        }
      }
      if (pass == 0) continue;  // the statistics walk stops here
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
        if constexpr (CT == 1) {
          vv[0] = Vs[j * HD + tx];
        } else if constexpr (CT == 2) {
          const float2 x = *reinterpret_cast<const float2*>(Vs + j * HD + 2 * tx);
          vv[0] = x.x;
          vv[1] = x.y;
        } else {
#pragma unroll
          for (int u = 0; u < CT / 4; ++u) {
            const float4 x = *reinterpret_cast<const float4*>(Vs + j * HD + CT * tx + 4 * u);
            vv[4 * u] = x.x;
            vv[4 * u + 1] = x.y;
            vv[4 * u + 2] = x.z;
            vv[4 * u + 3] = x.w;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int t = 0; t < CT; ++t) o[r][t] = fmaf(pv[r], vv[t], o[r][t]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi < Lq) {
      bf16* dst = out + ((size_t)b * Lq + qi) * E + h * HD + CT * tx;
#pragma unroll
      for (int t = 0; t < CT; ++t) IO::st(dst + t, o[r][t]);
    }
  }
}

}  // namespace regtile
