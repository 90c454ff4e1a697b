// The backward of float32 multi-head attention over (B, L, E) operands for
// Hopper (sm_90a), on the CUDA cores: the gradients that autograd gives for
// models/attention.attention_core with a key mask and no pair factors.
//
// Replaces the backward of mesm_tpu/ops/attention_pallas.py::
// fused_attention_trainable (`_fat_bwd`, :599-614), which has no Pallas
// kernel: it is XLA's VJP of the plain core, which XLA fuses on the TPU.
// Here two kernels compute the same gradients flash-attention style, and
// the (B, H, Lq, Lk) logits never leave the SM.
//
// What they compute, per (sample b, head h), with qs = q_h * scale (an f32
// product, as attention_core's) and O the forward's output:
//   S = qs . k_h^T; masked keys -> -1e9 (a finite value)
//   P = softmax(S) over exactly Lk keys; D_i = sum_d dO_id O_id
//   dV = P^T . dO;  dP = dO . v_h^T;  dS = P o (dP - D), 0 at masked keys
//   dQ = (dS . k_h) * scale;  dK = dS^T . qs
// A row whose keys are all masked has P uniform over all Lk keys: its dO
// reaches dV through every key, and its dS is 0 (torch.where passes no
// gradient to a masked logit). D equals sum_j P_ij dP_ij, the sum autograd
// takes; here it comes from O, since P is never stored.
//
// What bounds it on the H100: the operations. At the TACoS train shape (32
// x 601 x 601, H 8, hd 32) one product is 5.9 GFLOP, 88 us at 67 TFLOP/s;
// the gradients need at least five (S, dP, dV, dQ, dK). The tensor cores'
// TF32 keeps 10 mantissa bits, too few for the f32 core's gradients.
//
// Design: deterministic (no atomics: each sum is taken by one thread in a
// fixed order), on register tiles as attention_regtile.cuh: blocks of 256
// threads, tiles of 64 rows x 64 keys with the operands in shared memory as
// floats (d-major for the products over head_dim, so each pair of 16-byte
// loads feeds 16 FMAs), each thread a 4 x 4 tile of S and dP and a
// 4 x hd/16 tile of its gradient rows. Two launches:
//   - attention_backward_dq_kernel, one block per (b, 64-query tile, h):
//     D of its rows from O and dO, then one walk over the key tiles that
//     computes S, dP and e = exp(S - m) with each row's running max m and
//     sum l (online, as the forward), and accumulates e o (dP - D) . K,
//     rescaled when m grows; at the end dQ = that sum * scale / l, and
//     (m, 1/l, D) of each row go to a (B, H, Lq, 3) scratch;
//   - attention_backward_dkdv_kernel, after it on the stream, one block per
//     (b, 64-key tile, h): its keys' K_h and V_h stay in shared memory while
//     it walks the query tiles, recomputes S^T and P^T = exp(S^T - m) / l
//     from the scratch, computes dP^T and dS^T, and accumulates dV and dK.
// Seven products where the function needs five (S and dP in both kernels),
// and no scratch beyond the 12 bytes of statistics a query row and head:
// the memory of the backward grows as Lq + Lk, not as Lq * Lk. A design
// with one product fewer (the dk / dv kernel also writing each key tile's
// dQ partial sums, summed by a third kernel) needs 4 bytes a query row, key
// tile and head_dim column: Lq * Lk * hd / 16 bytes a (b, h), hd / 64 of
// the f32 logits (199 MB at the TACoS shape); PERF.md holds the two
// against each other.

#include "attention_grid.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;    // query rows or keys of a tile
constexpr int STRIDE = 68;  // row stride (floats) of the d-major and transposed tiles
constexpr float NEG_INF = -1e9f;

// Dynamic shared memory of each kernel, in bytes.
template <int HD>
struct DqSmem {
  // Qd, Gd, Kd, Vd [HD][STRIDE]; Kr [TILE][HD]; Ps [TILE][STRIDE]; Dr [TILE];
  // then TILE key flags
  static constexpr size_t bytes =
      (size_t)(4 * HD * STRIDE + TILE * HD + TILE * STRIDE + TILE) * 4 + TILE;
};
template <int HD>
struct DkdvSmem {
  // Kd, Vd, Qd, Gd [HD][STRIDE]; Qr, Gr [TILE][HD]; Pt, St [TILE][STRIDE];
  // Ms, Rs, Ds [TILE]
  static constexpr size_t bytes =
      (size_t)(4 * HD * STRIDE + 2 * TILE * HD + 2 * TILE * STRIDE + 3 * TILE) * 4;
};

// Rows [0, TILE) of a tile (row stride E floats; `rows` of them read, zeros
// beyond), each value times `mul`, into dst d-major: dst[d * STRIDE + r].
template <int HD>
__device__ __forceinline__ void stage_dmajor(float* dst, const float* __restrict__ src, int rows,
                                             int E, float mul) {
  constexpr int D4 = HD / 4;
  for (int idx = threadIdx.x; idx < TILE * D4; idx += THREADS) {
    const int r = idx % TILE, d4 = idx / TILE;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = *reinterpret_cast<const float4*>(src + (size_t)r * E + 4 * d4);
    dst[(4 * d4 + 0) * STRIDE + r] = x.x * mul;
    dst[(4 * d4 + 1) * STRIDE + r] = x.y * mul;
    dst[(4 * d4 + 2) * STRIDE + r] = x.z * mul;
    dst[(4 * d4 + 3) * STRIDE + r] = x.w * mul;
  }
}

// The same tile row-major: dst[r * HD + d].
template <int HD>
__device__ __forceinline__ void stage_rowmajor(float* dst, const float* __restrict__ src,
                                               int rows, int E, float mul) {
  constexpr int D4 = HD / 4;
  for (int idx = threadIdx.x; idx < TILE * D4; idx += THREADS) {
    const int r = idx / D4, d4 = idx % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = *reinterpret_cast<const float4*>(src + (size_t)r * E + 4 * d4);
    *reinterpret_cast<float4*>(dst + r * HD + 4 * d4) =
        make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

// s[r][c] = sum_d A[d][4 ty + r] * Bm[d][4 tx + c], d in order, both d-major.
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* Bm, int ty,
                                         int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * STRIDE + 4 * ty);
    const float4 bb = *reinterpret_cast<const float4*>(Bm + d * STRIDE + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
  }
}

// acc[r][t] += sum_{j < n} T[j][4 ty + r] * R[j][CT tx + t]: T transposed
// [TILE][STRIDE], R row-major [TILE][HD].
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16], const float* T, const float* R,
                                         int n, int ty, int tx) {
  constexpr int CT = HD / 16;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(T + j * STRIDE + 4 * ty);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    float rv[CT];
    if constexpr (CT == 2) {
      const float2 x = *reinterpret_cast<const float2*>(R + j * HD + 2 * tx);
      rv[0] = x.x;
      rv[1] = x.y;
    } else {
      const float4 x = *reinterpret_cast<const float4*>(R + j * HD + 4 * tx);
      rv[0] = x.x;
      rv[1] = x.y;
      rv[2] = x.z;
      rv[3] = x.w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[r][t] = fmaf(pv[r], rv[t], acc[r][t]);
  }
}

// a key's flag: 1 valid, 0 masked, 2 past Lk
__device__ __forceinline__ uint8_t key_flag(const uint8_t* __restrict__ mask_b, int j, int Lk) {
  return j < Lk ? (mask_b[j] ? 1 : 0) : 2;
}

// a logit under its key's flag: -1e9 masked, -inf past Lk
__device__ __forceinline__ float masked_logit(float s, uint8_t f) {
  return f == 2 ? -INFINITY : (f ? s : NEG_INF);
}

// dQ of a query tile, and each of its rows' softmax statistics and D, in
// scratch rows of 3 floats: m (the max logit), 1 / l (l = sum_j exp(S_ij -
// m)) and D.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
attention_backward_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ o,
                             const float* __restrict__ g, const uint8_t* __restrict__ mask,
                             float* __restrict__ dq, float* __restrict__ stats, int H, int Lq,
                             int Lk, int E, float scale) {
  constexpr int CT = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qd = reinterpret_cast<float*>(smem);
  float* Gd = Qd + HD * STRIDE;
  float* Kd = Gd + HD * STRIDE;
  float* Vd = Kd + HD * STRIDE;
  float* Kr = Vd + HD * STRIDE;
  float* Ps = Kr + TILE * HD;
  float* Dr = Ps + TILE * STRIDE;
  uint8_t* Fs = reinterpret_cast<uint8_t*>(Dr + TILE);

  int b, h, q0;
  attn_grid::block_coords<TILE>(H, Lq, b, h, q0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rows = min(TILE, Lq - q0);
  const size_t qoff = ((size_t)b * Lq + q0) * E + h * HD;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  stage_dmajor<HD>(Qd, q + qoff, rows, E, scale);
  stage_dmajor<HD>(Gd, g + qoff, rows, E, 1.f);
  {  // D = rowsum(dO o O), four threads a row
    const int r = tid / 4, part = tid % 4;
    float acc = 0.f;
    if (r < rows) {
      const size_t off = qoff + (size_t)r * E + part * (HD / 4);
#pragma unroll
      for (int d = 0; d < HD / 4; ++d) acc = fmaf(g[off + d], o[off + d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) Dr[r] = acc;
  }
  __syncthreads();
  // the rows 4 ty + r: their D, running max m and sum l, and the sum of
  // e o (dP - D) . K over the keys so far, scaled to exp(-m)
  float Dv[4], m[4], l[4], acc[4][CT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    Dv[r] = Dr[4 * ty + r];
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < CT; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    const int kn = min(TILE, Lk - k0);
    const size_t koff = ((size_t)b * Lk + k0) * E + h * HD;
    __syncthreads();  // the previous tile's K, V and dS are read
    stage_dmajor<HD>(Kd, k + koff, kn, E, 1.f);
    stage_rowmajor<HD>(Kr, k + koff, kn, E, 1.f);
    stage_dmajor<HD>(Vd, v + koff, kn, E, 1.f);
    for (int j = tid; j < TILE; j += THREADS) Fs[j] = key_flag(mask_b, k0 + j, Lk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, Qd, Kd, ty, tx);
    tile_dot<HD>(dp, Gd, Vd, ty, tx);
    uint8_t f[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = Fs[4 * tx + c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = masked_logit(s[r][c], f[c]);
        tmax = fmaxf(tmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mn = fmaxf(m[r], tmax);  // finite: a tile holds at least one key
      const float alpha = expf(m[r] - mn);  // 0 at the first tile
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[r][c] - mn);
        rs += e;
        dp[r][c] = f[c] == 1 ? e * (dp[r][c] - Dv[r]) : 0.f;  // 0 at masked keys
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = mn;
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[r][t] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Ps + (4 * tx + c) * STRIDE + 4 * ty) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    __syncthreads();
    tile_acc<HD>(acc, Ps, Kr, kn, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= Lq) continue;
    const float rinv = 1.f / l[r];  // l >= 1: the row's largest logit adds exp(0)
    float* dst = dq + ((size_t)b * Lq + qi) * E + h * HD + CT * tx;
#pragma unroll
    for (int t = 0; t < CT; ++t) dst[t] = acc[r][t] * rinv * scale;
    if (tx == 0) {
      float* st = stats + (((size_t)b * H + h) * Lq + qi) * 3;
      st[0] = m[r];
      st[1] = rinv;
      st[2] = Dv[r];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
attention_backward_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ g,
                               const uint8_t* __restrict__ mask, const float* __restrict__ stats,
                               float* __restrict__ dk, float* __restrict__ dv, int H, int Lq,
                               int Lk, int E, float scale) {
  constexpr int CT = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Kd = reinterpret_cast<float*>(smem);
  float* Vd = Kd + HD * STRIDE;
  float* Qd = Vd + HD * STRIDE;
  float* Gd = Qd + HD * STRIDE;
  float* Qr = Gd + HD * STRIDE;
  float* Gr = Qr + TILE * HD;
  float* Pt = Gr + TILE * HD;
  float* St = Pt + TILE * STRIDE;
  float* Ms = St + TILE * STRIDE;
  float* Rs = Ms + TILE;
  float* Ds = Rs + TILE;

  int b, h, k0;
  attn_grid::block_coords<TILE>(H, Lk, b, h, k0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t koff = ((size_t)b * Lk + k0) * E + h * HD;
  stage_dmajor<HD>(Kd, k + koff, min(TILE, Lk - k0), E, 1.f);
  stage_dmajor<HD>(Vd, v + koff, min(TILE, Lk - k0), E, 1.f);
  uint8_t f[4];  // the flags of keys 4 ty + r
#pragma unroll
  for (int r = 0; r < 4; ++r) f[r] = key_flag(mask + (size_t)b * Lk, k0 + 4 * ty + r, Lk);
  const float* st = stats + ((size_t)b * H + h) * Lq * 3;

  float adv[4][CT], adk[4][CT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < CT; ++t) adv[r][t] = adk[r][t] = 0.f;
  for (int q0 = 0; q0 < Lq; q0 += TILE) {
    const int qn = min(TILE, Lq - q0);
    const size_t qoff = ((size_t)b * Lq + q0) * E + h * HD;
    __syncthreads();  // the previous tile's Q, dO, P and dS are read
    stage_dmajor<HD>(Qd, q + qoff, qn, E, scale);
    stage_rowmajor<HD>(Qr, q + qoff, qn, E, scale);
    stage_dmajor<HD>(Gd, g + qoff, qn, E, 1.f);
    stage_rowmajor<HD>(Gr, g + qoff, qn, E, 1.f);
    // rows past Lq: q = 0 gives S = 0, and 1/l = 0 gives P = 0
    for (int i = tid; i < TILE; i += THREADS) {
      const bool in = i < qn;
      Ms[i] = in ? st[(size_t)(q0 + i) * 3] : 0.f;
      Rs[i] = in ? st[(size_t)(q0 + i) * 3 + 1] : 0.f;
      Ds[i] = in ? st[(size_t)(q0 + i) * 3 + 2] : 0.f;
    }
    __syncthreads();
    // keys 4 ty + r against queries 4 tx + c: S^T and dP^T, the sums of the
    // dq kernel's S and dP in the same order (so S is the one its m and l
    // were taken from)
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, Kd, Qd, ty, tx);
    tile_dot<HD>(dp, Vd, Gd, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * tx + c;
      const float mi = Ms[i], ri = Rs[i], di = Ds[i];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = expf(masked_logit(s[r][c], f[r]) - mi) * ri;
        dp[r][c] = f[r] == 1 ? p * (dp[r][c] - di) : 0.f;
        s[r][c] = p;
      }
      *reinterpret_cast<float4*>(Pt + i * STRIDE + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(St + i * STRIDE + 4 * ty) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    }
    __syncthreads();
    tile_acc<HD>(adv, Pt, Gr, qn, ty, tx);
    tile_acc<HD>(adk, St, Qr, qn, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + 4 * ty + r;
    if (kj < Lk) {
      const size_t off = ((size_t)b * Lk + kj) * E + h * HD + CT * tx;
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        dk[off + t] = adk[r][t];
        dv[off + t] = adv[r][t];
      }
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* g,
           const uint8_t* mask, float* dq, float* dk, float* dv, float* stats, int B, int H,
           int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  const size_t s1 = DqSmem<HD>::bytes, s2 = DkdvSmem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_backward_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_backward_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const long long bq = (long long)B * H * ((Lq + TILE - 1) / TILE);
  const long long bk = (long long)B * H * ((Lk + TILE - 1) / TILE);
  if (bq > 0x7fffffffLL || bk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attention_backward_dq_kernel<HD><<<(unsigned)bq, THREADS, s1, stream>>>(
      q, k, v, o, g, mask, dq, stats, H, Lq, Lk, E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_backward_dkdv_kernel<HD><<<(unsigned)bk, THREADS, s2, stream>>>(
      q, k, v, g, mask, stats, dk, dv, H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, o, g (= dO), dq: (B, Lq, E);
// k, v, dk, dv: (B, Lk, E); all float32, contiguous, 16-byte aligned; mask:
// (B, Lk) uint8, 1 = attendable; stats: (B, H, Lq, 3) float32 scratch. Head
// h reads and writes columns [h*hd, (h+1)*hd) with hd = E / H, 32 or 64;
// scale is the f32 softmax scale. Launches the two kernels on `stream` and
// returns the cudaError_t of the launches (0 = success).
extern "C" int attention_backward_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* g, const void* mask, void* dq,
                                         void* dk, void* dv, void* stats, int B, int H, int Lq,
                                         int Lk, int E, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fo = static_cast<const float*>(o);
  const auto* fg = static_cast<const float*>(g);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* fdq = static_cast<float*>(dq);
  auto* fdk = static_cast<float*>(dk);
  auto* fdv = static_cast<float*>(dv);
  auto* fst = static_cast<float*>(stats);
  const int hd = E / H;
  if (hd == 32)
    return launch<32>(fq, fk, fv, fo, fg, m, fdq, fdk, fdv, fst, B, H, Lq, Lk, E, scale, s);
  if (hd == 64)
    return launch<64>(fq, fk, fv, fo, fg, m, fdq, fdk, fdv, fst, B, H, Lq, Lk, E, scale, s);
  return (int)cudaErrorInvalidValue;
}
