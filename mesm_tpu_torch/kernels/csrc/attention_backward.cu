// The backward of float32 multi-head attention over (B, L, E) operands for
// Hopper (sm_90a), its products on the tensor cores in 3xTF32: the
// gradients that autograd gives for models/attention.attention_core with a
// key mask and no pair factors.
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
// x 601 x 601, H 8, hd 32) one product is 5.9 GFLOP, 88 us at the 67
// TFLOP/s of fp32 without the tensor cores; the gradients need at least
// five (S, dP, dV, dQ, dK). One TF32 product keeps 10 mantissa bits of each
// operand, too few for the f32 core's gradients; 3xTF32 keeps about 21:
// each operand x splits into hi = tf32(x) and lo = tf32(x - hi), and a
// product a . b is lo_a . hi_b + hi_a . lo_b + hi_a . hi_b (lo . lo, about
// 2^-22 of the product, is dropped), three tensor-core products that the
// tensor cores' 495 TFLOP/s TF32 rate turn into ~0.04 ms each at TACoS.
//
// Design: deterministic (no atomics: each sum is taken in a fixed order),
// on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA: A holds
// rows g and g + 8, columns t and t + 4 of a 16 x 8 tile, lane = 4 g + t;
// B column g, rows t and t + 4; C rows g and g + 8, columns 2t and 2t + 1).
// Blocks of 4 warps, tiles of 64 rows (16 a warp) against the 64 keys or
// queries of a tile of the other side, 32 of them a step. A warp's own
// rows (qs and dO, or K and V) are A fragments in registers, read once from
// device memory and split at each step. The other side's tiles are staged
// by cp.async into two buffers (the next tile lands while this one is
// computed) and split once a block: each thread splits the chunks it
// copied, in place (hi) and into a second array (lo), as f32 rows at a
// stride of hd + 4 floats, so each B fragment load (8 rows x 4 columns, or
// 4 row pairs x 8 columns) hits 32 distinct banks. Splitting in the warps
// instead (each value once for each of the four warps and each product that
// reads it) was slower: the splits, not the loads, held the products back;
// now the three mma.sync TF32 products do. A product whose result feeds the
// next one keeps it in registers: the C tile of 8 keys is the A fragment of
// those keys when the k index t stands for key 2t and t + 4 for key 2t + 1,
// and the B fragment is read in that order. Sums over keys or queries are
// taken a step at a time from zero on the tensor cores and added to the
// running sum on the CUDA cores in f32, so that the tensor cores' own
// accumulation (which truncates) rounds only short sums. The
// exponentials, dS, the masks and the statistics stay f32 on the CUDA
// cores. Two launches:
//   - attention_backward_dq_3xtf32_kernel, one block per (b, 64-query tile,
//     h): D of its rows from O and dO, then one walk over the key tiles that
//     computes S and dP, e = exp(S - m) with each row's running max m and
//     sum l (online, as the forward), and the sum of e o (dP - D) . K,
//     rescaled when m grows; at the end dQ = that sum * scale / l, and
//     (m, 1/l, D) of each row go to a (B, H, Lq, 3) scratch;
//   - attention_backward_dkdv_3xtf32_kernel, after it on the stream, one
//     block per (b, 64-key tile, h): it walks the query tiles, recomputes
//     S^T and P^T = exp(S^T - m) / l from the scratch, computes dP^T and
//     dS^T, and accumulates dV and dK.
// Seven products where the function needs five (S and dP in both kernels),
// and no scratch beyond the 12 bytes of statistics a query row and head:
// the memory of the backward grows as Lq + Lk, not as Lq * Lk. Shared
// memory: 72 KB a block at hd 32 (2 blocks an SM: 8 warps, no spills), 136
// KB at hd 64 (one block an SM).
//
// Head dims 16, 32, 64 and 128. At hd 128 a warp's own rows as A fragments
// would take 64 registers each (qs and dO, or K and V) on top of a 64 x 128
// f32 sum or two: so there the block stages its own rows once in shared
// memory (unsplit, at the row stride RS) and each step reads its fragments
// from there; the other side's tiles hold 32 rows (one step) instead of 64,
// so that both fit 227 KB; and the products whose output is hd wide are
// taken half the columns at a time, into 32 registers. The sums are the
// same, in the same order.
//
// Head dims above 128 (padded by the wrapper to 128 n) take two more
// kernels, attention_backward_{dq,dkdv}_wide_kernel, one block per 128
// output columns: see "wide heads" below. The 3xTF32 helpers are shared with
// the forward's float32 body (attention_tf32.cuh).

#include "attention_grid.cuh"
#include "attention_tf32.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace tf32x3;

constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int TILE = 64;      // a block's own query rows or keys
// keys (dq kernel) or queries (dk / dv kernel) of a tile taken in one step
constexpr int STEP = 32;
// rows of a tile of the other side: 64, or one step at hd 128
template <int HD>
constexpr int KT = HD >= 128 ? STEP : 64;
// the block's own rows staged in shared memory (hd 128), not in registers
template <int HD>
constexpr bool OWN_SMEM = HD >= 128;
// output column tiles (of 8) of a product taken at once: all, or half at
// hd 128
template <int HD>
constexpr int NH = HD >= 128 ? HD / 16 : HD / 8;

// Dynamic shared memory of each kernel, in bytes: at hd 128 the own rows
// (two arrays [TILE][RS]) first; then two buffers, each the hi and lo parts
// of two tiles [KT][RS]; the dq kernel adds KT key flags a buffer, the
// dk / dv kernel KT rows of statistics (3 floats) a buffer.
template <int HD>
struct DqSmem {
  static constexpr size_t own = OWN_SMEM<HD> ? (size_t)2 * TILE * RS<HD> * 4 : 0;
  static constexpr size_t bytes = own + (size_t)8 * KT<HD> * RS<HD> * 4 + 2 * KT<HD>;
};
template <int HD>
struct DkdvSmem {
  static constexpr size_t own = DqSmem<HD>::own;
  static constexpr size_t bytes = own + ((size_t)8 * KT<HD> * RS<HD> + 2 * KT<HD> * 3) * 4;
};

// The A fragments of rows r0 .. r0 + 16 (row stride E, from device memory),
// every k step of HD, each value times `mul`; rows at or past `rows` are 0.
template <int HD>
__device__ __forceinline__ void load_a(float (&a)[HD / 8][4], const float* __restrict__ src,
                                       int r0, int rows, int E, int lane, float mul) {
  const int g = lane >> 2, t = lane & 3;
  const bool in0 = r0 + g < rows, in1 = r0 + g + 8 < rows;
  const float* p0 = src + (size_t)(r0 + g) * E + t;
  const float* p1 = p0 + (size_t)8 * E;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    a[ks][0] = in0 ? p0[8 * ks] * mul : 0.f;
    a[ks][1] = in1 ? p1[8 * ks] * mul : 0.f;
    a[ks][2] = in0 ? p0[8 * ks + 4] * mul : 0.f;
    a[ks][3] = in1 ? p1[8 * ks + 4] * mul : 0.f;
  }
}

// A warp's own 16 rows as the A fragments of every k step of HD (rows g and
// g + 8, columns 8 ks + t and + 4): in registers, read from device memory
// once (load_a)...
template <int HD, bool SMEM = OWN_SMEM<HD>>
struct OwnRows {
  float a[HD / 8][4];
  __device__ __forceinline__ void load(const float* __restrict__ src, int r0, int rows, int E,
                                       int lane, float mul, float*) {
    load_a<HD>(a, src, r0, rows, E, lane, mul);
  }
  __device__ __forceinline__ SplitA split(int ks) const {
    return SplitA(a[ks][0], a[ks][1], a[ks][2], a[ks][3]);
  }
};
// ... or, at hd 128, in the warp's 16 rows of shared memory (row stride RS,
// each value times `mul`, rows at or past `rows` 0), read at each step
template <int HD>
struct OwnRows<HD, true> {
  const float* w;  // the thread's (g, t) in the warp's rows
  __device__ __forceinline__ void load(const float* __restrict__ src, int r0, int rows, int E,
                                       int lane, float mul, float* dst) {
    constexpr int C4 = HD / 4;
    for (int i = lane; i < 16 * C4; i += 32) {
      const int r = i / C4, c = i % C4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows) {
        x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * E + 4 * c);
        x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
      }
      *reinterpret_cast<float4*>(dst + r * RS<HD> + 4 * c) = x;
    }
    __syncwarp();
    w = dst + (lane >> 2) * RS<HD> + (lane & 3);
  }
  __device__ __forceinline__ SplitA split(int ks) const {
    return SplitA(w[8 * ks], w[8 * RS<HD> + 8 * ks], w[8 * ks + 4], w[8 * RS<HD> + 8 * ks + 4]);
  }
};

// dQ of a query tile, and each of its rows' softmax statistics and D, in
// scratch rows of 3 floats: m (the max logit), 1 / l (l = sum_j exp(S_ij -
// m)) and D.
template <int HD>
__global__ void __launch_bounds__(THREADS, OWN_SMEM<HD> ? 1 : 2)
attention_backward_dq_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ o,
                                    const float* __restrict__ g, const uint8_t* __restrict__ mask,
                                    float* __restrict__ dq, float* __restrict__ stats, int H,
                                    int Lq, int Lk, int E, float scale) {
  constexpr int NT = STEP / 8, ND = HD / 8, KTL = KT<HD>;
  constexpr int T1 = KTL * RS<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // hd 128: [qs, dO][TILE][RS]
  float* buf = reinterpret_cast<float*>(smem + DqSmem<HD>::own);  // [2][Khi, Klo, Vhi, Vlo][T1]
  uint8_t* Fs = reinterpret_cast<uint8_t*>(buf + 8 * T1);  // [2][KTL]

  int b, h, q0;
  attn_grid::block_coords<TILE>(H, Lq, b, h, q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int rows = min(TILE, Lq - q0);
  const size_t qoff = ((size_t)b * Lq + q0) * E + h * HD;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  const int ntiles = (Lk + KTL - 1) / KTL;
  auto tiles_of = [&](int bi) { return buf + bi * 4 * T1; };
  // the warp's rows 16 warp + g and + 8: qs and dO as A fragments, D
  OwnRows<HD> qa, ga;
  qa.load(q + qoff, 16 * warp, rows, E, lane, scale, own + 16 * warp * RS<HD>);
  ga.load(g + qoff, 16 * warp, rows, E, lane, 1.f, own + (TILE + 16 * warp) * RS<HD>);
  float D0 = 0.f, D1 = 0.f;  // rowsum(dO o O) of rows g and g + 8, four lanes a row
  {
    const int r0 = 16 * warp + gq;
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const int col = tq * (HD / 4) + d;
      if (r0 < rows) D0 = fmaf(g[qoff + (size_t)r0 * E + col], o[qoff + (size_t)r0 * E + col], D0);
      if (r0 + 8 < rows)
        D1 = fmaf(g[qoff + (size_t)(r0 + 8) * E + col], o[qoff + (size_t)(r0 + 8) * E + col], D1);
    }
    D0 = quad_sum(D0);
    D1 = quad_sum(D1);
  }
  // the running max m and sum l of rows g and g + 8, and the sum of
  // e o (dP - D) . K over the keys so far, scaled to exp(-m)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  // the key flags: thread tid < KTL holds key tid's of the next tile
  if (tid < KTL) Fs[tid] = key_flag(mask_b, tid, Lk);
  uint8_t fnext = 0;

  walk(
      ntiles,
      [&](int it, int bi) {
        const int k0 = it * KTL;
        const size_t koff = ((size_t)b * Lk + k0) * E + h * HD;
        stage_tile<HD, KT<HD>, THREADS>(tiles_of(bi), k + koff, min(KTL, Lk - k0), E);
        stage_tile<HD, KT<HD>, THREADS>(tiles_of(bi) + 2 * T1, v + koff, min(KTL, Lk - k0), E);
        cp_async_commit();
      },
      [&](int bi) {
        split_tile<HD, KT<HD>, THREADS>(tiles_of(bi), tiles_of(bi) + T1, 1.f);
        split_tile<HD, KT<HD>, THREADS>(tiles_of(bi) + 2 * T1, tiles_of(bi) + 3 * T1, 1.f);
      },
      [&](int it, int bi) {
        if (tid < KTL) fnext = key_flag(mask_b, (it + 1) * KTL + tid, Lk);
        const SplitTile Kt{tiles_of(bi), tiles_of(bi) + T1};
        const SplitTile Vt{tiles_of(bi) + 2 * T1, tiles_of(bi) + 3 * T1};
        const uint8_t* Fb = Fs + bi * KTL;
        const int kn = min(KTL, Lk - it * KTL);
        for (int kk = 0; kk < kn; kk += STEP) {  // a step holds at least one key < Lk
          float s[NT][4], dp[NT][4];
          product_nt<HD, NT>(s, qa, Kt, kk, lane);
          product_nt<HD, NT>(dp, ga, Vt, kk, lane);
          float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t f0 = Fb[kk + 8 * nt + 2 * tq], f1 = Fb[kk + 8 * nt + 2 * tq + 1];
            s[nt][0] = masked_logit(s[nt][0], f0);
            s[nt][1] = masked_logit(s[nt][1], f1);
            s[nt][2] = masked_logit(s[nt][2], f0);
            s[nt][3] = masked_logit(s[nt][3], f1);
            tmax0 = fmaxf(tmax0, fmaxf(s[nt][0], s[nt][1]));
            tmax1 = fmaxf(tmax1, fmaxf(s[nt][2], s[nt][3]));
          }
          const float mn0 = fmaxf(m0, quad_max(tmax0)), mn1 = fmaxf(m1, quad_max(tmax1));
          const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);  // 0 at the first step
          float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t f0 = Fb[kk + 8 * nt + 2 * tq], f1 = Fb[kk + 8 * nt + 2 * tq + 1];
            const float e0 = expf(s[nt][0] - mn0), e1 = expf(s[nt][1] - mn0);
            const float e2 = expf(s[nt][2] - mn1), e3 = expf(s[nt][3] - mn1);
            rs0 += e0 + e1;
            rs1 += e2 + e3;
            // e o (dP - D), 0 at masked keys
            s[nt][0] = f0 == 1 ? e0 * (dp[nt][0] - D0) : 0.f;
            s[nt][1] = f1 == 1 ? e1 * (dp[nt][1] - D0) : 0.f;
            s[nt][2] = f0 == 1 ? e2 * (dp[nt][2] - D1) : 0.f;
            s[nt][3] = f1 == 1 ? e3 * (dp[nt][3] - D1) : 0.f;
          }
          l0 = l0 * alpha0 + quad_sum(rs0);
          l1 = l1 * alpha1 + quad_sum(rs1);
          m0 = mn0;
          m1 = mn1;
#pragma unroll
          for (int n0 = 0; n0 < ND; n0 += NH<HD>) {
            float part[NH<HD>][4];
            product_kt<HD, STEP, NH<HD>>(part, s, Kt, kk, lane, n0);
#pragma unroll
            for (int nd = 0; nd < NH<HD>; ++nd) {
              acc[n0 + nd][0] = fmaf(acc[n0 + nd][0], alpha0, part[nd][0]);
              acc[n0 + nd][1] = fmaf(acc[n0 + nd][1], alpha0, part[nd][1]);
              acc[n0 + nd][2] = fmaf(acc[n0 + nd][2], alpha1, part[nd][2]);
              acc[n0 + nd][3] = fmaf(acc[n0 + nd][3], alpha1, part[nd][3]);
            }
          }
        }
      },
      [&](int it) {
        if (tid < KTL) Fs[((it + 1) & 1) * KTL + tid] = fnext;
      });

  // l >= 1: the row's largest logit adds exp(0)
  const float rinv0 = 1.f / l0, rinv1 = 1.f / l1;
  const int qi0 = q0 + 16 * warp + gq, qi1 = qi0 + 8;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = h * HD + 8 * nd + 2 * tq;
    if (qi0 < Lq)
      *reinterpret_cast<float2*>(dq + ((size_t)b * Lq + qi0) * E + col) =
          make_float2(acc[nd][0] * rinv0 * scale, acc[nd][1] * rinv0 * scale);
    if (qi1 < Lq)
      *reinterpret_cast<float2*>(dq + ((size_t)b * Lq + qi1) * E + col) =
          make_float2(acc[nd][2] * rinv1 * scale, acc[nd][3] * rinv1 * scale);
  }
  if (tq == 0) {
    float* st = stats + ((size_t)b * H + h) * Lq * 3;
    if (qi0 < Lq) {
      st[(size_t)qi0 * 3] = m0;
      st[(size_t)qi0 * 3 + 1] = rinv0;
      st[(size_t)qi0 * 3 + 2] = D0;
    }
    if (qi1 < Lq) {
      st[(size_t)qi1 * 3] = m1;
      st[(size_t)qi1 * 3 + 1] = rinv1;
      st[(size_t)qi1 * 3 + 2] = D1;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, OWN_SMEM<HD> ? 1 : 2)
attention_backward_dkdv_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v, const float* __restrict__ g,
                                      const uint8_t* __restrict__ mask,
                                      const float* __restrict__ stats, float* __restrict__ dk,
                                      float* __restrict__ dv, int H, int Lq, int Lk, int E,
                                      float scale) {
  constexpr int NT = STEP / 8, ND = HD / 8, KTL = KT<HD>;
  constexpr int T1 = KTL * RS<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // hd 128: [K, V][TILE][RS]
  float* buf = reinterpret_cast<float*>(smem + DkdvSmem<HD>::own);  // [2][Qhi, Qlo, Ghi, Glo][T1]
  float* St = buf + 8 * T1;                                         // [2][KTL * 3]

  int b, h, k0;
  attn_grid::block_coords<TILE>(H, Lk, b, h, k0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gk = lane >> 2, tk = lane & 3;
  const size_t koff = ((size_t)b * Lk + k0) * E + h * HD;
  const float* st = stats + ((size_t)b * H + h) * Lq * 3;
  const int ntiles = (Lq + KTL - 1) / KTL;
  // the warp's keys 16 warp + g and + 8: K and V as A fragments, their flags
  OwnRows<HD> ka, va;
  ka.load(k + koff, 16 * warp, Lk - k0, E, lane, 1.f, own + 16 * warp * RS<HD>);
  va.load(v + koff, 16 * warp, Lk - k0, E, lane, 1.f, own + (TILE + 16 * warp) * RS<HD>);
  const int kj0 = k0 + 16 * warp + gk, kj1 = kj0 + 8;
  const uint8_t f0 = key_flag(mask + (size_t)b * Lk, kj0, Lk);
  const uint8_t f1 = key_flag(mask + (size_t)b * Lk, kj1, Lk);

  float adv[ND][4], adk[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) adv[nd][i] = adk[nd][i] = 0.f;
  walk(
      ntiles,
      [&](int it, int bi) {
        const int q0 = it * KTL, qn = min(KTL, Lq - q0);
        const size_t qoff = ((size_t)b * Lq + q0) * E + h * HD;
        stage_tile<HD, KT<HD>, THREADS>(buf + bi * 4 * T1, q + qoff, qn, E);
        stage_tile<HD, KT<HD>, THREADS>(buf + bi * 4 * T1 + 2 * T1, g + qoff, qn, E);
        // (m, 1/l, D) of each row; rows past Lq: q = 0 gives S = 0, and
        // 1/l = 0 gives P = 0
        float* sb = St + bi * KTL * 3;
        for (int i = tid; i < KTL * 3; i += THREADS) {
          if (i < qn * 3)
            cp_async4(sb + i, st + (size_t)q0 * 3 + i);
          else
            sb[i] = 0.f;
        }
        cp_async_commit();
      },
      [&](int bi) {
        float* base = buf + bi * 4 * T1;
        split_tile<HD, KT<HD>, THREADS>(base, base + T1, scale);  // qs = q * scale, split
        split_tile<HD, KT<HD>, THREADS>(base + 2 * T1, base + 3 * T1, 1.f);
      },
      [&](int it, int bi) {
        const float* base = buf + bi * 4 * T1;
        const SplitTile Qt{base, base + T1}, Gt{base + 2 * T1, base + 3 * T1};
        const float* Sb = St + bi * KTL * 3;
        const int qn = min(KTL, Lq - it * KTL);
        for (int qq = 0; qq < qn; qq += STEP) {
          // keys g, g + 8 against queries qq + 8 nt + 2t, + 1: S^T and dP^T,
          // the sums of the dq kernel's S and dP over the same products
          float s[NT][4], dp[NT][4];
          product_nt<HD, NT>(s, ka, Qt, qq, lane);
          product_nt<HD, NT>(dp, va, Gt, qq, lane);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* sa = Sb + (qq + 8 * nt + 2 * tk) * 3;  // queries i, i + 1
            const float p0 = expf(masked_logit(s[nt][0], f0) - sa[0]) * sa[1];
            const float p1 = expf(masked_logit(s[nt][1], f0) - sa[3]) * sa[4];
            const float p2 = expf(masked_logit(s[nt][2], f1) - sa[0]) * sa[1];
            const float p3 = expf(masked_logit(s[nt][3], f1) - sa[3]) * sa[4];
            dp[nt][0] = f0 == 1 ? p0 * (dp[nt][0] - sa[2]) : 0.f;
            dp[nt][1] = f0 == 1 ? p1 * (dp[nt][1] - sa[5]) : 0.f;
            dp[nt][2] = f1 == 1 ? p2 * (dp[nt][2] - sa[2]) : 0.f;
            dp[nt][3] = f1 == 1 ? p3 * (dp[nt][3] - sa[5]) : 0.f;
            s[nt][0] = p0;
            s[nt][1] = p1;
            s[nt][2] = p2;
            s[nt][3] = p3;
          }
#pragma unroll
          for (int n0 = 0; n0 < ND; n0 += NH<HD>) {
            float part[NH<HD>][4];
            product_kt<HD, STEP, NH<HD>>(part, s, Gt, qq, lane, n0);  // P^T . dO
#pragma unroll
            for (int nd = 0; nd < NH<HD>; ++nd)
#pragma unroll
              for (int i = 0; i < 4; ++i) adv[n0 + nd][i] += part[nd][i];
          }
#pragma unroll
          for (int n0 = 0; n0 < ND; n0 += NH<HD>) {
            float part[NH<HD>][4];
            product_kt<HD, STEP, NH<HD>>(part, dp, Qt, qq, lane, n0);  // dS^T . qs
#pragma unroll
            for (int nd = 0; nd < NH<HD>; ++nd)
#pragma unroll
              for (int i = 0; i < 4; ++i) adk[n0 + nd][i] += part[nd][i];
          }
        }
      },
      [](int) {});
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = h * HD + 8 * nd + 2 * tk;
    if (kj0 < Lk) {
      const size_t off = ((size_t)b * Lk + kj0) * E + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(adk[nd][0], adk[nd][1]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(adv[nd][0], adv[nd][1]);
    }
    if (kj1 < Lk) {
      const size_t off = ((size_t)b * Lk + kj1) * E + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(adk[nd][2], adk[nd][3]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(adv[nd][2], adv[nd][3]);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* g,
           const uint8_t* mask, float* dq, float* dk, float* dv, float* stats, int B, int H,
           int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  const size_t s1 = DqSmem<HD>::bytes, s2 = DkdvSmem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_backward_dq_3xtf32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_backward_dkdv_3xtf32_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const long long bq = (long long)B * H * ((Lq + TILE - 1) / TILE);  // own rows: TILE
  const long long bk = (long long)B * H * ((Lk + TILE - 1) / TILE);
  if (bq > 0x7fffffffLL || bk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attention_backward_dq_3xtf32_kernel<HD><<<(unsigned)bq, THREADS, s1, stream>>>(
      q, k, v, o, g, mask, dq, stats, H, Lq, Lk, E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_backward_dkdv_3xtf32_kernel<HD><<<(unsigned)bk, THREADS, s2, stream>>>(
      q, k, v, g, mask, stats, dk, dv, H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// wide heads
// ---------------------------------------------------------------------------
//
// A head_dim above 128 (the wrapper pads it to 128 n): one block per (b, tile
// of 64 own rows, h) and output chunk c of 128 columns (grid dimension y),
// which writes only chunk c of its gradients. S and dP need the whole head:
// for each tile of 32 rows of the other side the block walks the head in
// slices of 128 columns, slice 0 first in every chunk (so every chunk sees
// the same S and dP), its own rows' slice staged unsplit in shared memory
// (as at hd 128) and the other side's slice split, each slice's products a
// partial sum added in f32; the slice of chunk c lands in a buffer of its
// own, kept for the products that write the chunk (dQ += dS . K_c; dV +=
// P^T . dO_c, dK += dS^T . qs_c). One buffer, taken in turn; a block reads
// its own rows again for every tile of the other side, a cost only wide
// heads pay. The dq kernel's chunk 0 writes the statistics.

constexpr int WHD = attn_grid::SLICE;  // the head columns of a slice and of a chunk

// Dynamic shared memory: the own rows of a slice (two arrays [TILE][RS]);
// the dq kernel the hi and lo parts of K and V of a slice and of K's chunk
// c [STEP][RS], and STEP key flags; the dk / dv kernel those of qs and dO of
// a slice and of their chunk c, and STEP rows of statistics (3 floats).
struct WideDqSmem {
  static constexpr size_t bytes = ((size_t)2 * TILE + 6 * STEP) * RS<WHD> * 4 + STEP;
};
struct WideDkdvSmem {
  static constexpr size_t bytes = (((size_t)2 * TILE + 8 * STEP) * RS<WHD> + STEP * 3) * 4;
};

__global__ void __launch_bounds__(THREADS, 1)
attention_backward_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ o,
                                  const float* __restrict__ g, const uint8_t* __restrict__ mask,
                                  float* __restrict__ dq, float* __restrict__ stats, int H, int Lq,
                                  int Lk, int E, float scale) {
  constexpr int HD = WHD, R = RS<HD>, T1 = STEP * R, NT = STEP / 8, ND = HD / 8, NHW = ND / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // [qs, dO][TILE][R] of a slice
  float* Kb = own + 2 * TILE * R;               // [hi, lo][T1]: K of a slice
  float* Vb = Kb + 2 * T1;                      // V of a slice
  float* Kc = Vb + 2 * T1;                      // K of chunk c
  uint8_t* Fs = reinterpret_cast<uint8_t*>(Kc + 2 * T1);

  int b, h, q0;
  attn_grid::block_coords<TILE>(H, Lq, b, h, q0);
  const int c = blockIdx.y, hdp = E / H, n = hdp / HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int rows = min(TILE, Lq - q0);
  const size_t qoff = ((size_t)b * Lq + q0) * E + h * hdp;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  float D0 = 0.f, D1 = 0.f;  // rowsum(dO o O) over the whole head, four lanes a row
  {
    const int r0 = 16 * warp + gq;
    for (int d = 0; d < hdp / 4; ++d) {
      const int col = tq * (hdp / 4) + d;
      if (r0 < rows) D0 = fmaf(g[qoff + (size_t)r0 * E + col], o[qoff + (size_t)r0 * E + col], D0);
      if (r0 + 8 < rows)
        D1 = fmaf(g[qoff + (size_t)(r0 + 8) * E + col], o[qoff + (size_t)(r0 + 8) * E + col], D1);
    }
    D0 = quad_sum(D0);
    D1 = quad_sum(D1);
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  OwnRows<HD, true> qa, ga;

  for (int k0 = 0; k0 < Lk; k0 += STEP) {
    const int kn = min(STEP, Lk - k0);
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    for (int sl = 0; sl < n; ++sl) {
      __syncthreads();  // every warp is done with the buffers
      float* Kt = sl == c ? Kc : Kb;
      const size_t koff = ((size_t)b * Lk + k0) * E + h * hdp + sl * HD;
      stage_tile<HD, STEP, THREADS>(Kt, k + koff, kn, E);
      stage_tile<HD, STEP, THREADS>(Vb, v + koff, kn, E);
      if (sl == 0 && tid < STEP) Fs[tid] = key_flag(mask_b, k0 + tid, Lk);
      cp_async_commit();
      qa.load(q + qoff + sl * HD, 16 * warp, rows, E, lane, scale, own + 16 * warp * R);
      ga.load(g + qoff + sl * HD, 16 * warp, rows, E, lane, 1.f, own + (TILE + 16 * warp) * R);
      cp_async_wait<0>();
      split_tile<HD, STEP, THREADS>(Kt, Kt + T1, 1.f);
      split_tile<HD, STEP, THREADS>(Vb, Vb + T1, 1.f);
      __syncthreads();
      float ps[NT][4], pdp[NT][4];
      product_nt<HD, NT>(ps, qa, SplitTile{Kt, Kt + T1}, 0, lane);
      product_nt<HD, NT>(pdp, ga, SplitTile{Vb, Vb + T1}, 0, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] += ps[nt][i];
          dp[nt][i] += pdp[nt][i];
        }
    }
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t f0 = Fs[8 * nt + 2 * tq], f1 = Fs[8 * nt + 2 * tq + 1];
      s[nt][0] = masked_logit(s[nt][0], f0);
      s[nt][1] = masked_logit(s[nt][1], f1);
      s[nt][2] = masked_logit(s[nt][2], f0);
      s[nt][3] = masked_logit(s[nt][3], f1);
      tmax0 = fmaxf(tmax0, fmaxf(s[nt][0], s[nt][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(tmax0)), mn1 = fmaxf(m1, quad_max(tmax1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);  // 0 at the first tile
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t f0 = Fs[8 * nt + 2 * tq], f1 = Fs[8 * nt + 2 * tq + 1];
      const float e0 = expf(s[nt][0] - mn0), e1 = expf(s[nt][1] - mn0);
      const float e2 = expf(s[nt][2] - mn1), e3 = expf(s[nt][3] - mn1);
      rs0 += e0 + e1;
      rs1 += e2 + e3;
      s[nt][0] = f0 == 1 ? e0 * (dp[nt][0] - D0) : 0.f;  // e o (dP - D), 0 at masked keys
      s[nt][1] = f1 == 1 ? e1 * (dp[nt][1] - D0) : 0.f;
      s[nt][2] = f0 == 1 ? e2 * (dp[nt][2] - D1) : 0.f;
      s[nt][3] = f1 == 1 ? e3 * (dp[nt][3] - D1) : 0.f;
    }
    l0 = l0 * alpha0 + quad_sum(rs0);
    l1 = l1 * alpha1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += NHW) {
      float part[NHW][4];
      product_kt<HD, STEP, NHW>(part, s, SplitTile{Kc, Kc + T1}, 0, lane, n0);
#pragma unroll
      for (int nd = 0; nd < NHW; ++nd) {
        acc[n0 + nd][0] = fmaf(acc[n0 + nd][0], alpha0, part[nd][0]);
        acc[n0 + nd][1] = fmaf(acc[n0 + nd][1], alpha0, part[nd][1]);
        acc[n0 + nd][2] = fmaf(acc[n0 + nd][2], alpha1, part[nd][2]);
        acc[n0 + nd][3] = fmaf(acc[n0 + nd][3], alpha1, part[nd][3]);
      }
    }
  }

  const float rinv0 = 1.f / l0, rinv1 = 1.f / l1;  // l >= 1
  const int qi0 = q0 + 16 * warp + gq, qi1 = qi0 + 8;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = h * hdp + c * HD + 8 * nd + 2 * tq;
    if (qi0 < Lq)
      *reinterpret_cast<float2*>(dq + ((size_t)b * Lq + qi0) * E + col) =
          make_float2(acc[nd][0] * rinv0 * scale, acc[nd][1] * rinv0 * scale);
    if (qi1 < Lq)
      *reinterpret_cast<float2*>(dq + ((size_t)b * Lq + qi1) * E + col) =
          make_float2(acc[nd][2] * rinv1 * scale, acc[nd][3] * rinv1 * scale);
  }
  if (c == 0 && tq == 0) {
    float* st = stats + ((size_t)b * H + h) * Lq * 3;
    if (qi0 < Lq) {
      st[(size_t)qi0 * 3] = m0;
      st[(size_t)qi0 * 3 + 1] = rinv0;
      st[(size_t)qi0 * 3 + 2] = D0;
    }
    if (qi1 < Lq) {
      st[(size_t)qi1 * 3] = m1;
      st[(size_t)qi1 * 3 + 1] = rinv1;
      st[(size_t)qi1 * 3 + 2] = D1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
attention_backward_dkdv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ g,
                                    const uint8_t* __restrict__ mask,
                                    const float* __restrict__ stats, float* __restrict__ dk,
                                    float* __restrict__ dv, int H, int Lq, int Lk, int E,
                                    float scale) {
  constexpr int HD = WHD, R = RS<HD>, T1 = STEP * R, NT = STEP / 8, ND = HD / 8, NHW = ND / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // [K, V][TILE][R] of a slice
  float* Qb = own + 2 * TILE * R;               // [hi, lo][T1]: qs of a slice
  float* Gb = Qb + 2 * T1;                      // dO of a slice
  float* Qc = Gb + 2 * T1;                      // qs of chunk c
  float* Gc = Qc + 2 * T1;                      // dO of chunk c
  float* St = Gc + 2 * T1;                      // [STEP * 3]

  int b, h, k0;
  attn_grid::block_coords<TILE>(H, Lk, b, h, k0);
  const int c = blockIdx.y, hdp = E / H, n = hdp / HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gk = lane >> 2, tk = lane & 3;
  const size_t koff = ((size_t)b * Lk + k0) * E + h * hdp;
  const float* st = stats + ((size_t)b * H + h) * Lq * 3;
  const int kj0 = k0 + 16 * warp + gk, kj1 = kj0 + 8;
  const uint8_t f0 = key_flag(mask + (size_t)b * Lk, kj0, Lk);
  const uint8_t f1 = key_flag(mask + (size_t)b * Lk, kj1, Lk);
  float adv[ND][4], adk[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) adv[nd][i] = adk[nd][i] = 0.f;
  OwnRows<HD, true> ka, va;

  for (int q0 = 0; q0 < Lq; q0 += STEP) {
    const int qn = min(STEP, Lq - q0);
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    for (int sl = 0; sl < n; ++sl) {
      __syncthreads();  // every warp is done with the buffers
      float* Qt = sl == c ? Qc : Qb;
      float* Gt = sl == c ? Gc : Gb;
      const size_t qoff = ((size_t)b * Lq + q0) * E + h * hdp + sl * HD;
      stage_tile<HD, STEP, THREADS>(Qt, q + qoff, qn, E);
      stage_tile<HD, STEP, THREADS>(Gt, g + qoff, qn, E);
      // (m, 1/l, D) of each row; rows past Lq: q = 0 gives S = 0, and 1/l =
      // 0 gives P = 0
      if (sl == 0)
        for (int i = tid; i < STEP * 3; i += THREADS)
          St[i] = i < qn * 3 ? st[(size_t)q0 * 3 + i] : 0.f;
      cp_async_commit();
      ka.load(k + koff + sl * HD, 16 * warp, Lk - k0, E, lane, 1.f, own + 16 * warp * R);
      va.load(v + koff + sl * HD, 16 * warp, Lk - k0, E, lane, 1.f, own + (TILE + 16 * warp) * R);
      cp_async_wait<0>();
      split_tile<HD, STEP, THREADS>(Qt, Qt + T1, scale);  // qs = q * scale, split
      split_tile<HD, STEP, THREADS>(Gt, Gt + T1, 1.f);
      __syncthreads();
      float ps[NT][4], pdp[NT][4];
      product_nt<HD, NT>(ps, ka, SplitTile{Qt, Qt + T1}, 0, lane);
      product_nt<HD, NT>(pdp, va, SplitTile{Gt, Gt + T1}, 0, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] += ps[nt][i];
          dp[nt][i] += pdp[nt][i];
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* sa = St + (8 * nt + 2 * tk) * 3;  // queries i, i + 1
      const float p0 = expf(masked_logit(s[nt][0], f0) - sa[0]) * sa[1];
      const float p1 = expf(masked_logit(s[nt][1], f0) - sa[3]) * sa[4];
      const float p2 = expf(masked_logit(s[nt][2], f1) - sa[0]) * sa[1];
      const float p3 = expf(masked_logit(s[nt][3], f1) - sa[3]) * sa[4];
      dp[nt][0] = f0 == 1 ? p0 * (dp[nt][0] - sa[2]) : 0.f;
      dp[nt][1] = f0 == 1 ? p1 * (dp[nt][1] - sa[5]) : 0.f;
      dp[nt][2] = f1 == 1 ? p2 * (dp[nt][2] - sa[2]) : 0.f;
      dp[nt][3] = f1 == 1 ? p3 * (dp[nt][3] - sa[5]) : 0.f;
      s[nt][0] = p0;
      s[nt][1] = p1;
      s[nt][2] = p2;
      s[nt][3] = p3;
    }
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += NHW) {
      float part[NHW][4];
      product_kt<HD, STEP, NHW>(part, s, SplitTile{Gc, Gc + T1}, 0, lane, n0);  // P^T . dO_c
#pragma unroll
      for (int nd = 0; nd < NHW; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) adv[n0 + nd][i] += part[nd][i];
    }
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += NHW) {
      float part[NHW][4];
      product_kt<HD, STEP, NHW>(part, dp, SplitTile{Qc, Qc + T1}, 0, lane, n0);  // dS^T . qs_c
#pragma unroll
      for (int nd = 0; nd < NHW; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) adk[n0 + nd][i] += part[nd][i];
    }
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = h * hdp + c * HD + 8 * nd + 2 * tk;
    if (kj0 < Lk) {
      const size_t off = ((size_t)b * Lk + kj0) * E + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(adk[nd][0], adk[nd][1]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(adv[nd][0], adv[nd][1]);
    }
    if (kj1 < Lk) {
      const size_t off = ((size_t)b * Lk + kj1) * E + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(adk[nd][2], adk[nd][3]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(adv[nd][2], adv[nd][3]);
    }
  }
}

int launch_wide(const float* q, const float* k, const float* v, const float* o, const float* g,
                const uint8_t* mask, float* dq, float* dk, float* dv, float* stats, int B, int H,
                int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  const size_t s1 = WideDqSmem::bytes, s2 = WideDkdvSmem::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_backward_dq_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_backward_dkdv_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const long long bq = (long long)B * H * ((Lq + TILE - 1) / TILE);
  const long long bk = (long long)B * H * ((Lk + TILE - 1) / TILE);
  if (bq > 0x7fffffffLL || bk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned chunks = (unsigned)attn_grid::chunks(E / H);
  attention_backward_dq_wide_kernel<<<dim3((unsigned)bq, chunks), THREADS, s1, stream>>>(
      q, k, v, o, g, mask, dq, stats, H, Lq, Lk, E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_backward_dkdv_wide_kernel<<<dim3((unsigned)bk, chunks), THREADS, s2, stream>>>(
      q, k, v, g, mask, stats, dk, dv, H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, o, g (= dO), dq: (B, Lq, E);
// k, v, dk, dv: (B, Lk, E); all float32, contiguous, 16-byte aligned; mask:
// (B, Lk) uint8, 1 = attendable; stats: (B, H, Lq, 3) float32 scratch. Head
// h reads and writes columns [h*hd, (h+1)*hd) with hd = E / H, 16, 32, 64,
// 128 or a multiple of 128 above; scale is the f32 softmax scale. Launches
// the two kernels on `stream` and returns the cudaError_t of the launches
// (0 = success).
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
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    if constexpr (HD == attn_grid::WIDE)
      return launch_wide(fq, fk, fv, fo, fg, m, fdq, fdk, fdv, fst, B, H, Lq, Lk, E, scale, s);
    else
      return launch<HD>(fq, fk, fv, fo, fg, m, fdq, fdk, fdv, fst, B, H, Lq, Lk, E, scale, s);
  });
}
