// Device code shared by the float32 attention kernels over (B, L, E)
// operands: the body of multi-head attention for one (sample b, head h) and a
// tile of 64 query rows, its two products on the tensor cores in 3xTF32
// (attention_tf32.cuh). Shared by attention_batched.cu (kernel 6, the TACoS
// encoder and the trainable forward), attention_heads.cu (kernels 7 and 8),
// attention_packed.cu (kernel 2, and kernel 3 with the pair flags) and
// attention_shortkey.cu (kernel 4, the pair flags optional, key tiles sized
// to its short keys).
//
// What it computes, per (sample b, head h), as attention_batched_reference
// in float32 (the TPU's _mha_kernel_batched):
//   qs = q_h * scale                            (an f32 product)
//   S = qs . k_h^T                              (f32 sums)
//   masked keys -> -1e9, a finite value; keys past Lk left out
//   P = softmax(S)                              (f32)
//   out_h = P . v_h                             (f32 sums)
// A row whose keys are all masked gets the uniform mean of v over all Lk
// keys, never NaN. With pair factors (the pair entry point, whose float32
// function is this one with the pair mask) a pair (q, k) whose row and key
// pair flags are both set is masked as well. The head split is
// the column slice [h*hd, (h+1)*hd), read and written in place.
//
// Design. A block of 4 warps takes 64 query rows (16 a warp) of one (b, h)
// and walks the keys in tiles of 32 (KN, a template argument: the short-key
// kernel takes one tile of 24 or 40 keys where that holds every key). The
// Q tile is staged once by cp.async, scaled and split (hi, lo) once; the K
// and V tiles stream by cp.async into
// two buffers (the next tile lands while this one is computed) and each
// thread splits the chunks it copied (tf32x3::walk). Per key tile a warp
// takes S = qs . K^T (hd / 8 k steps x 4 n8 tiles x 3 mma.sync m16n8k8
// TF32), the masks and an online softmax on the CUDA cores in f32 (a
// running row max and sum, the output rescaled when the max grows), then P .
// V with P split in registers (the C tile of S is P's A fragment) into a
// partial sum from zero over the tile's 32 keys, added to the f32 running
// output: the tensor cores' truncating accumulation rounds only short sums.
// At the end the output is divided by the row's sum. The online rescaling
// rounds at other points than the plain version's two-pass softmax, a few
// f32 ulps. Shared memory: (2 x 64 + 8 x 32) rows of hd + 4 floats: 55 KB at
// hd 32 (4 blocks an SM), 104 KB at 64, 203 KB at 128. Blocks of 128 rows
// (8 warps sharing each K / V tile) were no faster at hd 32 and slower at
// hd 16 on the H100 at 601 keys, and slower at the charades short-key site
// and hd 16 at 17 keys (PERF.md section 6).
//
// Wide heads (a head_dim above 128, zero-padded by the wrapper to 128 n):
// one block per (b, h, 64 query rows, output chunk c of 128 columns). For
// each key tile the block walks Q and K in n slices of 128 columns, always
// in the order 0 .. n - 1 so that every chunk sees the same logits, each
// slice's S a partial sum added in f32; then stages V's chunk c and takes P .
// V for those columns only. One buffer, taken in turn (135 KB): the slices
// of q are read again for every key tile, a cost only wide heads pay.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"

namespace fp32_attn {

using tf32x3::RS;
using tf32x3::SplitA;
using tf32x3::SplitTile;

constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int ROWS = 64;      // query rows a block
constexpr int KT = 32;        // keys a tile
constexpr int SLICE = 128;    // head columns a slice (and an output chunk) at wide heads
constexpr uint8_t KEY_PAIR = 4;  // flag bit: the key's pair factor is set

// the blocks an SM should hold (a __launch_bounds__ minimum), as shared
// memory allows; HD 0 stands for a wide head (attention_grid.cuh's WIDE)
template <int HD>
constexpr int min_blocks() {
  return HD == 16 || HD == 32 ? 4 : HD == 64 ? 2 : 1;
}

// Dynamic shared memory: Qhi, Qlo [ROWS][RS]; two buffers of Khi, Klo, Vhi,
// Vlo [KN][RS] (key tiles of KN keys); two buffers of KN key flags. Where
// one tile holds every key, block_attend takes one buffer and its flags
// (bytes_for).
template <int HD, int KN = KT>
struct Smem {
  static constexpr size_t bytes = (size_t)(2 * ROWS + 8 * KN) * RS<HD> * 4 + 2 * KN;
  static size_t bytes_for(int Lk) {
    return Lk <= KN ? (size_t)(2 * ROWS + 4 * KN) * RS<HD> * 4 + KN : bytes;
  }
};
// Wide heads: Qhi, Qlo [ROWS][RS]; one buffer of Khi, Klo, Vhi, Vlo [KT][RS]
// (RS of a slice); KT key flags.
struct WideSmem {
  static constexpr size_t bytes = (size_t)(2 * ROWS + 4 * KT) * RS<SLICE> * 4 + KT;
};

// A warp's 16 rows of a split tile as the A fragments of each k step: rows
// g and g + 8, columns 8 ks + t and + 4.
template <int HD>
struct SplitRows {
  const float* hi;  // at (row g, column t) of the warp's rows
  const float* lo;
  __device__ __forceinline__ SplitA split(int ks) const {
    SplitA a;
    const int o[4] = {8 * ks, 8 * RS<HD> + 8 * ks, 8 * ks + 4, 8 * RS<HD> + 8 * ks + 4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = __float_as_uint(hi[o[i]]);
      a.lo[i] = __float_as_uint(lo[o[i]]);
    }
    return a;
  }
};

// a logit under its key's flag f (1 valid, 0 masked, 2 past Lk, KEY_PAIR)
// in a row with pair flag qf: -1e9 masked or both pair flags set, -inf past Lk
__device__ __forceinline__ float masked(float s, uint8_t f, bool qf) {
  if (f == 2) return -INFINITY;
  return (f & 1) && !(qf && (f & KEY_PAIR)) ? s : tf32x3::NEG_INF;
}

// The running softmax of a warp's rows g (0) and g + 8 (1) and their output
// o[ND][4] (C layout over ND n8 column tiles), scaled to exp(-m).
template <int ND>
struct Online {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[ND][4];
  __device__ __forceinline__ Online() {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  }

  // s: the tile's logits (NT n8 tiles of keys); flags Fb of its keys; qf0,
  // qf1 the rows' pair flags. On return s holds exp(S - m) with m the new
  // running max, and (alpha0, alpha1) rescale the previous sums.
  template <int NT>
  __device__ __forceinline__ void update(float (&s)[NT][4], const uint8_t* Fb, int t, bool qf0,
                                         bool qf1, float& alpha0, float& alpha1) {
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t f0 = Fb[8 * nt + 2 * t], f1 = Fb[8 * nt + 2 * t + 1];
      s[nt][0] = masked(s[nt][0], f0, qf0);
      s[nt][1] = masked(s[nt][1], f1, qf0);
      s[nt][2] = masked(s[nt][2], f0, qf1);
      s[nt][3] = masked(s[nt][3], f1, qf1);
      tmax0 = fmaxf(tmax0, fmaxf(s[nt][0], s[nt][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[nt][2], s[nt][3]));
    }
    // finite: a tile holds at least one key < Lk, and a masked key is -1e9
    const float mn0 = fmaxf(m0, tf32x3::quad_max(tmax0));
    const float mn1 = fmaxf(m1, tf32x3::quad_max(tmax1));
    alpha0 = expf(m0 - mn0);  // 0 at the first tile
    alpha1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + tf32x3::quad_sum(rs0);
    l1 = l1 * alpha1 + tf32x3::quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
  }

  // o = o * alpha + e . V over the tile's KN keys (e: update's s), the
  // product a partial sum from zero in column groups of NH n8 tiles
  template <int HD, int KN, int NH>
  __device__ __forceinline__ void accumulate(const float (&e)[KN / 8][4], const SplitTile& Vt,
                                             int lane, float alpha0, float alpha1) {
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += NH) {
      float part[NH][4];
      tf32x3::product_kt<HD, KN, NH>(part, e, Vt, 0, lane, n0);
#pragma unroll
      for (int nd = 0; nd < NH; ++nd) {
        o[n0 + nd][0] = fmaf(o[n0 + nd][0], alpha0, part[nd][0]);
        o[n0 + nd][1] = fmaf(o[n0 + nd][1], alpha0, part[nd][1]);
        o[n0 + nd][2] = fmaf(o[n0 + nd][2], alpha1, part[nd][2]);
        o[n0 + nd][3] = fmaf(o[n0 + nd][3], alpha1, part[nd][3]);
      }
    }
  }

  // out rows qi0 and qi0 + 8 (those < Lq), columns 8 nd + 2t of `dst`
  // (the row's first output column), o / l
  __device__ __forceinline__ void store(float* __restrict__ out, size_t row0, int qi0, int Lq,
                                        int E, int t) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (qi0 < Lq)
        *reinterpret_cast<float2*>(out + (row0 + qi0) * E + col) =
            make_float2(o[nd][0] / l0, o[nd][1] / l0);
      if (qi0 + 8 < Lq)
        *reinterpret_cast<float2*>(out + (row0 + qi0 + 8) * E + col) =
            make_float2(o[nd][2] / l1, o[nd][3] / l1);
    }
  }
};

// column groups of the P . V product taken at once: all, or half at hd 128
template <int HD>
constexpr int NH = HD >= 128 ? HD / 16 : HD / 8;

// One tile of KN keys for a warp's 16 rows: S = qs . K^T, the masks and the
// online softmax update, then o = o * alpha + e . V. Kt, Vt: the tile's
// split K and V rows (KN rows of RS<HD>); flags: its KN key flags; qf0, qf1:
// the pair flags of rows g and g + 8. The step of block_attend below, and
// of the fused stream layer (stream_layer.cu), whose K and V tiles are its
// own projections.
template <int HD, int KN = KT>
__device__ __forceinline__ void attend_tile(Online<HD / 8>& st, const SplitRows<HD>& qa,
                                            const SplitTile& Kt, const SplitTile& Vt,
                                            const uint8_t* flags, int lane, bool qf0, bool qf1) {
  constexpr int NT = KN / 8;
  float s[NT][4];
  tf32x3::product_nt<HD, NT>(s, qa, Kt, 0, lane);
  float alpha0, alpha1;
  st.template update<NT>(s, flags, lane & 3, qf0, qf1, alpha0, alpha1);
  st.template accumulate<HD, KN, NH<HD>>(s, Vt, lane, alpha0, alpha1);
}

// The output rows [q0, q0 + ROWS) of head h of sample b, head_dim HD (16,
// 32, 64 or 128), key tiles of KN keys, by the THREADS threads of the
// block, with Smem<HD, KN>::bytes_for(Lk) of dynamic shared memory at
// `smem`. q, k, v, out: (B, Lq or Lk, E) f32 on 16-byte boundaries; mask
// (B, Lk) uint8; scale the f32 softmax scale. FACTORS: qf (Lq) and kf (Lk),
// the pair factors of head h of sample b as uint8, mask the pairs whose
// flags are both set.
template <int HD, bool FACTORS = false, int KN = KT>
__device__ __forceinline__ void block_attend(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const uint8_t* __restrict__ mask,
                                             float* __restrict__ out, int Lq, int Lk, int E,
                                             float scale, int b, int h, int q0,
                                             unsigned char* smem,
                                             const uint8_t* __restrict__ qf = nullptr,
                                             const uint8_t* __restrict__ kf = nullptr) {
  constexpr int R = RS<HD>, T1 = KN * R;
  const int ntiles = (Lk + KN - 1) / KN;
  float* Qh = reinterpret_cast<float*>(smem);
  float* Ql = Qh + ROWS * R;
  float* buf = Ql + ROWS * R;  // [2][Khi, Klo, Vhi, Vlo][T1], one buffer for one tile
  uint8_t* Fs = reinterpret_cast<uint8_t*>(buf + (ntiles > 1 ? 8 : 4) * T1);  // [2][KN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int rows = min(ROWS, Lq - q0);
  const float* kb = k + (size_t)b * Lk * E + h * HD;
  const float* vb = v + (size_t)b * Lk * E + h * HD;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  const bool active = 16 * warp < rows;  // a warp past Lq still meets the barriers
  const int r0 = q0 + 16 * warp + g;
  bool qf0 = false, qf1 = false;
  if constexpr (FACTORS) {
    qf0 = r0 < Lq && qf[r0];
    qf1 = r0 + 8 < Lq && qf[r0 + 8];
  }

  tf32x3::stage_tile<HD, ROWS, THREADS>(Qh, q + ((size_t)b * Lq + q0) * E + h * HD, rows, E);
  tf32x3::cp_async_commit();
  const SplitRows<HD> qa{Qh + (16 * warp + g) * R + t, Ql + (16 * warp + g) * R + t};
  Online<HD / 8> st;
  bool first = true;

  tf32x3::walk(
      ntiles,
      [&](int it, int bi) {
        const int k0 = it * KN;
        float* base = buf + bi * 4 * T1;
        tf32x3::stage_tile<HD, KN, THREADS>(base, kb + (size_t)k0 * E, min(KN, Lk - k0), E);
        tf32x3::stage_tile<HD, KN, THREADS>(base + 2 * T1, vb + (size_t)k0 * E,
                                            min(KN, Lk - k0), E);
        if (tid < KN) {
          uint8_t f = tf32x3::key_flag(mask_b, k0 + tid, Lk);
          if (FACTORS && k0 + tid < Lk && kf[k0 + tid]) f |= KEY_PAIR;
          Fs[bi * KN + tid] = f;
        }
        tf32x3::cp_async_commit();
      },
      [&](int bi) {
        if (first) {  // the Q tile's copies landed with tile 0's
          tf32x3::split_tile<HD, ROWS, THREADS>(Qh, Ql, scale);
          first = false;
        }
        float* base = buf + bi * 4 * T1;
        tf32x3::split_tile<HD, KN, THREADS>(base, base + T1, 1.f);
        tf32x3::split_tile<HD, KN, THREADS>(base + 2 * T1, base + 3 * T1, 1.f);
      },
      [&](int, int bi) {
        if (!active) return;
        const float* base = buf + bi * 4 * T1;
        attend_tile<HD, KN>(st, qa, SplitTile{base, base + T1},
                            SplitTile{base + 2 * T1, base + 3 * T1}, Fs + bi * KN, lane, qf0, qf1);
      },
      [](int) {});
  if (active) st.store(out + h * HD, (size_t)b * Lq, r0, Lq, E, t);
}

// Wide heads: the output columns [128 c, 128 c + 128) of head h (hdp = 128 n
// columns at h * hdp) for rows [q0, q0 + ROWS), with WideSmem::bytes of
// dynamic shared memory. FACTORS: qf (Lq) and kf (Lk), the pair factors of
// head h of sample b as uint8, mask the pairs whose flags are both set.
template <bool FACTORS>
__device__ __forceinline__ void block_attend_wide(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int Lq, int Lk, int E, int hdp,
    float scale, int b, int h, int q0, int c, unsigned char* smem,
    const uint8_t* __restrict__ qf = nullptr, const uint8_t* __restrict__ kf = nullptr) {
  constexpr int HD = SLICE, R = RS<HD>, T1 = KT * R, NT = KT / 8;
  float* Qh = reinterpret_cast<float*>(smem);
  float* Ql = Qh + ROWS * R;
  float* Kh = Ql + ROWS * R;
  float* Vh = Kh + 2 * T1;
  uint8_t* Fs = reinterpret_cast<uint8_t*>(Vh + 2 * T1);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int rows = min(ROWS, Lq - q0), n = hdp / SLICE;
  const float* qb = q + ((size_t)b * Lq + q0) * E + h * hdp;
  const float* kb = k + (size_t)b * Lk * E + h * hdp;
  const float* vb = v + (size_t)b * Lk * E + h * hdp + c * SLICE;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  const bool active = 16 * warp < rows;
  const int r0 = q0 + 16 * warp + g;
  bool qf0 = false, qf1 = false;
  if constexpr (FACTORS) {
    qf0 = r0 < Lq && qf[r0];
    qf1 = r0 + 8 < Lq && qf[r0 + 8];
  }
  const SplitRows<HD> qa{Qh + (16 * warp + g) * R + t, Ql + (16 * warp + g) * R + t};
  Online<HD / 8> st;

  for (int k0 = 0; k0 < Lk; k0 += KT) {
    const int kn = min(KT, Lk - k0);
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    for (int sl = 0; sl < n; ++sl) {
      __syncthreads();  // every warp is done with the buffers
      tf32x3::stage_tile<HD, ROWS, THREADS>(Qh, qb + sl * SLICE, rows, E);
      tf32x3::stage_tile<HD, KT, THREADS>(Kh, kb + (size_t)k0 * E + sl * SLICE, kn, E);
      if (sl == n - 1) tf32x3::stage_tile<HD, KT, THREADS>(Vh, vb + (size_t)k0 * E, kn, E);
      if (sl == 0 && tid < KT) {
        uint8_t f = tf32x3::key_flag(mask_b, k0 + tid, Lk);
        if (FACTORS && k0 + tid < Lk && kf[k0 + tid]) f |= KEY_PAIR;
        Fs[tid] = f;
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      tf32x3::split_tile<HD, ROWS, THREADS>(Qh, Ql, scale);
      tf32x3::split_tile<HD, KT, THREADS>(Kh, Kh + T1, 1.f);
      if (sl == n - 1) tf32x3::split_tile<HD, KT, THREADS>(Vh, Vh + T1, 1.f);
      __syncthreads();
      if (active) {
        float part[NT][4];
        tf32x3::product_nt<HD, NT>(part, qa, SplitTile{Kh, Kh + T1}, 0, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nt][i] += part[nt][i];
      }
    }
    if (active) {
      float alpha0, alpha1;
      st.template update<NT>(s, Fs, t, qf0, qf1, alpha0, alpha1);
      st.template accumulate<HD, KT, NH<HD>>(s, SplitTile{Vh, Vh + T1}, lane, alpha0, alpha1);
    }
  }
  if (active) st.store(out + h * hdp + c * SLICE, (size_t)b * Lq, r0, Lq, E, t);
}

}  // namespace fp32_attn
