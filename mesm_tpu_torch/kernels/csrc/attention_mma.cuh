// Device code for bf16 multi-head attention on Hopper's tensor cores: a
// warp-level body on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// that computes 16 query rows of one head at the TPU kernels' rounding
// points, and the block-level staging around it. Shared by the bf16
// attention kernels over (B, L, E) operands (attention_heads.cu,
// attention_batched.cu, attention_packed.cu: its packed and pair entry
// points; attention_shortkey.cu: its bf16 short-key kernel).
//
// What a warp computes, for rows i of head h of sample b (as
// attention_batched_reference, with bf() the rounding to bf16):
//   qs = bf(q_h * scale)          (scale already bf16: a product in bf16)
//   logits = qs . k_h^T           (f32 sums in the mma accumulators)
//   masked keys -> -1e9, a finite value; keys past Lk -> probability 0
//   m = max_j logits; l = sum_j exp(logits - m); p = bf(exp(logits - m) / l)
//   out_h = bf(p . v_h)           (f32 sums)
// an exact two-pass softmax over exactly Lk keys, so a row whose keys are
// all masked averages v over all Lk keys.
//
// That is Chain::BATCHED. Two more chains are compile-time variants:
//
// Chain::PACKED, the packed kernel's (as attention_packed_reference; it
// rounds at more points):
//   qs = bf(q_h * scale)
//   s = bf(qs . k_h^T)            (f32 sums, then rounded)
//   masked keys -> bf(-1e9); keys past Lk -> probability 0
//   m = max_j s; e = bf(exp(bf(s - m))); l = bf(sum_j e), the sum in f32
//   p = bf(e / l); out_h = bf(p . v_h)
//
// Chain::PAIR, the pair-masked kernel's (as attention_packed_pair_reference:
// q scaled in f32, an f32 softmax, only p rounded):
//   logits = (q_h . k_h^T) * scale  (exact products of the unscaled bf16
//                                    operands summed in f32, times the f32
//                                    scale: the plain version's f32(q) *
//                                    scale products in another order)
//   masked keys, and pairs whose row and key pair flags are both set, ->
//   -1e9; keys past Lk -> probability 0
//   m, l and p = bf(exp(logits - m) / l) as the batched chain; out_h = bf(p . v_h)
// Rounding q * scale to bf16 first, as the batched chain does, would move
// every logit by up to 2^-9 of itself.
// The instruction streams of BATCHED and PACKED do not depend on PAIR, nor
// on each other.
//
// Fragments (PTX ISA, m16n8k16 with bf16 inputs; lane = 4 g + t): A holds
// rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of a 16 x 16 tile;
// B holds k = 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; the f32 C holds
// rows g and g + 8, columns 2t, 2t + 1. So the C tiles of the logits of 16
// keys are, packed to bf16 pairs, the A fragment of P for those 16 keys
// (the C -> A register identity): P . V needs no trip through shared
// memory. Q's A fragments come from ldmatrix, K's B fragments from
// ldmatrix (K rows are k-contiguous columns of K^T) and V's from
// ldmatrix.trans.
//
// Shared memory: the block's Q tile, K_h and V_h (all keys, zero rows past
// Lk up to a multiple of 16) and one flag byte per key (1 valid, 0 masked,
// 2 past Lk; the pair chain adds KEY_PAIR where the key's pair factor is
// set), staged once per block with 16-byte cp.async copies. Rows are
// hd bf16 (32 to 256 bytes) with their 16-byte chunks XOR-swizzled by row,
// so the 8 rows an ldmatrix phase reads fall in 8 distinct bank groups
// without padding: up to 3,536 keys at hd 16, 1,760 at hd 32, 864 at hd 64
// and 416 at hd 128 fit in a block's 227 KB. Beyond, a head of head_dim 128
// takes the wide body below (one 128-column slice, any Lk), and the
// wrappers pad a smaller head_dim to 128.
//
// Head dims 16, 32, 64 and 128: at hd 16 the q . k^T of an n8 key tile is
// one k step of 16 (an ldmatrix x2 of K), at hd 128 a row of a tile spans
// two 128-byte lines and the swizzle permutes its chunks within 8.
//
// The row's logits: up to resident_keys<HD>() keys (RESIDENT_KEYS, 128 at
// hd 128, where q's fragments and the output take 96 registers) they stay
// in registers (32 n8 tiles, 128 f32 a thread; an instance may hold fewer,
// KEYS, in fewer registers) and are computed once; beyond, the warp walks
// the keys in chunks of CHUNK_KEYS and recomputes each chunk's logits in
// each of the three passes (max, sum, P . V), which at hd 32-64 costs a few
// tensor-core instructions a chunk.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mma_attn {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // query rows per block
constexpr int RESIDENT_KEYS = 256;
constexpr int CHUNK_KEYS = 64;
constexpr float NEG_INF = -1e9f;
constexpr uint8_t KEY_PAIR = 4;  // flag bit: the key's pair factor (Chain::PAIR)

// the rounding chain of a warp's softmax (see the top of this file)
enum class Chain { BATCHED, PACKED, PAIR };

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// the keys whose logits a warp keeps in registers at head_dim HD
template <int HD>
__host__ __device__ constexpr int resident_keys() {
  return HD >= 128 ? 128 : RESIDENT_KEYS;
}

// Dynamic shared memory of a block: Q tile, K_h, V_h, key flags.
template <int HD>
struct Smem {
  static size_t bytes(int Lk) {
    const size_t kp = (size_t)pad16(Lk);
    return ((size_t)ROWS + 2 * kp) * HD * sizeof(bf16) + kp;
  }
};

// whether a head of head_dim HD with Lk keys takes the wide body
// (block_attend_wide) rather than the staging above: at HD 128 where K_h
// and V_h do not fit `max_smem`
template <int HD>
inline bool unstaged(int Lk, size_t max_smem) {
  return HD == 128 && Smem<HD>::bytes(Lk) > max_smem;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// exp(s - m); the packed chain rounds the difference and the exp to bf16
template <Chain C>
__device__ __forceinline__ float exp_shifted(float s, float m) {
  return C == Chain::PACKED ? round_bf16(expf(round_bf16(s - m))) : expf(s - m);
}

// The pair chain's logit of a key with flag f in a row with pair flag qf:
// the f32 sum times the f32 scale; -1e9 where the key is masked or both
// pair flags are set; -inf past Lk.
__device__ __forceinline__ float pair_logit(float acc, uint8_t f, bool qf, float scale) {
  if (f == 2) return -INFINITY;
  return (f & 1) && !(qf && (f & KEY_PAIR)) ? acc * scale : NEG_INF;
}

// Element offset of 16-byte chunk `c` of row `r` in a swizzled tile of
// rows of HD bf16: chunk c ^ ((r / rows_per_128_bytes) % chunks_per_row),
// or c ^ (r % 8) where a row spans more than one 128-byte line (hd 128).
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = HD / 8;
  constexpr int RPL = CH >= 8 ? 1 : 8 / CH;
  constexpr int X = CH >= 8 ? 8 : CH;
  return r * HD + ((c ^ ((r / RPL) % X)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf(x * scale) for both halves of a bf16 pair
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// Stage `rows` rows of HD bf16 (row stride `ld` elements in device memory)
// into a swizzled tile of `rows_pad` rows, zeros past `rows`.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int rows,
                                           int rows_pad, int ld) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < rows_pad * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    bf16* d = dst + swz<HD>(r, c);
    if (r < rows)
      cp_async16(d, src + (size_t)r * ld + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The masked logits of the warp's 16 rows against NT n8 tiles of keys from
// key0 (tiles at or past kpad: -inf, not computed), rounded to bf16 in the
// packed chain; in the pair chain scaled by `scale` and masked by the pair
// flags of rows g (qf0) and g + 8 (qf1).
template <int HD, int NT, Chain C>
__device__ __forceinline__ void logits(float (&s)[NT][4], const uint32_t (&qa)[HD / 16][4],
                                       const bf16* Ks, const uint8_t* flags, int key0, int kpad,
                                       int lane, float scale, bool qf0, bool qf1) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n0 = key0 + 8 * nt;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    if (n0 >= kpad) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = -INFINITY;
      continue;
    }
#pragma unroll
    for (int hx = 0; hx < HD / 32; ++hx) {
      uint32_t kb[4];  // d chunks 4hx .. 4hx + 3 of keys n0 .. n0 + 7
      ldmatrix_x4(kb, Ks + swz<HD>(n0 + (lane & 7), (lane >> 3) + 4 * hx));
      mma_bf16(s[nt], qa[2 * hx], kb[0], kb[1]);
      mma_bf16(s[nt], qa[2 * hx + 1], kb[2], kb[3]);
    }
    if constexpr (HD % 32 == 16) {  // hd 16: one k step, d chunks 0 and 1
      uint32_t kb[2];
      ldmatrix_x2(kb, Ks + swz<HD>(n0 + (lane & 7), ((lane >> 3) & 1) + 4 * (HD / 32)));
      mma_bf16(s[nt], qa[2 * (HD / 32)], kb[0], kb[1]);
    }
    const uint8_t f0 = flags[n0 + 2 * t], f1 = flags[n0 + 2 * t + 1];
    if constexpr (C == Chain::PAIR) {
      s[nt][0] = pair_logit(s[nt][0], f0, qf0, scale);
      s[nt][1] = pair_logit(s[nt][1], f1, qf0, scale);
      s[nt][2] = pair_logit(s[nt][2], f0, qf1, scale);
      s[nt][3] = pair_logit(s[nt][3], f1, qf1, scale);
    } else {
      s[nt][0] = f0 == 2 ? -INFINITY : (f0 ? s[nt][0] : NEG_INF);
      s[nt][2] = f0 == 2 ? -INFINITY : (f0 ? s[nt][2] : NEG_INF);
      s[nt][1] = f1 == 2 ? -INFINITY : (f1 ? s[nt][1] : NEG_INF);
      s[nt][3] = f1 == 2 ? -INFINITY : (f1 ? s[nt][3] : NEG_INF);
      if (C == Chain::PACKED) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = round_bf16(s[nt][i]);
      }
    }
  }
}

// e / l, correctly rounded, for 0 <= e <= l and l >= 1, given r =
// __frcp_rn(l): one Newton step on the product (Markstein). The division
// operator would take its slow path for the zeros of masked keys.
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One warp: the output of 16 query rows (Qw: the warp's rows of the
// swizzled Q tile, unscaled) over kpad staged keys (Ks, Vs, flags), in
// o[HD / 8][4] (C layout, f32 sums of bf16 products, not rounded).
// RESIDENT: kpad <= KEYS, the logits computed once and kept in KEYS / 8
// n8 tiles. C: the rounding chain; qf0, qf1: the pair flags of rows g and
// g + 8 (Chain::PAIR only).
template <int HD, bool RESIDENT, Chain C, int KEYS = resident_keys<HD>()>
__device__ __forceinline__ void warp_attend(float (&o)[HD / 8][4], const bf16* Qw, const bf16* Ks,
                                            const bf16* Vs, const uint8_t* flags, int kpad,
                                            float scale, int lane, bool qf0, bool qf1) {
  constexpr int NT = (RESIDENT ? KEYS : CHUNK_KEYS) / 8;
  constexpr int KS = HD / 16;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldmatrix_x4(qa[ks], Qw + swz<HD>(lane & 15, 2 * ks + (lane >> 4)));
    if constexpr (C != Chain::PAIR) {  // the pair chain scales the f32 sums
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = scale_bf16x2(qa[ks][i], scale);
    }
  }
  const int nchunk = RESIDENT ? 1 : (kpad + 8 * NT - 1) / (8 * NT);

  float s[NT][4];
  if (RESIDENT) logits<HD, NT, C>(s, qa, Ks, flags, 0, kpad, lane, scale, qf0, qf1);
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g, g + 8
  for (int c = 0; c < nchunk; ++c) {
    if (!RESIDENT) logits<HD, NT, C>(s, qa, Ks, flags, c * 8 * NT, kpad, lane, scale, qf0, qf1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
  m0 = quad_max(m0);  // finite: Lk >= 1 and a masked key is -1e9
  m1 = quad_max(m1);

  float l0 = 0.f, l1 = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    if (!RESIDENT) logits<HD, NT, C>(s, qa, Ks, flags, c * 8 * NT, kpad, lane, scale, qf0, qf1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (c * 8 * NT + 8 * nt >= kpad) break;  // no key: P . V stops there too
      const float e0 = exp_shifted<C>(s[nt][0], m0), e1 = exp_shifted<C>(s[nt][1], m0);
      const float e2 = exp_shifted<C>(s[nt][2], m1), e3 = exp_shifted<C>(s[nt][3], m1);
      l0 += e0 + e1;
      l1 += e2 + e3;
      if (RESIDENT) {
        s[nt][0] = e0;
        s[nt][1] = e1;
        s[nt][2] = e2;
        s[nt][3] = e3;
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (C == Chain::PACKED) {
    l0 = round_bf16(l0);
    l1 = round_bf16(l1);
  }
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const int key0 = c * 8 * NT;
    if (!RESIDENT) {
      logits<HD, NT, C>(s, qa, Ks, flags, key0, kpad, lane, scale, qf0, qf1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = exp_shifted<C>(s[nt][0], m0);
        s[nt][1] = exp_shifted<C>(s[nt][1], m0);
        s[nt][2] = exp_shifted<C>(s[nt][2], m1);
        s[nt][3] = exp_shifted<C>(s[nt][3], m1);
      }
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const int k0 = key0 + 16 * j;
      if (k0 >= kpad) break;
      // p = bf(e / l), 0 <= e <= 1 <= l in every chain: the C tiles of keys
      // k0 .. k0 + 15 as an A fragment
      const uint32_t pa[4] = {
          pack_bf16(div_rn(s[2 * j][0], l0, r0), div_rn(s[2 * j][1], l0, r0)),
          pack_bf16(div_rn(s[2 * j][2], l1, r1), div_rn(s[2 * j][3], l1, r1)),
          pack_bf16(div_rn(s[2 * j + 1][0], l0, r0), div_rn(s[2 * j + 1][1], l0, r0)),
          pack_bf16(div_rn(s[2 * j + 1][2], l1, r1), div_rn(s[2 * j + 1][3], l1, r1))};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];  // keys k0 .. k0 + 15 of d chunks 2dp, 2dp + 1
        ldmatrix_x4_trans(vb, Vs + swz<HD>(k0 + (lane & 7) + (lane & 8), 2 * dp + (lane >> 4)));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

// The whole block: output rows [q0, q0 + ROWS) of head h of sample b.
// q: (B, Lq, E), k, v: (B, Lk, E), out: (B, Lq, E) bf16, 16-byte aligned;
// mask (B, Lk) uint8. Smem<HD>::bytes(Lk) of dynamic shared memory at smem.
// Chain::PAIR also reads qf (Lq) and kf (Lk), the pair factors of head h of
// sample b as uint8, and takes the f32 softmax scale; the other chains take
// the scale already rounded to bf16 and no factors. With FACTORS false the
// pair chain runs without pair factors: no key carries KEY_PAIR and no row
// flag is read (the short-key kernel without its pair mask). RESIDENT needs
// pad16(Lk) <= KEYS.
template <int HD, bool RESIDENT, Chain C = Chain::BATCHED, int KEYS = resident_keys<HD>(),
          bool FACTORS = true>
__device__ __forceinline__ void block_attend(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const uint8_t* __restrict__ mask,
                                             bf16* __restrict__ out, int Lq, int Lk, int E,
                                             float scale, int b, int h, int q0,
                                             unsigned char* smem,
                                             const uint8_t* __restrict__ qf = nullptr,
                                             const uint8_t* __restrict__ kf = nullptr) {
  constexpr int CH = HD / 8;
  const int kpad = pad16(Lk);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + ROWS * HD;
  bf16* Vs = Ks + (size_t)kpad * HD;
  uint8_t* flags = reinterpret_cast<uint8_t*>(Vs + (size_t)kpad * HD);

  stage_rows<HD>(Qs, q + ((size_t)b * Lq + q0) * E + h * HD, min(ROWS, Lq - q0), ROWS, E);
  stage_rows<HD>(Ks, k + (size_t)b * Lk * E + h * HD, Lk, kpad, E);
  stage_rows<HD>(Vs, v + (size_t)b * Lk * E + h * HD, Lk, kpad, E);
  for (int j = threadIdx.x; j < kpad; j += THREADS) {
    if constexpr (C == Chain::PAIR && FACTORS)
      flags[j] = j < Lk ? (mask[(size_t)b * Lk + j] ? 1 : 0) | (kf[j] ? KEY_PAIR : 0) : 2;
    else
      flags[j] = j < Lk ? (mask[(size_t)b * Lk + j] ? 1 : 0) : 2;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * warp;
  if (r0 >= Lq) return;
  bf16* Qw = Qs + 16 * warp * HD;  // 16 rows: the swizzle pattern repeats every 8
  bool qf0 = false, qf1 = false;  // the pair flags of the thread's rows g and g + 8
  if constexpr (C == Chain::PAIR && FACTORS) {
    const int g = lane >> 2;
    qf0 = r0 + g < Lq && qf[r0 + g];
    qf1 = r0 + g + 8 < Lq && qf[r0 + g + 8];
  }
  float o[HD / 8][4];
  warp_attend<HD, RESIDENT, C, KEYS>(o, Qw, Ks, Vs, flags, kpad, scale, lane, qf0, qf1);

  // out = bf(o), through the warp's (read) Q rows, then 16-byte stores
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(Qw + swz<HD>(g, dt) + 2 * t) = pack_bf16(o[dt][0], o[dt][1]);
    *reinterpret_cast<uint32_t*>(Qw + swz<HD>(g + 8, dt) + 2 * t) = pack_bf16(o[dt][2], o[dt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (r0 + r < Lq)
      *reinterpret_cast<uint4*>(out + ((size_t)b * Lq + r0 + r) * E + h * HD + 8 * c) =
          *reinterpret_cast<const uint4*>(Qw + swz<HD>(r, c));
  }
}


// ---------------------------------------------------------------------------
// wide heads
// ---------------------------------------------------------------------------
//
// A head_dim above 128 (the wrapper zero-pads it to 128 n) fits neither the
// staging above (at hd 256 the charades encoder's 195 keys take 245,760
// bytes) nor a warp's registers (Q's fragments and a 16 x 256 f32 output
// beside the logits). The wide body keeps the logits in shared memory
// instead, and takes the head in 128-column slices:
//   - one block of 4 warps per (b, h, 64 query rows, output chunk c of 128
//     columns: grid dimension y, attention_grid.cuh);
//   - the logits S [64 rows][kpad] as f32 sums: for each slice, the block
//     stages the Q slice and then K's slice 64 keys at a time, and each warp
//     adds its rows' mma.sync m16n8k16 sums over the slice's 128 columns
//     into S, slice 0 first, so every chunk sees the same logits;
//   - the chain's exact two-pass softmax on each row, the lanes across the
//     keys, leaving bf(p) in S;
//   - P . V for chunk c: V's chunk staged 64 keys at a time, P's A
//     fragments read from S, the output 16 x 128 f32 a warp in registers.
// The products of a slice and the softmax round where the body above
// rounds; the f32 sums over the slices and the row sums are taken in
// another order. Shared memory: 64 x (kpad + 4) floats of logits, a Q slice
// and a K or V piece (32 KB), the row statistics (8.5 KB), the flags. The
// logits of up to WIDE_KEYS = 704 keys stay in S; more keys are taken in
// chunks of 704 in three passes (each row's max, its sum of e, then P .
// V), each pass computing the chunk's logits again: the same values in
// the same order, so the result is the one-chunk result, for three times
// the product work. Any Lk. The sources launch the one-chunk instance
// (ONE_CHUNK, their kernels' RESIDENT one) where the keys fit a chunk: it
// holds no output registers while it computes the logits.

constexpr int SLICE = 128;  // head columns of a slice and of an output chunk
constexpr int PIECE = 64;   // keys of K or V staged at a time
// keys whose logits a wide block keeps at once: a multiple of PIECE (and of
// the 32 lanes, so a lane's share of a row sum keeps its order across
// chunks) whose WideSmem::block fits attn_grid::MAX_SMEM
constexpr int WIDE_KEYS = 704;

// Dynamic shared memory of a wide block whose rows hold `cols` logits (the
// keys padded to 16, times the heads it takes): S [ROWS][cols + 4] f32, a Q
// slice [ROWS][SLICE] (also the output's staging) and a K or V piece
// [PIECE][SLICE] bf16, then `cols` key flags and `extra` bytes.
struct WideSmem {
  static size_t bytes(int cols, size_t extra = 0) {
    return (size_t)ROWS * (cols + 4) * 4 + (size_t)(ROWS + PIECE) * SLICE * sizeof(bf16) +
           cols + extra;
  }
  // a block of block_attend_wide over Lk keys: the logits of a chunk of at
  // most WIDE_KEYS keys, and before the flags the row statistics: 32 lane
  // sums, the max and the sum of each row (223,424 bytes at most)
  static size_t block(int Lk) {
    const int kp = pad16(Lk);
    return bytes(kp < WIDE_KEYS ? kp : WIDE_KEYS, (size_t)ROWS * (32 + 2) * sizeof(float));
  }
};

// whether a wide block over Lk keys keeps every key's logits in S (one
// chunk): the instance of block_attend_wide with ONE_CHUNK, which holds no
// output registers while it computes the logits
inline bool one_chunk(int Lk) { return pad16(Lk) <= WIDE_KEYS; }

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

// Adds one head's logits into columns [col0, col0 + pad16(Lk)) of the
// warp's rows of S (row stride ss): the f32 sums of qs . k_h^T over nsl
// slices of 128 columns. qh: the block's first query row of the head (row
// stride E, qrows real rows), kh: its key 0. With scale_q the A operand is
// qs = bf(q * scale) (scale already bf16), else q itself. Every warp of the
// block calls it (its barriers); `active` warps compute.
__device__ __forceinline__ void wide_logits(float* S, int ss, int col0, const bf16* __restrict__ qh,
                                            int qrows, const bf16* __restrict__ kh, int Lk, int E,
                                            int nsl, bool scale_q, float scale, bf16* Qs,
                                            bf16* Ks, int warp, int lane, bool active) {
  const int kpad = pad16(Lk), g = lane >> 2, t = lane & 3;
  float* S0 = S + (size_t)(16 * warp + g) * ss + col0 + 2 * t;  // row g
  float* S1 = S0 + (size_t)8 * ss;                              // row g + 8
  for (int sl = 0; sl < nsl; ++sl) {
    __syncthreads();  // every warp is done with Qs and Ks
    stage_rows<SLICE>(Qs, qh + sl * SLICE, qrows, ROWS, E);
    cp_async_wait_all();
    __syncthreads();
    uint32_t qa[SLICE / 16][4];
    if (active) {
#pragma unroll
      for (int ks = 0; ks < SLICE / 16; ++ks) {
        ldmatrix_x4(qa[ks], Qs + 16 * warp * SLICE + swz<SLICE>(lane & 15, 2 * ks + (lane >> 4)));
        if (scale_q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[ks][i] = scale_bf16x2(qa[ks][i], scale);
        }
      }
    }
    for (int p0 = 0; p0 < kpad; p0 += PIECE) {
      const int pn = min(PIECE, kpad - p0);
      __syncthreads();  // every warp is done with Ks
      stage_rows<SLICE>(Ks, kh + (size_t)p0 * E + sl * SLICE, min(pn, Lk - p0), pn, E);
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      for (int n0 = 0; n0 < pn; n0 += 8) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hx = 0; hx < SLICE / 32; ++hx) {
          uint32_t kb[4];  // d chunks 4hx .. 4hx + 3 of keys n0 .. n0 + 7
          ldmatrix_x4(kb, Ks + swz<SLICE>(n0 + (lane & 7), (lane >> 3) + 4 * hx));
          mma_bf16(c, qa[2 * hx], kb[0], kb[1]);
          mma_bf16(c, qa[2 * hx + 1], kb[2], kb[3]);
        }
        float* a0 = S0 + p0 + n0;
        float* a1 = S1 + p0 + n0;
        if (sl == 0) {
          a0[0] = c[0];
          a0[1] = c[1];
          a1[0] = c[2];
          a1[1] = c[3];
        } else {
          a0[0] += c[0];
          a0[1] += c[1];
          a1[0] += c[2];
          a1[1] += c[3];
        }
      }
    }
  }
}

// The chain's logit of a key with flag f (KEY_PAIR set only under
// Chain::PAIR with factors) in a row with pair flag qf, from its f32 sum s:
// as warp_attend's.
template <Chain C>
__device__ __forceinline__ float wide_logit(float s, uint8_t f, bool qf, float scale) {
  if constexpr (C == Chain::PAIR) return pair_logit(s, f, qf, scale);
  const float x = f == 2 ? -INFINITY : (f ? s : NEG_INF);
  return C == Chain::PACKED ? round_bf16(x) : x;
}

__device__ __forceinline__ void zero(float (&o)[SLICE / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < SLICE / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
}

// o += P . V over columns [col0, col0 + pad16(Lk)) of the warp's rows of S
// (bf16 values) and the 128 columns of V at vh (key 0 of the head's chunk,
// row stride E), staged PIECE keys at a time into Vs. Every warp calls it.
__device__ __forceinline__ void wide_pv(float (&o)[SLICE / 8][4], const float* S, int ss, int col0,
                                        const bf16* __restrict__ vh, int Lk, int E, bf16* Vs,
                                        int warp, int lane, bool active) {
  const int kpad = pad16(Lk), g = lane >> 2, t = lane & 3;
  const float* S0 = S + (size_t)(16 * warp + g) * ss + col0 + 2 * t;
  const float* S1 = S0 + (size_t)8 * ss;
  for (int p0 = 0; p0 < kpad; p0 += PIECE) {
    const int pn = min(PIECE, kpad - p0);
    __syncthreads();  // every warp is done with Vs
    stage_rows<SLICE>(Vs, vh + (size_t)p0 * E, min(pn, Lk - p0), pn, E);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < pn; kk += 16) {
      const float* a0 = S0 + p0 + kk;
      const float* a1 = S1 + p0 + kk;
      const uint32_t pa[4] = {pack_bf16(a0[0], a0[1]), pack_bf16(a1[0], a1[1]),
                              pack_bf16(a0[8], a0[9]), pack_bf16(a1[8], a1[9])};
#pragma unroll
      for (int dp = 0; dp < SLICE / 16; ++dp) {
        uint32_t vb[4];  // keys kk .. kk + 15 of d chunks 2dp, 2dp + 1
        ldmatrix_x4_trans(vb, Vs + swz<SLICE>(kk + (lane & 7) + (lane & 8), 2 * dp + (lane >> 4)));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

// out = bf(o) for the warp's rows below `rows`: dst is the block's first
// row at the chunk's first column (row stride E); through the warp's rows
// of Qs, then 16-byte stores.
__device__ __forceinline__ void wide_store(const float (&o)[SLICE / 8][4], bf16* __restrict__ dst,
                                           int rows, int E, bf16* Qs, int warp, int lane) {
  constexpr int CH = SLICE / 8;
  const int g = lane >> 2, t = lane & 3;
  bf16* Qw = Qs + 16 * warp * SLICE;
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < CH; ++dt) {
    *reinterpret_cast<uint32_t*>(Qw + swz<SLICE>(g, dt) + 2 * t) = pack_bf16(o[dt][0], o[dt][1]);
    *reinterpret_cast<uint32_t*>(Qw + swz<SLICE>(g + 8, dt) + 2 * t) =
        pack_bf16(o[dt][2], o[dt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (16 * warp + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(16 * warp + r) * E + 8 * c) =
          *reinterpret_cast<const uint4*>(Qw + swz<SLICE>(r, c));
  }
  __syncwarp();
}

// The whole wide block: output columns [128 c, 128 c + 128) of head h
// (hdp = E / H columns at h * hdp) for rows [q0, q0 + ROWS) of sample b, in
// chain C, with WideSmem::block(Lk) of dynamic shared memory. Operands,
// scale and pair factors as block_attend's. ONE_CHUNK: one_chunk(Lk) holds,
// and the logits are computed once (an instance with fewer registers).
template <Chain C, bool FACTORS = true, bool ONE_CHUNK = false>
__device__ __forceinline__ void block_attend_wide(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, bf16* __restrict__ out, int Lq, int Lk, int E, int hdp,
    float scale, int b, int h, int q0, int c, unsigned char* smem,
    const uint8_t* __restrict__ qf = nullptr, const uint8_t* __restrict__ kf = nullptr) {
  constexpr bool PF = C == Chain::PAIR && FACTORS;
  const int kpad = pad16(Lk), ss = (kpad < WIDE_KEYS ? kpad : WIDE_KEYS) + 4;
  const int nch = ONE_CHUNK ? 1 : (kpad + WIDE_KEYS - 1) / WIDE_KEYS;
  float* S = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(S + (size_t)ROWS * ss);
  bf16* Ks = Qs + ROWS * SLICE;
  float* part = reinterpret_cast<float*>(Ks + PIECE * SLICE);  // [ROWS][32] lane sums
  float* M = part + ROWS * 32;                                 // each row's max
  float* L = M + ROWS;                                         // each row's sum
  uint8_t* flags = reinterpret_cast<uint8_t*>(L + ROWS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(ROWS, Lq - q0), rend = min(16 * warp + 16, rows);
  const bool active = 16 * warp < rows;  // a warp past Lq still meets the barriers
  const bf16* qh = q + ((size_t)b * Lq + q0) * E + h * hdp;
  const bf16* kh = k + (size_t)b * Lk * E + h * hdp;
  const bf16* vh = v + (size_t)b * Lk * E + h * hdp + c * SLICE;
  // the raw logits of chunk ch (keys [704 ch, 704 ch + 704)) into S, and
  // its key flags; every warp calls it
  auto chunk_logits = [&](int ch) {
    const int k0 = ch * WIDE_KEYS, kn = min(WIDE_KEYS, Lk - k0), cn = pad16(kn);
    __syncthreads();  // every warp is done with S and the flags
    for (int j = threadIdx.x; j < cn; j += THREADS) {
      uint8_t f = 2;
      if (j < kn) {
        f = mask[(size_t)b * Lk + k0 + j] ? 1 : 0;
        if (PF && kf[k0 + j]) f |= KEY_PAIR;
      }
      flags[j] = f;
    }
    wide_logits(S, ss, 0, qh, rows, kh + (size_t)k0 * E, kn, E, hdp / SLICE, C != Chain::PAIR,
                scale, Qs, Ks, warp, lane, active);
  };
  // pass 0: each row's max; 1: its sum of e. One chunk's logits stay in S
  // between the passes; more are computed again in each.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    for (int ch = 0; ch < nch; ++ch) {
      const bool fresh = pass == 0 || nch > 1;  // S holds the chunk's raw sums
      const int cn = pad16(min(WIDE_KEYS, Lk - ch * WIDE_KEYS));
      if (fresh) chunk_logits(ch);
      if (!active) continue;
      for (int r = 16 * warp; r < rend; ++r) {
        float* Sr = S + (size_t)r * ss;
        const bool qfr = PF && qf[q0 + r];
        if (pass == 0) {
          float m = -INFINITY;
          for (int j = lane; j < cn; j += 32) {
            const float x = wide_logit<C>(Sr[j], flags[j], qfr, scale);
            Sr[j] = x;
            m = fmaxf(m, x);
          }
          m = warp_max(m);  // finite: Lk >= 1 and a masked key is -1e9
          if (lane == 0) M[r] = ch == 0 ? m : fmaxf(M[r], m);
        } else {
          const float m = M[r];
          float l = ch == 0 ? 0.f : part[r * 32 + lane];
          for (int j = lane; j < cn; j += 32) {
            const float x = fresh ? wide_logit<C>(Sr[j], flags[j], qfr, scale) : Sr[j];
            const float e = exp_shifted<C>(x, m);
            Sr[j] = e;
            l += e;
          }
          part[r * 32 + lane] = l;
          if (ch == nch - 1) {
            l = warp_sum(l);
            if (C == Chain::PACKED) l = round_bf16(l);
            if (lane == 0) L[r] = l;
          }
        }
      }
      __syncwarp();  // M, L and the rows of S are read across the warp
    }
  }
  // pass 2: bf(p) and P . V for chunk c of the output
  float o[SLICE / 8][4];
  zero(o);
  for (int ch = 0; ch < nch; ++ch) {
    const bool fresh = nch > 1;
    const int k0 = ch * WIDE_KEYS, kn = min(WIDE_KEYS, Lk - k0), cn = pad16(kn);
    if (fresh) chunk_logits(ch);
    if (active) {
      for (int r = 16 * warp; r < rend; ++r) {
        float* Sr = S + (size_t)r * ss;
        const bool qfr = PF && qf[q0 + r];
        const float m = M[r], l = L[r], rl = __frcp_rn(l);
        for (int j = lane; j < cn; j += 32) {
          const float e =
              fresh ? exp_shifted<C>(wide_logit<C>(Sr[j], flags[j], qfr, scale), m) : Sr[j];
          Sr[j] = round_bf16(div_rn(e, l, rl));
        }
      }
      __syncwarp();
    }
    wide_pv(o, S, ss, 0, vh + (size_t)k0 * E, kn, E, Ks, warp, lane, active);
  }
  if (active)
    wide_store(o, out + ((size_t)b * Lq + q0) * E + h * hdp + c * SLICE, rows, E, Qs, warp,
               lane);
}

}  // namespace mma_attn
