// Short-key multi-head attention for Hopper (sm_90a): long video queries
// against a short text key sequence (Lk <= 64), with the factored pair mask
// optional.
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
//     That is the pair kernel's chain (attention_packed.cu's pair entry
//     point, _mha_kernel_packed_pair) with fewer keys and the pair factors
//     optional.
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
// Design of the bf16 short-key kernel (ONEMATMUL = false): the tensor-core
// body of attention_mma.cuh with the pair kernel's rounding chain
// (Chain::PAIR: unscaled bf16 q and k into mma.sync m16n8k16, the f32 sums
// times the f32 scale, an exact two-pass f32 softmax, p rounded to bf16,
// P . V on the tensor cores) on the grid of attention_grid.cuh, one block
// of 4 warps per (sample, 64-row query tile, head). K_h, V_h (padded to a
// multiple of 16 keys with zero rows, whose keys get probability 0) and a
// flag byte per key (valid, masked, past Lk, and KEY_PAIR where kf is set)
// are staged with cp.async; each warp holds 16 query rows and, up to 64
// keys, all their logits in 32 registers a thread (past 64 keys the body
// streams them). Without pair factors no key carries KEY_PAIR and no row
// flag is read (a compile-time instance). Operands on 16-byte boundaries,
// head_dim 16, 32, 64 or 128.
//
// Design of the bf16 one-matmul kernel (ONEMATMUL = true): one block per
// (sample, 64-row query tile) that handles every head, so that the row's
// maximum over all heads stays inside the block: 2 groups of 4 warps, each
// warp 16 query rows of every other head. In the mma.sync m16n8k16
// fragments a row's values sit in one quad of lanes: a warp's maximum is a
// running fmaxf in registers and two quad shuffles, and the two groups'
// meet through shared memory at one barrier. Every head's Q tile, the
// sample's K and V (all heads, padded to a multiple of 16 keys with zero
// rows), a flag byte per key and head (valid, masked, past Lk, and KEY_PAIR
// where kf is set) and the rows' pair flags are staged once (cp.async for
// the tiles) into the swizzled per-head tiles of attention_mma.cuh. A warp
// walks its heads twice: pass 1 computes each head's logits (qs = bf(q *
// bf(scale)) into the mma, f32 sums, the masks) and keeps only the running
// maximum; pass 2 recomputes them (the same instructions on the same
// operands: the same values), takes e = exp(l - gmax), the segment sum s_h
// (quad shuffles), p = bf(s_h > 0 ? e / s_h : 1/Lk) and that head's P . V
// on the tensor cores. Holding every head's logits at once would take 8
// heads x 32 keys, 128 f32 registers a thread; the recomputation costs a
// few mma a head at Lk <= 64. e / s_h is a true f32 division: s_h may sit
// far below 1, so both are scaled by the power of two that brings s_h into
// [1, 2) (exact) before div_rn. An empty segment takes 1/Lk on the Lk real
// keys and 0 on the padding. A head's logits stay in 32 registers between
// the sum and P . V, so it takes at most 64 keys, the short-key tier's.
// head_dim 16, 32, 64 or 128, operands on 16-byte boundaries.
//
// Design of the fp32 short-key kernel (ONEMATMUL = false): in float32 its
// function is the pair entry point's, with the pair factors optional, so it
// runs the 3xTF32 body of attention_fp32.cuh (the fp32 pair kernel's, with
// the pair flags a compile-time option) on the grid of attention_grid.cuh:
// one block of 4 warps per (sample, 64-row query tile, head), Q split once
// a block, the keys in tiles streamed and split once a block, products on
// mma.sync m16n8k8 in 3xTF32, an online f32 softmax a few ulps from the
// plain version's two-pass one. The key tile is sized to the short keys:
// one tile of 24 keys up to 24 keys (the charades and TACoS sites' 17), of
// 40 keys from 33 to 40 (QVH's 33), else tiles of 32; a single tile takes
// one buffer of shared memory. Tiles of 32 throughout took 5-8 % longer at
// 17 keys and 30 % at 33 (PERF.md section 6). At a wide head (above
// 128) the body's wide path. Any Lk.
//
// Design of the fp32 one-matmul kernel (ONEMATMUL = true, head_dim 16, 32,
// 64 or 128): one block per (sample, tile of query rows) over every head,
// so that the row's maximum over all heads stays in the block, with its
// products in 3xTF32 on mma.sync m16n8k8 (attention_tf32.cuh: each operand
// split hi + lo, lo . hi + hi . lo + hi . hi, short sums on the tensor cores
// added in f32). 8 warps in G groups (G the largest power of two up to
// min(H, 8)); group i takes heads i, i + G, ... of 16 * 8 / G rows, 16 a
// warp; the groups' maxima meet at one barrier. At the model's H = 8 that
// is one head a warp and 16 rows a block: the bf16 kernel's shape (64 rows,
// 2 groups, 4 heads a warp) took 1.1-1.4x its time at the TACoS and
// charades sites and 3x at QVH's 60 blocks (PERF.md section 6). The
// sample's K and V of every head
// are staged whole by cp.async (any Lk whose K and V fit in shared memory)
// and split at the fragment load: with one head a warp each value is split
// once a pass, and splitting them once a block in shared memory (twice the
// bytes) was no faster. K's rows are 16-byte chunks swizzled so that a
// quad's float4 loads of two key rows hit 32 banks; V's rows are padded to
// hd + 4 floats for the scalar loads of P . V. A warp reads its rows of q
// from device memory straight into its A fragments as float4 loads: the k
// index of a k step is permuted (lane t holds columns 4t .. 4t + 3 of each
// 16-column chunk: k index t the first or third, t + 4 the second or
// fourth) and K's fragments read the same permutation, so a dot product
// sums the same terms. qs = q * scale is rounded to f32 before the split.
// Pass 1 takes each head's logits in key groups of 64 (8 n8 tiles in
// registers), the masks and the running maximum; pass 2 takes e = exp(l -
// gmax), the segment sums s_h (quad shuffles), p = s_h > 0 ? e / s_h
// (correctly rounded, SegmentDivide) : 1/Lk on the real keys, and P . V on
// the tensor cores, its A fragment the C tile of the logits, split in
// registers. A warp of one head and up to 64 keys keeps its logits in
// registers across the barrier; otherwise pass 2 recomputes them with the
// same instructions (the same values), and past 64 keys walks a head's key
// groups twice (the sums, then P . V). The output goes to device memory
// from the C fragments. expf, not its fast variant: the subnormal e that
// decide s_h > 0 are kept.
//
// A head_dim above 128 (the wrapper pads it to 128 n): the bf16 short-key
// kernel takes the wide body of attention_mma.cuh (its pair chain; the
// logits in shared memory, the head in 128-column slices, one block per
// 128-column output chunk), and so does the bf16 one-matmul kernel, whose
// wide block holds every head's logits (attention_shortkey_onematmul_wide_
// kernel: the row's maximum over all of them, each head's segment softmax,
// P . V head by head). The fp32 one-matmul kernel keeps a CUDA-core kernel
// there (attention_shortkey_onematmul_fp32_wide_kernel): a warp a query
// row, every head's logits in shared memory, K and V read from device
// memory (L2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_fp32.cuh"
#include "attention_grid.cuh"
#include "attention_mma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// ---------------------------------------------------------------------------
// the bf16 short-key kernel on the tensor-core body
// ---------------------------------------------------------------------------

// keys whose logits stay in registers: every key of the short-key sites
constexpr int SHORT_KEYS = 64;

// scale: the f32 softmax scale; qf (B, H, Lq) and kf (B, H, Lk) the pair
// factors as uint8 (PAIR), or unused. RESIDENT: pad16(Lk) <= SHORT_KEYS (at
// a wide head: mma_attn::one_chunk(Lk))
template <int HD, bool RESIDENT, bool PAIR>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_shortkey_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                              bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale,
                              const uint8_t* __restrict__ qf, const uint8_t* __restrict__ kf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  const size_t bh = (size_t)b * H + h;
  if constexpr (HD == attn_grid::WIDE) {
    if constexpr (PAIR)
      mma_attn::block_attend_wide<mma_attn::Chain::PAIR, true, RESIDENT>(
          q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0, blockIdx.y, smem, qf + bh * Lq,
          kf + bh * Lk);
    else
      mma_attn::block_attend_wide<mma_attn::Chain::PAIR, false, RESIDENT>(
          q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0, blockIdx.y, smem);
  } else if constexpr (PAIR) {
    mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, SHORT_KEYS>(
        q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem, qf + bh * Lq, kf + bh * Lk);
  } else {
    mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, SHORT_KEYS, false>(
        q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem);
  }
}

template <int HD, bool PAIR>
int launch_mma(const void* q, const void* k, const void* v, const void* mask, const void* qf,
               const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
               cudaStream_t s) {
  auto kernel = attention_shortkey_mma_kernel<HD, false, PAIR>;
  size_t smem = 0;
  if constexpr (HD == attn_grid::WIDE) {
    smem = mma_attn::WideSmem::block(Lk);
    if (mma_attn::one_chunk(Lk)) kernel = attention_shortkey_mma_kernel<HD, true, PAIR>;
  } else {
    smem = mma_attn::Smem<HD>::bytes(Lk);
    if (mma_attn::pad16(Lk) <= SHORT_KEYS) kernel = attention_shortkey_mma_kernel<HD, true, PAIR>;
  }
  return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS, smem, q, k, v, mask,
                                                 out, B, H, Lq, Lk, E, scale, s,
                                                 static_cast<const uint8_t*>(qf),
                                                 static_cast<const uint8_t*>(kf));
}

template <int HD>
int dispatch_mma(const void* q, const void* k, const void* v, const void* mask, const void* qf,
                 const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
                 cudaStream_t s) {
  if (qf != nullptr)
    return launch_mma<HD, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  return launch_mma<HD, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
}

// ---------------------------------------------------------------------------
// the bf16 one-matmul kernel on the tensor-core tiles
// ---------------------------------------------------------------------------

// The one-matmul kernel's block: ONEMATMUL_GROUPS groups of 4 warps, each
// group every ONEMATMUL_GROUPS-th head of the same 64 query rows (16 rows a
// warp). At charades two groups were faster than one (a block's 64 KB of
// staged tiles leave 3 blocks an SM) and than four (fewer blocks fit).
constexpr int ONEMATMUL_GROUPS = 2;
constexpr int ONEMATMUL_THREADS = 32 * mma_attn::WARPS * ONEMATMUL_GROUPS;
// the most keys the kernel takes: a warp keeps a head's logits of every key
// in registers (the short-key tier's keys, kernels.SHORTKEY_MAX_LK)
constexpr int ONEMATMUL_KEYS = 64;

// Dynamic shared memory of a block: every head's Q tile (ROWS x hd), K and
// V (kpad x hd each), kpad key flag bytes a head, each group's row maxima,
// then ROWS row pair flags a head.
template <int HD>
struct OneMatmulSmem {
  __host__ __device__ static size_t kv(int H, int Lk) {  // the offset of the flags
    const size_t kp = (size_t)mma_attn::pad16(Lk);
    return ((size_t)mma_attn::ROWS + 2 * kp) * H * HD * sizeof(bf16);
  }
  __host__ __device__ static size_t maxima(int H, int Lk) {
    return align16(kv(H, Lk) + (size_t)mma_attn::pad16(Lk) * H);
  }
  __host__ __device__ static size_t rowflags(int H, int Lk) {
    return maxima(H, Lk) + (size_t)ONEMATMUL_GROUPS * mma_attn::ROWS * sizeof(float);
  }
  __host__ __device__ static size_t bytes(int H, int Lk) {
    return rowflags(H, Lk) + (size_t)H * mma_attn::ROWS;
  }
};

// The (row, 16-byte chunk) pairs of a (rows_pad, rc chunks) block that
// thread `tid` of `threads` takes, in steps of `threads` pairs: one
// division up front, none in the walk.
struct ChunkWalk {
  int r, x, dr, dx, rc;
  __device__ __forceinline__ ChunkWalk(int tid, int threads, int chunks)
      : r(tid / chunks), x(tid % chunks), dr(threads / chunks), dx(threads % chunks),
        rc(chunks) {}
  __device__ __forceinline__ void next() {
    r += dr;
    x += dx;
    if (x >= rc) {
      x -= rc;
      ++r;
    }
  }
};

// Stage `rows` rows of (rows, E = H * HD) bf16 (row stride E in device
// memory) into H swizzled tiles of rows_pad x HD, head h's at
// dst + h * rows_pad * HD, zeros past `rows`: consecutive threads copy
// consecutive 16-byte chunks of a row.
template <int HD>
__device__ __forceinline__ void stage_heads(bf16* dst, const bf16* __restrict__ src, int rows,
                                            int rows_pad, int H, int E) {
  constexpr int CH = HD / 8;
  for (ChunkWalk w(threadIdx.x, ONEMATMUL_THREADS, H * CH); w.r < rows_pad; w.next()) {
    bf16* d = dst + (size_t)(w.x / CH) * rows_pad * HD + mma_attn::swz<HD>(w.r, w.x % CH);
    if (w.r < rows)
      mma_attn::cp_async16(d, src + (size_t)w.r * E + 8 * w.x);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// e -> e / s correctly rounded, for 0 <= e <= s and 0 < s <= Lk: a head's
// segment sum may sit far below 1 (its keys below another head's maximum),
// so e and s are scaled exactly by the powers of two that bring s into
// [1, 2) before div_rn (no reciprocal of a tiny s overflows, and no
// division takes the operator's slow path).
struct SegmentDivide {
  float pre, mul, l, r;
  __device__ __forceinline__ explicit SegmentDivide(float s) {
    pre = s < 1.17549435e-38f ? 0x1p64f : 1.f;  // a subnormal sum: normal first
    const float s1 = s * pre;
    const int ex = (__float_as_int(s1) >> 23) & 0xff;
    mul = __int_as_float((254 - ex) << 23);  // 2^(127 - ex): s1 * mul in [1, 2)
    l = s1 * mul;
    r = __frcp_rn(l);
  }
  __device__ __forceinline__ float operator()(float e) const {
    return mma_attn::div_rn(e * pre * mul, l, r);
  }
};

// The A fragments of head h's Q rows for the warp, scaled: qs = bf(q * scale)
// with the scale already bf16 (a product in bf16, as the plain version's).
template <int HD>
__device__ __forceinline__ void scaled_q(uint32_t (&qa)[HD / 16][4], const bf16* Qw, int lane,
                                         float scale) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    mma_attn::ldmatrix_x4(qa[ks], Qw + mma_attn::swz<HD>(lane & 15, 2 * ks + (lane >> 4)));
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[ks][i] = mma_attn::scale_bf16x2(qa[ks][i], scale);
  }
}

// scale: the softmax scale rounded to bf16; qf (B, H, Lq) and kf (B, H, Lk)
// the pair factors as uint8 (PAIR), or unused. One block per (sample, ROWS
// query rows), every head; pad16(Lk) <= ONEMATMUL_KEYS.
template <int HD, bool PAIR>
__global__ void __launch_bounds__(ONEMATMUL_THREADS)
attention_shortkey_onematmul_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                                        int H, int Lq, int Lk, int E, float scale,
                                        const uint8_t* __restrict__ qf,
                                        const uint8_t* __restrict__ kf) {
  using mma_attn::swz;
  constexpr int NT = ONEMATMUL_KEYS / 8;  // n8 key tiles
  constexpr int QROWS = mma_attn::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = mma_attn::pad16(Lk);
  const int tiles = (Lq + QROWS - 1) / QROWS;
  const int b = blockIdx.x / tiles, q0 = blockIdx.x % tiles * QROWS;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + (size_t)H * QROWS * HD;
  bf16* Vs = Ks + (size_t)H * kpad * HD;
  uint8_t* flags = smem + OneMatmulSmem<HD>::kv(H, Lk);
  float* maxima = reinterpret_cast<float*>(smem + OneMatmulSmem<HD>::maxima(H, Lk));
  uint8_t* rowflags = smem + OneMatmulSmem<HD>::rowflags(H, Lk);

  const int rows = min(QROWS, Lq - q0);
  stage_heads<HD>(Qs, q + ((size_t)b * Lq + q0) * E, rows, QROWS, H, E);
  stage_heads<HD>(Ks, k + (size_t)b * Lk * E, Lk, kpad, H, E);
  stage_heads<HD>(Vs, v + (size_t)b * Lk * E, Lk, kpad, H, E);
  for (int i = threadIdx.x; i < H * kpad; i += ONEMATMUL_THREADS) {
    const int h = i / kpad, j = i - h * kpad;
    uint8_t f = 2;
    if (j < Lk) {
      f = mask[(size_t)b * Lk + j] ? 1 : 0;
      if (PAIR && kf[((size_t)b * H + h) * Lk + j]) f |= mma_attn::KEY_PAIR;
    }
    flags[i] = f;
  }
  if (PAIR)
    for (int i = threadIdx.x; i < H * QROWS; i += ONEMATMUL_THREADS) {
      const int h = i / QROWS, r = i % QROWS;
      rowflags[i] = r < rows && qf[((size_t)b * H + h) * Lq + q0 + r];
    }
  mma_attn::cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % mma_attn::WARPS, group = warp / mma_attn::WARPS;
  const int r0 = q0 + 16 * rw;
  const bool active = r0 < Lq;  // a warp past Lq still meets the barriers
  const int g = lane >> 2, t = lane & 3;
  // the pair flags of the thread's rows g and g + 8 in head h
  auto row_flags = [&](int h, bool& qf0, bool& qf1) {
    qf0 = PAIR && rowflags[h * QROWS + 16 * rw + g];
    qf1 = PAIR && rowflags[h * QROWS + 16 * rw + g + 8];
  };
  uint32_t qa[HD / 16][4];
  float s[NT][4];
  bool qf0, qf1;

  // pass 1: the maximum of rows g and g + 8 over the group's heads' logits
  // (the masks as the pair chain's, with the scale already in qs), then
  // over every group's
  float m0 = -INFINITY, m1 = -INFINITY;
  if (active) {
    for (int h = group; h < H; h += ONEMATMUL_GROUPS) {
      const bf16* Kh = Ks + (size_t)h * kpad * HD;
      scaled_q<HD>(qa, Qs + ((size_t)h * QROWS + 16 * rw) * HD, lane, scale);
      row_flags(h, qf0, qf1);
      mma_attn::logits<HD, NT, mma_attn::Chain::PAIR>(s, qa, Kh, flags + h * kpad, 0, kpad, lane,
                                                      1.f, qf0, qf1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    m0 = mma_attn::quad_max(m0);
    m1 = mma_attn::quad_max(m1);
    if (t == 0) {
      maxima[group * QROWS + 16 * rw + g] = m0;
      maxima[group * QROWS + 16 * rw + g + 8] = m1;
    }
  }
  __syncthreads();
  if (active) {
    m0 = m1 = -INFINITY;
#pragma unroll
    for (int gi = 0; gi < ONEMATMUL_GROUPS; ++gi) {
      m0 = fmaxf(m0, maxima[gi * QROWS + 16 * rw + g]);
      m1 = fmaxf(m1, maxima[gi * QROWS + 16 * rw + g + 8]);
    }  // finite: Lk >= 1 and a masked key is -1e9

    // pass 2, head by head: the segment softmax and P . V
    const float uniform = mma_attn::round_bf16(__fdiv_rn(1.f, (float)Lk));
    for (int h = group; h < H; h += ONEMATMUL_GROUPS) {
      const bf16* Kh = Ks + (size_t)h * kpad * HD;
      const bf16* Vh = Vs + (size_t)h * kpad * HD;
      const uint8_t* fh = flags + h * kpad;
      bf16* Qw = Qs + ((size_t)h * QROWS + 16 * rw) * HD;
      scaled_q<HD>(qa, Qw, lane, scale);
      row_flags(h, qf0, qf1);
      mma_attn::logits<HD, NT, mma_attn::Chain::PAIR>(s, qa, Kh, fh, 0, kpad, lane, 1.f, qf0, qf1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (8 * nt >= kpad) break;
        s[nt][0] = expf(s[nt][0] - m0);
        s[nt][1] = expf(s[nt][1] - m0);
        s[nt][2] = expf(s[nt][2] - m1);
        s[nt][3] = expf(s[nt][3] - m1);
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
      l0 = mma_attn::quad_sum(l0);
      l1 = mma_attn::quad_sum(l1);
      // an empty segment (every e underflowed): 1/Lk on each real key
      const bool empty0 = !(l0 > 0.f), empty1 = !(l1 > 0.f);
      const SegmentDivide div0(l0), div1(l1);
      auto prob = [&](float e, bool row1, int key) {
        if (row1 ? empty1 : empty0) return key < Lk ? uniform : 0.f;
        return row1 ? div1(e) : div0(e);
      };

      float o[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int k0 = 16 * j;
        if (k0 >= kpad) break;
        const int ka = k0 + 2 * t, kb = k0 + 8 + 2 * t;  // the keys of the two n8 tiles
        const uint32_t pa[4] = {
            mma_attn::pack_bf16(prob(s[2 * j][0], false, ka), prob(s[2 * j][1], false, ka + 1)),
            mma_attn::pack_bf16(prob(s[2 * j][2], true, ka), prob(s[2 * j][3], true, ka + 1)),
            mma_attn::pack_bf16(prob(s[2 * j + 1][0], false, kb),
                                prob(s[2 * j + 1][1], false, kb + 1)),
            mma_attn::pack_bf16(prob(s[2 * j + 1][2], true, kb),
                                prob(s[2 * j + 1][3], true, kb + 1))};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];  // keys k0 .. k0 + 15 of d chunks 2dp, 2dp + 1
          mma_attn::ldmatrix_x4_trans(vb, Vh + swz<HD>(k0 + (lane & 7) + (lane & 8),
                                                       2 * dp + (lane >> 4)));
          mma_attn::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_attn::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
      // out_h = bf(o), into the warp's (read) Q rows of head h
      __syncwarp();
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(Qw + swz<HD>(g, dt) + 2 * t) =
            mma_attn::pack_bf16(o[dt][0], o[dt][1]);
        *reinterpret_cast<uint32_t*>(Qw + swz<HD>(g + 8, dt) + 2 * t) =
            mma_attn::pack_bf16(o[dt][2], o[dt][3]);
      }
    }
  }
  // every head's output rows, 16-byte stores along each row
  __syncthreads();
  constexpr int CH = HD / 8;
  for (ChunkWalk w(threadIdx.x, ONEMATMUL_THREADS, H * CH); w.r < rows; w.next())
    *reinterpret_cast<uint4*>(out + ((size_t)b * Lq + q0 + w.r) * E + 8 * w.x) =
        *reinterpret_cast<const uint4*>(Qs + (size_t)(w.x / CH) * QROWS * HD +
                                        swz<HD>(w.r, w.x % CH));
}

template <int HD, bool PAIR>
int launch_onematmul_mma(const void* q, const void* k, const void* v, const void* mask,
                         const void* qf, const void* kf, void* out, int B, int H, int Lq, int Lk,
                         int E, float scale, cudaStream_t s) {
  const size_t smem = OneMatmulSmem<HD>::bytes(H, Lk);
  const auto kernel = attention_shortkey_onematmul_mma_kernel<HD, PAIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((Lq + mma_attn::ROWS - 1) / mma_attn::ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, ONEMATMUL_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), H, Lq, Lk, E, scale,
      static_cast<const uint8_t*>(qf), static_cast<const uint8_t*>(kf));
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_onematmul_mma(const void* q, const void* k, const void* v, const void* mask,
                           const void* qf, const void* kf, void* out, int B, int H, int Lq,
                           int Lk, int E, float scale, cudaStream_t s) {
  if (qf != nullptr)
    return launch_onematmul_mma<HD, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  return launch_onematmul_mma<HD, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
}

// ---------------------------------------------------------------------------
// the bf16 one-matmul kernel at a wide head
// ---------------------------------------------------------------------------

// Dynamic shared memory of a wide one-matmul block: the wide body's, its
// rows holding every head's logits, and ROWS row pair flags a head.
__host__ __device__ inline size_t onematmul_wide_cols(int H, int Lk) {
  return (size_t)H * mma_attn::pad16(Lk);
}
inline size_t onematmul_wide_smem(int H, int Lk) {
  return mma_attn::WideSmem::bytes((int)onematmul_wide_cols(H, Lk), (size_t)H * mma_attn::ROWS);
}

// One block of 4 warps per (sample, 64 query rows, output chunk c of 128
// columns: grid dimension y), every head: each head's logits go to its own
// columns of the wide body's logits in shared memory (qs = bf(q *
// bf(scale)) into the mma, f32 sums over the 128-column slices), then each
// row takes the maximum over all heads' logits, each head's segment softmax
// (SegmentDivide; 1/Lk on the real keys of an empty segment) and, head by
// head, P . V for chunk c. scale: the softmax scale rounded to bf16; qf, kf
// as the kernel above's. pad16(Lk) <= ONEMATMUL_KEYS.
template <bool PAIR>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_shortkey_onematmul_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                                         int H, int Lq, int Lk, int E, float scale,
                                         const uint8_t* __restrict__ qf,
                                         const uint8_t* __restrict__ kf) {
  constexpr int QROWS = mma_attn::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = mma_attn::pad16(Lk), cols = (int)onematmul_wide_cols(H, Lk), ss = cols + 4;
  const int hdp = E / H, c = blockIdx.y;
  const int tiles = (Lq + QROWS - 1) / QROWS;
  const int b = blockIdx.x / tiles, q0 = blockIdx.x % tiles * QROWS;
  float* S = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(S + (size_t)QROWS * ss);
  bf16* Ks = Qs + QROWS * mma_attn::SLICE;
  uint8_t* flags = reinterpret_cast<uint8_t*>(Ks + mma_attn::PIECE * mma_attn::SLICE);
  uint8_t* rowflags = flags + cols;

  const int rows = min(QROWS, Lq - q0);
  for (int i = threadIdx.x; i < cols; i += mma_attn::THREADS) {
    const int h = i / kpad, j = i - h * kpad;
    uint8_t f = 2;
    if (j < Lk) {
      f = mask[(size_t)b * Lk + j] ? 1 : 0;
      if (PAIR && kf[((size_t)b * H + h) * Lk + j]) f |= mma_attn::KEY_PAIR;
    }
    flags[i] = f;
  }
  for (int i = threadIdx.x; i < H * QROWS; i += mma_attn::THREADS) {
    const int h = i / QROWS, r = i % QROWS;
    rowflags[i] = PAIR && r < rows && qf[((size_t)b * H + h) * Lq + q0 + r];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = 16 * warp < rows;  // a warp past Lq still meets the barriers
  for (int h = 0; h < H; ++h)
    mma_attn::wide_logits(S, ss, h * kpad, q + ((size_t)b * Lq + q0) * E + h * hdp, rows,
                          k + (size_t)b * Lk * E + h * hdp, Lk, E, hdp / mma_attn::SLICE, true,
                          scale, Qs, Ks, warp, lane, active);
  if (active) {
    const float uniform = mma_attn::round_bf16(__fdiv_rn(1.f, (float)Lk));
    for (int r = 16 * warp; r < min(16 * warp + 16, rows); ++r) {
      float* Sr = S + (size_t)r * ss;
      // the masks as the pair chain's (the scale already in qs), the
      // maximum over every head's logits
      float m = -INFINITY;
      for (int i = lane; i < cols; i += 32) {
        const float x = mma_attn::pair_logit(Sr[i], flags[i], rowflags[i / kpad * QROWS + r], 1.f);
        Sr[i] = x;
        m = fmaxf(m, x);
      }
      m = mma_attn::warp_max(m);  // finite: Lk >= 1 and a masked key is -1e9
      for (int h = 0; h < H; ++h) {
        float* Sh = Sr + h * kpad;
        float l = 0.f;
        for (int j = lane; j < kpad; j += 32) {
          const float e = expf(Sh[j] - m);
          Sh[j] = e;
          l += e;
        }
        l = mma_attn::warp_sum(l);
        const bool empty = !(l > 0.f);  // every e underflowed: 1/Lk on each real key
        const SegmentDivide div(l);
        for (int j = lane; j < kpad; j += 32)
          Sh[j] = mma_attn::round_bf16(empty ? (j < Lk ? uniform : 0.f) : div(Sh[j]));
      }
    }
    __syncwarp();
  }
  for (int h = 0; h < H; ++h) {
    float o[mma_attn::SLICE / 8][4];
    mma_attn::zero(o);
    mma_attn::wide_pv(o, S, ss, h * kpad, v + (size_t)b * Lk * E + h * hdp + c * mma_attn::SLICE,
                      Lk, E, Ks, warp, lane, active);
    if (active)
      mma_attn::wide_store(o, out + ((size_t)b * Lq + q0) * E + h * hdp + c * mma_attn::SLICE,
                           rows, E, Qs, warp, lane);
  }
}

template <bool PAIR>
int launch_onematmul_wide(const void* q, const void* k, const void* v, const void* mask,
                          const void* qf, const void* kf, void* out, int B, int H, int Lq, int Lk,
                          int E, float scale, cudaStream_t s) {
  const size_t smem = onematmul_wide_smem(H, Lk);
  const auto kernel = attention_shortkey_onematmul_wide_kernel<PAIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((Lq + mma_attn::ROWS - 1) / mma_attn::ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)attn_grid::chunks(E / H));
  kernel<<<grid, mma_attn::THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), H, Lq, Lk, E, scale,
      static_cast<const uint8_t*>(qf), static_cast<const uint8_t*>(kf));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the fp32 short-key kernel on the 3xTF32 body
// ---------------------------------------------------------------------------

// Its key tile by Lk: one tile of 24 keys (up to 24), of 40 (33 to 40),
// else tiles of 32 (attention_fp32.cuh's). f(HeadDim<KN>{}) for that tile.
template <typename F>
auto by_key_tile(int Lk, F&& f) {
  if (Lk <= 24) return f(attn_grid::HeadDim<24>{});
  if (Lk > 32 && Lk <= 40) return f(attn_grid::HeadDim<40>{});
  return f(attn_grid::HeadDim<fp32_attn::KT>{});
}

template <int HD>
size_t shortkey_3xtf32_smem(int Lk) {
  if constexpr (HD == attn_grid::WIDE)
    return fp32_attn::WideSmem::bytes;
  else
    return by_key_tile(Lk, [&](auto c) {
      return fp32_attn::Smem<HD, decltype(c)::value>::bytes_for(Lk);
    });
}

// scale: the f32 softmax scale; qf (B, H, Lq) and kf (B, H, Lk) the pair
// factors as uint8 (PAIR), or unused
template <int HD, bool PAIR, int KN>
__global__ void __launch_bounds__(fp32_attn::THREADS, fp32_attn::min_blocks<HD>())
attention_shortkey_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                                 float* __restrict__ out, int H, int Lq, int Lk, int E,
                                 float scale, const uint8_t* __restrict__ qf,
                                 const uint8_t* __restrict__ kf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<fp32_attn::ROWS>(H, Lq, b, h, q0);
  const size_t bh = (size_t)b * H + h;
  const uint8_t* qfh = PAIR ? qf + bh * Lq : nullptr;
  const uint8_t* kfh = PAIR ? kf + bh * Lk : nullptr;
  if constexpr (HD == attn_grid::WIDE)
    fp32_attn::block_attend_wide<PAIR>(q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0,
                                       blockIdx.y, smem, qfh, kfh);
  else
    fp32_attn::block_attend<HD, PAIR, KN>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem,
                                          qfh, kfh);
}

template <int HD, bool PAIR>
int launch_3xtf32(const void* q, const void* k, const void* v, const void* mask, const void* qf,
                  const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
                  cudaStream_t s) {
  auto go = [&](auto kernel) {
    return attn_grid::launch<float, fp32_attn::ROWS>(
        kernel, fp32_attn::THREADS, shortkey_3xtf32_smem<HD>(Lk), q, k, v, mask, out, B, H, Lq,
        Lk, E, scale, s, static_cast<const uint8_t*>(qf), static_cast<const uint8_t*>(kf));
  };
  if constexpr (HD == attn_grid::WIDE)
    return go(attention_shortkey_3xtf32_kernel<HD, PAIR, fp32_attn::KT>);
  else
    return by_key_tile(
        Lk, [&](auto c) { return go(attention_shortkey_3xtf32_kernel<HD, PAIR, decltype(c)::value>); });
}

// ---------------------------------------------------------------------------
// the fp32 one-matmul kernel on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

// keys a warp holds the logits of at once: a key group of 8 n8 tiles
constexpr int KEY_GROUP = 64;
constexpr int GROUP_NT = KEY_GROUP / 8;
// A block of 8 warps: G groups of 8 / G warps, G the largest power of two
// up to min(H, 8); group i takes heads i, i + G, ... of the block's 16 * 8 /
// G query rows, 16 rows a warp. At H = 8 (E = 256, head_dim 32) a warp
// holds one head of 16 rows.
constexpr int OM32_WARPS = 8, OM32_THREADS = 32 * OM32_WARPS;
__host__ __device__ inline int om32_groups(int H) { return H >= 8 ? 8 : H >= 4 ? 4 : H >= 2 ? 2 : 1; }
__host__ __device__ inline int om32_rows(int H) { return 16 * OM32_WARPS / om32_groups(H); }

// V's row stride: hd + 4 floats (the P . V loads of keys 2t, 2t + 1 and
// column g hit 32 banks)
template <int HD>
constexpr int VS = HD + 4;

// K row j's 16-byte chunk x: swizzled at a head_dim of 32 or more (odd
// rows' chunks in the other half of each 8-chunk span), so that the float4
// loads of key rows g (even, odd) and chunks 4c + t of one phase of 8 lanes
// hit 32 banks; at hd 16 the rows' 64-byte stride does that already
template <int HD>
__device__ __forceinline__ int kchunk(int j, int x) {
  return HD >= 32 ? x ^ ((j & 1) << 2) : x;
}

// Dynamic shared memory of a block: K (H tiles of Lk rows of HD floats,
// swizzled), V (H tiles of Lk rows of VS<HD>), the groups' row maxima (16
// * OM32_WARPS floats), the key flags (H x Lk bytes: 1 valid, 0 masked,
// KEY_PAIR where kf is set).
template <int HD>
struct OneMatmul32Smem {
  __host__ __device__ static size_t k_words(int H, int Lk) { return (size_t)H * Lk * HD; }
  __host__ __device__ static size_t maxima(int H, int Lk) {
    return (k_words(H, Lk) + (size_t)H * Lk * VS<HD>) * 4;
  }
  __host__ __device__ static size_t flags(int H, int Lk) {
    return maxima(H, Lk) + (size_t)16 * OM32_WARPS * 4;
  }
  __host__ __device__ static size_t bytes(int H, int Lk) {
    return align16(flags(H, Lk) + (size_t)H * Lk);
  }
};

// c += a . b in 3xTF32 (lo . hi, hi . lo, hi . hi), b's two values split
// into (bh, bl)
__device__ __forceinline__ void mma3_split(float (&c)[4], const tf32x3::SplitA& a, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  tf32x3::mma_tf32(c, a.lo, bh0, bh1);
  tf32x3::mma_tf32(c, a.hi, bl0, bl1);
  tf32x3::mma_tf32(c, a.hi, bh0, bh1);
}

// scale: the f32 softmax scale (already rounded to f32); qf (B, H, Lq) and
// kf (B, H, Lk) the pair factors as uint8 (PAIR), or unused. One block per
// (sample, om32_rows(H) query rows), every head.
template <int HD, bool PAIR>
__global__ void __launch_bounds__(OM32_THREADS)
attention_shortkey_onematmul_3xtf32_kernel(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const uint8_t* __restrict__ mask,
                                           float* __restrict__ out, int H, int Lq, int Lk, int E,
                                           float scale, const uint8_t* __restrict__ qf,
                                           const uint8_t* __restrict__ kf) {
  using Smem = OneMatmul32Smem<HD>;
  using tf32x3::SplitA;
  constexpr int C4 = HD / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = om32_groups(H), RW = OM32_WARPS / G, QROWS = 16 * RW;
  const int tiles = (Lq + QROWS - 1) / QROWS;
  const int b = blockIdx.x / tiles, q0 = blockIdx.x % tiles * QROWS;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + Smem::k_words(H, Lk);
  float* maxima = reinterpret_cast<float*>(smem + Smem::maxima(H, Lk));
  uint8_t* flags = smem + Smem::flags(H, Lk);

  // stage every head's K and V rows (consecutive threads: consecutive
  // 16-byte chunks of a row) and the key flags
  const float* kb = k + (size_t)b * Lk * E;
  const float* vb = v + (size_t)b * Lk * E;
  for (ChunkWalk w(threadIdx.x, OM32_THREADS, H * C4); w.r < Lk; w.next()) {
    const int h = w.x / C4, x = w.x % C4;
    tf32x3::cp_async16(Ks + ((size_t)h * Lk + w.r) * HD + 4 * kchunk<HD>(w.r, x),
                       kb + (size_t)w.r * E + 4 * w.x);
    tf32x3::cp_async16(Vs + ((size_t)h * Lk + w.r) * VS<HD> + 4 * x,
                       vb + (size_t)w.r * E + 4 * w.x);
  }
  tf32x3::cp_async_commit();
  for (int i = threadIdx.x; i < H * Lk; i += OM32_THREADS) {
    const int h = i / Lk, j = i - h * Lk;
    uint8_t f = mask[(size_t)b * Lk + j] ? 1 : 0;
    if (PAIR && kf[((size_t)b * H + h) * Lk + j]) f |= fp32_attn::KEY_PAIR;
    flags[i] = f;
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % RW, group = warp / RW;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * rw + g, r1 = r0 + 8;
  const bool active = q0 + 16 * rw < Lq;  // a warp past Lq still meets the barrier
  // the rows read: a row past Lq reads row Lq - 1 and stores nothing
  const float* q0p = q + ((size_t)b * Lq + min(r0, Lq - 1)) * E + 4 * t;
  const float* q1p = q + ((size_t)b * Lq + min(r1, Lq - 1)) * E + 4 * t;
  // a warp of one head and one key group keeps its logits from pass 1 to
  // pass 2 (at H = 8 and up to 64 keys, every warp); else pass 2 recomputes
  // them
  const bool kept = group + G >= H && Lk <= KEY_GROUP;

  // s = qs . K_h^T for keys k0 .. k0 + 63 (n8 tile nt: row g keys k0 + 8 nt
  // + 2t and + 1, row g + 8 the same), the masks applied: -1e9 masked or
  // both pair flags set, -inf past Lk. The values K and the A fragments
  // carry are split at the load (each value of a block's K and V once a
  // pass when a warp holds one head).
  float s[GROUP_NT][4];
  auto logits = [&](int h, int k0, bool qf0, bool qf1) {
#pragma unroll
    for (int nt = 0; nt < GROUP_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    const float* Kh = Ks + (size_t)h * Lk * HD;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(q0p + h * HD + 16 * c);
      const float4 x1 = *reinterpret_cast<const float4*>(q1p + h * HD + 16 * c);
      // k step 2c: k index t = column 16c + 4t, t + 4 = 16c + 4t + 1; step
      // 2c + 1: + 2 and + 3
      const SplitA a0(__fmul_rn(x0.x, scale), __fmul_rn(x1.x, scale), __fmul_rn(x0.y, scale),
                      __fmul_rn(x1.y, scale));
      const SplitA a1(__fmul_rn(x0.z, scale), __fmul_rn(x1.z, scale), __fmul_rn(x0.w, scale),
                      __fmul_rn(x1.w, scale));
#pragma unroll
      for (int nt = 0; nt < GROUP_NT; ++nt) {
        if (k0 + 8 * nt >= Lk) break;
        const int j = min(k0 + 8 * nt + g, Lk - 1);  // a key past Lk reads key Lk - 1, masked
        const float4 xk =
            *reinterpret_cast<const float4*>(Kh + (size_t)j * HD + 4 * kchunk<HD>(j, 4 * c + t));
        uint32_t bh[4], bl[4];
        tf32x3::split(xk.x, bh[0], bl[0]);
        tf32x3::split(xk.y, bh[1], bl[1]);
        tf32x3::split(xk.z, bh[2], bl[2]);
        tf32x3::split(xk.w, bh[3], bl[3]);
        mma3_split(s[nt], a0, bh[0], bh[1], bl[0], bl[1]);
        mma3_split(s[nt], a1, bh[2], bh[3], bl[2], bl[3]);
      }
    }
    const uint8_t* fh = flags + (size_t)h * Lk;
#pragma unroll
    for (int nt = 0; nt < GROUP_NT; ++nt) {
      if (k0 + 8 * nt >= Lk) break;
      const int j = k0 + 8 * nt + 2 * t;
      const uint8_t f0 = j < Lk ? fh[j] : 2, f1 = j + 1 < Lk ? fh[j + 1] : 2;
      s[nt][0] = fp32_attn::masked(s[nt][0], f0, qf0);
      s[nt][1] = fp32_attn::masked(s[nt][1], f1, qf0);
      s[nt][2] = fp32_attn::masked(s[nt][2], f0, qf1);
      s[nt][3] = fp32_attn::masked(s[nt][3], f1, qf1);
    }
  };
  // the pair flags of the thread's rows in head h
  auto row_flags = [&](int h, bool& qf0, bool& qf1) {
    qf0 = qf1 = false;
    if constexpr (PAIR) {
      const uint8_t* qfh = qf + ((size_t)b * H + h) * Lq;
      qf0 = r0 < Lq && qfh[r0];
      qf1 = r1 < Lq && qfh[r1];
    }
  };

  // pass 1: the maximum of rows g and g + 8 over the group's heads' logits,
  // then over every group's
  float m0 = -INFINITY, m1 = -INFINITY;
  bool qf0, qf1;
  if (active) {
    for (int h = group; h < H; h += G) {
      row_flags(h, qf0, qf1);
      for (int k0 = 0; k0 < Lk; k0 += KEY_GROUP) {
        logits(h, k0, qf0, qf1);
#pragma unroll
        for (int nt = 0; nt < GROUP_NT; ++nt) {
          if (k0 + 8 * nt >= Lk) break;
          m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
          m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
        }
      }
    }
    m0 = tf32x3::quad_max(m0);
    m1 = tf32x3::quad_max(m1);
    if (t == 0) {
      maxima[group * QROWS + 16 * rw + g] = m0;
      maxima[group * QROWS + 16 * rw + g + 8] = m1;
    }
  }
  __syncthreads();
  if (!active) return;
  m0 = m1 = -INFINITY;
  for (int gi = 0; gi < G; ++gi) {
    m0 = fmaxf(m0, maxima[gi * QROWS + 16 * rw + g]);
    m1 = fmaxf(m1, maxima[gi * QROWS + 16 * rw + g + 8]);
  }  // finite: Lk >= 1 and a masked key is -1e9

  // pass 2, head by head: e, the segment sums, p and P . V
  const int groups = (Lk + KEY_GROUP - 1) / KEY_GROUP;
  const float uniform = __fdiv_rn(1.f, (float)Lk);
  auto exps = [&](int h, int k0, float& l0, float& l1) {
    if (!kept) logits(h, k0, qf0, qf1);
#pragma unroll
    for (int nt = 0; nt < GROUP_NT; ++nt) {
      if (k0 + 8 * nt >= Lk) break;
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
  };
  for (int h = group; h < H; h += G) {
    row_flags(h, qf0, qf1);
    float l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < Lk; k0 += KEY_GROUP) exps(h, k0, l0, l1);
    l0 = tf32x3::quad_sum(l0);
    l1 = tf32x3::quad_sum(l1);
    // an empty segment (every e underflowed): 1/Lk on each real key
    const bool empty0 = !(l0 > 0.f), empty1 = !(l1 > 0.f);
    const SegmentDivide div0(l0), div1(l1);
    auto prob = [&](float e, bool row1, int key) {
      if (row1 ? empty1 : empty0) return key < Lk ? uniform : 0.f;
      return row1 ? div1(e) : div0(e);
    };
    const float* Vh = Vs + (size_t)h * Lk * VS<HD>;
    float o[HD / 8][4];
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
    for (int k0 = 0; k0 < Lk; k0 += KEY_GROUP) {
      if (groups > 1) {  // one group's e are still in s
        float x0 = 0.f, x1 = 0.f;
        exps(h, k0, x0, x1);
      }
      // this group's P . V, a partial sum from zero on the tensor cores
      float part[HD / 8][4];
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[nd][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < GROUP_NT; ++ks) {
        if (k0 + 8 * ks >= Lk) break;
        // the C tile of keys k0 + 8 ks as the A fragment: k index t is key
        // 2t, t + 4 key 2t + 1
        const int ka = k0 + 8 * ks + 2 * t;
        const SplitA pa(prob(s[ks][0], false, ka), prob(s[ks][2], true, ka),
                        prob(s[ks][1], false, ka + 1), prob(s[ks][3], true, ka + 1));
        // past Lk: key Lk - 1's row, whose p is 0
        const float* va = Vh + (size_t)min(ka, Lk - 1) * VS<HD> + g;
        const float* vb2 = Vh + (size_t)min(ka + 1, Lk - 1) * VS<HD> + g;
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          uint32_t bh0, bh1, bl0, bl1;
          tf32x3::split(va[8 * nd], bh0, bl0);
          tf32x3::split(vb2[8 * nd], bh1, bl1);
          mma3_split(part[nd], pa, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nd][i] += part[nd][i];
    }
    // out rows r0, r1 (those < Lq), columns 8 nd + 2t of head h
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const int col = h * HD + 8 * nd + 2 * t;
      if (r0 < Lq)
        *reinterpret_cast<float2*>(out + ((size_t)b * Lq + r0) * E + col) =
            make_float2(o[nd][0], o[nd][1]);
      if (r1 < Lq)
        *reinterpret_cast<float2*>(out + ((size_t)b * Lq + r1) * E + col) =
            make_float2(o[nd][2], o[nd][3]);
    }
  }
}

template <int HD, bool PAIR>
int launch_onematmul_3xtf32(const void* q, const void* k, const void* v, const void* mask,
                            const void* qf, const void* kf, void* out, int B, int H, int Lq,
                            int Lk, int E, float scale, cudaStream_t s) {
  const size_t smem = OneMatmul32Smem<HD>::bytes(H, Lk);
  const auto kernel = attention_shortkey_onematmul_3xtf32_kernel<HD, PAIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((Lq + om32_rows(H) - 1) / om32_rows(H));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, OM32_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Lq, Lk, E, scale,
      static_cast<const uint8_t*>(qf), static_cast<const uint8_t*>(kf));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the fp32 one-matmul kernel at a wide head, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int WIDE32_THREADS = 256;
constexpr int WIDE32_WARPS = WIDE32_THREADS / 32;
constexpr int WIDE32_ROWS = 16;  // query rows a block

// Dynamic shared memory of a block: the key mask and pair factors, each
// warp's scaled query row (E floats) and logits (H x Lk floats).
struct Wide32Smem {
  size_t mask, kf, qrow, lg, total;
  __host__ __device__ Wide32Smem(int H, int Lk, int E) {
    mask = 0;
    kf = align16(mask + (size_t)Lk);
    qrow = align16(kf + (size_t)H * Lk);
    lg = align16(qrow + (size_t)WIDE32_WARPS * E * 4);
    total = align16(lg + (size_t)WIDE32_WARPS * H * Lk * 4);
  }
};

// One block of 8 warps per (sample, 16 query rows); a warp a row: the row
// scaled (an f32 product) in shared memory, lanes split the keys of every
// head's logits (K read from device memory), the row's maximum over all
// heads, each head's segment softmax (1/Lk for an empty segment), P . V
// with lane c on columns c, c + 32, ... . scale: the f32 softmax scale.
template <bool PAIR>
__global__ void __launch_bounds__(WIDE32_THREADS)
attention_shortkey_onematmul_fp32_wide_kernel(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              const uint8_t* __restrict__ mask,
                                              float* __restrict__ out, int H, int Lq, int Lk,
                                              int E, float scale, const uint8_t* __restrict__ qf,
                                              const uint8_t* __restrict__ kf) {
  const Wide32Smem lay(H, Lk, E);
  const int hd = E / H;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * WIDE32_ROWS, q1 = min(q0 + WIDE32_ROWS, Lq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* kb = k + (size_t)b * Lk * E;
  const float* vb = v + (size_t)b * Lk * E;
  uint8_t* ms = smem + lay.mask;
  uint8_t* kfs = smem + lay.kf;
  float* qrow = reinterpret_cast<float*>(smem + lay.qrow) + (size_t)warp * E;
  float* lg = reinterpret_cast<float*>(smem + lay.lg) + (size_t)warp * H * Lk;
  for (int j = threadIdx.x; j < Lk; j += WIDE32_THREADS) ms[j] = mask[(size_t)b * Lk + j];
  if (PAIR)
    for (int i = threadIdx.x; i < H * Lk; i += WIDE32_THREADS) kfs[i] = kf[(size_t)b * H * Lk + i];
  __syncthreads();

  const float uniform = __fdiv_rn(1.f, (float)Lk);
  for (int qi = q0 + warp; qi < q1; qi += WIDE32_WARPS) {
    const float* qsrc = q + ((size_t)b * Lq + qi) * E;
    for (int d = lane; d < E; d += 32) qrow[d] = __fmul_rn(qsrc[d], scale);
    __syncwarp();
    float gmax = -INFINITY;
    for (int h = 0; h < H; ++h) {
      const bool qflag = PAIR && qf[((size_t)b * H + h) * Lq + qi] != 0;
      const float* qh = qrow + h * hd;
      for (int j = lane; j < Lk; j += 32) {
        const float* kr = kb + (size_t)j * E + h * hd;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qh[d], kr[d], acc);
        if ((PAIR && qflag && kfs[h * Lk + j]) || !ms[j]) acc = tf32x3::NEG_INF;
        lg[h * Lk + j] = acc;
        gmax = fmaxf(gmax, acc);
      }
    }
    gmax = mma_attn::warp_max(gmax);
    for (int h = 0; h < H; ++h) {
      float* lh = lg + (size_t)h * Lk;
      float l = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        const float e = expf(lh[j] - gmax);
        lh[j] = e;
        l += e;
      }
      l = mma_attn::warp_sum(l);
      for (int j = lane; j < Lk; j += 32) lh[j] = l > 0.f ? __fdiv_rn(lh[j], l) : uniform;
    }
    __syncwarp();
    float* dst = out + ((size_t)b * Lq + qi) * E;
    for (int h = 0; h < H; ++h) {
      const float* lh = lg + (size_t)h * Lk;
      for (int c = lane; c < hd; c += 32) {
        const float* vc = vb + h * hd + c;
        float acc = 0.f;
        for (int j = 0; j < Lk; ++j) acc = fmaf(lh[j], vc[(size_t)j * E], acc);
        dst[h * hd + c] = acc;
      }
    }
    __syncwarp();  // qrow and lg are rewritten by the next row
  }
}

template <bool PAIR>
int launch_onematmul_fp32_wide(const void* q, const void* k, const void* v, const void* mask,
                               const void* qf, const void* kf, void* out, int B, int H, int Lq,
                               int Lk, int E, float scale, cudaStream_t s) {
  const size_t smem = Wide32Smem(H, Lk, E).total;
  const auto kernel = attention_shortkey_onematmul_fp32_wide_kernel<PAIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + WIDE32_ROWS - 1) / WIDE32_ROWS, B);
  kernel<<<grid, WIDE32_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Lq, Lk, E, scale,
      static_cast<const uint8_t*>(qf), static_cast<const uint8_t*>(kf));
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs (bytes), so the wrapper can refuse before
// launching (0 for a head_dim E / H with no instance). is_bf16: 1 for bf16
// operands, 0 for fp32; onematmul as for the launch. The bf16 short-key
// kernel stages one head (up to 3,536 keys at head_dim 16, 1,760 at 32, 864
// at 64, 416 at 128; at a wide head the logits of its keys), the bf16
// one-matmul kernel every head of a 64-row query tile and of the sample's
// keys (at a wide head every head's logits); the fp32 short-key kernel
// streams the keys in tiles (any Lk), the fp32 one-matmul kernel stages the
// sample's K and V of every head (split or not, as the launch takes them;
// at a wide head only each warp's row and logits: K and V stay in device
// memory).
extern "C" long long attention_shortkey_smem_bytes(int is_bf16, int onematmul, int H, int Lk,
                                                   int E) {
  if (H <= 0 || E % H || Lk <= 0) return 0;
  return attn_grid::by_head_dim(E / H, 0LL, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    if constexpr (HD == attn_grid::WIDE) {
      if (!is_bf16)
        return onematmul ? (long long)Wide32Smem(H, Lk, E).total
                         : (long long)shortkey_3xtf32_smem<HD>(Lk);
      return onematmul ? (long long)onematmul_wide_smem(H, Lk)
                       : (long long)mma_attn::WideSmem::block(Lk);
    } else {
      if (!is_bf16)
        return onematmul ? (long long)OneMatmul32Smem<HD>::bytes(H, Lk)
                         : (long long)shortkey_3xtf32_smem<HD>(Lk);
      return onematmul ? (long long)OneMatmulSmem<HD>::bytes(H, Lk)
                       : (long long)mma_attn::Smem<HD>::bytes(Lk);
    }
  });
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k, v: (B, Lk, E),
// out: (B, Lq, E), contiguous, on 16-byte boundaries, bf16 (is_bf16 = 1) or
// fp32. mask: (B, Lk) uint8, 1 = attendable. qf (B, H, Lq) and kf (B, H,
// Lk) uint8 pair factors, or both null for no pair mask. onematmul: 0 = the
// packed short-key kernel (scale in f32), 1 = the one-matmul
// segment-softmax kernel (scale already rounded to the operand dtype).
// head_dim E / H is 16, 32, 64, 128 or a multiple of 128 above. Every
// instance runs on the tensor cores (bf16 on mma.sync m16n8k16, fp32 in
// 3xTF32 on m16n8k8) but the fp32 one-matmul kernel at a wide head, on the
// CUDA cores. Returns the cudaError_t of the launch (0 = success).
extern "C" int attention_shortkey_launch(const void* q, const void* k, const void* v,
                                         const void* mask, const void* qf, const void* kf,
                                         void* out, int B, int H, int Lq, int Lk, int E,
                                         int is_bf16, int onematmul, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H || (qf == nullptr) != (kf == nullptr))
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && onematmul && Lk > ONEMATMUL_KEYS) return (int)cudaErrorInvalidValue;
  const bool pair = qf != nullptr;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    if (is_bf16) {  // the route by dtype: the tensor-core kernels
      if constexpr (HD == attn_grid::WIDE) {
        if (onematmul)
          return pair ? launch_onematmul_wide<true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E,
                                                    scale, s)
                      : launch_onematmul_wide<false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E,
                                                     scale, s);
      } else if (onematmul) {
        return dispatch_onematmul_mma<HD>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
      }
      return dispatch_mma<HD>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
    }
    // fp32: the 3xTF32 kernels (the one-matmul kernel on the CUDA cores at a
    // wide head)
    if (onematmul) {
      if constexpr (HD == attn_grid::WIDE)
        return pair ? launch_onematmul_fp32_wide<true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk,
                                                       E, scale, s)
                    : launch_onematmul_fp32_wide<false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk,
                                                        E, scale, s);
      else
        return pair ? launch_onematmul_3xtf32<HD, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk,
                                                        E, scale, s)
                    : launch_onematmul_3xtf32<HD, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk,
                                                         E, scale, s);
    }
    return pair ? launch_3xtf32<HD, true>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s)
                : launch_3xtf32<HD, false>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  });
}
