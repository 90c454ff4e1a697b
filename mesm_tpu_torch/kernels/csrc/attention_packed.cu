// Packed multi-head attention for Hopper (sm_90a), bf16 or float32, with and
// without the factored pair mask.
//
// Replaces two kernels of mesm_tpu/ops/attention_pallas.py (the "packed"
// branch of _fused_attention_impl):
//   - _mha_kernel_packed together with _softmax_lastdim (the packed entry
//     point): the DETR encoder's self-attention (charades: B = 128, L = 195
//     with the global token, E = 256, H = 8, head_dim 32; launched once per
//     encoder layer);
//   - _mha_kernel_packed_pair (the pair entry point): the T2V / enhance
//     cross-attention under the scrambled pair mask when the text has 64
//     keys or more (charades with long queries: 128 x 194 x 81).
// The float32 instances are what MESM_ATTN_VARIANT=packed sends fp32 models
// to (the TACoS encoder: 16 x 601 x 601).
//
// What each computes, per (sample b, head h), at the TPU kernels' rounding
// points, with bf() the rounding to the operand dtype (none in float32). The
// packed entry point (attention_packed_reference):
//   qs = bf(q_h * bf(scale))
//   logits = bf(qs . k_h^T)                     (f32 accumulation)
//   masked keys -> bf(-1e9), a finite value
//   m = max(logits); e = bf(exp(bf(logits - m)))
//   s = sum(e) in f32; p = bf(e / bf(s))
//   out_h = bf(p . v_h)                         (f32 accumulation)
// The pair entry point (attention_packed_pair_reference; an f32 softmax,
// only p rounded):
//   qs = f32(q_h) * scale                       (f32 product)
//   logits = qs . k_h^T                         (f32)
//   pair (q, k) with qf[b, h, q] and kf[b, h, k] -> -1e9; masked keys -> -1e9
//   p = bf(exp(logits - max) / sum(exp(logits - max)))   (f32 softmax)
//   out_h = bf(p . v_h)                         (f32 accumulation)
// A row whose keys are all masked gets the uniform average of v over all Lk
// keys, never NaN. Operands stay (B, L, E): the head split is the column
// slice [h*hd, (h+1)*hd), read and written in place, with no transposes
// around the call. The pair factors are the model's (B, H, Lq) and
// (B, H, Lk) masks as uint8; the TPU kernel's head-major float copies were a
// Mosaic restriction.
//
// What bounds it on the H100: in bf16 the bytes. q, k, v and out are 51 MB
// at the charades encoder shape (~15 us at 3.35 TB/s); the 5 GFLOP of the
// two products are ~5 us of tensor-core work. In float32 the operations
// (TACoS 16 x 601: 5.9 GFLOP, each product three TF32 products on the
// tensor cores, 36 us at 494.7 TFLOP/s). The (L, L) logits never leave the
// SM.
//
// Design of the packed entry point. In float32 every rounding above is to
// f32, so it computes attention_batched_reference's function; in bf16 it
// computes the same products with more roundings. So it runs the bodies of
// the per-head and all-heads kernels on their grid (attention_grid.cuh: one
// block per (sample, 64-row query tile, head)):
//   - bf16 on the tensor cores (attention_mma.cuh, Chain::PACKED: 4
//     warps, K_h and V_h staged whole with cp.async into swizzled tiles,
//     mma.sync m16n8k16 for both products, an exact two-pass softmax that
//     rounds at the points above; the logits stay in registers up to 256
//     keys (128 at hd 128), e is kept in them between passes; beyond, every
//     pass recomputes the same bf16 values). Up to 3,536 keys at hd 16,
//     1,760 at 32, 864 at 64, 416 at 128;
//   - float32 on the tensor cores in 3xTF32 (attention_fp32.cuh: key tiles
//     of 32 streamed and split once a block, an online f32 softmax a few
//     ulps from the plain version's two-pass one), any Lk.
// A head_dim above 128 (padded to 128 n) takes the wide bodies of the same
// headers, one block per 128-column output chunk, any Lk; so does bf16 at
// hd 128 beyond 416 keys (the wrapper pads a smaller head_dim beyond its
// staging to 128).
//
// Design of the pair entry point. bf16 operands (on 16-byte boundaries, as
// for the packed entry point) take the mma body on the same grid
// (attention_mma.cuh, Chain::PAIR: unscaled q and k into the mma, the f32
// sums times the f32 scale, the batched chain's exact two-pass f32
// softmax); the block stages its head's key factor row as one more bit of
// the per-key flag byte, and each thread reads the query factors of its two
// rows. Up to 128 keys (the text keys of the pair sites) a row's logits
// stay in 64 registers a thread, up to 256 in 128; beyond, they are
// streamed. The same key limits as the packed entry point's. In float32
// the pair chain is the batched function with the pair mask, so float32
// operands take the 3xTF32 body of the packed entry point with the pair
// flags in the same flag byte (attention_fp32.cuh), any Lk. At a wide head
// both take the wide bodies of the same headers. The entry point picks the
// body by the operand dtype.

#include "attention_fp32.cuh"
#include "attention_grid.cuh"
#include "attention_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int WIDE = attn_grid::WIDE;

// ---------------------------------------------------------------------------
// the packed entry point
// ---------------------------------------------------------------------------

template <int HD, bool RESIDENT>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_packed_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                            bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  if constexpr (HD == WIDE)
    mma_attn::block_attend_wide<mma_attn::Chain::PACKED, true, RESIDENT>(
        q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0, blockIdx.y, smem);
  else
    mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PACKED>(q, k, v, mask, out, Lq, Lk, E,
                                                                  scale, b, h, q0, smem);
}

// the pair entry point in bf16: scale is the f32 softmax scale; qf (B, H,
// Lq) and kf (B, H, Lk) the pair factors as uint8. KEYS: the keys whose
// logits stay in registers when RESIDENT
template <int HD, bool RESIDENT, int KEYS>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_packed_pair_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                                 bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale,
                                 const uint8_t* __restrict__ qf, const uint8_t* __restrict__ kf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  const size_t bh = (size_t)b * H + h;
  if constexpr (HD == WIDE)
    mma_attn::block_attend_wide<mma_attn::Chain::PAIR, true, RESIDENT>(
        q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0, blockIdx.y, smem, qf + bh * Lq,
        kf + bh * Lk);
  else
    mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, KEYS>(
        q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem, qf + bh * Lq, kf + bh * Lk);
}

template <int HD>
__global__ void __launch_bounds__(fp32_attn::THREADS, fp32_attn::min_blocks<HD>())
attention_packed_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const uint8_t* __restrict__ mask,
                               float* __restrict__ out, int H, int Lq, int Lk, int E,
                               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<fp32_attn::ROWS>(H, Lq, b, h, q0);
  if constexpr (HD == WIDE)
    fp32_attn::block_attend_wide<false>(q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0,
                                        blockIdx.y, smem);
  else
    fp32_attn::block_attend<HD>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem);
}

// the pair entry point in float32: scale is the f32 softmax scale; qf (B, H,
// Lq) and kf (B, H, Lk) the pair factors as uint8
template <int HD>
__global__ void __launch_bounds__(fp32_attn::THREADS, fp32_attn::min_blocks<HD>())
attention_packed_pair_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const uint8_t* __restrict__ mask,
                                    float* __restrict__ out, int H, int Lq, int Lk, int E,
                                    float scale, const uint8_t* __restrict__ qf,
                                    const uint8_t* __restrict__ kf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<fp32_attn::ROWS>(H, Lq, b, h, q0);
  const size_t bh = (size_t)b * H + h;
  if constexpr (HD == WIDE)
    fp32_attn::block_attend_wide<true>(q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0,
                                       blockIdx.y, smem, qf + bh * Lq, kf + bh * Lk);
  else
    fp32_attn::block_attend<HD, true>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem,
                                      qf + bh * Lq, kf + bh * Lk);
}

// bf16 at head_dim 128 beyond the staging of K_h and V_h takes the wide body
template <int HD>
bool bf16_wide(int is_bf16, int Lk) {
  return is_bf16 && mma_attn::unstaged<HD>(Lk, attn_grid::MAX_SMEM);
}

template <int HD>
size_t tiles_smem_bytes(int is_bf16, int Lk) {
  if constexpr (HD == WIDE)
    return is_bf16 ? mma_attn::WideSmem::block(Lk) : fp32_attn::WideSmem::bytes;
  else if (bf16_wide<HD>(is_bf16, Lk))
    return mma_attn::WideSmem::block(Lk);
  else
    return is_bf16 ? mma_attn::Smem<HD>::bytes(Lk) : fp32_attn::Smem<HD>::bytes;
}

template <int HD>
int launch_tiles(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                 int H, int Lq, int Lk, int E, int is_bf16, float scale, cudaStream_t s) {
  if constexpr (HD != WIDE)
    if (bf16_wide<HD>(is_bf16, Lk))
      return launch_tiles<WIDE>(q, k, v, mask, out, B, H, Lq, Lk, E, is_bf16, scale, s);
  const size_t smem = tiles_smem_bytes<HD>(is_bf16, Lk);
  if (is_bf16) {
    auto kernel = attention_packed_mma_kernel<HD, false>;
    if (HD == WIDE ? mma_attn::one_chunk(Lk) : Lk <= mma_attn::resident_keys<HD>())
      kernel = attention_packed_mma_kernel<HD, true>;
    return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS, smem, q, k, v, mask,
                                                   out, B, H, Lq, Lk, E, scale, s);
  }
  return attn_grid::launch<float, fp32_attn::ROWS>(attention_packed_3xtf32_kernel<HD>,
                                                   fp32_attn::THREADS, smem, q, k, v, mask, out,
                                                   B, H, Lq, Lk, E, scale, s);
}

// the text keys of the pair sites (up to 81 in charades) keep their logits
// in half the registers of RESIDENT_KEYS
constexpr int SHORT_KEYS = 128;

template <int HD>
int launch_pair_mma(const void* q, const void* k, const void* v, const void* mask, const void* qf,
                    const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
                    cudaStream_t s) {
  constexpr int RK = mma_attn::resident_keys<HD>();
  auto kernel = attention_packed_pair_mma_kernel<HD, false, RK>;
  if constexpr (HD == WIDE) {
    if (mma_attn::one_chunk(Lk)) kernel = attention_packed_pair_mma_kernel<HD, true, RK>;
  } else if (Lk <= SHORT_KEYS) {
    kernel = attention_packed_pair_mma_kernel<HD, true, SHORT_KEYS>;
  } else if (Lk <= RK) {
    kernel = attention_packed_pair_mma_kernel<HD, true, RK>;
  }
  return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS,
                                                 tiles_smem_bytes<HD>(1, Lk), q, k, v, mask,
                                                 out, B, H, Lq, Lk, E, scale, s,
                                                 static_cast<const uint8_t*>(qf),
                                                 static_cast<const uint8_t*>(kf));
}

template <int HD>
int launch_pair_entry(const void* q, const void* k, const void* v, const void* mask,
                      const void* qf, const void* kf, void* out, int B, int H, int Lq, int Lk,
                      int E, int is_bf16, float scale, cudaStream_t s) {
  if constexpr (HD != WIDE)
    if (bf16_wide<HD>(is_bf16, Lk))
      return launch_pair_entry<WIDE>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, is_bf16, scale,
                                     s);
  if (is_bf16) return launch_pair_mma<HD>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  return attn_grid::launch<float, fp32_attn::ROWS>(
      attention_packed_pair_3xtf32_kernel<HD>, fp32_attn::THREADS, tiles_smem_bytes<HD>(0, Lk), q,
      k, v, mask, out, B, H, Lq, Lk, E, scale, s, static_cast<const uint8_t*>(qf),
      static_cast<const uint8_t*>(kf));
}

bool valid(int B, int H, int Lq, int Lk, int E, int Ev) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && E % H == 0 && Ev == E;
}

}  // namespace

// Shared memory a block of either entry point needs for bf16 (is_bf16 = 1)
// or float32 operands, head_dim `hd` (16, 32, 64, 128 or a multiple of 128
// above) and `Lk` keys (0 for another hd), so the wrapper can pad or refuse
// before launching: bf16 stages every key of the head (up to 3,536 keys at
// hd 16, 1,760 at 32, 864 at 64; at hd 128 up to 416, beyond that and at a
// wide head the wide body, any Lk); float32 streams the keys in tiles and
// takes any Lk.
extern "C" long long attention_packed_smem_bytes(int is_bf16, int hd, int Lk) {
  return attn_grid::by_head_dim(hd, 0LL, [&](auto c) {
    return (long long)tiles_smem_bytes<decltype(c)::value>(is_bf16, Lk);
  });
}

// Plain C entry points, bound with ctypes. q: (B, Lq, E), k: (B, Lk, E),
// v: (B, Lk, Ev), out: (B, Lq, Ev), all bf16 (is_bf16 = 1) or all float32,
// contiguous; mask: (B, Lk) uint8, 1 = attendable. Head h reads and writes
// columns [h*hd, (h+1)*hd) with hd = E / H = Ev / H, 16, 32, 64, 128 or a
// multiple of 128 above. Each returns the cudaError_t of the launch (0 =
// success).
//
// attention_packed_launch: q, k, v and out 16-byte aligned; scale is the
// softmax scale already rounded to the operand dtype.
extern "C" int attention_packed_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int B, int H, int Lq, int Lk,
                                       int E, int Ev, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, Lq, Lk, E, Ev)) return (int)cudaErrorInvalidValue;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    return launch_tiles<decltype(c)::value>(q, k, v, mask, out, B, H, Lq, Lk, E, is_bf16, scale,
                                            s);
  });
}

// attention_packed_pair_launch: q, k, v and out 16-byte aligned; bf16 on
// the mma body, float32 on the 3xTF32 body; qf (B, H, Lq) and kf (B, H, Lk)
// uint8 pair factors (pair (q, k) of head (b, h) is masked when both are
// 1); scale is the f32 softmax scale.
extern "C" int attention_packed_pair_launch(const void* q, const void* k, const void* v,
                                            const void* mask, const void* qf, const void* kf,
                                            void* out, int B, int H, int Lq, int Lk, int E, int Ev,
                                            int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, Lq, Lk, E, Ev)) return (int)cudaErrorInvalidValue;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    return launch_pair_entry<decltype(c)::value>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E,
                                                 is_bf16, scale, s);
  });
}
