// Multi-head attention for Hopper (sm_90a) in the two layouts the attention
// dispatch reaches only through MESM_ATTN_VARIANT, bf16 or float32.
//
// Replaces two kernels of mesm_tpu/ops/attention_pallas.py (branches of
// _fused_attention_impl, :534-567):
//   - _mha_kernel (:44), "per_head", one grid step per (sample, head) over
//     (B, H, L, hd) operands;
//   - _mha_kernel_allheads (:66), "all_heads", one grid step per sample that
//     loops over the heads.
// Both sit where the bf16 packed or the fp32 batched kernel sits by default:
// the DETR encoder's self-attention (charades bf16: 128 x 195 x 195;
// TACoS fp32: 16 x 601 x 601 in eval, 32 x 601 x 601 in the train step;
// E = 256, H = 8, head_dim 32).
//
// What it computes, per (sample b, head h), as attention_batched_reference:
//   qs = round(q_h * round(scale))              (a product in the input dtype)
//   logits = qs . k_h^T                         (f32 sums)
//   masked keys -> -1e9, a finite value
//   p = round(softmax(logits))                  (f32 softmax)
//   out_h = round(p . v_h)                      (f32 sums)
// round() is to the input dtype: nothing in fp32, bf16 in bf16. A row whose
// keys are all masked gets the uniform average of v, never NaN.
//
// What bounds it on the H100: the bytes in bf16 (charades: 51 MB of q, k, v
// and out, 15 us at 3.35 TB/s; its 5 GFLOP are 5 us at the bf16
// tensor-core rate), the operations in fp32 (TACoS 16 rows: 5.9 GFLOP of
// FMA work, 88 us at 67 TFLOP/s, against 39 MB).
//
// Design. Operands stay (B, L, E): the head split is the column slice
// [h*hd, (h+1)*hd), read and written in place, so none of the TPU wrapper's
// (B, H, L, hd) transposes is made around the call.
//   - bf16 runs on the tensor cores (attention_mma.cuh): a block of 4 warps
//     takes 64 query rows of one (b, h) and stages that head's whole K_h and
//     V_h once, with 16-byte cp.async copies into XOR-swizzled tiles; each
//     warp owns 16 query rows and runs both products on
//     mma.sync.m16n8k16 bf16 tiles, with an exact two-pass softmax whose
//     logits stay in registers up to 256 keys (recomputed per pass beyond);
//     p is rounded to bf16 after the division, at the TPU's point, and fed
//     to P . V straight from the accumulators. The division is one Newton
//     step on the row's reciprocal, correctly rounded: the `/` operator
//     takes its slow path, a subroutine call, for the zero probabilities of
//     masked keys. 4 warps a block: 2 warps stage K_h and V_h twice as
//     often, 8 warps fit one block an SM at 165 registers (PERF.md).
//     mma.sync rather than wgmma:
//     the bound is bytes (15 us against 5 us of tensor work), and the
//     products are a small share of the time beside the staging and the
//     exact softmax's exp and division.
//   - float32 runs the tensor-core body the batched kernel runs in float32
//     (attention_fp32.cuh: 4 warps take 64 query rows of one (b, h), key
//     tiles of 32 streamed into two buffers, both products in 3xTF32 on
//     mma.sync m16n8k8, an online f32 softmax a few ulps from the plain
//     version's two-pass one, inside the 1e-5 the checks hold it to).
//   - a head_dim above 128 (padded to 128 n) takes the wide bodies of the
//     same headers, one block per 128-column output chunk, any Lk; so does
//     bf16 at hd 128 beyond 416 keys (the wrapper pads a smaller head_dim
//     beyond its staging to 128).
// Grid: one block per (sample, head, 64-row query tile), numbered (sample,
// tile, head) so the blocks of every head of a query tile run together:
// at charades bf16 4,096 blocks, at TACoS fp32 1,280 / 2,560 blocks, many
// waves on 132 SMs. The TPU's all-heads step (one per sample, fewer grid
// steps) would give 160 blocks at TACoS 16 rows, 1.2 waves. So both layouts
// launch the same kernels on the same grid; the wrappers count their
// launches apart.

#include "attention_fp32.cuh"
#include "attention_grid.cuh"
#include "attention_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int WIDE = attn_grid::WIDE;

template <int HD, bool RESIDENT>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_heads_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                            bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  if constexpr (HD == WIDE)
    mma_attn::block_attend_wide<mma_attn::Chain::BATCHED, true, RESIDENT>(
        q, k, v, mask, out, Lq, Lk, E, E / H, scale, b, h, q0, blockIdx.y, smem);
  else
    mma_attn::block_attend<HD, RESIDENT>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem);
}

template <int HD>
__global__ void __launch_bounds__(fp32_attn::THREADS, fp32_attn::min_blocks<HD>())
attention_heads_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

template <typename T, int HD>
size_t smem_bytes(int Lk) {
  if constexpr (sizeof(T) == 2) {
    if (HD == WIDE || mma_attn::unstaged<HD>(Lk, attn_grid::MAX_SMEM))
      return mma_attn::WideSmem::block(Lk);
    else
      return mma_attn::Smem<HD>::bytes(Lk);
  } else if constexpr (HD == WIDE) {
    return fp32_attn::WideSmem::bytes;
  } else {
    return fp32_attn::Smem<HD>::bytes;
  }
}

template <int HD>
int dispatch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                  int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  if constexpr (HD != WIDE)  // at hd 128 beyond the staging of K_h and V_h: the wide body
    if (mma_attn::unstaged<HD>(Lk, attn_grid::MAX_SMEM))
      return dispatch_bf16<WIDE>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  auto kernel = attention_heads_kernel_bf16<HD, false>;
  if (HD == WIDE ? mma_attn::one_chunk(Lk) : Lk <= mma_attn::resident_keys<HD>())
    kernel = attention_heads_kernel_bf16<HD, true>;
  return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS,
                                                 smem_bytes<bf16, HD>(Lk), q, k, v, mask, out, B,
                                                 H, Lq, Lk, E, scale, s);
}

template <int HD>
int dispatch_f32(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                 int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  return attn_grid::launch<float, fp32_attn::ROWS>(attention_heads_3xtf32_kernel<HD>,
                                                   fp32_attn::THREADS, smem_bytes<float, HD>(Lk),
                                                   q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
}

}  // namespace

// Shared memory a block needs for bf16 (is_bf16 = 1) or float32 operands,
// head_dim `hd` (16, 32, 64, 128 or a multiple of 128 above) and `Lk` keys
// (0 for another hd), so the wrapper can pad or refuse before launching.
// bf16 stages every key of the head (up to 3,536 keys at hd 16, 1,760 at
// 32, 864 at 64; at hd 128 up to 416, beyond that and at a wide head the
// wide body, any Lk); float32 streams the keys in tiles and takes any Lk.
extern "C" long long attention_heads_smem_bytes(int is_bf16, int hd, int Lk) {
  return attn_grid::by_head_dim(hd, 0LL, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return (long long)(is_bf16 ? smem_bytes<bf16, HD>(Lk) : smem_bytes<float, HD>(Lk));
  });
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k, v: (B, Lk, E),
// out: (B, Lq, E), all bf16 (is_bf16 = 1) or all float32, contiguous and
// 16-byte aligned; mask: (B, Lk) uint8, 1 = attendable. Head h reads and
// writes columns [h*hd, (h+1)*hd) with hd = E / H, 16, 32, 64, 128 or a
// multiple of 128 above. scale is the softmax scale rounded to the operand
// dtype. Returns the cudaError_t of the launch (0 = success).
extern "C" int attention_heads_launch(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int B, int H, int Lq, int Lk,
                                      int E, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0) return (int)cudaErrorInvalidValue;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return is_bf16 ? dispatch_bf16<HD>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s)
                   : dispatch_f32<HD>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  });
}
