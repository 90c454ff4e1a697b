// Multi-head attention for Hopper (sm_90a), float32 or bf16, heads split in
// the kernel.
//
// Replaces: mesm_tpu/ops/attention_pallas.py::_mha_kernel_batched (the
// "batched" branch of _fused_attention_impl, wrapper :515-533). In float32
// it is the fp32 tier of the attention dispatch: the DETR encoder's
// self-attention at the TACoS geometry (B = 16 eval rows or 32 stacked train
// rows, L = 601 with the global token, E = 256, H = 8, head_dim 32; launched
// once per encoder layer), and the forward of the trainable attention
// (ops/attention_trainable.py) in fp32. In bf16 it is what
// MESM_ATTN_VARIANT=batched sends the bf16 encoder to (charades: 128 x 195).
//
// What it computes: the function of attention_batched_reference (q * scale
// in the operand dtype, f32 logits, -1e9 on masked keys, an f32 softmax, p
// rounded to the operand dtype, f32 sums of p . v), which is that of the
// per-head and all-heads kernels too. Operands stay (B, L, E): the head
// split is the column slice [h*hd, (h+1)*hd), read and written in place;
// the TPU wrapper's (B, H, L, hd) transposes existed for Mosaic and are not
// carried over.
//
// What bounds it on the H100: in float32 the operations (B = 32, L = 601,
// hd = 32: 11.8 GFLOP in the two products; on the CUDA cores' 67 TFLOP/s
// 0.18 ms, in 3xTF32 on the tensor cores' 494.7 TFLOP/s 35.5 GFLOP, 0.07
// ms, against 79 MB of q, k, v and out, 0.024 ms at 3.35 TB/s); in bf16 the
// bytes (charades: 51 MB, 15 us, against 5 GFLOP, 5 us at the bf16
// tensor-core rate).
//
// Three bodies, by dtype and shape:
//   - float32 runs on the tensor cores in 3xTF32 (attention_fp32.cuh: 4
//     warps take 64 query rows of one (b, h), key tiles of 32 streamed by
//     cp.async into two buffers and split once a block, the Q tile split
//     once, an online f32 softmax, each tile's P . V a partial sum added in
//     f32), any Lk; at wide heads the slices and chunks of that header;
//   - bf16 runs on the tensor cores, the body of the per-head and all-heads
//     kernels (attention_mma.cuh: 4 warps take 64 query rows of one (b, h),
//     K_h and V_h staged whole with cp.async, mma.sync m16n8k16 tiles, an
//     exact two-pass softmax) on their grid (attention_grid.cuh); at wide
//     heads that header's wide body (logits in shared memory, chunks of
//     704 keys, any Lk);
//   - bf16 whose K_h and V_h do not fit a block's shared memory on the mma
//     tiles (more than 3,536 keys at hd 16, 1,760 at 32, 864 at 64, 416 at
//     128) runs the register tiles (attention_regtile.cuh: 256 threads per
//     (b, h) and 64 query rows, key tiles of 64 streamed, two walks), which
//     take any Lk. The bf16 choice is a route by shape between two
//     hand-written kernels that compute the same function. The wide body
//     takes any Lk too, but at hd 32 past 1,760 keys (padded to 128, three
//     passes) it took 2.4x the register tiles' time (PERF.md section 6).

#include "attention_fp32.cuh"
#include "attention_grid.cuh"
#include "attention_mma.cuh"
#include "attention_regtile.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int WIDE = attn_grid::WIDE;

template <int HD>
__global__ void __launch_bounds__(fp32_attn::THREADS, fp32_attn::min_blocks<HD>())
attention_batched_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

template <int HD>
__global__ void __launch_bounds__(regtile::THREADS)
attention_batched_regtile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                                 bf16* __restrict__ out, int H, int Lq, int Lk, int E,
                                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  regtile::attend<HD>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, blockIdx.y * regtile::BM, smem);
}

template <int HD, bool RESIDENT>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_batched_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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

// bf16 takes the mma body where its staging fits a block
template <int HD>
bool mma_fits(int Lk) {
  return mma_attn::Smem<HD>::bytes(Lk) <= attn_grid::MAX_SMEM;
}

template <typename T, int HD>
size_t smem_bytes(int Lk) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (HD == WIDE)
      return fp32_attn::WideSmem::bytes;
    else
      return fp32_attn::Smem<HD>::bytes;
  } else if constexpr (HD == WIDE) {
    return mma_attn::WideSmem::block(Lk);
  } else {
    return mma_fits<HD>(Lk) ? mma_attn::Smem<HD>::bytes(Lk) : regtile::Smem<HD>::bytes;
  }
}

template <int HD>
int launch_regtile(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                   int H, int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  constexpr size_t smem = regtile::Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_batched_regtile_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + regtile::BM - 1) / regtile::BM);
  attention_batched_regtile_kernel<HD><<<grid, regtile::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  if constexpr (HD == WIDE) {
    const auto kernel = mma_attn::one_chunk(Lk) ? attention_batched_mma_kernel<WIDE, true>
                                                : attention_batched_mma_kernel<WIDE, false>;
    return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS,
                                                   smem_bytes<bf16, HD>(Lk), q, k, v, mask, out,
                                                   B, H, Lq, Lk, E, scale, s);
  } else {
    if (mma_fits<HD>(Lk)) {
      const auto kernel = Lk <= mma_attn::resident_keys<HD>()
                              ? attention_batched_mma_kernel<HD, true>
                              : attention_batched_mma_kernel<HD, false>;
      return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS,
                                                     mma_attn::Smem<HD>::bytes(Lk), q, k, v,
                                                     mask, out, B, H, Lq, Lk, E, scale, s);
    }
    return launch_regtile<HD>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
               int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  return attn_grid::launch<float, fp32_attn::ROWS>(attention_batched_3xtf32_kernel<HD>,
                                                   fp32_attn::THREADS, smem_bytes<float, HD>(Lk),
                                                   q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
}

}  // namespace

// Shared memory a block takes for bf16 (is_bf16 = 1) or float32 operands,
// head_dim `hd` (16, 32, 64, 128 or a multiple of 128 above) and `Lk` keys
// (0 for another hd): bf16 stages K_h and V_h where that fits (at a wide
// head: the logits of up to 704 keys at a time, any Lk), else the register
// tiles' constant; float32 streams the keys in tiles and takes any Lk.
extern "C" long long attention_batched_smem_bytes(int is_bf16, int hd, int Lk) {
  return attn_grid::by_head_dim(hd, 0LL, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return (long long)(is_bf16 ? smem_bytes<bf16, HD>(Lk) : smem_bytes<float, HD>(Lk));
  });
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k and v: (B, Lk, E),
// out: (B, Lq, E), all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1),
// contiguous and 16-byte aligned; mask: (B, Lk) uint8, 1 = attendable. Head
// h reads and writes columns [h*hd, (h+1)*hd) with hd = E / H, 16, 32, 64,
// 128 or a multiple of 128 above. scale is the softmax scale rounded to the
// operand dtype. Returns the cudaError_t of the launch (0 = success).
extern "C" int attention_batched_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int H, int Lq, int Lk,
                                        int E, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0) return (int)cudaErrorInvalidValue;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return is_bf16 ? launch_bf16<HD>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s)
                   : launch_f32<HD>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  });
}
