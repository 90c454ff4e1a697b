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
// What bounds it on the H100: in float32 the operations (B = 16, L = 601,
// hd = 32: 5.9 GFLOP of fp32 FMA work, 88 us at 67 TFLOP/s, against 39 MB
// of q, k, v and out, 12 us at 3.35 TB/s); in bf16 the bytes (charades: 51
// MB, 15 us, against 5 GFLOP, 5 us at the bf16 tensor-core rate).
//
// Two bodies, by dtype and shape:
//   - bf16 runs on the tensor cores, the body of the per-head and all-heads
//     kernels (attention_mma.cuh: 4 warps take 64 query rows of one (b, h),
//     K_h and V_h staged whole with cp.async, mma.sync m16n8k16 tiles, an
//     exact two-pass softmax) on their grid (attention_grid.cuh);
//   - float32, and bf16 whose K_h and V_h do not fit a block's shared
//     memory (more than 3,536 keys at hd 16, 1,760 at 32, 864 at 64, 416
//     at 128), run the
//     register-tile body (attention_regtile.cuh: 256 threads per (b, h) and
//     64 query rows, key tiles of 64 streamed, an online softmax in fp32 and
//     two walks in bf16), which takes any Lk. The bf16 choice is a route by
//     shape between two hand-written kernels that compute the same function.

#include "attention_grid.cuh"
#include "attention_mma.cuh"
#include "attention_regtile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <typename T, int HD>
__global__ void __launch_bounds__(regtile::THREADS)
attention_batched_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         T* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  regtile::attend<T, HD>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, blockIdx.y * regtile::BM,
                         smem);
}

template <int HD, bool RESIDENT>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_batched_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                             bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  mma_attn::block_attend<HD, RESIDENT>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem);
}

// bf16 takes the mma body where its staging fits a block
template <int HD>
bool mma_fits(int Lk) {
  return mma_attn::Smem<HD>::bytes(Lk) <= attn_grid::MAX_SMEM;
}

template <typename T, int HD>
size_t smem_bytes(int Lk) {
  if constexpr (sizeof(T) == 2)
    if (mma_fits<HD>(Lk)) return mma_attn::Smem<HD>::bytes(Lk);
  return regtile::Smem<HD>::bytes;
}

template <typename T, int HD>
int launch_regtile(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                   int H, int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  constexpr size_t smem = regtile::Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_batched_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + regtile::BM - 1) / regtile::BM);
  attention_batched_kernel<T, HD><<<grid, regtile::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
           int Lq, int Lk, int E, float scale, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (mma_fits<HD>(Lk)) {
      const auto kernel = Lk <= mma_attn::resident_keys<HD>()
                              ? attention_batched_mma_kernel<HD, true>
                              : attention_batched_mma_kernel<HD, false>;
      return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS,
                                                     mma_attn::Smem<HD>::bytes(Lk), q, k, v, mask,
                                                     out, B, H, Lq, Lk, E, scale, s);
    }
  }
  return launch_regtile<T, HD>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
             int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    return launch<T, decltype(c)::value>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  });
}

}  // namespace

// Shared memory a block takes for bf16 (is_bf16 = 1) or float32 operands,
// head_dim `hd` (16, 32, 64 or 128) and `Lk` keys (0 for another hd): the
// staging of K_h and V_h in bf16 where it fits, else the register tiles'
// constant, since their keys stream through in tiles.
extern "C" long long attention_batched_smem_bytes(int is_bf16, int hd, int Lk) {
  return attn_grid::by_head_dim(hd, 0LL, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return (long long)(is_bf16 ? smem_bytes<bf16, HD>(Lk) : smem_bytes<float, HD>(Lk));
  });
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k and v: (B, Lk, E),
// out: (B, Lq, E), all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1),
// contiguous and 16-byte aligned; mask: (B, Lk) uint8, 1 = attendable. Head
// h reads and writes columns [h*hd, (h+1)*hd) with hd = E / H, 16, 32, 64 or
// 128. scale is the softmax scale rounded to the operand dtype. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int attention_batched_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int H, int Lq, int Lk,
                                        int E, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return dispatch<bf16>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  return dispatch<float>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
}
