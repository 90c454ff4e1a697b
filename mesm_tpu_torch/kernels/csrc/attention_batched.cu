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
// What it computes and how: the register-tile body of
// attention_regtile.cuh (the exact function of attention_batched_reference;
// a block of 256 threads per (b, h) and 64 query rows, 64 x 64 register
// tiles over key tiles of 64, an online softmax in fp32 and two walks in
// bf16). Operands stay (B, L, E): the head split is the column slice
// [h*hd, (h+1)*hd), read and written in place; the TPU wrapper's
// (B, H, L, hd) transposes existed for Mosaic and are not carried over.
//
// What bounds it on the H100: the operations. At B = 16, L = 601, hd = 32
// the two products are 5.9 GFLOP of fp32 FMA work (88 us at 67 TFLOP/s)
// against 39 MB of q, k, v and out (12 us at 3.35 TB/s).

#include "attention_regtile.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using regtile::BM;
using regtile::Smem;
using regtile::THREADS;

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attention_batched_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         T* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  regtile::attend<T, HD>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, blockIdx.y * BM, smem);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
           int Lq, int Lk, int E, float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_batched_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + BM - 1) / BM);
  attention_batched_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, Lq, Lk, E, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
             int H, int Lq, int Lk, int E, float scale, cudaStream_t s) {
  const int hd = E / H;
  if (hd == 32) return launch<T, 32>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  if (hd == 64) return launch<T, 64>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory a block takes for head_dim `hd` (0 when hd is not one the
// kernel takes); it does not depend on the lengths, since the keys stream
// through in tiles.
extern "C" long long attention_batched_smem_bytes(int hd, int Lk) {
  (void)Lk;
  if (hd == 32) return (long long)Smem<32>::bytes;
  if (hd == 64) return (long long)Smem<64>::bytes;
  return 0;
}

// Plain C entry point, bound with ctypes. q: (B, Lq, E), k and v: (B, Lk, E),
// out: (B, Lq, E), all float32 (is_bf16 = 0) or all bf16 (is_bf16 = 1),
// contiguous and 16-byte aligned; mask: (B, Lk) uint8, 1 = attendable. Head
// h reads and writes columns [h*hd, (h+1)*hd) with hd = E / H, 32 or 64.
// scale is the softmax scale rounded to the operand dtype. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int attention_batched_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int H, int Lq, int Lk,
                                        int E, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E % H != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return dispatch<bf16>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
  return dispatch<float>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);
}
