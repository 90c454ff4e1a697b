// The grid of the attention kernels over (B, L, E) operands that take one
// block per (sample b, head h, tile of ROWS query rows): blocks numbered
// (b, tile, h), so the blocks of every head of a query tile run together,
// and, at wide heads, one more grid dimension over the head's 128-column
// output chunks; the launch that sets a block's dynamic shared memory and
// checks the grid's size. Shared by attention_heads.cu, attention_batched.cu,
// attention_packed.cu and attention_shortkey.cu. Also the head dims every
// attention kernel has an instance for, shared by every attention source.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_grid {

// The head dims of the kernels' instances: 16, 32, 64 and 128, and WIDE:
// every multiple of SLICE = 128 above 128, which the wide bodies take in
// 128-column slices (the logits) and 128-column output chunks (one block
// each: grid dimension y). The wrappers zero-pad any other head_dim to the
// next of them (zero columns add exact zeros to the f32 sums of q . k and
// give zero columns of p . v). by_head_dim(hd, invalid, f) returns
// f(HeadDim<HD>{}) for hd one of them (HD = WIDE for a wide head), else
// `invalid`; f reads the head_dim as decltype(c)::value.
constexpr int SLICE = 128;
constexpr int WIDE = 0;

template <int HD>
struct HeadDim {
  static constexpr int value = HD;
};

template <typename R, typename F>
R by_head_dim(int hd, R invalid, F&& f) {
  switch (hd) {
    case 16: return f(HeadDim<16>{});
    case 32: return f(HeadDim<32>{});
    case 64: return f(HeadDim<64>{});
    case 128: return f(HeadDim<128>{});
    default: return hd > SLICE && hd % SLICE == 0 ? f(HeadDim<WIDE>{}) : invalid;
  }
}

// the output chunks of a head: hd / 128 at a wide head, else 1
__host__ __device__ inline int chunks(int hd) { return hd > SLICE ? hd / SLICE : 1; }

// shared memory a block may take on sm_90 (opt-in above 48 KB)
constexpr size_t MAX_SMEM = 232448;

// (b, h, first query row) of this block
template <int ROWS>
__device__ __forceinline__ void block_coords(int H, int Lq, int& b, int& h, int& q0) {
  const int tiles = (Lq + ROWS - 1) / ROWS;
  const int x = blockIdx.x;
  h = x % H;
  q0 = (x / H) % tiles * ROWS;
  b = x / (H * tiles);
}

// Launches `kernel` (q, k, v, mask, out, H, Lq, Lk, E, scale, extra...) of
// element type T on B * H * ceil(Lq / ROWS) x chunks(E / H) blocks of
// `threads` threads with `smem` bytes of dynamic shared memory; returns the
// cudaError_t of the launch. `extra` (none but for the pair kernel's factor pointers) is passed
// on after scale.
template <typename T, int ROWS, typename Kernel, typename... Extra>
int launch(Kernel kernel, int threads, size_t smem, const void* q, const void* k, const void* v,
           const void* mask, void* out, int B, int H, int Lq, int Lk, int E, float scale,
           cudaStream_t stream, Extra... extra) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Lq + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)chunks(E / H));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, Lq, Lk, E, scale,
      extra...);
  return (int)cudaGetLastError();
}

}  // namespace attn_grid
