// The layout anchor for Hopper (sm_90a): an identity copy of a (B, L, D)
// tensor, read through its strides, into a fresh row-major tensor.
//
// Replaces: mesm_tpu/ops/anchor.py::layout_anchor -> _copy_kernel (:27,
// pallas_call :47), an identity Pallas pass that pinned the video stream's
// row-major layout at a custom-call boundary. Nothing in mesm_tpu/ calls
// it; on the port's side `layout_anchor` (ops/anchor.py) copies a
// strided view of the stream, e.g. the DETR encoder's memory without its
// global token (128 x 194 x 256 bf16), into row-major memory.
//
// What bounds it on the H100: the bytes, each element read once and
// written once (2 x 12.7 MB at that shape: 7.6 us at 3.35 TB/s).
//
// Design: the TPU kernel's grid over B, one block per sample, its threads
// walking the sample's L x D elements in row-major order: the writes are
// coalesced, the reads follow the input's strides (coalesced for a
// row-major input, strided for a transposed view). Elements are copied as
// raw bits of their width, so the copy is bit-exact for any dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

template <typename E>
__global__ void __launch_bounds__(THREADS)
anchor_kernel(const E* __restrict__ x, E* __restrict__ out, int L, int D, long long sb,
              long long sl, long long sd) {
  const int b = blockIdx.x;
  const long long n = (long long)L * D;
  const E* xb = x + b * sb;
  E* ob = out + b * n;
  for (long long i = threadIdx.x; i < n; i += THREADS) {
    const long long l = i / D, d = i - l * D;
    ob[i] = xb[l * sl + d * sd];
  }
}

template <typename E>
int launch(const void* x, void* out, int B, int L, int D, long long sb, long long sl,
           long long sd, cudaStream_t stream) {
  anchor_kernel<E><<<B, THREADS, 0, stream>>>(static_cast<const E*>(x), static_cast<E*>(out), L,
                                               D, sb, sl, sd);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. x: the first element of a
// (B, L, D) tensor with element strides (sb, sl, sd); out: a contiguous
// (B, L, D) tensor of the same dtype, elem_bytes (1, 2, 4 or 8) wide.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int layout_anchor_launch(const void* x, void* out, int B, int L, int D, long long sb,
                                    long long sl, long long sd, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(x, out, B, L, D, sb, sl, sd, s);
    case 2: return launch<uint16_t>(x, out, B, L, D, sb, sl, sd, s);
    case 4: return launch<uint32_t>(x, out, B, L, D, sb, sl, sd, s);
    case 8: return launch<uint64_t>(x, out, B, L, D, sb, sl, sd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
