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
// Design: a grid over (D tiles, L tiles, B), one of three copies chosen by
// the strides before the launch. Elements are copied as raw bits of their
// width (1, 2, 4 or 8 bytes), so the copy is bit-exact for any dtype.
//   - rows: the unit stride along D (a row-major stream, or a slice such as
//     [:, 1:] of one): tiles of 32 rows x 32 chunks of 16 bytes, a warp on
//     one row's 512 bytes, each thread four 16-byte loads in flight before
//     its four stores. Taken where every row starts on a 16-byte boundary
//     and D fills whole chunks.
//   - transpose: the unit stride along L (a (B, D, L) tensor viewed as
//     (B, L, D)): tiles of 64 L x 64 D elements through shared memory,
//     read along L in the widest accesses every (b, d) column's alignment
//     allows (16 bytes where L fills 16-byte chunks; at L = 194 in bf16 a
//     column starts on a 4-byte boundary, so 4 bytes a thread, a warp's 128
//     bytes still one transaction), written in 16-byte chunks along D, the
//     tile's rows padded by one 4-byte word; element accesses at the tile
//     edges (and on the write side where D does not fill whole chunks).
//   - general: any other strides, element by element, threads along D (the
//     writes coalesced, the reads as the strides allow).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// rows: tile (blockIdx.x: 32 chunks of D, blockIdx.y: 32 rows of L, z: b)
template <typename E>
__global__ void __launch_bounds__(THREADS)
anchor_rows_kernel(const E* __restrict__ x, E* __restrict__ out, int L, int D, long long sb,
                   long long sl) {
  constexpr int V = 16 / sizeof(E), ROWS = 32, CH = 32, PER = ROWS * CH / THREADS;
  const int b = blockIdx.z, c = blockIdx.x * CH + threadIdx.x % CH;
  const int l0 = blockIdx.y * ROWS + threadIdx.x / CH;
  const int nch = D / V;
  if (c >= nch) return;
  uint4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = l0 + i * (THREADS / CH);
    if (l < L) v[i] = __ldg(reinterpret_cast<const uint4*>(x + b * sb + l * sl) + c);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = l0 + i * (THREADS / CH);
    if (l < L) reinterpret_cast<uint4*>(out + ((long long)b * L + l) * D)[c] = v[i];
  }
}

// transpose: tile of 64 L x 64 D (blockIdx.x: D tile, y: L tile, z: b);
// x(b, l, d) at b * sb + l + d * sd, read along l in accesses of type R
// (VR elements; every column starts on a sizeof(R) boundary). VEC_OUT: D
// fills whole 16-byte chunks.
template <typename E, typename R, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS)
anchor_transpose_kernel(const E* __restrict__ x, E* __restrict__ out, int L, int D, long long sb,
                        long long sd) {
  constexpr int V = 16 / sizeof(E), VR = sizeof(R) / sizeof(E), T = 64;
  constexpr int PAD = 4 / sizeof(E) > 0 ? 4 / sizeof(E) : 1;
  constexpr int RS = T + PAD;  // tile row stride in elements, rows along d
  __shared__ __align__(16) E tile[T * RS + V];
  const int b = blockIdx.z, d0 = blockIdx.x * T, l0 = blockIdx.y * T;
  const E* xb = x + b * sb;
  // read: 64 d rows x (64 / VR) accesses along l
  for (int i = threadIdx.x; i < T * (T / VR); i += THREADS) {
    const int dr = i / (T / VR), lc = (i % (T / VR)) * VR;
    const int d = d0 + dr, l = l0 + lc;
    union {
      R r;
      E e[VR];
    } u;
    if (d < D && l + VR <= L) {
      u.r = __ldg(reinterpret_cast<const R*>(xb + d * sd + l));
    } else {
#pragma unroll
      for (int k = 0; k < VR; ++k) u.e[k] = d < D && l + k < L ? xb[d * sd + l + k] : E(0);
    }
#pragma unroll
    for (int k = 0; k < VR; ++k) tile[dr * RS + lc + k] = u.e[k];
  }
  __syncthreads();
  // write: 64 l rows x (64 / V) chunks along d
  for (int i = threadIdx.x; i < T * (T / V); i += THREADS) {
    const int lr = i / (T / V), dc = (i % (T / V)) * V;
    const int l = l0 + lr, d = d0 + dc;
    if (l >= L) continue;
    alignas(16) E e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = tile[(dc + k) * RS + lr];
    E* o = out + ((long long)b * L + l) * D + d;
    if (VEC_OUT && d + V <= D) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(e);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (d + k < D) o[k] = e[k];
    }
  }
}

// general: tile of 8 L rows x 128 D elements (blockIdx.x: D tile, y: L tile, z: b)
template <typename E>
__global__ void __launch_bounds__(THREADS)
anchor_general_kernel(const E* __restrict__ x, E* __restrict__ out, int L, int D, long long sb,
                      long long sl, long long sd) {
  const int b = blockIdx.z, d = blockIdx.x * 128 + threadIdx.x % 128;
  if (d >= D) return;
  for (int l = blockIdx.y * 8 + threadIdx.x / 128; l < min(L, (int)blockIdx.y * 8 + 8); l += 2)
    out[((long long)b * L + l) * D + d] = x[b * sb + l * sl + d * sd];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename E, typename R>
void launch_transpose(const E* x, E* out, int B, int L, int D, long long sb, long long sd,
                      cudaStream_t stream) {
  const dim3 grid((D + 63) / 64, (L + 63) / 64, B);
  if (D % (16 / sizeof(E)) == 0 && aligned16(out))
    anchor_transpose_kernel<E, R, true><<<grid, THREADS, 0, stream>>>(x, out, L, D, sb, sd);
  else
    anchor_transpose_kernel<E, R, false><<<grid, THREADS, 0, stream>>>(x, out, L, D, sb, sd);
}

template <typename E>
int launch(const void* xv, void* outv, int B, int L, int D, long long sb, long long sl,
           long long sd, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  const E* x = static_cast<const E*>(xv);
  E* out = static_cast<E*>(outv);
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if ((sd == 1 || D == 1) && D % V == 0 && sl % V == 0 && sb % V == 0 && aligned16(x) &&
      aligned16(out)) {
    const dim3 grid((D / V + 31) / 32, (L + 31) / 32, B);
    anchor_rows_kernel<E><<<grid, THREADS, 0, stream>>>(x, out, L, D, sb, sl);
  } else if (sl == 1) {
    // the widest read every column's first element allows
    const unsigned long long bits = (unsigned long long)(sd * sizeof(E)) |
                                    (unsigned long long)(sb * sizeof(E)) |
                                    (unsigned long long)reinterpret_cast<uintptr_t>(x) | 16ull;
    const unsigned long long align = bits & (~bits + 1);  // lowest set bit
    if (align >= 16)
      launch_transpose<E, uint4>(x, out, B, L, D, sb, sd, stream);
    else if (align >= 8)
      launch_transpose<E, uint2>(x, out, B, L, D, sb, sd, stream);
    else if constexpr (sizeof(E) <= 4) {
      if (align >= 4)
        launch_transpose<E, uint32_t>(x, out, B, L, D, sb, sd, stream);
      else
        launch_transpose<E, E>(x, out, B, L, D, sb, sd, stream);
    } else {
      launch_transpose<E, E>(x, out, B, L, D, sb, sd, stream);
    }
  } else {
    const dim3 grid((D + 127) / 128, (L + 7) / 8, B);
    anchor_general_kernel<E><<<grid, THREADS, 0, stream>>>(x, out, L, D, sb, sl, sd);
  }
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
