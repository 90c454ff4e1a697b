// Device code shared by the float32 attention kernels whose products run on
// the tensor cores in 3xTF32: the forward body (attention_fp32.cuh: kernels
// 2, 3, 6, 7 and 8 in float32, and kernel 4, attention_shortkey.cu's
// packed short-key kernel, at every head_dim), the fp32 one-matmul kernel
// (kernel 5, attention_shortkey.cu, head_dim 16 to 128; above 128 it runs on
// the CUDA cores) and the backward (attention_backward.cu).
//
// One TF32 product keeps 10 mantissa bits of each operand, too few for an
// f32 function; 3xTF32 keeps about 21: each operand x splits into hi =
// tf32(x) and lo = tf32(x - hi), and a product a . b is lo_a . hi_b + hi_a .
// lo_b + hi_a . hi_b (lo . lo, about 2^-22 of the product, is dropped),
// three tensor-core products. The tensor cores truncate their own
// accumulation, so the kernels take short sums on them (one tile of keys or
// one head_dim) and add those into f32 running sums on the CUDA cores.
//
// The instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (PTX ISA: A holds rows g and g + 8, columns t and t + 4 of a 16 x 8 tile,
// lane = 4 g + t; B column g, rows t and t + 4; C rows g and g + 8, columns
// 2t and 2t + 1). A product whose result feeds the next one keeps it in
// registers: the C tile of 8 keys is the A fragment of those keys when the
// k index t stands for key 2t and t + 4 for key 2t + 1, and the B fragment
// is read in that order (product_kt).
//
// Tiles of the other side of a product are staged by cp.async as f32 rows at
// a stride of hd + 4 floats (RS), so each B fragment load (8 rows x 4
// columns, or 4 row pairs x 8 columns) hits 32 distinct banks, and split once
// a block: each thread splits the chunks it copied, in place (hi) and into a
// second array (lo). Splitting in the warps instead (each value once for
// each warp and each product that reads it) was slower in the backward: the
// splits, not the loads, held the products back.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tf32x3 {

constexpr float NEG_INF = -1e9f;

// row stride (floats) of a staged tile: conflict-free fragment loads
template <int HD>
constexpr int RS = HD + 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as tf32, rounded to nearest with ties away from zero: cvt.rna.tf32.f32
// for every finite x, in two integer instructions (half a tf32 ulp added to
// the magnitude, the 13 low bits cleared); the cvt itself was slower
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 21 bits: hi = tf32(x), lo = tf32(x - hi) (exact
// difference)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (4 f32 values), split; or read already split.
struct SplitA {
  uint32_t hi[4], lo[4];
  SplitA() = default;
  __device__ __forceinline__ SplitA(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// A staged tile, split: hi = tf32(x), lo = tf32(x - hi) at the same offsets.
struct SplitTile {
  const float* hi;
  const float* lo;
};

// c += a . b in 3xTF32, the small terms first: lo . hi, hi . lo, hi . hi;
// b's two values at offsets o0, o1 of a split tile
__device__ __forceinline__ void mma3(float (&c)[4], const SplitA& a, const SplitTile& T, int o0,
                                     int o1) {
  const uint32_t bh0 = __float_as_uint(T.hi[o0]), bh1 = __float_as_uint(T.hi[o1]);
  const uint32_t bl0 = __float_as_uint(T.lo[o0]), bl1 = __float_as_uint(T.lo[o1]);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

// cp.async of rows [0, ROWS) of an f32 tile of HD columns (row stride E in
// device memory; `rows` of them read, zeros beyond) into dst at row stride
// RS: thread tid of THREADS copies the 16-byte chunks i = tid + n THREADS.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int rows,
                                           int E) {
  constexpr int C4 = HD / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    float* d = dst + r * RS<HD> + 4 * c;
    if (r < rows)
      cp_async16(d, src + (size_t)r * E + 4 * c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The chunks this thread staged into `hi` by stage_tile (its own copies,
// arrived), each value times `mul`, split in place: hi keeps tf32(x * mul),
// lo gets the rest. Visible to the block after the next barrier.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void split_tile(float* hi, float* lo, float mul) {
  constexpr int C4 = HD / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int off = i / C4 * RS<HD> + 4 * (i % C4);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split(x.x * mul, h.x, l.x);
    split(x.y * mul, h.y, l.y);
    split(x.z * mul, h.z, l.z);
    split(x.w * mul, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// c[nt] = A . T^T over HD: the rows n0 + 8 nt + g of split tile T are the B
// columns (S = qs . K^T with T = K). A gives the split A fragment of each k
// step: a.split(ks).
template <int HD, int NT, typename A>
__device__ __forceinline__ void product_nt(float (&c)[NT][4], const A& a, const SplitTile& T,
                                           int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    const SplitA sa = a.split(ks);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int off = (n0 + 8 * nt + g) * RS<HD> + 8 * ks + t;
      mma3(c[nt], sa, T, off, off + 4);
    }
  }
}

// c = X . T over the K rows k0 .. k0 + K of split tile T, output columns
// 8 (nd0 + nd) .. of T for nd < NC, with X the C tiles x[K / 8] of a
// previous product (16 rows x K): tile ks's C values (row g: keys 2t,
// 2t + 1; row g + 8: the same) are the A fragment of k step ks when k index
// t stands for row 2t of T and t + 4 for row 2t + 1.
template <int HD, int K, int NC>
__device__ __forceinline__ void product_kt(float (&c)[NC][4], const float (&x)[K / 8][4],
                                           const SplitTile& T, int k0, int lane, int nd0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < NC; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nd][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    const SplitA sa(x[ks][0], x[ks][2], x[ks][1], x[ks][3]);
    const int off = (k0 + 8 * ks + 2 * t) * RS<HD> + g + 8 * nd0;
#pragma unroll
    for (int nd = 0; nd < NC; ++nd) mma3(c[nd], sa, T, off + 8 * nd, off + RS<HD> + 8 * nd);
  }
}

// a key's flag: 1 valid, 0 masked, 2 past Lk
__device__ __forceinline__ uint8_t key_flag(const uint8_t* __restrict__ mask_b, int j, int Lk) {
  return j < Lk ? (mask_b[j] ? 1 : 0) : 2;
}

// a logit under its key's flag: -1e9 masked, -inf past Lk
__device__ __forceinline__ float masked_logit(float s, uint8_t f) {
  return f == 2 ? -INFINITY : (f ? s : NEG_INF);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The walk over the tiles of the other side, two buffers: tile it + 1's
// copies land while tile it is computed, tile it + 2's are issued as soon
// as every warp is done with tile it's buffer, and each thread splits its
// own chunks of tile it + 1 before the barrier that opens it. Copies issued
// (and committed) before the walk have landed when split_own(0) runs.
//   stage(it, buf): issue (and commit) tile it's copies into buffer buf
//   split_own(buf): split this thread's chunks of buffer buf
//   compute(it, buf): the products of tile it
//   between(it): work for tile it + 1 after the first barrier
template <typename Stage, typename Split, typename Compute, typename Between>
__device__ __forceinline__ void walk(int ntiles, Stage stage, Split split_own, Compute compute,
                                     Between between) {
  stage(0, 0);
  if (ntiles > 1) stage(1, 1);
  if (ntiles > 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  split_own(0);
  __syncthreads();
  for (int it = 0; it < ntiles; ++it) {
    compute(it, it & 1);
    __syncthreads();  // every warp is done with buffer it & 1
    if (it + 2 < ntiles) stage(it + 2, it & 1);
    if (it + 1 < ntiles) {
      if (it + 2 < ntiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      split_own((it + 1) & 1);
      between(it);
    }
    __syncthreads();  // tile it + 1 is split
  }
}

}  // namespace tf32x3
