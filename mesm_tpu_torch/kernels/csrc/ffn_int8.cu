// The fused int8 FFN for Hopper (sm_90a): out = linear2(prelu(linear1(x)))
// with int8 x int8 -> int32 products on wgmma, the hidden activation never
// leaving the SM.
//
// Replaces: mesm_tpu/ops/ffn_pallas.py::ffn_int8 -> _ffn_int8_kernel
// (:44-142), which the FFN of every eval transformer layer runs when the
// int8 switch is on (mesm_tpu/models/layers.py:298-325): x of (N, K = 256)
// rows in the model's dtype (charades bf16: N = 24,832-24,960; TACoS fp32:
// ~9,600), hidden width N1 = 1024, K2 = 256 outputs.
//
// What it computes, row by row, at the TPU kernel's rounding points
// (ops/ffn_int8.ffn_int8_reference is its plain version; bf() rounds to
// bf16, and every product and sum of bf16 values below is rounded to bf16):
//   xs = max(amax |x|, 1e-8) * (1/127)                      (f32)
//   xq = int8(round(bf(x) * bf(1 / xs)))
//   h = ((bf(xq . w1q) * s1) * bf(xs)) + b1;  h = h > 0 ? h : alpha * h
//   ah = amax |h|;  hq = int8(round(h * bf(127 / max(ah, 1e-8))))
//   out = ((bf(hq . w2q) * s2) * bf(max(ah, 1e-8) * (1/127))) + b2
// in the output's dtype. round() is half to even and int8() saturates to
// [-128, 127], as XLA's conversion does. The weights come quantized per
// output channel (w1q (N1, K), w2q (K2, N1) int8, torch's (out, in) layout;
// s1, s2, b1, b2, alpha as bf16), made by the wrapper once per weight
// version, as the TPU version makes them in XLA outside its pallas_call. The
// integer sums are exact (int32: depths up to 132,104), and bf(sum) is the
// TPU kernel's acc.astype(bfloat16), which XLA computes as int -> f32 ->
// bf16 (two roundings past 2**24; the plain version does the same on exact
// sums). The bf16 chain runs as
// bf16x2 instructions with round-to-nearest (mul.rn / add.rn, never fused):
// each is the correctly rounded result of the f32 operation on bf16
// operands, which is what the plain version's bf16 tensor ops compute.
//
// What bounds it on the H100: the operations. At the charades site,
// 4 * 24,960 * 256 * 1024 = 26.2 G int8 operations are 13 us at 1,979
// TOP/s; x and out in bf16 and the int8 weights are 26 MB, 8 us at
// 3.35 TB/s. The 51 MB bf16 hidden activation of the unfused FFN is never
// written.
//
// Design. One block of WG warpgroups (128 threads each) per tile of
// R = 64 * WG rows; warpgroup w owns rows [64 w, 64 w + 64) of the tile, so
// every product is a wgmma m64nNk32 .s32.s8.s8 with A and B in shared
// memory.
//   - The weights are staged, never read by a warp from L2 inside a
//     product. The hidden width is walked in chunks of NC columns. The
//     wrapper keeps the int8 weights, once per weight version, in the
//     order the stages hold them (ops/ffn_int8.stage_weights): per chunk,
//     its NC rows of w1q (NC x K) and its NC columns of every output row of
//     w2q (256 x NC), each in wgmma's shared-memory layout. So a stage is
//     two contiguous cp.async.bulk copies issued by one thread, completing
//     on the stage's mbarrier; S stages are in flight. A warp that has
//     read a stage for the last time counts itself off on it (a shared
//     atomic); the last of the block's warps issues the copies of the chunk
//     that stage holds next. The two warpgroups share the stages but never
//     wait for each other otherwise.
//   - What one thread does is predicated PTX, not a branch: ptxas
//     serialises every wgmma of a kernel where a wgmma's registers meet a
//     branch on the thread (its C75xx notes, which chip_smoke.py's build
//     line lists per instance). The k steps of linear1 are unrolled at the
//     model's K = 256, an instance of its own; other K take a runtime loop.
//   - The row amax of h must be known before any hq, and h does not fit a
//     block (128 rows x 1024 x bf16 = 256 KB). So linear1 is computed
//     twice: pass A runs it chunk by chunk for the row amax alone; pass B
//     runs it again (the same exact integer sums, the same chain: a
//     bit-identical h), quantizes the chunk to hq in shared memory and adds
//     its linear2 product (hq chunk . w2q chunk^T) into the output
//     accumulator, 64 x 256 int32 a warpgroup held in registers. That costs
//     1.5x the int8 operations of the function (~7 us more at peak) and
//     buys a 128-row tile, which halves the weight traffic from L2 against
//     64-row tiles.
//   - Each warpgroup waits for each product before it runs the product's
//     epilogue; the tensor cores are kept busy by the other warpgroup,
//     whose epilogue and products interleave with these. (Issuing the next
//     chunk's linear1 into a second accumulator before this chunk's
//     epilogue, or linear2 of a chunk under the next chunk's epilogue, was
//     slower on the H100, and a third warpgroup does not fit the registers.)
//   - A row's hidden columns all lie in the four lanes of one quad of one
//     warp (the wgmma accumulator layout), so the row amax is two shuffles,
//     with no shared atomics.
//   - Scales and biases of linear1 are read through the L1 cache, a chunk
//     at a time, their loads issued while the chunk's products run; those
//     of linear2 sit in shared memory, loaded once per block of 256 output
//     columns. x is
//     quantized with 16-byte loads, 8 rows of a warp in flight at once
//     (element loads where x is not on a 16-byte boundary).
//   - Shared-memory operands use wgmma's canonical K-major layout without
//     swizzle: 8-row x 16-byte core matrices, each 128 contiguous bytes,
//     adjacent in K at 128 bytes (LBO), 8-row groups at K / 16 * 128 bytes
//     (SBO). The quantize pass and the hq epilogue write it directly.
//   - Widths the main instance (WG = 2, NC = 64, 4 stages) cannot stage in
//     a block's 227 KB (K above 384) take a second instance of the same
//     kernel with a 64-row tile, 32-column chunks and 3 stages (WG = 1,
//     NC = 32), chosen by shape before the launch; it holds K up to 1,248.
//     More than 256 outputs repeat pass B per block of 256 output columns
//     (the model has 256). Any K, N1 and K2: the wrapper pads the staged
//     weights with zeros to K rounded up to 32, N1 to its chunks and K2 to
//     blocks of 256 (and the scales and biases, zero, to 64 and 256), x's
//     columns past K are quantized as zeros (element loads where a row is
//     not on a 16-byte boundary), and the outputs are stored column by
//     column where K2 is odd. Padded hidden columns are h = 0 (zero weights,
//     scale and bias), outside every row's amax; padded outputs are not
//     stored. linear1's scales and biases are read from the L1 cache, a
//     chunk at a time, so no table grows with N1.
// Not done: a persistent grid (one tile's x loads under the previous
// tile's epilogue), warp-specialised producers, swizzled layouts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KO = 256;  // output columns per block of linear2: one m64n256 accumulator
constexpr float INV127 = (float)(1.0 / 127.0);  // the f32 the plain version multiplies by

// ---------------------------------------------------------------------------
// bf16x2 arithmetic: one correctly rounded result per half, no contraction
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// bf(lo), bf(hi) as one bf16x2 word (lo in the low half)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ float lo_f(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_f(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }
// bf(x) in both halves
__device__ __forceinline__ uint32_t bcast2(float x) { return pack2(x, x); }

// round half to even, saturated to int8
__device__ __forceinline__ uint32_t to_i8(float v) {
  return (uint32_t)max(-128, min(127, __float2int_rn(v))) & 0xffu;
}
// the two halves of a bf16x2 word as two int8 bytes (the low 16 bits)
__device__ __forceinline__ uint32_t i8pair(uint32_t q) { return to_i8(lo_f(q)) | (to_i8(hi_f(q)) << 8); }

// ((bf(a0, a1) * s) * xs) + b: the dequantization chain of two int32 sums
__device__ __forceinline__ uint32_t dequant(int a0, int a1, uint32_t s, uint32_t xs, uint32_t b) {
  return add2(mul2(mul2(pack2((float)a0, (float)a1), s), xs), b);
}
// PReLU as the plain version writes it: max(h, 0) + alpha * min(h, 0)
__device__ __forceinline__ uint32_t prelu2(uint32_t h, uint32_t al) {
  return add2(max2(h, 0u), mul2(al, min2(h, 0u)));
}

// ---------------------------------------------------------------------------
// shared memory, async copies, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// generic-proxy writes to shared memory become visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across the wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// the 128 threads of warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Matrix descriptor of a K-major operand in the canonical layout without
// swizzle (layout type 0): start address, LBO (the next core matrix in K)
// and SBO (the next 8-row group), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fffu) | ((uint64_t)((lbo >> 4) & 0x3fffu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32);
}
// one k step of 32 bytes is two core matrices: 256 bytes, 16 units
constexpr uint64_t DESC_K_STEP = 16;
// byte offset of (row r, byte k) in the canonical layout with SBO sbo
__device__ __forceinline__ int canon(int r, int k, int sbo) {
  return (r >> 3) * sbo + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

// d (+)= A . B^T, m64n32k32, s8 x s8 -> s32; A and B from shared memory
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B^T, m64n64k32, s8 x s8 -> s32; A and B from shared memory
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B^T, m64n256k32, s8 x s8 -> s32; A and B from shared memory
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// mbarriers and bulk copies: a stage is filled by one thread with
// cp.async.bulk copies that complete on the stage's mbarrier. The kernel
// has no branch that depends on the thread (ptxas serialises every wgmma of
// a kernel that has one): what one thread does is predicated PTX.

// with pred: initialise bar for one arrival
__device__ __forceinline__ void mbar_init(bool pred, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %0, 0;\n@p mbarrier.init.shared::cta.b64 [%1], 1;\n}\n" ::"r"(
          (uint32_t)pred),
      "r"(smem_addr(bar))
      : "memory");
}
// with pred: expect bytes1 + bytes2 on bar, then copy bytes1 from src1 to
// dst1 and, when bytes2 > 0, bytes2 from src2 to dst2
__device__ __forceinline__ void stage_copies(bool pred, uint64_t* bar, void* dst1, const void* src1,
                                             uint32_t bytes1, void* dst2, const void* src2,
                                             uint32_t bytes2) {
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "setp.ne.and.u32 q, %7, 0, p;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%3], [%4], %5, [%1];\n"
      "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%6], [%8], %7, [%1];\n"
      "}\n" ::"r"((uint32_t)pred),
      "r"(smem_addr(bar)), "r"(bytes1 + bytes2), "r"(smem_addr(dst1)), "l"(src1), "r"(bytes1),
      "r"(smem_addr(dst2)), "r"(bytes2), "l"(src2)
      : "memory");
}
// with pred: atomically add 1 to *counter and return its old value, else -2
__device__ __forceinline__ int count_off(bool pred, int* counter) {
  int old;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mov.s32 %0, -2;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p atom.shared.add.s32 %0, [%2], 1;\n"
      "}\n"
      : "=r"(old)
      : "r"((uint32_t)pred), "r"(smem_addr(counter))
      : "memory");
  return old;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Dynamic shared memory of a block of WG warpgroups with NC-column hidden
// chunks and S weight stages, for Kp = K rounded up to 32: the tile's xq,
// the stages (a w1 chunk and a w2 chunk each), an hq chunk a warpgroup,
// linear2's scales and biases per warpgroup (bf16 pairs), each row's
// bf(xs), the stages' mbarriers and release counters.
template <int WG, int NC, int S>
struct Layout {
  int J;  // hidden chunks
  size_t w1_stage, w2_stage, xq, w1, w2, hq, s2, xs, bars, cnt, total;
  __host__ __device__ Layout(int Kp, int N1) {
    J = (N1 + NC - 1) / NC;
    w1_stage = (size_t)NC * Kp;
    w2_stage = (size_t)KO * NC;
    xq = 0;
    w1 = xq + (size_t)64 * WG * Kp;
    w2 = w1 + S * w1_stage;
    hq = w2 + S * w2_stage;
    s2 = hq + (size_t)WG * 64 * NC;  // per warpgroup: KO scales, then KO biases
    xs = s2 + (size_t)WG * 2 * KO * 2;
    bars = xs + (size_t)64 * WG * 4;
    cnt = bars + (size_t)S * 8;
    total = cnt + (size_t)S * 4;
  }
};

// the 8 values x[0..8) as floats, zeros from x[n] on: one 16-byte load of
// bf16, two of float (element loads where the row is not on a 16-byte
// boundary, or where n < 8)
template <typename T>
__device__ __forceinline__ void load8(const T* p, bool aligned, int n, float (&f)[8]);
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, bool aligned, int n, float (&f)[8]) {
  if (aligned && n >= 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lo_f(w[i]);
      f[2 * i + 1] = hi_f(w[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i < n ? __bfloat162float(p[i]) : 0.f;
  }
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, bool aligned, int n, float (&f)[8]) {
  if (aligned && n >= 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i < n ? p[i] : 0.f;
  }
}

// two adjacent outputs from a bf16x2 word (predicated PTX): as one store
// where `pair` (K2 even: the pair is aligned) and both p0 and p1, else
// each half where its own predicate holds
template <typename T>
__device__ __forceinline__ void store2(bool p0, bool p1, bool pair, T* p, uint32_t v);
template <>
__device__ __forceinline__ void store2<bf16>(bool p0, bool p1, bool pair, bf16* p, uint32_t v) {
  asm volatile(
      "{\n.reg .pred w, a, b;\n"
      "setp.ne.u32 w, %0, 0;\nsetp.ne.u32 a, %1, 0;\nsetp.ne.u32 b, %2, 0;\n"
      "@w st.global.b32 [%3], %4;\n"
      "@a st.global.b16 [%3], %5;\n@b st.global.b16 [%6], %7;\n}\n" ::"r"(
          (uint32_t)(p0 && p1 && pair)),
      "r"((uint32_t)(p0 && !pair)), "r"((uint32_t)(p1 && !pair)), "l"(p), "r"(v),
      "h"((unsigned short)(v & 0xffffu)), "l"(p + 1), "h"((unsigned short)(v >> 16))
      : "memory");
}
template <>
__device__ __forceinline__ void store2<float>(bool p0, bool p1, bool pair, float* p, uint32_t v) {
  asm volatile(
      "{\n.reg .pred w, a, b;\n"
      "setp.ne.u32 w, %0, 0;\nsetp.ne.u32 a, %1, 0;\nsetp.ne.u32 b, %2, 0;\n"
      "@w st.global.v2.f32 [%3], {%4, %5};\n"
      "@a st.global.f32 [%3], %4;\n@b st.global.f32 [%6], %5;\n}\n" ::"r"(
          (uint32_t)(p0 && p1 && pair)),
      "r"((uint32_t)(p0 && !pair)), "r"((uint32_t)(p1 && !pair)), "l"(p), "f"(lo_f(v)),
      "f"(hi_f(v)), "l"(p + 1)
      : "memory");
}

// linear1 of one chunk into acc: xq rows . w1 chunk^T over K / 32 k steps,
// KS of them where KS > 0 (unrolled, the wgmma back to back), else ksteps
template <int NC, int KS>
__device__ __forceinline__ void linear1_ops(int (&acc)[NC / 2], uint64_t dx, uint64_t dw,
                                            int ksteps) {
  wgmma_fence();
  auto step = [&](int kk) {
    if constexpr (NC == 64)
      wgmma_n64(acc, dx + kk * DESC_K_STEP, dw + kk * DESC_K_STEP, kk);
    else
      wgmma_n32(acc, dx + kk * DESC_K_STEP, dw + kk * DESC_K_STEP, kk);
  };
  if constexpr (KS > 0) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) step(kk);
  } else {
    for (int kk = 0; kk < ksteps; ++kk) step(kk);
  }
}

// linear2 of one chunk added into acc2: hq chunk . w2 chunk^T over NC / 32
// k steps
template <int NC>
__device__ __forceinline__ void linear2_ops(int (&acc2)[KO / 2], uint64_t dh, uint64_t dw) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NC / 32; ++kk)
    wgmma_n256(acc2, dh + kk * DESC_K_STEP, dw + kk * DESC_K_STEP, 1);
}

// linear1's scales and biases of a thread's columns of one chunk (bf16
// pairs: columns 8 nt + 2t, + 1 of n8 tile nt), read from device memory
// through the L1 cache, issued while the chunk's products run
template <int NC>
struct ChunkScales {
  uint32_t s[NC / 8], b[NC / 8];
  __device__ __forceinline__ void load(const uint32_t* s1t, const uint32_t* b1t, int t) {
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      s[nt] = __ldg(s1t + 4 * nt + t);
      b[nt] = __ldg(b1t + 4 * nt + t);
    }
  }
};

// pass A's epilogue of one chunk: fold |h| of rows lr (A) and lr + 8 (B)
// into mxA, mxB
template <int NC>
__device__ __forceinline__ void amax_chunk(const int (&acc)[NC / 2], const ChunkScales<NC>& sc,
                                           uint32_t xsA, uint32_t xsB, uint32_t al2,
                                           uint32_t& mxA, uint32_t& mxB) {
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const uint32_t s = sc.s[nt], b = sc.b[nt];
    const uint32_t hA = prelu2(dequant(acc[4 * nt], acc[4 * nt + 1], s, xsA, b), al2);
    const uint32_t hB = prelu2(dequant(acc[4 * nt + 2], acc[4 * nt + 3], s, xsB, b), al2);
    mxA = max2(mxA, hA & 0x7fff7fffu);  // |h|, exact
    mxB = max2(mxB, hB & 0x7fff7fffu);
  }
}

// pass B's epilogue of one chunk: hq = int8(round(h * bf(hr))) of rows lr,
// lr + 8 into the warpgroup's hq chunk (canonical layout, SBO sbo_h), two
// n8 tiles at a time, each lane pair swapping halves so that every lane
// stores 4 bytes (4 columns of one tile)
template <int NC>
__device__ __forceinline__ void hq_chunk(const int (&acc)[NC / 2], const ChunkScales<NC>& sc,
                                         int t, int lr, uint32_t xsA, uint32_t xsB, uint32_t hrA,
                                         uint32_t hrB, uint32_t al2, int8_t* hq, int sbo_h) {
#pragma unroll
  for (int n0 = 0; n0 < NC / 8; n0 += 2) {
    const uint32_t sa = sc.s[n0], ba = sc.b[n0], sb = sc.s[n0 + 1], bb = sc.b[n0 + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t xs = half ? xsB : xsA, hr = half ? hrB : hrA;
      const int e = 2 * half;
      const uint32_t pa =
          i8pair(mul2(prelu2(dequant(acc[4 * n0 + e], acc[4 * n0 + e + 1], sa, xs, ba), al2), hr));
      const uint32_t pb = i8pair(
          mul2(prelu2(dequant(acc[4 * n0 + 4 + e], acc[4 * n0 + 5 + e], sb, xs, bb), al2), hr));
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, (t & 1) ? pa : pb, 1);
      const uint32_t word = (t & 1) ? (recv | (pb << 16)) : (pa | (recv << 16));
      const int kcol = ((t & 1) ? n0 + 1 : n0) * 8 + 2 * (t & ~1);
      *reinterpret_cast<uint32_t*>(hq + canon(lr + 8 * half, kcol, sbo_h)) = word;
    }
  }
}

// The weights come staged (ops/ffn_int8.stage_weights): w1s holds, chunk
// after chunk, the NC rows of w1q of each hidden chunk in the canonical
// layout (NC x Kp bytes; zeros past K and N1); w2s, for each block of KO
// output rows and each chunk, those rows' NC columns (KO x NC bytes; zeros
// past K2 and N1). A stage is then two contiguous bulk copies. s1, b1 are
// zero-padded to a multiple of 64 columns, s2, b2 to one of KO.
template <typename T, int WG, int NC, int S, int KS>
__global__ void __launch_bounds__(128 * WG, 1)
ffn_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1s,
                const bf16* __restrict__ s1, const bf16* __restrict__ b1,
                const bf16* __restrict__ alpha, const int8_t* __restrict__ w2s,
                const bf16* __restrict__ s2, const bf16* __restrict__ b2, T* __restrict__ out,
                int N, int K, int N1, int K2) {
  constexpr int THREADS = 128 * WG, R = 64 * WG;
  const int Kp = (K + 31) & ~31;
  const Layout<WG, NC, S> lay(Kp, N1);
  const int J = lay.J, NOB = (K2 + KO - 1) / KO, items = J * (1 + NOB);
  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int sbo_x = Kp * 8;  // xq and a w1 stage: Kp / 16 core matrices per 8-row group
  const int sbo_h = NC * 8;  // an hq chunk and a w2 stage: NC / 16
  const int ksteps = Kp / 32;

  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.xq);
  int8_t* st1 = reinterpret_cast<int8_t*>(smem + lay.w1);
  int8_t* st2 = reinterpret_cast<int8_t*>(smem + lay.w2);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + lay.hq) + wg * 64 * NC;
  const uint32_t* s1t = reinterpret_cast<const uint32_t*>(s1);  // bf16 pairs
  const uint32_t* b1t = reinterpret_cast<const uint32_t*>(b1);
  uint32_t* s2t = reinterpret_cast<uint32_t*>(smem + lay.s2) + wg * KO;  // KO / 2 scales, KO / 2 biases
  uint32_t* b2t = s2t + KO / 2;
  uint32_t* xs_row = reinterpret_cast<uint32_t*>(smem + lay.xs);  // bf(xs), both halves
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  int* released = reinterpret_cast<int*>(smem + lay.cnt);

  // Items: pass A's chunks 0 .. J - 1 (a w1 chunk), then pass B's chunks
  // of each output block (a w1 and a w2 chunk). Item i lives in stage
  // i % S; with pred, the calling thread issues its copies.
  auto issue = [&](bool pred, int i) {
    const int s = i % S;
    const bool b = i >= J;
    const int j = b ? (i - J) % J : i;
    stage_copies(pred, full + s, st1 + s * lay.w1_stage, w1s + (size_t)j * lay.w1_stage,
                 (uint32_t)lay.w1_stage, st2 + s * lay.w2_stage,
                 w2s + (size_t)(b ? i - J : 0) * lay.w2_stage, b ? (uint32_t)lay.w2_stage : 0u);
  };
  // item i's stage has landed
  auto wait_full = [&](int i) { mbar_wait(full + i % S, (uint32_t)((i / S) & 1)); };
  // The warp has read item i's stage for the last time: its lane 0 counts
  // the warp off on the stage, and the last of the block's warps issues the
  // copies of item i + S into it.
  auto release = [&](int i) {
    const int s = i % S;
    __syncwarp();
    const int old = count_off(lane == 0, released + s);
    issue(old == 4 * WG * (i / S + 1) - 1 && i + S < items, i + S);
  };

  for (int s = 0; s < S; ++s) {
    mbar_init(tid == 0, full + s);
    released[s] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < S && i < items; ++i) issue(tid == 0, i);

  // linear2's scales and biases of the first output block (zero past K2:
  // the padding)
  static_assert(KO / 2 == 128, "one word of linear2's scales and biases per thread of a warpgroup");
  auto load_s2 = [&](int ob) {
    const int c = tid % 128;
    s2t[c] = __ldg(reinterpret_cast<const unsigned int*>(s2) + ob * KO / 2 + c);
    b2t[c] = __ldg(reinterpret_cast<const unsigned int*>(b2) + ob * KO / 2 + c);
  };
  load_s2(0);
  const uint32_t al2 = bcast2(__bfloat162float(alpha[0]));

  // quantize the tile's rows of x, 8 rows of a warp at a time; rows past N
  // repeat row N - 1 and are not stored; columns past K are zeros
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (K * sizeof(T)) % 16 == 0;
  constexpr int RB = 8;
  for (int rb = warp * 16; rb < warp * 16 + 16; rb += RB) {
    float ax[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) ax[u] = 0.f;
    for (int c0 = 0; c0 < Kp / 8; c0 += 32) {
      const int c = min(c0 + lane, Kp / 8 - 1);  // past the row: a repeat of its last chunk
      float f[RB][8];
#pragma unroll
      for (int u = 0; u < RB; ++u)
        load8(x + (size_t)min(r0 + rb + u, N - 1) * K + 8 * c, aligned, K - 8 * c, f[u]);
#pragma unroll
      for (int u = 0; u < RB; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e) ax[u] = fmaxf(ax[u], fabsf(f[u][e]));
    }
    uint32_t inv2[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ax[u] = fmaxf(ax[u], __shfl_xor_sync(0xffffffffu, ax[u], o));
      const float xs = fmaxf(ax[u], 1e-8f) * INV127;
      inv2[u] = bcast2(1.0f / xs);
      xs_row[rb + u] = bcast2(xs);  // the same word from every lane
    }
    for (int c0 = 0; c0 < Kp / 8; c0 += 32) {
      const int c = min(c0 + lane, Kp / 8 - 1);
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        float f[8];
        load8(x + (size_t)min(r0 + rb + u, N - 1) * K + 8 * c, aligned, K - 8 * c, f);
        uint32_t qb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) qb[e] = i8pair(mul2(pack2(f[2 * e], f[2 * e + 1]), inv2[u]));
        *reinterpret_cast<uint2*>(xq + canon(rb + u, 8 * c, sbo_x)) =
            make_uint2(qb[0] | (qb[1] << 16), qb[2] | (qb[3] << 16));
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  // the thread's rows in the accumulators: lr and lr + 8 of its
  // warpgroup's 64, rows rA and rA + 8 of the tile
  const int lr = 16 * (warp & 3) + g, rA = 64 * wg + lr;
  const uint32_t xsA = xs_row[rA], xsB = xs_row[rA + 8];
  const uint64_t dx = make_desc(xq + wg * 8 * sbo_x, 128, sbo_x);
  const uint64_t dh = make_desc(hq, 128, sbo_h);
  auto dw1 = [&](int i) { return make_desc(st1 + (i % S) * lay.w1_stage, 128, sbo_x); };
  auto dw2 = [&](int i) { return make_desc(st2 + (i % S) * lay.w2_stage, 128, sbo_h); };

  // Pass A: each row's amax |h|
  int acc1[NC / 2];
  uint32_t mxA = 0u, mxB = 0u;
  for (int j = 0; j < J; ++j) {
    wait_full(j);
    linear1_ops<NC, KS>(acc1, dx, dw1(j), ksteps);
    wgmma_commit();
    ChunkScales<NC> sc;
    sc.load(s1t + j * NC / 2, b1t + j * NC / 2, t);
    wgmma_wait<0>();
    fence_regs(acc1);
    release(j);
    amax_chunk<NC>(acc1, sc, xsA, xsB, al2, mxA, mxB);
  }
  float ahA = fmaxf(lo_f(mxA), hi_f(mxA)), ahB = fmaxf(lo_f(mxB), hi_f(mxB));
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {  // the row's other columns are in the quad
    ahA = fmaxf(ahA, __shfl_xor_sync(0xffffffffu, ahA, o));
    ahB = fmaxf(ahB, __shfl_xor_sync(0xffffffffu, ahB, o));
  }
  ahA = fmaxf(ahA, 1e-8f);
  ahB = fmaxf(ahB, 1e-8f);
  const uint32_t hrA = bcast2(127.0f / ahA), hrB = bcast2(127.0f / ahB);
  const uint32_t hsA = bcast2(ahA * INV127), hsB = bcast2(ahB * INV127);

  // Pass B, per block of KO output columns: linear1 again, its hq chunk,
  // and linear2 of the chunk into acc2
  for (int ob = 0; ob < NOB; ++ob) {
    int acc2[KO / 2];
#pragma unroll
    for (int e = 0; e < KO / 2; ++e) acc2[e] = 0;
    if (ob > 0) {  // the warpgroup's scales of the previous block are read
      warpgroup_sync(wg);
      load_s2(ob);
      warpgroup_sync(wg);
    }
    for (int j = 0; j < J; ++j) {
      const int i = J + ob * J + j;
      wait_full(i);
      linear1_ops<NC, KS>(acc1, dx, dw1(i), ksteps);
      wgmma_commit();
      ChunkScales<NC> sc;
      sc.load(s1t + j * NC / 2, b1t + j * NC / 2, t);
      wgmma_wait<0>();
      fence_regs(acc1);
      hq_chunk<NC>(acc1, sc, t, lr, xsA, xsB, hrA, hrB, al2, hq, sbo_h);
      fence_async_smem();
      warpgroup_sync(wg);
      linear2_ops<NC>(acc2, dh, dw2(i));
      wgmma_commit();
      wgmma_wait<0>();  // also frees hq for the next chunk
      fence_regs(acc2);
      release(i);
    }
    // out = ((bf(acc2) * s2) * bf(hs)) + b2 for the rows below N and the
    // columns below K2 (pairs where K2 is even, else column by column)
    const bool pair = (K2 & 1) == 0;
#pragma unroll
    for (int nt = 0; nt < KO / 8; ++nt) {
      if (ob * KO + nt * 8 >= K2) break;
      const int c = nt * 8 + 2 * t, col = ob * KO + c;
      const uint32_t s = s2t[c >> 1], b = b2t[c >> 1];
      const bool in0 = col < K2, in1 = col + 1 < K2;
      store2(r0 + rA < N && in0, r0 + rA < N && in1, pair, out + (size_t)(r0 + rA) * K2 + col,
             dequant(acc2[4 * nt], acc2[4 * nt + 1], s, hsA, b));
      store2(r0 + rA + 8 < N && in0, r0 + rA + 8 < N && in1, pair,
             out + (size_t)(r0 + rA + 8) * K2 + col,
             dequant(acc2[4 * nt + 2], acc2[4 * nt + 3], s, hsB, b));
    }
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes a block may use on sm_90

// the instances: 128-row tiles with 64-column chunks and 4 stages, with the
// k steps of the model's K = 256 unrolled, or any K; 64-row tiles with
// 32-column chunks and 3 stages where the 128-row tile does not fit. Kp is
// K rounded up to 32.
typedef Layout<2, 64, 4> MainLayout;
typedef Layout<1, 32, 3> SmallLayout;
int padded(int K) { return (K + 31) & ~31; }
bool main_fits(int K, int N1) { return MainLayout(padded(K), N1).total <= MAX_SMEM; }
// the int32 sums stay exact: 128 * 127 * depth < 2**31
constexpr int MAX_DEPTH = 132104;

template <typename T, int WG, int NC, int S, int KS>
int launch(const void* x, const void* w1s, const void* s1, const void* b1, const void* alpha,
           const void* w2s, const void* s2, const void* b2, void* out, int N, int K, int N1,
           int K2, cudaStream_t stream) {
  const size_t smem = Layout<WG, NC, S>(padded(K), N1).total;
  const auto kernel = ffn_int8_kernel<T, WG, NC, S, KS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(N + 64 * WG - 1) / (64 * WG), 128 * WG, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w1s), static_cast<const bf16*>(s1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(alpha),
      static_cast<const int8_t*>(w2s), static_cast<const bf16*>(s2),
      static_cast<const bf16*>(b2), static_cast<T*>(out), N, K, N1, K2);
  return (int)cudaGetLastError();
}

template <typename T>
int route(const void* x, const void* w1s, const void* s1, const void* b1, const void* alpha,
          const void* w2s, const void* s2, const void* b2, void* out, int N, int K, int N1,
          int K2, cudaStream_t s) {
  if (padded(K) == 256 && main_fits(K, N1))
    return launch<T, 2, 64, 4, 8>(x, w1s, s1, b1, alpha, w2s, s2, b2, out, N, K, N1, K2, s);
  if (main_fits(K, N1))
    return launch<T, 2, 64, 4, 0>(x, w1s, s1, b1, alpha, w2s, s2, b2, out, N, K, N1, K2, s);
  return launch<T, 1, 32, 3, 0>(x, w1s, s1, b1, alpha, w2s, s2, b2, out, N, K, N1, K2, s);
}

}  // namespace

// Shared memory a block needs for K inputs and N1 hidden units (bytes): the
// main instance's where it fits, else the 64-row instance's, so the wrapper
// can refuse before launching.
extern "C" long long ffn_int8_smem_bytes(int K, int N1) {
  return main_fits(K, N1) ? (long long)MainLayout(padded(K), N1).total
                          : (long long)SmallLayout(padded(K), N1).total;
}

// Hidden columns per chunk of the instance the launch for K, N1 takes (64 or
// 32): the wrapper stages the weights for it (ops/ffn_int8.stage_weights).
extern "C" int ffn_int8_chunk_cols(int K, int N1) { return main_fits(K, N1) ? 64 : 32; }

// Plain C entry point, bound with ctypes. x: (N, K) and out: (N, K2), both
// bf16 (is_bf16 = 1) or both float32, contiguous; w1s and w2s the int8
// weights staged for ffn_int8_chunk_cols(K, N1) columns a chunk, on 16-byte
// boundaries; s1, b1: N1 zero-padded to a multiple of 64, s2, b2: K2
// zero-padded to a multiple of 256, and alpha: (1,), bf16 on 4-byte
// boundaries. Any K, N1 and K2 up to MAX_DEPTH whose tile fits
// (ffn_int8_smem_bytes). Returns the cudaError_t of the launch (0 = success).
extern "C" int ffn_int8_launch(const void* x, const void* w1s, const void* s1, const void* b1,
                               const void* alpha, const void* w2s, const void* s2, const void* b2,
                               void* out, int N, int K, int N1, int K2, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || K <= 0 || N1 <= 0 || K2 <= 0 || K > MAX_DEPTH || N1 > MAX_DEPTH ||
      ffn_int8_smem_bytes(K, N1) > (long long)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return route<bf16>(x, w1s, s1, b1, alpha, w2s, s2, b2, out, N, K, N1, K2, s);
  return route<float>(x, w1s, s1, b1, alpha, w2s, s2, b2, out, N, K, N1, K2, s);
}
