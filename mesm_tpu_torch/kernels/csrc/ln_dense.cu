// Fused LayerNorm -> Dense (-> ReLU) for Hopper (sm_90a) on wgmma: the bf16
// product in bf16, the float32 product in 3xTF32.
//
// Replaces: mesm_tpu/ops/layer_pallas.py::fused_ln_dense / _ln_dense_kernel
// (:267-287), the input projection of the raw video features (LinearBlock
// with a LayerNorm on the input; charades bf16: N = NG*Lv ~ 10,282 rows,
// D = 2818, F = 256; TACoS fp32: 3,600 rows of D = 4098).
//
// What it computes, at the TPU kernel's rounding points (ops/ln_dense.py
// ln_dense_reference is its plain version):
//   per row: f32 mean and E[x^2]; var = E[x^2] - mean^2 (unclamped);
//   y = (x - mean) * (1 / sqrt(var + eps)), then y * gamma, then + beta
//       (f32 gamma, beta; each step rounded to f32, none fused)
//   y is rounded to the input dtype;
//   out = y @ W^T with f32 accumulation, + f32 bias, optional ReLU,
//   cast to the input dtype.
// The normalisation is never folded into W: that would move the rounding
// of y.
//
// What bounds it on the H100: in bf16 the bytes. x is 58 MB at charades
// (17 us at 3.35 TB/s), out 5 MB, W 1.4 MB; the 14.8 GFLOP of the product
// are 15 us at the bf16 tensor-core rate. In float32 the operations: 7.6
// GFLOP at TACoS are 113 us at the 67 TFLOP/s of fp32 without tensor
// cores; three TF32 products (3xTF32) are 46 us at 495 TFLOP/s.
//
// Design.
//   - Two launches on the stream. ln_stats_kernel, one warp a row, reads
//     x once (16-byte loads where a row is on a 16-byte boundary, else the
//     widest its address allows) and writes each row's f32 mean and
//     1 / sqrt(var + eps), summed in an order fixed by the elements'
//     indices, so a row gets the same statistics at any address (the
//     coalesced eval step projects K batches' rows in one call):
//     the statistics must be known before the first K tile of a row is
//     normalised, and a pass of its own reads x at the full memory rate,
//     where a sweep inside the product kernel would be one more stream for
//     its copies to wait on. x is read twice from device memory at most
//     (116 MB at charades, ~35 us).
//   - ln_dense_wgmma_kernel: a persistent grid, one block an SM, each
//     block walking tiles of BM rows x FN output columns (bf16 128 x 256,
//     fp32 64 x 128; more outputs take more column tiles, the last of each
//     ragged), from the last row tile. Three warpgroups:
//       the producer fills a ring of STAGES stages, one K tile (one
//       128-byte row of K: 64 bf16, 32 fp32) each: the weight's tile by
//       cp.async.bulk.tensor (TMA) of FN rows x 128 bytes of the cached
//       padded weight (torch layout, F x DP, K-major as wgmma wants it)
//       through a tensor map with 128-byte swizzle, which zero-fills
//       columns past D and rows past F; and the raw K tile of x, each row's
//       128 bytes as the 9 16-byte chunks around them (a row starts on any
//       4- or 2-byte boundary: D = 2818 bf16 rows are 5,636 bytes), by
//       cp.async with the L2's 256-byte prefetch (the row's next K tile),
//       and in bf16 the K tile's gamma and beta. Two consumers normalise
//       their rows of the stage's raw K tile with the rows' statistics
//       (staged per tile in shared memory, with each row's offset in a raw
//       K tile) and multiply the stage:
//         bf16: each consumer its own 64 rows x 256 columns on wgmma
//         m64n256k16 (f32 accumulators in 128 registers) with A from
//         registers: a lane normalises its A fragment's elements and rounds
//         them to bf16 straight into the registers a k step's wgmma reads,
//         one wgmma group a k step, and rewrites a k step's registers once
//         its group of the previous K tile is done (up to 3 groups in
//         flight); no A tile, no barrier a K tile. ptxas notes (C7513) that
//         it serialises these wgmma, since registers they read are written
//         between them; waiting for every group before writing any was
//         slower on the H100 (and short of registers);
//         fp32: both consumers on the same 64 rows, each its 64 of the 128
//         columns (wgmma m64n64k8, tf32); their halves of the rows are
//         normalised, split and written into the stage's A tiles (hi, lo) in
//         the 128-byte-swizzled K-major layout wgmma reads (16-byte chunk c
//         of row r at chunk c ^ (r % 8)), K tile j + 1 while K tile j's
//         products run.
//     Each stage has a full mbarrier (the TMA's bytes, and the producer's
//     128 lanes, each arriving when its copies have landed) and an empty
//     one (one arrival from each of the 8 consumer warps after its wgmma
//     have read the stage). The producer fills stages ahead, so one tile's
//     epilogue (bias from shared memory, ReLU, rounding, stores) runs while
//     the next tile's copies land.
//   - fp32 (3xTF32, as the attention backward): each value x splits into
//     hi = tf32(x) (round to nearest, ties away) and lo = tf32(x - hi), and
//     a product is lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, the small terms
//     first (lo . lo, ~2^-22 of it, is dropped). The weight is split once
//     per weight version by the wrapper (two cached arrays, two tensor
//     maps; splitting each staged tile in shared memory instead was slower
//     on the H100); a consumer splits each y once as it writes it. The
//     tensor cores truncate their sums, so each K tile's 12 wgmma (4 k
//     steps x 3) start from zero and the consumer adds that partial sum to
//     its running f32 sum on the CUDA cores, a K tile at a time.
//   - What a thread does differently from its warpgroup near a wgmma is
//     predicated PTX (the empty-barrier arrivals, the epilogue's stores):
//     ptxas serialises the wgmma of a kernel where their registers meet a
//     branch on the thread. Only one warpgroup produces: a kernel of 512
//     threads gets 128 registers a thread from ptxas, whatever setmaxnreg
//     asks, and the bf16 accumulators need more.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// the row statistics
// ---------------------------------------------------------------------------

constexpr int STATS_THREADS = 256;
constexpr int STATS_ROWS = STATS_THREADS / 32;  // one warp a row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// a lane's sums of x and x^2 over its elements of one row: chunk j, the
// elements [j * VEC, (j + 1) * VEC), goes to lane j % 32, each chunk summed
// in element order, then the lane's element of the ragged tail. Which
// element a lane adds, and when, depends on the element's index alone, so a
// row's statistics are the same bits wherever the row lies in memory (a row
// of D = 2818 bf16 starts on any 4-byte boundary). L is the load: 16 bytes
// where the row is 16-byte aligned, else the widest its address allows.
template <typename T, typename L>
__device__ __forceinline__ void row_sums(const T* __restrict__ xrow, int D, int lane, float& s,
                                         float& ss) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER = sizeof(L) / sizeof(T);  // elements a load
  const int nchunk = D / VEC;
  for (int j = lane; j < nchunk; j += 32) {
    const L* p = reinterpret_cast<const L*>(xrow + (size_t)j * VEC);
#pragma unroll
    for (int l = 0; l < VEC / PER; ++l) {
      const L u = __ldg(p + l);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const float v = to_f(e[t]);
        s += v;
        ss += v * v;
      }
    }
  }
  const int c = nchunk * VEC + lane;  // the tail: fewer than VEC elements
  if (c < D) {
    const float v = to_f(xrow[c]);
    s += v;
    ss += v * v;
  }
}

// mean and 1 / sqrt(var + eps) of each row of x (N, D), var = E[x^2] -
// mean^2 unclamped, as float2 (mean, rstd)
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
ln_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int N, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * STATS_ROWS + threadIdx.x / 32;
  if (n >= N) return;
  const T* xrow = x + (size_t)n * D;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(xrow);
  float s = 0.f, ss = 0.f;
  if ((addr & 15) == 0) {
    row_sums<T, uint4>(xrow, D, lane, s, ss);
  } else if ((addr & 7) == 0) {
    row_sums<T, uint2>(xrow, D, lane, s, ss);
  } else if ((addr & 3) == 0) {
    row_sums<T, unsigned int>(xrow, D, lane, s, ss);
  } else {
    row_sums<T, T>(xrow, D, lane, s, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    const float mu = s / (float)D;
    const float var = ss / (float)D - mu * mu;  // unclamped, as the TPU kernel
    stats[n] = make_float2(mu, 1.0f / sqrtf(var + eps));
  }
}

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// with pred: one arrival on bar (predicated PTX, no branch on the thread)
__device__ __forceinline__ void mbar_arrive_if(bool pred, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %0, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%1];\n}\n" ::
          "r"((uint32_t)pred),
      "r"(smem_addr(bar))
      : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies on bar
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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

// rows [c1, c1 + box rows) x columns [c0, c0 + box columns) of the tensor
// `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory become visible to the async proxy
// that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// consumer warpgroup wg's own barrier (barrier 0 is __syncthreads), and
// both consumers'
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// Matrix descriptor of a K-major operand in the 128-byte swizzled layout
// (layout type 1): 128-byte rows, 8-row groups 1024 bytes apart (SBO; LBO
// is not read for this layout), the tile on a 1024-byte boundary. A k step
// of 32 bytes advances the start address by 2 (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fffu) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr uint64_t DESC_K_STEP = 2;

// d (+)= A . B^T, m64n256k16, bf16; A from registers (the m16n8k16 A fragment
// of the warp's 16 rows: a0 rows g cols 2t, 2t + 1; a1 row g + 8; a2, a3
// the same at cols + 8), B from shared memory (B128 descriptor);
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_bf16_n256_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
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
      " %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A . B^T, m64n64k8, tf32; A and B from shared memory (B128
// descriptors); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// the product kernel
// ---------------------------------------------------------------------------

constexpr int WG = 128;          // threads a warpgroup
constexpr int THREADS = 3 * WG;  // two consumer warpgroups, then the producer
constexpr int ROW_BYTES = 128;   // a row's K tile: one 128-byte swizzle row

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BM = 128;  // rows a tile: 64 a consumer
  static constexpr int FN = 256;  // output columns a tile: all of them a consumer
  static constexpr int STAGES = 4;
  static constexpr int PARTS = 1;      // operands whole
  static constexpr bool A_REGS = true;  // A from registers: no A tile
};
template <>
struct Cfg<float> {
  static constexpr int BM = 64;   // both consumers on the same rows
  static constexpr int FN = 128;  // 64 columns a consumer
  static constexpr int STAGES = 3;
  static constexpr int PARTS = 2;  // operands as hi and lo
  static constexpr bool A_REGS = false;
};
// A row's K tile of x (128 bytes from any 4- or 2-byte boundary) is copied
// as the RAW_CHUNKS 16-byte chunks around it.
constexpr int RAW_CHUNKS = ROW_BYTES / 16 + 1;
constexpr int RAW_ROW = 16 * RAW_CHUNKS;

// Dynamic shared memory: STAGES stages, each the A parts (BM x 128 bytes;
// none where A comes from registers), the B parts (FN x 128 bytes), the raw
// K tile of x (BM x RAW_ROW bytes, as copied) and, where A comes from
// registers, the K tile's gamma and beta (f32); the tile's row statistics;
// the tile's bias, a copy a consumer; the full and empty mbarriers. The base
// is rounded up to 1024 bytes.
template <typename T>
struct Layout {
  static constexpr int BK = ROW_BYTES / sizeof(T);  // K a stage
  static constexpr int A_PART = Cfg<T>::BM * ROW_BYTES;
  static constexpr int B_PART = Cfg<T>::FN * ROW_BYTES;
  static constexpr int RAW_TILE = Cfg<T>::BM * RAW_ROW;
  static constexpr int B_AT = Cfg<T>::A_REGS ? 0 : Cfg<T>::PARTS * A_PART;  // in a stage
  static constexpr int RAW_AT = B_AT + Cfg<T>::PARTS * B_PART;             // in a stage
  static constexpr int GB_AT = RAW_AT + RAW_TILE;                          // in a stage
  static constexpr int STAGE = (GB_AT + (Cfg<T>::A_REGS ? 2 * BK * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = Cfg<T>::PARTS * B_PART;  // a stage's TMA bytes
  static constexpr int STATS = Cfg<T>::STAGES * STAGE;
  static constexpr int BIAS = STATS + Cfg<T>::BM * 16;
  static constexpr int BARS = BIAS + 2 * Cfg<T>::FN * 4;
  static constexpr int TOTAL = BARS + 2 * Cfg<T>::STAGES * 8;  // full[STAGES], empty[STAGES]
  static constexpr int SMEM = TOTAL + 1024;
};

// the tensor-core parts of a value: tf32(x) rounded to nearest, ties away
// from zero (cvt.rna.tf32.f32 in two integer instructions), and the rest
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// cp.async of 16 bytes to dst from src (both on 16-byte boundaries): the
// first `n` (0-16) are read from src, the rest are zeros (src is not read
// past them); the L2 fetches the 256 bytes around src from device memory
// (the row's next K tile)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
// one arrival on bar once every cp.async this thread issued has landed
// (bar's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// elements c, c + 1 of a row from its raw copy at p (the pair's first
// byte); PAIRS: the pair is one aligned word (bf16) or two (float), else
// (odd D in bf16) two halves
template <bool PAIRS>
__device__ __forceinline__ float2 read_pair(const unsigned char* p, bf16) {
  uint32_t u;
  if (PAIRS) {
    u = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    u = (uint32_t)h[0] | ((uint32_t)h[1] << 16);
  }
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
template <bool PAIRS>
__device__ __forceinline__ float2 read_pair(const unsigned char* p, float) {
  const float* f = reinterpret_cast<const float*>(p);
  return make_float2(f[0], f[1]);
}

// bf16(lo), bf16(hi) as one bf16x2 word (lo in the low half)
__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// y of the plain version: ((x - mean) * rstd) * gamma + beta, each step
// rounded to f32 (no contraction)
__device__ __forceinline__ float normalize(float x, float2 st, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, st.x), st.y), g), b);
}

// Store the normalised pair (y0, y1) of tile row r (r8 = r % 8) at byte
// `b` of its 128-byte K tile into the A parts of an fp32 stage, swizzled
// and split: hi in the first part, lo in the second.
__device__ __forceinline__ void store_a(unsigned char* A, int r, int r8, int b, float y0,
                                        float y1) {
  constexpr int A_PART = Cfg<float>::BM * ROW_BYTES;
  const int off = r * ROW_BYTES + ((((b >> 4) ^ r8) << 4) | (b & 15));
  const float h0 = tf32(y0), h1 = tf32(y1);
  *reinterpret_cast<float2*>(A + off) = make_float2(h0, h1);
  *reinterpret_cast<float2*>(A + A_PART + off) = make_float2(tf32(y0 - h0), tf32(y1 - h1));
}

// with pred: out[i], out[i + 1] = v0, v1 (pair: one store, else two). No
// memory clobber: nothing in the thread reads out, and the epilogue's bias
// loads may then issue ahead of the stores
__device__ __forceinline__ void store_out(bool p0, bool p1, bool pair, bf16* o, float v0, float v1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
  asm volatile(
      "{\n.reg .pred p, q, w;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "setp.ne.u32 w, %2, 0;\n"
      "@w bra.uni PAIR;\n"
      "@p st.global.b16 [%3], %4;\n"
      "@q st.global.b16 [%3+2], %5;\n"
      "bra.uni DONE;\n"
      "PAIR:\n"
      "@p st.global.b32 [%3], %6;\n"
      "DONE:\n}\n" ::"r"((uint32_t)p0),
      "r"((uint32_t)p1), "r"((uint32_t)pair), "l"(o), "h"((unsigned short)(u & 0xffffu)),
      "h"((unsigned short)(u >> 16)), "r"(u));
}
__device__ __forceinline__ void store_out(bool p0, bool p1, bool pair, float* o, float v0,
                                          float v1) {
  asm volatile(
      "{\n.reg .pred p, q, w;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "setp.ne.u32 w, %2, 0;\n"
      "@w bra.uni PAIR;\n"
      "@p st.global.f32 [%3], %4;\n"
      "@q st.global.f32 [%3+4], %5;\n"
      "bra.uni DONE;\n"
      "PAIR:\n"
      "@p st.global.v2.f32 [%3], {%4, %5};\n"
      "DONE:\n}\n" ::"r"((uint32_t)p0),
      "r"((uint32_t)p1), "r"((uint32_t)pair), "l"(o), "f"(v0), "f"(v1));
}

// The consumer's epilogue: acc (the wgmma accumulator layout: register
// 4 j + i holds row 16 w + g + 8 (i / 2), column 8 j + 2 t + i % 2 of the
// warpgroup's 64 x NC block, lane = 4 g + t) + bias, ReLU, rounded to T,
// stored where inside (N, F). bias_s: the bias of the block's columns c0 ..
// in shared memory.
template <typename T, int NC>
__device__ __forceinline__ void epilogue(const float (&acc)[NC / 2], const float* bias_s,
                                         T* __restrict__ out, int r0, int c0, int N, int F,
                                         int relu) {
  const int w = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int ra = r0 + 16 * w + (lane >> 2), rb = ra + 8;
  const bool pair = (F & 1) == 0;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int cl = 8 * j + 2 * (lane & 3), col = c0 + cl;
    const float b0 = bias_s[cl], b1 = bias_s[cl + 1];
    float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
    if (relu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
    }
    store_out(ra < N && col < F, ra < N && col + 1 < F, pair, out + (size_t)ra * F + col, v[0],
              v[1]);
    store_out(rb < N && col < F, rb < N && col + 1 < F, pair, out + (size_t)rb * F + col, v[2],
              v[3]);
  }
}

// One block: the producer warpgroup fills the ring (x and the weight), the
// two consumer warpgroups normalise the rows, run the products and the
// epilogues, tile after tile (the last row tile first). map0: the cached
// weight (bf16) or its tf32 hi part (fp32); map1: its lo part (fp32; map0
// again in bf16). stats: (N,) float2 of ln_stats_kernel.
template <typename T, bool PAIRS>
__global__ void __launch_bounds__(THREADS, 1)
ln_dense_wgmma_kernel(const __grid_constant__ CUtensorMap map0,
                      const __grid_constant__ CUtensorMap map1, const T* __restrict__ x,
                      const float2* __restrict__ stats, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ bias,
                      T* __restrict__ out, int N, int D, int F, int relu) {
  using L = Layout<T>;
  constexpr int BM = Cfg<T>::BM, FN = Cfg<T>::FN, S = Cfg<T>::STAGES, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float4* tstats = reinterpret_cast<float4*>(smem + L::STATS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;
  auto stage = [&](int s) { return smem + s * L::STAGE; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer's lanes (their copies of x landed) and the TMA's arrival
      mbar_init(&full[s], WG + 1);
      mbar_init(&empty[s], 2 * WG / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int KT = (D + BK - 1) / BK;
  const int FT = (F + FN - 1) / FN;
  const int tiles = (N + BM - 1) / BM * FT;
  const int first = tiles - 1 - (int)blockIdx.x;
  const int wg = threadIdx.x / WG;
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  int s = 0;
  uint32_t ph = 0;

  if (wg == 2) {
    // the producer: for each K tile of each of the block's tiles, once the
    // consumers have released its stage, the weight's tile by TMA and the
    // raw K tile of the tile's rows by cp.async (each lane RAW_CHUNKS of
    // the BM x RAW_CHUNKS 16-byte chunks; rows past N and the bytes past
    // x's end are zeros, not read)
    const int pt = threadIdx.x - 2 * WG;
    const uintptr_t xend = xb + (uintptr_t)N * D * sizeof(T);
    for (int t = first; t >= 0; t -= (int)gridDim.x) {
      const int row0 = t / FT * BM, f0 = t % FT * FN;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = stage(s);
        if (pt == 0) {
          mbar_arrive_expect(&full[s], L::B_BYTES);
          tma_load_2d(st + L::B_AT, &map0, &full[s], kt * BK, f0);
          if (Cfg<T>::PARTS == 2) tma_load_2d(st + L::B_AT + L::B_PART, &map1, &full[s], kt * BK, f0);
        }
#pragma unroll
        for (int e = pt; e < BM * RAW_CHUNKS; e += WG) {
          const int r = e / RAW_CHUNKS, q = e % RAW_CHUNKS;
          const uintptr_t a = xb + ((size_t)(row0 + r) * D + (size_t)kt * BK) * sizeof(T);
          const uintptr_t src = (a & ~(uintptr_t)15) + 16 * q;
          const bool in = row0 + r < N && src < xend;
          cp_async16_zfill(st + L::RAW_AT + r * RAW_ROW + 16 * q,
                           reinterpret_cast<const void*>(in ? src : xb),
                           in ? (int)min((uintptr_t)16, xend - src) : 0);
        }
        if (Cfg<T>::A_REGS && pt < 32) {
          // the K tile's gamma (chunks 0-15) and beta (16-31), zeros past D
          const int c = kt * BK + 4 * (pt % 16);
          const float* src = (pt < 16 ? gamma : beta) + c;
          cp_async16_zfill(st + L::GB_AT + 16 * pt, c < D ? src : gamma,
                           c < D ? 4 * min(4, D - c) : 0);
        }
        cp_async_arrive(&full[s]);
        if (++s == S) s = 0, ph ^= 1;
      }
    }
  } else {
    // the consumers: each normalises its NR rows of the tile (bf16: its
    // own 64; fp32: half of the 64 both multiply) from the stages' raw K
    // tiles and runs the stages' products
    constexpr int NR = BM / 2;
    const int lane = threadIdx.x % 32;
    float* bias_s = reinterpret_cast<float*>(smem + L::BIAS) + wg * FN;
    for (int t = first; t >= 0; t -= (int)gridDim.x) {
      const int row0 = t / FT * BM, f0 = t % FT * FN;
      // the tile's bias and its rows' statistics, in shared memory
      consumer_sync(wg);  // the previous tile's reads of them are done
      for (int i = threadIdx.x % WG; i < FN; i += WG) bias_s[i] = f0 + i < F ? bias[f0 + i] : 0.f;
      for (int i = threadIdx.x % WG; i < NR; i += WG) {
        // the row's K tile starts (every K tile alike: 128 is a multiple
        // of 16) misaligned by this much in its raw copy
        const int r = wg * NR + i;
        const int mis = (int)((uint32_t)xb + (uint32_t)(row0 + r) * (uint32_t)(D * sizeof(T))) & 15;
        const float2 m = row0 + r < N ? stats[row0 + r] : make_float2(0.f, 0.f);
        tstats[r] = make_float4(m.x, m.y, __int_as_float(r * RAW_ROW + mis), 0.f);
      }
      consumer_sync(wg);
      if constexpr (Cfg<T>::A_REGS) {
        // rows 64 wg .. of the tile, all FN columns. A lane normalises its
        // A fragment's elements (rows g and g + 8 of its warp's 16, columns
        // 2t, 2t + 1, 2t + 8, 2t + 9 of each k step) straight into
        // registers; each k step is a wgmma group of its own, and a k
        // step's registers are rewritten once its group of the previous K
        // tile is done (at most 3 groups in flight)
        const int g = lane >> 2, t = lane & 3;
        const int ra = 64 * wg + 16 * ((threadIdx.x % WG) / 32) + g;
        const float4 sa = tstats[ra], sb = tstats[ra + 8];
        const float2 ma = make_float2(sa.x, sa.y), mb = make_float2(sb.x, sb.y);
        const int oa = __float_as_int(sa.z) + 4 * t, ob = __float_as_int(sb.z) + 4 * t;
        float acc[128];
        uint32_t a[BK / 16][4];
        int prev = -1;  // the stage whose products may still be in flight
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&full[s], ph);
          const unsigned char* st = stage(s);
          const unsigned char* raw = st + L::RAW_AT;
          const float* gs = reinterpret_cast<const float*>(st + L::GB_AT) + 2 * t;
          const uint64_t db = desc_sw128(st + L::B_AT);
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            wgmma_wait<BK / 16 - 1>();  // a[ks]'s product of the previous K tile is done
            if (ks == BK / 16 - 1 && prev >= 0) mbar_arrive_if(lane == 0, &empty[prev]);
            const int c = kt * BK + 16 * ks + 2 * t;  // columns c, c + 1, c + 8, c + 9
            const float2 g0 = *reinterpret_cast<const float2*>(gs + 16 * ks);
            const float2 g8 = *reinterpret_cast<const float2*>(gs + 16 * ks + 8);
            const float2 b0 = *reinterpret_cast<const float2*>(gs + BK + 16 * ks);
            const float2 b8 = *reinterpret_cast<const float2*>(gs + BK + 16 * ks + 8);
            const float2 xa0 = read_pair<PAIRS>(raw + oa + 32 * ks, T());
            const float2 xb0 = read_pair<PAIRS>(raw + ob + 32 * ks, T());
            const float2 xa8 = read_pair<PAIRS>(raw + oa + 32 * ks + 16, T());
            const float2 xb8 = read_pair<PAIRS>(raw + ob + 32 * ks + 16, T());
            // columns past D are 0
            auto y = [&](float v, float2 m, float gg, float bb, int col) {
              return col < D ? normalize(v, m, gg, bb) : 0.f;
            };
            a[ks][0] = pack2_bf16(y(xa0.x, ma, g0.x, b0.x, c), y(xa0.y, ma, g0.y, b0.y, c + 1));
            a[ks][1] = pack2_bf16(y(xb0.x, mb, g0.x, b0.x, c), y(xb0.y, mb, g0.y, b0.y, c + 1));
            a[ks][2] = pack2_bf16(y(xa8.x, ma, g8.x, b8.x, c + 8), y(xa8.y, ma, g8.y, b8.y, c + 9));
            a[ks][3] = pack2_bf16(y(xb8.x, mb, g8.x, b8.x, c + 8), y(xb8.y, mb, g8.y, b8.y, c + 9));
            wgmma_fence();
            wgmma_bf16_n256_rs(acc, a[ks], db + ks * DESC_K_STEP, kt | ks);
            wgmma_commit();
          }
          prev = s;
          if (++s == S) s = 0, ph ^= 1;
        }
        wgmma_wait<0>();
        mbar_arrive_if(lane == 0, &empty[prev]);
        epilogue<T, 256>(acc, bias_s, out, row0 + 64 * wg, f0, N, F, relu);
      } else {
        // all BM = 64 rows, columns 64 wg ..; each K tile's 3xTF32 partial
        // sum from zero, added to the running sum in f32. The consumer's
        // rows of K tile kt + 1 are normalised and split into the stage's A
        // tile (a lane a pair of a row) while K tile kt's products run
        constexpr int LPR = BK / 2;       // lanes on a row's K tile, a pair each
        constexpr int RPI = 32 / LPR;     // rows a warp normalises at once
        constexpr int IT = NR / 4 / RPI;  // pairs a lane a K tile
        const int rbase = wg * NR + (threadIdx.x % WG) / 32 * (NR / 4) + lane / LPR;
        const int pb = 2 * (lane % LPR);  // the lane's pair in the K tile
        // the lane's gamma and beta of K tile kt (0 past D), loaded a K
        // tile before their use
        auto gamma_beta = [&](int kt) {
          const int c = kt * BK + pb;
          return make_float4(c < D ? __ldg(gamma + c) : 0.f, c + 1 < D ? __ldg(gamma + c + 1) : 0.f,
                             c < D ? __ldg(beta + c) : 0.f, c + 1 < D ? __ldg(beta + c + 1) : 0.f);
        };
        // stage st's A tile from its raw K tile kt; gb: gamma_beta(kt).
        // Every pair is read before any is stored (the reads then issue
        // back to back)
        auto normalize_tile = [&](unsigned char* st, int kt, float4 gb) {
          const int c = kt * BK + pb;
          const bool c0in = c < D, c1in = c + 1 < D;  // columns past D are 0
          const unsigned char* raw = st + L::RAW_AT + pb * (int)sizeof(T);
          float2 v[IT];
          float4 sv[IT];
#pragma unroll
          for (int i = 0; i < IT; ++i) {
            sv[i] = tstats[rbase + i * RPI];
            v[i] = read_pair<PAIRS>(raw + __float_as_int(sv[i].z), T());
          }
#pragma unroll
          for (int i = 0; i < IT; ++i) {
            const float2 m = make_float2(sv[i].x, sv[i].y);
            const float y0 = c0in ? normalize(v[i].x, m, gb.x, gb.z) : 0.f;
            const float y1 = c1in ? normalize(v[i].y, m, gb.y, gb.w) : 0.f;
            const int r8 = (i * RPI + lane / LPR) & 7;  // rbase - lane / LPR: 8 | it
            store_a(st, rbase + i * RPI, r8, pb * (int)sizeof(T), y0, y1);
          }
          fence_async_smem();
          consumers_sync();  // the A tile is whole: both consumers read all of it
        };
        float part[32], run[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) run[i] = 0.f;
        mbar_wait(&full[s], ph);
        normalize_tile(stage(s), 0, gamma_beta(0));
        float4 gb = gamma_beta(1);
        for (int kt = 0; kt < KT; ++kt) {
          unsigned char* st = stage(s);
          const uint64_t dah = desc_sw128(st), dal = desc_sw128(st + L::A_PART);
          const uint64_t dbh = desc_sw128(st + L::B_AT + wg * 64 * ROW_BYTES);
          const uint64_t dbl = desc_sw128(st + L::B_AT + L::B_PART + wg * 64 * ROW_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const uint64_t o = kk * DESC_K_STEP;
            wgmma_tf32_n64(part, dal + o, dbh + o, kk);  // lo . hi first, from zero
            wgmma_tf32_n64(part, dah + o, dbl + o, 1);   // hi . lo
            wgmma_tf32_n64(part, dah + o, dbh + o, 1);   // hi . hi
          }
          wgmma_commit();
          const int s1 = s + 1 == S ? 0 : s + 1;
          const uint32_t ph1 = s + 1 == S ? ph ^ 1 : ph;
          if (kt + 1 < KT) {
            mbar_wait(&full[s1], ph1);
            normalize_tile(stage(s1), kt + 1, gb);
            gb = gamma_beta(kt + 2);
          }
          wgmma_wait<0>();
          mbar_arrive_if(lane == 0, &empty[s]);
#pragma unroll
          for (int i = 0; i < 32; ++i) run[i] = __fadd_rn(run[i], part[i]);
          s = s1;
          ph = ph1;
        }
        epilogue<T, 64>(run, bias_s + 64 * wg, out, row0, f0 + 64 * wg, N, F, relu);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the CUDA driver library the runtime has
// loaded (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a weight (F rows of D values of `item` bytes, row
// stride DP values), read in boxes of `rows` rows x 128 bytes with 128-byte
// swizzle; outside (D, F) the TMA fills zeros.
int weight_map(CUtensorMap* map, const void* w, int D, int DP, int F, int item, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)F};
  const cuuint64_t strides[1] = {(cuuint64_t)DP * item};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / item), (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, item == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        2, const_cast<void*>(w), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* w0, const void* w1,
           const void* bias, void* out, void* stats, int N, int D, int DP, int F, int relu,
           float eps, cudaStream_t stream) {
  CUtensorMap map0, map1;
  int err = weight_map(&map0, w0, D, DP, F, sizeof(T), Cfg<T>::FN);
  if (err == 0) err = weight_map(&map1, w1 != nullptr ? w1 : w0, D, DP, F, sizeof(T), Cfg<T>::FN);
  if (err != 0) return err;
  ln_stats_kernel<T><<<(N + STATS_ROWS - 1) / STATS_ROWS, STATS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(stats), N, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // pairs of x are aligned copies where D is even and x starts on a pair
  const bool pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const auto kernel = pairs ? ln_dense_wgmma_kernel<T, true> : ln_dense_wgmma_kernel<T, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T>::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)((N + Cfg<T>::BM - 1) / Cfg<T>::BM) * ((F + Cfg<T>::FN - 1) / Cfg<T>::FN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, Layout<T>::SMEM, stream>>>(
      map0, map1, static_cast<const T*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(bias), static_cast<T*>(out), N, D, F, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. x: (N, D) row-major in `dtype` (0
// = float32, 1 = bfloat16); gamma, beta: (D,) f32; x, gamma and beta on
// 16-byte boundaries (the producer copies them in 16-byte chunks); the weight (F, D) in
// torch layout as the wrapper caches it, rows padded to DP values (a
// multiple of 16 bytes) on 16-byte boundaries: w0 in bf16, or w0 = its
// tf32 hi part and w1 its lo part in float32 (w1 null in bf16); bias: (F,)
// f32; out: (N, F) in `dtype`; stats: N x 8 bytes of scratch on an 8-byte
// boundary (each row's mean and 1 / sqrt(var + eps)). Any N, D, F >= 1.
// Launches the statistics pass and the product on `stream`; returns the
// cudaError_t of the launches (0 = success).
extern "C" int ln_dense_launch(const void* x, const void* gamma, const void* beta, const void* w0,
                               const void* w1, const void* bias, void* out, void* stats, int N,
                               int D, int DP, int F, int relu, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || D <= 0 || F <= 0 || DP < D) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
       reinterpret_cast<uintptr_t>(beta)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 1)
    return launch<bf16>(x, gamma, beta, w0, nullptr, bias, out, stats, N, D, DP, F, relu, eps, s);
  if (dtype == 0) {
    if (w1 == nullptr) return (int)cudaErrorInvalidValue;
    return launch<float>(x, gamma, beta, w0, w1, bias, out, stats, N, D, DP, F, relu, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
