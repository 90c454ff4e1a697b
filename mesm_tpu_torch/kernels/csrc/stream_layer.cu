// A whole post-norm transformer layer in one launch, for Hopper (sm_90a),
// float32 or bf16: qkv projections, multi-head attention (the factored pair
// mask optional), out projection, residual, LayerNorm, PReLU FFN, residual,
// LayerNorm.
//
// Replaces: mesm_tpu/ops/layer_pallas.py::fused_stream_layer ->
// _stream_layer_kernel (:107-158, pallas_call :244). Like it, this kernel is
// on no path of the model: `python -m mesm_tpu_torch.scripts.bench_layer_kernel`
// holds it against the port's own layers at the charades widths, the
// encoder flavour at 128 x 195 (the DETR encoder, its global token
// included) and the T2V flavour at 128 x 194 video queries against 17 text
// keys, D = 256, H = 8, FFN 1024.
//
// What it computes (ops/stream_layer.stream_layer_reference is its plain
// version; T is the stream dtype and rnd() rounds to it):
//   q_in = rnd(x + pos); encoder: k_in = q_in, v_in = x
//   qp, kp, vp = rnd(in . W^T + b)          (W rounded to T, f32 sums, f32 bias)
//   per head: logits = (f32(qp_h) * scale) . kp_h^T in f32; -1e9 where both
//     pair factors are set or the key is masked; p = rnd(exact f32 softmax
//     over all Lk keys); att_h = rnd(p . vp_h) with f32 sums
//   x1 = rnd(x + rnd(att . Wo^T + bo)); s = LN1(x1)
//   f = rnd(prelu_f32(rnd(s . W1^T + b1)) . W2^T + b2)     (prelu rounded too)
//   encoder: out = LN2(rnd(s + f)); T2V: out = LN2(rnd(x1 + f))
// with LN(v) = rnd(((v - mean) * rsqrt(E[v^2] - mean^2 + 1e-5)) * g + b) in
// f32. A row whose keys are all masked takes the mean of v over all Lk keys
// (every logit is -1e9: a uniform softmax).
//
// What bounds it on the H100: the operations. At the encoder's widths the
// layer is 44.2 GFLOP: 0.045 ms at 989 TFLOP/s in bf16, 0.268 ms in fp32 as
// three TF32 products (3xTF32) at 494.7 TFLOP/s; the stream in and out is
// ~38 MB (11 us at 3.35 TB/s) and the weights 1.6 MB in bf16.
//
// Design: a persistent cooperative kernel of 256 threads (8 warps) a
// block, one launch, two phases with one grid barrier between them (a
// sample's layer does not fit one block's 227 KB, and the out projection
// needs every head of a row).
//   - Phase 1 walks (sample b, head group) items: hg heads at once (4 in
//     bf16 at charades: 128 projected columns, so that each A chunk feeds
//     enough products; fewer where their keys would not fit). The block
//     projects the heads' keys and values (every key, 128 rows a job) into
//     shared memory, then, 128 query rows at a time (64 in fp32 at head_dim
//     128, the other warps idle), their queries, and each warp attends 16
//     rows of each head with the attention bodies the port's attention
//     kernels run:
//       bf16: attention_mma.cuh's warp body (warp_attend) in Chain::PAIR,
//         this layer's rounding (q unscaled into the mma, the f32 sums times
//         the f32 scale, an exact two-pass f32 softmax, only p rounded, P . V
//         summed in f32), on swizzled tiles it stages itself; every key is
//         resident, so bf16 takes as many keys as fit the shared memory
//         (at D 256: 3,216 at head_dim 16, 1,568 at 32, 736 at 64, 320 at
//         128; stream_layer_config says);
//       fp32: attention_fp32.cuh's 3xTF32 step (attend_tile) over key tiles
//         of 32, split once as the projection writes them, with the online
//         f32 softmax; keys beyond what fits are taken in chunks, each
//         projected again for each block of query rows: any Lk.
//     The head's output rows go to `att`, the one intermediate left in
//     device memory: (B, Lq, H * hdp) of the stream dtype, hdp the padded
//     head_dim (12.8 MB in bf16 at charades; it stays in the 50 MB L2).
//   - Phase 2 walks tiles of R rows of the B * Lq rows (64 in bf16 at
//     D = 256, 32 in fp32, fewer at wider D: the host picks the largest that
//     fits): stages the tile's att rows, multiplies by Wo (x1 with its
//     residual and LN1 stay in shared memory), then the FFN in chunks of 64
//     hidden columns: h = rnd(prelu(rnd(s . W1c^T + b1c))) into shared memory
//     and its product with the chunk's W2 columns added into an f32
//     accumulator tile in shared memory; then the residual, LN2 and the
//     output rows. Nothing but `att` and the output touches device memory.
//   - Every product is mma.sync on the tensor cores: bf16 m16n8k16 with f32
//     accumulators; fp32 3xTF32 (attention_tf32.cuh: m16n8k8 on split
//     operands, small terms first, each depth tile of 32 a partial sum from
//     zero added into the f32 running sum on the CUDA cores, as the
//     tensor cores truncate their own sums).
//   - Weights: the wrapper keeps, once per weight version
//     (ops/_weight_cache.derived), each weight as tiles in the order the
//     kernel reads them: bf16 (rows x 64) tiles with their 16-byte chunks
//     XOR-swizzled by row (conflict-free ldmatrix), fp32 (rows x 32) tiles
//     split into hi and lo at a row stride of 36 floats; every width padded
//     with zeros (D and the attention width to 64, F to 64, each head to
//     hdp). One thread copies them with cp.async.bulk into a ring of up to
//     8 stages completing on mbarriers: phase 1's tiles are a head group's
//     Wk, Wv, Wq rows (hg hdp x 64 or 32 each), one a stage; phase 2 replays
//     one stream of Wo, then per hidden chunk W1's rows and W2's columns
//     (64 x 64 or 32), two tiles a stage.
//   - A operands (the rows of x + pos, k_in, v_in) stream in depth chunks
//     of 64 (bf16) or 32 (fp32) into shared memory, 16-byte loads where a
//     row allows, zeros past D; a chunk's loads are issued into registers
//     before the previous chunk's products, and written to shared memory
//     after them.
//   - LayerNorm is a warp per row, in f32, E[x^2] - mean^2 unclamped.
// Not done: warp-specialised producers, wgmma.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_fp32.cuh"
#include "attention_mma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS1 = 16 * WARPS;  // rows of a phase-1 projection job and of a query block
constexpr int NTILE = 64;          // rows of a phase-2 weight tile; hidden columns of an FFN chunk
constexpr int SPLIT_RS = 36;       // row stride (floats) of an fp32 weight tile of depth 32
constexpr float LN_EPS = 1e-5f;
constexpr size_t MAX_SMEM = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }

// Per stream dtype: the depth of a weight tile and of an A chunk (KC), the
// bytes of a weight tile of `rows` rows, of one A element, and the row
// strides of the A tiles (bf16: rows of the tile's width, 16-byte chunks
// swizzled within each 128 bytes; fp32: 4 floats of padding)
template <bool BF16>
struct Cfg;
template <>
struct Cfg<true> {
  static constexpr int KC = 64;
  __host__ __device__ static size_t tile_bytes(int rows) { return (size_t)rows * 64 * 2; }
  static constexpr int ELEM = 2;
  __host__ __device__ static int lda(int width) { return width; }
};
template <>
struct Cfg<false> {
  static constexpr int KC = 32;
  __host__ __device__ static size_t tile_bytes(int rows) { return (size_t)rows * SPLIT_RS * 4 * 2; }
  static constexpr int ELEM = 4;
  __host__ __device__ static int lda(int width) { return width + 4; }
};

// The shared memory of a block: both phases' ring mbarriers, then phase 1's
// or phase 2's bytes over the same memory (the phases never overlap in
// time): the phase's weight ring (S1 slots of a phase-1 tile, S2 of a
// phase-2 tile), then its tiles.
//   phase 1: A chunk (ROWS1 x KC), for each of the item's hg heads its query
//     tile of `qrows` rows (128, or 64 where that is what fits: fp32 at hdp
//     128), its K and V of `kres` keys and their flags (bf16: swizzled
//     tiles of hdp; fp32: hi and lo at hdp + 4);
//   phase 2: x1 (R x Dq, T; x's rows first), s (R x Dq, A layout), att then
//     the f32 FFN accumulator (R x (Dq + 8)), an FFN hidden chunk (R x 64,
//     A layout), the f32 vectors bo, b2 (Dq), b1 (Fp), ln1s, ln1b, ln2s,
//     ln2b (D each).
struct Plan {
  int hdp, Dq, Ka, Fp, R, S1, S2, G2, hg, qrows, kres;
  size_t slot1, slot2, bars1, bars2, ring, a1, q, k, v, f, p1_end, x1, s, p, h, vec, p2_end, total;
  int D;
  template <bool BF16>
  __host__ __device__ static Plan make(int hdp, int D, int H, int F, int R, int S1, int S2,
                                       int G2, int hg, int qrows, int kres) {
    using C = Cfg<BF16>;
    Plan p;
    p.hdp = hdp;
    p.D = D;
    p.Dq = round_up(D, 64);
    p.Ka = round_up(H * hdp, 64);
    p.Fp = round_up(F, NTILE);
    p.R = R;
    p.S1 = S1;
    p.S2 = S2;
    p.G2 = G2;
    p.hg = hg;
    p.qrows = qrows;
    p.kres = kres;
    p.slot1 = C::tile_bytes(hg * hdp);
    p.slot2 = C::tile_bytes(NTILE) * G2;
    p.bars1 = 0;
    p.bars2 = (size_t)S1 * 8;
    p.ring = align128(p.bars2 + (size_t)S2 * 8);
    // a row of a head's q, k or v tile, times the group's heads
    const size_t hrow = (BF16 ? (size_t)hdp * 2 : (size_t)(hdp + 4) * 4 * 2) * hg;
    p.a1 = align128(p.ring + (size_t)S1 * p.slot1);
    p.q = align128(p.a1 + (size_t)ROWS1 * C::lda(C::KC) * C::ELEM);
    p.k = align128(p.q + (size_t)qrows * hrow);
    p.v = align128(p.k + (size_t)kres * hrow);
    p.f = align128(p.v + (size_t)kres * hrow);
    p.p1_end = p.f + (size_t)kres * hg;
    p.x1 = align128(p.ring + (size_t)S2 * p.slot2);
    p.s = align128(p.x1 + (size_t)R * p.Dq * C::ELEM);
    p.p = align128(p.s + (size_t)R * C::lda(p.Dq) * C::ELEM);
    const size_t att = (size_t)R * C::lda(p.Ka) * C::ELEM, acc = (size_t)R * (p.Dq + 8) * 4;
    p.h = align128(p.p + (att > acc ? att : acc));
    p.vec = align128(p.h + (size_t)R * C::lda(NTILE) * C::ELEM);
    p.p2_end = p.vec + (size_t)(2 * p.Dq + p.Fp + 4 * D) * 4;
    p.total = p.p1_end > p.p2_end ? p.p1_end : p.p2_end;
    return p;
  }
};

// The plan of a launch. Phase 2: the most rows R, then the deepest ring S2
// (up to MAX_STAGES: the weight tiles come from L2, and a tile's products
// take less time than its copy's latency) of slots of G2 = 2 tiles (one
// copy, one wait and one barrier for two tiles), or of single tiles where
// no two-tile ring fits. Phase 1: every key resident (bf16 needs it:
// pad16(Lk); fp32 takes keys in chunks of a multiple of 32 otherwise,
// one head an item), then the most heads an item (hg, up to group_width /
// hdp: each A chunk then feeds hg heads' products), then 128 query rows,
// then the deepest ring S1. Returns false where nothing fits.
constexpr int MAX_STAGES = 8;
// the widest projection an item takes: a head group's columns
template <bool BF16>
__host__ __device__ constexpr int group_width() {
  return BF16 ? 128 : 64;
}
template <bool BF16>
bool choose(int hdp, int Lk, int D, int H, int F, Plan& out) {
  int R = 64, S2 = MAX_STAGES, G2 = 2, hg = 1;
  auto plan = [&](int R, int S1, int S2, int qrows, int kres) {
    return Plan::make<BF16>(hdp, D, H, F, R, S1, S2, G2, hg, qrows, kres);
  };
  while (R >= 16 && plan(R, 2, S2, ROWS1, 0).p2_end > MAX_SMEM)
    if (--S2 < 2) {
      S2 = MAX_STAGES;
      if (--G2 < 1) G2 = 2, R /= 2;
    }
  if (R < 16) return false;
  const int want = BF16 ? mma_attn::pad16(Lk) : round_up(Lk, 32);
  int top = 1;
  while (2 * top * hdp <= group_width<BF16>() && 2 * top <= H) top *= 2;
  for (hg = top; hg >= 1; hg /= 2)
    for (int qrows = ROWS1; qrows >= 64; qrows /= 2)
      for (int S1 = MAX_STAGES; S1 >= 2; --S1)
        if (plan(R, S1, S2, qrows, want).p1_end <= MAX_SMEM) {
          out = plan(R, S1, S2, qrows, want);
          return true;
        }
  if (BF16) return false;
  hg = 1;
  int kres = want;  // fp32: keys in chunks, as many as fit
  while (kres > 32 && plan(R, 2, S2, 64, kres).p1_end > MAX_SMEM) kres -= 32;
  if (plan(R, 2, S2, 64, kres).p1_end > MAX_SMEM) return false;
  out = plan(R, 2, S2, 64, kres);
  return true;
}

struct Args {
  const void *x, *pos, *kin, *vin;
  const uint8_t *mask, *qf, *kf;
  const unsigned char *w1s, *w2s;  // phase 1's and phase 2's weight tiles
  const float *bqkv, *bo, *b1, *b2, *ln1s, *ln1b, *ln2s, *ln2b, *alpha;
  void *att, *out;
  int B, Lq, Lk, D, H, F, hd, self_attn;
  float scale;
  Plan plan;
};

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

using mma_attn::smem_addr;

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element (r, k) of a bf16 A tile of row stride ld (a multiple of 64): the
// 16-byte chunks of each 128 bytes of a row XOR-swizzled by r % 8
__device__ __forceinline__ int asw(int r, int k, int ld) {
  return r * ld + (k & ~63) + ((((k >> 3) & 7) ^ (r & 7)) << 3) + (k & 7);
}

// ---------------------------------------------------------------------------
// the weight ring: one thread copies each tile with cp.async.bulk into the
// next of S slots, completing on the slot's mbarrier; tile n of the block's
// whole walk lives in slot n % S, its use number n / S is the wait's parity
// ---------------------------------------------------------------------------

struct Ring {
  unsigned char* slots;
  uint64_t* full;
  size_t slot_bytes;
  int S;
  __device__ unsigned char* slot(uint32_t n) const { return slots + (n % S) * slot_bytes; }
  __device__ void issue(uint32_t n, const void* src, uint32_t bytes) const {
    const uint32_t bar = smem_addr(full + n % S);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(slot(n))),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
  __device__ void wait(uint32_t n) const {
    const uint32_t bar = smem_addr(full + n % S), parity = (n / S) & 1;
    uint32_t ok = 0;
    while (!ok)
      asm volatile(
          "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\nselp.u32 %0, 1, 0, P;\n}\n"
          : "=r"(ok)
          : "r"(bar), "r"(parity)
          : "memory");
  }
};

// The tiles of one item, consumed in order by the whole block, G of them
// a slot (consecutive tiles, contiguous in device memory from src(g G),
// one bulk copy): thread 0 keeps S slots in flight. src(i) is tile i's
// address in device memory; `first` counts the slots of earlier items.
template <typename Src>
struct Walk {
  const Ring& ring;
  uint32_t first;
  int ntiles, G, cur = 0;
  uint32_t bytes;
  Src src;
  __device__ Walk(const Ring& r, uint32_t first_, int n, int g, uint32_t b, Src s)
      : ring(r), first(first_), ntiles(n), G(g), bytes(b), src(s) {
    if (threadIdx.x == 0)
      for (int i = 0; i < groups() && i < r.S; ++i) issue(i);
  }
  __device__ int groups() const { return (ntiles + G - 1) / G; }
  __device__ void issue(int g) const {
    const int n = min(G, ntiles - g * G);
    ring.issue(first + g, src(g * G), bytes * n);
  }
  // the next tile, once its slot has landed
  __device__ const unsigned char* take() const {
    if (cur % G == 0) ring.wait(first + cur / G);
    return ring.slot(first + cur / G) + (size_t)(cur % G) * bytes;
  }
  // every warp is done with the tile taken last; after a slot's last tile
  // the slot takes group g + S
  __device__ void done() {
    if (cur % G == G - 1 || cur == ntiles - 1) {
      __syncthreads();
      const int g = cur / G;
      if (threadIdx.x == 0 && g + ring.S < groups()) issue(g + ring.S);
    }
    ++cur;
  }
};

// ---------------------------------------------------------------------------
// the warp's share of a product with one weight tile
// ---------------------------------------------------------------------------

// acc[nt] += A rows [r0, r0 + 16) x depth [k0, k0 + 64) . W^T for the tile's
// rows n0 + 8 nt (nt < ntw); bf16 mma m16n8k16, A swizzled at row stride lda
template <int NT>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], const bf16* A, int lda, int r0, int k0,
                                         const unsigned char* tile, int n0, int ntw, int lane) {
  const bf16* W = reinterpret_cast<const bf16*>(tile);
  uint32_t a[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    mma_attn::ldmatrix_x4(a[ks], A + asw(r0 + (lane & 15), k0 + 16 * ks + 8 * (lane >> 4), lda));
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= ntw) break;
#pragma unroll
    for (int hx = 0; hx < 2; ++hx) {
      uint32_t kb[4];  // depth 32 hx .. 32 hx + 31 of tile rows n0 + 8 nt ..
      mma_attn::ldmatrix_x4(kb, W + mma_attn::swz<64>(n0 + 8 * nt + (lane & 7), (lane >> 3) + 4 * hx));
      mma_attn::mma_bf16(acc[nt], a[2 * hx], kb[0], kb[1]);
      mma_attn::mma_bf16(acc[nt], a[2 * hx + 1], kb[2], kb[3]);
    }
  }
}

// The same in fp32 over depth [k0, k0 + 32): 3xTF32 of A split as it is
// read and the tile's hi and lo rows (`rows` of them a half), a partial sum
// from zero added into acc
template <int NT>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], const float* A, int lda, int r0, int k0,
                                         const unsigned char* tile, int rows, int n0, int ntw,
                                         int lane) {
  const float* hi = reinterpret_cast<const float*>(tile);
  const tf32x3::SplitTile W{hi, hi + rows * SPLIT_RS};
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + (size_t)(r0 + g) * lda + k0 + t;
  const float* a1 = a0 + 8 * lda;
  float part[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const tf32x3::SplitA sa(a0[8 * ks], a1[8 * ks], a0[8 * ks + 4], a1[8 * ks + 4]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= ntw) break;
      const int off = (n0 + 8 * nt + g) * SPLIT_RS + 8 * ks + t;
      tf32x3::mma3(part[nt], sa, W, off, off + 4);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// ---------------------------------------------------------------------------
// phase 1: projections and attention of one (sample, head)
// ---------------------------------------------------------------------------

// 8 consecutive elements of a row of width D from column c (zeros past D),
// plus b's where b is given, rounded to T, element by element
template <typename T>
__device__ __forceinline__ void load8(const T* a, const T* b, int c, int D, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = 0.f;
    if (c + i < D) {
      v = to_f(a[c + i]);
      if (b) v = rnd<T>(v + to_f(b[c + i]));
    }
    f[i] = v;
  }
}

// The A chunks of a projection job: rows [r0, r0 + ROWS1) (those below
// nrows) of a (+ b), columns [k0, k0 + KC) (zeros past D). fetch() issues
// the 16-byte loads of a chunk (where `vec` and the 8 columns of a thread's
// piece lie inside the row) into registers; put() writes the chunk into the
// A tile, adding b and rounding to T, with element loads for the pieces
// fetch() left. So a chunk's loads are in flight while the previous chunk
// is multiplied.
template <typename T>
struct AChunks {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int KC = Cfg<BF16>::KC, CH = KC / 8, PER = ROWS1 * CH / THREADS;
  static constexpr int U = BF16 ? 1 : 2;  // 16-byte loads of 8 elements
  uint4 xa[PER][U], xb[PER][U];
  const T *a, *b;
  int r0, nrows, D;
  bool vec;
  __device__ bool fast(int r, int col) const { return vec && r0 + r < nrows && col + 8 <= D; }
  __device__ void fetch(int k0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * THREADS, r = i / CH, col = k0 + 8 * (i % CH);
      if (!fast(r, col)) continue;
      const size_t off = (size_t)(r0 + r) * D + col;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xa[p][u] = __ldg(reinterpret_cast<const uint4*>(a + off) + u);
        if (b) xb[p][u] = __ldg(reinterpret_cast<const uint4*>(b + off) + u);
      }
    }
  }
  __device__ void put(T* A, int k0) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * THREADS, r = i / CH, c = i % CH, col = k0 + 8 * c;
      float f[8];
      if (fast(r, col)) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T* ea = reinterpret_cast<const T*>(&xa[p][u]);
          const T* eb = reinterpret_cast<const T*>(&xb[p][u]);
#pragma unroll
          for (int e = 0; e < 8 / U; ++e)
            f[u * 8 / U + e] = b ? rnd<T>(to_f(ea[e]) + to_f(eb[e])) : to_f(ea[e]);
        }
      } else if (r0 + r < nrows) {
        const size_t row = (size_t)(r0 + r) * D;
        load8<T>(a + row, b ? b + row : nullptr, col, D, f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
      }
      if constexpr (BF16) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = mma_attn::pack_bf16(f[2 * e], f[2 * e + 1]);
        *reinterpret_cast<uint4*>(A + asw(r, 8 * c, KC)) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        float* d = A + r * Cfg<false>::lda(KC) + 8 * c;
        *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
};

// which weight (0 k, 1 v, 2 q) job j of an item reads. Per block of query
// rows: its q job, then (for the first block, or for every block when
// the keys take more than one chunk) for each key chunk its k jobs and its
// v jobs, one per 128 keys.
__device__ __forceinline__ int job_weight(int j, int nch, int kres, int Lk) {
  auto nkb = [&](int ch) { return (min(kres, Lk - ch * kres) + ROWS1 - 1) / ROWS1; };
  int kv = 0;
  for (int ch = 0; ch < nch; ++ch) kv += 2 * nkb(ch);
  const int first = 1 + kv, later = 1 + (nch > 1 ? kv : 0);
  int r = j < first ? j : (j - first) % later;
  if (r == 0) return 2;
  --r;
  for (int ch = 0; ch < nch; ++ch) {
    const int n = nkb(ch);
    if (r < n) return 0;
    r -= n;
    if (r < n) return 1;
    r -= n;
  }
  return 2;
}

// One phase-1 item: heads [h0, h0 + hg) (those below H) of sample b. The
// group's Wk, Wv and Wq rows (hg heads of HDP rows) are one weight tile a
// depth chunk, so each A chunk feeds hg heads' products; each head has its
// own q, k and v tiles and key flags, and attends on its own.
template <typename T, int HDP>
__device__ void phase1_item(const Args& a, const Ring& ring, uint32_t& seq, unsigned char* smem,
                            int b, int grp) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int KC = Cfg<BF16>::KC, NT = HDP / 8, RS = tf32x3::RS<HDP>;
  // n8 tiles of the widest group (at least one head)
  constexpr int NTG = (group_width<BF16>() > HDP ? group_width<BF16>() : HDP) / 8;
  const Plan& pl = a.plan;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, H = a.H, kres = pl.kres, hg = pl.hg;
  const int h0 = grp * hg, nh = min(hg, H - h0), Hp = (H + hg - 1) / hg * hg;
  const int qrows = pl.qrows, nk = pl.Dq / KC, nqb = (Lq + qrows - 1) / qrows;
  const int nch = (Lk + kres - 1) / kres, ntw = hg * NT;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * Lq * D;
  const T* pos = static_cast<const T*>(a.pos) + (size_t)b * Lq * D;
  const T* kin = a.self_attn ? x : static_cast<const T*>(a.kin) + (size_t)b * Lk * D;
  const T* kadd = a.self_attn ? pos : nullptr;
  const T* vin = a.self_attn ? x : static_cast<const T*>(a.vin) + (size_t)b * Lk * D;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.pos) |
                     reinterpret_cast<uintptr_t>(a.kin) | reinterpret_cast<uintptr_t>(a.vin)) & 15) == 0;
  T* A = reinterpret_cast<T*>(smem + pl.a1);
  // a head's tiles: q (qrows rows), k and v (kres rows), flags (kres)
  const size_t hrow = BF16 ? (size_t)HDP * 2 : (size_t)RS * 4 * 2;
  auto qtile = [&](int hh) { return smem + pl.q + hh * qrows * hrow; };
  auto ktile = [&](int which, int hh) { return smem + (which ? pl.v : pl.k) + hh * kres * hrow; };
  auto flags = [&](int hh) { return smem + pl.f + hh * kres; };
  const float* bias = a.bqkv;  // (3, Hp, HDP): k, v, q

  int kv = 0;
  for (int ch = 0; ch < nch; ++ch) kv += 2 * ((min(kres, Lk - ch * kres) + ROWS1 - 1) / ROWS1);
  const int jobs = nqb + kv + (nch > 1 ? (nqb - 1) * kv : 0);
  const uint32_t tb = (uint32_t)Cfg<BF16>::tile_bytes(hg * HDP);
  auto src = [&](int i) {
    const int which = job_weight(i / nk, nch, kres, Lk);
    return a.w1s + (((size_t)grp * 3 + which) * nk + i % nk) * tb;
  };
  Walk<decltype(src)> walk(ring, seq, jobs * nk, 1, tb, src);
  seq += jobs * nk;

  // one job: rows [r0, r0 + 128) of (src_a + src_b) (rows < nrows) times
  // the weight of the job into acc (the warp's 16 rows, the group's hg HDP
  // columns)
  float acc[NTG][4];
  auto project = [&](const T* sa, const T* sb, int r0, int nrows) {
    zero(acc);
    AChunks<T> chunks{{}, {}, sa, sb, r0, nrows, D, vec};
    chunks.fetch(0);
    for (int kc = 0; kc < nk; ++kc) {
      chunks.put(A, kc * KC);
      __syncthreads();
      if (kc + 1 < nk) chunks.fetch((kc + 1) * KC);  // in flight during this chunk's products
      const unsigned char* tile = walk.take();
      if constexpr (BF16)
        tile_mma<NTG>(acc, A, KC, 16 * warp, 0, tile, 0, ntw, lane);
      else
        tile_mma<NTG>(acc, A, Cfg<false>::lda(KC), 16 * warp, 0, tile, hg * HDP, 0, ntw, lane);
      walk.done();
    }
  };
  // the job's epilogue: rows 16 warp + g, + 8 of the job (row0 their first
  // tile row; rows at or past `rows` are written as zeros, past `cap` not
  // at all): rnd(acc + bias) (times `mul` in fp32) into each head's tile of
  // `tile_rows` rows (fp32: its lo half after them)
  auto epilogue = [&](int which, auto tile_of, int row0, int rows, int cap, int tile_rows,
                      float mul) {
    const float* bw = bias + ((size_t)which * Hp + h0) * HDP;
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      if (nt >= ntw) break;
      const int n = 8 * nt + 2 * t, hh = n / HDP, c = n % HDP;
      const float b0 = bw[n], b1 = bw[n + 1];
      unsigned char* dst = tile_of(hh);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + 16 * warp + g + 8 * half;
        if (r >= cap) continue;
        const bool live = r < rows;
        const float v0 = live ? rnd<T>(acc[nt][2 * half] + b0) : 0.f;
        const float v1 = live ? rnd<T>(acc[nt][2 * half + 1] + b1) : 0.f;
        if constexpr (BF16) {
          bf16* tile = reinterpret_cast<bf16*>(dst);
          *reinterpret_cast<uint32_t*>(tile + mma_attn::swz<HDP>(r, c >> 3) + (c & 7)) =
              mma_attn::pack_bf16(v0, v1);
        } else {
          float* hi = reinterpret_cast<float*>(dst);
          float* lo = hi + (size_t)tile_rows * RS;
          uint32_t hb0, lb0, hb1, lb1;
          tf32x3::split(v0 * mul, hb0, lb0);
          tf32x3::split(v1 * mul, hb1, lb1);
          *reinterpret_cast<uint2*>(hi + (size_t)r * RS + c) = make_uint2(hb0, hb1);
          *reinterpret_cast<uint2*>(lo + (size_t)r * RS + c) = make_uint2(lb0, lb1);
        }
      }
    }
  };
  // K and V of key chunk ch into each head's tiles, and its key flags
  auto keys = [&](int ch) {
    const int k0 = ch * kres, kn = min(kres, Lk - k0);
    const int cap = BF16 ? mma_attn::pad16(kn) : round_up(kn, 32);
    for (int which = 0; which < 2; ++which) {
      const T* sa = which ? vin : kin;
      const T* sb = which ? nullptr : kadd;
      for (int r0 = 0; r0 < kn; r0 += ROWS1) {
        project(sa + (size_t)k0 * D, sb ? sb + (size_t)k0 * D : nullptr, r0, kn);
        epilogue(which, [&](int hh) { return ktile(which, hh); }, r0, kn, cap, kres, 1.f);
      }
    }
    for (int i = tid; i < nh * cap; i += THREADS) {
      const int hh = i / cap, j = i % cap;
      uint8_t f = 2;
      if (j < kn) {
        f = a.mask[(size_t)b * Lk + k0 + j] ? 1 : 0;
        // the same bit as fp32_attn::KEY_PAIR
        if (a.kf && a.kf[((size_t)b * H + h0 + hh) * Lk + k0 + j]) f |= mma_attn::KEY_PAIR;
      }
      flags(hh)[j] = f;
    }
    __syncthreads();
    return kn;
  };

  for (int qb = 0; qb < nqb; ++qb) {
    const int q0 = qb * qrows;
    project(x, pos, q0, Lq);
    epilogue(2, qtile, 0, Lq - q0, qrows, qrows, a.scale);
    const int r0 = q0 + 16 * warp;  // the warp's first query row
    const bool active = 16 * warp < qrows && r0 < Lq;
    // the pair flags of rows r0 + g and r0 + g + 8 for head hh of the group
    auto qflags = [&](int hh, bool& qf0, bool& qf1) {
      const uint8_t* qf = a.qf ? a.qf + ((size_t)b * H + h0 + hh) * Lq : nullptr;
      qf0 = qf && r0 + g < Lq && qf[r0 + g];
      qf1 = qf && r0 + g + 8 < Lq && qf[r0 + g + 8];
    };
    if constexpr (BF16) {
      if (qb == 0)
        keys(0);
      else
        __syncthreads();  // the query tiles are written
      if (!active) continue;
      const int kpad = mma_attn::pad16(Lk);
      for (int hh = 0; hh < nh; ++hh) {
        bool qf0, qf1;
        qflags(hh, qf0, qf1);
        const bf16* Ks = reinterpret_cast<const bf16*>(ktile(0, hh));
        const bf16* Vs = reinterpret_cast<const bf16*>(ktile(1, hh));
        bf16* Qw = reinterpret_cast<bf16*>(qtile(hh)) + 16 * warp * HDP;
        float o[NT][4];
        if (kpad <= mma_attn::resident_keys<HDP>())
          mma_attn::warp_attend<HDP, true, mma_attn::Chain::PAIR>(o, Qw, Ks, Vs, flags(hh), kpad,
                                                                  a.scale, lane, qf0, qf1);
        else
          mma_attn::warp_attend<HDP, false, mma_attn::Chain::PAIR>(o, Qw, Ks, Vs, flags(hh), kpad,
                                                                   a.scale, lane, qf0, qf1);
        // att = bf(o): through the warp's (read) query rows, then 16-byte stores
        __syncwarp();
#pragma unroll
        for (int dt = 0; dt < NT; ++dt) {
          *reinterpret_cast<uint32_t*>(Qw + mma_attn::swz<HDP>(g, dt) + 2 * t) =
              mma_attn::pack_bf16(o[dt][0], o[dt][1]);
          *reinterpret_cast<uint32_t*>(Qw + mma_attn::swz<HDP>(g + 8, dt) + 2 * t) =
              mma_attn::pack_bf16(o[dt][2], o[dt][3]);
        }
        __syncwarp();
        bf16* att = static_cast<bf16*>(a.att) + ((size_t)b * Lq + r0) * pl.Ka + (h0 + hh) * HDP;
        for (int i = lane; i < 16 * NT; i += 32) {
          const int r = i / NT, c = i % NT;
          if (r0 + r < Lq)
            *reinterpret_cast<uint4*>(att + (size_t)r * pl.Ka + 8 * c) =
                *reinterpret_cast<const uint4*>(Qw + mma_attn::swz<HDP>(r, c));
        }
      }
    } else {
      if (qb > 0 && nch == 1) __syncthreads();  // the query tiles are written
      // head hh's split query rows and its key tile j (32 keys)
      auto qa = [&](int hh) {
        const float* Qh = reinterpret_cast<const float*>(qtile(hh));
        return fp32_attn::SplitRows<HDP>{Qh + (16 * warp + g) * RS + t,
                                         Qh + qrows * RS + (16 * warp + g) * RS + t};
      };
      auto kv_tile = [&](int which, int hh, int j) {
        const float* hi = reinterpret_cast<const float*>(ktile(which, hh));
        return tf32x3::SplitTile{hi + j * 32 * RS, hi + (size_t)kres * RS + j * 32 * RS};
      };
      float* att = static_cast<float*>(a.att);
      if (nch == 1) {
        if (qb == 0) keys(0);
        if (!active) continue;
        for (int hh = 0; hh < nh; ++hh) {
          bool qf0, qf1;
          qflags(hh, qf0, qf1);
          fp32_attn::Online<NT> st;
          for (int j = 0; j * 32 < Lk; ++j)
            fp32_attn::attend_tile<HDP>(st, qa(hh), kv_tile(0, hh, j), kv_tile(1, hh, j),
                                        flags(hh) + 32 * j, lane, qf0, qf1);
          st.store(att + (h0 + hh) * HDP, (size_t)b * Lq, r0 + g, Lq, pl.Ka, t);
        }
      } else {  // keys in chunks: one head an item (choose), the softmax carried over the chunks
        bool qf0, qf1;
        qflags(0, qf0, qf1);
        fp32_attn::Online<NT> st;
        for (int ch = 0; ch < nch; ++ch) {
          const int kn = keys(ch);
          if (!active) continue;
          for (int j = 0; j * 32 < kn; ++j)
            fp32_attn::attend_tile<HDP>(st, qa(0), kv_tile(0, 0, j), kv_tile(1, 0, j),
                                        flags(0) + 32 * j, lane, qf0, qf1);
        }
        if (active) st.store(att + h0 * HDP, (size_t)b * Lq, r0 + g, Lq, pl.Ka, t);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// phase 2: out projection, LN1, FFN, LN2 of R rows
// ---------------------------------------------------------------------------

template <typename T>
__device__ void phase2_item(const Args& a, const Ring& ring, uint32_t& seq, unsigned char* smem,
                            int m0) {
  constexpr bool BF16 = sizeof(T) == 2;
  using C = Cfg<BF16>;
  constexpr int KC = C::KC;
  const Plan& pl = a.plan;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int N = a.B * a.Lq, D = a.D, R = pl.R, Dq = pl.Dq, Ka = pl.Ka;
  const int RG = R / 16, rg = warp % RG, cw = warp / RG, wc = 8 * RG, ntw = RG;
  const int lds = C::lda(Dq), ldatt = C::lda(Ka), ldh = C::lda(NTILE), ldacc = Dq + 8;
  T* X1 = reinterpret_cast<T*>(smem + pl.x1);
  T* Sb = reinterpret_cast<T*>(smem + pl.s);
  T* Att = reinterpret_cast<T*>(smem + pl.p);
  float* Yacc = reinterpret_cast<float*>(smem + pl.p);
  T* Hc = reinterpret_cast<T*>(smem + pl.h);
  const float* bo = reinterpret_cast<const float*>(smem + pl.vec);  // see load_vectors
  const float *b2 = bo + Dq, *b1 = b2 + Dq, *ln1s = b1 + pl.Fp, *ln1b = ln1s + D;
  const float *ln2s = ln1b + D, *ln2b = ln2s + D;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);

  const int nwo = (Dq / NTILE) * (Ka / KC), nw1 = Dq / KC, nw2 = (Dq / NTILE) * (NTILE / KC);
  const int nj = pl.Fp / NTILE, ntiles = nwo + nj * (nw1 + nw2);
  const uint32_t tb = (uint32_t)C::tile_bytes(NTILE);
  auto src = [&](int i) { return a.w2s + (size_t)i * tb; };
  Walk<decltype(src)> walk(ring, seq, ntiles, pl.G2, tb, src);
  seq += walk.groups();

  // an element of an A tile (bf16 swizzled, fp32 padded rows)
  auto aidx = [&](int r, int c, int ld) { return BF16 ? asw(r, c, ld) : r * ld + c; };
  // the warp's product of one N tile of 64 output columns over `nk` tiles
  // with A at row stride lda: acc[nt] for rows 16 rg + g (+ 8), columns
  // wc cw + 8 nt + 2t (+ 1) of the N tile
  float acc[4][4];
  auto product = [&](const T* A, int lda, int nk) {
    zero(acc);
    for (int kc = 0; kc < nk; ++kc) {
      const unsigned char* tile = walk.take();
      if constexpr (BF16)
        tile_mma<4>(acc, A, lda, 16 * rg, kc * KC, tile, wc * cw, ntw, lane);
      else
        tile_mma<4>(acc, A, lda, 16 * rg, kc * KC, tile, NTILE, wc * cw, ntw, lane);
      walk.done();
    }
  };
  // f(row r of the tile, column c of the N tile, value) for the warp's
  // accumulator pairs
  auto each = [&](auto f) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= ntw) break;
      const int c = wc * cw + 8 * nt + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) f(16 * rg + g + 8 * (i >> 1), c + (i & 1), acc[nt][i]);
    }
  };

  // the tile's att rows (L2 loads: phase 1 wrote them in this launch),
  // zeros past N and past the heads' H * hdp columns (which no item
  // writes); x's rows into X1 (16-byte loads where its rows allow)
  {
    constexpr int E8 = 16 / sizeof(T);  // elements of a 16-byte chunk
    const T* att = static_cast<const T*>(a.att);
    const int heads_w = a.H * pl.hdp;
    for (int i = tid; i < R * (Ka / E8); i += THREADS) {
      const int r = i / (Ka / E8), c = (i % (Ka / E8)) * E8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < N && c < heads_w) u = __ldcg(reinterpret_cast<const uint4*>(att + (size_t)(m0 + r) * Ka + c));
      *reinterpret_cast<uint4*>(Att + aidx(r, c, ldatt)) = u;
    }
    const bool vec = (D * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (vec) {
      for (int i = tid; i < R * (D / E8); i += THREADS) {
        const int r = i / (D / E8), c = (i % (D / E8)) * E8;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < N) u = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * D + c));
        *reinterpret_cast<uint4*>(X1 + (size_t)r * Dq + c) = u;
      }
    } else {
      for (int i = tid; i < R * D; i += THREADS) {
        const int r = i / D, c = i % D;
        X1[(size_t)r * Dq + c] = m0 + r < N ? x[(size_t)(m0 + r) * D + c] : T(0.f);
      }
    }
  }
  __syncthreads();

  // x1 = rnd(x + rnd(att . Wo^T + bo)), columns below D
  for (int nb = 0; nb < Dq / NTILE; ++nb) {
    product(Att, ldatt, Ka / KC);
    each([&](int r, int c, float v) {
      const int col = nb * NTILE + c;
      if (col >= D) return;
      T* x1 = X1 + (size_t)r * Dq + col;  // holds x
      put(x1, rnd<T>(to_f(*x1) + rnd<T>(v + bo[col])));
    });
  }
  __syncthreads();

  // s = LN1(x1) into the A tile (zeros past D and N), a warp per row; then
  // the FFN accumulator, zero
  auto layernorm = [&](auto value, const float* gs, const float* bs, auto store) {
    for (int r = warp; r < R; r += WARPS) {
      float s = 0.f, ss = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float v = value(r, c);
        s += v;
        ss += v * v;
      }
      const float mu = warp_sum(s) / D;
      const float var = warp_sum(ss) / D - mu * mu;
      const float rs = rsqrtf(var + LN_EPS);
      for (int c = lane; c < D; c += 32)
        store(r, c, rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(value(r, c) - mu, rs), gs[c]), bs[c])));
    }
  };
  layernorm([&](int r, int c) { return to_f(X1[(size_t)r * Dq + c]); }, ln1s, ln1b,
            [&](int r, int c, float v) { put(Sb + aidx(r, c, lds), m0 + r < N ? v : 0.f); });
  for (int i = tid; i < R * (Dq - D); i += THREADS) {  // columns past D
    const int r = i / (Dq - D), c = D + i % (Dq - D);
    put(Sb + aidx(r, c, lds), 0.f);
  }
  for (int i = tid; i < R * ldacc; i += THREADS) Yacc[i] = 0.f;
  __syncthreads();

  // the FFN, 64 hidden columns at a time
  const float alpha = a.alpha[0];
  for (int j = 0; j < nj; ++j) {
    product(Sb, lds, Dq / KC);
    __syncthreads();  // every warp is done with the previous chunk's Hc
    each([&](int r, int c, float v) {
      const float hv = rnd<T>(v + b1[j * NTILE + c]);
      put(Hc + aidx(r, c, ldh), rnd<T>(hv > 0.f ? hv : alpha * hv));
    });
    __syncthreads();
    for (int nb = 0; nb < Dq / NTILE; ++nb) {
      product(Hc, ldh, NTILE / KC);
      each([&](int r, int c, float v) { Yacc[(size_t)r * ldacc + nb * NTILE + c] += v; });
    }
  }
  __syncthreads();

  // y = rnd(res + rnd(f + b2)), out = LN2(y) for the rows below N
  auto yval = [&](int r, int c) {
    const float res = a.self_attn ? to_f(Sb[aidx(r, c, lds)]) : to_f(X1[(size_t)r * Dq + c]);
    return rnd<T>(res + rnd<T>(Yacc[(size_t)r * ldacc + c] + b2[c]));
  };
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Yacc[(size_t)r * ldacc + c] = yval(r, c);
  }
  __syncthreads();
  layernorm([&](int r, int c) { return Yacc[(size_t)r * ldacc + c]; }, ln2s, ln2b,
            [&](int r, int c, float v) {
              if (m0 + r < N) put(out + (size_t)(m0 + r) * D + c, v);
            });
  __syncthreads();  // the tiles are read before the next item writes them
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1) stream_layer_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& pl = a.plan;
  const Ring ring1{smem + pl.ring, reinterpret_cast<uint64_t*>(smem + pl.bars1), pl.slot1, pl.S1};
  const Ring ring2{smem + pl.ring, reinterpret_cast<uint64_t*>(smem + pl.bars2), pl.slot2, pl.S2};
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.S1 + pl.S2; ++s)  // bars2 follows bars1
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(ring1.full + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t seq = 0;  // weight tiles this block has walked in the phase
  const int groups = (a.H + pl.hg - 1) / pl.hg;  // head groups of a sample
  for (int item = blockIdx.x; item < a.B * groups; item += gridDim.x)
    phase1_item<T, HDP>(a, ring1, seq, smem, item / groups, item % groups);
  cg::this_grid().sync();  // every head of every row is in att
  {  // phase 2's vectors into shared memory, in the order phase2_item reads them
    float* vec = reinterpret_cast<float*>(smem + pl.vec);
    const float* src[7] = {a.bo, a.b2, a.b1, a.ln1s, a.ln1b, a.ln2s, a.ln2b};
    const int len[7] = {pl.Dq, pl.Dq, pl.Fp, pl.D, pl.D, pl.D, pl.D};
    for (int v = 0, off = 0; v < 7; off += len[v++])
      for (int i = threadIdx.x; i < len[v]; i += THREADS) vec[off + i] = src[v][i];
    __syncthreads();
  }
  const int N = a.B * a.Lq;
  seq = 0;
  for (int item = blockIdx.x; item * pl.R < N; item += gridDim.x)
    phase2_item<T>(a, ring2, seq, smem, item * pl.R);
}

template <typename T, int HDP>
int launch(Args a, cudaStream_t stream) {
  const auto kernel = stream_layer_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.plan.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                          a.plan.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items1 = (long long)a.B * ((a.H + a.plan.hg - 1) / a.plan.hg);
  const long long items2 = ((long long)a.B * a.Lq + a.plan.R - 1) / a.plan.R;
  long long grid = items1 > items2 ? items1 : items2;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid), dim3(THREADS),
                                    params, a.plan.total, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(const Args& a, int hdp, cudaStream_t s) {
  switch (hdp) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool plan_for(int is_bf16, int hdp, int Lk, int D, int H, int F, Plan& p) {
  if (hdp != 16 && hdp != 32 && hdp != 64 && hdp != 128) return false;
  return is_bf16 ? choose<true>(hdp, Lk, D, H, F, p) : choose<false>(hdp, Lk, D, H, F, p);
}

}  // namespace

// The plan of a launch, for the wrapper: cfg[0] the shared memory a block
// takes (bytes), cfg[1] the rows of a phase-2 tile, cfg[2] the keys resident
// at once (all of them, or fp32's chunk), cfg[3] and cfg[4] the weight
// ring's stages in phase 1 and phase 2, cfg[5] the query rows of phase 1,
// cfg[6] the heads of a phase-1 item (the weight layout depends on it).
// hdp: the padded head_dim (16, 32, 64 or 128). Returns 0, or
// cudaErrorInvalidValue where no plan fits a block's shared memory (bf16
// keys that do not all fit, a D too wide for 16 rows).
extern "C" int stream_layer_config(int is_bf16, int hdp, int Lk, int D, int H, int F, int* cfg) {
  Plan p;
  if (Lk <= 0 || D <= 0 || H <= 0 || F <= 0 || !plan_for(is_bf16, hdp, Lk, D, H, F, p))
    return (int)cudaErrorInvalidValue;
  cfg[0] = (int)p.total;
  cfg[1] = p.R;
  cfg[2] = p.kres;
  cfg[3] = p.S1;
  cfg[4] = p.S2;
  cfg[5] = p.qrows;
  cfg[6] = p.hg;
  return 0;
}

// Plain C entry point, bound with ctypes. x, pos, out: (B, Lq, D); kin, vin:
// (B, Lk, D) for the T2V flavour (null for the encoder, where Lk = Lq); all
// float32 (is_bf16 = 0) or all bf16, contiguous. mask: (B, Lk) uint8, 1 =
// attendable; qf, kf: (B, H, Lq) and (B, H, Lk) uint8 pair factors, or both
// null. The weights come as ops/stream_layer.kernel_weights lays them out
// for head_dim hd = D / H padded to hdp and the plan's head groups of hg
// (stream_layer_config): w1s, phase 1's tiles (head group, k / v / q, depth
// tile) of hg hdp rows; bqkv (3, Hp, hdp) f32, Hp = H rounded up to hg; w2s, phase 2's tile stream; bo, b2
// (Dq), b1 (Fp) f32 zero-padded; ln1s, ln1b, ln2s, ln2b (D), alpha (1) f32,
// all on 16-byte boundaries. att: (B, Lq, Ka) of the stream dtype, Ka =
// H * hdp rounded up to 64, written and read by the launch. scale is
// hd ** -0.5. Returns the cudaError_t of the launch (0 = success).
extern "C" int stream_layer_launch(
    const void* x, const void* pos, const void* kin, const void* vin, const void* mask,
    const void* qf, const void* kf, const void* w1s, const void* bqkv, const void* w2s,
    const void* bo, const void* b1, const void* b2, const void* ln1s, const void* ln1b,
    const void* ln2s, const void* ln2b, const void* alpha, void* att, void* out, int B, int Lq,
    int Lk, int D, int H, int F, int hdp, int is_bf16, int self_attn, float scale, void* stream) {
  Plan p;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || F <= 0 || D % H || D / H > hdp ||
      (self_attn && Lk != Lq) || (!self_attn && (!kin || !vin)) || (!qf != !kf) ||
      !plan_for(is_bf16, hdp, Lk, D, H, F, p))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  Args a{x, pos, kin, vin, static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(qf),
         static_cast<const uint8_t*>(kf), static_cast<const unsigned char*>(w1s),
         static_cast<const unsigned char*>(w2s), f(bqkv), f(bo), f(b1), f(b2), f(ln1s), f(ln1b),
         f(ln2s), f(ln2b), f(alpha), att, out, B, Lq, Lk, D, H, F, D / H, self_attn, scale, p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_head_dim<bf16>(a, hdp, s) : by_head_dim<float>(a, hdp, s);
}
