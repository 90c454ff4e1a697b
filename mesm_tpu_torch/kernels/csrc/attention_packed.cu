// Packed multi-head attention for Hopper (sm_90a), bf16 or float32, with and
// without the factored pair mask.
//
// Replaces two kernels of mesm_tpu/ops/attention_pallas.py (the "packed"
// branch of _fused_attention_impl):
//   - _mha_kernel_packed together with _softmax_lastdim (the packed entry
//     point): the DETR encoder's self-attention (charades: B = 128, L = 195
//     with the global token, E = 256, H = 8, head_dim 32; launched once per
//     encoder layer);
//   - _mha_kernel_packed_pair (the pair entry point): the T2V / enhance
//     cross-attention under the scrambled pair mask when the text has 64
//     keys or more (charades with long queries: 128 x 194 x 81).
// The float32 instances are what MESM_ATTN_VARIANT=packed sends fp32 models
// to (the TACoS encoder: 16 x 601 x 601).
//
// What each computes, per (sample b, head h), at the TPU kernels' rounding
// points, with bf() the rounding to the operand dtype (none in float32). The
// packed entry point (attention_packed_reference):
//   qs = bf(q_h * bf(scale))
//   logits = bf(qs . k_h^T)                     (f32 accumulation)
//   masked keys -> bf(-1e9), a finite value
//   m = max(logits); e = bf(exp(bf(logits - m)))
//   s = sum(e) in f32; p = bf(e / bf(s))
//   out_h = bf(p . v_h)                         (f32 accumulation)
// The pair entry point (attention_packed_pair_reference; an f32 softmax,
// only p rounded):
//   qs = f32(q_h) * scale                       (f32 product)
//   logits = qs . k_h^T                         (f32)
//   pair (q, k) with qf[b, h, q] and kf[b, h, k] -> -1e9; masked keys -> -1e9
//   p = bf(exp(logits - max) / sum(exp(logits - max)))   (f32 softmax)
//   out_h = bf(p . v_h)                         (f32 accumulation)
// A row whose keys are all masked gets the uniform average of v over all Lk
// keys, never NaN. Operands stay (B, L, E): the head split is the column
// slice [h*hd, (h+1)*hd), read and written in place, with no transposes
// around the call. The pair factors are the model's (B, H, Lq) and
// (B, H, Lk) masks as uint8; the TPU kernel's head-major float copies were a
// Mosaic restriction.
//
// What bounds it on the H100: in bf16 the bytes. q, k, v and out are 51 MB
// at the charades encoder shape (~15 us at 3.35 TB/s); the 5 GFLOP of the
// two products are ~5 us of tensor-core work. In float32 the operations
// (TACoS 16 x 601: 5.9 GFLOP of FMA work, 88 us at 67 TFLOP/s). The (L, L)
// logits never leave the SM.
//
// Design of the packed entry point. In float32 every rounding above is to
// f32, so it computes attention_batched_reference's function; in bf16 it
// computes the same products with more roundings. So it runs the bodies of
// the per-head and all-heads kernels on their grid (attention_grid.cuh: one
// block per (sample, 64-row query tile, head)):
//   - bf16 on the tensor cores (attention_mma.cuh, Chain::PACKED: 4
//     warps, K_h and V_h staged whole with cp.async into swizzled tiles,
//     mma.sync m16n8k16 for both products, an exact two-pass softmax that
//     rounds at the points above; the logits stay in registers up to 256
//     keys (128 at hd 128), e is kept in them between passes; beyond, every
//     pass recomputes the same bf16 values). Up to 3,536 keys at hd 16,
//     1,760 at 32, 864 at 64, 416 at 128;
//   - float32 on the register tiles (attention_regtile.cuh, an online f32
//     softmax a few ulps from the plain version's two-pass one), any Lk.
//
// Design of the pair entry point. bf16 operands (on 16-byte boundaries, as
// for the packed entry point) take the mma body on the same grid
// (attention_mma.cuh, Chain::PAIR: unscaled q and k into the mma, the f32
// sums times the f32 scale, the batched chain's exact two-pass f32
// softmax); the block stages its head's key factor row as one more bit of
// the per-key flag byte, and each thread reads the query factors of its two
// rows. Up to 128 keys (the text keys of the pair sites) a row's logits
// stay in 64 registers a thread, up to 256 in 128; beyond, they are
// streamed. The same key limits as the packed entry point's.
// Float32 operands take a CUDA-core kernel, one block of 8 warps per
// (b, h): K_h and V_h, the key mask and the key factor row are staged once
// in shared memory, so k and v are read from device memory once per head
// and q and out exactly once. One warp owns one query row at a time: its lanes split
// the keys for the logits (the K_h rows are padded to an odd word stride,
// so the 32 lanes hit 32 banks), the softmax is two warp reductions, and for
// P.V each lane owns one output column. The row's logits sit in a per-warp
// shared buffer. It is faster than SDPA at the charades shape. The entry
// point picks the kernel by the operand dtype.

#include "attention_grid.cuh"
#include "attention_mma.cuh"
#include "attention_regtile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// the packed entry point
// ---------------------------------------------------------------------------

template <int HD, bool RESIDENT>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_packed_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                            bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PACKED>(q, k, v, mask, out, Lq, Lk, E,
                                                                scale, b, h, q0, smem);
}

// the pair entry point in bf16: scale is the f32 softmax scale; qf (B, H,
// Lq) and kf (B, H, Lk) the pair factors as uint8. KEYS: the keys whose
// logits stay in registers when RESIDENT
template <int HD, bool RESIDENT, int KEYS>
__global__ void __launch_bounds__(mma_attn::THREADS)
attention_packed_pair_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                                 bf16* __restrict__ out, int H, int Lq, int Lk, int E, float scale,
                                 const uint8_t* __restrict__ qf, const uint8_t* __restrict__ kf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<mma_attn::ROWS>(H, Lq, b, h, q0);
  const size_t bh = (size_t)b * H + h;
  mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, KEYS>(
      q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem, qf + bh * Lq, kf + bh * Lk);
}

// at least 4 blocks an SM (64 registers), as the per-head and all-heads
// kernels' float32 instance
template <int HD>
__global__ void __launch_bounds__(regtile::THREADS, regtile::min_blocks<HD>())
attention_packed_regtile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                                float* __restrict__ out, int H, int Lq, int Lk, int E,
                                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<regtile::BM>(H, Lq, b, h, q0);
  regtile::attend<float, HD>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem);
}

template <int HD>
size_t tiles_smem_bytes(int is_bf16, int Lk) {
  return is_bf16 ? mma_attn::Smem<HD>::bytes(Lk) : regtile::Smem<HD>::bytes;
}

template <int HD>
int launch_tiles(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                 int H, int Lq, int Lk, int E, int is_bf16, float scale, cudaStream_t s) {
  const size_t smem = tiles_smem_bytes<HD>(is_bf16, Lk);
  if (is_bf16) {
    const auto kernel = Lk <= mma_attn::resident_keys<HD>()
                            ? attention_packed_mma_kernel<HD, true>
                            : attention_packed_mma_kernel<HD, false>;
    return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS, smem, q, k, v, mask,
                                                   out, B, H, Lq, Lk, E, scale, s);
  }
  return attn_grid::launch<float, regtile::BM>(attention_packed_regtile_kernel<HD>,
                                               regtile::THREADS, smem, q, k, v, mask, out, B, H,
                                               Lq, Lk, E, scale, s);
}

// the text keys of the pair sites (up to 81 in charades) keep their logits
// in half the registers of RESIDENT_KEYS
constexpr int SHORT_KEYS = 128;

template <int HD>
int launch_pair_mma(const void* q, const void* k, const void* v, const void* mask, const void* qf,
                    const void* kf, void* out, int B, int H, int Lq, int Lk, int E, float scale,
                    cudaStream_t s) {
  const size_t smem = mma_attn::Smem<HD>::bytes(Lk);
  constexpr int RK = mma_attn::resident_keys<HD>();
  const auto kernel = Lk <= SHORT_KEYS ? attention_packed_pair_mma_kernel<HD, true, SHORT_KEYS>
                      : Lk <= RK       ? attention_packed_pair_mma_kernel<HD, true, RK>
                                       : attention_packed_pair_mma_kernel<HD, false, RK>;
  return attn_grid::launch<bf16, mma_attn::ROWS>(kernel, mma_attn::THREADS, smem, q, k, v, mask,
                                                 out, B, H, Lq, Lk, E, scale, s,
                                                 static_cast<const uint8_t*>(qf),
                                                 static_cast<const uint8_t*>(kf));
}

// ---------------------------------------------------------------------------
// the pair entry point on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e9f;

template <int HD>
struct PairSmem {
  static constexpr int KS = HD + 1;  // K_h row stride: an odd number of words
  static size_t bytes(int Lk) {
    size_t b = ((size_t)Lk * KS + (size_t)Lk * HD) * 4;  // K_h, V_h
    b = (b + 15) & ~(size_t)15;
    b += (size_t)WARPS * Lk * 4 + (size_t)WARPS * HD * 4;  // per-warp logits row, q row
    b += 2 * (size_t)Lk;                                    // key mask, key pair factor
    return b;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_packed_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ mask,
                             const uint8_t* __restrict__ qf, const uint8_t* __restrict__ kf,
                             float* __restrict__ out, int H, int Lq, int Lk, int E, int Ev,
                             float scale) {
  constexpr int KS = PairSmem<HD>::KS;
  // output columns per lane in P.V: lane + 32 t for t < PER_LANE (at hd 16
  // lanes 16-31 own none)
  constexpr int PER_LANE = (HD + 31) / 32;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + (size_t)Lk * KS;
  const size_t off = (((size_t)Lk * KS + (size_t)Lk * HD) * 4 + 15) & ~(size_t)15;
  float* ps = reinterpret_cast<float*>(smem + off);
  float* qsm = ps + (size_t)WARPS * Lk;
  uint8_t* ms = reinterpret_cast<uint8_t*>(qsm + WARPS * HD);
  uint8_t* kfs = ms + Lk;

  // stage K_h, V_h, the mask row and the key factor row
  const float* kb = k + (size_t)b * Lk * E + h * HD;
  const float* vb = v + (size_t)b * Lk * Ev + h * HD;
  for (int idx = threadIdx.x; idx < Lk * HD; idx += THREADS) {
    const int j = idx / HD, d = idx - (idx / HD) * HD;
    ks[(size_t)j * KS + d] = kb[(size_t)j * E + d];
    vs[(size_t)j * HD + d] = vb[(size_t)j * Ev + d];
  }
  for (int j = threadIdx.x; j < Lk; j += THREADS) {
    ms[j] = mask[(size_t)b * Lk + j];
    kfs[j] = kf[((size_t)b * H + h) * Lk + j];
  }
  __syncthreads();

  float* prow = ps + (size_t)warp * Lk;
  float* qrow = qsm + warp * HD;
  for (int qi = warp; qi < Lq; qi += WARPS) {
    const float* qsrc = q + ((size_t)b * Lq + qi) * E + h * HD;
    for (int d = lane; d < HD; d += 32) qrow[d] = qsrc[d] * scale;
    const bool qflag = qf[((size_t)b * H + h) * Lq + qi] != 0;
    __syncwarp();
    float qr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qrow[d];

    // logits, lanes split the keys
    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + (size_t)j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], kr[d], acc);
      float l = acc;
      if (qflag && kfs[j]) l = NEG_INF;
      if (!ms[j]) l = NEG_INF;
      prow[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));

    // f32 exp and denominator
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < Lk; j += 32) prow[j] = prow[j] / sum;
    __syncwarp();

    // P.V: each lane owns PER_LANE output columns
    float acc[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) acc[t] = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t)
        if (lane + 32 * t < HD) acc[t] = fmaf(p, vs[(size_t)j * HD + lane + 32 * t], acc[t]);
    }
    float* dst = out + ((size_t)b * Lq + qi) * Ev + h * HD;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t)
      if (lane + 32 * t < HD) dst[lane + 32 * t] = acc[t];
    __syncwarp();  // prow and qrow are rewritten by the next row
  }
}

template <int HD>
int launch_pair(const void* q, const void* k, const void* v, const void* mask, const void* qf,
                const void* kf, void* out, int B, int H, int Lq, int Lk, int E, int Ev,
                float scale, cudaStream_t stream) {
  const size_t smem = PairSmem<HD>::bytes(Lk);
  cudaError_t err = cudaFuncSetAttribute(attention_packed_pair_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_packed_pair_kernel<HD><<<B * H, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(qf),
      static_cast<const uint8_t*>(kf), static_cast<float*>(out), H, Lq, Lk, E, Ev, scale);
  return (int)cudaGetLastError();
}

// a block's shared memory on the pair entry point: the mma staging in bf16,
// the CUDA-core kernel's in float32
template <int HD>
size_t pair_smem_bytes(int is_bf16, int Lk) {
  return is_bf16 ? mma_attn::Smem<HD>::bytes(Lk) : PairSmem<HD>::bytes(Lk);
}

template <int HD>
int launch_pair_entry(const void* q, const void* k, const void* v, const void* mask,
                      const void* qf, const void* kf, void* out, int B, int H, int Lq, int Lk,
                      int E, int Ev, int is_bf16, float scale, cudaStream_t s) {
  if (is_bf16) return launch_pair_mma<HD>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, scale, s);
  return launch_pair<HD>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, Ev, scale, s);
}

bool valid(int B, int H, int Lq, int Lk, int E, int Ev) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && E % H == 0 && Ev == E;
}

}  // namespace

// Shared memory a block of the packed entry point needs for bf16 (is_bf16 =
// 1) or float32 operands, head_dim `hd` (16, 32, 64 or 128) and `Lk` keys (0
// for another hd), so the wrapper can refuse before launching: bf16 stages
// every key of the head (up to 3,536 keys at hd 16, 1,760 at 32, 864 at 64,
// 416 at 128); float32 streams the keys in tiles and takes any Lk.
extern "C" long long attention_packed_nopair_smem_bytes(int is_bf16, int hd, int Lk) {
  return attn_grid::by_head_dim(hd, 0LL, [&](auto c) {
    return (long long)tiles_smem_bytes<decltype(c)::value>(is_bf16, Lk);
  });
}

// The same for a block of the pair entry point: bf16 stages as the packed
// entry point; float32 stages K_h and V_h whole (up to 1,397 keys at hd 16,
// 787 at 32, 418 at 64, 215 at 128).
extern "C" long long attention_packed_smem_bytes(int is_bf16, int hd, int Lk) {
  return attn_grid::by_head_dim(hd, 0LL, [&](auto c) {
    return (long long)pair_smem_bytes<decltype(c)::value>(is_bf16, Lk);
  });
}

// Plain C entry points, bound with ctypes. q: (B, Lq, E), k: (B, Lk, E),
// v: (B, Lk, Ev), out: (B, Lq, Ev), all bf16 (is_bf16 = 1) or all float32,
// contiguous; mask: (B, Lk) uint8, 1 = attendable. Head h reads and writes
// columns [h*hd, (h+1)*hd) with hd = E / H = Ev / H, 16, 32, 64 or 128. Each
// returns the cudaError_t of the launch (0 = success).
//
// attention_packed_launch: q, k, v and out 16-byte aligned; scale is the
// softmax scale already rounded to the operand dtype.
extern "C" int attention_packed_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int B, int H, int Lq, int Lk,
                                       int E, int Ev, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, Lq, Lk, E, Ev)) return (int)cudaErrorInvalidValue;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    return launch_tiles<decltype(c)::value>(q, k, v, mask, out, B, H, Lq, Lk, E, is_bf16, scale,
                                            s);
  });
}

// attention_packed_pair_launch: bf16 on the mma body (q, k, v and out
// 16-byte aligned), float32 on the CUDA cores; qf (B, H, Lq) and kf (B, H,
// Lk) uint8 pair factors (pair (q, k) of head (b, h) is masked when both
// are 1); scale is the f32 softmax scale.
extern "C" int attention_packed_pair_launch(const void* q, const void* k, const void* v,
                                            const void* mask, const void* qf, const void* kf,
                                            void* out, int B, int H, int Lq, int Lk, int E, int Ev,
                                            int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, Lq, Lk, E, Ev)) return (int)cudaErrorInvalidValue;
  return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue, [&](auto c) {
    return launch_pair_entry<decltype(c)::value>(q, k, v, mask, qf, kf, out, B, H, Lq, Lk, E, Ev,
                                                 is_bf16, scale, s);
  });
}
