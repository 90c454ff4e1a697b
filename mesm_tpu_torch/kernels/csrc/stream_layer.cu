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
// layer is 44.2 GFLOP (0.045 ms at 989 TFLOP/s in bf16, 0.66 ms at 67 in
// fp32) against ~40 MB of stream in and out and 3 MB of weights.
//
// Design: one block of 256 threads per sample (the TPU grid's NB = 1: at B =
// 128 one wave on 132 SMs). The layer's weights (1.57 MB in bf16, 3.1 MB as
// the f32 parameters read here) and one sample's intermediates (the
// projected q, k, v of 195 rows, 200 KB in bf16; the 195 x 1024 FFN hidden,
// 400 KB) do not fit in a block's 227 KB of shared memory, so the weights
// stream from L2, which holds them whole, and the intermediates live in a
// per-sample scratch in device memory that the wrapper allocates. The block
// owns its sample, so __syncthreads() orders the phases; no grid-wide sync
// is needed. Every product is one routine: 64 x 64 output tiles, each
// thread a 4 x 4 register tile of f32 FMAs over depth steps of 32 staged in
// shared memory as floats, the next step's loads issued before the current
// step's FMAs. The weight products take whole depth steps (D and F
// multiples of 32); the attention products (depth hd and Lk) zero-fill the
// tail. Each head's logits go to an f32 scratch, then a warp per row takes
// the row's max and sum and writes the probabilities, rounded after the
// division as the TPU kernel rounds them (an online softmax would round
// before the last scale). LayerNorm is a warp per row. All products run on
// the CUDA cores, in bf16 too: tensor-core tiles (mma / wgmma) and
// shared-memory weight pipelines are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 64;  // output rows of a tile
constexpr int BN = 64;  // output columns of a tile
constexpr int BK = 32;  // depth of a staged step
constexpr int PAD = 68;  // row stride (floats) of the staged k-major tiles: 16-byte rows
constexpr int PER = BM * BK / THREADS;  // staged elements of each operand per thread
constexpr float NEG_INF = -1e9f;
constexpr float LN_EPS = 1e-5f;

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

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) { *p = __float2bfloat16(v); }

// an operand element as a value of the stream dtype T: an f32 weight is
// rounded to T, a T element converts exactly
template <typename T>
__device__ __forceinline__ float ldT(const float* p) {
  return rnd<T>(*p);
}
template <typename T>
__device__ __forceinline__ float ldT(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C = (ascale * A) . B by the whole block, epi(row, col, f32 sum) for every
// row < M, col < N. A: M x K, row stride lda. B(k, n) = Bm[n * ldb + k] when
// BNK (a torch (out, in) weight, or the keys), else Bm[k * ldb + n]. KTAIL:
// K need not be a multiple of BK (its tail is zero-filled). The caller
// orders the epilogue's writes before their readers with __syncthreads().
template <typename T, bool BNK, bool KTAIL, typename TA, typename TB, typename Epi>
__device__ __forceinline__ void gemm(const TA* A, int lda, float ascale, const TB* Bm, int ldb,
                                     int M, int N, int K, float* As, float* Bs, Epi epi) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += BM)
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      float ra[PER], rb[PER];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int e = tid + i * THREADS;
          const int ka = k0 + e % BK, m = m0 + e / BK;
          ra[i] = (m < M && (!KTAIL || ka < K)) ? ldT<T>(A + (size_t)m * lda + ka) * ascale : 0.f;
          const int kb = k0 + (BNK ? e % BK : e / BN), n = n0 + (BNK ? e / BK : e % BN);
          rb[i] = (n < N && (!KTAIL || kb < K))
                      ? ldT<T>(BNK ? Bm + (size_t)n * ldb + kb : Bm + (size_t)kb * ldb + n)
                      : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < K; k0 += BK) {
        __syncthreads();  // the previous step's tiles are read
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int e = tid + i * THREADS;
          As[(e % BK) * PAD + e / BK] = ra[i];
          if (BNK)
            Bs[(e % BK) * PAD + e / BK] = rb[i];
          else
            Bs[(e / BN) * PAD + e % BN] = rb[i];
        }
        __syncthreads();
        if (k0 + BK < K) fetch(k0 + BK);  // in flight during this step's FMAs
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * PAD + 4 * ty);
          const float4 b = *reinterpret_cast<const float4*>(Bs + kk * PAD + 4 * tx);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + 4 * ty + r, n = n0 + 4 * tx + c;
          if (m < M && n < N) epi(m, n, acc[r][c]);
        }
    }
}

// p = rnd(softmax(S row)) over Lk keys, a warp per row: the row's max and
// sum first, then each exp divided by the sum and rounded
template <typename T>
__device__ void softmax_rows(const float* S, T* P, int Lq, int Lk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < Lq; i += WARPS) {
    const float* row = S + (size_t)i * Lk;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) stf(P + (size_t)i * Lk + j, expf(row[j] - m) / sum);
  }
}

// Y = LN(X) row by row, a warp per row: f32 mean and E[x^2] - mean^2
template <typename T>
__device__ void layernorm_rows(const T* X, T* Y, const float* g, const float* beta, int L, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += WARPS) {
    const T* row = X + (size_t)i * D;
    float s = 0.f, ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = ldf(row + d);
      s += v;
      ss += v * v;
    }
    const float mu = warp_sum(s) / D;
    const float var = warp_sum(ss) / D - mu * mu;
    const float r = rsqrtf(var + LN_EPS);
    for (int d = lane; d < D; d += 32)
      stf(Y + (size_t)i * D + d, (ldf(row + d) - mu) * r * g[d] + beta[d]);
  }
}

struct Args {
  const void *x, *pos, *kin, *vin;
  const uint8_t *mask, *qf, *kf;
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *ln1s, *ln1b, *w1, *b1, *alpha, *w2, *b2,
      *ln2s, *ln2b;
  void *out, *scratch;
  float* logits;
  int Lq, Lk, D, H, F;
  float scale;
};

// elements of T in one sample's scratch: q_in, qp, att, x1, s, y (Lq x D
// each), kp, vp (Lk x D), the FFN hidden (Lq x F), the probabilities (Lq x Lk)
__host__ __device__ long long scratch_elems(int Lq, int Lk, int D, int F) {
  return 6LL * Lq * D + 2LL * Lk * D + (long long)Lq * F + (long long)Lq * Lk;
}

template <typename T, bool SELF, bool PAIR>
__global__ void __launch_bounds__(THREADS) stream_layer_kernel(const Args a) {
  __shared__ __align__(16) float As[BK * PAD];
  __shared__ __align__(16) float Bs[BK * PAD];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, H = a.H, F = a.F, hd = D / H;
  const size_t qd = (size_t)Lq * D, kd = (size_t)Lk * D;
  const T* x = static_cast<const T*>(a.x) + b * qd;
  const T* pos = static_cast<const T*>(a.pos) + b * qd;
  T* out = static_cast<T*>(a.out) + b * qd;
  T* qin = static_cast<T*>(a.scratch) + (size_t)b * scratch_elems(Lq, Lk, D, F);
  T* qp = qin + qd;
  T* att = qp + qd;
  T* x1 = att + qd;
  T* s = x1 + qd;
  T* y = s + qd;
  T* kp = y + qd;
  T* vp = kp + kd;
  T* hid = vp + kd;
  T* P = hid + (size_t)Lq * F;
  float* S = a.logits + (size_t)b * Lq * Lk;
  const uint8_t* mask = a.mask + (size_t)b * Lk;

  for (size_t i = tid; i < qd; i += THREADS) stf(qin + i, ldf(x + i) + ldf(pos + i));
  __syncthreads();

  // the projections
  const T* kin = SELF ? qin : static_cast<const T*>(a.kin) + b * kd;
  const T* vin = SELF ? x : static_cast<const T*>(a.vin) + b * kd;
  gemm<T, true, false>(qin, D, 1.f, a.wq, D, Lq, D, D, As, Bs,
                       [&](int i, int n, float v) { stf(qp + (size_t)i * D + n, v + a.bq[n]); });
  gemm<T, true, false>(kin, D, 1.f, a.wk, D, Lk, D, D, As, Bs,
                       [&](int i, int n, float v) { stf(kp + (size_t)i * D + n, v + a.bk[n]); });
  gemm<T, true, false>(vin, D, 1.f, a.wv, D, Lk, D, D, As, Bs,
                       [&](int i, int n, float v) { stf(vp + (size_t)i * D + n, v + a.bv[n]); });
  __syncthreads();

  // attention, head by head
  for (int h = 0; h < H; ++h) {
    const uint8_t* qf = PAIR ? a.qf + ((size_t)b * H + h) * Lq : nullptr;
    const uint8_t* kf = PAIR ? a.kf + ((size_t)b * H + h) * Lk : nullptr;
    gemm<T, true, true>(qp + h * hd, D, a.scale, kp + h * hd, D, Lq, Lk, hd, As, Bs,
                        [&](int i, int j, float v) {
                          const bool dead = !mask[j] || (PAIR && qf[i] && kf[j]);
                          S[(size_t)i * Lk + j] = dead ? NEG_INF : v;
                        });
    __syncthreads();
    softmax_rows(S, P, Lq, Lk);
    __syncthreads();
    gemm<T, false, true>(P, Lk, 1.f, vp + h * hd, D, Lq, hd, Lk, As, Bs,
                         [&](int i, int d, float v) { stf(att + (size_t)i * D + h * hd + d, v); });
    __syncthreads();
  }

  // out projection, residual, LN1
  gemm<T, true, false>(att, D, 1.f, a.wo, D, Lq, D, D, As, Bs, [&](int i, int n, float v) {
    const size_t o = (size_t)i * D + n;
    stf(x1 + o, ldf(x + o) + rnd<T>(v + a.bo[n]));
  });
  __syncthreads();
  layernorm_rows(x1, s, a.ln1s, a.ln1b, Lq, D);
  __syncthreads();

  // the FFN, residual, LN2
  const float alpha = a.alpha[0];
  gemm<T, true, false>(s, D, 1.f, a.w1, D, Lq, F, D, As, Bs, [&](int i, int n, float v) {
    const float hv = rnd<T>(v + a.b1[n]);
    stf(hid + (size_t)i * F + n, hv > 0.f ? hv : alpha * hv);
  });
  __syncthreads();
  const T* res = SELF ? s : x1;
  gemm<T, true, false>(hid, F, 1.f, a.w2, F, Lq, D, F, As, Bs, [&](int i, int n, float v) {
    const size_t o = (size_t)i * D + n;
    stf(y + o, ldf(res + o) + rnd<T>(v + a.b2[n]));
  });
  __syncthreads();
  layernorm_rows(y, out, a.ln2s, a.ln2b, Lq, D);
}

template <typename T, bool SELF, bool PAIR>
int launch(const Args& a, int B, cudaStream_t stream) {
  stream_layer_kernel<T, SELF, PAIR><<<B, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, bool self_attn, cudaStream_t s) {
  const bool pair = a.qf != nullptr;
  if (self_attn) return pair ? launch<T, true, true>(a, B, s) : launch<T, true, false>(a, B, s);
  return pair ? launch<T, false, true>(a, B, s) : launch<T, false, false>(a, B, s);
}

}  // namespace

// Elements of the stream dtype one sample's scratch takes; the wrapper
// allocates B times that.
extern "C" long long stream_layer_scratch_elems(int Lq, int Lk, int D, int F) {
  return scratch_elems(Lq, Lk, D, F);
}

// Plain C entry point, bound with ctypes. x, pos, out: (B, Lq, D); kin, vin:
// (B, Lk, D) for the T2V flavour (null for the encoder, where Lk = Lq); all
// float32 (is_bf16 = 0) or all bf16, contiguous. mask: (B, Lk) uint8, 1 =
// attendable; qf, kf: (B, H, Lq) and (B, H, Lk) uint8 pair factors, or both
// null. The 17 weights are contiguous float32 in torch's (out, in) layout:
// wq, wk, wv, wo (D, D), w1 (F, D), w2 (D, F), the biases, LayerNorm scales
// and biases as vectors, alpha (1,). scratch: B * stream_layer_scratch_elems
// elements of the stream dtype; logits: B * Lq * Lk float32. D and F are
// multiples of 32 and D of H; scale is (D / H) ** -0.5. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int stream_layer_launch(
    const void* x, const void* pos, const void* kin, const void* vin, const void* mask,
    const void* qf, const void* kf, const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* wo, const void* bo, const void* ln1s,
    const void* ln1b, const void* w1, const void* b1, const void* alpha, const void* w2,
    const void* b2, const void* ln2s, const void* ln2b, void* out, void* scratch, void* logits,
    int B, int Lq, int Lk, int D, int H, int F, int is_bf16, int self_attn, float scale,
    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || F <= 0 || D % H || D % BK || F % BK ||
      (self_attn && Lk != Lq) || (!self_attn && (!kin || !vin)) || (!qf != !kf))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{x, pos, kin, vin, static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(qf),
         static_cast<const uint8_t*>(kf), f(wq), f(bq), f(wk), f(bk), f(wv), f(bv), f(wo), f(bo),
         f(ln1s), f(ln1b), f(w1), f(b1), f(alpha), f(w2), f(b2), f(ln2s), f(ln2b), out, scratch,
         static_cast<float*>(logits), Lq, Lk, D, H, F, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<bf16>(a, B, self_attn != 0, s);
  return dispatch<float>(a, B, self_attn != 0, s);
}
