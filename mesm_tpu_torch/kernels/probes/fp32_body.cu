// Probes of the float32 attention forward (attention_fp32.cuh), for
// measurement only: no wrapper or model path calls them. Built and timed by
// probe_fp32_body.py at the repo root.
//
// - p_*: the body of fp32_attn::block_attend (no pair flags) with parts
//   left out, at the TACoS encoder's head_dim 32 (and 128): no S product
//   (S read from the K tile instead), no P . V product, no products, no
//   online softmax, no split of the K / V tiles. What a part costs is the
//   full variant's time less the time without it; the variants without a
//   part compute garbage and are not checked.
// - wg_fwd: the same function at head_dim 32 with both products on wgmma
//   m64n32k8 TF32 (3xTF32): S from Q and K in 128-byte swizzled shared
//   memory (both K-major as they stand), P . V with P's split from
//   registers and V split into a transposed tile, its keys permuted so that
//   the C tile of S is P's A fragment. Checked against the plain version.

#include "attention_fp32.cuh"
#include "attention_grid.cuh"

using namespace tf32x3;
using fp32_attn::Online;
using fp32_attn::SplitRows;

// probe flags: 8 skip S, 16 skip P.V, 32 skip the softmax, 64 skip the K/V splits
template <int HD, int V>
__device__ __forceinline__ void body(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                                     float* __restrict__ out, int Lq, int Lk, int E, float scale,
                                     int b, int h, int q0, unsigned char* smem) {
  constexpr bool NOS = V & 8, NOPV = V & 16, NOSM = V & 32, NOSPLIT = V & 64;
  constexpr int KT = 32;
  constexpr int ROWS = 64, THREADS = 128;
  constexpr int R = RS<HD>, T1 = KT * R, NT = KT / 8;
  float* Qh = reinterpret_cast<float*>(smem);
  float* Ql = Qh + ROWS * R;
  float* buf = Ql + ROWS * R;
  uint8_t* Fs = reinterpret_cast<uint8_t*>(buf + 8 * T1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int rows = min(ROWS, Lq - q0);
  const float* kb = k + (size_t)b * Lk * E + h * HD;
  const float* vb = v + (size_t)b * Lk * E + h * HD;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  const int ntiles = (Lk + KT - 1) / KT;
  const bool active = 16 * warp < rows;
  stage_tile<HD, ROWS, THREADS>(Qh, q + ((size_t)b * Lq + q0) * E + h * HD, rows, E);
  cp_async_commit();
  const SplitRows<HD> qs{Qh + (16 * warp + g) * R + t, Ql + (16 * warp + g) * R + t};
  Online<HD / 8> st;
  bool first = true;
  walk(
      ntiles,
      [&](int it, int bi) {
        const int k0 = it * KT;
        float* base = buf + bi * 4 * T1;
        stage_tile<HD, KT, THREADS>(base, kb + (size_t)k0 * E, min(KT, Lk - k0), E);
        stage_tile<HD, KT, THREADS>(base + 2 * T1, vb + (size_t)k0 * E, min(KT, Lk - k0), E);
        if (tid < KT) Fs[bi * KT + tid] = key_flag(mask_b, k0 + tid, Lk);
        cp_async_commit();
      },
      [&](int bi) {
        if (first) {
          split_tile<HD, ROWS, THREADS>(Qh, Ql, scale);
          first = false;
        }
        if (NOSPLIT) return;
        float* base = buf + bi * 4 * T1;
        split_tile<HD, KT, THREADS>(base, base + T1, 1.f);
        split_tile<HD, KT, THREADS>(base + 2 * T1, base + 3 * T1, 1.f);
      },
      [&](int it, int bi) {
        if (!active) return;
        const float* base = buf + bi * 4 * T1;
        float s[NT][4];
        if constexpr (NOS) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[nt][i] = base[(8 * nt + g) * R + t + i];
        } else {
          product_nt<HD, NT>(s, qs, SplitTile{base, base + T1}, 0, lane);
        }
        float alpha0 = 1.f, alpha1 = 1.f;
        if constexpr (!NOSM) st.template update<NT>(s, Fs + bi * KT, t, false, false, alpha0, alpha1);
        constexpr int ND = HD / 8, NH = HD >= 128 ? HD / 16 : HD / 8;
        const SplitTile Vt{base + 2 * T1, base + 3 * T1};
#pragma unroll
        for (int n0 = 0; n0 < ND; n0 += NH) {
          float part[NH][4];
          if constexpr (NOPV) {
#pragma unroll
            for (int nd = 0; nd < NH; ++nd)
#pragma unroll
              for (int i = 0; i < 4; ++i) part[nd][i] = s[nd % NT][i];
          } else {
            product_kt<HD, KT, NH>(part, s, Vt, 0, lane, n0);
          }
#pragma unroll
          for (int nd = 0; nd < NH; ++nd) {
            st.o[n0 + nd][0] = fmaf(st.o[n0 + nd][0], alpha0, part[nd][0]);
            st.o[n0 + nd][1] = fmaf(st.o[n0 + nd][1], alpha0, part[nd][1]);
            st.o[n0 + nd][2] = fmaf(st.o[n0 + nd][2], alpha1, part[nd][2]);
            st.o[n0 + nd][3] = fmaf(st.o[n0 + nd][3], alpha1, part[nd][3]);
          }
        }
      },
      [](int) {});
  if (NOSM) st.l0 = st.l1 = 1.f;
  if (active) st.store(out + h * HD, (size_t)b * Lq, q0 + 16 * warp + g, Lq, E, t);
}

template <int HD, int V>
constexpr size_t smem_of() {
  return (size_t)(2 * 64 + 8 * 32) * RS<HD> * 4 + 2 * 32;
}
template <int HD, int V, int MINB>
__global__ void __launch_bounds__(128, MINB)
var_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const uint8_t* __restrict__ mask, float* __restrict__ out, int H, int Lq, int Lk, int E,
           float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b, h, q0;
  attn_grid::block_coords<64>(H, Lq, b, h, q0);
  body<HD, V>(q, k, v, mask, out, Lq, Lk, E, scale, b, h, q0, smem);
}

template <int HD, int V, int MINB>
int launch_v(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
             int Lq, int Lk, int E, float scale, void* s) {
  return attn_grid::launch<float, 64>(var_kernel<HD, V, MINB>, 128, smem_of<HD, V>(), q, k, v, mask,
                                      out, B, H, Lq, Lk, E, scale, (cudaStream_t)s);
}

#define ENTRY(NAME, HD, V, MINB)                                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* mask, void* out,  \
                      int B, int H, int Lq, int Lk, int E, float scale, void* s) {               \
    return launch_v<HD, V, MINB>(q, k, v, mask, out, B, H, Lq, Lk, E, scale, s);                 \
  }
ENTRY(p_full, 32, 0, 4)
ENTRY(p_nos, 32, 8, 4)
ENTRY(p_nopv, 32, 16, 4)
ENTRY(p_nosm, 32, 32, 4)
ENTRY(p_nosplit, 32, 64, 4)
ENTRY(p_noprod, 32, 24, 4)
ENTRY(p128_full, 128, 0, 1)
ENTRY(p128_noprod, 128, 24, 1)

// ---- wgmma

namespace wg {
using namespace tf32x3;
constexpr int THREADS = 128, ROWS = 64, KT = 32, HD = 32;

// byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fffu) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

#define D16(d) "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
  "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),            \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])

__device__ __forceinline__ void ss_n32(float (&d)[4][4], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : D16(d) : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void rs_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// layout (bytes): Qh, Ql [64][128B]; 2 buffers of { Kh, Kl [32][128B], V [32][32 f32],
// Vth, Vtl [32 cols][128B of 32 keys] }; 2 x 32 flags
constexpr int QB = ROWS * 128, KB = KT * 128, BUF = 5 * KB;
constexpr size_t SMEM = 1024 + 2 * QB + 2 * BUF + 2 * KT;

// the position of key j (within its 8) in the permuted k order: key 2t -> t, 2t + 1 -> t + 4
__device__ __forceinline__ int perm(int j) { return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1); }

__global__ void __launch_bounds__(THREADS, 4)
fwd_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const uint8_t* __restrict__ mask, float* __restrict__ out, int H, int Lq, int Lk,
                 int E, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* Qh = smem;
  unsigned char* Ql = Qh + QB;
  unsigned char* bufs = Ql + QB;
  uint8_t* Fs = bufs + 2 * BUF;
  int b, h, q0;
  attn_grid::block_coords<ROWS>(H, Lq, b, h, q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int rows = min(ROWS, Lq - q0);
  const float* qb = q + ((size_t)b * Lq + q0) * E + h * HD;
  const float* kb = k + (size_t)b * Lk * E + h * HD;
  const float* vb = v + (size_t)b * Lk * E + h * HD;
  const uint8_t* mask_b = mask + (size_t)b * Lk;
  const int ntiles = (Lk + KT - 1) / KT;
  // stage Q (swizzled), rows past Lq zero
  for (int i = tid; i < ROWS * 8; i += THREADS) {
    const int r = i / 8, c = i % 8;
    unsigned char* d = Qh + swz(r, c);
    if (r < rows) cp_async16(d, qb + (size_t)r * E + 4 * c);
    else *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  fp32_attn::Online<HD / 8> st;
  bool first = true;
  walk(
      ntiles,
      [&](int it, int bi) {
        const int k0 = it * KT, kn = min(KT, Lk - k0);
        unsigned char* base = bufs + bi * BUF;
        for (int i = tid; i < KT * 8; i += THREADS) {
          const int r = i / 8, c = i % 8;
          unsigned char* dk = base + swz(r, c);
          unsigned char* dv = base + 2 * KB + r * 128 + c * 16;
          if (r < kn) {
            cp_async16(dk, kb + (size_t)(k0 + r) * E + 4 * c);
            cp_async16(dv, vb + (size_t)(k0 + r) * E + 4 * c);
          } else {
            *reinterpret_cast<float4*>(dk) = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(dv) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        if (tid < KT) Fs[bi * KT + tid] = key_flag(mask_b, k0 + tid, Lk);
        cp_async_commit();
      },
      [&](int bi) {
        if (first) {
          for (int i = tid; i < ROWS * 8; i += THREADS) {
            const int off = swz(i / 8, i % 8);
            const float4 x = *reinterpret_cast<const float4*>(Qh + off);
            uint4 hh, ll;
            split(x.x * scale, hh.x, ll.x);
            split(x.y * scale, hh.y, ll.y);
            split(x.z * scale, hh.z, ll.z);
            split(x.w * scale, hh.w, ll.w);
            *reinterpret_cast<uint4*>(Qh + off) = hh;
            *reinterpret_cast<uint4*>(Ql + off) = ll;
          }
          first = false;
        }
        unsigned char* base = bufs + bi * BUF;
        for (int i = tid; i < KT * 8; i += THREADS) {
          const int r = i / 8, c = i % 8;
          const int off = swz(r, c);
          const float4 x = *reinterpret_cast<const float4*>(base + off);
          uint4 hh, ll;
          split(x.x, hh.x, ll.x);
          split(x.y, hh.y, ll.y);
          split(x.z, hh.z, ll.z);
          split(x.w, hh.w, ll.w);
          *reinterpret_cast<uint4*>(base + off) = hh;
          *reinterpret_cast<uint4*>(base + KB + off) = ll;
          // V: key r, columns 4c .. 4c + 3 -> rows 4c + u of V^T at the permuted key
          const float4 y = *reinterpret_cast<const float4*>(base + 2 * KB + r * 128 + c * 16);
          const float yv[4] = {y.x, y.y, y.z, y.w};
          const int kp = perm(r);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t vh, vl;
            split(yv[u], vh, vl);
            const int n = 4 * c + u;
            const int o = swz(n, kp >> 2) + (kp & 3) * 4;
            *reinterpret_cast<uint32_t*>(base + 3 * KB + o) = vh;
            *reinterpret_cast<uint32_t*>(base + 4 * KB + o) = vl;
          }
        }
        fence_async();
      },
      [&](int, int bi) {
        unsigned char* base = bufs + bi * BUF;
        const uint64_t dqh = desc(Qh), dql = desc(Ql), dkh = desc(base), dkl = desc(base + KB);
        const uint64_t dvh = desc(base + 3 * KB), dvl = desc(base + 4 * KB);
        float s[4][4];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
          const uint64_t o = 2 * ks;
          ss_n32(s, dql + o, dkh + o, ks);
          ss_n32(s, dqh + o, dkl + o, 1);
          ss_n32(s, dqh + o, dkh + o, 1);
        }
        wg_commit();
        wg_wait0();
        float alpha0, alpha1;
        st.template update<4>(s, Fs + bi * KT, t, false, false, alpha0, alpha1);
        uint32_t ah[KT / 8][4], al[KT / 8][4];
#pragma unroll
        for (int ks = 0; ks < KT / 8; ++ks) {
          split(s[ks][0], ah[ks][0], al[ks][0]);
          split(s[ks][2], ah[ks][1], al[ks][1]);
          split(s[ks][1], ah[ks][2], al[ks][2]);
          split(s[ks][3], ah[ks][3], al[ks][3]);
        }
        float part[4][4];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KT / 8; ++ks) {
          const uint64_t o = 2 * ks;
          rs_n32(part, al[ks], dvh + o, ks);
          rs_n32(part, ah[ks], dvl + o, 1);
          rs_n32(part, ah[ks], dvh + o, 1);
        }
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) {
          st.o[nd][0] = fmaf(st.o[nd][0], alpha0, part[nd][0]);
          st.o[nd][1] = fmaf(st.o[nd][1], alpha0, part[nd][1]);
          st.o[nd][2] = fmaf(st.o[nd][2], alpha1, part[nd][2]);
          st.o[nd][3] = fmaf(st.o[nd][3], alpha1, part[nd][3]);
        }
      },
      [](int) {});
  if (16 * warp < rows) st.store(out + h * HD, (size_t)b * Lq, q0 + 16 * warp + g, Lq, E, t);
}
}  // namespace wg

extern "C" int wg_fwd(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                         int H, int Lq, int Lk, int E, float scale, void* s) {
  return attn_grid::launch<float, wg::ROWS>(wg::fwd_wgmma_kernel, wg::THREADS, wg::SMEM, q, k, v, mask,
                                            out, B, H, Lq, Lk, E, scale, (cudaStream_t)s);
}
