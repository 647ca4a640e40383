// Flash attention backward for Hopper (sm_90a): the gradients of the
// forward in flash_attention.cu with respect to q, k and v.
//
// Replaces no Pallas kernel.  The TPU kernel (src/repro/kernels/
// flash_attention.py:73 flash_attention_tpu) has no backward; the
// reference trains through its jnp chunked flash
// (src/repro/models/attention.py:154 flash_attention), which XLA
// differentiates.  The port's forward is a CUDA kernel with no autograd
// rule, so training on the card needs this one.
//
// What it computes, for q [B, G, P, Sq, hd], k and v [B, G, Sk, hd], the
// forward's output o and its gradient dO (strided views, the last
// dimension dense; float32 or bf16, all one type), with scale = hd**-0.5
// and the forward's mask (causal: kpos <= qpos; window > 0: kpos > qpos -
// window; positions q_offset + i and j):
//   S   = (q * scale) . k^T           P  = exp(S - lse)
//   dP  = dO . v^T                    dS = P * (dP - D),  D = rowsum(dO * o)
//   dv  = sum over the group's P heads of P^T . dO
//   dk  = sum over the group's P heads of dS^T . (q * scale)
//   dq  = dS . k * scale
// in float32, written in the inputs' type.  The softmax weights are the
// exact float32 ones whatever the forward's p_bf16 mode rounded: the
// gradient of the softmax, not of its bf16 rounding.
//
// Three launches, in order, on the caller's stream:
//   1. flash_bwd_stats: one block per (b, g, p, 64 q rows).  lse = m +
//      log(l) by an online pass over the visible 64-row kv tiles (S only),
//      and D from o and dO; both float32 [B, G, P, Sq] scratch.
//   2. flash_bwd_dkdv: one block per (b, g, 32 kv rows).  It loops over the
//      group's P heads and, for each, over the visible 64-row q tiles:
//      recomputes S, P, dP and dS for the 64 x 32 tile, and accumulates dk
//      and dv for its 32 rows in registers (2 rows x hd/16 columns a
//      thread of each).  So the P heads that share a kv head are summed in
//      the block: no atomics, and the sums run in one fixed order, so two
//      calls give the same bits.
//   3. flash_bwd_dq: one block per (b, g, p, 64 q rows) over the visible
//      32-row kv tiles, dq in registers (4 rows x hd/16 columns a thread).
// Every block walks only the tiles its rows can see (the block-uniform
// test of block_visible in src/repro/models/attention.py); hidden pairs
// inside a visible tile get P = 0.
//
// What bounds it on an H100: operations.  The essential work is five
// products of 2 * hd FLOP per visible (q, k) pair and head (S, dV, dP, dK,
// dQ); at gemma-2b's training shape (B 4, G 1, P 8, hd 256, Sq = Sk =
// 1,024, causal) that is 43.0 GFLOP a layer on 16.8 MB of bf16 tensors:
// far above the ridge, so the bound is the bf16 tensor-core rate.  This
// first kernel does not approach it: it is plain float32 FMAs from shared
// memory (the float32 forward's design), 16 * hd FLOP a pair and head (S
// three times, dP twice, dV, dK and dQ once each), at most 67 TFLOP/s of
// float32 and in practice bound by shared-memory reads.  mma.sync or wgmma
// tiles, as the bf16 forward has, are the next step.
//
// Widths: hd in {16, 32, 64, 128, 256} (a template each: the smoke
// configs' 16, Llama 4 Scout's 128 and gemma-2b's 256).  Shared memory is
// float32 with an odd row stride (hd + 1), so 16 lanes reading 16 rows hit
// 16 banks; at hd = 256 the dkdv block takes 214,784 bytes, one block an
// SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;     // 16 row groups x 16 column lanes
constexpr int kBQ = 64;           // q rows per tile
constexpr int kBK = 32;           // kv rows per tile (dkdv, dq)
constexpr int kBKS = 64;          // kv rows per tile (stats)
constexpr int kPS = kBK + 1;      // row stride of the P and dS tiles

struct Bwd {
  int B, G, P, Sq, Sk, hd;
  int causal, window, q_offset;
  float scale;
  int64_t qs[4], os[4], dos[4], dqs[4];  // element strides (batch, group, head, row)
  int64_t ks[3], vs[3], dks[3], dvs[3];  // element strides (batch, group, row)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// may a q position in [qlo, qhi] see a key in [klo, khi]?  (block_visible)
__device__ __forceinline__ bool tile_visible(const Bwd& s, int qlo, int qhi, int klo, int khi) {
  if (s.causal && klo > qhi) return false;
  if (s.window > 0 && khi < qlo - s.window + 1) return false;
  return true;
}

__device__ __forceinline__ bool pair_visible(const Bwd& s, int qpos, int kpos) {
  bool ok = kpos < s.Sk;
  if (s.causal) ok = ok && kpos <= qpos;
  if (s.window > 0) ok = ok && kpos > qpos - s.window;
  return ok;
}

// rows [0, rows) of a tile into shared memory (row stride ld) in float32,
// times mul; rows at or past nvalid are 0
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int64_t row_stride,
                                          int rows, int nvalid, float mul) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    dst[r * ld + c] = r < nvalid ? to_f(src[r * row_stride + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int64_t stat_row(const Bwd& s, int b, int g, int head) {
  return ((static_cast<int64_t>(b) * s.G + g) * s.P + head) * s.Sq;
}

// ---------------------------------------------------------------------------
// 1. lse and D
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                       const T* __restrict__ dout, float* __restrict__ lse,
                       float* __restrict__ dsum, Bwd s) {
  constexpr int HD = NC * 16, LD = HD + 1;
  extern __shared__ float smem[];
  float* s_q = smem;             // [kBQ][LD], scaled
  float* s_k = s_q + kBQ * LD;   // [kBKS][LD]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, b = blockIdx.z / s.G, g = blockIdx.z % s.G;
  const int nq = min(kBQ, s.Sq - q0);
  const T* qg = q + b * s.qs[0] + g * s.qs[1] + head * s.qs[2] + q0 * s.qs[3];
  const T* og = o + b * s.os[0] + g * s.os[1] + head * s.os[2] + q0 * s.os[3];
  const T* dg = dout + b * s.dos[0] + g * s.dos[1] + head * s.dos[2] + q0 * s.dos[3];
  const T* kg = k + b * s.ks[0] + g * s.ks[1];
  load_rows<T, HD>(s_q, LD, qg, s.qs[3], kBQ, nq, s.scale);

  const int r0 = (tid / 16) * 4, cl = tid % 16;
  float dd[4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    float acc = 0.f;
    if (r < nq) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc = fmaf(to_f(dg[r * s.dos[3] + cl + 16 * c]), to_f(og[r * s.os[3] + cl + 16 * c]), acc);
    }
    dd[i] = half_warp_sum(acc);
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int qlo = s.q_offset + q0, qhi = s.q_offset + q0 + nq - 1;
  for (int k0 = 0; k0 < s.Sk; k0 += kBKS) {
    const int nk = min(kBKS, s.Sk - k0);
    if (!tile_visible(s, qlo, qhi, k0, k0 + nk - 1)) continue;
    __syncthreads();  // the previous tile's readers are done (and s_q is loaded)
    load_rows<T, HD>(s_k, LD, kg + k0 * s.ks[2], s.ks[2], kBKS, nk, 1.f);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = s_q[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = s_k[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qlo + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!pair_visible(s, qpos, k0 + cl + 16 * j)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(sc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }

  if (cl == 0) {
    const int64_t base = stat_row(s, b, g, head) + q0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= nq) continue;
      // a row that sees no key gets P = 0 everywhere, as its output is 0
      lse[base + r0 + i] = l[i] > 0.f ? m[i] + logf(l[i]) : -kNegInf;
      dsum[base + r0 + i] = dd[i];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * ((2 * kBK + 2 * kBQ) * static_cast<size_t>(HD + 1) + 2 * kBQ * kPS +
                          2 * kBQ);
}

// S and dP of a 64 x 32 tile: q rows r0 .. r0+3 against kv rows cl, cl+16
template <int HD>
__device__ __forceinline__ void score_tiles(const float* s_q, const float* s_do, const float* s_k,
                                            const float* s_v, int r0, int cl, float sc[4][2],
                                            float dp[4][2]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], da[4], kb[2], vb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = s_q[(r0 + i) * LD + d];
      da[i] = s_do[(r0 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kb[j] = s_k[(cl + 16 * j) * LD + d];
      vb[j] = s_v[(cl + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                      Bwd s) {
  constexpr int HD = NC * 16, LD = HD + 1;
  extern __shared__ float smem[];
  float* s_k = smem;                 // [kBK][LD]
  float* s_v = s_k + kBK * LD;       // [kBK][LD]
  float* s_q = s_v + kBK * LD;       // [kBQ][LD], scaled
  float* s_do = s_q + kBQ * LD;      // [kBQ][LD]
  float* s_p = s_do + kBQ * LD;      // [kBQ][kPS]
  float* s_ds = s_p + kBQ * kPS;     // [kBQ][kPS]
  float* s_lse = s_ds + kBQ * kPS;   // [kBQ]
  float* s_dd = s_lse + kBQ;         // [kBQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / s.G, g = blockIdx.y % s.G;
  const int nk = min(kBK, s.Sk - k0);
  load_rows<T, HD>(s_k, LD, k + b * s.ks[0] + g * s.ks[1] + k0 * s.ks[2], s.ks[2], kBK, nk, 1.f);
  load_rows<T, HD>(s_v, LD, v + b * s.vs[0] + g * s.vs[1] + k0 * s.vs[2], s.vs[2], kBK, nk, 1.f);

  const int r0 = (tid / 16) * 4, cl = tid % 16;  // the score tile's rows and columns
  const int kr0 = (tid / 16) * 2;                // the accumulators' kv rows
  float acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int head = 0; head < s.P; ++head) {
    const T* qh = q + b * s.qs[0] + g * s.qs[1] + head * s.qs[2];
    const T* dh = dout + b * s.dos[0] + g * s.dos[1] + head * s.dos[2];
    const float* lh = lse + stat_row(s, b, g, head);
    const float* dsh = dsum + stat_row(s, b, g, head);
    for (int q0 = 0; q0 < s.Sq; q0 += kBQ) {
      const int nq = min(kBQ, s.Sq - q0);
      const int qlo = s.q_offset + q0;
      if (!tile_visible(s, qlo, qlo + nq - 1, k0, k0 + nk - 1)) continue;
      __syncthreads();  // the previous tile's readers are done (and s_k, s_v are loaded)
      load_rows<T, HD>(s_q, LD, qh + q0 * s.qs[3], s.qs[3], kBQ, nq, s.scale);
      load_rows<T, HD>(s_do, LD, dh + q0 * s.dos[3], s.dos[3], kBQ, nq, 1.f);
      if (tid < kBQ) {
        s_lse[tid] = tid < nq ? lh[q0 + tid] : 0.f;
        s_dd[tid] = tid < nq ? dsh[q0 + tid] : 0.f;
      }
      __syncthreads();
      float sc[4][2], dp[4][2];
      score_tiles<HD>(s_q, s_do, s_k, s_v, r0, cl, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = cl + 16 * j;
          const float p = (r < nq && pair_visible(s, qlo + r, k0 + c))
                              ? expf(sc[i][j] - s_lse[r]) : 0.f;
          s_p[r * kPS + c] = p;
          s_ds[r * kPS + c] = p * (dp[i][j] - s_dd[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < kBQ; ++rr) {
        float pa[2], da[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pa[i] = s_p[rr * kPS + kr0 + i];
          da[i] = s_ds[rr * kPS + kr0 + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float qv = s_q[rr * LD + cl + 16 * c];
          const float ov = s_do[rr * LD + cl + 16 * c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc_v[i][c] = fmaf(pa[i], ov, acc_v[i][c]);
            acc_k[i][c] = fmaf(da[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kr0 + i;
    if (r >= nk) continue;
    T* dkr = dk + b * s.dks[0] + g * s.dks[1] + (k0 + r) * s.dks[2];
    T* dvr = dv + b * s.dvs[0] + g * s.dvs[1] + (k0 + r) * s.dvs[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[cl + 16 * c] = from_f<T>(acc_k[i][c]);
      dvr[cl + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * kBQ + 2 * kBK) * static_cast<size_t>(HD + 1) + kBQ * kPS);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq, Bwd s) {
  constexpr int HD = NC * 16, LD = HD + 1;
  extern __shared__ float smem[];
  float* s_q = smem;                 // [kBQ][LD], scaled
  float* s_do = s_q + kBQ * LD;      // [kBQ][LD]
  float* s_k = s_do + kBQ * LD;      // [kBK][LD]
  float* s_v = s_k + kBK * LD;       // [kBK][LD]
  float* s_ds = s_v + kBK * LD;      // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, b = blockIdx.z / s.G, g = blockIdx.z % s.G;
  const int nq = min(kBQ, s.Sq - q0);
  load_rows<T, HD>(s_q, LD, q + b * s.qs[0] + g * s.qs[1] + head * s.qs[2] + q0 * s.qs[3],
                   s.qs[3], kBQ, nq, s.scale);
  load_rows<T, HD>(s_do, LD,
                   dout + b * s.dos[0] + g * s.dos[1] + head * s.dos[2] + q0 * s.dos[3],
                   s.dos[3], kBQ, nq, 1.f);
  const T* kg = k + b * s.ks[0] + g * s.ks[1];
  const T* vg = v + b * s.vs[0] + g * s.vs[1];

  const int r0 = (tid / 16) * 4, cl = tid % 16;
  const int64_t base = stat_row(s, b, g, head) + q0;
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = r0 + i < nq ? lse[base + r0 + i] : 0.f;
    dr[i] = r0 + i < nq ? dsum[base + r0 + i] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int qlo = s.q_offset + q0;
  for (int k0 = 0; k0 < s.Sk; k0 += kBK) {
    const int nk = min(kBK, s.Sk - k0);
    if (!tile_visible(s, qlo, qlo + nq - 1, k0, k0 + nk - 1)) continue;
    __syncthreads();  // the previous tile's readers are done (and s_q, s_do are loaded)
    load_rows<T, HD>(s_k, LD, kg + k0 * s.ks[2], s.ks[2], kBK, nk, 1.f);
    load_rows<T, HD>(s_v, LD, vg + k0 * s.vs[2], s.vs[2], kBK, nk, 1.f);
    __syncthreads();
    float sc[4][2], dp[4][2];
    score_tiles<HD>(s_q, s_do, s_k, s_v, r0, cl, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cl + 16 * j;
        const float p = (r < nq && pair_visible(s, qlo + r, k0 + c)) ? expf(sc[i][j] - lr[i])
                                                                      : 0.f;
        s_ds[r * kPS + c] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = s_ds[(r0 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = s_k[kk * LD + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(da[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (r >= nq) continue;
    T* out = dq + b * s.dqs[0] + g * s.dqs[1] + head * s.dqs[2] + (q0 + r) * s.dqs[3];
#pragma unroll
    for (int c = 0; c < NC; ++c) out[cl + 16 * c] = from_f<T>(acc[i][c] * s.scale);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit once per device; ``done``
// holds a bit per device and belongs to the kernel.
template <typename K>
cudaError_t raise_smem_limit(K kernel, size_t bytes, uint64_t& done) {
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done & bit)) return cudaSuccess;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes)))
    return e;
  done |= bit;
  return cudaSuccess;
}

template <typename T, int NC>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
                       const Bwd& s, cudaStream_t st) {
  constexpr int HD = NC * 16;
  constexpr size_t stats_bytes = sizeof(float) * (kBQ + kBKS) * static_cast<size_t>(HD + 1);
  constexpr size_t dkdv_bytes = dkdv_smem_bytes<HD>();
  constexpr size_t dq_bytes = dq_smem_bytes<HD>();
  auto stats = flash_bwd_stats_kernel<T, NC>;
  auto dkdv = flash_bwd_dkdv_kernel<T, NC>;
  auto dqk = flash_bwd_dq_kernel<T, NC>;
  static uint64_t done_stats = 0, done_dkdv = 0, done_dq = 0;
  if (cudaError_t e = raise_smem_limit(stats, stats_bytes, done_stats)) return e;
  if (cudaError_t e = raise_smem_limit(dkdv, dkdv_bytes, done_dkdv)) return e;
  if (cudaError_t e = raise_smem_limit(dqk, dq_bytes, done_dq)) return e;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* dd = static_cast<const T*>(dout);
  const int bg = s.B * s.G;
  if (s.Sq > 0) {
    const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.P, bg);
    stats<<<grid, kThreads, stats_bytes, st>>>(qq, kk, oo, dd, lse, dsum, s);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  if (s.Sk > 0) {
    const dim3 grid((s.Sk + kBK - 1) / kBK, bg);
    dkdv<<<grid, kThreads, dkdv_bytes, st>>>(qq, kk, vv, dd, lse, dsum, static_cast<T*>(dk),
                                             static_cast<T*>(dv), s);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  if (s.Sq > 0) {
    const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.P, bg);
    dqk<<<grid, kThreads, dq_bytes, st>>>(qq, kk, vv, dd, lse, dsum, static_cast<T*>(dq), s);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, void* dq, void* dk, void* dv, float* lse,
                         float* dsum, const Bwd& s, cudaStream_t st) {
  switch (s.hd) {
    case 16: return launch_bwd<T, 1>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 32: return launch_bwd<T, 2>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 64: return launch_bwd<T, 4>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 128: return launch_bwd<T, 8>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 256: return launch_bwd<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bf16 (every tensor); hd in {16, 32, 64, 128, 256}.
// Strides are in elements: q, o, dout, dq (batch, group, head, row); k, v,
// dk, dv (batch, group, row); the last dimension of every tensor is dense.
// lse and dsum are float32 [B, G, P, Sq] scratch.
int fa_flash_backward(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
                      int B, int G, int P, int Sq, int Sk, int hd, int dtype, int causal,
                      int window, int q_offset, float scale, const int64_t* qs,
                      const int64_t* ks, const int64_t* vs, const int64_t* os,
                      const int64_t* dos, const int64_t* dqs, const int64_t* dks,
                      const int64_t* dvs, void* stream) {
  if (Sq < 0 || Sk < 0 || window < 0 || P > 65535 || static_cast<int64_t>(B) * G > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || G == 0) return 0;
  Bwd s{B, G, P, Sq, Sk, hd, causal, window, q_offset, scale, {}, {}, {}, {}, {}, {}, {}, {}};
  for (int i = 0; i < 4; ++i) {
    s.qs[i] = qs[i];
    s.os[i] = os[i];
    s.dos[i] = dos[i];
    s.dqs[i] = dqs[i];
  }
  for (int i = 0; i < 3; ++i) {
    s.ks[i] = ks[i];
    s.vs[i] = vs[i];
    s.dks[i] = dks[i];
    s.dvs[i] = dvs[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dsum);
  if (dtype == 0) return dispatch_bwd<float>(q, k, v, o, dout, dq, dk, dv, l, d, s, st);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, d, s, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
