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
// gradient of the softmax, not of its bf16 rounding.  lse and D are
// float32 [B, G, P] rows of Sq, ls elements apart (ls >= Sq rounded up to
// 64, so that a 64-row tile's 256 bytes load whole).
//
// What bounds it on an H100: operations.  The essential work is five
// products of 2 * hd FLOP per visible (q, k) pair and head (S, dV, dP, dK,
// dQ); at gemma-2b's training shape (B 4, G 1, P 8, hd 256, Sq = Sk =
// 1,024, causal) that is 43.0 GFLOP a layer on 16.8 MB of bf16 tensors:
// far above the ridge, so the bound is the bf16 tensor-core rate.
//
// bf16: tensor cores (wgmma) with TMA loads, lse from the forward.  Three
// passes on the caller's stream (four when the P heads are split):
//   1. flash_bwd_dsum: D, a row per hd / 8 lanes, 16-byte loads (bytes-
//      bound).  When the caller has no lse from the forward (its p_bf16
//      mode sums rounded weights), flash_bwd_stats (below) computes lse and
//      D instead.
//   2. flash_bwd_dkdv_wgmma: one block per (64 kv rows, b, g, split of the
//      P heads), kv tile 0 first (under a causal mask it sees the most q
//      tiles).  K and V stay resident in shared memory; the block's visible
//      (head, 64-row q tile) pairs stream through a ring of stages, each Q,
//      dO (TMA, 128B-swizzled chunks of 64 columns) and the tile's lse and
//      D (a bulk copy), on the stage's "full" mbarrier; both warpgroups
//      arrive on its "empty" one and warpgroup 1's first thread refills it.
//      The two warpgroups split the work by output:
//        warpgroup 0: S^T = K . Q^T (SS wgmma), P^T = exp2(S^T * scale *
//          log2 e - lse * log2 e), masked to 0, handed to warpgroup 1
//          through a 16 KB float32 exchange, then dV += P^T . dO;
//        warpgroup 1: dP^T = V . dO^T (SS), then dS^T = P^T * (dP^T - D)
//          with warpgroup 0's P^T, then dK += dS^T . Q.
//      So each warpgroup keeps one accumulator of 64 x hd (128 registers a
//      thread at hd 256) and does one score product and one gradient
//      product a tile.  P^T and dS^T reach their wgmma as the A operand from
//      registers (the accumulator's layout is the A fragment's), B (dO, Q)
//      is read MN-major.  Two named barriers order the exchange (full,
//      free).  The group's P heads are summed in the block in a fixed
//      order; when there are too few blocks for the card (gemma-2b: G = 1,
//      64 blocks for 132 SMs) the heads are split over nsplit blocks, each
//      writing float32 partials that
//   3. flash_bwd_reduce sums in split order and casts.  No atomics: two
//      calls give the same bits.
//   4. flash_bwd_dq_wgmma: one block per (64 q rows, b, g, head), the q
//      tiles that see the most kv tiles first, as the forward's kernel:
//      Q and dO resident, K and V tiles through the forward's ring, the two
//      warpgroups take every other visible kv tile with their own dQ, summed
//      at the end.  S = Q . K^T and dP = dO . V^T (SS), dS as above, dQ +=
//      dS . K (K read MN-major).
//   The products run on bf16 operands with float32 sums; P^T in dV and dS
//   in dK and dQ are split into hi = bf16(x) and lo = bf16(x - hi), two
//   products each (about 16 mantissa bits of the float32 weights, as the
//   forward's P).  So the tensor cores execute 10 products of 2 * hd FLOP
//   a pair (S twice, dP twice, dV, dK and dQ two each) for the 5 the
//   bound counts.  Scale is applied in float32 (to S, and to dK and dQ at
//   the end), as the forward does.
//
// float32: scalar FMAs from shared memory, three launches (the first
// port's kernels, kept so that float32 stays float32: the tensor cores
// would round the operands):
//   1. flash_bwd_stats: one block per (b, g, p, 64 q rows).  lse = m +
//      log(l) by an online pass over the visible 64-row kv tiles (S only),
//      and D from o and dO.
//   2. flash_bwd_dkdv: one block per (b, g, 32 kv rows).  It loops over the
//      group's P heads and, for each, over the visible 64-row q tiles:
//      recomputes S, P, dP and dS for the 64 x 32 tile, and accumulates dk
//      and dv for its 32 rows in registers (2 rows x hd/16 columns a
//      thread of each).
//   3. flash_bwd_dq: one block per (b, g, p, 64 q rows) over the visible
//      32-row kv tiles, dq in registers (4 rows x hd/16 columns a thread).
//   16 * hd FLOP a pair and head (S three times, dP twice, dV, dK and dQ
//   once each).  Shared memory is float32 with an odd row stride (hd + 1),
//   so 16 lanes reading 16 rows hit 16 banks; at hd = 256 the dkdv block
//   takes 214,784 bytes, one block an SM.
// Every block walks only the tiles its rows can see (the block-uniform
// test of block_visible in src/repro/models/attention.py); hidden pairs
// inside a visible tile get P = 0.
//
// Widths: hd in {16, 32, 64, 128, 256} (the smoke configs' 16, Llama 4
// Scout's 128 and gemma-2b's 256): float32 a template per hd / 16, bf16 a
// template per 64-column chunk count (hd padded to 64 by TMA's zero fill).

#include "hopper_common.cuh"

namespace {

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
  int64_t ls;                            // lse and D: elements between (b, g, head) rows
  int nsplit;                            // bf16 dkdv: blocks over the group's P heads
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
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
  return ((static_cast<int64_t>(b) * s.G + g) * s.P + head) * s.ls;
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
// bf16: D, then dk and dv, then dq on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                         // rows of every tile (wgmma M, TMA box)
constexpr int kWgThreads = 128;                   // one warpgroup
constexpr int kWgmmaThreads = 2 * kWgThreads;     // two warpgroups a block
constexpr int kXferBytes = 32 * kWgThreads * 4;   // one 64 x 64 float32 accumulator
constexpr int kXferFull = 1, kXferFree = 2;       // named barriers of the P^T exchange

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWgmmaThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kWgmmaThreads) : "memory");
}

// D = rowsum(dO * o) of every (b, g, head) row in float32, into rows of ls
// (0 past Sq): L = hd / 8 lanes a row, each one 16-byte load of o and of
// dO.  Bound by bytes: o and dO read once.
template <int L>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dsum_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ dsum, Bwd s) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  const int64_t rows = static_cast<int64_t>(s.B) * s.G * s.P * s.ls;
  const int64_t bgh = r / s.ls;
  const int row = static_cast<int>(r - bgh * s.ls);
  float acc = 0.f;
  if (r < rows && row < s.Sq) {
    const int64_t head = bgh % s.P, g = (bgh / s.P) % s.G, b = bgh / (static_cast<int64_t>(s.P) * s.G);
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + b * s.os[0] + g * s.os[1] + head * s.os[2] + row * s.os[3] + lane * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * s.dos[0] + g * s.dos[1] + head * s.dos[2] + row * s.dos[3] + lane * 8);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xa[i]), c = __bfloat1622float2(ya[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && lane == 0) dsum[r] = acc;
}

// dkdv's ring: as many stages, up to 4, as fit in the 227 KB a block may
// take beside K and V (resident) and the P^T exchange; a stage is a Q and
// a dO tile and the tile's lse and D (2 at hd = 256: 64 KB of K and V,
// 2 x 64.5 KB of stages, 16 KB exchange)
template <int NCH>
__host__ __device__ constexpr int dkdv_stages() {
  const int fixed = 2 * NCH * kChunkBytes + kXferBytes;
  const int stage = 2 * NCH * kChunkBytes + 2 * kRows * 4;
  const int n = (232448 - 2048 - fixed) / stage;
  return n < 4 ? n : 4;
}

template <int NCH>
constexpr size_t dkdv_wgmma_smem_bytes() {
  // K, V, the stages, the exchange, barriers, 1024 bytes of alignment
  return 2 * static_cast<size_t>(NCH) * kChunkBytes +
         static_cast<size_t>(dkdv_stages<NCH>()) * (2 * NCH * kChunkBytes + 2 * kRows * 4) +
         kXferBytes + 1024 + 128;
}

// may the tile of q rows [q0, q0 + 64) and kv rows [k0, k0 + 64) hold a
// hidden pair, or rows past Sq or Sk?  (then the tile is masked pair by pair)
__device__ __forceinline__ bool tile_edge(const Bwd& s, int q0, int k0) {
  const int qw0 = s.q_offset + q0, qw1 = qw0 + kRows - 1;
  return q0 + kRows > s.Sq || k0 + kRows > s.Sk || (s.causal && k0 + kRows - 1 > qw0) ||
         (s.window > 0 && k0 <= qw1 - s.window);
}

// NCH = ceil(hd / 64) column chunks.  Block: kv rows [k0, k0 + 64) of one
// (b, g) over the P heads of one split; warpgroup 0 accumulates dV,
// warpgroup 1 dK / scale.
template <int NCH>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                            const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, float* __restrict__ part, Bwd s) {
  constexpr int kStages = dkdv_stages<NCH>();
  static_assert(kStages >= 2, "a ring of at least 2 stages");
  constexpr int TILE = NCH * kChunkBytes;  // one 64-row tile, every column chunk
  constexpr uint32_t STAGE_TX = 2 * TILE + 2 * kRows * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sV = sK + TILE;
  uint8_t* sQ = sV + TILE;                 // [stages] tiles
  uint8_t* sDO = sQ + kStages * TILE;      // [stages] tiles
  float* xfer = reinterpret_cast<float*>(sDO + kStages * TILE);  // P^T, [32 values][128 threads]
  float* sLD = xfer + 32 * kWgThreads;     // [stages][lse 64, D 64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sLD + kStages * 2 * kRows);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages),
                 kvbar = smem_u32(bars + 2 * kStages);

  const int per = s.B * s.G * s.nsplit;
  const int kt = blockIdx.x / per, rest = blockIdx.x % per;
  const int split = rest % s.nsplit, g = (rest / s.nsplit) % s.G, b = rest / (s.nsplit * s.G);
  const int k0 = kt * kRows;
  const int h_lo = split * s.P / s.nsplit, h_hi = (split + 1) * s.P / s.nsplit;
  // the q tiles that may see the block's kv rows: one run [qt_lo, qt_hi)
  const int nqt = (s.Sq + kRows - 1) / kRows, khi = min(k0 + kRows, s.Sk) - 1;
  int qt_lo = nqt, qt_hi = 0;
  for (int qt = 0; qt < nqt; ++qt) {
    const int qlo = s.q_offset + qt * kRows, qhi = s.q_offset + min(qt * kRows + kRows, s.Sq) - 1;
    if (tile_visible(s, qlo, qhi, k0, khi)) {
      qt_lo = min(qt_lo, qt);
      qt_hi = qt + 1;
    }
  }
  const int nvis = max(qt_hi - qt_lo, 0);
  const int ntiles = (h_hi - h_lo) * nvis;  // (head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWgmmaThreads / 32);  // both warpgroups' warps
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q and dO of the block's i-th (head, q tile), and its lse and D, into
  // stage i % kStages on that stage's "full" barrier (one thread)
  auto load_q = [&](int i) {
    const int st = i % kStages, head = h_lo + i / nvis, q0 = (qt_lo + i % nvis) * kRows;
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, STAGE_TX);
    for (int c = 0; c < NCH; ++c)
      tma_load_5d(smem_u32(sQ + st * TILE + c * kChunkBytes), &tq, bar, c * 64, q0, head, g, b);
    for (int c = 0; c < NCH; ++c)
      tma_load_5d(smem_u32(sDO + st * TILE + c * kChunkBytes), &tdo, bar, c * 64, q0, head, g,
                  b);
    const int64_t row = stat_row(s, b, g, head) + q0;
    bulk_load(smem_u32(sLD + st * 2 * kRows), lse + row, kRows * 4, bar);
    bulk_load(smem_u32(sLD + st * 2 * kRows + kRows), dsum + row, kRows * 4, bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, 2 * TILE);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(smem_u32(sK + c * kChunkBytes), &tk, kvbar, c * 64, k0, g, b);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(smem_u32(sV + c * kChunkBytes), &tv, kvbar, c * 64, k0, g, b);
    for (int i = 0; i < kStages && i < ntiles; ++i) load_q(i);
  }

  const int wg = static_cast<int>(threadIdx.x) / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int rl = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's kv rows rl and rl + 8
  const int cq = 2 * (tid % 4);                      // its q columns 8 j + cq, + 1
  const float sl2 = s.scale * kLog2e;

  float acc[NCH][32];  // warpgroup 0: dV; warpgroup 1: dK / scale
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;

  const uint64_t ad = smem_desc(smem_u32(wg == 0 ? sK : sV), 16, 1024);
  mbar_wait(kvbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages, phase = i / kStages;
    const int q0 = (qt_lo + i % nvis) * kRows;
    // every warpgroup consumes every tile in order, so the stage's
    // previous phase (tile i - kStages) has completed: wait for tile i
    mbar_wait(full0 + 8 * st, phase & 1);
    __syncwarp();  // wgmma needs the warp converged after the spin
    const float* sl = sLD + st * 2 * kRows;  // the tile's lse, then its D
    uint8_t* const sq = sQ + st * TILE;
    uint8_t* const sdo = sDO + st * TILE;

    // warpgroup 0: S^T = K . Q^T; warpgroup 1: dP^T = V . dO^T
    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    wgmma_fence();
    qk_steps(sc, ad, smem_desc(smem_u32(wg == 0 ? sq : sdo), 16, 1024),
             std::make_integer_sequence<int, 4 * NCH>{});
    wgmma_commit();
    wgmma_wait_all();

    uint32_t hi[4][4], lo[4][4];
    if (wg == 0) {
      // P^T = exp(scale S^T - lse) of the tile, 0 at hidden pairs and past
      // Sq or Sk (where lse may be any bits)
      const bool edge = tile_edge(s, q0, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + cq + (e & 1), x = 4 * j + e;
          float p = fast_exp2(fmaf(sc[x], sl2, -sl[col] * kLog2e));
          if (edge) {
            const int kpos = k0 + rl + (e >> 1) * 8, qpos = s.q_offset + q0 + col;
            bool ok = q0 + col < s.Sq && kpos < s.Sk;
            if (s.causal) ok = ok && kpos <= qpos;
            if (s.window > 0) ok = ok && kpos > qpos - s.window;
            if (!ok) p = 0.f;
          }
          sc[x] = p;
        }
      if (i > 0) named_sync(kXferFree);  // warpgroup 1 has read the previous tile's P^T
#pragma unroll
      for (int x = 0; x < 32; ++x) xfer[x * kWgThreads + tid] = sc[x];
      named_arrive(kXferFull);
    } else {
      // dS^T = P^T (dP^T - D), with warpgroup 0's P^T (0 where masked, so
      // D past Sq, any bits, is never used)
      named_sync(kXferFull);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          const float p = xfer[x * kWgThreads + tid];
          sc[x] = p == 0.f ? 0.f : p * (sc[x] - sl[kRows + 8 * j + cq + (e & 1)]);
        }
      if (i + 1 < ntiles) named_arrive(kXferFree);
    }
    split_bf16(sc, hi, lo);

    // dV += P^T . dO (warpgroup 0) or dK += dS^T . Q (warpgroup 1): B is
    // read MN-major, hi and lo summed into the same accumulator
    const uint64_t bd = smem_desc(smem_u32(wg == 0 ? sdo : sq), kChunkBytes, 1024);
    wgmma_fence();
    pv_steps<NCH>(acc, hi, bd, std::make_integer_sequence<int, 4 * NCH>{});
    pv_steps<NCH>(acc, lo, bd, std::make_integer_sequence<int, 4 * NCH>{});
    wgmma_commit();
    wgmma_wait_all();

    // this warp is done with the stage; once all eight are, warpgroup 1's
    // first thread (the later of the two) loads the tile kStages ahead
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty0 + 8 * st);
    if (wg == 1 && tid == 0 && i + kStages < ntiles) {
      mbar_wait(empty0 + 8 * st, phase & 1);
      load_q(i + kStages);
    }
  }

  // the block's rows of dV (warpgroup 0) and dK (warpgroup 1): in the
  // inputs' type, or as float32 partials [dV, dK][split][B][G][Sk][hd]
  const float mul = wg == 0 ? 1.f : s.scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + rl + 8 * h;
    if (row >= s.Sk) continue;
    if (s.nsplit > 1) {
      float* out = part + ((((static_cast<int64_t>(wg) * s.nsplit + split) * s.B + b) * s.G + g) *
                               s.Sk + row) * s.hd;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + cq, x = 4 * j + 2 * h;
          if (col < s.hd) *reinterpret_cast<float2*>(out + col) = make_float2(acc[c][x], acc[c][x + 1]);
        }
    } else {
      __nv_bfloat16* out = wg == 0 ? dv + b * s.dvs[0] + g * s.dvs[1] + row * s.dvs[2]
                                   : dk + b * s.dks[0] + g * s.dks[1] + row * s.dks[2];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + cq, x = 4 * j + 2 * h;
          if (col < s.hd)
            *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(acc[c][x] * mul, acc[c][x + 1] * mul);
        }
    }
  }
}

// dk, dv = the sum of the nsplit partials in split order (dk times scale),
// in bf16: two columns a thread a step
__global__ void __launch_bounds__(kThreads)
flash_bwd_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, Bwd s) {
  const int64_t n = static_cast<int64_t>(s.B) * s.G * s.Sk * s.hd;  // elements of one partial
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int which = i >= n / 2;  // 0: dV, 1: dK
    const int64_t e = 2 * (i - which * (n / 2));
    float2 sum = make_float2(0.f, 0.f);
    for (int sp = 0; sp < s.nsplit; ++sp) {
      const float2 x = *reinterpret_cast<const float2*>(part + (which * s.nsplit + sp) * n + e);
      sum.x += x.x;
      sum.y += x.y;
    }
    const int col = static_cast<int>(e % s.hd);
    const int64_t r = e / s.hd, row = r % s.Sk, g = (r / s.Sk) % s.G, b = r / (s.Sk * static_cast<int64_t>(s.G));
    __nv_bfloat16* out = which ? dk + b * s.dks[0] + g * s.dks[1] + row * s.dks[2]
                               : dv + b * s.dvs[0] + g * s.dvs[1] + row * s.dvs[2];
    const float mul = which ? s.scale : 1.f;
    *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(sum.x * mul, sum.y * mul);
  }
}

// dq's K/V ring: as many stages, up to 4, as fit beside Q and dO (2 at
// hd = 256, one a warpgroup)
template <int NCH>
__host__ __device__ constexpr int dq_stages() {
  const int fixed = 2 * NCH * kChunkBytes, stage = 2 * NCH * kChunkBytes;
  const int n = (232448 - 2048 - fixed) / stage;
  return n < 4 ? n : 4;
}

template <int NCH>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO, the K/V stages (reused at the end to hand one warpgroup's dQ to
  // the other), barriers, 1024 bytes of alignment
  return 2 * static_cast<size_t>(NCH) * kChunkBytes +
         static_cast<size_t>(dq_stages<NCH>()) * 2 * NCH * kChunkBytes + 1024 + 128;
}

// Block: one 64-row q tile of one (b, g, head); its two warpgroups take
// every other visible kv tile, each with its own dQ / scale.
template <int NCH>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                          const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, Bwd s,
                          int nqt) {
  constexpr int kStages = dq_stages<NCH>();
  static_assert(kStages >= 2, "a ring of at least 2 stages");
  constexpr int TILE = NCH * kChunkBytes;
  constexpr uint32_t STAGE_TX = 2 * TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sDO = sQ + TILE;
  uint8_t* sK = sDO + TILE;               // [stages] tiles
  uint8_t* sV = sK + kStages * TILE;      // [stages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * TILE);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages),
                 qbar = smem_u32(bars + 2 * kStages);

  const int per = s.B * s.G * s.P;
  const int rank = blockIdx.x / per, bgh = blockIdx.x % per;
  const int qt = s.causal ? nqt - 1 - rank : rank;
  const int head = bgh % s.P, g = (bgh / s.P) % s.G, b = bgh / (s.P * s.G);
  const int q0 = qt * kRows;
  const int nrows = min(kRows, s.Sq - q0);
  const int qw0 = s.q_offset + q0, qw1 = qw0 + nrows - 1;  // the block's q positions
  int t_lo, t_hi;
  visible_tiles(s, qw0, qw1, kRows, &t_lo, &t_hi);
  const int ntiles = t_hi - t_lo;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWgThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int i) {
    const int st = i % kStages, row = (t_lo + i) * kRows;
    mbar_expect_tx(full0 + 8 * st, STAGE_TX);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(smem_u32(sK + st * TILE + c * kChunkBytes), &tk, full0 + 8 * st, c * 64, row, g,
                  b);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(smem_u32(sV + st * TILE + c * kChunkBytes), &tv, full0 + 8 * st, c * 64, row, g,
                  b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, 2 * TILE);
    for (int c = 0; c < NCH; ++c)
      tma_load_5d(smem_u32(sQ + c * kChunkBytes), &tq, qbar, c * 64, q0, head, g, b);
    for (int c = 0; c < NCH; ++c)
      tma_load_5d(smem_u32(sDO + c * kChunkBytes), &tdo, qbar, c * 64, q0, head, g, b);
    for (int i = 0; i < kStages && i < ntiles; ++i) load_kv(i);
  }

  const int wg = static_cast<int>(threadIdx.x) / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int rl = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's q rows rl and rl + 8
  const int cq = 2 * (tid % 4);                      // its kv columns 8 j + cq, + 1
  const float sl2 = s.scale * kLog2e;
  // the rows' lse (times log2 e) and D; rows past Sq get P = 0
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl + 8 * h;
    const int64_t at = stat_row(s, b, g, head) + row;
    lse2[h] = row < s.Sq ? lse[at] * kLog2e : -kNegInf;
    dd[h] = row < s.Sq ? dsum[at] : 0.f;
  }

  float acc[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;

  const uint64_t qd = smem_desc(smem_u32(sQ), 16, 1024), dod = smem_desc(smem_u32(sDO), 16, 1024);
  mbar_wait(qbar, 0);
  for (int i = wg; i < ntiles; i += 2) {
    const int st = i % kStages, phase = i / kStages;
    const int k0 = (t_lo + i) * kRows;
    // tile i - kStages consumed (so its load landed and the refill with
    // tile i was issued), then tile i landed (the forward's protocol)
    if (phase > 0) mbar_wait(empty0 + 8 * st, (phase - 1) & 1);
    mbar_wait(full0 + 8 * st, phase & 1);
    __syncwarp();

    // S = Q . K^T and dP = dO . V^T
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    const uint32_t k_at = smem_u32(sK + st * TILE);
    wgmma_fence();
    qk_steps(sc, qd, smem_desc(k_at, 16, 1024), std::make_integer_sequence<int, 4 * NCH>{});
    qk_steps(dp, dod, smem_desc(smem_u32(sV + st * TILE), 16, 1024),
             std::make_integer_sequence<int, 4 * NCH>{});
    wgmma_commit();
    wgmma_wait_all();

    // dS = P (dP - D), P = exp(scale S - lse), 0 at hidden pairs
    const bool edge = k0 + kRows > s.Sk || (s.causal && k0 + kRows - 1 > qw0) ||
                      (s.window > 0 && k0 <= qw1 - s.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e, h = e >> 1;
        float p = fast_exp2(fmaf(sc[x], sl2, -lse2[h]));
        if (edge) {
          const int kpos = k0 + 8 * j + cq + (e & 1), qpos = qw0 + rl + h * 8;
          bool ok = kpos < s.Sk;
          if (s.causal) ok = ok && kpos <= qpos;
          if (s.window > 0) ok = ok && kpos > qpos - s.window;
          if (!ok) p = 0.f;
        }
        sc[x] = p * (dp[x] - dd[h]);
      }
    uint32_t hi[4][4], lo[4][4];
    split_bf16(sc, hi, lo);

    // dQ += dS . K, K read MN-major
    const uint64_t kd = smem_desc(k_at, kChunkBytes, 1024);
    wgmma_fence();
    pv_steps<NCH>(acc, hi, kd, std::make_integer_sequence<int, 4 * NCH>{});
    pv_steps<NCH>(acc, lo, kd, std::make_integer_sequence<int, 4 * NCH>{});
    wgmma_commit();
    wgmma_wait_all();

    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty0 + 8 * st);
    if (tid == 0 && i + kStages < ntiles) {
      mbar_wait(empty0 + 8 * st, phase & 1);
      load_kv(i + kStages);
    }
  }

  // dQ = (dQ_0 + dQ_1) * scale: warpgroup 1 hands its registers over
  // through the ring (every tile is consumed), [register][thread]
  float* xfer = reinterpret_cast<float*>(sK);
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) xfer[(c * 32 + x) * kWgThreads + tid] = acc[c][x];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl + 8 * h;
    if (row >= s.Sq) continue;
    __nv_bfloat16* out = dq + b * s.dqs[0] + g * s.dqs[1] + head * s.dqs[2] + row * s.dqs[3];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + cq, x = 4 * j + 2 * h;
        if (col < s.hd) {
          const float v0 = (acc[c][x] + xfer[(c * 32 + x) * kWgThreads + tid]) * s.scale;
          const float v1 = (acc[c][x + 1] + xfer[(c * 32 + x + 1) * kWgThreads + tid]) * s.scale;
          *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(v0, v1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int NC>
cudaError_t launch_stats(const void* q, const void* k, const void* o, const void* dout,
                         float* lse, float* dsum, const Bwd& s, cudaStream_t st) {
  constexpr size_t bytes = sizeof(float) * (kBQ + kBKS) * static_cast<size_t>(NC * 16 + 1);
  auto stats = flash_bwd_stats_kernel<T, NC>;
  static uint64_t done = 0;
  if (cudaError_t e = raise_smem_limit(stats, bytes, done)) return e;
  const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.P, s.B * s.G);
  stats<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(o), static_cast<const T*>(dout), lse,
                                       dsum, s);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
                       const Bwd& s, cudaStream_t st) {
  constexpr int HD = NC * 16;
  constexpr size_t dkdv_bytes = dkdv_smem_bytes<HD>();
  constexpr size_t dq_bytes = dq_smem_bytes<HD>();
  auto dkdv = flash_bwd_dkdv_kernel<T, NC>;
  auto dqk = flash_bwd_dq_kernel<T, NC>;
  static uint64_t done_dkdv = 0, done_dq = 0;
  if (cudaError_t e = raise_smem_limit(dkdv, dkdv_bytes, done_dkdv)) return e;
  if (cudaError_t e = raise_smem_limit(dqk, dq_bytes, done_dq)) return e;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  const int bg = s.B * s.G;
  if (s.Sq > 0) {
    if (cudaError_t e = launch_stats<T, NC>(q, k, o, dout, lse, dsum, s, st)) return e;
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

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
                         const Bwd& s, cudaStream_t st) {
  switch (s.hd) {
    case 16: return launch_bwd<float, 1>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 32: return launch_bwd<float, 2>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 64: return launch_bwd<float, 4>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 128: return launch_bwd<float, 8>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    case 256: return launch_bwd<float, 16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, s, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int L>
cudaError_t launch_dsum(const void* o, const void* dout, float* dsum, const Bwd& s,
                        cudaStream_t st) {
  const int64_t threads = static_cast<int64_t>(s.B) * s.G * s.P * s.ls * L;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_dsum_kernel<L><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), dsum, s);
  return cudaGetLastError();
}

// the row statistics of the bf16 path: D alone when lse came from the
// forward, else lse and D by the stats pass
cudaError_t bf16_stats(const void* q, const void* k, const void* o, const void* dout, float* lse,
                       float* dsum, int have_lse, const Bwd& s, cudaStream_t st) {
  switch (s.hd) {
    case 16: return have_lse ? launch_dsum<2>(o, dout, dsum, s, st)
                             : launch_stats<__nv_bfloat16, 1>(q, k, o, dout, lse, dsum, s, st);
    case 32: return have_lse ? launch_dsum<4>(o, dout, dsum, s, st)
                             : launch_stats<__nv_bfloat16, 2>(q, k, o, dout, lse, dsum, s, st);
    case 64: return have_lse ? launch_dsum<8>(o, dout, dsum, s, st)
                             : launch_stats<__nv_bfloat16, 4>(q, k, o, dout, lse, dsum, s, st);
    case 128: return have_lse ? launch_dsum<16>(o, dout, dsum, s, st)
                              : launch_stats<__nv_bfloat16, 8>(q, k, o, dout, lse, dsum, s, st);
    case 256: return have_lse ? launch_dsum<32>(o, dout, dsum, s, st)
                              : launch_stats<__nv_bfloat16, 16>(q, k, o, dout, lse, dsum, s, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NCH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout, void* dq,
                         void* dk, void* dv, const float* lse, const float* dsum, float* part,
                         const Bwd& s, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  const cuuint64_t qdims[5] = {static_cast<cuuint64_t>(s.hd),
                               static_cast<cuuint64_t>(s.Sq > 0 ? s.Sq : 1),
                               static_cast<cuuint64_t>(s.P), static_cast<cuuint64_t>(s.G),
                               static_cast<cuuint64_t>(s.B)};
  const int64_t qst[4] = {s.qs[3], s.qs[2], s.qs[1], s.qs[0]};
  const int64_t dost[4] = {s.dos[3], s.dos[2], s.dos[1], s.dos[0]};
  const cuuint64_t kdims[4] = {static_cast<cuuint64_t>(s.hd),
                               static_cast<cuuint64_t>(s.Sk > 0 ? s.Sk : 1),
                               static_cast<cuuint64_t>(s.G), static_cast<cuuint64_t>(s.B)};
  const int64_t kst[3] = {s.ks[2], s.ks[1], s.ks[0]};
  const int64_t vst[3] = {s.vs[2], s.vs[1], s.vs[0]};
  if (cudaError_t e = bf16_map(&tq, q, 5, qdims, qst, kRows)) return e;
  if (cudaError_t e = bf16_map(&tdo, dout, 5, qdims, dost, kRows)) return e;
  if (cudaError_t e = bf16_map(&tk, k, 4, kdims, kst, kRows)) return e;
  if (cudaError_t e = bf16_map(&tv, v, 4, kdims, vst, kRows)) return e;

  constexpr size_t dkdv_bytes = dkdv_wgmma_smem_bytes<NCH>();
  constexpr size_t dq_bytes = dq_wgmma_smem_bytes<NCH>();
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<NCH>;
  auto dqk = flash_bwd_dq_wgmma_kernel<NCH>;
  static uint64_t done_dkdv = 0, done_dq = 0;
  if (cudaError_t e = raise_smem_limit(dkdv, dkdv_bytes, done_dkdv)) return e;
  if (cudaError_t e = raise_smem_limit(dqk, dq_bytes, done_dq)) return e;
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(dv);
  if (s.Sk > 0) {
    const int64_t blocks = static_cast<int64_t>((s.Sk + kRows - 1) / kRows) * s.B * s.G * s.nsplit;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    dkdv<<<static_cast<unsigned>(blocks), kWgmmaThreads, dkdv_bytes, st>>>(
        tq, tk, tv, tdo, lse, dsum, dkb, dvb, part, s);
    if (cudaError_t e = cudaGetLastError()) return e;
    if (s.nsplit > 1) {
      const int64_t pairs = static_cast<int64_t>(s.B) * s.G * s.Sk * s.hd;  // 2 x (elements / 2)
      const int64_t rb = (pairs + kThreads - 1) / kThreads;
      flash_bwd_reduce_kernel<<<static_cast<unsigned>(rb < 8192 ? rb : 8192), kThreads, 0, st>>>(
          part, dkb, dvb, s);
      if (cudaError_t e = cudaGetLastError()) return e;
    }
  }
  if (s.Sq > 0) {
    const int nqt = (s.Sq + kRows - 1) / kRows;
    const int64_t blocks = static_cast<int64_t>(nqt) * s.B * s.G * s.P;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    dqk<<<static_cast<unsigned>(blocks), kWgmmaThreads, dq_bytes, st>>>(
        tq, tk, tv, tdo, lse, dsum, static_cast<__nv_bfloat16*>(dq), s, nqt);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  return cudaSuccess;
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* dk, void* dv, float* lse,
                          float* dsum, float* part, int have_lse, const Bwd& s, cudaStream_t st) {
  // TMA (q, k, v, dout) and the D pass's 16-byte loads (o) take 16-byte
  // aligned bases and strides; the statistics' rows load in 256-byte tiles;
  // outputs are stored in pairs
  uintptr_t mis = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                   reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(lse) |
                   reinterpret_cast<uintptr_t>(dsum)) & 15;
  for (int i = 0; i < 4; ++i) mis |= s.os[i] & 7;
  mis |= (reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
          reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(part)) & 7;
  for (int i = 0; i < 4; ++i) mis |= s.dqs[i] & 1;
  for (int i = 0; i < 3; ++i) mis |= (s.dks[i] | s.dvs[i]) & 1;
  if (mis || s.ls % 4 || s.ls < (s.Sq + kRows - 1) / kRows * kRows) return cudaErrorMisalignedAddress;
  if (s.nsplit < 1 || s.nsplit > s.P || (s.nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (s.Sq > 0) {
    if (cudaError_t e = bf16_stats(q, k, o, dout, lse, dsum, have_lse, s, st)) return e;
  }
  switch ((s.hd + 63) / 64) {
    case 1: return launch_wgmma<1>(q, k, v, dout, dq, dk, dv, lse, dsum, part, s, st);
    case 2: return launch_wgmma<2>(q, k, v, dout, dq, dk, dv, lse, dsum, part, s, st);
    case 4: return launch_wgmma<4>(q, k, v, dout, dq, dk, dv, lse, dsum, part, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernels), 1 = bf16 (wgmma kernels); hd in
// {16, 32, 64, 128, 256}.  Strides are in elements: q, o, dout, dq (batch,
// group, head, row); k, v, dk, dv (batch, group, row); the last dimension
// of every tensor is dense.  lse and dsum are float32 [B, G, P] rows of at
// least Sq rounded up to 64, ls elements apart (a multiple of 4).
// have_lse = 1 (bf16 only): lse holds the forward's log-sum-exp and only D
// is computed; else the stats pass writes both.  nsplit (bf16; 1 for
// float32) splits the group's P heads over that many dkdv blocks, whose
// float32 partials go to part ([2, nsplit, B, G, Sk, hd]).
int fa_flash_backward(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
                      void* part, int B, int G, int P, int Sq, int Sk, int hd, int dtype,
                      int causal, int window, int q_offset, float scale, int64_t ls,
                      int have_lse, int nsplit, const int64_t* qs, const int64_t* ks,
                      const int64_t* vs, const int64_t* os, const int64_t* dos,
                      const int64_t* dqs, const int64_t* dks, const int64_t* dvs, void* stream) {
  if (Sq < 0 || Sk < 0 || window < 0 || P > 65535 || static_cast<int64_t>(B) * G > 65535 ||
      ls < Sq)
    return cudaErrorInvalidValue;
  if (B == 0 || G == 0) return 0;
  Bwd s{B, G, P, Sq, Sk, hd, causal, window, q_offset, scale, {}, {}, {}, {}, {}, {}, {}, {},
        ls, nsplit};
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
  if (dtype == 0) {
    if (have_lse || nsplit != 1) return cudaErrorInvalidValue;
    return dispatch_f32(q, k, v, o, dout, dq, dk, dv, l, d, s, st);
  }
  if (dtype == 1)
    return dispatch_bf16(q, k, v, o, dout, dq, dk, dv, l, d, static_cast<float*>(part), have_lse,
                         s, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
