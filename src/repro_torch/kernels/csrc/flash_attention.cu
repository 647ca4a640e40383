// Flash attention forward for Hopper (sm_90a): GQA-grouped, causal and/or
// sliding-window, online softmax, any sequence length.
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/flash_attention.py:73  flash_attention_tpu  (pallas_call :92)
// and, on the models' path, the jnp chunked flash it stands in for
// (src/repro/models/attention.py:154 flash_attention).
//
// What it computes (as flash_attention.py:29-70 does):
//   q [G, P, Sq, hd], k and v [G, Sk, hd] (G kv groups, P q heads each),
//   out [G, P, Sq, hd] in q's type.  All math in float32: q is cast and
//   multiplied by scale = hd**-0.5 before the dot.  Positions are
//   q_offset + i for q row i and j for k row j; the mask keeps
//   kpos <= qpos when causal and kpos > qpos - window when window > 0;
//   masked scores are -1e30 (not -inf), so a row's p over masked entries
//   of a visible tile is exp(-1e30 - m), exactly as the Pallas kernel's.
//   The finalize divides by max(l, 1e-30).
//
// What bounds it on an H100: operations.  A prefill at gemma-2b's shape
// (G = 1, P = 8, hd = 256, Sq = Sk = 2048, causal) does 4*G*P*hd*Sq(Sq+1)/2
// = 17.2 GFLOP on 18.9 MB of bf16 inputs and output: about 900 FLOP a
// byte, far above the card's ~295 bf16 ridge.  This first kernel does the
// two products with scalar float32 FMAs from shared memory, not on the
// tensor cores, so it runs well below the bf16 bound; wgmma, TMA and a
// producer/consumer split are later work.
//
// The design:
//   * The Pallas grid (G, nq, nk) carries (m, l, acc) in VMEM across its
//     sequential kv axis.  Blocks here run in parallel in no order, so one
//     block owns a 64-row q tile of one (g, p) and loops over the 64-row kv
//     tiles itself, keeping m, l and acc in registers (4 rows x hd/16
//     columns a thread).
//   * Tiles hidden entirely by the causal or window mask are skipped (the
//     test is block-uniform, as src/repro/models/attention.py:_block_visible).
//     That is exact: a hidden tile would add exp(-1e30 - m) = 0 once any
//     visible key has been seen, and every row sees at least its own key.
//   * Ragged lengths: the Pallas kernel asserts Sq % bq == 0; here q rows
//     past Sq are zero and never written, and k/v rows past Sk are zero
//     and masked like hidden keys.
//   * Widths: hd is any multiple of 16 up to 256 (a template per hd/16).
//     At hd = 256 the q, k and v tiles in float32 plus the p tile take
//     214,528 bytes of shared memory, above the 48 KB default, so the
//     launch raises the kernel's dynamic shared-memory limit first.  The q
//     and k tiles have an odd row stride (hd + 1) so that the 16 lanes
//     reading 16 different k rows hit 16 different banks.
//   * Types: float32 and bf16 inputs; bf16 is converted with the
//     intrinsics, the output rounded to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes
constexpr int kRows = 4;         // q rows per thread (kBQ / 16)
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kPStride = kBK + 4;  // p tile row stride: the two half-warps' rows 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (HD + 1) + kBK * (HD + 1) +
                          kBK * HD + kBQ * kPStride);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int P, int Sq, int Sk, int causal, int window,
                 int q_offset, float scale) {
  constexpr int HD = NC * 16;
  constexpr int QS = HD + 1;
  extern __shared__ float smem[];
  float* s_q = smem;                 // [kBQ][QS], scaled
  float* s_k = s_q + kBQ * QS;       // [kBK][QS]
  float* s_v = s_k + kBK * QS;       // [kBK][HD]
  float* s_p = s_v + kBK * HD;       // [kBQ][kPStride]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, g = blockIdx.z;
  const int nrows = min(kBQ, Sq - q0);
  const int64_t qbase = ((static_cast<int64_t>(g) * P + head) * Sq + q0) * HD;
  const T* kg = k + static_cast<int64_t>(g) * Sk * HD;
  const T* vg = v + static_cast<int64_t>(g) * Sk * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    s_q[r * QS + c] = r < nrows ? to_f32(q[qbase + i]) * scale : 0.f;
  }

  const int r0 = (tid / 16) * kRows;  // this thread's q rows r0 .. r0+3
  const int cl = tid % 16;            // its columns cl + 16 j
  float acc[kRows][NC], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int qlo = q_offset + q0, qhi = q_offset + q0 + nrows - 1;
  const int ntiles = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK, k1 = min(k0 + kBK, Sk);
    if (causal && k0 > qhi) break;                       // later tiles hidden too
    if (window > 0 && k1 - 1 < qlo - window + 1) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i - r * HD;
      const bool in = k0 + r < Sk;
      const int64_t at = static_cast<int64_t>(k0) * HD + i;
      s_k[r * QS + c] = in ? to_f32(kg[at]) : 0.f;
      s_v[i] = in ? to_f32(vg[at]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = s_q[(r0 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = s_k[(cl + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_offset + q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cl + 16 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s_p[(r0 + i) * kPStride + cl + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = s_p[(r0 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vb = s_v[kk * HD + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= nrows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + qbase + static_cast<int64_t>(r0 + i) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + cl + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int G, int P,
                   int Sq, int Sk, int causal, int window, int q_offset, float scale,
                   cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<NC * 16>();
  auto kernel = flash_fwd_kernel<T, NC>;
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)))
    return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, P, G);
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), P, Sq,
                                        Sk, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int G,
                     int P, int Sq, int Sk, int causal, int window, int q_offset, float scale,
                     cudaStream_t st) {
#define FA_CASE(nc)                                                                      \
  case nc:                                                                               \
    return launch<T, nc>(q, k, v, o, G, P, Sq, Sk, causal, window, q_offset, scale, st);
  switch (hd / 16) {
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
    FA_CASE(9) FA_CASE(10) FA_CASE(11) FA_CASE(12) FA_CASE(13) FA_CASE(14) FA_CASE(15)
    FA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bf16.  hd is a multiple of 16 in [16, 256].
int fa_flash_forward(const void* q, const void* k, const void* v, void* o, int G, int P,
                     int Sq, int Sk, int hd, int dtype, int causal, int window,
                     int q_offset, float scale, void* stream) {
  if (hd % 16 != 0 || hd < 16 || hd > 256) return cudaErrorInvalidValue;
  if (G == 0 || P == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, G, P, Sq, Sk, causal, window, q_offset, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, G, P, Sq, Sk, causal, window, q_offset,
                                   scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
