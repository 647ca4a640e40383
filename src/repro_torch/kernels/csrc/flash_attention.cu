// Flash attention forward for Hopper (sm_90a): GQA-grouped, causal and/or
// sliding-window, online softmax, any sequence length, strided inputs.
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/flash_attention.py:73  flash_attention_tpu  (pallas_call :92)
// and, on the models' path, the jnp chunked flash it stands in for
// (src/repro/models/attention.py:154 flash_attention).
//
// What it computes (as flash_attention.py:29-70 does):
//   q [B, G, P, Sq, hd], k and v [B, G, Sk, hd] as strided views (B
//   batches, G kv groups, P q heads each; the Pallas layout is B = 1),
//   out in q's type.  Scores are (q . k) * scale with scale = hd**-0.5 in
//   float32.  Positions are q_offset + i for q row i and j for k row j;
//   the mask keeps kpos <= qpos when causal and kpos > qpos - window when
//   window > 0; masked scores are -1e30 (not -inf), so a row's p over the
//   masked entries of a visible tile is exp(-1e30 - m), exactly as the
//   Pallas kernel's.  The finalize divides by max(l, 1e-30).  With p_bf16
//   (Policy.attn_p_bf16) the weights follow the jnp flash's rounding:
//   p = bf16(exp(bf16(s - m))), l sums the bf16 p in float32, and the PV
//   product takes bf16 p and bf16 v with float32 sums.
//
// What bounds it on an H100: operations.  Each visible (q, k) pair costs
// 4*hd FLOP (2*hd for q.k, 2*hd for p.v).  A prefill at gemma-2b's shape
// (G = 1, P = 8, hd = 256, Sq = Sk = 2048, causal) does
// 4*G*P*hd*Sq(Sq+1)/2 = 17.2 GFLOP on 18.9 MB of bf16 inputs and output:
// about 900 FLOP a byte, far above the card's ~295 bf16 ridge, so the
// bound is 17.2 GFLOP at 989 TFLOP/s = 17.4 us, and only the tensor cores
// can approach it.
//
// Dispatch by the inputs' type, explicit and not a fallback:
//   * bf16 -> flash_wgmma_kernel, the tensor-core design below.  A bf16 call
//     it cannot take (strides or addresses that TMA refuses) raises.
//   * float32 -> flash_f32_kernel, scalar float32 FMAs from shared memory
//     (the first port's kernel, kept so that float32 stays float32: the
//     tensor cores would round the operands to bf16 or TF32).
//
// The bf16 design (flash_wgmma_kernel), answering the operations bound:
//   * Tensor cores for both products.  S = Q.K^T and O += P.V are
//     wgmma.mma_async m64n64k16 with bf16 operands and float32 accumulators
//     in registers.  Q and K/V tiles sit in shared memory in the 128-byte
//     swizzled layout that the wgmma descriptors read; the head dimension
//     is cut into 64-column chunks (128 bytes of bf16), so hd is padded to
//     a multiple of 64 in shared memory.  TMA fills the pad with zeros, so
//     the q.k product runs over the padded width with a step count fixed
//     at compile time (a step count known only at run time put branches
//     between the wgmmas and made them much slower).  P goes to the PV wgmma as
//     the A operand from registers: the S accumulator's layout is the A
//     fragment's, so P never touches shared memory.  The scale is applied
//     to S in float32 (it is not exact in bf16 q unless hd is a power of
//     four), folded with log2(e) into ex2.approx.
//   * Load balance.  A block owns one 64-row q tile of one (b, g, p); its
//     two warpgroups take every other visible kv tile (even, odd), each
//     with its own (m, l, O), and are combined at the end through shared
//     memory (O = (O_a 2^(m_a - m) + O_b 2^(m_b - m)) / (l_a ... + l_b ...)).
//     So a causal prefill's longest row of tiles is split over two
//     warpgroups, the grid has twice the blocks of a 128-row tile, and the
//     q tiles that see the most kv tiles start first: at gemma-2b's 2048
//     shape that halves the longest block's walk (from 32 tiles of 128 q
//     rows to 16 steps of two 64-row tiles) while the mean stays.
//   * Asynchronous copies.  One thread issues TMA loads of the Q tile once
//     and of the first K and V tiles (64 kv rows) into a ring of 3-4 stages
//     (as many as fit in 227 KB: 3 at hd = 256, Q 32 KB + 3 x (K 32 KB +
//     V 32 KB) = 224 KB); each stage's "full" mbarrier counts the bytes.  A
//     warpgroup done with a stage arrives on the stage's "empty" mbarrier
//     (one arrival a warp) and refills the stage at once with the tile
//     kStages ahead, so each warpgroup's next tile loads while it computes
//     this one.  With an odd ring (3 stages) the tile kStages ahead belongs
//     to the other warpgroup, which may reach it while the stage's previous
//     load is still in flight; a wait on the "full" barrier's parity alone
//     would then pass one phase early.  So the consumer of tile j first
//     waits on the "empty" barrier for tile j - kStages (consumed, hence
//     landed, hence the "full" barrier is in tile j's phase) and only then
//     on "full" for tile j.  A barrier cannot run two phases ahead of a
//     waiter: each stage's next phase waits for the waiter's own tile.
//     There is no producer warpgroup and no setmaxnreg: nvcc 12.9's ptxas
//     compiled a 384-thread block (2 consumers + 1 producer) within the
//     launch bound's 168 registers a thread although setmaxnreg raised the
//     consumers to 240 at run time, and at hd = 256 (O alone is 128
//     registers a thread) that spilled and serialised every wgmma, with 64-
//     and with 32-row kv tiles; the block took about twice as long.  A
//     256-thread block gets up to 255 registers and runs without spills.
//     TMA zero-fills rows past Sq and Sk and columns past hd; rows past Sq
//     are never stored, keys past Sk are masked.
//   * Causal and window work.  A block walks only the kv tiles its rows can
//     see (the block-uniform test of src/repro/models/attention.py:
//     _block_visible).  That is exact: a hidden tile would add
//     exp(-1e30 - m) = 0 once any visible key has been seen, and every row
//     sees at least its own key; a warpgroup whose tiles are all hidden for
//     a row ends with m = -1e30 and weighs nothing in the combination.  Only
//     the tiles that cross the diagonal, the window's edge or Sk are masked.
//   * The PV product's precision follows the Policy.  p_bf16 = 0 (the
//     reference's default) keeps P in float32: P is split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two PV wgmmas sum into
//     the same accumulator, which keeps about 16 mantissa bits of P, far
//     below the bf16 rounding of the output; l sums the float32 P.  The
//     tensor cores then do 6*hd FLOP per visible pair while the bound stays
//     4*hd: the yardstick counts the work, whatever implements it.
//     p_bf16 = 1 rounds as the reference does and runs one PV wgmma.
//
// The float32 kernel (flash_f32_kernel): one block owns a 64-row q tile of
// one (b, g, p) and walks the visible 64-row kv tiles, keeping m, l and
// acc in registers (4 rows x hd/16 columns a thread); both products are
// scalar fmaf loops over float32 tiles in shared memory (214,528 bytes at
// hd = 256, above the 48 KB default, so the launch raises the limit).  The
// q and k tiles have an odd row stride (hd + 1) so that the 16 lanes
// reading 16 k rows hit 16 banks.
//
// Widths: hd is any multiple of 16 up to 256 (float32: a template per
// hd/16; bf16: a template per 64-column chunk count, ceil(hd / 64)).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Shape {
  int B, G, P, Sq, Sk, hd;
  int causal, window, q_offset, p_bf16;
  float scale;
  int64_t qs[4], ks[3], vs[3], os[4];  // element strides: q/o (batch, group, head, row),
                                       // k/v (batch, group, row); the last dim is dense
};

// first and one-past-last kv tile (of bk rows) that q positions [qlo, qhi]
// may see: the block-uniform test of _block_visible
__device__ __forceinline__ void visible_tiles(const Shape& s, int qlo, int qhi, int bk,
                                              int* t_lo, int* t_hi) {
  const int ntiles = (s.Sk + bk - 1) / bk;
  int hi = ntiles;
  if (s.causal) hi = min(hi, qhi < 0 ? 0 : qhi / bk + 1);
  int lo = 0;
  if (s.window > 0) {
    const int first = qlo - s.window + 1;  // the earliest key a row of the block sees
    if (first > 0) lo = first / bk;
    if (lo < hi && min(hi * bk, s.Sk) - 1 < first) hi = lo;  // a short last tile, hidden
  }
  *t_lo = lo;
  *t_hi = hi;
}

// Raise a kernel's dynamic shared-memory limit once per device (a launch
// would pay the call otherwise); ``done`` holds a bit per device and
// belongs to the kernel.
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

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // kv rows per tile
constexpr int kThreads = 256;      // 16 row groups x 16 column lanes
constexpr int kRows = 4;           // q rows per thread (kBQ / 16)
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr int kPStride = kBK + 4;  // p tile row stride: the two half-warps' rows 16 banks apart

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (HD + 1) + kBK * (HD + 1) +
                          kBK * HD + kBQ * kPStride);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Shape s) {
  constexpr int HD = NC * 16;
  constexpr int QS = HD + 1;
  extern __shared__ float smem[];
  float* s_q = smem;                 // [kBQ][QS], scaled
  float* s_k = s_q + kBQ * QS;       // [kBK][QS]
  float* s_v = s_k + kBK * QS;       // [kBK][HD]
  float* s_p = s_v + kBK * HD;       // [kBQ][kPStride]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, b = blockIdx.z / s.G, g = blockIdx.z % s.G;
  const int nrows = min(kBQ, s.Sq - q0);
  const float* qg = q + b * s.qs[0] + g * s.qs[1] + head * s.qs[2] + q0 * s.qs[3];
  float* og = o + b * s.os[0] + g * s.os[1] + head * s.os[2] + q0 * s.os[3];
  const float* kg = k + b * s.ks[0] + g * s.ks[1];
  const float* vg = v + b * s.vs[0] + g * s.vs[1];

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    s_q[r * QS + c] = r < nrows ? qg[r * s.qs[3] + c] * s.scale : 0.f;
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

  int t_lo, t_hi;
  visible_tiles(s, s.q_offset + q0, s.q_offset + q0 + nrows - 1, kBK, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i - r * HD;
      const bool in = k0 + r < s.Sk;
      const float kx = in ? kg[(k0 + r) * s.ks[2] + c] : 0.f;
      const float vx = in ? vg[(k0 + r) * s.vs[2] + c] : 0.f;
      s_k[r * QS + c] = kx;
      s_v[i] = s.p_bf16 ? bf16_round(vx) : vx;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
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
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = s.q_offset + q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cl + 16 * j;
        bool ok = kpos < s.Sk;
        if (s.causal) ok = ok && kpos <= qpos;
        if (s.window > 0) ok = ok && kpos > qpos - s.window;
        if (!ok) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = s.p_bf16 ? bf16_round(expf(bf16_round(sc[i][j] - m_new)))
                                 : expf(sc[i][j] - m_new);
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
    float* out = og + static_cast<int64_t>(r0 + i) * s.os[3];
#pragma unroll
    for (int c = 0; c < NC; ++c) out[cl + 16 * c] = acc[i][c] / denom;
  }
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, const Shape& s,
                       cudaStream_t st) {
  constexpr size_t bytes = f32_smem_bytes<NC * 16>();
  auto kernel = flash_f32_kernel<NC>;
  static uint64_t done = 0;
  if (cudaError_t e = raise_smem_limit(kernel, bytes, done)) return e;
  const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.P, s.B * s.G);
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const float*>(q),
                                        static_cast<const float*>(k),
                                        static_cast<const float*>(v), static_cast<float*>(o), s);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, const Shape& s,
                         cudaStream_t st) {
  if (s.P > 65535 || static_cast<int64_t>(s.B) * s.G > 65535) return cudaErrorInvalidValue;
#define FA_CASE(nc) \
  case nc:          \
    return launch_f32<nc>(q, k, v, o, s, st);
  switch (s.hd / 16) {
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
    FA_CASE(9) FA_CASE(10) FA_CASE(11) FA_CASE(12) FA_CASE(13) FA_CASE(14) FA_CASE(15)
    FA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBlockRows = 64;                 // q rows per block (one wgmma M)
constexpr int kWarpgroups = 2;                 // each takes every other kv tile
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = kWgThreads * kWarpgroups;
constexpr int kQChunkBytes = kBlockRows * 128;  // 64 rows x 64 bf16 columns, 128B-swizzled
constexpr int kTileKV = 64;                    // kv rows per stage

// K/V ring depth: as many stages, up to 4, as fit beside Q in the 227 KB
// a block may take (3 at hd = 256: each warpgroup computes on one stage
// while its next tile loads into another)
template <int NCH>
__host__ __device__ constexpr int kv_stages() {
  const int q = NCH * kQChunkBytes, stage = 2 * NCH * kTileKV * 128;
  const int n = (232448 - 2048 - q) / stage;
  return n < 4 ? n : 4;
}

template <int NCH>
constexpr size_t wgmma_smem_bytes() {
  // Q (NCH chunks), K and V (stages x NCH chunks of kTileKV rows each),
  // barriers, and 1024 bytes to align the tiles to the swizzle atom; the
  // ring is reused at the end to hand one warpgroup's O to the other
  return static_cast<size_t>(NCH) * kQChunkBytes +
         2 * static_cast<size_t>(kv_stages<NCH>()) * NCH * kTileKV * 128 + 1024 + 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// 2**x on the special-function unit (relative error about 2**-22; 0 for
// very negative x)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wait until the phase of the given parity has completed; a wait that
// never ends (a fault in the pipeline) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128B-swizzled tile whose 8-row
// groups are 1024 bytes apart (sbo); lbo is the stride between 64-column
// atoms along M/N of an MN-major operand (unused by K-major ones).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define FA_D32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FA_D32_LIST                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// Step I of S (+)= Q . K^T, S [64 x 64] (I < 4 * NCH k16 steps): A (Q) and
// B (K) are K-major; the step's offset into the tiles (chunk I / 4, 32
// bytes a step within it) is added to the base descriptors inside the asm,
// so only the bases live in registers.
template <int I>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t qd, uint64_t kd) {
  constexpr int off = (I / 4) * (kQChunkBytes >> 4) + (I % 4) * 2;
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "add.s64 da, %32, %34;\nadd.s64 db, %33, %34;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32_LIST
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(d)
      : "l"(qd), "l"(kd), "n"(off), "r"(I > 0 ? 1 : 0));
}

// Step (KK, C) of O += P . V: P's k16 step KK from registers (the m16n8k16
// A fragment of each warp's 16 rows), V's rows 16 KK.. of column chunk C
// (64 rows each), MN-major (transposed) in shared memory.
template <int KK, int C>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t vd) {
  constexpr int off = C * (kTileKV * 128 >> 4) + KK * (16 * 128 >> 4);
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "add.s64 db, %36, %37;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32_LIST
      ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : FA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "n"(off), "r"(1));
}

// all 4 * NCH k16 steps of the padded width: the pad columns of Q and K
// are zero (TMA fills them), so they add nothing, and a step count fixed at
// compile time keeps the accumulator out of branches
template <int... I>
__device__ __forceinline__ void qk_steps(float (&d)[32], uint64_t qd, uint64_t kd,
                                         std::integer_sequence<int, I...>) {
  (wgmma_qk<I>(d, qd, kd), ...);
}

// the 4 k16 steps of P over the NCH column chunks of V
template <int NCH, int... I>
__device__ __forceinline__ void pv_steps(float (&acc)[NCH][32], const uint32_t (&p)[4][4],
                                         uint64_t vd, std::integer_sequence<int, I...>) {
  (wgmma_pv<I / NCH, I % NCH>(acc[I % NCH], p[I / NCH], vd), ...);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// NCH = ceil(hd / 64) column chunks.  Block: one 64-row q tile of one
// (b, g, head); its two warpgroups split the visible kv tiles, even and
// odd, and are combined at the end.  Grid: one block per q tile and head,
// the q tiles that see the most kv tiles first.
template <int NCH>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   Shape s, int nqt) {
  constexpr int kStages = kv_stages<NCH>();
  static_assert(kStages >= 3, "a ring of at least 3 stages (2 warpgroups, 1 ahead)");
  constexpr int KV_CHUNK = kTileKV * 128;   // bytes of one K or V column chunk
  constexpr uint32_t STAGE_TX = 2 * NCH * KV_CHUNK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [NCH] chunks
  uint8_t* sK = sQ + NCH * kQChunkBytes;                                    // [stages][NCH]
  uint8_t* sV = sK + kStages * NCH * KV_CHUNK;                              // [stages][NCH]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * NCH * KV_CHUNK);
  // per stage a "full" barrier (the TMA's bytes) and an "empty" one (the
  // consuming warpgroup's warps are done with the stage)
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages),
                 qbar = smem_u32(bars + 2 * kStages);

  const int per = s.B * s.G * s.P;
  const int rank = blockIdx.x / per, bgh = blockIdx.x % per;
  const int qt = s.causal ? nqt - 1 - rank : rank;
  const int head = bgh % s.P, g = (bgh / s.P) % s.G, b = bgh / (s.P * s.G);
  const int q0 = qt * kBlockRows;
  const int nrows = min(kBlockRows, s.Sq - q0);
  const int qw0 = s.q_offset + q0, qw1 = qw0 + nrows - 1;  // the block's q positions
  int t_lo, t_hi;
  visible_tiles(s, qw0, qw1, kTileKV, &t_lo, &t_hi);
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

  // K and V column chunks of the block's i-th kv tile into stage i % kStages,
  // on that stage's "full" barrier (one thread)
  auto load_kv = [&](int i) {
    const int st = i % kStages, row = (t_lo + i) * kTileKV;
    mbar_expect_tx(full0 + 8 * st, STAGE_TX);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(smem_u32(sK + (st * NCH + c) * KV_CHUNK), &tk, full0 + 8 * st, c * 64, row,
                  g, b);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(smem_u32(sV + (st * NCH + c) * KV_CHUNK), &tv, full0 + 8 * st, c * 64, row,
                  g, b);
  };
  if (threadIdx.x == 0) {
    // the Q tile and the first kStages kv tiles; the ring starts empty
    mbar_expect_tx(qbar, NCH * kQChunkBytes);
    for (int c = 0; c < NCH; ++c)
      tma_load_5d(smem_u32(sQ + c * kQChunkBytes), &tq, qbar, c * 64, q0, head, g, b);
    for (int i = 0; i < kStages && i < ntiles; ++i) load_kv(i);
  }

  const int wg = static_cast<int>(threadIdx.x) / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int rl = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's rows rl and rl + 8
  const int cq = 2 * (tid % 4);                      // its columns 8 j + cq, + 1
  const float sl2 = s.scale * kLog2e;

  float acc[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
  // raw (unscaled) running row maxima; this thread's share of the row sums
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const uint64_t qd = smem_desc(smem_u32(sQ), 16, 1024);
  mbar_wait(qbar, 0);
  for (int i = wg; i < ntiles; i += kWarpgroups) {
    const int st = i % kStages, phase = i / kStages;
    const int k0 = (t_lo + i) * kTileKV;
    // tile i - kStages consumed (so its load landed and the refill with
    // tile i was issued), then tile i landed
    if (phase > 0) mbar_wait(empty0 + 8 * st, (phase - 1) & 1);
    mbar_wait(full0 + 8 * st, phase & 1);
    __syncwarp();  // wgmma needs the warp converged after the spin

    // S = Q . K^T
    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    const uint64_t kd = smem_desc(smem_u32(sK + st * NCH * KV_CHUNK), 16, 1024);
    wgmma_fence();
    qk_steps(sc, qd, kd, std::make_integer_sequence<int, 4 * NCH>{});
    wgmma_commit();
    wgmma_wait_all();

    // mask the tiles that cross the diagonal, the window's edge or Sk
    if (k0 + kTileKV > s.Sk || (s.causal && k0 + kTileKV - 1 > qw0) ||
        (s.window > 0 && k0 <= qw1 - s.window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + cq + (e & 1);
          const int qpos = qw0 + rl + (e >> 1) * 8;
          bool ok = kpos < s.Sk;
          if (s.causal) ok = ok && kpos <= qpos;
          if (s.window > 0) ok = ok && kpos > qpos - s.window;
          if (!ok) sc[4 * j + e] = kNegInf;
        }
    }

    // online softmax over this thread's two rows (a quad shares a row)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = fast_exp2((m0 - mn0) * sl2), corr1 = fast_exp2((m1 - mn1) * sl2);
    m0 = mn0;
    m1 = mn1;
    if (s.p_bf16) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = bf16_round((sc[4 * j + e] - (e < 2 ? mn0 : mn1)) * s.scale);
          sc[4 * j + e] = bf16_round(fast_exp2(x * kLog2e));
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = fast_exp2((sc[4 * j + e] - (e < 2 ? mn0 : mn1)) * sl2);
    }
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[c][4 * j] *= corr0;
        acc[c][4 * j + 1] *= corr0;
        acc[c][4 * j + 2] *= corr1;
        acc[c][4 * j + 3] *= corr1;
      }

    // P as the A fragments of its 4 k16 steps: P_hi = bf16(P) and, unless
    // p_bf16, P_lo = bf16(P - P_hi)
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
        phi[kk][r] = pack_bf16(x0, x1);
        if (!s.p_bf16) plo[kk][r] = pack_bf16(x0 - bf16_round(x0), x1 - bf16_round(x1));
      }

    // O += P . V
    const uint64_t vd = smem_desc(smem_u32(sV + st * NCH * KV_CHUNK), KV_CHUNK, 1024);
    wgmma_fence();
    pv_steps<NCH>(acc, phi, vd, std::make_integer_sequence<int, 4 * NCH>{});
    if (!s.p_bf16) pv_steps<NCH>(acc, plo, vd, std::make_integer_sequence<int, 4 * NCH>{});
    wgmma_commit();
    wgmma_wait_all();

    // this warp is done with the stage; once the warpgroup's four warps
    // are, load the tile kStages ahead into it
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty0 + 8 * st);
    if (tid == 0 && i + kStages < ntiles) {
      mbar_wait(empty0 + 8 * st, phase & 1);
      load_kv(i + kStages);
    }
  }

  // combine the two warpgroups' (m, l, O) for the same rows: warpgroup 1
  // hands its registers over through the ring (every tile is consumed),
  // laid out [register][thread] so that both sides hit 32 banks
  constexpr int NREG = NCH * 32 + 4;
  float* xfer = reinterpret_cast<float*>(sK);
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) xfer[(c * 32 + x) * kWgThreads + tid] = acc[c][x];
    xfer[(NREG - 4) * kWgThreads + tid] = m0;
    xfer[(NREG - 3) * kWgThreads + tid] = m1;
    xfer[(NREG - 2) * kWgThreads + tid] = l0;
    xfer[(NREG - 1) * kWgThreads + tid] = l1;
  }
  __syncthreads();
  if (wg == 1) return;
  const float om0 = xfer[(NREG - 4) * kWgThreads + tid], om1 = xfer[(NREG - 3) * kWgThreads + tid];
  const float mt0 = fmaxf(m0, om0), mt1 = fmaxf(m1, om1);
  const float a0 = fast_exp2((m0 - mt0) * sl2), a1 = fast_exp2((m1 - mt1) * sl2);
  const float b0 = fast_exp2((om0 - mt0) * sl2), b1 = fast_exp2((om1 - mt1) * sl2);
  l0 = l0 * a0 + xfer[(NREG - 2) * kWgThreads + tid] * b0;
  l1 = l1 * a1 + xfer[(NREG - 1) * kWgThreads + tid] * b1;
  const float den[2] = {fmaxf(quad_sum(l0), 1e-30f), fmaxf(quad_sum(l1), 1e-30f)};
  const float fa[2] = {a0, a1}, fb[2] = {b0, b1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl + 8 * h;
    if (row >= s.Sq) continue;
    __nv_bfloat16* out = o + b * s.os[0] + g * s.os[1] + head * s.os[2] + row * s.os[3];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + cq, x = 4 * j + 2 * h;
        if (col < s.hd) {
          const float v0 = acc[c][x] * fa[h] + xfer[(c * 32 + x) * kWgThreads + tid] * fb[h];
          const float v1 =
              acc[c][x + 1] * fa[h] + xfer[(c * 32 + x + 1) * kWgThreads + tid] * fb[h];
          *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(v0 / den[h], v1 / den[h]);
        }
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime
// (so the build needs no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &res);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with dims {hd, rows, outer...} (innermost first),
// element strides of the dims past the first, a box of 64 columns x
// box_rows rows, 128B swizzle; out-of-range elements read as zero
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const int64_t* strides, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t bytes[4];
  cuuint32_t box[5], ones[5];
  for (int i = 0; i < rank; ++i) {
    box[i] = i == 0 ? 64 : i == 1 ? box_rows : 1;
    ones[i] = 1;
    if (i + 1 < rank) {
      if (strides[i] <= 0 || (strides[i] * 2) % 16 != 0) return cudaErrorInvalidValue;
      bytes[i] = static_cast<cuuint64_t>(strides[i]) * 2;
    }
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NCH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, const Shape& s,
                         cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[5] = {static_cast<cuuint64_t>(s.hd), static_cast<cuuint64_t>(s.Sq),
                               static_cast<cuuint64_t>(s.P), static_cast<cuuint64_t>(s.G),
                               static_cast<cuuint64_t>(s.B)};
  const int64_t qst[4] = {s.qs[3], s.qs[2], s.qs[1], s.qs[0]};
  const cuuint64_t kdims[4] = {static_cast<cuuint64_t>(s.hd),
                               static_cast<cuuint64_t>(s.Sk > 0 ? s.Sk : 1),
                               static_cast<cuuint64_t>(s.G), static_cast<cuuint64_t>(s.B)};
  const int64_t kst[3] = {s.ks[2], s.ks[1], s.ks[0]};
  const int64_t vst[3] = {s.vs[2], s.vs[1], s.vs[0]};
  if (cudaError_t e = bf16_map(&tq, q, 5, qdims, qst, kBlockRows)) return e;
  if (cudaError_t e = bf16_map(&tk, k, 4, kdims, kst, kTileKV)) return e;
  if (cudaError_t e = bf16_map(&tv, v, 4, kdims, vst, kTileKV)) return e;

  constexpr size_t bytes = wgmma_smem_bytes<NCH>();
  auto kernel = flash_wgmma_kernel<NCH>;
  static uint64_t done = 0;
  if (cudaError_t e = raise_smem_limit(kernel, bytes, done)) return e;
  const int nqt = (s.Sq + kBlockRows - 1) / kBlockRows;
  const int64_t blocks = static_cast<int64_t>(nqt) * s.B * s.G * s.P;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kWgmmaThreads, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s, nqt);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, const Shape& s,
                          cudaStream_t st) {
  // TMA takes 16-byte aligned bases and strides; the output is stored in
  // pairs of bf16
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15;
  int64_t odd = reinterpret_cast<uintptr_t>(o) & 3;
  for (int i = 0; i < 4; ++i) odd |= s.os[i] & 1;
  if (mis || odd) return cudaErrorMisalignedAddress;
  switch ((s.hd + 63) / 64) {
    case 1: return launch_wgmma<1>(q, k, v, o, s, st);
    case 2: return launch_wgmma<2>(q, k, v, o, s, st);
    case 3: return launch_wgmma<3>(q, k, v, o, s, st);
    case 4: return launch_wgmma<4>(q, k, v, o, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernel), 1 = bf16 (wgmma kernel).  hd is a
// multiple of 16 in [16, 256].  Strides are in elements: qs and os
// (batch, group, head, row), ks and vs (batch, group, row); the last
// dimension of every tensor is dense.
int fa_flash_forward(const void* q, const void* k, const void* v, void* o, int B, int G, int P,
                     int Sq, int Sk, int hd, int dtype, int p_bf16, int causal, int window,
                     int q_offset, float scale, const int64_t* qs, const int64_t* ks,
                     const int64_t* vs, const int64_t* os, void* stream) {
  if (hd % 16 != 0 || hd < 16 || hd > 256 || Sk < 0 || window < 0) return cudaErrorInvalidValue;
  if (B == 0 || G == 0 || P == 0 || Sq == 0) return 0;
  Shape s{B, G, P, Sq, Sk, hd, causal, window, q_offset, p_bf16, scale, {}, {}, {}, {}};
  for (int i = 0; i < 4; ++i) {
    s.qs[i] = qs[i];
    s.os[i] = os[i];
  }
  for (int i = 0; i < 3; ++i) {
    s.ks[i] = ks[i];
    s.vs[i] = vs[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(q, k, v, o, s, st);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, s, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
