// Hopper (sm_90a) machinery shared by the flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): shared-memory addresses,
// mbarriers, TMA tile loads and their tensor maps, wgmma descriptors and
// the two wgmma forms the kernels use, bf16 packing and quad reductions.
//
// Every tile is 64 rows (one wgmma M, one TMA box) by 64-column bf16
// chunks of 128 bytes a row, in the 128-byte swizzled layout TMA writes
// and the wgmma descriptors read: a chunk of 64 rows is kChunkBytes, its
// 8-row groups 1024 bytes apart.  Everything here lives in an anonymous
// namespace, one copy a translation unit.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunkBytes = 64 * 128;  // one 64-row, 64-column bf16 chunk

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// first and one-past-last kv tile (of bk rows) that q positions [qlo, qhi]
// may see: the block-uniform test of _block_visible (src/repro/models/
// attention.py); S is any shape struct with Sk, causal and window
template <typename S>
__device__ __forceinline__ void visible_tiles(const S& s, int qlo, int qhi, int bk, int* t_lo,
                                              int* t_hi) {
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

// a plain copy of ``bytes`` (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory, on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// Step I of D (+)= A . B^T, D [64 x 64] (I < 4 * NCH k16 steps over the
// padded width): A and B are 64-row tiles of NCH chunks, both K-major
// (the width is contiguous); the step's offset into the tiles (chunk
// I / 4, 32 bytes a step within it) is added to the base descriptors
// inside the asm, so only the bases live in registers.
template <int I>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t qd, uint64_t kd) {
  constexpr int off = (I / 4) * (kChunkBytes >> 4) + (I % 4) * 2;
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "add.s64 da, %32, %34;\nadd.s64 db, %33, %34;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32_LIST
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(d)
      : "l"(qd), "l"(kd), "n"(off), "r"(I > 0 ? 1 : 0));
}

// Step (KK, C) of D += A . B: A's k16 step KK from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B's rows 16 KK.. of column
// chunk C (64 rows each), MN-major (transposed) in shared memory.
template <int KK, int C>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t vd) {
  constexpr int off = C * (kChunkBytes >> 4) + KK * (16 * 128 >> 4);
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "add.s64 db, %36, %37;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32_LIST
      ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : FA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "n"(off), "r"(1));
}

// all 4 * NCH k16 steps of the padded width: the pad columns are zero (TMA
// fills them), so they add nothing, and a step count fixed at compile time
// keeps the accumulator out of branches
template <int... I>
__device__ __forceinline__ void qk_steps(float (&d)[32], uint64_t qd, uint64_t kd,
                                         std::integer_sequence<int, I...>) {
  (wgmma_qk<I>(d, qd, kd), ...);
}

// the 4 k16 steps of A over the NCH column chunks of B
template <int NCH, int... I>
__device__ __forceinline__ void pv_steps(float (&acc)[NCH][32], const uint32_t (&p)[4][4],
                                         uint64_t vd, std::integer_sequence<int, I...>) {
  (wgmma_pv<I / NCH, I % NCH>(acc[I % NCH], p[I / NCH], vd), ...);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A 64 x 64 float32 accumulator (this thread's 32 values) as the A
// fragments of its 4 k16 steps: hi = bf16(x) and lo = bf16(x - hi), so
// that two products on hi and lo keep about 16 mantissa bits of x
__device__ __forceinline__ void split_bf16(const float (&x)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      hi[kk][r] = pack_bf16(x0, x1);
      lo[kk][r] = pack_bf16(x0 - bf16_round(x0), x1 - bf16_round(x1));
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

}  // namespace
