// Batch-path kernels for Hopper (sm_90a): partition_apply, dispatch_count
// and sketch_update.
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/partition_apply.py:72  partition_apply  (pallas_call :90)
//   src/repro/kernels/dispatch_count.py:60   dispatch_count   (pallas_call :74)
//   src/repro/kernels/sketch_update.py:50    sketch_update    (pallas_call :65)
//
// What they compute:
//   partition_apply, per record i of W*n (flat, the tables are shared):
//     part[i] = heavy_parts[j]  for the first j with heavy_keys[j] == key
//             = host_to_part[fmix32(key ^ seed_mix) & (H-1)]  otherwise;
//     B = 0 (no heavy table) is allowed.  A key equal to a sentinel pad row
//     gets that row's part, 0, as the TPU kernel's sum over matching pad
//     rows does.
//   dispatch_count, per worker w and record i of n:
//     slot[w,i]   = stable rank of record i among the valid records of
//                   worker w with the same dest, when 0 <= dest < N;
//                 = 0 for a valid record with dest outside [0, N) (not
//                   counted; the exchange counts it as overflow);
//                 = -1 for an invalid record;
//     counts[w,d] = valid records of worker w with dest d.
//   sketch_update, per worker w:
//     out[w, d, fmix32(key ^ (d * golden mod 2**32)) % width] += valid,
//     for d < depth, as float32; counts are summed in int32 and converted
//     at the end, so the result is deterministic and equals the TPU
//     kernel's float32 sum while every cell stays below 2**24.
//
// What bounds them on an H100 (3.35 TB/s HBM3, published peak): device
// memory bytes.  Each does a few tens of integer operations per record
// against 4-9 bytes read and 0-8 written.  Bounds, as chip_smoke.py counts
// them (each input read once, each output written once):
//   partition_apply  W*n*(4 key + 4 part) + tables
//   dispatch_count   W*n*(4 dest + 1 valid + 4 slot) + W*N*4 counts
//   sketch_update    W*n*(4 key + 1 valid) + W*depth*width*4
// The design:
//   * partition_apply: the H <= 8192 host table and the heavy table sit in
//     shared memory; a grid of a few blocks per SM walks the records, so
//     each block loads the tables once; the heavy table is binary-searched
//     (first match, as searchsorted).  The TPU kernel's one-hot matmuls are
//     not needed.
//   * dispatch_count: the one-pass stable lane rank of lane_rank.cuh (one
//     kernel: ticketed tiles, a ballot multisplit in the warp, a decoupled
//     look-back over the tiles of a worker) with the destination as the
//     lane; dest and valid are read once, after one memset of the rank
//     scratch.  No rank depends on timing; the TPU kernel's
//     triangular-matmul prefix and sequential carry are not needed.
//   * sketch_update: a block keeps the depth x width int32 rows in shared
//     memory when they fit (warp-aggregated atomics: equal columns of a
//     warp add once), then adds its nonzero cells into an int32 accumulator
//     in device memory; rows too large for shared memory take global
//     atomics, warp-aggregated too.  A last pass converts to float32.
// Speed beyond this simple correct shape is later work.

#include "lane_rank.cuh"

namespace {

// ---- partition_apply ---------------------------------------------------

__global__ void partition_apply_kernel(const int32_t* keys, int64_t total,
                                       const int32_t* heavy_keys, const int32_t* heavy_parts,
                                       int num_heavy, const int32_t* host_to_part,
                                       int num_hosts, uint32_t seed_mix, int32_t* part) {
  extern __shared__ int32_t smem[];
  int32_t* s_host = smem;
  int32_t* s_hk = smem + num_hosts;
  int32_t* s_hp = s_hk + num_heavy;
  for (int i = threadIdx.x; i < num_hosts; i += kThreads) s_host[i] = host_to_part[i];
  for (int i = threadIdx.x; i < num_heavy; i += kThreads) {
    s_hk[i] = heavy_keys[i];
    s_hp[i] = heavy_parts[i];
  }
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(num_hosts - 1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const int32_t key = keys[i];
    const int j = heavy_find(s_hk, num_heavy, key);
    part[i] = j >= 0 ? s_hp[j]
                     : s_host[fmix32(static_cast<uint32_t>(key) ^ seed_mix) & mask];
  }
}

// ---- dispatch_count ----------------------------------------------------

// The records of rank_tiles for dispatch_count: a record's lane is its
// destination when valid and in [0, N); a valid record outside takes slot
// 0, an invalid one -1.
struct DestRecords {
  static constexpr bool kStaged = false;
  const int32_t* dest;
  const uint8_t* valid;
  int num_parts;
  int32_t* slot;

  __device__ __forceinline__ void load(int64_t row, int first, int n, int p0,
                                       int (&lane_of)[kChunk]) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = first + p0 + 32 * j;
      const bool in = i < n;
      const int d = in ? dest[row + i] : -1;
      const bool on = in && valid[row + i];
      lane_of[j] = !on ? -1 : d >= 0 && d < num_parts ? d : -2;
    }
  }

  __device__ __forceinline__ void prefetch(int64_t at, int count) {
    prefetch_l2(dest + at, count * 4);
    prefetch_l2(valid + at, count);
  }

  __device__ __forceinline__ void emit(int, int64_t at, int, int, int sl, int) { slot[at] = sl; }

  __device__ __forceinline__ void flush(int, int64_t, int, const int32_t*, const int32_t*, int) {}
};

__global__ void __launch_bounds__(kThreads) dispatch_rank_kernel(
    const int32_t* dest, const uint8_t* valid, int num_workers, int n, int num_parts,
    int32_t* slot, int32_t* counts, RankScratch r) {
  extern __shared__ int32_t s_rank[];  // rank_shared_ints(tile, N)
  DestRecords rec{dest, valid, num_parts, slot};
  rank_tiles(rec, r, num_workers, n, counts, s_rank);
}

// ---- sketch_update -----------------------------------------------------

// Adds each valid record of worker blockIdx.y to its depth cells: into the
// block's shared rows (kShared) and from there into acc, or straight into
// acc.  Every thread of a warp runs the same iterations, so the warp
// aggregation sees all 32 lanes.
template <bool kShared>
__global__ void sketch_count_kernel(const int32_t* keys, const uint8_t* valid, int n,
                                    int depth, int width, int32_t* acc) {
  extern __shared__ int32_t s_rows[];  // [depth][width] when kShared
  const int w = blockIdx.y;
  const int cells = depth * width;
  int32_t* rows = acc + static_cast<int64_t>(w) * cells;
  if (kShared) {
    for (int c = threadIdx.x; c < cells; c += kThreads) s_rows[c] = 0;
    __syncthreads();
  }
  const int64_t row = static_cast<int64_t>(w) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool on = i < n && valid[row + i];
    const uint32_t key = on ? static_cast<uint32_t>(keys[row + i]) : 0u;
    for (int d = 0; d < depth; ++d) {
      const int col = on ? static_cast<int>(fmix32(key ^ (static_cast<uint32_t>(d) * kGolden)) %
                                            static_cast<uint32_t>(width))
                         : -1;
      const unsigned peers = __match_any_sync(kFull, col);
      if (col >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        int32_t* cell = (kShared ? s_rows : rows) + d * width + col;
        atomicAdd(cell, __popc(peers));
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += kThreads)
      if (s_rows[c]) atomicAdd(rows + c, s_rows[c]);
  }
}

__global__ void to_float_kernel(const int32_t* acc, int64_t size, float* out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < size;
       c += stride)
    out[c] = static_cast<float>(acc[c]);
}

}  // namespace

extern "C" {

int bk_partition_apply(const int32_t* keys, int64_t total, const int32_t* heavy_keys,
                       const int32_t* heavy_parts, int num_heavy, const int32_t* host_to_part,
                       int num_hosts, uint32_t seed_mix, int32_t* part, void* stream) {
  if (total <= 0) return 0;
  const size_t smem = static_cast<size_t>(num_hosts + 2 * num_heavy) * sizeof(int32_t);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  if (cudaError_t e = allow_shared(partition_apply_kernel, smem)) return e;
  const int blocks = resident_blocks(partition_apply_kernel, smem,
                                     (total + kThreads - 1) / kThreads);
  partition_apply_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, total, heavy_keys, heavy_parts, num_heavy, host_to_part, num_hosts, seed_mix,
      part);
  return cudaGetLastError();
}

int bk_dispatch_count(const int32_t* dest, const uint8_t* valid, int num_workers, int n,
                      int num_parts, int32_t* slot, int32_t* counts, int64_t* scratch,
                      void* stream) {
  const int tile = kTileOf[kDispatchCount];
  if (n > INT32_MAX - tile) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = zero_for_launch(scratch, tile, num_workers, n, num_parts, counts, st))
    return e;
  const RankScratch r = rank_scratch(scratch, tile, num_workers, n, num_parts);
  const int64_t total = static_cast<int64_t>(num_workers) * r.tiles;
  if (total == 0) return 0;
  const size_t smem = rank_shared_ints(tile, num_parts) * sizeof(int32_t);
  static RankGrid grid;
  int blocks = 0;
  if (cudaError_t e = rank_grid(grid, dispatch_rank_kernel, smem, total, &blocks)) return e;
  dispatch_rank_kernel<<<blocks, kThreads, smem, st>>>(dest, valid, num_workers, n, num_parts,
                                                      slot, counts, r);
  return cudaGetLastError();
}

int bk_sketch_update(const int32_t* keys, const uint8_t* valid, int num_workers, int n,
                     int depth, int width, int32_t* acc, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t size = static_cast<int64_t>(num_workers) * depth * width;
  if (cudaError_t e = cudaMemsetAsync(acc, 0, size * sizeof(int32_t), st)) return e;
  if (n > 0) {
    const size_t smem = static_cast<size_t>(depth) * width * sizeof(int32_t);
    const int64_t needed = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
    if (smem <= static_cast<size_t>(kMaxSharedBytes)) {
      if (cudaError_t e = allow_shared(sketch_count_kernel<true>, smem)) return e;
      int blocks = resident_blocks(sketch_count_kernel<true>, smem, needed * num_workers);
      blocks = (blocks + num_workers - 1) / num_workers;
      blocks = static_cast<int>(blocks < needed ? blocks : needed);
      sketch_count_kernel<true><<<dim3(blocks, num_workers), kThreads, smem, st>>>(
          keys, valid, n, depth, width, acc);
    } else {
      int blocks = resident_blocks(sketch_count_kernel<false>, 0, needed * num_workers);
      blocks = (blocks + num_workers - 1) / num_workers;
      blocks = static_cast<int>(blocks < needed ? blocks : needed);
      sketch_count_kernel<false><<<dim3(blocks, num_workers), kThreads, 0, st>>>(
          keys, valid, n, depth, width, acc);
    }
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  if (size > 0) {
    int64_t blocks = (size + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    to_float_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(acc, size, out);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  return 0;
}

}  // extern "C"
