// Device code shared by route_kernels.cu and batch_kernels.cu: the hash,
// the heavy-table search, the block layout and the deterministic lane-rank
// building blocks (per-block lane counts, the scan over blocks, the stable
// in-block rank).  Everything sits in an anonymous namespace, so each
// translation unit that includes it gets its own copy.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kBlock = kThreads * kPerThread;  // records per block
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Index of the first row of the sorted heavy table equal to key, or -1
// (a lower-bound search, clipped, as searchsorted + clip + compare).
// `heavy_keys` may point to shared or global memory.
__device__ __forceinline__ int heavy_find(const int32_t* heavy_keys, int num_heavy,
                                          int32_t key) {
  if (num_heavy <= 0) return -1;
  int lo = 0, hi = num_heavy;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (heavy_keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  const int j = lo < num_heavy ? lo : num_heavy - 1;
  return heavy_keys[j] == key ? j : -1;
}

// Record handled by (warp, lane) in round j of block b: each warp owns a
// contiguous run of 32 * kPerThread records, so in-warp order is index order.
__device__ __forceinline__ int record_index(int b, int warp, int lane, int j) {
  return b * kBlock + warp * (32 * kPerThread) + j * 32 + lane;
}

// Warp-aggregated count of one record on lane l (l < 0: none) into s_count.
__device__ __forceinline__ void count_lane(int l, int32_t* s_count) {
  const unsigned peers = __match_any_sync(kFull, l);
  if (l >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&s_count[l], __popc(peers));
}

// Exclusive scan of one value per thread across the block; `total` gets the
// block's sum.  s_warp holds kWarps ints.
__device__ __forceinline__ int block_exclusive_scan(int x, int32_t* s_warp, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int s = s_warp[k];
    if (k < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before + incl - x;
}

// Pass 2: one block per (worker, lane) row of block_counts: exclusive scan
// over the record blocks, in place; the row total is the lane's count.
__global__ void lane_scan_kernel(int32_t* block_counts, int32_t* counts, int num_blocks) {
  __shared__ int32_t s_warp[kWarps];
  int32_t* row = block_counts + static_cast<int64_t>(blockIdx.x) * num_blocks;
  int carry = 0;
  for (int start = 0; start < num_blocks; start += kThreads) {
    const int i = start + threadIdx.x;
    const int x = i < num_blocks ? row[i] : 0;
    int total;
    const int excl = block_exclusive_scan(x, s_warp, total);
    if (i < num_blocks) row[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

// Stable in-block rank, pass 3's first half: given each of the thread's
// kPerThread records' lanes (-1: none), writes each record's rank among the
// earlier records of its warp on its lane, and leaves each warp's per-lane
// totals in s_wcount ([kWarps][L], zeroed by the caller and followed by a
// __syncthreads before it is read).
__device__ __forceinline__ void warp_lane_ranks(const int (&lane_of)[kPerThread],
                                                int (&rank)[kPerThread],
                                                int32_t* s_wcount, int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int32_t* mine = s_wcount + warp * L;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = lane_of[j];
    const unsigned peers = __match_any_sync(kFull, l);
    rank[j] = l >= 0 ? mine[l] + __popc(peers & lower) : 0;
    __syncwarp();
    if (l >= 0 && lane == __ffs(peers) - 1) mine[l] += __popc(peers);
    __syncwarp();
  }
}

// Pass 3's second half: the slot of a record on lane l >= 0 in block b of
// worker w = the lane's offset before this block + the records of earlier
// warps of the block on that lane + its rank in its warp.
__device__ __forceinline__ int lane_slot(const int32_t* block_counts, const int32_t* s_wcount,
                                         int w, int b, int l, int L, int num_blocks,
                                         int rank) {
  int sl = block_counts[(static_cast<int64_t>(w) * L + l) * num_blocks + b] + rank;
  for (int k = 0; k < (threadIdx.x >> 5); ++k) sl += s_wcount[k * L + l];
  return sl;
}

}  // namespace
