// Code shared by route_kernels.cu and batch_kernels.cu: the block shape,
// the hash, the heavy-table search, and the host-side helpers that size a
// grid of resident blocks.  The one-pass stable lane rank that
// lookup_dispatch, route_bucketize and dispatch_count share is in
// lane_rank.cuh.  Everything sits in an anonymous namespace, so each
// translation unit that includes it gets its own copy.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxSharedBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr int kDefaultSharedBytes = 48 * 1024;

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

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSharedBytes)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Blocks for a grid-stride (or ticket-taking) kernel: enough to fill every
// SM at the occupancy the kernel reaches with `smem` bytes of shared
// memory, no more than the work needs.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int64_t needed) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const int64_t want = static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(needed < want ? needed : want);
}

}  // namespace
