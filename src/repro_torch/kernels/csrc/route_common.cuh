// Code shared by route_kernels.cu and batch_kernels.cu: the block shape,
// the hash, the heavy-key lookup (an O(1) probe, or a binary search for
// tables too large for it), and the host-side helpers that size a grid of
// resident blocks.  The one-pass stable lane rank that lookup_dispatch,
// route_bucketize and dispatch_count share is in lane_rank.cuh.
// Everything sits in an anonymous namespace, so each translation unit that
// includes it gets its own copy.
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

// ---- the heavy-key lookup ------------------------------------------------
//
// A record's heavy row is the first row of the sorted heavy table equal to
// its key, or none (-1): what searchsorted + clip + compare gives.  The
// padded tables end in up to 127 sentinel rows (key 2**31-1, part 0), so a
// real key equal to the sentinel finds the first of them.
//
// The probe (tables of at most kMaxProbeRows rows): each block builds an
// open-addressing table in shared memory of {key, row} pairs, one for the
// first row of each run of equal keys, at the slot picked by the low bits
// of mixed = fmix32(key ^ seed_mix), the hash the route computes anyway for
// the host table, walking on to the next slot while a slot is taken.  A
// record reads its key's home slot and walks on while the slot holds
// another key; an empty slot ends the walk with no hit.  Slots are the
// least power of two >= 4 B, so at most a quarter of them are taken: a
// walk ends, and is short.  A record costs one shared load, now and then
// two or three, instead of the search's ceil(log2 B) + 1 dependent ones;
// a thread's records take their walks' steps together.  Only one slot
// holds a key, so the order in which the block's threads insert does not
// change any result.  Larger tables (the wrappers take up to 16,384 rows)
// take the binary search; the launch picks one of the two by B alone.

constexpr int kMaxProbeRows = 1024;  // 4,096 slots, 32 KB of shared memory
constexpr int kWalkOn = -2;          // a probe's slot holds another key

// Slots of the probe table for a heavy table of B rows, or 0 for none: B is
// 0, or above kMaxProbeRows (the binary search).
__host__ __device__ inline int probe_slots(int num_heavy) {
  if (num_heavy <= 0 || num_heavy > kMaxProbeRows) return 0;
  int slots = 4;
  while (slots < 4 * num_heavy) slots *= 2;
  return slots;
}

// Inserts the first row of each run of equal keys of heavy_keys (device
// memory, B <= kMaxProbeRows) into the block's probe table: the keys are
// loaded first, so they are in flight while the slots are cleared.  Every
// thread calls it, and a barrier must come between it and the first probe.
__device__ __forceinline__ void probe_build(int2* s_probe, int slots, const int32_t* heavy_keys,
                                            int num_heavy, uint32_t seed_mix) {
  constexpr int kRows = kMaxProbeRows / kThreads;  // rows a thread inserts, at most
  int32_t key[kRows];
  bool first[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = threadIdx.x + r * kThreads;
    key[r] = j < num_heavy ? heavy_keys[j] : 0;
    first[r] = j < num_heavy && (j == 0 || heavy_keys[j - 1] != key[r]);
  }
  for (int s = threadIdx.x; s < slots; s += kThreads) s_probe[s] = make_int2(0, -1);
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(slots - 1);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!first[r]) continue;  // past the table, or not the first row of its run
    uint32_t s = fmix32(static_cast<uint32_t>(key[r]) ^ seed_mix) & mask;
    while (atomicCAS(&s_probe[s].y, -1, static_cast<int>(threadIdx.x) + r * kThreads) != -1)
      s = (s + 1) & mask;
    s_probe[s].x = key[r];
  }
}

// What one probe of a slot says about key: its row (a hit), -1 (an empty
// slot: no hit), or kWalkOn.
__device__ __forceinline__ int probe_step(int2 slot, int32_t key) {
  return slot.y < 0 || slot.x == key ? slot.y : kWalkOn;
}

// The heavy table as a block sees it: the probe table in shared memory, or
// the sorted keys (shared or device memory) for the binary search.
struct HeavyTable {
  const int2* probe;     // [mask + 1] slots, or null for the search
  uint32_t mask;         // slots - 1
  const int32_t* keys;   // [num_heavy], for the search
  int num_heavy;
  int step;              // the largest power of two <= num_heavy (0 when none)
};

__host__ __device__ inline int search_step(int num_heavy) {
  int step = num_heavy > 0 ? 1 : 0;
  while (step > 0 && 2 * step <= num_heavy) step *= 2;
  return step;
}

// The heavy rows of a thread's N records at once (mixed[j] = fmix32(key[j]
// ^ seed_mix)): the probes of all N, step by step of their walks, or the
// search's halving steps, are issued together, so their shared or cached
// loads overlap.
template <int N>
__device__ __forceinline__ void heavy_rows(const HeavyTable& h, const int32_t (&key)[N],
                                           const uint32_t (&mixed)[N], int (&row)[N]) {
  if (h.num_heavy <= 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = -1;
    return;
  }
  if (h.probe != nullptr) {
    uint32_t at[N];
    bool walk = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      at[j] = mixed[j] & h.mask;
      row[j] = probe_step(h.probe[at[j]], key[j]);
      walk |= row[j] == kWalkOn;
    }
    while (walk) {
      walk = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (row[j] != kWalkOn) continue;
        at[j] = (at[j] + 1) & h.mask;
        row[j] = probe_step(h.probe[at[j]], key[j]);
        walk |= row[j] == kWalkOn;
      }
    }
    return;
  }
  const int B = h.num_heavy;
  int lo[N];  // heavy rows below the key: the lower bound
#pragma unroll
  for (int j = 0; j < N; ++j) lo[j] = 0;
  for (int step = h.step; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int at = lo[j] + step - 1;
      if (at < B && h.keys[at] < key[j]) lo[j] += step;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int at = lo[j] < B ? lo[j] : B - 1;
    row[j] = h.keys[at] == key[j] ? at : -1;
  }
}

// Starts copying count int32s from device to shared memory: 16 bytes at a
// time by cp.async where both are aligned (the copies run on while the
// thread goes on), else 4 bytes through registers.  Every thread calls it;
// copy_wait() and a barrier must come before the copy is read.
__device__ __forceinline__ void copy_to_shared(int32_t* dst, const int32_t* src, int count) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    done = count & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * kThreads) {
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(src + i)
                   : "memory");
    }
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// Waits for the thread's copy_to_shared copies to land.
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

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
