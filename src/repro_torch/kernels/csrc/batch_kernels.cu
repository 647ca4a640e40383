// Batch-path kernels for Hopper (sm_90a): partition_apply and
// dispatch_count (sketch_update is in sketch_kernels.cu).
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/partition_apply.py:72  partition_apply  (pallas_call :90)
//   src/repro/kernels/dispatch_count.py:60   dispatch_count   (pallas_call :74)
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
//
// What bounds them on an H100 (3.35 TB/s HBM3, published peak): device
// memory bytes.  Each does a few tens of integer operations per record
// against 4-9 bytes read and 0-8 written.  Bounds, as chip_smoke.py counts
// them (each input read once, each output written once):
//   partition_apply  W*n*(4 key + 4 part) + tables
//   dispatch_count   W*n*(4 dest + 1 valid + 4 slot) + W*N*4 counts
// The design:
//   * partition_apply: a thread routes 8 records in lock step (two
//     16-byte key vectors, neighbouring threads on neighbouring vectors)
//     while its next 8 are in flight, and stores two 16-byte vectors of
//     parts; a key view that does not start on 16 bytes takes its first
//     records (under 4) one at a time, as it does the last, and parts are
//     stored 4 bytes at a time when they and the keys lie differently
//     against 16 bytes.  The
//     H <= 8192 host table, the heavy parts and the heavy-key probe table
//     (route_common.cuh; the sorted keys for the binary search when the
//     table is too large for it) sit in shared memory; a grid of the
//     resident blocks walks the records, so each block builds them once,
//     its first keys, the tables' copies (cp.async) and the heavy keys all
//     in flight at once.  The TPU kernel's one-hot matmuls are not needed.
//   * dispatch_count: the one-pass stable lane rank of lane_rank.cuh (one
//     kernel: ticketed tiles, a ballot multisplit in the warp, a decoupled
//     look-back over the tiles of a worker) with the destination as the
//     lane; dest and valid are read once, after one memset of the rank
//     scratch.  No rank depends on timing; the TPU kernel's
//     triangular-matmul prefix and sequential carry are not needed.
// Speed beyond this simple correct shape is later work.

#include "lane_rank.cuh"

namespace {

// ---- partition_apply ---------------------------------------------------

constexpr int kApplyVecs = 2;  // 16-byte key vectors a thread routes at once

// The partitions of N records, in place of their keys: the heavy row's
// part, else the hashed host's.
template <int N>
__device__ __forceinline__ void apply_parts(const HeavyTable& h, const int32_t* s_host,
                                            const int32_t* s_hp, uint32_t host_mask,
                                            uint32_t seed_mix, int32_t (&v)[N]) {
  uint32_t mixed[N];
  int row[N];
#pragma unroll
  for (int j = 0; j < N; ++j) mixed[j] = fmix32(static_cast<uint32_t>(v[j]) ^ seed_mix);
  heavy_rows(h, v, mixed, row);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = row[j] >= 0 ? s_hp[row[j]] : s_host[mixed[j] & host_mask];
}

// kApplyVecs 16-byte vectors of keys from at0, kThreads vectors apart (zero
// past the last).
__device__ __forceinline__ void load_keys(const int4* key_vecs, int64_t vecs, int64_t at0,
                                          int32_t (&v)[4 * kApplyVecs]) {
#pragma unroll
  for (int q = 0; q < kApplyVecs; ++q) {
    const int64_t at = at0 + q * kThreads;
    const int4 x = at < vecs ? __ldg(key_vecs + at) : make_int4(0, 0, 0, 0);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// kProbe: the heavy table is looked up by the probe (B <= kMaxProbeRows),
// else by the binary search.  Shared memory: with kProbe the probe slots
// (int2), then the host table [H] and the heavy parts [B], and without
// kProbe the heavy keys [B].  A thread's next 8 keys are in flight while it
// routes the current ones.
template <bool kProbe>
__global__ void __launch_bounds__(kThreads) partition_apply_kernel(
    const int32_t* keys, int64_t total, const int32_t* heavy_keys, const int32_t* heavy_parts,
    int num_heavy, const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
    int32_t* part) {
  extern __shared__ int4 s_apply[];  // 16-byte aligned
  constexpr int kRecords = 4 * kApplyVecs;
  // records before the keys' first 16-byte boundary, 16-byte vectors, a tail
  const int64_t head_left = ((16 - (reinterpret_cast<uintptr_t>(keys) & 15)) & 15) >> 2;
  const int64_t head = head_left < total ? head_left : total;
  const int64_t vecs = (total - head) >> 2;
  const int64_t tail = head + 4 * vecs;
  const int4* key_vecs = reinterpret_cast<const int4*>(keys + head);
  int32_t* out = part + head;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kApplyVecs;
  int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kApplyVecs + threadIdx.x;
  int32_t v[kRecords], next[kRecords];
  load_keys(key_vecs, vecs, base, v);  // in flight while the block builds its tables
  const int slots = kProbe ? probe_slots(num_heavy) : 0;
  int2* s_probe = reinterpret_cast<int2*>(s_apply);
  int32_t* s_host = reinterpret_cast<int32_t*>(s_probe + slots);
  int32_t* s_hp = s_host + num_hosts;
  copy_to_shared(s_host, host_to_part, num_hosts);
  copy_to_shared(s_hp, heavy_parts, num_heavy);
  HeavyTable h{nullptr, 0u, s_hp + num_heavy, num_heavy, search_step(num_heavy)};
  if (kProbe) {
    probe_build(s_probe, slots, heavy_keys, num_heavy, seed_mix);
    h.probe = s_probe;
    h.mask = static_cast<uint32_t>(slots - 1);
  } else {
    copy_to_shared(s_hp + num_heavy, heavy_keys, num_heavy);
  }
  copy_wait();
  __syncthreads();
  const uint32_t host_mask = static_cast<uint32_t>(num_hosts - 1);
  for (; base < vecs; base += step) {
    load_keys(key_vecs, vecs, base + step, next);
    apply_parts(h, s_host, s_hp, host_mask, seed_mix, v);
#pragma unroll
    for (int q = 0; q < kApplyVecs; ++q) {
      const int64_t at = base + q * kThreads;
      if (at >= vecs) continue;
      if (vec_out) {
        reinterpret_cast<int4*>(out)[at] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                     v[4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[4 * at + e] = v[4 * q + e];
      }
    }
#pragma unroll
    for (int j = 0; j < kRecords; ++j) v[j] = next[j];
  }
  // the head and the tail, under 4 records each: one a thread of block 0
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int64_t i = threadIdx.x < 4 ? threadIdx.x : tail + threadIdx.x - 4;
    if (threadIdx.x < 4 ? i < head : i < total) {
      int32_t one[1] = {keys[i]};
      apply_parts(h, s_host, s_hp, host_mask, seed_mix, one);
      part[i] = one[0];
    }
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

}  // namespace

extern "C" {

int bk_partition_apply(const int32_t* keys, int64_t total, const int32_t* heavy_keys,
                       const int32_t* heavy_parts, int num_heavy, const int32_t* host_to_part,
                       int num_hosts, uint32_t seed_mix, int32_t* part, void* stream) {
  if (total <= 0) return 0;
  const int slots = probe_slots(num_heavy);
  const size_t smem = (2 * static_cast<size_t>(slots) + num_hosts +
                       (slots > 0 ? 1 : 2) * static_cast<size_t>(num_heavy)) * sizeof(int32_t);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  auto kernel = slots > 0 ? partition_apply_kernel<true> : partition_apply_kernel<false>;
  if (cudaError_t e = allow_shared(kernel, smem)) return e;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kApplyVecs * 4;
  const int blocks = resident_blocks(kernel, smem, (total + per_block - 1) / per_block);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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

}  // extern "C"
