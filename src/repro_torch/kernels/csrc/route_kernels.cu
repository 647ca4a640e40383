// Route kernels for Hopper (sm_90a): lookup_dispatch and route_bucketize.
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/lookup_dispatch.py:136  lookup_dispatch  (pallas_call :179)
//   src/repro/kernels/route_bucketize.py:155  route_bucketize  (pallas_call :199)
// for W stacked workers in one launch sequence: the grid covers
// (block of records, worker).
//
// What they compute, per worker w and record i of n (worker-local index):
//   part[w,i]  = heavy_parts[j] if keys[w,i] == heavy_keys[j] (first such j)
//              = host_to_part[fmix32(key ^ seed_mix) & (H-1)]   otherwise
//                with num_partitions > 0, a heavy hit becomes
//                (part + (fmix32(i*golden ^ mixed) & 0x7FFFFFFF) % max(repl,1))
//                % num_partitions (split hot keys);
//   slot[w,i]  = stable rank of record i among the valid records of worker w
//                on lane part % L (-1 when invalid);
//   counts[w,l] = valid records of worker w on lane l;
// and route_bucketize also scatters each record with slot < capacity into
// the [W, L, capacity] send buffers (valid, key, part, vals[D]); cells no
// record fills hold the fills (False, key_fill, 0, 0).
//
// What bounds them on an H100 (3.35 TB/s HBM3, published peak): device
// memory bytes.  Per record they do one fmix32 or two, a binary search of a
// 128-row heavy table and a host-table gather: a few tens of integer
// operations against 9 bytes read and 8 written (plus 4*D+9 bytes per cell
// of the send buffers), far below the card's operations-per-byte balance.
// Bound = bytes / 3.35 TB/s, with bytes = W*n*(4 key + 1 valid + 4 part +
// 4 slot) + W*L*4 counts + the tables, plus for route_bucketize W*n*4*D vals
// + W*L*capacity*(1 + 4 + 4 + 4*D) for every send-buffer cell; PERF.md has
// the measured time beside it with the card's power limit.
// The design keeps every per-record intermediate out of device memory
// except `part` (written once in pass 1, read once in pass 3):
//   * the 16 KB host table sits in shared memory, read with a gather (the
//     TPU kernel's one-hot matmul lookup is not needed);
//   * the heavy table is binary-searched in device memory (it stays in L1/L2);
//   * ranks are deterministic, never taken in atomic order: pass 1 counts
//     (worker, block, lane) records, pass 2 scans the counts over blocks for
//     each (worker, lane) and yields `counts`, pass 3 ranks records stably
//     inside the block (warp __match_any_sync + per-warp running counts in
//     shared memory + a prefix over the warps before) and scatters; the
//     TPU kernel's triangular-matmul prefix is not needed;
//   * int32 payloads are stored natively (no 16-bit f32 halves);
//   * the fill pass writes only cells past each lane's count, so every
//     buffer cell is written exactly once.
// Speed beyond this simple correct shape is later work.  The hash, the
// heavy-table search and the rank building blocks live in route_common.cuh.

#include "route_common.cuh"

namespace {

struct RouteArgs {
  const int32_t* keys;         // [W, n]
  const uint8_t* valid;        // [W, n] (torch.bool)
  int num_workers;
  int n;                       // records per worker
  const int32_t* heavy_keys;   // [B] sorted, sentinel padded
  const int32_t* heavy_parts;  // [B]
  const int32_t* heavy_repl;   // [B] or null when num_partitions == 0
  int num_heavy;
  const int32_t* host_to_part; // [H], H a power of two
  int num_hosts;
  uint32_t seed_mix;
  int num_lanes;
  int num_partitions;
  int num_blocks;              // blocks of kBlock records per worker
  int32_t* part;               // [W, n]
  int32_t* slot;               // [W, n]
  int32_t* counts;             // [W, L]
  int32_t* block_counts;       // [W, L, num_blocks] scratch
};

struct ScatterArgs {
  const float* vals;           // [W, n, D]
  int dim;
  int capacity;
  int32_t key_fill;
  uint8_t* buf_valid;          // [W, L, capacity]
  int32_t* buf_keys;           // [W, L, capacity]
  float* buf_vals;             // [W, L, capacity, D]
  int32_t* buf_part;           // [W, L, capacity]
};

// The route stage both kernels share: key -> partition.
__device__ __forceinline__ int route_part(const RouteArgs& a, int32_t key, int idx,
                                          const int32_t* s_host) {
  const uint32_t mixed = fmix32(static_cast<uint32_t>(key) ^ a.seed_mix);
  int part = s_host[mixed & static_cast<uint32_t>(a.num_hosts - 1)];
  const int j = heavy_find(a.heavy_keys, a.num_heavy, key);
  if (j >= 0) {
    part = __ldg(a.heavy_parts + j);
    if (a.num_partitions > 0) {
      int d = __ldg(a.heavy_repl + j);
      d = d > 1 ? d : 1;
      const uint32_t h = fmix32(static_cast<uint32_t>(idx) * kGolden ^ mixed);
      const int offset = static_cast<int>(h & 0x7FFFFFFFu) % d;
      part = (part + offset) % a.num_partitions;
    }
  }
  return part;
}

// Pass 1: route every record, store its part, count valid records per lane.
__global__ void route_count_kernel(RouteArgs a) {
  extern __shared__ int32_t smem[];
  int32_t* s_host = smem;
  int32_t* s_count = smem + a.num_hosts;
  const int b = blockIdx.x, w = blockIdx.y;
  for (int i = threadIdx.x; i < a.num_hosts; i += kThreads) s_host[i] = a.host_to_part[i];
  for (int l = threadIdx.x; l < a.num_lanes; l += kThreads) s_count[l] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(w) * a.n;
  for (int j = 0; j < kPerThread; ++j) {
    const int i = record_index(b, warp, lane, j);
    int l = -1;
    if (i < a.n) {
      const int p = route_part(a, a.keys[row + i], i, s_host);
      a.part[row + i] = p;
      if (a.valid[row + i]) l = p % a.num_lanes;
    }
    count_lane(l, s_count);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < a.num_lanes; l += kThreads)
    a.block_counts[(static_cast<int64_t>(w) * a.num_lanes + l) * a.num_blocks + b] = s_count[l];
}

// Pass 3: stable in-block rank per lane, slot = block offset + rank; with
// kScatter, records with slot < capacity land in the send buffers.
template <bool kScatter>
__global__ void rank_kernel(RouteArgs a, ScatterArgs s) {
  extern __shared__ int32_t s_wcount[];  // [kWarps][L] running per-warp counts
  const int b = blockIdx.x, w = blockIdx.y;
  const int L = a.num_lanes;
  for (int k = threadIdx.x; k < kWarps * L; k += kThreads) s_wcount[k] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(w) * a.n;
  int lane_of[kPerThread];
  int rank[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = record_index(b, warp, lane, j);
    lane_of[j] = i < a.n && a.valid[row + i] ? a.part[row + i] % L : -1;
  }
  warp_lane_ranks(lane_of, rank, s_wcount, L);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = record_index(b, warp, lane, j);
    if (i >= a.n) continue;
    const int l = lane_of[j];
    const int sl = l >= 0 ? lane_slot(a.block_counts, s_wcount, w, b, l, L, a.num_blocks,
                                      rank[j]) : -1;
    a.slot[row + i] = sl;
    if (kScatter && l >= 0 && sl < s.capacity) {
      const int64_t cell = (static_cast<int64_t>(w) * L + l) * s.capacity + sl;
      s.buf_valid[cell] = 1;
      s.buf_keys[cell] = a.keys[row + i];
      s.buf_part[cell] = a.part[row + i];
      for (int d = 0; d < s.dim; ++d)
        s.buf_vals[cell * s.dim + d] = s.vals[(row + i) * s.dim + d];
    }
  }
}

// Fill pass: every cell at or past its lane's count gets the fill values.
__global__ void fill_kernel(const int32_t* counts, int64_t num_cells, ScatterArgs s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < num_cells; c += stride) {
    const int64_t wl = c / s.capacity;
    if (c - wl * s.capacity >= counts[wl]) {
      s.buf_valid[c] = 0;
      s.buf_keys[c] = s.key_fill;
      s.buf_part[c] = 0;
      for (int d = 0; d < s.dim; ++d) s.buf_vals[c * s.dim + d] = 0.0f;
    }
  }
}

int route_and_rank(const RouteArgs& a, const ScatterArgs* s, cudaStream_t stream) {
  const dim3 grid(a.num_blocks, a.num_workers);
  if (a.num_blocks > 0) {
    const size_t smem1 = static_cast<size_t>(a.num_hosts + a.num_lanes) * sizeof(int32_t);
    route_count_kernel<<<grid, kThreads, smem1, stream>>>(a);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  lane_scan_kernel<<<a.num_workers * a.num_lanes, kThreads, 0, stream>>>(
      a.block_counts, a.counts, a.num_blocks);
  if (cudaError_t e = cudaGetLastError()) return e;
  if (a.num_blocks > 0) {
    const size_t smem3 = static_cast<size_t>(kWarps) * a.num_lanes * sizeof(int32_t);
    if (s != nullptr) {
      rank_kernel<true><<<grid, kThreads, smem3, stream>>>(a, *s);
    } else {
      rank_kernel<false><<<grid, kThreads, smem3, stream>>>(a, ScatterArgs{});
    }
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  return 0;
}

RouteArgs make_route_args(const int32_t* keys, const uint8_t* valid, int num_workers, int n,
                          const int32_t* heavy_keys, const int32_t* heavy_parts,
                          const int32_t* heavy_repl, int num_heavy,
                          const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
                          int num_lanes, int num_partitions, int32_t* part, int32_t* slot,
                          int32_t* counts, int32_t* block_counts) {
  RouteArgs a;
  a.keys = keys;
  a.valid = valid;
  a.num_workers = num_workers;
  a.n = n;
  a.heavy_keys = heavy_keys;
  a.heavy_parts = heavy_parts;
  a.heavy_repl = heavy_repl;
  a.num_heavy = num_heavy;
  a.host_to_part = host_to_part;
  a.num_hosts = num_hosts;
  a.seed_mix = seed_mix;
  a.num_lanes = num_lanes;
  a.num_partitions = num_partitions;
  a.num_blocks = (n + kBlock - 1) / kBlock;
  a.part = part;
  a.slot = slot;
  a.counts = counts;
  a.block_counts = block_counts;
  return a;
}

}  // namespace

extern "C" {

// Records per block: the wrapper sizes block_counts as [W, L, ceil(n / this)].
int rk_block_records() { return kBlock; }

const char* rk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rk_lookup_dispatch(const int32_t* keys, const uint8_t* valid, int num_workers, int n,
                       const int32_t* heavy_keys, const int32_t* heavy_parts,
                       const int32_t* heavy_repl, int num_heavy,
                       const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
                       int num_lanes, int num_partitions, int32_t* part, int32_t* slot,
                       int32_t* counts, int32_t* block_counts, void* stream) {
  const RouteArgs a = make_route_args(keys, valid, num_workers, n, heavy_keys, heavy_parts,
                                      heavy_repl, num_heavy, host_to_part, num_hosts,
                                      seed_mix, num_lanes, num_partitions, part, slot,
                                      counts, block_counts);
  return route_and_rank(a, nullptr, static_cast<cudaStream_t>(stream));
}

int rk_route_bucketize(const int32_t* keys, const uint8_t* valid, const float* vals, int dim,
                       int num_workers, int n, const int32_t* heavy_keys,
                       const int32_t* heavy_parts, const int32_t* heavy_repl, int num_heavy,
                       const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
                       int num_lanes, int num_partitions, int capacity, int32_t key_fill,
                       int32_t* part, int32_t* slot, int32_t* counts, int32_t* block_counts,
                       uint8_t* buf_valid, int32_t* buf_keys, float* buf_vals,
                       int32_t* buf_part, void* stream) {
  const RouteArgs a = make_route_args(keys, valid, num_workers, n, heavy_keys, heavy_parts,
                                      heavy_repl, num_heavy, host_to_part, num_hosts,
                                      seed_mix, num_lanes, num_partitions, part, slot,
                                      counts, block_counts);
  ScatterArgs s;
  s.vals = vals;
  s.dim = dim;
  s.capacity = capacity;
  s.key_fill = key_fill;
  s.buf_valid = buf_valid;
  s.buf_keys = buf_keys;
  s.buf_vals = buf_vals;
  s.buf_part = buf_part;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int e = route_and_rank(a, &s, st)) return e;
  const int64_t num_cells = static_cast<int64_t>(num_workers) * num_lanes * capacity;
  if (num_cells > 0) {
    int64_t blocks = (num_cells + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    fill_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(counts, num_cells, s);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  return 0;
}

}  // extern "C"
