// Route kernels for Hopper (sm_90a): lookup_dispatch and route_bucketize.
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/lookup_dispatch.py:136  lookup_dispatch  (pallas_call :179)
//   src/repro/kernels/route_bucketize.py:155  route_bucketize  (pallas_call :199)
// for W stacked workers.
//
// What they compute, per worker w and record i of n (worker-local index):
//   part[w,i]  = heavy_parts[j] if keys[w,i] == heavy_keys[j] (first such j)
//              = host_to_part[fmix32(key ^ seed_mix) & (H-1)]   otherwise
//                with num_partitions > 0, a heavy hit becomes
//                (part + (h & 0x7FFFFFFF) % max(repl,1)) % num_partitions,
//                h = fmix32(i*golden ^ mixed) (split hot keys); with part_loads
//                (float32[num_partitions]) the offset becomes the two-choice
//                least-load pick: offset2 from h2 = fmix32(h + 0x85EBCA6B),
//                taken only when loads[(part + offset2) % N] is below
//                loads[(part + offset) % N] (ties keep the first hash);
//   slot[w,i]  = stable rank of record i among the valid records of worker w
//                on lane part % L (-1 when invalid);
//   counts[w,l] = valid records of worker w on lane l;
// and route_bucketize also scatters each record with slot < capacity into
// the [W, L, capacity] send buffers (valid, key, part, vals[D]); cells no
// record fills hold the fills (False, key_fill, 0, 0).
//
// What bounds them on an H100 (3.35 TB/s HBM3, published peak): device
// memory bytes.  Per record they do one fmix32 or two, a probe of the
// heavy-key table, a host-table gather and a few ballots (a hit on a
// split key, d > 1, under the least-load pick one more fmix32 and two
// reads of the N-float load vector, which stays in L1): a few tens of
// integer operations against 9 bytes read and 8 written (plus 4*D+9 bytes
// per cell of the send buffers), far below the card's operations-per-byte
// balance.  Bound = bytes / 3.35 TB/s, with bytes = W*n*(4 key + 1 valid +
// 4 part + 4 slot) + W*L*4 counts + the tables, plus for route_bucketize
// W*n*4*D vals + W*L*capacity*(1 + 4 + 4 + 4*D) for every send-buffer cell
// (chip_smoke.py's route_bytes); at the streaming path's shapes the cells
// are 92% of those bytes and only 6% of them hold a record.
// The design:
//   * one kernel routes, ranks and (route_bucketize) scatters, reading
//     keys, valid and vals once: the one-pass stable lane rank of
//     lane_rank.cuh (ticketed tiles, a ballot multisplit in the warp, a
//     decoupled look-back over the tiles of a worker);
//   * the heavy-key probe table (route_common.cuh: one or two shared loads
//     a record, against the ceil(log2 B) + 1 dependent loads of a binary
//     search in device memory) sits in shared memory, built once per
//     resident block (the block then takes tiles until none is left); a
//     heavy table too large for the probe is binary-searched in device
//     memory.  The host table is read through the L1 cache (it stays
//     there: 16 KB): at the migrate step's shape every tile runs at once,
//     one a block, and a copy of it into each block's shared memory held
//     up every block's start for longer than the cached reads cost.  A
//     thread's 8 records are routed in lock step so their loads overlap;
//     the TPU kernel's one-hot matmul lookup and triangular-matmul prefix
//     are not needed, and int32 payloads are stored natively;
//   * route_bucketize first fills every cell of the four send buffers in
//     one flat pass of 16-byte stores (no per-cell division, no count
//     read), zeroing the rank scratch in the same launch, then the rank
//     kernel scatters the live records over the fills: 2 launches, and the
//     cells under the counts are written twice (6% more bytes at the
//     streaming path's shapes).  The scatter takes a tile's records in
//     lane order from shared memory, so neighbouring threads store
//     neighbouring cells;
//   * lookup_dispatch is one memset of the rank scratch and the rank kernel
//     without the scatter.

#include "lane_rank.cuh"

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
  int heavy_step;              // the largest power of two <= num_heavy (0 when none)
  int probe_slots;             // probe_slots(num_heavy): 0 for the binary search
  const int32_t* host_to_part; // [H], H a power of two
  int num_hosts;
  uint32_t seed_mix;
  int num_lanes;
  int lane_mask;               // num_lanes - 1 when a power of two, else -1
  int num_partitions;
  const float* part_loads;     // [num_partitions] or null: the hash pick alone
  int32_t* part;               // [W, n]
  int32_t* slot;               // [W, n]
  int32_t* counts;             // [W, L]
};

struct ScatterArgs {
  const float* vals;           // [W, n, D]
  int dim;
  int capacity;
  uint8_t* buf_valid;          // [W, L, capacity]
  int32_t* buf_keys;           // [W, L, capacity]
  float* buf_vals;             // [W, L, capacity, D]
  int32_t* buf_part;           // [W, L, capacity]
};

// The route stage both kernels share, for a thread's kChunk records at
// once (key -> partition): their heavy-row lookups run in lock step, so
// their loads overlap.
__device__ __forceinline__ void route_parts(const RouteArgs& a, const HeavyTable& heavy,
                                            const int32_t (&key)[kChunk],
                                            const int (&idx)[kChunk], int32_t (&part)[kChunk]) {
  uint32_t mixed[kChunk];
  int row[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    mixed[j] = fmix32(static_cast<uint32_t>(key[j]) ^ a.seed_mix);
    part[j] = __ldg(a.host_to_part + (mixed[j] & static_cast<uint32_t>(a.num_hosts - 1)));
  }
  heavy_rows(heavy, key, mixed, row);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int h = row[j];
    if (h < 0) continue;
    part[j] = __ldg(a.heavy_parts + h);
    if (a.num_partitions > 0) {
      int d = __ldg(a.heavy_repl + h);
      d = d > 1 ? d : 1;
      const uint32_t hash = fmix32(static_cast<uint32_t>(idx[j]) * kGolden ^ mixed[j]);
      int offset = static_cast<int>(hash & 0x7FFFFFFFu) % d;
      // the two-choice least-load pick; a key on one replica (d = 1: every
      // unsplit heavy key, and the sentinel rows invalid records hit) has
      // offset2 = offset = 0, so it skips the second hash and the reads
      if (a.part_loads != nullptr && d > 1) {
        const int offset2 = static_cast<int>(fmix32(hash + 0x85EBCA6Bu) & 0x7FFFFFFFu) % d;
        const float load1 = __ldg(a.part_loads + (part[j] + offset) % a.num_partitions);
        const float load2 = __ldg(a.part_loads + (part[j] + offset2) % a.num_partitions);
        if (load2 < load1) offset = offset2;
      }
      part[j] = (part[j] + offset) % a.num_partitions;
    }
  }
}

// The records of rank_tiles for the route kernels: a record's part is
// stored as soon as it is routed, and its lane is part % L when valid.
// With kScatter, its key and part wait in shared memory; once the tile is
// ranked, each counted record's place in lane order gets its place in the
// tile (s_order) and its lane (s_olane), and the flush writes the tile's
// records with slot < capacity lane run by lane run, neighbouring threads
// on neighbouring cells, its values read there.
template <bool kScatter>
struct RouteRecords {
  static constexpr bool kStaged = kScatter;
  RouteArgs a;
  ScatterArgs s;
  HeavyTable heavy;
  int32_t* s_key;     // [tile] by place, with kScatter
  int32_t* s_part;    // [tile] by place
  uint16_t* s_order;  // [tile] place by lane order
  uint16_t* s_olane;  // [tile] lane by lane order

  __device__ __forceinline__ void load(int64_t row, int first, int n, int p0,
                                       int (&lane_of)[kChunk]) {
    int32_t key[kChunk], part[kChunk];
    int idx[kChunk];
    bool on[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      idx[j] = first + p0 + 32 * j;
      const bool in = idx[j] < n;
      key[j] = in ? a.keys[row + idx[j]] : 0;
      on[j] = in && a.valid[row + idx[j]];
    }
    route_parts(a, heavy, key, idx, part);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      // part % L: a mask when L is a power of two and the part not negative
      const int lane = a.lane_mask >= 0 && part[j] >= 0 ? part[j] & a.lane_mask
                                                        : part[j] % a.num_lanes;
      lane_of[j] = on[j] ? lane : -1;
      if (idx[j] >= n) continue;
      a.part[row + idx[j]] = part[j];
      if (kScatter) {
        s_key[p0 + 32 * j] = key[j];
        s_part[p0 + 32 * j] = part[j];
      }
    }
  }

  __device__ __forceinline__ void prefetch(int64_t at, int count) {
    prefetch_l2(a.keys + at, count * 4);
    prefetch_l2(a.valid + at, count);
    if (kScatter) prefetch_l2(s.vals + at * s.dim, static_cast<int64_t>(count) * 4 * s.dim);
  }

  __device__ __forceinline__ void emit(int, int64_t at, int p, int l, int sl, int place) {
    a.slot[at] = sl;
    if (kScatter && l >= 0) {
      s_order[place] = static_cast<uint16_t>(p);
      s_olane[place] = static_cast<uint16_t>(l);
    }
  }

  __device__ __forceinline__ void flush(int w, int64_t row, int first, const int32_t* s_excl,
                                        const int32_t* s_start, int count) {
    for (int q = threadIdx.x; q < count; q += kThreads) {
      const int l = s_olane[q];
      const int sl = s_excl[l] + q - s_start[l];
      if (sl >= s.capacity) continue;
      const int p = s_order[q];
      const int64_t cell = (static_cast<int64_t>(w) * a.num_lanes + l) * s.capacity + sl;
      const int64_t at = row + first + p;
      s.buf_valid[cell] = 1;
      s.buf_keys[cell] = s_key[p];
      s.buf_part[cell] = s_part[p];
      for (int d = 0; d < s.dim; ++d) s.buf_vals[cell * s.dim + d] = s.vals[at * s.dim + d];
    }
  }
};

// Shared memory of the scatter's staging, in int32s: key and part by place,
// then place and lane (uint16) by lane order.
inline int64_t stage_ints(int tile) { return 3 * static_cast<int64_t>(tile); }

template <bool kScatter>
__global__ void __launch_bounds__(kThreads) route_rank_kernel(RouteArgs a, ScatterArgs s,
                                                              RankScratch r) {
  // the probe slots, rank_shared_ints(tile, L), then with kScatter the
  // staging
  extern __shared__ int2 s_route[];
  HeavyTable heavy{nullptr, 0u, a.heavy_keys, a.num_heavy, a.heavy_step};
  if (a.probe_slots > 0) {
    probe_build(s_route, a.probe_slots, a.heavy_keys, a.num_heavy, a.seed_mix);
    heavy.probe = s_route;
    heavy.mask = static_cast<uint32_t>(a.probe_slots - 1);
  }
  // (the first tile's barrier orders the probe table's stores before a probe)
  int32_t* s_rank = reinterpret_cast<int32_t*>(s_route + a.probe_slots);
  int32_t* stage = s_rank + rank_shared_ints(r.tile, a.num_lanes);
  uint16_t* order = reinterpret_cast<uint16_t*>(stage + 2 * r.tile);
  RouteRecords<kScatter> rec{a, s, heavy, stage, stage + r.tile, order, order + r.tile};
  rank_tiles(rec, r, a.num_workers, a.n, a.counts, s_rank);
}

// ---- the fill ----------------------------------------------------------

struct FillSegment {
  void* ptr;         // 16-byte aligned
  int64_t bytes;
  uint32_t pattern;  // repeated every 4 bytes, little-endian
};

constexpr int kMaxSegments = 6;

struct FillArgs {
  FillSegment seg[kMaxSegments];
  int count;
};

// Writes each segment's pattern over it: 16-byte stores, then the last
// partial vector (under 16 bytes) one byte at a time.
__global__ void __launch_bounds__(kThreads) fill_kernel(FillArgs f) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
#pragma unroll
  for (int g = 0; g < kMaxSegments; ++g) {
    if (g >= f.count) break;
    const FillSegment seg = f.seg[g];
    const uint4 v = make_uint4(seg.pattern, seg.pattern, seg.pattern, seg.pattern);
    uint4* vec = static_cast<uint4*>(seg.ptr);
    const int64_t nvec = seg.bytes >> 4;
    for (int64_t c = gid; c < nvec; c += stride) vec[c] = v;
    if (gid < (seg.bytes & 15))
      static_cast<uint8_t*>(seg.ptr)[(nvec << 4) + gid] =
          static_cast<uint8_t>(seg.pattern >> (8 * (gid & 3)));
  }
}

void add_segment(FillArgs& f, void* ptr, int64_t bytes, uint32_t pattern) {
  if (bytes > 0) f.seg[f.count++] = FillSegment{ptr, bytes, pattern};
}

int launch_fill(const FillArgs& f, cudaStream_t stream) {
  int64_t most = 16;
  for (int g = 0; g < f.count; ++g) {
    if (reinterpret_cast<uintptr_t>(f.seg[g].ptr) & 15) return cudaErrorMisalignedAddress;
    most = f.seg[g].bytes > most ? f.seg[g].bytes : most;
  }
  const int blocks = resident_blocks(fill_kernel, 0, (most / 16 + kThreads - 1) / kThreads);
  fill_kernel<<<blocks, kThreads, 0, stream>>>(f);
  return cudaGetLastError();
}

template <bool kScatter>
int launch_route_rank(const RouteArgs& a, const ScatterArgs& s, const RankScratch& r,
                      cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(a.num_workers) * r.tiles;
  if (total == 0) return 0;
  const size_t smem = (2 * a.probe_slots + rank_shared_ints(r.tile, a.num_lanes) +
                       (kScatter ? stage_ints(r.tile) : 0)) * sizeof(int32_t);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  static RankGrid grid;  // one per kernel (template instance)
  int blocks = 0;
  if (cudaError_t e = rank_grid(grid, route_rank_kernel<kScatter>, smem, total, &blocks)) return e;
  route_rank_kernel<kScatter><<<blocks, kThreads, smem, stream>>>(a, s, r);
  return cudaGetLastError();
}

RouteArgs make_route_args(const int32_t* keys, const uint8_t* valid, int num_workers, int n,
                          const int32_t* heavy_keys, const int32_t* heavy_parts,
                          const int32_t* heavy_repl, int num_heavy,
                          const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
                          int num_lanes, int num_partitions, const float* part_loads,
                          int32_t* part, int32_t* slot, int32_t* counts) {
  RouteArgs a;
  a.keys = keys;
  a.valid = valid;
  a.num_workers = num_workers;
  a.n = n;
  a.heavy_keys = heavy_keys;
  a.heavy_parts = heavy_parts;
  a.heavy_repl = heavy_repl;
  a.num_heavy = num_heavy;
  a.heavy_step = search_step(num_heavy);
  a.probe_slots = probe_slots(num_heavy);
  a.host_to_part = host_to_part;
  a.num_hosts = num_hosts;
  a.seed_mix = seed_mix;
  a.num_lanes = num_lanes;
  a.lane_mask = num_lanes & (num_lanes - 1) ? -1 : num_lanes - 1;
  a.num_partitions = num_partitions;
  a.part_loads = part_loads;
  a.part = part;
  a.slot = slot;
  a.counts = counts;
  return a;
}

}  // namespace

extern "C" {

// Records per tile of the one-pass rank of a kernel (RankKernel: 0
// lookup_dispatch, 1 route_bucketize, 2 dispatch_count).
int rk_tile_records(int kernel) { return kTileOf[kernel]; }

// Slots of the heavy-key probe table the route kernels and partition_apply
// build for B heavy rows (0: they binary-search the table instead).
int rk_probe_slots(int num_heavy) { return probe_slots(num_heavy); }

// 64-bit words of rank scratch a kernel's launch over [W, n] records and L
// lanes takes.
int64_t rk_scratch_words(int kernel, int num_workers, int n, int num_lanes) {
  return scratch_words(kTileOf[kernel], num_workers, n, num_lanes);
}

const char* rk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rk_lookup_dispatch(const int32_t* keys, const uint8_t* valid, int num_workers, int n,
                       const int32_t* heavy_keys, const int32_t* heavy_parts,
                       const int32_t* heavy_repl, int num_heavy,
                       const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
                       int num_lanes, int num_partitions, const float* part_loads,
                       int32_t* part, int32_t* slot, int32_t* counts, int64_t* scratch,
                       void* stream) {
  const int tile = kTileOf[kLookupDispatch];
  if (n > INT32_MAX - tile) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RouteArgs a = make_route_args(keys, valid, num_workers, n, heavy_keys, heavy_parts,
                                      heavy_repl, num_heavy, host_to_part, num_hosts,
                                      seed_mix, num_lanes, num_partitions, part_loads,
                                      part, slot, counts);
  if (cudaError_t e = zero_for_launch(scratch, tile, num_workers, n, num_lanes, counts, st))
    return e;
  return launch_route_rank<false>(a, ScatterArgs{},
                                  rank_scratch(scratch, tile, num_workers, n, num_lanes), st);
}

int rk_route_bucketize(const int32_t* keys, const uint8_t* valid, const float* vals, int dim,
                       int num_workers, int n, const int32_t* heavy_keys,
                       const int32_t* heavy_parts, const int32_t* heavy_repl, int num_heavy,
                       const int32_t* host_to_part, int num_hosts, uint32_t seed_mix,
                       int num_lanes, int num_partitions, const float* part_loads,
                       int capacity, int32_t key_fill,
                       int32_t* part, int32_t* slot, int32_t* counts, int64_t* scratch,
                       uint8_t* buf_valid, int32_t* buf_keys, float* buf_vals,
                       int32_t* buf_part, void* stream) {
  const int tile = kTileOf[kRouteBucketize];
  if (n > INT32_MAX - tile) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RouteArgs a = make_route_args(keys, valid, num_workers, n, heavy_keys, heavy_parts,
                                      heavy_repl, num_heavy, host_to_part, num_hosts,
                                      seed_mix, num_lanes, num_partitions, part_loads,
                                      part, slot, counts);
  ScatterArgs s;
  s.vals = vals;
  s.dim = dim;
  s.capacity = capacity;
  s.buf_valid = buf_valid;
  s.buf_keys = buf_keys;
  s.buf_vals = buf_vals;
  s.buf_part = buf_part;
  // launch 1: the fills, the rank scratch and the counts (written again by
  // each worker's last tile; zero when there is none)
  const int64_t cells = static_cast<int64_t>(num_workers) * num_lanes * capacity;
  FillArgs f{};
  add_segment(f, buf_valid, cells, 0u);
  add_segment(f, buf_keys, cells * 4, static_cast<uint32_t>(key_fill));
  add_segment(f, buf_part, cells * 4, 0u);
  add_segment(f, buf_vals, cells * 4 * dim, 0u);  // 0.0f
  add_segment(f, scratch, scratch_zero_bytes(tile, num_workers, n), 0u);
  add_segment(f, counts, static_cast<int64_t>(num_workers) * num_lanes * 4, 0u);
  if (int e = launch_fill(f, st)) return e;
  // launch 2: route, rank, scatter
  return launch_route_rank<true>(a, s, rank_scratch(scratch, tile, num_workers, n, num_lanes),
                                 st);
}

}  // extern "C"
