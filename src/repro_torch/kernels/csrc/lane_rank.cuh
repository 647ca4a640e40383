// One-pass stable lane ranks for Hopper (sm_90a), shared by
// route_kernels.cu (lookup_dispatch, route_bucketize) and batch_kernels.cu
// (dispatch_count).
//
// Each of W workers holds n records; a record has a lane l in [0, L) or
// none.  Its slot is the number of records of its worker on lane l with a
// lower index (a stable rank), and counts[w, l] is the lane's total.  One
// kernel reads each record once and writes its slot: a single-pass scan
// with decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA NVR-2016-002) over the L lane
// counters of each tile of one worker's records.
//   * A block takes its tile from a ticket counter (atomicAdd), not from
//     blockIdx, so every tile it may wait on is held by a block that is
//     already running: the look-back cannot deadlock.  A grid of resident
//     blocks loops over the tickets, so a block's set-up (a host table in
//     shared memory) is paid once per block, not once per tile.  A block
//     asks the L2 cache for its whole tile first, so the tile's records are
//     in flight at once while its threads load them a chunk at a time.
//   * In the tile, a warp ranks each round of 32 records by a ballot
//     multisplit: the records on lane l are those whose lane agrees with l
//     on each of its ceil(log2 L) bits (one __ballot_sync per bit, masked by
//     the ballot of counted records).  A running per-warp count per lane in
//     shared memory carries the rank from round to round; each record's
//     lane and rank wait in shared memory for the tile's prefix, and a scan
//     over the warps gives each warp's offset and the tile's per-lane
//     aggregate.
//   * A tile has one status flag (0 none yet, 1 aggregate, 2 inclusive
//     prefix) and two rows of L counts (aggregate, inclusive prefix).  The
//     block stores its aggregates, fences, and flags them; one warp walks
//     back over the flags of the earlier tiles of its worker, 32 at a time,
//     to the nearest inclusive prefix; the threads sum that prefix and the
//     aggregates after it per lane (reading the count rows whole, so the
//     loads coalesce and overlap), store the tile's inclusive prefix, fence,
//     and flag it.  The fences before the flags make the counts
//     visible first (release); the walker's fence after the flags makes the
//     counts read after them current (acquire).
//   * slot = the tile's exclusive prefix + the records of the warps before
//     + the rank in the warp; the last tile of each worker writes its
//     counts.
// Ranks never depend on timing: a prefix is the sum of the earlier tiles'
// counts, whichever block computes it.  The ticket and the flags must be
// zero when the kernel starts (the launch sequence zeroes them); the count
// rows are read only after their flag.
//
// Tiles are 16 or 32 records a thread (4,096 or 8,192 a tile), set per
// kernel (kTileOf): larger tiles keep the look-back's walks short where a
// worker has many tiles, smaller ones leave more shared memory, so more
// resident blocks.

#pragma once

#include "route_common.cuh"

namespace {

constexpr int kChunk = 8;            // records a thread loads at once
constexpr int kAggregate = 1;
constexpr int kPrefix = 2;
constexpr uint32_t kNone = 0xFFFFu;  // lane field of a record not counted, slot -1
constexpr uint32_t kZero = 0xFFFEu;  // lane field of a record not counted, slot 0
// The scratch, in int32s: the ticket and 3 pad words, the [W, tiles] flags,
// then the [W, tiles, L] aggregate and inclusive-prefix rows.
constexpr int64_t kScratchHead = 4;

// Records per tile of each kernel that ranks, chosen from 2,048, 4,096 and
// 8,192 by device time at the paths' shapes on an H100 (PERF.md §6):
// 4,096 for the route kernels (8 workers of 262,144 or 524,288 records),
// 8,192 for dispatch_count (one worker of 10 M records, where smaller tiles
// lengthen the look-back's walks).
enum RankKernel { kLookupDispatch = 0, kRouteBucketize = 1, kDispatchCount = 2 };
constexpr int kTileOf[3] = {16 * kThreads, 16 * kThreads, 32 * kThreads};

struct RankScratch {
  unsigned* ticket;
  int32_t* flags;
  int32_t* aggregate;
  int32_t* inclusive;
  int tile;        // records per tile: kThreads * per_thread
  int per_thread;  // a multiple of kChunk
  int tiles;       // tiles per worker
  int num_lanes;
  int lane_bits;   // ceil(log2 num_lanes)
};

inline int64_t tiles_of(int n, int tile) { return (static_cast<int64_t>(n) + tile - 1) / tile; }

inline int64_t scratch_words(int tile, int num_workers, int n, int num_lanes) {
  const int64_t ints = kScratchHead + num_workers * tiles_of(n, tile) * (1 + 2 * num_lanes);
  return (ints + 1) / 2;
}

// Bytes at the scratch's start that must be zero: the ticket and the flags.
inline int64_t scratch_zero_bytes(int tile, int num_workers, int n) {
  return (kScratchHead + num_workers * tiles_of(n, tile)) * 4;
}

inline RankScratch rank_scratch(int64_t* words, int tile, int num_workers, int n,
                                int num_lanes) {
  RankScratch r;
  int32_t* ints = reinterpret_cast<int32_t*>(words);
  const int64_t tiles = num_workers * tiles_of(n, tile);
  r.ticket = reinterpret_cast<unsigned*>(ints);
  r.flags = ints + kScratchHead;
  r.aggregate = r.flags + tiles;
  r.inclusive = r.aggregate + tiles * num_lanes;
  r.tile = tile;
  r.per_thread = tile / kThreads;
  r.tiles = static_cast<int>(tiles_of(n, tile));
  r.num_lanes = num_lanes;
  r.lane_bits = 0;
  while ((1 << r.lane_bits) < num_lanes) ++r.lane_bits;
  return r;
}

// Shared memory the ranking takes, in int32s: each record's lane and rank,
// the per-warp lane counts, per lane the tile's exclusive prefix,
// aggregate and first place in the tile, and one int per warp for a scan.
__host__ __device__ inline int64_t rank_shared_ints(int tile, int num_lanes) {
  return tile + (kWarps + 3) * num_lanes + kWarps;
}

// The grid of a rank kernel: its resident blocks for `smem` bytes of shared
// memory (its limit raised first), no more than the tiles; remembered per
// launch site for the last device and size, which recur call after call.
struct RankGrid {
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <typename Kernel>
cudaError_t rank_grid(RankGrid& g, Kernel kernel, size_t smem, int64_t tiles, int* blocks) {
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return e;
  if (device != g.device || smem != g.smem) {
    if (cudaError_t e = allow_shared(kernel, smem)) return e;
    g.blocks = resident_blocks(kernel, smem, INT32_MAX);
    g.device = device;
    g.smem = smem;
  }
  *blocks = static_cast<int>(tiles < g.blocks ? tiles : g.blocks);
  return cudaSuccess;
}

// Zeroes the ticket and the flags before a launch; with no tile to launch,
// zeroes the counts the kernel would have written instead.
inline cudaError_t zero_for_launch(int64_t* scratch, int tile, int num_workers, int n,
                                   int num_lanes, int32_t* counts, cudaStream_t stream) {
  if (num_workers * tiles_of(n, tile) == 0) {
    const size_t bytes = static_cast<size_t>(num_workers) * num_lanes * sizeof(int32_t);
    return bytes ? cudaMemsetAsync(counts, 0, bytes, stream) : cudaSuccess;
  }
  return cudaMemsetAsync(scratch, 0, scratch_zero_bytes(tile, num_workers, n), stream);
}

// A load of a flag at GPU scope, bypassing L1, while it may change.
__device__ __forceinline__ int observe(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The threads that stored counts of the tile (`wrote`) make them visible,
// then thread 0 sets the tile's flag (release: the counts before the flag).
__device__ __forceinline__ void publish_flag(int32_t* flag, int value, bool wrote) {
  if (wrote) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(value) : "memory");
}

// Brings the lines of [p, p + bytes) into the L2 cache, one thread per
// 128-byte line (every thread of the block calls it).
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes) {
  const char* base = static_cast<const char*>(p);
  for (int64_t at = static_cast<int64_t>(threadIdx.x) * 128; at < bytes; at += kThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + at));
}

// Place in its tile of the record handled by (warp, lane) in round j: each
// warp owns a contiguous run of 32 * per_thread records, round-major, so
// in-warp order (round, lane) is index order.
__device__ __forceinline__ int tile_record(int per_thread, int warp, int lane, int j) {
  return (warp * per_thread + j) * 32 + lane;
}

// Stable rank of each of the thread's kChunk records (lane < 0: none) among
// the earlier records of its warp on its lane; s_count[warp * L + l] keeps
// the warp's running count on lane l (zero before the tile's first round),
// moved on by the last record of each group.  kBits = ceil(log2 L), fixed
// at compile time so the ballots unroll.
template <int kBits>
__device__ __forceinline__ void warp_ranks(const int (&lane_of)[kChunk], int (&rank)[kChunk],
                                           int32_t* s_count, int num_lanes) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int32_t* mine = s_count + warp * num_lanes;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int l = lane_of[j];
    unsigned peers = __ballot_sync(kFull, l >= 0);
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
      const unsigned set = __ballot_sync(kFull, (l >> b) & 1);
      peers &= (l >> b) & 1 ? set : ~set;
    }
    const int leader = 31 - __clz(peers);
    int before = 0;
    if (l >= 0 && lane == leader) {
      before = mine[l];
      mine[l] = before + __popc(peers);
    }
    before = __shfl_sync(kFull, before, l >= 0 ? leader : lane);
    rank[j] = before + __popc(peers & lower);
    __syncwarp();
  }
}

// Takes the block's next tile (false when every tile is taken) and zeroes
// the per-warp lane counts for it.  The first barrier orders the previous
// tile's reads of shared memory before they are overwritten.
__device__ __forceinline__ bool next_tile(const RankScratch& r, unsigned total,
                                          int32_t* s_count, unsigned* s_ticket, unsigned& t) {
  __syncthreads();
  if (threadIdx.x == 0) *s_ticket = atomicAdd(r.ticket, 1u);
  for (int c = threadIdx.x; c < kWarps * r.num_lanes; c += kThreads) s_count[c] = 0;
  __syncthreads();
  t = *s_ticket;
  return t < total;
}

// The tile's exclusive prefix per lane (into s_excl) over the earlier tiles
// of worker w; on the way, s_count becomes each warp's offset in the tile
// and s_agg gets the tile's per-lane aggregate.
// Publishes the tile's aggregates, then its inclusive prefix, and on the
// worker's last tile writes its counts.
__device__ __forceinline__ void tile_prefix(const RankScratch& r, int w, int k,
                                            int32_t* s_count, int32_t* s_excl, int32_t* s_agg,
                                            int32_t* counts, int* s_walk, int* s_part) {
  const int L = r.num_lanes;
  const int64_t row0 = static_cast<int64_t>(w) * r.tiles;  // the worker's first tile
  const int64_t tile = row0 + k;
  int32_t* flags = r.flags + row0;
  const bool last = k == r.tiles - 1;
  // aggregates, one thread per lane
  for (int l = threadIdx.x; l < L; l += kThreads) {
    int agg = 0;
    for (int x = 0; x < kWarps; ++x) {
      const int c = s_count[x * L + l];
      s_count[x * L + l] = agg;
      agg += c;
    }
    s_agg[l] = agg;
    s_excl[l] = 0;
    (k == 0 ? r.inclusive : r.aggregate)[tile * L + l] = agg;
    if (k == 0 && last) counts[w * static_cast<int64_t>(L) + l] = agg;
  }
  publish_flag(flags + k, k == 0 ? kPrefix : kAggregate, threadIdx.x < L);
  if (k == 0) return;
  // the walk: warp 0, 32 earlier tiles at a time, to the nearest prefix
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int base = k - 1;; base -= 32) {
      const int j = base - lane;
      int f = j >= 0 ? observe(flags + j) : kPrefix;  // before tile 0: an empty prefix
      while (f == 0) f = observe(flags + j);
      const unsigned found = __ballot_sync(kFull, f == kPrefix);
      if (found) {  // the walk stops at the nearest inclusive prefix
        const int at = __ffs(found) - 1;
        const int stop_flag = __shfl_sync(kFull, f, at);
        if (lane == 0) {
          s_walk[0] = base - at;
          s_walk[1] = stop_flag;
        }
        break;
      }
    }
    __threadfence();  // the counts read after the flags are current
  }
  __syncthreads();
  // the sums over the tiles from the walk's stop, per lane: with L <=
  // kThreads, `reps` threads a lane, neighbouring threads on neighbouring
  // counts, each summing every reps-th tile; then one thread a lane adds
  // the partial sums and stores the tile's inclusive prefix
  // (a stop before tile 0, the empty prefix, reads as tile 0's inclusive
  // prefix: the same sum)
  const int from = s_walk[0] < 0 ? 0 : s_walk[0], from_flag = s_walk[1];
  const int reps = kThreads / L;
  auto finish = [&](int l, int sum) {
    const int agg = s_agg[l];
    s_excl[l] = sum;
    r.inclusive[tile * L + l] = sum + agg;
    if (last) counts[w * static_cast<int64_t>(L) + l] = sum + agg;
  };
  auto count_of = [&](int j, int l) {  // final once flagged, so the loads overlap
    const int32_t* rows = j == from && from_flag == kPrefix ? r.inclusive : r.aggregate;
    return __ldcg(rows + (row0 + j) * L + l);
  };
  if (reps > 0) {
    int sum = 0;
    if (threadIdx.x < reps * L) {
      const int l = threadIdx.x % L;
#pragma unroll 8
      for (int j = from + static_cast<int>(threadIdx.x) / L; j < k; j += reps)
        sum += count_of(j, l);
    }
    s_part[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x < L) {
      int total = 0;
      for (int x = threadIdx.x; x < reps * L; x += L) total += s_part[x];
      finish(threadIdx.x, total);
    }
  } else {
    for (int l = threadIdx.x; l < L; l += kThreads) {
      int sum = 0;
#pragma unroll 8
      for (int j = from; j < k; ++j) sum += count_of(j, l);
      finish(l, sum);
    }
  }
  publish_flag(flags + k, kPrefix, threadIdx.x < L);
}

// Exclusive scan of in[0, L) into out over the block (every thread calls
// it); s_warp holds kWarps ints.
__device__ __forceinline__ void scan_lanes(const int32_t* in, int32_t* out, int L,
                                           int32_t* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (L + kThreads - 1) / kThreads;
  const int l0 = threadIdx.x * per, l1 = l0 + per < L ? l0 + per : L;
  int sum = 0;
  for (int l = l0; l < l1; ++l) sum += in[l];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int x = 0; x < warp; ++x) run += s_warp[x];
  for (int l = l0; l < l1; ++l) {
    out[l] = run;
    run += in[l];
  }
}

// Ranks every record of every tile the block takes.  `rec.load(row, first,
// n, p0, lane_of)` gives the lanes of the thread's kChunk records at places
// p0 + 32 j in the tile (record first + p of its worker, flat index row +
// first + p; -1 when not counted or past n, -2 when not counted but its
// slot is 0) and may keep what it read in shared memory at p;
// `rec.emit(w, at, p, l, slot, place)` takes its slot (l -1 when not
// counted) and, with Records::kStaged, its place among the tile's counted
// records in lane order; then `rec.flush(w, row, first, s_excl, s_start,
// count)` follows a barrier (s_start: each lane's first place; count: the
// tile's counted records).  `rec.prefetch(at, count)` asks the L2 cache for
// records [at, at + count).  `s_rank` holds rank_shared_ints(r.tile, L)
// int32s of dynamic shared memory.
template <class Records>
__device__ __forceinline__ void rank_tiles(Records& rec, const RankScratch& r,
                                           int num_workers, int n, int32_t* counts,
                                           int32_t* s_rank) {
  __shared__ unsigned s_ticket;
  __shared__ int s_walk[2];
  __shared__ int s_part[kThreads];
  const int L = r.num_lanes, per = r.per_thread;
  uint32_t* s_lr = reinterpret_cast<uint32_t*>(s_rank);  // [tile] lane << 16 | rank
  int32_t* s_count = s_rank + r.tile;
  int32_t* s_excl = s_count + kWarps * L;
  int32_t* s_agg = s_excl + L;
  int32_t* s_start = s_agg + L;
  int32_t* s_warp = s_start + L;
  const unsigned total = static_cast<unsigned>(num_workers) * r.tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned t;
  while (next_tile(r, total, s_count, &s_ticket, t)) {
    const int w = static_cast<int>(t / r.tiles);
    const int k = static_cast<int>(t - static_cast<unsigned>(w) * r.tiles);
    const int64_t row = static_cast<int64_t>(w) * n;
    const int first = k * r.tile;
    const int count = n - first < r.tile ? n - first : r.tile;
    rec.prefetch(row + first, count);  // the whole tile in flight at once
    for (int c = 0; c < per; c += kChunk) {
      int lane_of[kChunk], rank[kChunk];
      rec.load(row, first, n, tile_record(per, warp, lane, c), lane_of);
      switch (r.lane_bits) {  // L <= 1024
        case 0: warp_ranks<0>(lane_of, rank, s_count, L); break;
        case 1: warp_ranks<1>(lane_of, rank, s_count, L); break;
        case 2: warp_ranks<2>(lane_of, rank, s_count, L); break;
        case 3: warp_ranks<3>(lane_of, rank, s_count, L); break;
        case 4: warp_ranks<4>(lane_of, rank, s_count, L); break;
        case 5: warp_ranks<5>(lane_of, rank, s_count, L); break;
        case 6: warp_ranks<6>(lane_of, rank, s_count, L); break;
        case 7: warp_ranks<7>(lane_of, rank, s_count, L); break;
        case 8: warp_ranks<8>(lane_of, rank, s_count, L); break;
        case 9: warp_ranks<9>(lane_of, rank, s_count, L); break;
        default: warp_ranks<10>(lane_of, rank, s_count, L); break;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        s_lr[tile_record(per, warp, lane, c + j)] =
            (static_cast<uint32_t>(lane_of[j]) & kNone) << 16 |
            (static_cast<uint32_t>(rank[j]) & kNone);
    }
    __syncthreads();
    tile_prefix(r, w, k, s_count, s_excl, s_agg, counts, s_walk, s_part);
    __syncthreads();
    if (Records::kStaged) {
      scan_lanes(s_agg, s_start, L, s_warp);
      __syncthreads();
    }
#pragma unroll 4
    for (int j = 0; j < per; ++j) {
      const int p = tile_record(per, warp, lane, j), i = first + p;
      if (i >= n) continue;
      const uint32_t v = s_lr[p];
      const uint32_t lf = v >> 16;
      if (lf < kZero) {
        const int l = static_cast<int>(lf);
        const int local = s_count[warp * L + l] + static_cast<int>(v & kNone);
        rec.emit(w, row + i, p, l, s_excl[l] + local,
                 Records::kStaged ? s_start[l] + local : 0);
      } else {
        rec.emit(w, row + i, p, -1, lf == kZero ? 0 : -1, 0);
      }
    }
    if (Records::kStaged) {
      __syncthreads();
      rec.flush(w, row, first, s_excl, s_start, s_start[L - 1] + s_agg[L - 1]);
    }
  }
}

}  // namespace
