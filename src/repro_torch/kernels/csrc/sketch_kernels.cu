// Count-min sketch accumulation (sketch_update) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/sketch_update.py:50  sketch_update  (pallas_call :65)
// which carries the sketch in VMEM across a sequential grid and adds each
// step's 256 records as a one-hot [256, width] matmul.  Neither carries
// over: blocks run in parallel, and a one-hot product is width times the
// work.
//
// What it computes, per worker w of W, for each valid record of its n:
//   out[w, d, fmix32(key ^ (d * golden mod 2**32)) % width] += 1,  d < depth,
// counted in int32 and converted to float32 once, so the sketch is
// deterministic and equals the reference's float32 sum while every cell
// stays below 2**24.
//
// What bounds it on an H100: integer operations, then bytes.  Bytes: each
// record's 4-byte key and 1-byte valid flag read once, W * depth * width *
// 4 written (at the batch path's 10 M records, depth 4, width 2048: 50 MB,
// 0.0149 ms at 3.35 TB/s).  Operations, by the pipe that runs them: a flag
// test a record; for a valid record the hash's first step once
// (fmix32(key ^ s) begins key ^ (key >> 16) ^ s ^ (s >> 16)), then for
// each row an xor with the row's seed (none for row 0), two shift-xors
// with the column's mask fused into the last (a power-of-two width; else
// Lemire's fastmod, a remainder by an invariant divisor) and the address
// from the row's base, on the ALU pipe, and two multiplies on the FMA
// pipe: 26 ALU and 8 FMA operations a record at depth 4 (sketch_ab.py
// --sass holds the loop's SASS to this count).  The ALU pipe's 64 lanes
// an SM bind: 260 M at the batch path's shape, 0.0155 ms at 132 SMs x
// 1.98 GHz (chip_smoke.sketch_ops; the shared atomic adds are not
// counted).
//
// The design, against what held the kernel of commit cd6bcde back
// (PERF.md §6: its shared atomics behind a warp match of every row's
// column, 256-thread blocks that width 8192 left one to an SM, global
// atomics for rows above shared memory):
//   * Persistent blocks of 1,024 threads, one an SM, each with the rows in
//     shared memory (each row padded to 4 cells); a thread takes 4 records from one 16-byte key vector
//     (neighbouring threads on neighbouring vectors) and their 4 valid
//     flags as one word (one byte at a time where the flags do not lie on
//     4 bytes), while its next vector is in flight.  A key view that does
//     not start on 16 bytes takes its first records (under 4) one at a
//     time, as it does the last.  (Trials with 8 or 16 records a thread,
//     512-thread blocks two or three to an SM, or 2-6 private copies of the
//     rows a block to spread hot cells were no faster.)
//   * No warp match: every valid record adds 1 to its cells, which the
//     compiler emits as ATOMS.POPC.INC, a shared atomic that adds each
//     address's lanes in one step, so equal keys of a warp cost no more
//     than distinct ones.  A match a record on the key, its leader adding
//     the group's count (sketch_ab.py's MATCH copy), was slower at every
//     skew measured.
//   * The column is a mask when the width is a power of two, else a
//     remainder by the host's fastmod constant (no division).
//   * Across blocks without global atomics on cells: each block of a
//     cluster of 8 sums one eighth of the cells over the cluster's shared
//     memory (distributed shared memory) into the cluster's partial sketch
//     in device memory, 16 bytes at a time, fences, and takes its eighth's
//     ticket; the block of the last cluster to do so sums that eighth over
//     the clusters' partials in a fixed order and writes float32.  One
//     memset of the tickets and one kernel a call: no accumulator to clear
//     and no conversion pass.
//   * Rows too large for one block (above 200 KiB: depth 8, width 8192)
//     are split by rows over a group of 2, 4 or 8 blocks of the cluster:
//     the blocks of a group read the same records (the second read mostly
//     from L2) and each adds the cells of its own rows; the same cluster
//     sum follows, each cell read from the block of each group that holds
//     its row.

#include <cooperative_groups.h>

#include "route_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSketchThreads = 1024;
constexpr int kSketchCluster = 8;   // blocks of a cluster
constexpr int kSketchMaxDepth = 8;

// s ^ (s >> 16) for row d's seed s = d * golden: the hash's first step,
// moved off the key (key ^ s) ^ ((key ^ s) >> 16) = h ^ row_mix(d) with
// h = key ^ (key >> 16).
__host__ __device__ constexpr uint32_t row_mix(int d) {
  return (static_cast<uint32_t>(d) * kGolden) ^ ((static_cast<uint32_t>(d) * kGolden) >> 16);
}

// x % d for every uint32 x, with magic = 2**64 // d + 1 (mod 2**64).
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t magic, uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(magic * x, d));
}

struct SketchArgs {
  const int32_t* keys;   // [W, n]
  const uint8_t* valid;  // [W, n]
  int n;
  int width;
  uint64_t magic;        // fastmod constant for width (unused for a power of two)
  int stride;            // cells of a row in shared memory and in the partials:
                         // width rounded up to 4, so a 16-byte chunk lies in one row
  int split;             // blocks of a group, over which the rows are split (1: none)
  int rows_per_block;    // ceil(depth / split)
  int block_cells;       // int32s of a block's rows: rows_per_block * stride
  int clusters;          // clusters per worker
  int cells_pad;         // depth * stride
  int32_t* tickets;      // [W, kSketchCluster], zero at the start
  int32_t* partial;      // [clusters, W, cells_pad]
  float* out;            // [W, depth * width]
};

// The column of a hashed record-row.
template <bool kPow2>
__device__ __forceinline__ uint32_t sketch_col(uint32_t x, const SketchArgs& a) {
  return kPow2 ? x & static_cast<uint32_t>(a.width - 1)
               : fastmod(x, a.magic, static_cast<uint32_t>(a.width));
}

// fmix32 after its first step: h ^ row_mix(d) through the rest.
__device__ __forceinline__ uint32_t sketch_hash(uint32_t h, uint32_t mix) {
  uint32_t x = h ^ mix;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Adds cnt to key's cells of rows d0 <= d < d1 (kSplit; else all rows):
// row d of the block's rows starts at row[d].
template <int kDepth, bool kPow2, bool kSplit>
__device__ __forceinline__ void sketch_add(uint32_t key, int cnt, const SketchArgs& a,
                                           int32_t* const* row, int d0, int d1) {
  const uint32_t h = key ^ (key >> 16);
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (kSplit && (d < d0 || d >= d1)) continue;
    atomicAdd(row[d] + sketch_col<kPow2>(sketch_hash(h, row_mix(d)), a), cnt);
  }
}

// One thread's 4 keys from 16-byte key vector `at` and their valid flags
// (one byte a flag); nothing past the last vector.
__device__ __forceinline__ void sketch_load(const int4* key_vecs, const uint8_t* valid,
                                            bool valid_words, int64_t vecs, int64_t at,
                                            int4& k, uint32_t& v) {
  k = make_int4(0, 0, 0, 0);
  v = 0;
  if (at >= vecs) return;
  k = __ldg(key_vecs + at);
  if (valid_words) {
    v = __ldg(reinterpret_cast<const uint32_t*>(valid) + at);
  } else {
    const uint8_t* b = valid + 4 * at;
    v = __ldg(b) | (__ldg(b + 1) << 8) | (__ldg(b + 2) << 16) |
        (static_cast<uint32_t>(__ldg(b + 3)) << 24);
  }
}

// The shared::cluster address of p (this block's shared memory) in the
// block of the cluster with rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}

__device__ __forceinline__ int4 ld_cluster4(uint32_t addr) {
  int4 x;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr));
  return x;
}

__device__ __forceinline__ void add4(int4& s, const int4& x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// The sum over the cluster of cell chunk c (4 cells from 4 * c of the
// padded rows), rows[b] being the rows' address in the block of rank b: a
// 16-byte load from each block, all in flight before the sum (kSplit: from
// the block of each group of `split` blocks that holds the chunk's row,
// addressed from s_rows).
template <bool kSplit>
__device__ __forceinline__ int4 cluster_chunk(const uint32_t (&rows)[kSketchCluster],
                                              const int32_t* s_rows, int c,
                                              const SketchArgs& a) {
  int4 s = make_int4(0, 0, 0, 0);
  int4 x[kSketchCluster];
  if (!kSplit) {
#pragma unroll
    for (int b = 0; b < kSketchCluster; ++b) x[b] = ld_cluster4(rows[b] + 16 * c);
#pragma unroll
    for (int b = 0; b < kSketchCluster; ++b) add4(s, x[b]);
    return s;
  }
  const int d = 4 * c / a.stride;
  const uint32_t at = 4 * ((d % a.rows_per_block) * a.stride + 4 * c - d * a.stride);
  const int owner = d / a.rows_per_block;
#pragma unroll
  for (int g = 0; g < kSketchCluster; ++g)
    if (g % a.split == 0) x[g] = ld_cluster4(cluster_addr(s_rows, g + owner) + at);
#pragma unroll
  for (int g = 0; g < kSketchCluster; ++g)
    if (g % a.split == 0) add4(s, x[g]);
  return s;
}

// Grid (clusters * kSketchCluster, W), clusters of kSketchCluster blocks
// along x.  Shared memory: block_cells int32s.  With kSplit, the
// `split` blocks of a group (blockIdx.x / split) read the same records and
// each adds rows rows_per_block * (blockIdx.x % split) on.
template <int kDepth, bool kPow2, bool kSplit>
__global__ void __launch_bounds__(kSketchThreads, 1) sketch_rows_kernel(SketchArgs a) {
  extern __shared__ int4 s_sketch[];  // 16-byte aligned
  int32_t* s_rows = reinterpret_cast<int32_t*>(s_sketch);
  cg::cluster_group cluster = cg::this_cluster();
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = a.n;
  const int cells = kDepth * a.width;
  const int32_t* keys = a.keys + static_cast<int64_t>(w) * n;
  const uint8_t* valid = a.valid + static_cast<int64_t>(w) * n;
  // records before the keys' first 16-byte boundary, 16-byte vectors, a tail
  const int head_left =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(keys) & 15)) & 15) >> 2);
  const int head = head_left < n ? head_left : n;
  const int64_t vecs = (n - head) >> 2;
  const int tail = head + 4 * static_cast<int>(vecs);
  const int4* key_vecs = reinterpret_cast<const int4*>(keys + head);
  const uint8_t* vvalid = valid + head;
  const bool valid_words = (reinterpret_cast<uintptr_t>(vvalid) & 3) == 0;
  const int split = kSplit ? a.split : 1;
  const int d0 = kSplit ? static_cast<int>(blockIdx.x % split) * a.rows_per_block : 0;
  const int d1 = d0 + a.rows_per_block < kDepth ? d0 + a.rows_per_block : kDepth;
  const int group = static_cast<int>(blockIdx.x) / split;
  const int64_t step = static_cast<int64_t>(gridDim.x / split) * kSketchThreads;
  int64_t wbase = static_cast<int64_t>(group) * kSketchThreads + 32 * warp;
  int4 k, k_next;
  uint32_t v, v_next;
  sketch_load(key_vecs, vvalid, valid_words, vecs, wbase + lane, k, v);  // in flight meanwhile

  for (int i = threadIdx.x; i < (a.block_cells >> 2); i += kSketchThreads)
    s_sketch[i] = make_int4(0, 0, 0, 0);
  int32_t* row[kDepth];  // the block holds rows d0.. on
#pragma unroll
  for (int d = 0; d < kDepth; ++d) row[d] = s_rows + (d - d0) * a.stride;
  __syncthreads();

  for (; wbase < vecs; wbase += step) {
    sketch_load(key_vecs, vvalid, valid_words, vecs, wbase + step + lane, k_next, v_next);
    const int32_t key4[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool on = (v >> (8 * j)) & 0xFFu;
      const uint32_t key = static_cast<uint32_t>(key4[j]);
      if (on) sketch_add<kDepth, kPow2, kSplit>(key, 1, a, row, d0, d1);
    }
    k = k_next;
    v = v_next;
  }
  // the head and the tail, under 4 records each: one a thread of group 0
  if (group == 0 && threadIdx.x < 8) {
    const int i = threadIdx.x < 4 ? threadIdx.x : tail + threadIdx.x - 4;
    if ((threadIdx.x < 4 ? i < head : i < n) && valid[i])
      sketch_add<kDepth, kPow2, kSplit>(static_cast<uint32_t>(keys[i]), 1, a, row, d0, d1);
  }
  cluster.sync();  // every block's rows are complete

  // This block's eighth of the cells, summed over the cluster, into the
  // cluster's partial sketch.
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunks = a.cells_pad >> 2;
  const int per = (chunks + kSketchCluster - 1) / kSketchCluster;
  const int lo = rank * per;
  const int hi = lo + per < chunks ? lo + per : chunks;
  const int cl = blockIdx.x / kSketchCluster;
  int4* part = reinterpret_cast<int4*>(a.partial) +
               (static_cast<int64_t>(cl) * gridDim.y + w) * chunks;
  uint32_t rows[kSketchCluster];  // the cluster's rows, block by block
#pragma unroll
  for (int b = 0; b < kSketchCluster; ++b) rows[b] = cluster_addr(s_rows, b);
  for (int c = lo + threadIdx.x; c < hi; c += kSketchThreads)
    part[c] = cluster_chunk<kSplit>(rows, s_rows, c, a);
  __threadfence();  // the partial before the ticket (release)
  cluster.sync();   // and no block leaves while another reads its rows

  __shared__ bool s_last;
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.tickets + w * kSketchCluster + rank, 1) == a.clusters - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // the other clusters' partials after their tickets (acquire)
  const int4* parts = reinterpret_cast<const int4*>(a.partial) + static_cast<int64_t>(w) * chunks;
  const int64_t cl_stride = static_cast<int64_t>(gridDim.y) * chunks;
  float* out = a.out + static_cast<int64_t>(w) * cells;
  const bool vec_out = a.stride == a.width;  // then out rows lie on 16 bytes
  for (int c = lo + threadIdx.x; c < hi; c += kSketchThreads) {
    int4 s = make_int4(0, 0, 0, 0);
#pragma unroll 8
    for (int j = 0; j < a.clusters; ++j) {  // the loads in flight together
      const int4 x = __ldcg(parts + j * cl_stride + c);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    if (vec_out) {
      reinterpret_cast<float4*>(out)[c] = make_float4(s.x, s.y, s.z, s.w);
    } else {  // the chunk's cells of row d, from column col, less the padding
      const int d = 4 * c / a.stride;
      const int col = 4 * c - d * a.stride;
      const int e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < a.width) out[d * a.width + col + j] = static_cast<float>(e[j]);
    }
  }
}

using SketchKernel = void (*)(SketchArgs);

template <int kDepth>
SketchKernel sketch_kernel_of(bool pow2, bool split) {
  if (split)
    return pow2 ? sketch_rows_kernel<kDepth, true, true> : sketch_rows_kernel<kDepth, false, true>;
  return pow2 ? sketch_rows_kernel<kDepth, true, false>
              : sketch_rows_kernel<kDepth, false, false>;
}

SketchKernel sketch_kernel(int depth, bool pow2, bool split) {
  switch (depth) {
    case 1: return sketch_kernel_of<1>(pow2, split);
    case 2: return sketch_kernel_of<2>(pow2, split);
    case 3: return sketch_kernel_of<3>(pow2, split);
    case 4: return sketch_kernel_of<4>(pow2, split);
    case 5: return sketch_kernel_of<5>(pow2, split);
    case 6: return sketch_kernel_of<6>(pow2, split);
    case 7: return sketch_kernel_of<7>(pow2, split);
    case 8: return sketch_kernel_of<8>(pow2, split);
    default: return nullptr;
  }
}

cudaLaunchConfig_t sketch_config(dim3 grid, size_t smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSketchThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSketchCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Clusters of kSketchCluster blocks that fit on the card at once with the
// most shared memory a block takes (a block to an SM: its registers allow
// no more), or a negative CUDA error code; the wrapper's plan spreads a
// call's workers over them.
int bk_sketch_clusters() {
  const size_t smem = kMaxSharedBytes;
  SketchKernel kernel = sketch_kernel(4, true, false);
  if (cudaError_t e = allow_shared(kernel, smem)) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = sketch_config(dim3(kSketchCluster), smem, nullptr, &attr);
  int clusters = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg))
    return -static_cast<int>(e);
  return clusters;
}

// The sketch of W workers' n records each, with the wrapper's plan:
// clusters per worker and the split of the rows; scratch holds W *
// kSketchCluster tickets (a multiple of 16 bytes), then [clusters, W,
// cells_pad] partials.
int bk_sketch_update(const int32_t* keys, const uint8_t* valid, int num_workers, int n,
                     int depth, int width, uint64_t magic, int clusters, int split,
                     int32_t* scratch, float* out, void* stream) {
  if (num_workers <= 0) return 0;
  const bool pow2 = (width & (width - 1)) == 0;
  if (depth < 1 || depth > kSketchMaxDepth || width < 1 || n < 0 || clusters < 1 ||
      split < 1 || split > kSketchCluster || (split & (split - 1)) || num_workers > 65535 ||
      static_cast<int64_t>(clusters) * kSketchCluster > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  const int rows_per_block = (depth + split - 1) / split;
  const int64_t stride = (static_cast<int64_t>(width) + 3) & ~int64_t{3};
  const int64_t block_cells = rows_per_block * stride;
  const int64_t cells_pad = depth * stride;
  const int64_t smem = block_cells * static_cast<int64_t>(sizeof(int32_t));
  if (smem > kMaxSharedBytes || cells_pad > 0x7FFFFFFF) return cudaErrorInvalidValue;
  SketchKernel kernel = sketch_kernel(depth, pow2, split > 1);
  if (cudaError_t e = allow_shared(kernel, static_cast<size_t>(smem))) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tickets = static_cast<size_t>(num_workers) * kSketchCluster;
  if (cudaError_t e = cudaMemsetAsync(scratch, 0, tickets * sizeof(int32_t), st)) return e;
  SketchArgs a{keys, valid, n, width, magic, static_cast<int>(stride), split, rows_per_block,
               static_cast<int>(block_cells), clusters, static_cast<int>(cells_pad),
               scratch, scratch + tickets, out};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = sketch_config(dim3(clusters * kSketchCluster, num_workers),
                                         static_cast<size_t>(smem), st, &attr);
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a)) return e;
  return cudaGetLastError();
}

}  // extern "C"
