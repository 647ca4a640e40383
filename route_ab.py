"""The route kernels against the parent's, in one process on one CUDA card:
partition_apply at the batch path's shape (10,000,000 keys, the KIP tables
of phase 6 at exponent 1.2), lookup_dispatch at the migrate step's (the
final state of phase 2's DR loop, 8 x 262,144 rows) and route_bucketize at
the shuffle's (phase 2's last batch), which shares their route.

    mkdir -p build/route_parent
    git archive f80bd67 src/repro_torch/kernels/csrc | tar -x -C build/route_parent
    python3 route_ab.py

``build/route_parent`` (git-ignored) holds the parent's sources (commit
f80bd67: a binary search of the heavy table, one record a thread in
partition_apply, the host table copied into every block).  The script
builds them beside the port's own kernels, checks that both give the
plain version's outputs, then times each kernel in turns (parent, new,
new, parent): CUDA events around one call, and device time by kernel name
over 20 calls (``chip_smoke.own_device_time``) without and with a 128 MiB
L2 flush between calls.

Then it splits each kernel's time by phase.  It builds copies of the
route and batch sources, parent's and new, in a temporary directory with
``%globaltimer`` stamps at the phase boundaries (``PARENT_STAMPS``,
``NEW_STAMPS``; the shipping sources carry none).  Each warp's leader
reads the timer at every boundary, after a vote that waits for the
phase's loaded values, and adds the time since the last stamp to the
phase; the sums over all warps of 20 flushed calls give each phase's
share of the warps' time.  A stamped phase ends only when its loads have
arrived, so the split describes a kernel whose phases run one after
another in each warp: it says where a warp waits, not what the unstamped
kernel overlaps, and a wait for another block counts in the phase where
it happens.  The ms beside each share is that share of the unstamped
kernel's flushed device time.  Beside the split it prints, for one
flushed call, when each block reached its marks (``MARKS``): from the
stamped copies, and from copies that carry the marks alone
(``MARKS_ONLY``), which run within a few percent of the kernel's own
time.
"""
from __future__ import annotations

import contextlib
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc")
PARENT = REPO / "build/route_parent"
KERNELS = ("partition_apply", "lookup_dispatch", "route_bucketize")
PHASES = ("preload", "ticket", "key loads", "host gather", "heavy search", "part stores",
          "multisplit", "look-back", "slot stores", "gather + store")
P = {name: i for i, name in enumerate(PHASES)}
N_PHASES = 16  # accumulators in a stamped copy (>= len(PHASES))
# the times each block's thread 0 records: its start, its route's end (the
# barrier after the preload in partition_apply, before the look-back of its
# last tile in lookup_dispatch), the walk's end, the look-back's end, its end
MARKS = ("start", "routed", "walked", "ranked", "end")

# Added to route_common.cuh inside its namespace: the stamps.
STAMP_HEADER = r"""
// ---- %globaltimer stamps (route_ab.py's copies only) ----
constexpr int kStampPhases = NPHASES;
__device__ unsigned long long g_stamp[kStampPhases + 1];  // warp-ns by phase, warps
__device__ unsigned g_stamp_sink;
constexpr int kStampBlocks = 8192;
constexpr int kStampMarks = 5;
// per block, its thread 0's time at the marks (MARKS in route_ab.py)
__device__ unsigned long long g_stamp_block[kStampMarks * kStampBlocks];
__shared__ unsigned long long s_stamp_last[kWarps];
__shared__ unsigned long long s_stamp_acc[kWarps * kStampPhases];

__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ void stamp_mark(int k) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks)
    g_stamp_block[k * kStampBlocks + blockIdx.x] = stamp_now();
}
__device__ __forceinline__ bool stamp_leader() {
  return static_cast<int>(threadIdx.x & 31) == __ffs(__activemask()) - 1;
}
__device__ __forceinline__ void stamp_begin() {
  __syncwarp(__activemask());
  if (stamp_leader()) {
    const int w = threadIdx.x >> 5;
    for (int p = 0; p < kStampPhases; ++p) s_stamp_acc[w * kStampPhases + p] = 0;
    s_stamp_last[w] = stamp_now();
  }
  stamp_mark(0);
  __syncwarp(__activemask());
}
// Waits until v has arrived in every active lane.
__device__ __forceinline__ void stamp_wait(unsigned v) {
  if (__any_sync(__activemask(), v == 0x5A5A5A5Bu)) g_stamp_sink = v;
}
__device__ __forceinline__ void stamp(int phase) {
  const unsigned m = __activemask();
  __syncwarp(m);
  if (stamp_leader()) {
    const int w = threadIdx.x >> 5;
    const unsigned long long now = stamp_now();
    s_stamp_acc[w * kStampPhases + phase] += now - s_stamp_last[w];
    s_stamp_last[w] = now;
  }
  __syncwarp(m);
}
__device__ __forceinline__ void stamp_end() {
  if (stamp_leader()) {
    const int w = threadIdx.x >> 5;
    for (int p = 0; p < kStampPhases; ++p)
      atomicAdd(&g_stamp[p], s_stamp_acc[w * kStampPhases + p]);
    atomicAdd(&g_stamp[kStampPhases], 1ull);
  }
  stamp_mark(4);
}
__global__ void stamp_resolution_kernel(unsigned long long* out) {
  unsigned long long last = stamp_now(), best = ~0ull;
  for (int i = 0; i < 200000; ++i) {
    const unsigned long long t = stamp_now();
    if (t != last) {
      best = t - last < best ? t - last : best;
      last = t;
    }
  }
  *out = best;
}
""".replace("NPHASES", str(N_PHASES))

# Appended to each stamped .cu: read and zero the sums, and the timer's step.
STAMP_ENTRY = r"""
extern "C" {
int stamp_reset() {
  unsigned long long z[kStampPhases + 1] = {};
  void* blocks = nullptr;
  if (cudaError_t e = cudaGetSymbolAddress(&blocks, g_stamp_block)) return e;
  if (cudaError_t e = cudaMemset(blocks, 0,
                                 sizeof(unsigned long long) * kStampMarks * kStampBlocks))
    return e;
  return cudaMemcpyToSymbol(g_stamp, z, sizeof z);
}
int stamp_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_stamp, sizeof(unsigned long long) * (kStampPhases + 1));
}
int stamp_read_blocks(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_stamp_block,
                              sizeof(unsigned long long) * kStampMarks * kStampBlocks);
}
int stamp_resolution(unsigned long long* out) {
  unsigned long long* d = nullptr;
  if (cudaError_t e = cudaMalloc(&d, sizeof *d)) return e;
  stamp_resolution_kernel<<<1, 1>>>(d);
  cudaError_t e = cudaMemcpy(out, d, sizeof *d, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return e;
}
}
"""


def _wait_all(arr: str, extra: str = "", n: str = "kChunk") -> str:
    return (f"{{ unsigned d_ = 0; for (int j_ = 0; j_ < {n}; ++j_) "
            f"d_ ^= static_cast<unsigned>({arr}[j_]){extra}; stamp_wait(d_); }} ")


# (file, anchor, replacement) edits that put the stamps into a copy of the
# sources (each anchor must occur exactly once).  The route and the rank of
# lookup_dispatch read alike in the parent's sources and the port's:
RANK_STAMPS = [
    ("route_common.cuh", "\n}  // namespace\n", STAMP_HEADER + "\n}  // namespace\n"),
    ("lane_rank.cuh", "  while (next_tile(r, total, s_count, &s_ticket, t)) {\n",
     f"  while (next_tile(r, total, s_count, &s_ticket, t)) {{\n    stamp({P['ticket']});\n"),
    ("route_kernels.cu", "  rank_tiles(rec, r, a.num_workers, a.n, a.counts, s_rank);\n}\n",
     "  rank_tiles(rec, r, a.num_workers, a.n, a.counts, s_rank);\n  stamp_end();\n}\n"),
    ("route_kernels.cu", "      on[j] = in && a.valid[row + idx[j]];\n    }\n",
     "      on[j] = in && a.valid[row + idx[j]];\n    }\n    "
     + _wait_all("key", " + on[j_]") + f"stamp({P['key loads']});\n"),
    ("route_kernels.cu",
     "      part[j] = (part[j] + offset) % a.num_partitions;\n    }\n  }\n}\n",
     "      part[j] = (part[j] + offset) % a.num_partitions;\n    }\n  }\n  "
     + _wait_all("part") + f"stamp({P['heavy search']});\n}}\n"),
    ("route_kernels.cu",
     "        s_part[p0 + 32 * j] = part[j];\n      }\n    }\n  }\n",
     "        s_part[p0 + 32 * j] = part[j];\n      }\n    }\n"
     f"    stamp({P['part stores']});\n  }}\n"),
    ("lane_rank.cuh",
     "            (static_cast<uint32_t>(rank[j]) & kNone);\n    }\n    __syncthreads();\n"
     "    tile_prefix(r, w, k, s_count, s_excl, s_agg, counts, s_walk, s_part);\n"
     "    __syncthreads();\n",
     "            (static_cast<uint32_t>(rank[j]) & kNone);\n"
     f"      stamp({P['multisplit']});\n    }}\n    __syncthreads();\n"
     f"    stamp({P['multisplit']});\n"
     "    stamp_mark(1);\n"
     "    tile_prefix(r, w, k, s_count, s_excl, s_agg, counts, s_walk, s_part);\n"
     f"    __syncthreads();\n    stamp({P['look-back']});\n    stamp_mark(3);\n"),
    ("lane_rank.cuh",
     "        rec.emit(w, row + i, p, -1, lf == kZero ? 0 : -1, 0);\n      }\n    }\n",
     "        rec.emit(w, row + i, p, -1, lf == kZero ? 0 : -1, 0);\n      }\n    }\n"
     f"    stamp({P['slot stores']});\n"),
    ("lane_rank.cuh",
     "      rec.flush(w, row, first, s_excl, s_start, s_start[L - 1] + s_agg[L - 1]);\n"
     "    }\n  }\n}\n",
     "      rec.flush(w, row, first, s_excl, s_start, s_start[L - 1] + s_agg[L - 1]);\n"
     f"    }}\n  }}\n  stamp({P['ticket']});\n}}\n"),
]

# The parent's (commit f80bd67): partition_apply routes one record a thread,
# grid-stride; lookup_dispatch copies the host table one int at a time.
PARENT_STAMPS = RANK_STAMPS + [
    ("route_kernels.cu",
     "    part[j] = s_host[mixed[j] & static_cast<uint32_t>(a.num_hosts - 1)];\n  }\n",
     "    part[j] = s_host[mixed[j] & static_cast<uint32_t>(a.num_hosts - 1)];\n  }\n  "
     + _wait_all("part") + f"stamp({P['host gather']});\n"),
    ("batch_kernels.cu", "  extern __shared__ int32_t smem[];\n  int32_t* s_host = smem;\n",
     "  extern __shared__ int32_t smem[];\n  int32_t* s_host = smem;\n  stamp_begin();\n"),
    ("batch_kernels.cu",
     "  __syncthreads();\n  const uint32_t mask = static_cast<uint32_t>(num_hosts - 1);\n",
     f"  __syncthreads();\n  stamp({P['preload']});\n  stamp_mark(1);\n"
     "  const uint32_t mask = static_cast<uint32_t>(num_hosts - 1);\n"),
    ("batch_kernels.cu", "    const int32_t key = keys[i];\n",
     f"    const int32_t key = keys[i];\n    stamp_wait(key); stamp({P['key loads']});\n"),
    ("batch_kernels.cu", "    const int j = heavy_find(s_hk, num_heavy, key);\n",
     "    const int j = heavy_find(s_hk, num_heavy, key);\n"
     f"    stamp_wait(j); stamp({P['heavy search']});\n"),
    ("batch_kernels.cu",
     "                     : s_host[fmix32(static_cast<uint32_t>(key) ^ seed_mix) & mask];\n"
     "  }\n}\n",
     "                     : s_host[fmix32(static_cast<uint32_t>(key) ^ seed_mix) & mask];\n"
     f"    stamp({P['gather + store']});\n  }}\n  stamp_end();\n}}\n"),
    ("route_kernels.cu",
     "  for (int i = threadIdx.x; i < a.num_hosts; i += kThreads) smem[i] = a.host_to_part[i];\n",
     "  stamp_begin();\n"
     "  for (int i = threadIdx.x; i < a.num_hosts; i += kThreads) smem[i] = a.host_to_part[i];\n"
     f"  stamp({P['preload']});\n"),
]

# The port's: partition_apply routes 8 records a thread in lock step (the
# heavy search stamp includes the hash; the first loads fly during the
# preload); the route kernels build the probe table in the preload and
# read the host table through the L1 cache.
NEW_STAMPS = RANK_STAMPS + [
    ("route_kernels.cu",
     "    part[j] = __ldg(a.host_to_part + (mixed[j] & static_cast<uint32_t>(a.num_hosts - 1)));\n"
     "  }\n",
     "    part[j] = __ldg(a.host_to_part + (mixed[j] & static_cast<uint32_t>(a.num_hosts - 1)));\n"
     "  }\n  " + _wait_all("part") + f"stamp({P['host gather']});\n"),
    ("batch_kernels.cu", "  extern __shared__ int4 s_apply[];  // 16-byte aligned\n",
     "  extern __shared__ int4 s_apply[];\n  stamp_begin();\n"),
    ("batch_kernels.cu",
     "  __syncthreads();\n  const uint32_t host_mask = static_cast<uint32_t>(num_hosts - 1);\n"
     "  for (; base < vecs; base += step) {\n",
     f"  __syncthreads();\n  stamp({P['preload']});\n  stamp_mark(1);\n"
     "  const uint32_t host_mask = static_cast<uint32_t>(num_hosts - 1);\n"
     "  for (; base < vecs; base += step) {\n    "
     + _wait_all("v", n="kRecords") + f"stamp({P['key loads']});\n"),
    ("batch_kernels.cu",
     "#pragma unroll\n    for (int j = 0; j < kRecords; ++j) v[j] = next[j];\n  }\n",
     f"    stamp({P['gather + store']});\n"
     "#pragma unroll\n    for (int j = 0; j < kRecords; ++j) v[j] = next[j];\n  }\n"),
    ("batch_kernels.cu", "  heavy_rows(h, v, mixed, row);\n",
     "  heavy_rows(h, v, mixed, row);\n  " + _wait_all("row", n="N")
     + f"stamp({P['heavy search']});\n"),
    ("batch_kernels.cu", "      part[i] = one[0];\n    }\n  }\n}\n",
     "      part[i] = one[0];\n    }\n  }\n  stamp_end();\n}\n"),
    ("route_kernels.cu", "  extern __shared__ int2 s_route[];\n",
     "  extern __shared__ int2 s_route[];\n  stamp_begin();\n"),
    ("route_kernels.cu",
     "  // (the first tile's barrier orders the probe table's stores before a probe)\n",
     f"  stamp({P['preload']});\n"),
]

# which stamped source each kernel's split is read from
# Copies with the block marks alone (no per-warp stamps, so nearly the
# kernel's own timing): the parent's and the port's sources.
_RANK_MARKS = [
    ("route_common.cuh", "\n}  // namespace\n", STAMP_HEADER + "\n}  // namespace\n"),
    ("route_kernels.cu", "  rank_tiles(rec, r, a.num_workers, a.n, a.counts, s_rank);\n}\n",
     "  rank_tiles(rec, r, a.num_workers, a.n, a.counts, s_rank);\n  stamp_mark(4);\n}\n"),
    ("lane_rank.cuh",
     "    __syncthreads();\n"
     "    tile_prefix(r, w, k, s_count, s_excl, s_agg, counts, s_walk, s_part);\n"
     "    __syncthreads();\n",
     "    __syncthreads();\n    stamp_mark(1);\n"
     "    tile_prefix(r, w, k, s_count, s_excl, s_agg, counts, s_walk, s_part);\n"
     "    __syncthreads();\n    stamp_mark(3);\n"),
    ("lane_rank.cuh", "  __syncthreads();\n  // the sums over the tiles from the walk's stop",
     "  __syncthreads();\n  stamp_mark(2);\n  // the sums over the tiles from the walk's stop"),
]
MARKS_ONLY = {
    "parent": _RANK_MARKS + [
        ("route_kernels.cu", "  extern __shared__ int32_t smem[];\n",
         "  extern __shared__ int32_t smem[];\n  stamp_mark(0);\n"),
        ("batch_kernels.cu", "  extern __shared__ int32_t smem[];\n  int32_t* s_host = smem;\n",
         "  extern __shared__ int32_t smem[];\n  int32_t* s_host = smem;\n  stamp_mark(0);\n"),
        ("batch_kernels.cu",
         "  __syncthreads();\n  const uint32_t mask = static_cast<uint32_t>(num_hosts - 1);\n",
         "  __syncthreads();\n  stamp_mark(1);\n"
         "  const uint32_t mask = static_cast<uint32_t>(num_hosts - 1);\n"),
        ("batch_kernels.cu",
         "                     : s_host[fmix32(static_cast<uint32_t>(key) ^ seed_mix) & mask];\n"
         "  }\n}\n",
         "                     : s_host[fmix32(static_cast<uint32_t>(key) ^ seed_mix) & mask];\n"
         "  }\n  __syncthreads();\n  stamp_mark(4);\n}\n"),
    ],
    "new": _RANK_MARKS + [
        ("route_kernels.cu", "  extern __shared__ int2 s_route[];\n",
         "  extern __shared__ int2 s_route[];\n  stamp_mark(0);\n"),
        ("batch_kernels.cu", "  extern __shared__ int4 s_apply[];  // 16-byte aligned\n",
         "  extern __shared__ int4 s_apply[];\n  stamp_mark(0);\n"),
        ("batch_kernels.cu", "  copy_wait();\n  __syncthreads();\n",
         "  copy_wait();\n  __syncthreads();\n  stamp_mark(1);\n"),
        ("batch_kernels.cu", "      part[i] = one[0];\n    }\n  }\n}\n",
         "      part[i] = one[0];\n    }\n  }\n  __syncthreads();\n  stamp_mark(4);\n}\n"),
    ],
}

SPLIT_SOURCE = {"partition_apply": "batch_kernels.cu", "lookup_dispatch": "route_kernels.cu"}


def _replace(text: str, old: str, new: str, where: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"stamp anchor found {text.count(old)} times in {where}: {old!r}")
    return text.replace(old, new)


def stamped_copy(src: Path, edits, dst: Path) -> None:
    """A copy of the sources in ``src`` with ``edits`` applied and the
    stamp entry points appended to each .cu."""
    dst.mkdir(parents=True)
    for f in src.iterdir():
        shutil.copy(f, dst / f.name)
    for name, old, new in edits:
        path = dst / name
        path.write_text(_replace(path.read_text(), old, new, f"{src}/{name}"))
    for name in SPLIT_SOURCE.values():
        path = dst / name
        path.write_text(path.read_text() + STAMP_ENTRY)


def nvcc_lib(nvcc: str, sources: list[Path], out: Path) -> subprocess.Popen:
    """Starts one nvcc that builds ``sources`` into the shared library ``out``."""
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared"]
    return subprocess.Popen([nvcc, *flags, "-o", str(out), *map(str, sources)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(path: Path):
    """The library at ``path`` with the port's C signatures on the entry
    points it has (a stamped copy has only one source's)."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name, (args, res) in build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    for name in ("stamp_reset", "stamp_read", "stamp_read_blocks", "stamp_resolution"):
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def using(lib):
    """The port's wrappers launch from ``lib`` inside."""
    from repro_torch.kernels import build

    saved = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = saved


def through(lib, fn):
    def call():
        with using(lib):
            return fn()
    return call


def split(lib, fn, flush, *, n=20) -> tuple[list[int], int]:
    """(warp-ns by phase, warps) of ``n`` calls of ``fn`` on the stamped
    ``lib``, each after an L2 flush."""
    with using(lib):
        fn()
        torch.cuda.synchronize()
        assert lib.stamp_reset() == 0
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * (N_PHASES + 1))()
    assert lib.stamp_read(out) == 0
    return list(out[:N_PHASES]), int(out[N_PHASES])


def timeline(lib, fn, flush, marks=MARKS) -> str:
    """Percentiles (0, 50, 90, 100) over the blocks of one flushed call on
    the stamped ``lib`` of the times of each of ``marks`` that the copy
    records, in us from the first block's start."""
    import numpy as np

    with using(lib):
        fn()
        torch.cuda.synchronize()
        assert lib.stamp_reset() == 0
        flush()
        fn()
        torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * (len(MARKS) * 8192))()
    assert lib.stamp_read_blocks(out) == 0
    stamps = np.frombuffer(out, dtype=np.uint64).reshape(len(MARKS), 8192).astype(np.float64)
    seen = stamps[0] > 0
    t0 = stamps[0][seen].min()
    parts = []
    for k, label in enumerate(marks):
        at = stamps[k][seen & (stamps[k] > 0)]
        if at.size:
            q = np.percentile((at - t0) / 1e3, [0, 50, 90, 100])
            parts.append(f"{label} " + "/".join(f"{x:.2f}" for x in q))
    return f"{int(seen.sum())} blocks, us p0/p50/p90/p100: " + "; ".join(parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("route_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (PARENT / CSRC).is_dir():
        print(f"route_ab: {PARENT / CSRC} is missing (see the docstring)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import rank_ab
    from repro_torch.kernels import build
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch, lookup_dispatch_plain
    from repro_torch.kernels.partition_apply import partition_apply, partition_apply_plain
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    dev = torch.device("cuda")
    nvcc = build.nvcc_path()
    kernel = {"partition_apply": partition_apply, "lookup_dispatch": lookup_dispatch,
              "route_bucketize": route_bucketize}
    plain = {"partition_apply": partition_apply_plain,
             "lookup_dispatch": lookup_dispatch_plain, "route_bucketize": route_bucketize_plain}
    with tempfile.TemporaryDirectory(prefix="route_ab_") as tmp:
        tmp = Path(tmp)
        jobs = {"parent": nvcc_lib(nvcc, [PARENT / CSRC / "route_kernels.cu",
                                          PARENT / CSRC / "batch_kernels.cu"],
                                   tmp / "libparent.so")}
        for which, root, edits in (("parent", PARENT / CSRC, PARENT_STAMPS),
                                   ("new", REPO / CSRC, NEW_STAMPS)):
            for kind, kind_edits in (("stamped", edits), ("marked", MARKS_ONLY[which])):
                stamped_copy(root, kind_edits, tmp / f"{kind}_{which}")
                for name, source in SPLIT_SOURCE.items():
                    jobs[f"{which} {name} {kind}"] = nvcc_lib(
                        nvcc, [tmp / f"{kind}_{which}" / source],
                        tmp / f"lib_{kind}_{which}_{name}.so")
        libs = {"new": build.library()}
        for label, proc in jobs.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {label}:\n{err}")
        libs["parent"] = load(tmp / "libparent.so")
        stamped = {(which, name): load(tmp / f"lib_stamped_{which}_{name}.so")
                   for which in ("parent", "new") for name in SPLIT_SOURCE}
        marked = {(which, name): load(tmp / f"lib_marked_{which}_{name}.so")
                  for which in ("parent", "new") for name in SPLIT_SOURCE}
        res = ctypes.c_ulonglong()
        assert stamped["new", "partition_apply"].stamp_resolution(ctypes.byref(res)) == 0
        card = cs.card_line()
        print(card, flush=True)
        print(f"%globaltimer step on this card: {res.value} ns", flush=True)

        inputs = rank_ab.path_inputs(dev)
        flush = cs.l2_flush(dev)
        device_ms = {}
        for name in KERNELS:
            args, kw = inputs[name]
            calls = {which: through(libs[which], lambda: kernel[name](*args, **kw))
                     for which in ("parent", "new")}
            want = plain[name](*args, **kw)
            for which, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                got, want_ = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                assert all(torch.equal(g, x) for g, x in zip(got, want_)), (name, which)
            del want, got
            print(f"{name}: parent and new equal the plain version", flush=True)
            names = cs.DEVICE_NAMES[name]
            seen = {"parent": [], "new": []}
            for which in ("parent", "new", "new", "parent"):
                ms = cs.cuda_ms(calls[which])
                warm, _, _ = cs.own_device_time(calls[which], names)
                cold, by, ops = cs.own_device_time(calls[which], names, flush=flush)
                seen[which].append((ms, warm, cold))
                print(f"{name} {which}: events {ms:.4f} ms; device {warm:.4f} ms unflushed, "
                      f"{cold:.4f} ms flushed ({ops:g} device operations a call: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in by.items()) + ")", flush=True)
            for which, rows in seen.items():
                mean = [statistics.mean(r[i] for r in rows) for i in range(3)]
                device_ms[name, which] = mean[2]
                print(f"{name} {which}, mean of 2: events {mean[0]:.4f} ms, device "
                      f"{mean[1]:.4f} ms unflushed, {mean[2]:.4f} ms flushed", flush=True)

        for name in SPLIT_SOURCE:
            args, kw = inputs[name]
            for which in ("parent", "new"):
                lib = stamped[which, name]
                fn = lambda: kernel[name](*args, **kw)  # noqa: E731
                acc, warps = split(lib, fn, flush)
                cold, _, _ = cs.own_device_time(through(lib, fn), cs.DEVICE_NAMES[name],
                                                flush=flush)
                total = sum(acc)
                base = device_ms[name, which]
                parts = [f"{PHASES[p]} {100 * v / total:.1f}% ({v / total * base:.4f} ms)"
                         for p, v in enumerate(acc) if v]
                print(f"{name} {which} split ({warps // 20} warps a call; stamped copy "
                      f"{cold:.4f} ms flushed, unstamped {base:.4f} ms): " + ", ".join(parts),
                      flush=True)
                print(f"{name} {which} timeline of the stamped copy: "
                      f"{timeline(lib, fn, flush)}", flush=True)
                cold, _, _ = cs.own_device_time(through(marked[which, name], fn),
                                                cs.DEVICE_NAMES[name], flush=flush)
                print(f"{name} {which} timeline of the copy with block marks alone "
                      f"({cold:.4f} ms flushed): {timeline(marked[which, name], fn, flush)}",
                      flush=True)
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
