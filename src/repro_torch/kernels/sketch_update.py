"""Count-min sketch accumulation (``sketch_update``) for W stacked workers:
the CUDA kernel's wrapper, beside its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/sketch_update.py::
sketch_update``.  The kernel (``csrc/sketch_kernels.cu``) counts in int32
and converts to float32 once, so it is deterministic and equals the
reference's float32 sum while every cell stays below 2**24.  It is bounded
by integer operations (the hash of every record-row) and by bytes (the
keys and flags read once), the larger of the two.

One kernel a call: clusters of 8 blocks of 1,024 threads, a block to an
SM, each block with the rows in shared memory; each cluster sums its
blocks' rows through distributed shared memory into one partial sketch,
and the last cluster to finish an eighth of the cells sums that eighth
over the partials and writes float32 (a per-call ticket scratch, zeroed
by one memset).  :func:`plan` computes the launch from the shapes alone:
the path (``"shared"``, every block holding all rows, or ``"split"``, rows
above 200 KiB split by rows over a group of 2-8 blocks of a cluster that
read the same records), the grid, the scratch and the fastmod constant of
the width.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.sketch_update_ref`); on a CUDA tensor it
launches the kernel or raises.  ``sketch_update.launches`` counts the
launches.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sketch_update_ref

__all__ = ["MAX_DEPTH", "MAX_WIDTH", "SketchPlan", "fastmod", "fastmod_magic", "plan",
           "sketch_update", "sketch_update_plain"]

MAX_DEPTH = 8
SHARED_BYTES = 200 * 1024  # a block's shared memory for rows (csrc/route_common.cuh)
MAX_WIDTH = SHARED_BYTES // 4  # one row in one block
CLUSTER = 8        # blocks of a cluster (csrc/sketch_kernels.cu, kSketchCluster)
THREADS = 1024     # kSketchThreads; a thread takes 4 records a step


def fastmod_magic(width: int) -> int:
    """Lemire's fastmod constant of ``width``: ``2**64 // width + 1`` mod
    2**64."""
    return (2**64 // width + 1) % 2**64


def fastmod(x, magic: int, width: int):
    """``x % width`` for uint32 ``x`` as the kernel computes it: the high 64
    bits of ``((magic * x) mod 2**64) * width``.  ``x`` is an int, or a
    numpy uint64 array, taken in the kernel's wrapping uint64 arithmetic
    (the high half of the product from 32-bit halves)."""
    if isinstance(x, np.ndarray):
        low = x.astype(np.uint64) * np.uint64(magic)  # wraps mod 2**64
        w = np.uint64(width)
        return ((low >> np.uint64(32)) * w + (((low & np.uint64(0xFFFFFFFF)) * w)
                                               >> np.uint64(32))) >> np.uint64(32)
    return (((magic * x) % 2**64) * width) >> 64


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


@dataclasses.dataclass(frozen=True)
class SketchPlan:
    """One launch of the sketch kernel, from the shapes alone."""
    path: str             # "shared" (each block holds all rows) or "split"
    grid: tuple           # (clusters * CLUSTER, W)
    clusters: int         # clusters per worker
    split: int            # blocks of a group, over which the rows are split
    rows_per_block: int
    shared_bytes: int     # rows_per_block rows, each padded to 4 cells
    partial_shape: tuple  # int32 (clusters, W, depth rows padded to 4 cells)
    scratch_ints: int     # W * CLUSTER tickets, then the partials
    magic: int            # fastmod constant of the width
    pow2: bool            # the column is a mask


def _check_rows(depth, width):
    if not 1 <= depth <= MAX_DEPTH or not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"sketch_update input: need 1 <= depth <= {MAX_DEPTH} and "
                         f"1 <= width <= {MAX_WIDTH}, got depth {depth}, width {width}")


@functools.lru_cache(maxsize=256)
def plan(w: int, n: int, depth: int, width: int, *, resident_clusters: int) -> SketchPlan:
    """The launch for ``w >= 1`` workers of ``n`` records into ``depth``
    rows of ``width``, ``resident_clusters`` clusters fitting on the card
    at once (15 on an H100 80GB HBM3); raises ``ValueError`` on what the
    kernel does not take."""
    _check_rows(depth, width)
    stride = _round4(width)
    split = next(s for s in (1, 2, 4, 8) if -(-depth // s) * stride * 4 <= SHARED_BYTES)
    rows = -(-depth // split)
    needed = max(1, -(-n * split // (THREADS * 4 * CLUSTER)))
    clusters = max(1, min(resident_clusters // w, needed))
    return SketchPlan(
        path="shared" if split == 1 else "split", grid=(clusters * CLUSTER, w),
        clusters=clusters, split=split, rows_per_block=rows,
        shared_bytes=rows * stride * 4, partial_shape=(clusters, w, depth * stride),
        scratch_ints=w * CLUSTER + clusters * w * depth * stride, magic=fastmod_magic(width),
        pow2=width & (width - 1) == 0)


def sketch_update_plain(keys, valid, *, depth=4, width=2048):
    """The plain PyTorch version of :func:`sketch_update` (any device)."""
    return sketch_update_ref(keys, valid, depth=depth, width=width)


def _check(keys, valid, depth, width):
    build.require_cuda("sketch_update", keys, valid)
    if keys.dim() not in (1, 2) or keys.dtype != torch.int32:
        raise ValueError(f"sketch_update input: keys must be int32[W, n] or int32[n], "
                         f"got {keys.dtype}{list(keys.shape)}")
    if valid.dtype != torch.bool or valid.shape != keys.shape:
        raise ValueError(f"sketch_update input: valid must be bool{list(keys.shape)}, "
                         f"got {valid.dtype}{list(valid.shape)}")
    w = keys.shape[0] if keys.dim() == 2 else 1
    _check_rows(depth, width)
    if w > 65535 or keys.numel() >= 2**31:
        raise ValueError("sketch_update input: too many records for one launch")


_resident: dict[int, int] = {}


def _resident_clusters(lib, device) -> int:
    """Clusters of 8 sketch blocks that fit on ``device`` at once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _resident:
        with torch.cuda.device(index):
            got = lib.bk_sketch_clusters()
        build.check(-got if got < 0 else 0, "sketch_update (cluster occupancy)")
        _resident[index] = max(1, got)
    return _resident[index]


def sketch_update(keys, valid, *, depth=4, width=2048):
    """``float32[depth, width]`` count-min sketch of the valid keys
    (``[W, depth, width]``, one per worker, for stacked keys)."""
    if keys.device.type == "cpu":
        return sketch_update_plain(keys, valid, depth=depth, width=width)
    _check(keys, valid, depth, width)
    k2 = keys if keys.dim() == 2 else keys.unsqueeze(0)
    w, n = k2.shape
    out = torch.empty((w, depth, width), dtype=torch.float32, device=keys.device)
    if w == 0:
        return out
    lib = build.library()
    p = plan(w, n, depth, width, resident_clusters=_resident_clusters(lib, keys.device))
    scratch = torch.empty(p.scratch_ints, dtype=torch.int32, device=keys.device)
    code = lib.bk_sketch_update(
        k2.data_ptr(), valid.data_ptr(), w, n, depth, width, p.magic, p.clusters, p.split,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(code, "sketch_update")
    sketch_update.launches += 1
    return out if keys.dim() == 2 else out[0]


sketch_update.launches = 0
