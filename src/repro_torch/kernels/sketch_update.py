"""Count-min sketch accumulation (``sketch_update``) for W stacked workers:
the CUDA kernel's wrapper, beside its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/sketch_update.py::
sketch_update``.  The kernel (``csrc/batch_kernels.cu``) counts in int32
(in shared memory when the rows fit) and converts to float32 at the end, so
it is deterministic and equals the reference's float32 sum while every cell
stays below 2**24.  It is bounded by device-memory bytes on an H100.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.sketch_update_ref`); on a CUDA tensor it
launches the kernel or raises.  ``sketch_update.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sketch_update_ref

__all__ = ["MAX_DEPTH", "sketch_update", "sketch_update_plain"]

MAX_DEPTH = 8


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
    if not 1 <= depth <= MAX_DEPTH or width < 1 or w * depth * width >= 2**31:
        raise ValueError(f"sketch_update input: need 1 <= depth <= {MAX_DEPTH}, width >= 1 "
                         f"and fewer than 2**31 cells, got depth {depth}, width {width}")
    if w > 65535 or keys.numel() >= 2**31:
        raise ValueError("sketch_update input: too many records for one launch")


def sketch_update(keys, valid, *, depth=4, width=2048):
    """``float32[depth, width]`` count-min sketch of the valid keys
    (``[W, depth, width]``, one per worker, for stacked keys)."""
    if keys.device.type == "cpu":
        return sketch_update_plain(keys, valid, depth=depth, width=width)
    _check(keys, valid, depth, width)
    k2 = keys if keys.dim() == 2 else keys.unsqueeze(0)
    w, n = k2.shape
    acc = torch.empty((w, depth, width), dtype=torch.int32, device=keys.device)
    out = torch.empty((w, depth, width), dtype=torch.float32, device=keys.device)
    code = build.library().bk_sketch_update(
        k2.data_ptr(), valid.data_ptr(), w, n, depth, width, acc.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(code, "sketch_update")
    sketch_update.launches += 1
    return out if keys.dim() == 2 else out[0]


sketch_update.launches = 0
