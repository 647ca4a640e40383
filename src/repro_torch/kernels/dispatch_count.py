"""Stable rank within destination + counts (``dispatch_count``) for W
stacked workers: the CUDA kernel's wrapper, beside its plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/dispatch_count.py::
dispatch_count``, which the exchange's bucketize derives slots with when
none is handed in.  The kernel (``csrc/batch_kernels.cu``) is the route
kernels' one-pass deterministic rank (``csrc/lane_rank.cuh``) with the
destination given, one launch; it is bounded by device-memory bytes on an
H100.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.dispatch_count_ref`); on a CUDA tensor it
launches the kernel or raises.  ``dispatch_count.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lookup_dispatch import MAX_LANES as MAX_PARTS, rank_scratch
from repro_torch.kernels.ref import dispatch_count_ref

__all__ = ["MAX_PARTS", "dispatch_count", "dispatch_count_plain"]


def dispatch_count_plain(dest, valid, *, num_parts):
    """The plain PyTorch version of :func:`dispatch_count` (any device)."""
    return dispatch_count_ref(dest, valid, num_parts=num_parts)


def _check(dest, valid, num_parts):
    build.require_cuda("dispatch_count", dest, valid)
    if dest.dim() not in (1, 2) or dest.dtype != torch.int32:
        raise ValueError(f"dispatch_count input: dest must be int32[W, n] or int32[n], "
                         f"got {dest.dtype}{list(dest.shape)}")
    if valid.dtype != torch.bool or valid.shape != dest.shape:
        raise ValueError(f"dispatch_count input: valid must be bool{list(dest.shape)}, "
                         f"got {valid.dtype}{list(valid.shape)}")
    if not 1 <= num_parts <= MAX_PARTS:
        raise ValueError(f"dispatch_count input: num_parts must be in [1, {MAX_PARTS}], "
                         f"got {num_parts}")
    if (dest.shape[0] if dest.dim() == 2 else 1) > 65535 or dest.numel() >= 2**31:
        raise ValueError("dispatch_count input: too many records for one launch")


def dispatch_count(dest, valid, *, num_parts):
    """``(slot, counts)``: each valid record's stable rank among the
    earlier records of its worker with the same destination, 0 for a valid
    record whose destination lies outside ``[0, num_parts)`` (not counted),
    -1 for an invalid one; ``counts[W, num_parts]`` (1-D in, 1-D out)."""
    if dest.device.type == "cpu":
        return dispatch_count_plain(dest, valid, num_parts=num_parts)
    _check(dest, valid, num_parts)
    d2 = dest if dest.dim() == 2 else dest.unsqueeze(0)
    w, n = d2.shape
    slot = torch.empty_like(d2)
    counts = torch.empty((w, num_parts), dtype=torch.int32, device=dest.device)
    scratch = rank_scratch(d2, num_parts, "dispatch_count")
    code = build.library().bk_dispatch_count(
        d2.data_ptr(), valid.data_ptr(), w, n, num_parts, slot.data_ptr(),
        counts.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dest.device).cuda_stream)
    build.check(code, "dispatch_count")
    dispatch_count.launches += 1
    return (slot, counts) if dest.dim() == 2 else (slot[0], counts[0])


dispatch_count.launches = 0
