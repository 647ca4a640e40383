"""Partition lookup (``partition_apply``) for keys ``[W, n]`` or ``[n]``:
the CUDA kernel's wrapper, beside its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/partition_apply.py::
partition_apply`` — the batch replay's partition-assignment pass.  The
kernel (``csrc/batch_kernels.cu``) reads keys and writes parts 16 bytes a
thread at a time, 16 records in flight, and keeps the host table and the
heavy table in shared memory: a hashed probe table of the heavy keys, or
the sorted keys for a binary search when the table has more rows than the
probe takes (``build.library().rk_probe_slots(B)`` is 0).  It is bounded by
device-memory bytes on an H100.  Unlike the TPU kernel it takes an empty
heavy table (``B = 0``).  ``heavy_keys`` must be sorted ascending, as the
partitioner keeps it: the first row equal to a key wins.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.partition_apply_ref`); on a CUDA tensor it
launches the kernel or raises.  ``partition_apply.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import build
from repro_torch.kernels.lookup_dispatch import MAX_HOSTS
from repro_torch.kernels.ref import partition_apply_ref

__all__ = ["MAX_HEAVY", "partition_apply", "partition_apply_plain"]

MAX_HEAVY = 16384  # with 8192 hosts, 160 KB of shared memory


def partition_apply_plain(keys, heavy_keys, heavy_parts, host_to_part, *, seed=0,
                          num_hosts=4096):
    """The plain PyTorch version of :func:`partition_apply` (any device)."""
    return partition_apply_ref(keys, heavy_keys, heavy_parts, host_to_part, seed=seed,
                               num_hosts=num_hosts)


def _check(keys, heavy_keys, heavy_parts, host_to_part, num_hosts):
    build.require_cuda("partition_apply", keys, heavy_keys, heavy_parts, host_to_part)
    if keys.dim() not in (1, 2) or keys.dtype != torch.int32:
        raise ValueError(f"partition_apply input: keys must be int32[W, n] or int32[n], "
                         f"got {keys.dtype}{list(keys.shape)}")
    for t in (heavy_keys, heavy_parts, host_to_part):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"partition_apply input: tables must be int32 vectors, "
                             f"got {t.dtype}{list(t.shape)}")
    if heavy_parts.shape != heavy_keys.shape or heavy_keys.shape[0] > MAX_HEAVY:
        raise ValueError(f"partition_apply input: heavy tables must have one length "
                         f"<= {MAX_HEAVY}")
    if (host_to_part.shape[0] != num_hosts or num_hosts & (num_hosts - 1)
            or not 1 <= num_hosts <= MAX_HOSTS):
        raise ValueError(f"partition_apply input: host table must hold num_hosts = a "
                         f"power of two <= {MAX_HOSTS} entries")


def partition_apply(keys, heavy_keys, heavy_parts, host_to_part, *, seed=0,
                    num_hosts=4096):
    """``int32`` partition of every key, shaped as ``keys``: the first
    heavy row equal to the key, else the hashed host's partition.
    ``heavy_keys`` is sorted ascending and may be empty."""
    if keys.device.type == "cpu":
        return partition_apply_plain(keys, heavy_keys, heavy_parts, host_to_part,
                                     seed=seed, num_hosts=num_hosts)
    _check(keys, heavy_keys, heavy_parts, host_to_part, num_hosts)
    part = torch.empty_like(keys)
    code = build.library().bk_partition_apply(
        keys.data_ptr(), keys.numel(), heavy_keys.data_ptr(), heavy_parts.data_ptr(),
        heavy_keys.shape[0], host_to_part.data_ptr(), num_hosts, seed_mix(seed),
        part.data_ptr(), torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(code, "partition_apply")
    partition_apply.launches += 1
    return part


partition_apply.launches = 0
