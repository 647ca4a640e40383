"""Fused partition lookup + lane slot (``lookup_dispatch``) for W stacked
workers: the CUDA kernel's wrapper, beside its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/lookup_dispatch.py::
lookup_dispatch``.  The kernel (``csrc/route_kernels.cu``) is bounded by
device-memory bytes on an H100, looks heavy keys up in a hashed probe
table in shared memory (``csrc/route_common.cuh``; a binary search for
tables too large for it) and ranks records deterministically in one pass
(``csrc/lane_rank.cuh``: ticketed tiles and a decoupled look-back); the
sources' headers say how.  ``heavy_keys`` must be sorted ascending.
``part_loads`` (float32 ``[num_partitions]``) turns the split-key replica
pick into the two-choice least-load pick, in the kernel itself.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.lookup_dispatch_ref`); on a CUDA tensor it
launches the kernel or raises.  ``lookup_dispatch.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import build
from repro_torch.kernels.ref import lookup_dispatch_ref

__all__ = ["lookup_dispatch", "lookup_dispatch_plain"]

MAX_LANES = 1024
MAX_HOSTS = 8192


def lookup_dispatch_plain(keys, valid, heavy_keys, heavy_parts, host_to_part,
                          heavy_repl=None, *, seed=0, num_hosts=4096, num_lanes,
                          num_partitions=0, part_loads=None):
    """The plain PyTorch version of :func:`lookup_dispatch` (any device)."""
    split = num_partitions > 0
    return lookup_dispatch_ref(
        keys, valid, heavy_keys, heavy_parts, host_to_part, seed=seed,
        num_hosts=num_hosts, num_lanes=num_lanes,
        heavy_repl=heavy_repl if split else None, num_partitions=num_partitions,
        part_loads=part_loads if split else None)


def _fail(msg: str):
    raise ValueError(f"route kernel input: {msg}")


def check_route_inputs(keys, valid, heavy_keys, heavy_parts, host_to_part,
                       heavy_repl, *, num_hosts, num_lanes, num_partitions,
                       part_loads=None):
    """Raise ``ValueError`` on anything the CUDA route kernels do not take.
    ``part_loads`` is read only when ``num_partitions > 0``."""
    tables = [heavy_keys, heavy_parts, host_to_part]
    loads = [part_loads] if num_partitions > 0 and part_loads is not None else []
    if num_partitions > 0:
        if heavy_repl is None:
            _fail("splitting (num_partitions > 0) needs the replica table")
        tables.append(heavy_repl)
    build.require_cuda("route kernel", keys, valid, *tables, *loads)
    for t in loads:
        if t.dtype != torch.float32 or tuple(t.shape) != (num_partitions,):
            _fail(f"part_loads must be float32[{num_partitions}], got "
                  f"{t.dtype}{list(t.shape)}")
    if keys.dim() != 2 or keys.dtype != torch.int32:
        _fail(f"keys must be int32[W, n], got {keys.dtype}{list(keys.shape)}")
    if valid.dtype != torch.bool or valid.shape != keys.shape:
        _fail(f"valid must be bool{list(keys.shape)}, got {valid.dtype}{list(valid.shape)}")
    for t in tables:
        if t.dim() != 1 or t.dtype != torch.int32:
            _fail(f"tables must be int32 vectors, got {t.dtype}{list(t.shape)}")
    b = heavy_keys.shape[0]
    if heavy_parts.shape[0] != b or (num_partitions > 0 and heavy_repl.shape[0] != b):
        _fail("heavy tables differ in length")
    if host_to_part.shape[0] != num_hosts or num_hosts & (num_hosts - 1) or num_hosts > MAX_HOSTS:
        _fail(f"host table must hold num_hosts = a power of two <= {MAX_HOSTS} entries")
    if not 1 <= num_lanes <= MAX_LANES:
        _fail(f"num_lanes must be in [1, {MAX_LANES}], got {num_lanes}")
    if keys.shape[0] > 65535 or keys.numel() >= 2**31:
        _fail("too many records for one launch")


def split_pointers(heavy_repl, part_loads, num_partitions):
    """The replica table's and the load vector's pointers (``None``: null)
    as the route kernels read them: only while splitting is on."""
    if num_partitions <= 0:
        return None, None
    return heavy_repl.data_ptr(), None if part_loads is None else part_loads.data_ptr()


# the kernels that rank, as the C side numbers them (csrc/lane_rank.cuh)
RANK_KERNELS = {"lookup_dispatch": 0, "route_bucketize": 1, "dispatch_count": 2}


def rank_scratch(keys, num_lanes, kernel):
    """The one-pass rank's scratch for records ``[W, n]`` of ``kernel`` (a
    ticket, and a flag and two rows of lane counts per tile); the launch
    sequence zeroes what must start at zero."""
    w, n = keys.shape
    words = build.library().rk_scratch_words(RANK_KERNELS[kernel], w, n, num_lanes)
    return torch.empty(words, dtype=torch.int64, device=keys.device)


def lookup_dispatch(keys, valid, heavy_keys, heavy_parts, host_to_part,
                    heavy_repl=None, *, seed=0, num_hosts=4096, num_lanes,
                    num_partitions=0, part_loads=None):
    """``(part int32[W, n], slot int32[W, n], counts int32[W, L])`` for keys
    ``int32[W, n]`` of W stacked workers.

    ``slot`` is each valid record's stable rank within lane ``part % L``
    (-1 when invalid).  ``num_partitions > 0`` turns on the split-key
    replica pick from ``heavy_repl``, and ``part_loads`` its two-choice
    least-load tie-break."""
    if keys.device.type == "cpu":
        return lookup_dispatch_plain(
            keys, valid, heavy_keys, heavy_parts, host_to_part, heavy_repl,
            seed=seed, num_hosts=num_hosts, num_lanes=num_lanes,
            num_partitions=num_partitions, part_loads=part_loads)
    check_route_inputs(keys, valid, heavy_keys, heavy_parts, host_to_part, heavy_repl,
                       num_hosts=num_hosts, num_lanes=num_lanes,
                       num_partitions=num_partitions, part_loads=part_loads)
    lib = build.library()
    w, n = keys.shape
    part = torch.empty_like(keys)
    slot = torch.empty_like(keys)
    counts = torch.empty((w, num_lanes), dtype=torch.int32, device=keys.device)
    scratch = rank_scratch(keys, num_lanes, "lookup_dispatch")
    repl, loads = split_pointers(heavy_repl, part_loads, num_partitions)
    code = lib.rk_lookup_dispatch(
        keys.data_ptr(), valid.data_ptr(), w, n,
        heavy_keys.data_ptr(), heavy_parts.data_ptr(), repl, heavy_keys.shape[0],
        host_to_part.data_ptr(), num_hosts, seed_mix(seed), num_lanes, num_partitions,
        loads, part.data_ptr(), slot.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(code, "lookup_dispatch")
    lookup_dispatch.launches += 1
    return part, slot, counts


lookup_dispatch.launches = 0
