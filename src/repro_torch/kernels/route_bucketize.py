"""Fused route + slot + bucketize (``route_bucketize``) for W stacked
workers: the CUDA kernel's wrapper, beside its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/route_bucketize.py::
route_bucketize``.  That kernel scattered by one-hot matmuls and carried
int32 channels as 16-bit f32 halves for the wrapper to recombine; the CUDA
kernel (``csrc/route_kernels.cu``) stores int32 natively and writes the
fills itself, so its outputs are the send buffers as the exchange plane
consumes them: one launch fills every cell with 16-byte stores, a second
routes, ranks (one pass, ``csrc/lane_rank.cuh``) and scatters.  It is
bounded by device-memory bytes on an H100.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.route_bucketize_ref`); on a CUDA tensor it
launches the kernel or raises.  ``route_bucketize.launches`` counts the
launches.  ``out=`` hands both a recycled set of the four send buffers to
write in place (the overlapped driver's ping-pong pool): the kernel's fill
writes every cell, so a set holding an earlier batch's rows comes back
equal to a fresh one.  ``part_loads`` (float32 ``[num_partitions]``)
turns the split-key replica pick into the two-choice least-load pick, in
the kernel itself.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import build
from repro_torch.kernels.lookup_dispatch import check_route_inputs, rank_scratch, split_pointers
from repro_torch.kernels.ref import route_bucketize_ref

__all__ = ["route_bucketize", "route_bucketize_plain"]


def route_bucketize_plain(keys, valid, vals, heavy_keys, heavy_parts, host_to_part,
                          heavy_repl=None, *, seed=0, num_hosts=4096, num_lanes,
                          capacity, key_fill, num_partitions=0, part_loads=None,
                          out=None):
    """The plain PyTorch version of :func:`route_bucketize` (any device)."""
    split = num_partitions > 0
    return route_bucketize_ref(
        keys, valid, vals, heavy_keys, heavy_parts, host_to_part, seed=seed,
        num_hosts=num_hosts, num_lanes=num_lanes, capacity=capacity,
        key_fill=key_fill, heavy_repl=heavy_repl if split else None,
        num_partitions=num_partitions, part_loads=part_loads if split else None,
        out=out)


def _check_out(out, w, num_lanes, capacity, dim, dev):
    """Raise ``ValueError`` unless ``out`` is a set the kernel can fill."""
    shape = (w, num_lanes, capacity)
    want = [(torch.bool, shape), (torch.int32, shape), (torch.float32, shape + (dim,)),
            (torch.int32, shape)]
    if len(out) != 4:
        raise ValueError(f"route kernel out: 4 buffers (valid, keys, vals, part), "
                         f"got {len(out)}")
    for name, t, (dtype, shp) in zip(("buf_valid", "buf_keys", "buf_vals", "buf_part"),
                                     out, want):
        if (t.dtype != dtype or tuple(t.shape) != shp or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"route kernel out: {name} must be a contiguous, 16-byte aligned "
                f"{dtype}{list(shp)} on {dev}, got {t.dtype}{list(t.shape)} on {t.device}")


def route_bucketize(keys, valid, vals, heavy_keys, heavy_parts, host_to_part,
                    heavy_repl=None, *, seed=0, num_hosts=4096, num_lanes,
                    capacity, key_fill, num_partitions=0, part_loads=None, out=None):
    """Returns ``(part[W, n], slot[W, n], counts[W, L], buf_valid[W, L, cap]
    bool, buf_keys[W, L, cap] int32, buf_vals[W, L, cap, D] f32,
    buf_part[W, L, cap] int32)`` for keys ``int32[W, n]`` and vals
    ``f32[W, n, D]`` of W stacked workers.

    Records whose slot is at or past ``capacity`` drop out (the counts keep
    them); empty cells hold ``key_fill`` / 0 / 0 / False.  ``out``, when
    given, is the ``(buf_valid, buf_keys, buf_vals, buf_part)`` set to write
    (checked: shape, dtype, device, contiguity; ``ValueError`` otherwise)
    and is returned in place of fresh buffers.  ``part_loads`` switches the
    split-key replica pick to the two-choice least-load tie-break."""
    if keys.device.type == "cpu":
        return route_bucketize_plain(
            keys, valid, vals, heavy_keys, heavy_parts, host_to_part, heavy_repl,
            seed=seed, num_hosts=num_hosts, num_lanes=num_lanes, capacity=capacity,
            key_fill=key_fill, num_partitions=num_partitions, part_loads=part_loads,
            out=out)
    check_route_inputs(keys, valid, heavy_keys, heavy_parts, host_to_part, heavy_repl,
                       num_hosts=num_hosts, num_lanes=num_lanes,
                       num_partitions=num_partitions, part_loads=part_loads)
    w, n = keys.shape
    if (vals.dtype != torch.float32 or vals.dim() != 3 or vals.shape[:2] != keys.shape
            or vals.device != keys.device or not vals.is_contiguous()):
        raise ValueError(f"route kernel input: vals must be contiguous f32[{w}, {n}, D] "
                         f"on {keys.device}, got {vals.dtype}{list(vals.shape)}")
    if not 0 <= capacity < 2**31 // max(w * num_lanes, 1):
        raise ValueError(f"route kernel input: capacity {capacity} out of range")
    lib = build.library()
    dim = vals.shape[2]
    dev = keys.device
    part = torch.empty_like(keys)
    slot = torch.empty_like(keys)
    counts = torch.empty((w, num_lanes), dtype=torch.int32, device=dev)
    scratch = rank_scratch(keys, num_lanes, "route_bucketize")
    if out is None:
        shape = (w, num_lanes, capacity)
        out = (torch.empty(shape, dtype=torch.bool, device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev),
               torch.empty(shape + (dim,), dtype=torch.float32, device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev))
    else:
        _check_out(out, w, num_lanes, capacity, dim, dev)
    buf_valid, buf_keys, buf_vals, buf_part = out
    repl, loads = split_pointers(heavy_repl, part_loads, num_partitions)
    code = lib.rk_route_bucketize(
        keys.data_ptr(), valid.data_ptr(), vals.data_ptr(), dim, w, n,
        heavy_keys.data_ptr(), heavy_parts.data_ptr(), repl, heavy_keys.shape[0],
        host_to_part.data_ptr(), num_hosts, seed_mix(seed), num_lanes, num_partitions,
        loads, capacity, int(key_fill), part.data_ptr(), slot.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), buf_valid.data_ptr(), buf_keys.data_ptr(),
        buf_vals.data_ptr(), buf_part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "route_bucketize")
    route_bucketize.launches += 1
    return part, slot, counts, buf_valid, buf_keys, buf_vals, buf_part


route_bucketize.launches = 0
