"""Public wrappers around the port's kernels, with the reference's padding
and sentinel rules (``repro.kernels.ops``).

* Heavy tables are padded to a multiple of ``KEY_LANES`` (128) rows with
  sentinel keys, part 0 and replica count 0 (clamped to 1).  Invalid
  records carry the sentinel key, so they "hit" a pad row and route to
  partition 0; every consumer masks their part.
* ``route_bucketize`` pads one whole tile of sentinel rows when the heavy
  table is empty; ``route_slots`` and ``apply_partitioner`` do not (their
  kernels take ``B = 0``; the reference's Pallas kernels do not).
* Records need no padding: the CUDA kernels mask the ragged edge.  The
  capacity is exactly the caller's (the TPU kernel's 128-column padding of
  it was internal to that kernel).
* ``valid`` defaults to all records in ``count_sketch`` and
  ``dispatch_slots``, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import KEY_SENTINEL
from repro_torch.kernels.dispatch_count import dispatch_count
from repro_torch.kernels.lookup_dispatch import lookup_dispatch
from repro_torch.kernels.partition_apply import partition_apply
from repro_torch.kernels.route_bucketize import route_bucketize as _route_bucketize_kernel
from repro_torch.kernels.sketch_update import sketch_update

__all__ = [
    "KEY_LANES",
    "apply_partitioner",
    "count_sketch",
    "dispatch_slots",
    "pad_heavy_tables",
    "route_bucketize",
    "route_slots",
]

KEY_LANES = 128


def pad_heavy_tables(tables, *, num_partitions: int, pad_empty: bool):
    """(heavy_keys, heavy_parts, heavy_repl or None) padded to the tile."""
    hk, hp, hr = tables.heavy_keys, tables.heavy_parts, tables.heavy_repl
    b = hk.shape[0]
    bpad = KEY_LANES if (b == 0 and pad_empty) else (-b) % KEY_LANES
    if bpad:
        def pad(t, fill):
            return torch.cat([t, torch.full((bpad,), int(fill), dtype=torch.int32,
                                            device=t.device)])
        hk, hp = pad(hk, KEY_SENTINEL), pad(hp, 0)
        hr = pad(hr, 0) if num_partitions > 0 else None
    elif num_partitions <= 0:
        hr = None
    return hk.contiguous(), hp.contiguous(), None if hr is None else hr.contiguous()


def route_slots(keys, valid, tables, *, num_hosts: int, seed: int = 0,
                num_lanes: int, num_partitions: int = 0, part_loads=None):
    """Fused partition lookup + lane slot: ``(part, slot, counts)`` for keys
    ``[W, n]`` (see :func:`repro_torch.kernels.lookup_dispatch`);
    ``part_loads`` is the least-load replica pick's load vector."""
    hk, hp, hr = pad_heavy_tables(tables, num_partitions=num_partitions, pad_empty=False)
    return lookup_dispatch(
        keys.to(torch.int32).contiguous(), valid.contiguous(), hk, hp,
        tables.host_to_part.contiguous(), hr, seed=seed, num_hosts=num_hosts,
        num_lanes=num_lanes, num_partitions=num_partitions, part_loads=part_loads)


def route_bucketize(keys, valid, tables, vals, *, num_hosts: int, seed: int = 0,
                    num_lanes: int, capacity: int, key_fill: int,
                    num_partitions: int = 0, part_loads=None, out=None):
    """Fused route + slot + bucketize: ``(part, slot, counts, buf_valid,
    buf_keys, buf_vals, buf_part)`` with ``[W, L, capacity]`` buffers,
    written into ``out = (buf_valid, buf_keys, buf_vals, buf_part)`` when
    given (a recycled set); ``part_loads`` as in :func:`route_slots`."""
    hk, hp, hr = pad_heavy_tables(tables, num_partitions=num_partitions, pad_empty=True)
    return _route_bucketize_kernel(
        keys.to(torch.int32).contiguous(), valid.contiguous(),
        vals.to(torch.float32).contiguous(), hk, hp,
        tables.host_to_part.contiguous(), hr, seed=seed, num_hosts=num_hosts,
        num_lanes=num_lanes, capacity=capacity, key_fill=key_fill,
        num_partitions=num_partitions, part_loads=part_loads, out=out)


def apply_partitioner(keys, tables, *, num_hosts: int, seed: int = 0):
    """Partition id of every key (``[W, n]`` or ``[n]``) under
    :class:`~repro_torch.core.partitioner.PartitionerTables`: the batch
    replay's assignment pass (see :mod:`repro_torch.kernels.partition_apply`)."""
    hk, hp, _ = pad_heavy_tables(tables, num_partitions=0, pad_empty=False)
    return partition_apply(keys.to(torch.int32).contiguous(), hk, hp,
                           tables.host_to_part.contiguous(), seed=seed,
                           num_hosts=num_hosts)


def count_sketch(keys, valid=None, *, depth: int = 4, width: int = 2048):
    """``float32[depth, width]`` count-min sketch of the batch (one per
    worker for ``[W, n]`` keys; see :mod:`repro_torch.kernels.sketch_update`)."""
    keys = keys.to(torch.int32).contiguous()
    valid = torch.ones_like(keys, dtype=torch.bool) if valid is None else valid
    return sketch_update(keys, valid.to(torch.bool).contiguous(), depth=depth, width=width)


def dispatch_slots(dest, valid=None, *, num_parts: int):
    """``(slot, counts)`` for building the all-to-all send buffers (see
    :mod:`repro_torch.kernels.dispatch_count`)."""
    dest = dest.to(torch.int32).contiguous()
    valid = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
    return dispatch_count(dest, valid.to(torch.bool).contiguous(), num_parts=num_parts)
