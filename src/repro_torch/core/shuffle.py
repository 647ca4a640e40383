"""Keyed shuffle and state migration over stacked workers.

One shuffle step, for W workers held as ``[W, n_local]`` tensors on one
device, built on the exchange plane (:mod:`repro_torch.exchange`):

1. every worker routes its local keys with the fused
   route -> slot -> bucketize pass (the ``route_bucketize`` CUDA kernel on
   the card, its plain version on the CPU),
2. the backend's all-to-all (the lane/worker transpose; the ragged
   backend exchanges the lane counts first) moves the ``[W, L, cap]`` send
   buffers and they are unpacked,
3. the DRW hook emits each worker's top-k histogram and the global
   per-partition loads.

State migration (:func:`make_migrate_step`) is the same exchange with lanes
sized by the planner (``migration_capacity``), routed by the
``lookup_dispatch`` kernel at worker granularity.  Partitions may outnumber
workers; ``worker = partition % W``.

Both steps are split-phase, as ``repro.core.shuffle``'s: the fused call is
``finish(start(...))`` on fresh buffers, and ``.start`` / ``.finish`` are
attached for the overlapped driver.  ``start`` runs route + bucketize +
the transport's control phase and returns every control-plane output
(loads, histograms, overflow, shipped rows) beside the pending exchange;
``finish`` ships the rows.  The split halves keep a two-set ping-pong pool
of send buffers: a set drained at ``finish`` becomes the next ``start``'s
buffers (written in place), so at pipeline depth 2 one set is in flight
while the other is filled; values equal the fresh path's.

Over a process group (``group=``, a :class:`~repro_torch.exchange.dist.
WorkerGroup`) each rank holds one worker, ``[1, n]``: it routes its own
keys through the same kernels on its device, and the figures the
reference sums with ``psum`` over the mesh (the loads, ``overflow``,
``lane_overflow``, the shipped rows and their classes; the migration's
moved and live rows too) are summed over the group, in one
``all_reduce``; the DRW histograms are all-gathered into the ``[W, K]``
the DR master reads, in rank order.  The start phase's outputs are then
the stacked step's, for all W workers.

Each host entry point (the fused ``step`` and ``migrate`` and both
``start`` halves) first calls :func:`~repro_torch.exchange.maybe_inject`
on the step's backend: an installed
:class:`~repro_torch.exchange.FaultyBackend` fires its plan there, one tick
per issued start, as at the reference's host boundary.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compat import host_fetch
from repro_torch.core.hashing import KEY_SENTINEL
from repro_torch.core.histogram import local_topk_histogram
from repro_torch.core.partitioner import PartitionerTables
from repro_torch.exchange import (
    ExchangeSpec,
    ExchangeStats,
    ExchangeTopology,
    Payload,
    PendingExchange,
    make_exchange,
    maybe_inject,
    route_bucketize,
    route_dispatch,
)
from repro_torch.exchange.spec import DISTANCE_CLASSES

__all__ = [
    "MigrateResult",
    "MigrateStart",
    "ShuffleResult",
    "ShuffleStart",
    "make_migrate_step",
    "make_shuffle_step",
    "migrate_stats",
    "shuffle_stats",
]

_SENT = int(KEY_SENTINEL)


class ShuffleResult(NamedTuple):
    keys: torch.Tensor       # int32[W, W*cap]   received keys per worker (sentinel padded)
    values: torch.Tensor     # f32[W, W*cap, D]  received payloads
    valid: torch.Tensor      # bool[W, W*cap]
    part: torch.Tensor       # int32[W, W*cap]   destination partition of each record
    loads: torch.Tensor      # int64[N]          global per-partition record counts
    hist_keys: torch.Tensor  # int32[W, K]       DRW local top-k keys
    hist_counts: torch.Tensor  # int32[W, K]
    overflow: torch.Tensor   # int64[]           records dropped for capacity globally
    lane_overflow: torch.Tensor  # int32[W]      global per-lane capacity drops
    shipped_rows: torch.Tensor   # int64[]       rows the backend moved, all workers
    shipped_rows_by_class: torch.Tensor  # int64[C] shipped by lane distance class
                             # (self / intra-host / inter-host), all workers;
                             # zeros when the spec carries no topology


class ShuffleStart(NamedTuple):
    """Control-plane outputs of the shuffle's start phase: everything a
    decision needs, available before (and without) the row ship."""

    loads: torch.Tensor          # int64[N]
    hist_keys: torch.Tensor      # int32[W, K]
    hist_counts: torch.Tensor    # int32[W, K]
    overflow: torch.Tensor       # int64[]
    lane_overflow: torch.Tensor  # int32[W]
    shipped_rows: torch.Tensor   # int64[]
    shipped_rows_by_class: torch.Tensor  # int64[C]


class MigrateResult(NamedTuple):
    kept_keys: torch.Tensor   # int32[W, S] rows staying put (moved rows -> sentinel)
    kept_vals: torch.Tensor   # f32[W, S, D]
    kept_valid: torch.Tensor  # bool[W, S]
    recv_keys: torch.Tensor   # int32[W, W*cap]
    recv_vals: torch.Tensor   # f32[W, W*cap, D]
    recv_valid: torch.Tensor  # bool[W, W*cap]
    moved: torch.Tensor       # int64[] rows that crossed workers
    total: torch.Tensor       # int64[] live state rows
    overflow: torch.Tensor    # int64[] rows dropped for lane capacity
    lane_overflow: torch.Tensor  # int32[W]
    shipped_rows: torch.Tensor   # int64[]
    shipped_rows_by_class: torch.Tensor  # int64[C], as ShuffleResult's


class MigrateStart(NamedTuple):
    """The migrate start phase: the kept state and every control output;
    the moving rows stay in the pending exchange."""

    kept_keys: torch.Tensor
    kept_vals: torch.Tensor
    kept_valid: torch.Tensor
    moved: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor
    lane_overflow: torch.Tensor
    shipped_rows: torch.Tensor
    shipped_rows_by_class: torch.Tensor


def _recycling(finish_rows):
    """``(start_buffers, finish)`` for a step whose ``finish_rows(pending)``
    ships a pending exchange: the two-set ping-pong pool of send buffers.
    ``start_buffers(like)`` pops a drained set (``None``: allocate fresh)
    unless its payload rows differ from ``like``'s (``[W, n, ...]``) in
    width, dtype or device; ``finish`` returns a drained set to the pool
    (at most two: at most two exchanges are in flight, at depth 2) once the
    rows have moved into new receive tensors."""
    recycled: list = []

    def start_buffers(like):
        bufs = recycled.pop() if recycled else None
        if bufs is not None:
            b = bufs[1][1]
            if (b.shape[3:] != like.shape[2:] or b.dtype != like.dtype
                    or b.device != like.device):
                return None  # payload width changed: the set cannot be reused
        return bufs

    def finish(pending: PendingExchange):
        res, out = finish_rows(pending)
        sent = pending.buffers
        if len(recycled) < 2 and res.valid is not sent.valid:
            recycled.append((sent.valid, sent.payloads))
        return out

    return start_buffers, finish


def _summed_by_class(started, like: torch.Tensor) -> torch.Tensor:
    """The start phase's per-class traffic summed over the workers, int64[C]
    (zeros on a flat spec, whose backend stamps none)."""
    by = started.shipped_rows_by_class
    if by is None:
        return torch.zeros(DISTANCE_CLASSES, dtype=torch.int64, device=like.device)
    return by.sum(dim=0, dtype=torch.int64)


def make_shuffle_step(*, num_workers: int, num_partitions: int, capacity: int,
                      hist_k: int = 64, num_hosts: int, seed: int = 0,
                      backend=None, topology: ExchangeTopology | None = None,
                      group=None):
    """Build the shuffle step for a fixed worker count and lane capacity.

    ``step(tables, keys[W, n], vals[W, n, D], valid[W, n], part_loads=None)
    -> ShuffleResult`` is the fused call; ``step.start(..., part_loads=None)
    -> (pending, ShuffleStart)`` and ``step.finish(pending) -> (keys,
    values, valid, part)`` are its halves (see the module docstring for the
    buffer pool).  ``part_loads`` (float32 ``[num_partitions]``, the
    previous batch's loads) turns the route kernel's split-key replica pick
    into the two-choice least-load pick; ``None`` is the hash pick, as
    equal loads are.  ``topology`` rides the spec: the start phase then
    splits the shipped rows by distance class.  ``group`` binds the spec to
    a process group (``num_workers`` is then its world size and the inputs
    this rank's ``[1, n]``); the start phase's outputs are global."""
    ex = make_exchange(ExchangeSpec(num_lanes=num_workers, capacity=capacity,
                                    axis="data", topology=topology, group=group), backend)

    def _start(tables: PartitionerTables, keys, vals, valid, bufs, part_loads):
        part, buffers = route_bucketize(
            ex, tables, keys, valid, vals, num_hosts=num_hosts, seed=seed,
            num_partitions=num_partitions, buffers=bufs, part_loads=part_loads)
        pending = ex.start_from(buffers)
        started = pending.buffers
        dest = torch.where(valid, part, 0).to(torch.int64)
        hk, hc, _ = local_topk_histogram(keys, valid, hist_k)
        loads = torch.zeros(num_partitions, dtype=torch.int64, device=keys.device)
        loads.index_add_(0, dest.reshape(-1), valid.reshape(-1).to(torch.int64))
        send = started.send
        out = (loads, send.overflow.sum(), send.lane_overflow.sum(dim=0),
               started.shipped_rows.sum(), _summed_by_class(started, keys))
        if group is not None:
            out = group.sum(*out)
            hk, hc = group.gather_rows(hk, hc)
        loads, overflow, lane_overflow, shipped, by_class = out
        return pending, ShuffleStart(loads, hk, hc, overflow, lane_overflow, shipped,
                                     by_class)

    def _finish(pending: PendingExchange):
        res = ex.finish(pending)
        rva, (rk, rv, rp) = res.unpack()
        return res, (rk, rv, rva, rp)

    def step(tables: PartitionerTables, keys, vals, valid, part_loads=None) -> ShuffleResult:
        maybe_inject(ex.backend, "shuffle")  # host boundary: faults fire here
        pending, s = _start(tables, keys, vals, valid, None, part_loads)
        return ShuffleResult(*_finish(pending)[1], *s)

    start_buffers, finish = _recycling(_finish)

    def start(tables: PartitionerTables, keys, vals, valid, part_loads=None):
        maybe_inject(ex.backend, "shuffle")
        return _start(tables, keys, vals, valid, start_buffers(vals), part_loads)

    step.start = start
    step.finish = finish
    step.exchange = ex
    return step


def make_migrate_step(*, num_workers: int, state_capacity: int, num_hosts: int,
                      lane_capacity: int | None = None, seed: int = 0,
                      spec: ExchangeSpec | None = None, backend=None):
    """Operator-state migration for a partitioner swap:
    ``migrate(new_tables, state_keys[W, S], state_vals[W, S, D]) ->
    MigrateResult``, with the halves ``migrate.start(...) -> (pending,
    MigrateStart)`` and ``migrate.finish(pending) -> (keys, vals, valid)``
    attached (the overlapped driver leaves the ship in flight across the
    safe point).

    Each worker re-evaluates the new partitioner on its stored keys (home
    routing: ``num_partitions`` stays 0 so split partials converge) and
    ships rows whose worker changed; rows on lane ``me`` stay put, so that
    lane's count is zeroed before the bucketize.  ``lane_capacity`` bounds
    the per-(src, dst) rows (default: the full state table); ``spec``
    replaces the derived spec whole (a topology or a group rides it there;
    over a group each rank migrates its own ``[1, S]`` table, and the counts
    come back summed over the group)."""
    if spec is None:
        cap = state_capacity if lane_capacity is None else min(lane_capacity, state_capacity)
        spec = ExchangeSpec(num_lanes=num_workers, capacity=cap, axis="data")
    group = spec.group
    ex = make_exchange(spec, backend)

    def _start(new_tables: PartitionerTables, state_keys, state_vals, bufs):
        dev = state_keys.device
        first = 0 if group is None else group.rank  # this process's first worker
        me = torch.arange(first, first + state_keys.shape[0], device=dev,
                          dtype=torch.int32)[:, None]
        valid = state_keys != _SENT
        part, slot, counts = route_dispatch(
            new_tables, state_keys, valid, num_hosts=num_hosts, seed=seed,
            num_lanes=num_workers)
        dest = torch.where(valid, part % num_workers, me)
        moving = valid & (dest != me)
        counts = counts.clone()
        # rows bound for their own worker stay put: no lane to self
        counts.scatter_(1, me.long(), 0)
        pending = ex.start(
            torch.where(moving, dest, me), moving,
            [Payload(torch.where(moving, state_keys, _SENT), _SENT),
             Payload(state_vals, 0)],
            slot=slot, counts=counts, buffers=bufs)
        started = pending.buffers
        send = started.send
        counted = (moving.sum(), valid.sum(), send.overflow.sum(),
                   send.lane_overflow.sum(dim=0), started.shipped_rows.sum(),
                   _summed_by_class(started, state_keys))
        if group is not None:
            counted = group.sum(*counted)
        return pending, MigrateStart(
            torch.where(moving, _SENT, state_keys), state_vals, valid & ~moving, *counted)

    def _finish(pending: PendingExchange):
        res = ex.finish(pending)
        rva, (rk, rv) = res.unpack()
        return res, (rk, rv, rva)

    def migrate(new_tables: PartitionerTables, state_keys, state_vals) -> MigrateResult:
        maybe_inject(ex.backend, "migrate")  # host boundary: faults fire here
        pending, s = _start(new_tables, state_keys, state_vals, None)
        rk, rv, rva = _finish(pending)[1]
        return MigrateResult(s.kept_keys, s.kept_vals, s.kept_valid, rk, rv, rva,
                             *s[3:])

    start_buffers, finish = _recycling(_finish)

    def start(new_tables: PartitionerTables, state_keys, state_vals):
        maybe_inject(ex.backend, "migrate")
        return _start(new_tables, state_keys, state_vals, start_buffers(state_vals))

    migrate.start = start
    migrate.finish = finish
    migrate.exchange = ex
    return migrate


# ---------------------------------------------------------------------------
# Plane-side telemetry constructors (host records for Telemetry).
# ---------------------------------------------------------------------------


def shuffle_stats(res: "ShuffleResult | ShuffleStart", spec: ExchangeSpec,
                  num_workers: int, *, wall_s: float = 0.0,
                  count_wall_s: float | None = None,
                  backend: str | None = None,
                  replica_rows: np.ndarray | None = None) -> ExchangeStats:
    """:class:`ExchangeStats` for one shuffle step: rows per worker (the
    global counters divided by ``num_workers``), ``padded`` the spec's
    per-worker provision.  ``ShuffleResult`` and ``ShuffleStart`` share
    every field read here, so the serial and overlapped drivers build the
    same record.  ``replica_rows`` (the host twin
    :func:`~repro_torch.core.partitioner.split_replica_rows`, while splits
    are installed) rides the record as it is.  Reads through
    :func:`~repro_torch.compat.host_fetch`: the
    overlapped driver hands in host copies of the start phase, so nothing
    here waits for the card; device counters must be read at a safe
    point."""
    shipped = int(host_fetch(res.shipped_rows)) // num_workers
    occupied = max(int(host_fetch(res.loads).sum()) - int(host_fetch(res.overflow)),
                   0) // num_workers
    by_class = None
    if spec.topology is not None and res.shipped_rows_by_class is not None:
        # summed over the workers first, then divided, as the reference's
        # psum-then-divide
        by_class = np.asarray(host_fetch(res.shipped_rows_by_class), np.int64) // num_workers
    return ExchangeStats(
        rows=shipped,
        wall_s=wall_s,
        padded_rows=spec.rows,
        occupied_rows=occupied,
        lane_overflow=host_fetch(res.lane_overflow),
        count_wall_s=count_wall_s,
        backend=backend,
        replica_rows=replica_rows,
        rows_by_class=by_class,
    )


def migrate_stats(*, shipped_rows, buffer_rows: int, moved_rows: int, overflow: int,
                  num_workers: int, lane_overflow=None, wall_s: float = 0.0,
                  shipped_rows_by_class=None) -> ExchangeStats:
    """:class:`ExchangeStats` for one state migration: ``buffer_rows`` is the
    per-worker lane provision, ``moved_rows`` the rows that crossed
    workers (globally summed, like ``shipped_rows``, ``overflow`` and
    ``shipped_rows_by_class``, whose all-zero vector of a flat spec gives
    ``rows_by_class=None``)."""
    by_class = None
    if shipped_rows_by_class is not None:
        by_class = np.asarray(host_fetch(shipped_rows_by_class), np.int64)
        by_class = by_class // num_workers if by_class.any() else None
    return ExchangeStats(
        rows=int(host_fetch(shipped_rows)) // num_workers,
        wall_s=wall_s,
        padded_rows=int(buffer_rows),
        occupied_rows=max(int(moved_rows) - int(overflow), 0) // num_workers,
        lane_overflow=None if lane_overflow is None else np.asarray(lane_overflow),
        rows_by_class=by_class,
    )
