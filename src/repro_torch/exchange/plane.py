"""The exchange plane: ``route -> bucketize -> all_to_all -> unpack`` for
stacked workers, or for one worker a process when the spec is bound to a
:class:`~repro_torch.exchange.dist.WorkerGroup`.

An :class:`~repro_torch.exchange.spec.ExchangeSpec` names the static shape
of one exchange, an :class:`~repro_torch.exchange.backends.ExchangeBackend`
moves the buffers, and :class:`Exchange` binds the two for the consumers —
the micro-batch shuffle and the state migration (``repro_torch.core.
shuffle``).  The routing hot path always goes through the route kernels'
wrappers (:mod:`repro_torch.kernels.ops`): the CUDA kernels on the card,
their plain PyTorch versions on the CPU.

The exchange is split-phase, as the reference's: :meth:`Exchange.start`
bucketizes and runs the transport's control phase, so every control-plane
output (the ``send`` accounting, ``shipped_rows``) is final on the
returned :class:`PendingExchange`, and :meth:`Exchange.finish` ships the
rows; ``finish(start(...))`` equals the fused call.  The overlapped
streaming driver holds a pending exchange in flight across a batch
boundary.  ``buffers=`` recycles a drained send-buffer set.
:meth:`Exchange.backhaul` runs the return trip of a request-response
pattern over the same lanes, and ``take_from`` gathers each record's row
back out of lane-major buffers.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.hashing import KEY_SENTINEL
from repro_torch.core.partitioner import PartitionerTables
from repro_torch.exchange.backends import ExchangeBackend, resolve_backend
from repro_torch.exchange.spec import (
    ExchangeResult,
    ExchangeSpec,
    ExchangeStats,
    ExchangeTopology,
    Payload,
    SendInfo,
    take_from,
)
from repro_torch.kernels import ops

__all__ = [
    "Exchange",
    "ExchangeResult",
    "ExchangeSpec",
    "ExchangeStats",
    "ExchangeTopology",
    "Payload",
    "PendingExchange",
    "SendInfo",
    "make_exchange",
    "route_bucketize",
    "route_dispatch",
    "take_from",
]


class PendingExchange(NamedTuple):
    """An exchange whose control phase ran but whose rows have not shipped.

    ``buffers`` is the bucketized :class:`ExchangeResult` with every
    control-plane field stamped by the backend's ``a2a_start``
    (``shipped_rows`` and the ``send`` accounting are final); ``valid`` /
    ``payloads`` still hold the *send*-side buffers until
    :meth:`Exchange.finish` moves them."""

    buffers: ExchangeResult


def route_dispatch(tables: PartitionerTables, keys, valid, *, num_hosts: int,
                   seed: int, num_lanes: int, num_partitions: int = 0,
                   part_loads=None):
    """Fused key -> partition lookup + lane slot assignment (the
    ``lookup_dispatch`` kernel): ``(part[W, n], slot[W, n], counts[W, L])``.

    ``num_partitions > 0`` activates hot-key splitting; the migration path
    leaves it 0 so every key routes to its home.  ``part_loads`` (float32
    ``[num_partitions]``) switches the split-replica pick to the two-choice
    least-load tie-break, in the kernel on the card."""
    return ops.route_slots(keys, valid, tables, num_hosts=num_hosts, seed=seed,
                           num_lanes=num_lanes, num_partitions=num_partitions,
                           part_loads=part_loads)


def route_bucketize(exchange: "Exchange", tables: PartitionerTables, keys, valid, vals,
                    *, num_hosts: int, seed: int, key_fill: int = int(KEY_SENTINEL),
                    num_partitions: int = 0, buffers: tuple | None = None,
                    part_loads=None):
    """Fused route -> bucketize for the shuffle's ``(keys, vals, part)``
    payload triple (the ``route_bucketize`` kernel; ``part_loads`` as in
    :func:`route_dispatch`).

    Returns ``(part[W, n], buffers)`` — the per-record partition ids plus a
    bucketized :class:`ExchangeResult` ready for the collective.
    ``buffers`` is a recycled ``(valid_buf, (keys_buf, vals_buf,
    part_buf))`` set the kernel writes in place (its ``out=``)."""
    spec = exchange.spec
    out = None if buffers is None else (buffers[0], *buffers[1])
    part, slot, counts, buf_valid, bk, bv, bp = ops.route_bucketize(
        keys, valid, tables, vals, num_hosts=num_hosts, seed=seed,
        num_lanes=spec.num_lanes, capacity=spec.capacity, key_fill=key_fill,
        num_partitions=num_partitions, part_loads=part_loads, out=out)
    lane = torch.where(valid, part % spec.num_lanes, 0).to(torch.int32)
    ok = valid & (slot >= 0) & (slot < spec.capacity)
    # lanes are `part % L`, always in range: the capacity drops per lane
    # (and their sum) fall out of the dispatch counts
    lane_overflow = (counts - spec.capacity).clamp(min=0).to(torch.int32)
    overflow = lane_overflow.sum(dim=1)
    buffers = ExchangeResult(
        buf_valid, (bk, bv, bp),
        SendInfo(lane, slot, ok, overflow, lane_overflow),
        shipped_rows=torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device),
        lane_counts=counts.clamp(max=spec.capacity).to(torch.int32),
        fills=(key_fill, 0.0, 0),
    )
    return part, buffers


class Exchange:
    """One :class:`ExchangeSpec` bound to one :class:`ExchangeBackend`."""

    def __init__(self, spec: ExchangeSpec, backend: str | ExchangeBackend | None = None):
        self.spec = spec
        self.backend = resolve_backend(backend, spec)

    def bucketize(self, lane, valid, payloads: Sequence[Payload], slot=None,
                  counts=None, buffers=None) -> ExchangeResult:
        """Build the lane-major ``[W, L, capacity]`` send buffers, into a
        recycled ``(valid_buf, payload_bufs)`` set when ``buffers`` is
        given (values equal to fresh buffers)."""
        return self.backend.bucketize(self.spec, lane, valid, payloads,
                                      slot=slot, counts=counts, buffers=buffers)

    def start(self, lane, valid, payloads: Sequence[Payload], slot=None,
              counts=None, buffers=None) -> PendingExchange:
        """Bucketize and run the transport's control phase; rows stay put."""
        return self.start_from(self.bucketize(lane, valid, payloads, slot=slot,
                                              counts=counts, buffers=buffers))

    def start_from(self, buffers: ExchangeResult) -> PendingExchange:
        """Start the collective from already bucketized buffers (the fused
        route path hands these in directly)."""
        return PendingExchange(self.backend.a2a_start(self.spec, buffers))

    def finish(self, pending: PendingExchange) -> ExchangeResult:
        """Ship the payload rows of a started exchange."""
        return self.backend.a2a_finish(self.spec, pending.buffers)

    def all_to_all(self, buffers: ExchangeResult) -> ExchangeResult:
        return self.backend.all_to_all(self.spec, buffers)

    def backhaul(self, buffers, forward: ExchangeResult | None = None):
        """The return trip for laned response buffers ``[W, L, cap, ...]``.

        ``forward`` is the request hop's exchanged result: its counts make a
        ragged return trip need no second count phase (the response
        occupancy is the forward ``recv_counts``, what comes back the forward
        ``lane_counts``); a dense forward hop's received mask gives the
        occupancy instead.  Returns ``(rows, shipped_rows int64[W],
        occupied_rows int64[W])``."""
        send_counts = forward.recv_counts if forward is not None else None
        recv_counts = forward.lane_counts if forward is not None else None
        if send_counts is None and forward is not None:
            send_counts = forward.valid.sum(dim=-1, dtype=torch.int32)
        return self.backend.backhaul(self.spec, buffers, send_counts=send_counts,
                                     recv_counts=recv_counts)

    def __call__(self, lane, valid, payloads: Sequence[Payload], slot=None,
                 counts=None) -> ExchangeResult:
        return self.all_to_all(self.bucketize(lane, valid, payloads, slot=slot,
                                              counts=counts))


def make_exchange(spec: ExchangeSpec, backend: str | ExchangeBackend | None = None) -> Exchange:
    """Build the exchange primitive for one static spec (``"dense"`` /
    ``"ragged"`` / ``"hierarchical"`` / ``"local"``, an instance, or
    ``None`` to auto-select)."""
    return Exchange(spec, backend)
