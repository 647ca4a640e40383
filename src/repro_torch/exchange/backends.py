"""Exchange backends: the *how* of a routed exchange, for stacked workers.

An :class:`ExchangeBackend` implements the plane's verbs — ``bucketize`` /
``a2a_start`` / ``a2a_finish`` / ``all_to_all`` / ``cost`` — against one
:class:`~repro_torch.exchange.spec.ExchangeSpec`.  The port's first
transport keeps all W workers on one device as ``[W, ...]`` tensors, so the
dense all-to-all is the lane/worker transpose ``[W_src, L, cap] ->
[L, W_src, cap]``: row ``j`` of worker ``i``'s buffer lands at position
``i`` of worker ``j``, exactly the tiled all-to-all of
``repro.exchange.backends.DenseBackend``.  The collective is split-phase:
``a2a_start`` runs the control phase (for the dense transport it only
stamps the statically known traffic), ``a2a_finish`` ships the rows into
new receive tensors, so the send set is free to be recycled, and
``all_to_all == a2a_finish(a2a_start(...))``.

* :class:`DenseBackend` — the capacity-padded all-to-all: every lane ships
  ``capacity`` rows.
* :class:`RaggedBackend` — the count-first two-phase exchange: the start
  phase exchanges each lane's occupancy (``lane_counts`` -> its transpose
  ``recv_counts``) and prices the traffic by real rows; the ship is the
  same transpose, with the receive mask taken from the counts.  On stacked
  workers that is the reference's masked fallback: bucketize packs each
  lane from slot 0, so the rows past a peer's count already hold the
  sender's fills, as the fallback ships them.  A native uneven-split
  collective waits for the ``torch.distributed`` transport.
* :class:`LocalBackend` — ``axis=None``: bucketize only, nothing ships.

The hierarchical and ``torch.distributed`` transports are not ported yet.
"""
from __future__ import annotations

import math
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.exchange.spec import ExchangeResult, ExchangeSpec, Payload, SendInfo
from repro_torch.kernels import ops
from repro_torch.kernels.ref import scatter_rows

__all__ = [
    "DenseBackend",
    "ExchangeBackend",
    "LocalBackend",
    "RaggedBackend",
    "resolve_backend",
]


@runtime_checkable
class ExchangeBackend(Protocol):
    """The verbs every exchange transport implements."""

    name: str

    def bucketize(self, spec: ExchangeSpec, lane, valid, payloads: Sequence[Payload],
                  slot=None, counts=None, buffers=None) -> ExchangeResult: ...

    def a2a_start(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult: ...

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult: ...

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult: ...

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float: ...


def _bucketize(spec: ExchangeSpec, lane, valid, payloads: Sequence[Payload],
               slot=None, counts=None, buffers=None) -> ExchangeResult:
    """Scatter records into ``[W, L, capacity]`` buffers; count overflow.

    ``slot`` and ``counts`` may be precomputed (the route kernels emit
    both); otherwise they come from the ``dispatch_count`` kernel
    (``ops.dispatch_slots``; its plain version on the CPU).  A valid record
    is lost either to a full lane or to a lane outside ``[0, num_lanes)`` —
    both are counted, never silently dropped.

    ``buffers`` is the reuse seam of the overlapped driver: a recycled
    ``(valid_buf, payload_bufs)`` set of this call's shapes and dtypes,
    refilled and written in place (:func:`~repro_torch.kernels.ref.
    scatter_rows`) with the values of fresh buffers.
    """
    lane = torch.where(valid, lane, torch.zeros_like(lane)).to(torch.int32)
    if slot is None:
        slot, counts = ops.dispatch_slots(lane, valid, num_parts=spec.num_lanes)
    w = lane.shape[0]
    in_range = (lane >= 0) & (lane < spec.num_lanes)
    ok = valid & in_range & (slot >= 0) & (slot < spec.capacity)
    overflow = (valid & (~in_range | (slot >= spec.capacity))).sum(dim=1)
    lane_counts = None
    if counts is not None:
        # slots run 0..count-1, so the excess over capacity is what dropped
        # and the buffer occupancy is the clipped count
        lane_overflow = (counts - spec.capacity).clamp(min=0).to(torch.int32)
        lane_counts = counts.clamp(max=spec.capacity).to(torch.int32)
    else:
        lane_overflow = torch.zeros((w, spec.num_lanes), dtype=torch.int32,
                                    device=lane.device)
        dropped = valid & in_range & (slot >= spec.capacity)
        lane_overflow.scatter_add_(1, lane.clamp(0, spec.num_lanes - 1).to(torch.int64),
                                   dropped.to(torch.int32))
    shape = (w, spec.num_lanes, spec.capacity)
    num_cells = w * spec.rows
    worker = torch.arange(w, device=lane.device, dtype=torch.int64)[:, None]
    cell = torch.where(ok, (worker * spec.num_lanes + lane) * spec.capacity + slot,
                       num_cells)
    if buffers is None:
        buffers = (None, (None,) * len(payloads))
    elif len(buffers[1]) != len(payloads):
        raise ValueError(f"bucketize: {len(buffers[1])} recycled payload buffers "
                         f"for {len(payloads)} payloads")
    buf_valid = scatter_rows(cell, num_cells, ok, False, shape, out=buffers[0])
    bufs = tuple(scatter_rows(cell, num_cells, p.data, p.fill, shape, out=b)
                 for p, b in zip(payloads, buffers[1]))
    return ExchangeResult(
        buf_valid, bufs, SendInfo(lane, slot, ok, overflow, lane_overflow),
        shipped_rows=torch.zeros(w, dtype=torch.int64, device=lane.device),
        lane_counts=lane_counts,
    )


def _row_bytes(payloads: tuple) -> int:
    """Bytes one exchanged row carries across all ``[W, L, cap, ...]``
    payload buffers (the trailing dims after ``cap``)."""
    return max(1, sum(math.prod(b.shape[3:]) * b.element_size() for b in payloads))


def _count_phase_rows(spec: ExchangeSpec, payloads: tuple) -> int:
    """The count phase's traffic in row-equivalents: one int32 per lane,
    normalized by the payload row width."""
    return -(-4 * spec.num_lanes // _row_bytes(payloads))


def _check_stacked(spec: ExchangeSpec, buffers: ExchangeResult) -> None:
    w = buffers.valid.shape[0]
    if w != spec.num_lanes:
        raise ValueError(f"stacked all-to-all needs one lane per worker: "
                         f"{w} workers, {spec.num_lanes} lanes")


def _transposed(b: torch.Tensor) -> torch.Tensor:
    """``b`` with its first two axes swapped, in a new contiguous tensor
    (never a view of ``b``, even when ``W = 1`` makes the swap free)."""
    return b.transpose(0, 1).clone(memory_format=torch.contiguous_format)


class DenseBackend:
    """The capacity-padded transport: the stacked lane/worker transpose."""

    name = "dense"

    def bucketize(self, spec, lane, valid, payloads, slot=None, counts=None,
                  buffers=None):
        return _bucketize(spec, lane, valid, payloads, slot=slot, counts=counts,
                          buffers=buffers)

    @staticmethod
    def _shipped(spec: ExchangeSpec, buffers: ExchangeResult) -> torch.Tensor:
        w = buffers.valid.shape[0]
        return torch.full((w,), spec.rows, dtype=torch.int64, device=buffers.valid.device)

    def a2a_start(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """No count phase to run: only stamp the statically known traffic
        (the whole pad), so control-plane reads never wait for the ship."""
        if spec.axis is None:
            return buffers
        return buffers._replace(shipped_rows=self._shipped(spec, buffers))

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """Row ``j`` of worker ``i`` -> position ``i`` of worker ``j``, into
        new receive tensors."""
        if spec.axis is None:
            return buffers
        _check_stacked(spec, buffers)
        return buffers._replace(
            valid=_transposed(buffers.valid),
            payloads=tuple(_transposed(b) for b in buffers.payloads),
            shipped_rows=self._shipped(spec, buffers),
        )

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_finish(spec, self.a2a_start(spec, buffers))

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float:
        """Every lane provisions (and ships) the peak planned lane mass."""
        plan_rows = np.asarray(plan_rows, np.float64)
        if plan_rows.size == 0:
            return 0.0
        return float(plan_rows.max()) * slack


class RaggedBackend:
    """Count-first two-phase transport: exchange the lane counts, then ship
    the rows they cover (``shipped_rows`` counts those rows and the count
    phase, not the pad)."""

    name = "ragged"

    def bucketize(self, spec, lane, valid, payloads, slot=None, counts=None,
                  buffers=None):
        return _bucketize(spec, lane, valid, payloads, slot=slot, counts=counts,
                          buffers=buffers)

    def a2a_start(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """Phase 1: every receiver learns how many rows each peer sends
        (``recv_counts[w, j] = lane_counts[j, w]``); ``shipped_rows``,
        ``lane_counts`` and ``recv_counts`` are final here."""
        if spec.axis is None:
            return buffers
        counts = buffers.lane_counts
        if counts is None:  # bucketize had no dispatch counts to reuse
            counts = buffers.valid.sum(dim=2, dtype=torch.int32)
        phase_rows = _count_phase_rows(spec, buffers.payloads)
        return buffers._replace(
            shipped_rows=counts.sum(dim=1, dtype=torch.int64) + phase_rows,
            lane_counts=counts, recv_counts=_transposed(counts))

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """Phase 2: the rows by the dense transpose, valid where the
        started counts say (rows past a count hold the sender's fills)."""
        if spec.axis is None:
            return buffers
        _check_stacked(spec, buffers)
        recv = buffers.recv_counts
        slots = torch.arange(spec.capacity, device=recv.device, dtype=torch.int32)
        return buffers._replace(
            valid=slots[None, None, :] < recv[:, :, None],
            payloads=tuple(_transposed(b) for b in buffers.payloads))

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_finish(spec, self.a2a_start(spec, buffers))

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float:
        """Real rows: the per-lane average planned mass (empty lanes are
        free), never more than the dense peak."""
        plan_rows = np.asarray(plan_rows, np.float64)
        if plan_rows.size == 0:
            return 0.0
        return float(plan_rows.sum()) / plan_rows.size * slack


class LocalBackend:
    """``axis=None`` fast path: bucketize only, no collective, nothing ships."""

    name = "local"

    def bucketize(self, spec, lane, valid, payloads, slot=None, counts=None,
                  buffers=None):
        return _bucketize(spec, lane, valid, payloads, slot=slot, counts=counts,
                          buffers=buffers)

    def a2a_start(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        if spec.axis is not None:
            raise ValueError(f"LocalBackend cannot cross worker axis {spec.axis!r}; "
                             "use the dense or ragged backend")
        return buffers

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_start(spec, buffers)

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_finish(spec, self.a2a_start(spec, buffers))

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float:
        return 0.0


_BACKENDS = {"dense": DenseBackend, "local": LocalBackend, "ragged": RaggedBackend}
_NOT_PORTED = ("hierarchical",)


def resolve_backend(backend, spec: ExchangeSpec | None = None) -> ExchangeBackend:
    """Turn a backend name (or instance, or ``None``) into an instance;
    ``None`` is local for an ``axis=None`` spec, else dense."""
    if backend is None:
        return LocalBackend() if spec is not None and spec.axis is None else DenseBackend()
    if isinstance(backend, str):
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"the {backend} exchange backend is not ported yet "
                "(ROADMAP.md, queue 1 item 4)")
        try:
            return _BACKENDS[backend]()
        except KeyError:
            raise ValueError(
                f"unknown exchange backend {backend!r}; have {sorted(_BACKENDS)}"
            ) from None
    return backend

