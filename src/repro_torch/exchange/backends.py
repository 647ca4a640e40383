"""Exchange backends: the *how* of a routed exchange, over two transports.

An :class:`ExchangeBackend` implements the plane's verbs — ``bucketize`` /
``a2a_start`` / ``a2a_finish`` / ``all_to_all`` / ``backhaul`` / ``cost`` —
against one
:class:`~repro_torch.exchange.spec.ExchangeSpec`.  The port's first
transport keeps all W workers on one device as ``[W, ...]`` tensors, so the
dense all-to-all is the lane/worker transpose ``[W_src, L, cap] ->
[L, W_src, cap]``: row ``j`` of worker ``i``'s buffer lands at position
``i`` of worker ``j``, exactly the tiled all-to-all of
``repro.exchange.backends.DenseBackend``.  Its second runs one worker a
process: a spec bound to a :class:`~repro_torch.exchange.dist.WorkerGroup`
holds this rank's ``[1, L, cap]`` buffers, and the same verbs ship them
over the process group (``all_to_all_single``), into the layout the
transpose gives.  The backends move rows only through the spec's transport
(:func:`transport_of`: :class:`StackedTransport` or :class:`GroupTransport`,
each with ``permute``, ``two_hop``, ``ragged_ship`` and ``rows_of_me``) and
never ask which one it is.  The collective is split-phase:
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
  sender's fills, as the fallback ships them.  Over a process group the
  ship is native (:func:`~repro_torch.compat.has_ragged_all_to_all`): each
  lane's counted rows are compacted and move through the uneven
  ``all_to_all_single``, and land in receive buffers filled with each
  payload's fill; ``REPRO_DISABLE_NATIVE_RAGGED=1`` ships the masked dense
  buffers instead.  Both give the transpose's receive tensors bit for bit;
  only the native ship moves fewer bytes.
* :class:`LocalBackend` — ``axis=None``: bucketize only, nothing ships.
* :class:`HierarchicalBackend` — the topology-aware two-tier exchange: an
  intra-host permutation, then an inter-host one (:func:`_two_hop_a2a`;
  over a process group two ``all_to_all_single`` calls on the rank's
  intra-host and inter-host subgroups, :meth:`GroupTransport.two_hop`), composing
  to the dense transpose bit for bit; traffic is priced per distance
  class, the intra tier dense and the inter tier by real rows.

Over a process group the rows carry gradients: :class:`GroupTransport`
ships through the :class:`~repro_torch.exchange.dist.WorkerGroup`'s
collectives, whose backward is each collective's transpose (the dense
all-to-all again, the uneven one over the forward's split sizes swapped),
so hop 1 and ``backhaul`` differentiate on every backend, the native
ragged ship included, with no second fetch of its counts.  The stacked
transport's permutations are tensor ops, differentiable as they are.

``backhaul`` is the return trip of a request-response exchange: response
rows ride the request lanes back (the same permutation, which is its own
inverse).  When the spec carries an :class:`~repro_torch.exchange.spec.
ExchangeTopology` the start phase also stamps ``shipped_rows_by_class``
``[W, C]``; worker ``w`` reads its class tables at row ``min(w, L - 1)``
(a bound spec's one worker is its rank).  The tables live on the device
once per ``(L, G, device)`` (:func:`_class_tensors`).  The counts a bound
exchange stamps are this rank's; the shuffle sums them over the group where
the reference sums them with ``psum``.
"""
from __future__ import annotations

import functools
import math
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.compat import has_ragged_all_to_all, host_fetch, to_device
from repro_torch.exchange.spec import (
    ExchangeResult,
    ExchangeSpec,
    ExchangeTopology,
    Payload,
    SendInfo,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import scatter_rows

__all__ = [
    "BACKEND_NAMES",
    "DenseBackend",
    "ExchangeBackend",
    "GroupTransport",
    "HierarchicalBackend",
    "LocalBackend",
    "RaggedBackend",
    "StackedTransport",
    "resolve_backend",
    "transport_of",
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

    def backhaul(self, spec: ExchangeSpec, buffers: torch.Tensor, *, send_counts=None,
                 recv_counts=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]: ...

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
        fills=tuple(p.fill for p in payloads),
    )


def _row_bytes(payloads: tuple) -> int:
    """Bytes one exchanged row carries across all ``[W, L, cap, ...]``
    payload buffers (the trailing dims after ``cap``)."""
    return max(1, sum(math.prod(b.shape[3:]) * b.element_size() for b in payloads))


def _count_phase_rows(spec: ExchangeSpec, payloads: tuple) -> int:
    """The count phase's traffic in row-equivalents: one int32 per lane,
    normalized by the payload row width."""
    return -(-4 * spec.num_lanes // _row_bytes(payloads))


def _transposed(b: torch.Tensor) -> torch.Tensor:
    """``b`` with its first two axes swapped, in a new contiguous tensor
    (never a view of ``b``, even when ``W = 1`` makes the swap free)."""
    return b.transpose(0, 1).clone(memory_format=torch.contiguous_format)


def _two_hop_a2a(x: torch.Tensor, num_hosts: int, lanes_per_host: int) -> torch.Tensor:
    """The hierarchical all-to-all on stacked send buffers ``[W, L, cap,
    ...]`` with ``W = L = num_hosts * lanes_per_host``, lane ``j`` on host
    ``j // lanes_per_host`` at rank ``j % lanes_per_host``.

    Hop 1 moves rows within each host: worker ``(h, s)`` hands its rows for
    rank ``r`` of every host to worker ``(h, r)``.  Hop 2 moves them across
    hosts: worker ``(h, r)`` hands the rows for host ``h'`` to worker
    ``(h', r)``.  Each hop is a copy into a new tensor.  The composition
    lands row ``x[src, dst]`` at ``out[dst, src]``, the flat transpose bit
    for bit, so applying it twice is the identity and the backhaul rides the
    same function."""
    h, g = num_hosts, lanes_per_host
    tail = tuple(x.shape[2:])
    rest = tuple(range(4, 4 + len(tail)))
    v = x.reshape((h, g, h, g) + tail)  # [src host, src rank, dst host, dst rank]
    hop1 = v.permute((0, 3, 2, 1) + rest).contiguous()  # worker (h, r): [h', s]
    hop2 = hop1.permute((2, 1, 0, 3) + rest).contiguous()  # worker (h', r): [h, s]
    return hop2.reshape((h * g, h * g) + tail)


class StackedTransport:
    """All W workers as ``[W, ...]`` tensors on one device: the dense
    all-to-all is the lane/worker transpose, and the ragged ship is the
    reference's masked fallback (bucketize packs each lane from slot 0, so
    the rows past a peer's count already hold the sender's fills)."""

    def check(self, spec: ExchangeSpec, w: int) -> None:
        if w != spec.num_lanes:
            raise ValueError(f"stacked all-to-all needs one lane per worker: "
                             f"{w} workers, {spec.num_lanes} lanes")

    def workers(self, w: int) -> int:
        """The workers an exchange spans when ``w`` of them are held here."""
        return w

    def permute(self, b: torch.Tensor) -> torch.Tensor:
        """Row ``j`` of worker ``i`` -> position ``i`` of worker ``j``, in a
        new tensor."""
        return _transposed(b)

    def two_hop(self, x: torch.Tensor, num_hosts: int, lanes_per_host: int) -> torch.Tensor:
        return _two_hop_a2a(x, num_hosts, lanes_per_host)

    def rows_of_me(self, table: torch.Tensor, w: int) -> torch.Tensor:
        """``table[min(w_i, L - 1)]`` for each of ``w`` workers: worker
        ``i`` reads its own row, and workers past the last lane read the
        last."""
        l = table.shape[0]
        if w <= l:
            return table[:w]
        return torch.cat([table, table[-1:].expand((w - l,) + tuple(table.shape[1:]))])

    def ragged_ship(self, spec: ExchangeSpec, payloads: Sequence[torch.Tensor], fills: tuple,
                    send_counts: torch.Tensor, recv_counts: torch.Tensor) -> tuple:
        return tuple(self.permute(b) for b in payloads)


class GroupTransport:
    """One worker a process over a
    :class:`~repro_torch.exchange.dist.WorkerGroup`: this rank's tensors
    are ``[1, ...]`` and the rows move through ``all_to_all_single`` into
    the layout the stacked transpose gives.  The ragged ship is native
    (:func:`~repro_torch.compat.has_ragged_all_to_all`) unless
    ``REPRO_DISABLE_NATIVE_RAGGED`` forces the masked dense one."""

    def __init__(self, group):
        self.group = group

    def check(self, spec: ExchangeSpec, w: int) -> None:
        if w != 1:
            raise ValueError(f"a process-group exchange holds one worker a rank, got {w}")

    def workers(self, w: int) -> int:
        return self.group.world_size

    def permute(self, b: torch.Tensor) -> torch.Tensor:
        return self.group.all_to_all(b[0])[None]

    def two_hop(self, x: torch.Tensor, num_hosts: int, lanes_per_host: int) -> torch.Tensor:
        """:func:`_two_hop_a2a` for this rank's ``[1, L, cap, ...]`` send
        buffer (rank ``(h, s)`` = ``h * G + s``).

        Hop 1 is an all-to-all on the rank's intra-host subgroup: rank
        ``(h, s)`` sends its rows for place ``r`` of every host to ``(h,
        r)``, which holds them as ``[h', s]``.  Hop 2 is one on its
        inter-host subgroup: ``(h, r)`` sends the rows for host ``h'`` to
        ``(h', r)``, which holds them as ``[h, s]``: the rows of source ``h
        * G + s``, the transpose's layout bit for bit."""
        h, g = num_hosts, lanes_per_host
        intra, inter = self.group.tiers(g)
        tail = tuple(x.shape[2:])
        v = x[0].reshape((h, g) + tail)  # [dst host, dst place]
        hop1 = self.group.all_to_all(v.transpose(0, 1), group=intra)  # [src place, dst host]
        hop2 = self.group.all_to_all(hop1.transpose(0, 1), group=inter)  # [src host, src place]
        return hop2.reshape((1, h * g) + tail)

    def rows_of_me(self, table: torch.Tensor, w: int) -> torch.Tensor:
        """The one worker here is the rank: its row of ``table``."""
        r = min(self.group.rank, table.shape[0] - 1)
        return table[r: r + 1]

    def ragged_ship(self, spec: ExchangeSpec, payloads: Sequence[torch.Tensor], fills: tuple,
                    send_counts: torch.Tensor, recv_counts: torch.Tensor) -> tuple:
        """The native ragged ship of this rank's ``[1, L, cap, ...]``
        buffers: each lane's first ``send_counts[0, l]`` rows (bucketize
        packs a lane from slot 0) go compacted through the uneven
        ``all_to_all_single``, and the ``recv_counts[0, j]`` rows from peer
        ``j`` land at the head of lane ``j`` of a receive buffer filled with
        the payload's fill: what the dense ship carries there, bit for bit.
        The split sizes are host integers, so the counts are fetched first
        (a host sync the audit counts outside a safe point); under autograd
        the backward reuses them, swapped, and fetches nothing."""
        if not has_ragged_all_to_all():
            return tuple(self.permute(b) for b in payloads)
        if len(fills) != len(payloads):
            raise ValueError("a native ragged ship needs each payload's fill "
                             "(ExchangeResult.fills)")
        counts = host_fetch(torch.stack([send_counts[0], recv_counts[0]]).to(torch.int64))
        send, recv = counts[0].tolist(), counts[1].tolist()
        slots = torch.arange(spec.capacity, device=send_counts.device, dtype=torch.int32)
        live_send = slots[None, :] < send_counts[0][:, None]
        live_recv = slots[None, :] < recv_counts[0][:, None]
        out = []
        for b, fill in zip(payloads, fills):
            rows = self.group.all_to_all_uneven(b[0][live_send], send, recv)
            full = torch.full_like(b[0], fill)
            full[live_recv] = rows
            out.append(full[None])
        return tuple(out)


_STACKED = StackedTransport()


def transport_of(spec: ExchangeSpec) -> StackedTransport | GroupTransport:
    """The transport ``spec``'s rows move over: the stacked one, or the
    process group it is bound to.  The backends ship through it and never
    ask which it is."""
    return _STACKED if spec.group is None else GroupTransport(spec.group)


def _per_worker(like: torch.Tensor, value: int) -> torch.Tensor:
    """int64[W] holding ``value`` for each of ``like``'s W workers."""
    return torch.full((like.shape[0],), value, dtype=torch.int64, device=like.device)


@functools.lru_cache(maxsize=64)
def _class_tensors(num_lanes: int, lanes_per_host: int, device: str):
    """``(class_lane_counts int64[L, C], class_onehot int64[L, C, L])`` of
    one topology on ``device``, uploaded once (pinned, without waiting for
    the stream) and kept."""
    topo = ExchangeTopology(num_lanes, lanes_per_host)
    return (to_device(topo.class_lane_counts.astype(np.int64), device),
            to_device(topo.class_onehot.astype(np.int64), device))


def _by_class_dense(spec: ExchangeSpec, like: torch.Tensor) -> torch.Tensor:
    """Dense-priced per-class traffic ``[W, C]``: every lane ships its full
    capacity, so each worker's split is its lanes of each class x capacity."""
    topo = spec.topology
    counts, _ = _class_tensors(topo.num_lanes, topo.lanes_per_host, str(like.device))
    return transport_of(spec).rows_of_me(counts, like.shape[0]) * spec.capacity


def _by_class_counts(spec: ExchangeSpec, counts: torch.Tensor) -> torch.Tensor:
    """Count-priced per-class traffic ``[W, C]``: each worker's per-lane
    occupancy ``counts[W, L]`` summed over each distance class."""
    topo = spec.topology
    _, onehot = _class_tensors(topo.num_lanes, topo.lanes_per_host, str(counts.device))
    me = transport_of(spec).rows_of_me(onehot, counts.shape[0])  # [W, C, L]
    return (me * counts.to(torch.int64)[:, None, :]).sum(dim=2)


def _count_phase_class(spec: ExchangeSpec) -> int:
    """The class the ragged count phase is charged to: it crosses every
    lane, so the slowest tier the topology has."""
    if spec.topology.num_hosts > 1:
        return 2
    return 1 if spec.num_lanes > 1 else 0


def _no_ship(buffers: torch.Tensor):
    """A backhaul over no axis: the buffers stay, nothing ships."""
    zero = torch.zeros(buffers.shape[0], dtype=torch.int64, device=buffers.device)
    return buffers, zero, zero


class DenseBackend:
    """The capacity-padded transport: the stacked lane/worker transpose."""

    name = "dense"

    def bucketize(self, spec, lane, valid, payloads, slot=None, counts=None,
                  buffers=None):
        return _bucketize(spec, lane, valid, payloads, slot=slot, counts=counts,
                          buffers=buffers)

    @staticmethod
    def _stamped(spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """The statically known traffic: the whole pad, per class when the
        spec carries a topology."""
        by = (_by_class_dense(spec, buffers.valid) if spec.topology is not None
              else None)
        return buffers._replace(shipped_rows=_per_worker(buffers.valid, spec.rows),
                                shipped_rows_by_class=by)

    def a2a_start(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """No count phase to run: only stamp the statically known traffic,
        so control-plane reads never wait for the ship."""
        if spec.axis is None:
            return buffers
        return self._stamped(spec, buffers)

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """Row ``j`` of worker ``i`` -> position ``i`` of worker ``j``, into
        new receive tensors."""
        if spec.axis is None:
            return buffers
        t = transport_of(spec)
        t.check(spec, buffers.valid.shape[0])
        return self._stamped(spec, buffers)._replace(
            valid=t.permute(buffers.valid),
            payloads=tuple(t.permute(b) for b in buffers.payloads),
        )

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_finish(spec, self.a2a_start(spec, buffers))

    def backhaul(self, spec: ExchangeSpec, buffers: torch.Tensor, *, send_counts=None,
                 recv_counts=None):
        """The reverse collective for laned response buffers ``[W, L, cap,
        ...]``: ships the whole pad back whatever the counts say, and reports
        the counted occupancy beside it when counts are given.  Returns
        ``(rows, shipped int64[W], occupied int64[W])``."""
        if spec.axis is None:
            return _no_ship(buffers)
        t = transport_of(spec)
        t.check(spec, buffers.shape[0])
        pad = _per_worker(buffers, spec.rows)
        occupied = pad if send_counts is None else send_counts.sum(dim=1, dtype=torch.int64)
        return t.permute(buffers), pad, occupied

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
        by = None
        if spec.topology is not None:
            # the count phase crosses every lane: charge it to the slowest
            # tier present, so the classes still sum to shipped_rows
            by = _by_class_counts(spec, counts)
            by[:, _count_phase_class(spec)] += phase_rows
        return buffers._replace(
            shipped_rows=counts.sum(dim=1, dtype=torch.int64) + phase_rows,
            lane_counts=counts, recv_counts=transport_of(spec).permute(counts),
            shipped_rows_by_class=by)

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """Phase 2: the rows by the dense transpose, valid where the
        started counts say (rows past a count hold the sender's fills).
        Over a process group the counted rows ship natively
        (:meth:`GroupTransport.ragged_ship`) unless
        ``REPRO_DISABLE_NATIVE_RAGGED`` is set."""
        if spec.axis is None:
            return buffers
        t = transport_of(spec)
        t.check(spec, buffers.valid.shape[0])
        recv = buffers.recv_counts
        slots = torch.arange(spec.capacity, device=recv.device, dtype=torch.int32)
        return buffers._replace(
            valid=slots[None, None, :] < recv[:, :, None],
            payloads=t.ragged_ship(spec, buffers.payloads, buffers.fills,
                                   buffers.lane_counts, recv))

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_finish(spec, self.a2a_start(spec, buffers))

    def backhaul(self, spec: ExchangeSpec, buffers: torch.Tensor, *, send_counts=None,
                 recv_counts=None):
        """Response rows ride the request lanes back.  With the forward
        hop's counts the return trip is ragged with no second count phase:
        a worker's response occupancy is what it received (``send_counts``
        = the forward ``recv_counts``) and what comes back is what it sent
        (``recv_counts`` = the forward ``lane_counts``); the rows past a
        lane's count come back as 0, as the reference's masked collective
        gives them.  Without counts the return trip ships dense."""
        if spec.axis is None:
            return _no_ship(buffers)
        t = transport_of(spec)
        t.check(spec, buffers.shape[0])
        if send_counts is None or recv_counts is None:
            pad = _per_worker(buffers, spec.rows)
            return t.permute(buffers), pad, pad
        shipped = send_counts.sum(dim=1, dtype=torch.int64)
        rows, = t.ragged_ship(spec, (buffers,), (0,), send_counts, recv_counts)
        slots = torch.arange(spec.capacity, device=rows.device, dtype=torch.int32)
        live = slots[None, None, :] < recv_counts[:, :, None]
        live = live.reshape(live.shape + (1,) * (rows.ndim - 3))
        rows = torch.where(live, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return rows, shipped, shipped

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float:
        """Real rows: the per-lane average planned mass (empty lanes are
        free), never more than the dense peak."""
        plan_rows = np.asarray(plan_rows, np.float64)
        if plan_rows.size == 0:
            return 0.0
        return float(plan_rows.sum()) / plan_rows.size * slack


class HierarchicalBackend:
    """Two-tier transport: an intra-host hop, then an inter-host hop.

    The composed permutation equals the dense transpose (:func:`_two_hop_a2a`),
    so the received rows and the overflow accounting equal the flat
    backends'; only the measured traffic differs: ``shipped_rows_by_class``
    prices the intra tier dense (its pad, ``cap`` to self and ``(L - 1) x
    cap`` within the host) and the inter tier by the rows each worker sends
    to other hosts, so ``shipped_rows`` exceeds the dense pad by those rows.

    Without a usable topology (none on the spec, one host, lanes not a
    multiple of ``lanes_per_host``, or a stacked worker count other than the
    lane count) the ship falls back to the flat transpose (over a process
    group, the dense all-to-all).  The instance
    counts its ships by kind: ``two_hop_ships`` and ``flat_ships``.
    """

    name = "hierarchical"

    def __init__(self):
        self.two_hop_ships = 0
        self.flat_ships = 0

    def bucketize(self, spec, lane, valid, payloads, slot=None, counts=None,
                  buffers=None):
        return _bucketize(spec, lane, valid, payloads, slot=slot, counts=counts,
                          buffers=buffers)

    def _plan(self, spec: ExchangeSpec, num_workers: int) -> tuple[int, int] | None:
        """``(num_hosts, lanes_per_host)`` when the two-hop ship applies to
        ``num_workers`` stacked workers, else ``None`` (the flat ship)."""
        topo, l = spec.topology, spec.num_lanes
        if topo is None:
            return None
        g = min(topo.lanes_per_host, l)
        if g <= 1 or g >= l or l % g:
            return None
        if transport_of(spec).workers(num_workers) != l:
            return None
        return l // g, g

    def _ship(self, spec: ExchangeSpec, tensors: Sequence[torch.Tensor]) -> tuple:
        """Each of ``tensors`` through one ship (counted once)."""
        t, w = transport_of(spec), tensors[0].shape[0]
        t.check(spec, w)
        plan = self._plan(spec, w)
        if plan is None:
            self.flat_ships += 1
            return tuple(t.permute(x) for x in tensors)
        self.two_hop_ships += 1
        return tuple(t.two_hop(x, *plan) for x in tensors)

    def a2a_start(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """No count phase blocks the control plane: the intra tier ships its
        statically known pad, the inter tier the measured occupancy of the
        lanes on other hosts."""
        if spec.axis is None:
            return buffers
        if spec.topology is None:
            return buffers._replace(
                shipped_rows=_per_worker(buffers.valid, spec.rows))
        counts = buffers.lane_counts
        if counts is None:
            counts = buffers.valid.sum(dim=2, dtype=torch.int32)
        inter = _by_class_counts(spec, counts)[:, 2]
        cap = spec.capacity
        by = torch.stack([torch.full_like(inter, cap),
                          torch.full_like(inter, (spec.num_lanes - 1) * cap), inter], dim=1)
        return buffers._replace(shipped_rows=by.sum(dim=1), shipped_rows_by_class=by)

    def a2a_finish(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        """Move the validity mask and the payloads through the two hops."""
        if spec.axis is None:
            return buffers
        valid, *payloads = self._ship(spec, (buffers.valid, *buffers.payloads))
        return buffers._replace(valid=valid, payloads=tuple(payloads))

    def all_to_all(self, spec: ExchangeSpec, buffers: ExchangeResult) -> ExchangeResult:
        return self.a2a_finish(spec, self.a2a_start(spec, buffers))

    def backhaul(self, spec: ExchangeSpec, buffers: torch.Tensor, *, send_counts=None,
                 recv_counts=None):
        """Responses ride the two hops back (the permutation is its own
        inverse).  The accounting mirrors the forward hop: the pad plus, with
        a topology and counts, the counted rows that cross hosts."""
        if spec.axis is None:
            return _no_ship(buffers)
        pad = _per_worker(buffers, spec.rows)
        if send_counts is not None:
            occupied = send_counts.sum(dim=1, dtype=torch.int64)
            shipped = (pad + _by_class_counts(spec, send_counts)[:, 2]
                       if spec.topology is not None else pad)
        else:
            shipped = occupied = pad
        rows, = self._ship(spec, (buffers,))
        return rows, shipped, occupied

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float:
        """The intra tier pads every lane to the peak (the dense rule); the
        locality discount comes from ``exchange_lane_cost`` weighting the
        plan by distance class first."""
        plan_rows = np.asarray(plan_rows, np.float64)
        if plan_rows.size == 0:
            return 0.0
        return float(plan_rows.max()) * slack


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

    def backhaul(self, spec: ExchangeSpec, buffers: torch.Tensor, *, send_counts=None,
                 recv_counts=None):
        if spec.axis is not None:
            raise ValueError(f"LocalBackend cannot cross worker axis {spec.axis!r}")
        return _no_ship(buffers)

    def cost(self, spec: ExchangeSpec | None, plan_rows: np.ndarray,
             slack: float = 1.25) -> float:
        return 0.0


_BACKENDS = {"dense": DenseBackend, "hierarchical": HierarchicalBackend,
             "local": LocalBackend, "ragged": RaggedBackend}
BACKEND_NAMES = tuple(sorted(_BACKENDS))


def resolve_backend(backend, spec: ExchangeSpec | None = None) -> ExchangeBackend:
    """Turn a backend name (or instance, or ``None``) into an instance;
    ``None`` is local for an ``axis=None`` spec, else dense."""
    if backend is None:
        return LocalBackend() if spec is not None and spec.axis is None else DenseBackend()
    if isinstance(backend, str):
        try:
            return _BACKENDS[backend]()
        except KeyError:
            raise ValueError(
                f"unknown exchange backend {backend!r}; have {sorted(_BACKENDS)}"
            ) from None
    return backend

