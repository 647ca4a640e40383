"""Exchange vocabulary: the *what* of a routed exchange, backend-free.

``ExchangeSpec`` describes the static shape of one exchange (lanes x
capacity over an optional worker axis, and the lanes' locality,
``ExchangeTopology``); ``Payload``/``SendInfo``/``ExchangeResult`` describe
what travels through it; ``ExchangeStats`` is the telemetry record the
control plane consumes.  Every tensor here carries a leading worker axis
``W``: send buffers are ``[W, L, capacity, ...]``.  The port's first
transport *stacks* all W workers on one device; a spec bound to a
:class:`~repro_torch.exchange.dist.WorkerGroup` (``group=``) crosses
processes instead, one worker a process, and each process's tensors carry
a worker axis of 1.

Vocabulary (as in ``repro.exchange.spec``):

* **lane** — one destination of the exchange (a worker, for an all-to-all).
* **slot** — a record's stable rank within its lane, which makes the
  scatter into the ``[L, capacity]`` send buffer collision-free.
* **capacity** — static rows per lane; anything beyond it is *counted* in
  ``SendInfo.overflow`` / ``SendInfo.lane_overflow``, never silently lost.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DISTANCE_CLASSES",
    "ExchangeResult",
    "ExchangeSpec",
    "ExchangeStats",
    "ExchangeTopology",
    "Payload",
    "SendInfo",
    "take_from",
]

# distance classes a lane can sit at, relative to the sending worker:
# 0 = the worker itself (nothing crosses a link), 1 = another lane on the
# same host (fast interconnect), 2 = a lane on another host (slow tier)
DISTANCE_CLASSES = 3


@functools.lru_cache(maxsize=64)
def _class_tables(num_lanes: int, lanes_per_host: int):
    """Numpy lookups for one (L, G) topology, computed once and cached,
    read-only: ``(class_matrix int8[L, L], class_lane_counts int32[L, C],
    class_onehot int32[L, C, L])`` — the distance class of lane ``j`` seen
    from worker ``i`` (0 self, 1 same host ``i // G == j // G``, 2 other
    host), how many lanes of each class worker ``i`` sees, and per-worker
    one-hot class masks (a per-class reduction of a lane vector is one
    product)."""
    lanes = np.arange(num_lanes)
    host = lanes // lanes_per_host
    cm = np.where(host[:, None] == host[None, :], 1, 2).astype(np.int8)
    np.fill_diagonal(cm, 0)
    onehot = np.stack(
        [(cm == c).astype(np.int32) for c in range(DISTANCE_CLASSES)], axis=1)
    counts = onehot.sum(axis=2).astype(np.int32)
    for a in (cm, onehot, counts):
        a.setflags(write=False)
    return cm, counts, onehot


@dataclasses.dataclass(frozen=True)
class ExchangeTopology:
    """Lane -> distance-class map for one exchange: which lanes share the
    sender's host and what each distance class costs.

    Lanes are host-major (lane ``j`` lives on host ``j // lanes_per_host``).
    ``class_weights`` price one row crossing each class (self, intra-host,
    inter-host) in :func:`repro_torch.core.migration.exchange_lane_cost`;
    the default makes an inter-host row 10x an intra-host one and a
    same-worker row free.  Hashable; the class tables are cached numpy
    constants (:func:`_class_tables`), one set per (L, G).
    """

    num_lanes: int
    lanes_per_host: int
    class_weights: tuple[float, ...] = (0.0, 1.0, 10.0)

    def __post_init__(self):
        object.__setattr__(
            self, "class_weights", tuple(float(w) for w in self.class_weights))
        if self.num_lanes < 1 or self.lanes_per_host < 1:
            raise ValueError(f"a topology needs lanes and hosts: {self}")
        if len(self.class_weights) != DISTANCE_CLASSES:
            raise ValueError(f"{DISTANCE_CLASSES} class weights expected, got "
                             f"{self.class_weights}")

    @property
    def num_hosts(self) -> int:
        return -(-self.num_lanes // self.lanes_per_host)

    @property
    def class_matrix(self) -> np.ndarray:
        """int8[L, L] — distance class of lane ``j`` seen from worker ``i``."""
        return _class_tables(self.num_lanes, self.lanes_per_host)[0]

    @property
    def class_lane_counts(self) -> np.ndarray:
        """int32[L, C] — lanes of each class seen from worker ``i``."""
        return _class_tables(self.num_lanes, self.lanes_per_host)[1]

    @property
    def class_onehot(self) -> np.ndarray:
        """int32[L, C, L] — per-worker one-hot class masks."""
        return _class_tables(self.num_lanes, self.lanes_per_host)[2]

    def weight_matrix(self, num_lanes: int | None = None) -> np.ndarray:
        """float64[n, n] per-(src, dst) row weights: ``class_weights``
        through the class matrix; ``num_lanes`` re-derives for another lane
        count (a worker-folded transfer), keeping ``lanes_per_host``."""
        topo = self if num_lanes is None else self.resized(num_lanes)
        return np.asarray(topo.class_weights, np.float64)[topo.class_matrix]

    def resized(self, num_lanes: int) -> "ExchangeTopology":
        """The topology at another lane count: hosts keep their width, so 8
        lanes at 4 a host shrunk to 7 are two hosts of 4 and 3."""
        return dataclasses.replace(self, num_lanes=int(num_lanes))


@dataclasses.dataclass(frozen=True)
class ExchangeStats:
    """Everything the control plane learns from one exchange, in one record
    (the fields of ``repro.exchange.spec.ExchangeStats`` this slice sets).

    * ``rows`` — rows the active transport measured moving (shipped).
    * ``padded_rows`` — rows the exchange provisioned; ``None`` = ``rows``.
    * ``occupied_rows`` — rows live in the shipped lanes; ``None`` = ``rows``.
    * ``lane_overflow`` — per-lane capacity drops or ``None``.
    * ``wall_s`` — host wall time of the exchange path.
    * ``count_wall_s`` / ``ship_wall_s`` / ``hidden_wall_s`` — the
      split-phase wall breakdown: blocking on the start (count) phase,
      blocking on the row ship at a drain, and host wall that ran while a
      ship was in flight (the latency the overlap hid); ``None`` when not
      measured (the serving scheduler books a count wall of 0.0 under
      overlap).
    * ``backend`` — transport name the measurements belong to.
    * ``replica_rows`` — rows landed per partition from *split* hot keys, or
      ``None`` when no key is split.
    * ``rows_by_class`` — ``rows`` split by lane distance class (self /
      intra-host / inter-host), or ``None`` when the exchange carried no
      topology.
    """

    rows: int
    wall_s: float = 0.0
    padded_rows: int | None = None
    occupied_rows: int | None = None
    lane_overflow: np.ndarray | None = None
    count_wall_s: float | None = None
    ship_wall_s: float | None = None
    hidden_wall_s: float | None = None
    backend: str | None = None
    replica_rows: np.ndarray | None = None
    rows_by_class: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Static shape of one exchange: ``num_lanes`` destinations of
    ``capacity`` rows each, crossed over the stacked worker axis when
    ``axis`` is set (``axis=None`` is a *local* exchange: bucketize only).

    ``topology`` localizes the lanes (:class:`ExchangeTopology`); a
    topology of another lane count is snapped to ``num_lanes``.  ``None`` is
    the flat exchange: no per-class accounting.

    ``group`` (a :class:`~repro_torch.exchange.dist.WorkerGroup`) binds the
    exchange to a process group: each process holds one worker (tensors
    ``[1, ...]``) and the backends ship over the group.  A lane is a rank,
    so a bound spec that crosses ``axis`` needs ``num_lanes`` equal to the
    world size (``ValueError`` otherwise), as the reference's ragged shim
    needs lanes that coincide with the axis's shards.
    """

    num_lanes: int
    capacity: int
    axis: str | None = None
    topology: ExchangeTopology | None = None
    group: object = None

    def __post_init__(self):
        if self.topology is not None and self.topology.num_lanes != self.num_lanes:
            object.__setattr__(self, "topology", self.topology.resized(self.num_lanes))
        if (self.group is not None and self.axis is not None
                and self.num_lanes != self.group.world_size):
            raise ValueError(f"a spec bound to {self.group.world_size} ranks needs one lane "
                             f"a rank, got {self.num_lanes} lanes")

    @property
    def rows(self) -> int:
        """Rows one exchange call provisions per worker (``L * capacity``)."""
        return self.num_lanes * self.capacity

    def resized(self, *, num_lanes: int | None = None,
                capacity: int | None = None) -> "ExchangeSpec":
        """The spec at another lane count or capacity; a topology follows
        the lane count, keeping ``lanes_per_host``."""
        return dataclasses.replace(
            self,
            num_lanes=self.num_lanes if num_lanes is None else int(num_lanes),
            capacity=self.capacity if capacity is None else int(capacity))


class Payload(NamedTuple):
    """One tensor travelling through the exchange (``[W, n, ...]``, one row
    per record); ``fill`` pads empty slots."""

    data: torch.Tensor
    fill: int | float = 0


class SendInfo(NamedTuple):
    """Send-side bookkeeping, stacked ``[W, ...]`` per worker."""

    lane: torch.Tensor           # int32[W, n] destination lane per record
    slot: torch.Tensor           # int32[W, n] rank within lane, -1 for invalid
    ok: torch.Tensor             # bool[W, n]  accepted into the send buffer
    overflow: torch.Tensor       # int[W]      records dropped (all causes)
    lane_overflow: torch.Tensor = None  # int[W, L] capacity drops per lane


class ExchangeResult(NamedTuple):
    valid: torch.Tensor      # bool[W, L, capacity] occupancy of the buffers
    payloads: tuple          # each [W, L, capacity, ...], order of the inputs
    send: SendInfo
    # rows the transport moved per worker: the dense backend ships the
    # whole padded buffer (L * capacity), the ragged backend its measured
    # occupancy plus the count phase, a local exchange nothing
    shipped_rows: torch.Tensor = None  # int[W]
    # the count bookkeeping: ``lane_counts[w, l]`` is the rows worker w
    # sent on lane l (min(count, capacity)), ``recv_counts[w, j]`` the rows
    # worker w received from peer j (the ragged transport's count phase)
    lane_counts: torch.Tensor = None   # int32[W, L]
    recv_counts: torch.Tensor = None   # int32[W, L]
    # ``shipped_rows`` split by lane distance class (self / intra-host /
    # inter-host), stamped by the backend's start phase when the spec
    # carries a topology; None on a flat spec
    shipped_rows_by_class: torch.Tensor = None  # int[W, C]
    # each payload's pad value (the ``Payload.fill`` its buffer was built
    # with), so the process-group ragged ship can fill its receive buffers
    # with what the dense ship would have carried there
    fills: tuple = ()

    def unpack(self):
        """Flatten lane-major buffers to record-major ``[W, L*capacity, ...]``."""
        w, l, c = self.valid.shape
        flat = tuple(p.reshape((w, l * c) + p.shape[3:]) for p in self.payloads)
        return self.valid.reshape(w, l * c), flat

    def stats(self, spec: ExchangeSpec | None = None, *, wall_s: float = 0.0,
              count_wall_s: float | None = None, ship_wall_s: float | None = None,
              hidden_wall_s: float | None = None, backend: str | None = None,
              replica_rows: np.ndarray | None = None) -> ExchangeStats:
        """The per-worker telemetry record of this stacked exchange: each
        count is summed over the W workers and floor-divided by W, as the
        reference's psum-then-divide gives it (``lane_overflow`` stays the
        global per-lane sum, as the shuffle's).  The caller supplies what
        the plane cannot know: walls, the backend name, the split host
        twin's rows.  Fetches the counts to the host."""
        w = self.valid.shape[0]

        def per_worker(x) -> int:
            return int(x.sum()) // w

        rows = 0 if self.shipped_rows is None else per_worker(self.shipped_rows)
        occupied = per_worker(self.valid if self.lane_counts is None else self.lane_counts)
        by_class = None
        if self.shipped_rows_by_class is not None:
            by_class = (self.shipped_rows_by_class.sum(dim=0).cpu().numpy()
                        .astype(np.int64) // w)
        lane_ov = self.send.lane_overflow
        if lane_ov is not None:
            lane_ov = lane_ov.sum(dim=0).cpu().numpy()
        return ExchangeStats(
            rows=rows,
            wall_s=wall_s,
            padded_rows=spec.rows if spec is not None else self.valid[0].numel(),
            occupied_rows=occupied,
            lane_overflow=lane_ov,
            count_wall_s=count_wall_s,
            ship_wall_s=ship_wall_s,
            hidden_wall_s=hidden_wall_s,
            backend=backend,
            replica_rows=replica_rows,
            rows_by_class=by_class,
        )


def take_from(buffers: torch.Tensor, send: SendInfo) -> torch.Tensor:
    """Each record's row of ``[W, L, capacity, ...]`` buffers, ``[W, n,
    ...]``, zero for a record that never took a slot (the reverse of
    bucketize)."""
    w = buffers.shape[0]
    worker = torch.arange(w, device=buffers.device)[:, None]
    # a record without a slot reads cell (0, 0), masked off below
    lane = torch.where(send.ok, send.lane, 0).long()
    slot = torch.where(send.ok, send.slot, 0).long()
    rows = buffers[worker, lane, slot]
    mask = send.ok.reshape(send.ok.shape + (1,) * (rows.ndim - 2))
    return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
