"""Exchange vocabulary: the *what* of a routed exchange, backend-free.

``ExchangeSpec`` describes the static shape of one exchange (lanes x
capacity over an optional worker axis); ``Payload``/``SendInfo``/
``ExchangeResult`` describe what travels through it; ``ExchangeStats`` is
the telemetry record the control plane consumes.  The port's workers are
*stacked* on one device, so every tensor here carries a leading worker axis
``W``: send buffers are ``[W, L, capacity, ...]``.

Vocabulary (as in ``repro.exchange.spec``):

* **lane** — one destination of the exchange (a worker, for an all-to-all).
* **slot** — a record's stable rank within its lane, which makes the
  scatter into the ``[L, capacity]`` send buffer collision-free.
* **capacity** — static rows per lane; anything beyond it is *counted* in
  ``SendInfo.overflow`` / ``SendInfo.lane_overflow``, never silently lost.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DISTANCE_CLASSES",
    "ExchangeResult",
    "ExchangeSpec",
    "ExchangeStats",
    "Payload",
    "SendInfo",
]

# distance classes a lane can sit at (self / intra-host / inter-host): the
# per-class accounting vectors keep this width, all zeros on a flat exchange
DISTANCE_CLASSES = 3


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

    The per-distance-class field of the reference record arrives with its
    feature.
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


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Static shape of one exchange: ``num_lanes`` destinations of
    ``capacity`` rows each, crossed over the stacked worker axis when
    ``axis`` is set (``axis=None`` is a *local* exchange: bucketize only).

    ``topology`` (lane locality) is not ported yet and must be ``None``.
    """

    num_lanes: int
    capacity: int
    axis: str | None = None
    topology: object | None = None

    def __post_init__(self):
        if self.topology is not None:
            raise NotImplementedError(
                "ExchangeTopology (hierarchical lanes) is not ported yet "
                "(ROADMAP.md, queue 1 item 4)")

    @property
    def rows(self) -> int:
        """Rows one exchange call provisions per worker (``L * capacity``)."""
        return self.num_lanes * self.capacity


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

    def unpack(self):
        """Flatten lane-major buffers to record-major ``[W, L*capacity, ...]``."""
        w, l, c = self.valid.shape
        flat = tuple(p.reshape((w, l * c) + p.shape[3:]) for p in self.payloads)
        return self.valid.reshape(w, l * c), flat
