"""System signals: what the control plane actually observes.

The paper's repartitioning decisions are "system-aware": they key on
measured load, not static assumptions.  :class:`Signals` is the one record
the streaming job hands the policy stack at a safe point — per-partition
loads, overflow counts and exchange-lane accounting (rows the backend
*shipped* vs. the rows the spec *provisioned*, and the per-lane overflow
vector).  :class:`Telemetry` is the accumulator the job feeds during normal
work (no extra measurement passes — the DRW principle); a ``snapshot`` at a
safe point turns the window into a ``Signals`` record and opens the next
window.

Only the fields the ported consumers record are ported: the streaming
drivers' (serial and overlapped: the count, ship and hidden walls behind
``overlap_fraction``), and the serving scheduler's replica queue depths,
count-phase wall and per-backend wall EWMA, the rows split hot keys
landed on each partition, the fault seam's per-lane evidence
(``record_fault`` -> ``lane_straggle_s`` / ``lane_retries``, the lane-health
layer's input), and the shipped rows by lane distance class
(``exchange_rows_by_class`` -> ``inter_host_fraction``) when the exchanges
carry a topology.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.compat import host_fetch, safe_point
from repro_torch.core.migration import fold_to_workers
from repro_torch.exchange.spec import ExchangeStats

__all__ = ["Signals", "Telemetry"]


@dataclasses.dataclass(frozen=True)
class Signals:
    """One safe point's view of the system, as the policies consume it.

    ``loads`` is the only required field: per-partition record counts
    observed over the window.  Everything else defaults to "unknown" so
    host-side unit tests can build a minimal record.
    """

    loads: np.ndarray                      # float64[N] per-partition work
    num_workers: int = 1                   # physical workers under the N partitions
    records: float = 0.0                   # records processed this window
    window_wall_s: float = 0.0             # wall time the window spanned
    shuffle_overflow: int = 0              # shuffle rows dropped for capacity
    migration_overflow: int = 0            # migration rows dropped for capacity
    exchange_rows: int = 0                 # rows the backend shipped through lanes
    exchange_padded_rows: int = 0          # rows the specs provisioned (L * capacity)
    exchange_occupied_rows: int | None = None  # rows actually live in the
                                           # buffers; None when the window
                                           # recorded no exchange
    exchange_wall_s: float = 0.0           # wall time inside the exchange path
    exchange_count_wall_s: float = 0.0     # wall blocking on the start phase
                                           # (route + bucketize + count)
    exchange_ship_wall_s: float = 0.0      # wall blocking on the finish phase
                                           # (row ship) — only drains block, so
                                           # an overlapped window shows the
                                           # un-hidden remainder
    exchange_hidden_wall_s: float = 0.0    # host wall that ran while a finish
                                           # was in flight (what the overlap hid)
    backend_wall_ewma: dict | None = None  # backend name -> EWMA of exchange
                                           # wall (long-lived, not windowed)
    lane_overflow: np.ndarray | None = None  # int64[L] capacity drops per lane
    exchange_replica_rows: np.ndarray | None = None  # int64[N] rows landed per
                                           # partition from *split* hot keys
                                           # this window (None: nothing split)
    exchange_rows_by_class: np.ndarray | None = None  # int64[C] shipped rows by
                                           # lane distance class (self /
                                           # intra-host / inter-host); None
                                           # when no exchange carried a
                                           # topology this window
    queue_depths: np.ndarray | None = None # serving replica queue depths
    lane_straggle_s: np.ndarray | None = None  # float64[L] injected/observed
                                           # per-lane straggle seconds this
                                           # window (None: no fault evidence)
    lane_retries: np.ndarray | None = None # int64[L] exchange retries per lane
                                           # this window (transient failures)
    degenerate_walls: int = 0              # NaN/negative wall samples clamped
                                           # to zero this window
    state_rows: int = 0                    # live keyed-state rows (migration scale)
    at_safe_point: bool = True             # decisions may act only when True
    consumer: str = ""                     # which runtime emitted this

    @property
    def imbalance(self) -> float:
        """max/mean per-partition load (1.0 when nothing was observed)."""
        loads = np.asarray(self.loads, np.float64)
        if loads.size == 0 or not loads.sum():
            return 1.0
        return float(loads.max() / max(loads.mean(), 1e-12))

    @property
    def worker_loads(self) -> np.ndarray:
        """Loads folded to worker granularity (partition p on worker p % W)."""
        return fold_to_workers(self.loads, self.num_workers)

    @property
    def worker_imbalance(self) -> float:
        w = self.worker_loads
        if w.size == 0 or not w.sum():
            return 1.0
        return float(w.max() / max(w.mean(), 1e-12))

    @property
    def per_worker_throughput(self) -> float:
        """Records/s each worker sustained, against the capacity target
        (``DRConfig.target_throughput``)."""
        return self.throughput / max(self.num_workers, 1)

    @property
    def overlap_fraction(self) -> float:
        """Share of the exchange's ship wall the split-phase pipeline hid
        behind host work this window: ``hidden / (hidden + ship)``; 0.0 when
        no phase walls were recorded (a serial window)."""
        total = self.exchange_hidden_wall_s + self.exchange_ship_wall_s
        if total <= 0.0:
            return 0.0
        return self.exchange_hidden_wall_s / total

    @property
    def throughput(self) -> float:
        """Records/s over the window; 0.0 when the window is unmeasured."""
        if self.records <= 0 or self.window_wall_s <= 0:
            return 0.0
        return self.records / self.window_wall_s

    @property
    def exchange_padding_fraction(self) -> float:
        """Occupied / provisioned rows over the window, whatever transport
        moved them (0.0 when the window saw no exchange): the
        ``BackendPolicy``'s signal.  Falls back to the shipped rows when no
        occupancy was recorded; an explicit occupancy of zero is a real
        measurement (all lanes empty), not a missing one."""
        if self.exchange_padded_rows <= 0:
            return 0.0
        rows = (self.exchange_rows if self.exchange_occupied_rows is None
                else self.exchange_occupied_rows)
        return rows / self.exchange_padded_rows

    @property
    def inter_host_fraction(self) -> float:
        """Share of the window's shipped rows that crossed a host boundary
        (the slow tier); 0.0 when no exchange carried a topology."""
        by = self.exchange_rows_by_class
        if by is None:
            return 0.0
        total = float(np.sum(by))
        if total <= 0.0:
            return 0.0
        return float(by[-1]) / total

    @property
    def hot_lane(self) -> int:
        """Lane with the most capacity drops this window, or -1 when nothing
        overflowed."""
        if self.lane_overflow is None or not np.any(self.lane_overflow):
            return -1
        return int(np.argmax(self.lane_overflow))


class Telemetry:
    """Windowed accumulator turning runtime counters into ``Signals``.

    The job calls the ``record_*`` hooks during normal work (shuffle,
    migration); ``snapshot`` emits the window's :class:`Signals` at a safe
    point and — when the safe point consumes the window — resets for the
    next one.  Peeking at a non-safe point leaves the window accumulating,
    so a decision gated on checkpoint ticks sees everything since the
    previous tick.
    """

    def __init__(self, consumer: str = ""):
        self.consumer = consumer
        # per-backend exchange wall EWMA: long-lived evidence, not reset
        # with the window
        self.wall_ewma: dict[str, float] = {}
        # lifetime count of degenerate (NaN / negative) wall samples clamped
        # to zero; the per-window count rides Signals.degenerate_walls
        self.degenerate_walls_total = 0
        self._reset()

    def _reset(self) -> None:
        self._records = 0.0
        self._shuffle_overflow = 0
        self._migration_overflow = 0
        self._exchange_rows = 0
        self._exchange_padded_rows = 0
        self._exchange_occupied_rows: int | None = None
        self._exchange_wall_s = 0.0
        self._count_wall_s = 0.0
        self._ship_wall_s = 0.0
        self._hidden_wall_s = 0.0
        self._degenerate_walls = 0
        self._lane_overflow: np.ndarray | None = None
        self._replica_rows: np.ndarray | None = None
        self._rows_by_class: np.ndarray | None = None
        self._queues: np.ndarray | None = None
        self._lane_straggle: np.ndarray | None = None
        self._lane_retries: np.ndarray | None = None
        # exchanges recorded this window whose count fields may still live
        # on device — folded (one host fetch each) at the next snapshot, so
        # recording never blocks between safe points
        self._pending_stats: list[ExchangeStats] = []
        # the window clock starts at the first recording, not at reset:
        # setup/idle time between construction (or a checkpoint) and the
        # next batch must not read as a throughput collapse
        self._t0: float | None = None

    def _touch(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    # -- recording hooks (called during normal work) -----------------------
    def record_batch(self, records: float) -> None:
        self._touch()
        self._records += float(records)

    def record_exchange(self, stats: ExchangeStats) -> None:
        """Fold one exchange's :class:`ExchangeStats` into the window.

        ``stats`` is constructed by the plane
        (``repro_torch.core.shuffle.shuffle_stats`` / ``migrate_stats``), so
        the job never assembles measurement fields itself.  The count fields
        may be device values: recording only queues the record, and the host
        fetch happens at the next :meth:`snapshot` (the safe point).  The
        wall fields are host floats and fold at once: ``count_wall_s`` into
        the window, and ``wall_s`` (when positive) into the per-backend EWMA
        of ``stats.backend``; the phase walls (``count_wall_s``,
        ``ship_wall_s``, ``hidden_wall_s``) into their window sums.  A NaN
        or negative wall is clamped to zero and counted."""
        self._touch()
        wall = self._clean_wall(stats.wall_s)
        self._exchange_wall_s += wall
        if stats.count_wall_s is not None:
            self._count_wall_s += self._clean_wall(stats.count_wall_s)
        if stats.ship_wall_s is not None:
            self._ship_wall_s += self._clean_wall(stats.ship_wall_s)
        if stats.hidden_wall_s is not None:
            self._hidden_wall_s += self._clean_wall(stats.hidden_wall_s)
        if stats.backend is not None and wall > 0.0:
            prev = self.wall_ewma.get(stats.backend)
            self.wall_ewma[stats.backend] = wall if prev is None else 0.7 * prev + 0.3 * wall
        self._pending_stats.append(stats)

    def _clean_wall(self, wall) -> float:
        w = float(wall)
        if not np.isfinite(w) or w < 0.0:
            self._degenerate_walls += 1
            self.degenerate_walls_total += 1
            return 0.0
        return w

    @staticmethod
    def _fold_vector(acc: np.ndarray | None, v) -> np.ndarray:
        """Accumulate a per-lane or per-partition vector over the window; a
        width change mid-window (a resize) folds both onto the wider one."""
        v = np.asarray(host_fetch(v), np.int64)
        if acc is None:
            return v.copy()
        if len(v) == len(acc):
            return acc + v
        out = np.zeros(max(len(v), len(acc)), np.int64)
        out[: len(acc)] += acc
        out[: len(v)] += v
        return out

    def _flush_pending(self) -> None:
        """Fold the queued exchange records' count fields — the one place
        device telemetry becomes host ints, inside a safe-point region."""
        if not self._pending_stats:
            return
        with safe_point():
            for stats in self._pending_stats:
                rows = int(host_fetch(stats.rows))
                self._exchange_rows += rows
                self._exchange_padded_rows += (
                    rows if stats.padded_rows is None
                    else int(host_fetch(stats.padded_rows))
                )
                add = (rows if stats.occupied_rows is None
                       else int(host_fetch(stats.occupied_rows)))
                self._exchange_occupied_rows = (
                    add if self._exchange_occupied_rows is None
                    else self._exchange_occupied_rows + add
                )
                if stats.lane_overflow is not None:
                    self._lane_overflow = self._fold_vector(self._lane_overflow,
                                                            stats.lane_overflow)
                if stats.replica_rows is not None:
                    self._replica_rows = self._fold_vector(self._replica_rows,
                                                           stats.replica_rows)
                if stats.rows_by_class is not None:
                    self._rows_by_class = self._fold_vector(self._rows_by_class,
                                                            stats.rows_by_class)
        self._pending_stats.clear()

    def record_fault(self, lane: int, *, straggle_s: float = 0.0,
                     retries: int = 0) -> None:
        """Fold one lane's fault evidence for this window: injected or
        observed straggle seconds and exchange retry counts.  The driver
        drains its fault seam's report here; both vectors grow to the
        largest lane seen, and the lane-health layer reads them off the
        ``Signals`` snapshot."""
        self._touch()
        lane = int(lane)
        width = lane + 1
        if self._lane_straggle is None or len(self._lane_straggle) < width:
            grown = np.zeros(width, np.float64)
            if self._lane_straggle is not None:
                grown[: len(self._lane_straggle)] = self._lane_straggle
            self._lane_straggle = grown
            grown_r = np.zeros(width, np.int64)
            if self._lane_retries is not None:
                grown_r[: len(self._lane_retries)] = self._lane_retries
            self._lane_retries = grown_r
        self._lane_straggle[lane] += max(float(straggle_s), 0.0)
        self._lane_retries[lane] += max(int(retries), 0)

    def record_overflow(self, shuffle: int = 0, migration: int = 0) -> None:
        self._touch()
        self._shuffle_overflow += int(shuffle)
        self._migration_overflow += int(migration)

    def record_queues(self, depths: np.ndarray) -> None:
        """The serving replicas' queue depths at this point of the window."""
        self._touch()
        self._queues = np.asarray(depths, np.float64)

    # -- safe point --------------------------------------------------------
    def snapshot(
        self,
        loads: np.ndarray,
        *,
        num_workers: int = 1,
        state_rows: int = 0,
        at_safe_point: bool = True,
    ) -> Signals:
        self._flush_pending()
        sig = Signals(
            loads=np.asarray(loads, np.float64),
            num_workers=int(num_workers),
            records=self._records,
            window_wall_s=(max(time.perf_counter() - self._t0, 0.0)
                           if self._t0 is not None else 0.0),
            shuffle_overflow=self._shuffle_overflow,
            migration_overflow=self._migration_overflow,
            exchange_rows=self._exchange_rows,
            exchange_padded_rows=self._exchange_padded_rows,
            exchange_occupied_rows=self._exchange_occupied_rows,
            exchange_wall_s=self._exchange_wall_s,
            exchange_count_wall_s=self._count_wall_s,
            exchange_ship_wall_s=self._ship_wall_s,
            exchange_hidden_wall_s=self._hidden_wall_s,
            backend_wall_ewma=dict(self.wall_ewma) if self.wall_ewma else None,
            lane_overflow=self._lane_overflow,
            exchange_replica_rows=self._replica_rows,
            exchange_rows_by_class=self._rows_by_class,
            queue_depths=self._queues,
            lane_straggle_s=self._lane_straggle,
            lane_retries=self._lane_retries,
            degenerate_walls=self._degenerate_walls,
            state_rows=int(state_rows),
            at_safe_point=at_safe_point,
            consumer=self.consumer,
        )
        if at_safe_point:
            self._reset()
        return sig
