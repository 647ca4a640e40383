"""Micro-batch streaming runtime with on-the-fly Dynamic Repartitioning.

The job graph is the paper's canonical stateful pipeline::

    source -> map -> [shuffle by key] -> stateful reduce (keyed state)

Per micro-batch the runtime runs the shuffle step (which also emits the
DRW histograms and global loads), folds the received records into the keyed
state, then gives the DR master a safe point: telemetry snapshots into a
``Signals`` record, ``DRMaster.evaluate`` runs the policy stack, and the
driver executes the taken action before the next batch: a ``Repartition``
migrates the keyed state through the same exchange; a ``Resize`` re-plans
the partitioner across sizes (``DRMaster.replan_resize``), migrates through
lanes the cross-size plan sizes and rebuilds the shuffle step; a ``Split``
needs nothing (the DR master stamped the replica table and the next
batch's route fans the key out); an ``Unsplit`` runs a home-routed
migration off the still-split partitioner whose merge sums the partials;
a ``SwitchBackend`` (the ``BackendPolicy``, ``DRConfig(auto_backend=
True)``) drops the steps, which the next batch rebuilds on the new
transport, and moves nothing; a ``Quarantine`` or ``Evict`` (the
``HealthPolicy``, ``DRConfig(health_enabled=True)``) removes one worker row
and folds its state onto the survivors, and a ``Recover`` re-admits the
oldest quarantined lane and spreads the state back.

A port of ``repro.core.streaming.StreamingJob``'s three drivers.  The W
workers are stacked on one device (``num_workers``, default 1 — what the
reference's default mesh gives on one device), or run one a process over a
``torch.distributed`` process group (``group=``, below).

* **Serial** (``DRConfig(overlap_exchange=False)``, or
  ``REPRO_DISABLE_OVERLAP=1``): the fused shuffle step, the merge, then the
  decision section.
* **Overlapped, depth 1** (the default): the shuffle is split-phase
  (:mod:`repro_torch.core.shuffle`) and every control-plane input comes out
  of the start phase.  The driver enqueues batch N's start, copies its
  control outputs into pinned host memory without blocking
  (``compat.copy_to_host``), enqueues batch N-1's row ship and state merge
  behind them, and waits only on the copies' event: the card executes its
  stream in order, so the wait covers the start phase and not the ship,
  and the host's decision section runs while the card merges.  State
  materializes only at drains: before any taken action, at ``snapshot``,
  ``state_count`` and direct reads of ``state_keys`` / ``state_vals``.  A
  repartition's own ship and merge likewise stay in flight across the safe
  point.  ``state_rows`` is the count as of the last drain (reading it live
  would wait for the merge), as in the reference.
* **Depth 2** (``DRConfig(pipeline_depth=2)``, overlap active): ``run``
  gives the driver one batch of lookahead, and right after batch N's count
  sync the driver uploads batch N+1 and enqueues its start behind the
  in-flight ship, so two stages live on the stream.  The staged start
  routes with today's partitioner; a taken action drains both stages and
  discards it, and the batch is routed afresh under the new partitioner.

The trajectories (actions, state, overflow, shipped rows) of the three
drivers are equal by construction; walls and the phase-wall telemetry
(``overlap_fraction``) differ.  Batches reach the card through two pinned
staging sets, one per pipeline stage, with ``non_blocking=True`` (a
pageable upload would wait for the stream), and the partitioner's tables
are uploaded once per partitioner.  Everything runs on one stream, so the
recycled send buffers and the state need no cross-stream events.

**Elastic resize** is requested by ``resize(n)`` or, with
``DRConfig(elastic=True)``, by the resize policy, and fires only at a
checkpoint safe point.  While a split is installed, and for an unsplit,
migration lanes get the whole state table: the split's partial aggregates
live off their key's home, where the home-diff plan cannot see them, and
lanes sized by that plan would drop them.  A snapshot restores onto
another worker count by re-folding its rows on the host (``_adopt_state``).

**The least-load replica pick** (``DRConfig(split_least_load=True)``):
after each batch's loads reach the host, the driver uploads them as
float32 (without a wait), and the next route's kernel sends a split key's
record to the less loaded of its two hashed replicas.  All three drivers
route batch N+1 on batch N's loads; a resize or a restore drops the
vector.

**Failure domains.**  A :class:`~repro_torch.exchange.FaultyBackend`
given as ``exchange_backend`` fires its plan at the steps' host entry
points; the driver drains the seam's per-lane report into telemetry each
batch (re-mapped from original lane ids to current rows), where the
``HealthPolicy`` reads it.  A lane is a row of the ``[W, ...]`` stack, so
a quarantined lane is parked as its label; removing or re-admitting one
rebuilds the steps for the new worker count and re-folds the state on the
host (``_adopt_state``).  With ``DRConfig(snapshot_interval=k)``,
``process_batch`` is also the zero-loss recovery loop: it takes an
auto-snapshot (lazily first, then every ``k`` batches and after each lane
change), keeps the batches since in a replay buffer, and on a
:class:`~repro_torch.exchange.WorkerLostError` drains the survivors,
evicts the lost lane (a single worker restarts in place), restores the
snapshot, replays the buffer and retries the batch.  No row is lost.

**The lane topology.**  ``StreamingJob(topology=...)`` puts an
:class:`~repro_torch.exchange.ExchangeTopology` on every spec the job
builds (the shuffle's, each migration's, and after a lane change the
snapped one of the new worker count); ``BatchMetrics.shipped_rows_by_class``
splits the batch's shipped rows by distance class, and the DR master
prices plans by locality.  A snapshot carries the topology; restoring a
flat one keeps the topology the job was built with.

**One worker a process.**  ``StreamingJob(group=WorkerGroup)`` runs this
process's worker of ``num_workers`` = the group's world size, as the
reference runs one on each device of its mesh: every spec the job builds
is bound to the group (:mod:`repro_torch.exchange.dist`), its state is
``[1, S]``, and every rank is given the same global batch, of which it
uploads its contiguous chunk, the one ``shard_map`` gives it.  The shuffle
and migrate steps sum the global figures over the group, and reads that
need the whole state (``state_keys``, ``state_vals``, ``state_count``,
``snapshot`` and the migration planner's keys) gather it and return the
stacked layout.  Each rank decides for itself, so the decisions must
agree: every wall that reaches the policies is the max over the group
(one ``all_reduce`` at each safe point), and a digest of each decision
and of the partitioner after it is compared across the ranks, which
raises on a mismatch.  All three drivers run.  A ``FaultPlan``
(:class:`~repro_torch.exchange.FaultyBackend`) and the health actions that
change the set of workers (Quarantine, Evict, Recover) raise
``NotImplementedError``: losing a process needs a rebuilt group (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.compat import (
    copy_to_host,
    host_fetch,
    host_wait,
    overlap_enabled,
    resolve_device,
    safe_point,
    to_device,
)
from repro_torch.control import (
    Evict,
    NoOp,
    Quarantine,
    Recover,
    Repartition,
    Resize,
    SwitchBackend,
    Telemetry,
    Unsplit,
)
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.hashing import DEFAULT_NUM_HOSTS, KEY_SENTINEL
from repro_torch.core.migration import migration_capacity, plan_migration
from repro_torch.core.partitioner import (
    Partitioner,
    heavy_capacity_for,
    split_replica_rows,
    uniform_partitioner,
)
from repro_torch.core.shuffle import (
    make_migrate_step,
    make_shuffle_step,
    migrate_stats,
    shuffle_stats,
)
from repro_torch.core.state import empty_state, merge_into, state_size
from repro_torch.exchange import (
    ExchangeSpec,
    ExchangeStats,
    FaultyBackend,
    WorkerLostError,
    resolve_backend,
)
from repro_torch.exchange.backends import BACKEND_NAMES
from repro_torch.exchange.spec import DISTANCE_CLASSES

__all__ = ["BatchMetrics", "RecoveryStats", "StreamingJob"]

_SENT = int(KEY_SENTINEL)


@dataclasses.dataclass
class BatchMetrics:
    """One batch's trajectory record (the fields of the reference's)."""

    batch: int
    imbalance: float            # measured per-partition record imbalance
    worker_imbalance: float     # per-worker (straggler view)
    repartitioned: bool
    relative_migration: float
    overflow: int               # shuffle + migration rows dropped for capacity
    state_rows: int             # overlapped: as of the last drain
    wall_time_s: float
    reason: str
    migration_rows: int = 0     # rows of all-to-all buffer a repartition exchanged
    resized: bool = False       # an elastic resize fired at this safe point
    num_partitions: int = 0     # topology after this batch (post-resize)
    migration_plan_rows: int = 0  # migration_capacity() of the plan (pre-pow2)
    action: str = "noop"        # control-plane action kind this safe point took
    shipped_rows: int = 0       # rows the backend moved this batch (per worker)
    padded_rows: int = 0        # rows the specs provisioned (per worker)
    backend: str = "dense"      # exchange backend the batch ran on
    exchange_wall_s: float = 0.0  # wall blocking on the shuffle exchange path
                                  # (overlapped: the count phase only)
    overlapped: bool = False    # the batch ran the split-phase pipeline
    pipelined: bool = False     # the batch consumed a depth-2 staged start
    overlap_fraction: float = 0.0  # hidden / (hidden + ship) wall this window
                                # (lags one batch); 0.0 when serial
    split_keys: int = 0         # hot keys replicated after this safe point
    shipped_rows_by_class: tuple = (0, 0, 0)  # shipped_rows by lane distance class
                                # (self / intra-host / inter-host), per
                                # worker; zeros when the job has no topology
    lanes: int = 0              # live workers after this batch


@dataclasses.dataclass
class RecoveryStats:
    """One zero-loss recovery: the lane lost, how the job survived it
    (``evict``: shrunk onto the survivors; ``restart``: restored in place,
    the single-worker fallback), how many gap batches the replay buffer
    re-ran, the worker count after, and the recovery's wall (drain,
    restore and replay, up to the lost batch's successful retry)."""

    lane: int
    kind: str                   # "evict" | "restart"
    replayed: int
    workers: int
    wall_s: float = 0.0


class _Staging:
    """The host side of the batches' uploads.

    On the card: two pinned staging sets, one per pipeline stage.  A batch's
    arrays are copied into a set on the host (cast and padded on the way),
    then uploaded with ``non_blocking=True``; an event recorded after the
    copies guards the set, which is refilled only once that event has
    completed.  So an upload never waits for the stream, and the caller may
    overwrite its numpy array as soon as the call returns.  On the CPU each
    upload gets fresh arrays (the tensors handed out alias them)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._sets: list[dict] = [{}, {}]
        self._events = [None, None]
        self._turn = 0

    def upload(self, parts, rows: int) -> list[torch.Tensor]:
        """A tensor of ``rows`` rows on the device for each ``(array, fill,
        dtype)`` of ``parts``: the array's rows, then ``fill``."""
        pinned = self.device.type != "cpu"
        i = self._turn
        self._turn ^= 1
        if pinned:
            host_wait(self._events[i])  # the set's previous copies are done
        out = []
        for j, (a, fill, dtype) in enumerate(parts):
            a = np.asarray(a)
            shape = (rows,) + tuple(a.shape[1:])
            if pinned:
                numel = math.prod(shape)
                buf = self._sets[i].get(j)
                if buf is None or buf.numel() < numel or buf.dtype != dtype:
                    buf = self._sets[i][j] = torch.empty(numel, dtype=dtype, pin_memory=True)
                buf = buf[:numel].view(shape)
            else:
                buf = torch.empty(shape, dtype=dtype)
            host = buf.numpy()
            host[: len(a)] = a
            host[len(a):] = fill
            if pinned:
                buf = torch.empty(shape, dtype=dtype, device=self.device).copy_(
                    buf, non_blocking=True)
            out.append(buf)
        if pinned:
            self._events[i] = torch.cuda.Event()
            self._events[i].record()
        return out


class StreamingJob:
    """Long-running stateful streaming job with DR, on ``num_workers``
    stacked workers of one device.

    ``device=None`` is the CUDA device and raises when there is none;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    ``payload_dim`` is the record payload width (the reduce is a per-key
    vector sum — the word-count family of stateful operators).
    ``topology`` (an :class:`~repro_torch.exchange.ExchangeTopology`, e.g.
    :func:`repro_torch.launch.mesh.exchange_topology_of`) rides every spec
    the job builds, at the live worker count: the shipped rows are split by
    distance class, and the DR master prices plans by locality.
    ``group`` (a :class:`~repro_torch.exchange.dist.WorkerGroup`) runs this
    process's worker of the group's (see the module docstring);
    ``num_workers`` defaults to its world size and ``device`` to its
    device.
    """

    def __init__(
        self,
        *,
        num_partitions: int | None = None,
        num_workers: int | None = None,
        device=None,
        capacity_factor: float = 2.0,
        state_capacity: int = 4096,
        payload_dim: int = 1,
        dr: DRConfig | None = None,
        dr_enabled: bool = True,
        checkpoint_interval: int = 1,
        initial: Partitioner | None = None,
        hist_k: int = 64,
        seed: int = 0,
        exchange_backend=None,
        topology=None,
        group=None,
    ):
        self.group = group
        if group is None:
            self.device = resolve_device(device)
            num_workers = 1 if num_workers is None else num_workers
        else:
            self.device = resolve_device(group.device if device is None else device)
            if num_workers is None:
                num_workers = group.world_size
            if int(num_workers) != group.world_size:
                raise ValueError(f"a job over {group.world_size} ranks has as many "
                                 f"workers, not {num_workers}")
            cfg = dr or DRConfig()
            if isinstance(exchange_backend, FaultyBackend):
                raise NotImplementedError(
                    "a FaultPlan over a process group is not ported: losing a process "
                    "needs a rebuilt group (ROADMAP.md, queue 1)")
            if cfg.health_enabled:
                raise NotImplementedError(
                    "health actions over a process group (Quarantine, Evict, Recover) "
                    "change the set of workers, which needs a rebuilt group (ROADMAP.md, "
                    "queue 1)")
        self.num_workers = int(num_workers)
        self.num_partitions = num_partitions or self.num_workers
        if self.num_partitions < self.num_workers:
            raise ValueError(f"num_partitions {self.num_partitions} < "
                             f"num_workers {self.num_workers}")
        self.capacity_factor = capacity_factor
        self.state_capacity = state_capacity
        self.payload_dim = payload_dim
        self.dr_enabled = dr_enabled
        self.checkpoint_interval = checkpoint_interval
        self.hist_k = hist_k
        self.seed = seed
        self.exchange_backend = resolve_backend(exchange_backend or "dense")
        self.exchange_topology = topology
        cfg = dr or DRConfig()
        heavy_cap = heavy_capacity_for(cfg.lam, self.num_partitions)
        part = initial or uniform_partitioner(
            self.num_partitions, DEFAULT_NUM_HOSTS, seed, heavy_capacity=heavy_cap)
        self.drm = DRMaster(part, cfg, exchange_backend=self.exchange_backend,
                            exchange_topology=topology)
        self.telemetry = Telemetry("stream")
        self._shuffle = None
        self._shuffle_sig = None    # (capacity, num_partitions) the step was built for
        self._shuffle_spec: ExchangeSpec | None = None
        self._migrate_steps: dict[int, object] = {}  # lane capacity -> step
        self._pending_resize: int | None = None  # applied at the next checkpoint
        self._staging = _Staging(self.device)
        self._tables_of = None      # the partitioner whose device tables are held
        self._device_tables = None
        # split-phase overlap: the previous batch's in-flight finish + merge
        # (a callable that enqueues it), the host wall start of the section
        # a pending ship is hiding behind, and the state-row count as of the
        # last drain (reading it live would wait for the in-flight merge)
        self._inflight = None
        self._hidden_since: float | None = None
        self._last_state_rows = 0
        # depth 2: ``run`` parks the lookahead batch here, ``process_batch``
        # stages its start behind the current ship, and a taken action
        # discards the staged start so the batch is routed afresh
        self._next_batch: np.ndarray | None = None
        # (source array, partitioner, step, pending, host ShuffleStart, event)
        self._staged: tuple | None = None
        # split_least_load: the previous batch's loads, float32 on the
        # device, that the next route's replica pick reads (None: equal)
        self._part_loads: torch.Tensor | None = None
        # failure domains: current -> original lane map (plan lanes are
        # original ids), the quarantined lanes' labels (oldest first), the
        # auto-snapshot and bounded replay buffer
        # (``DRConfig.snapshot_interval``), and the recovery record
        self._lane_ids: list[int] = list(range(self.num_workers))
        self._parked: list[int] = []
        self._auto_snap: dict | None = None
        self._replay: list[tuple[np.ndarray, np.ndarray | None]] = []
        self.recoveries: list[RecoveryStats] = []
        self.state_keys, self.state_vals = empty_state(
            state_capacity, payload_dim, num_workers=self._local_workers, device=self.device)
        self.metrics: list[BatchMetrics] = []

    # -- keyed state access (drains any in-flight exchange first) ----------
    # Over a process group the getters gather every rank's row into the
    # stacked [W, ...] layout (every rank calls them together); the setters
    # take this process's rows.
    @property
    def state_keys(self) -> torch.Tensor:
        self._drain_inflight()
        return self._stacked(self._sk)

    @state_keys.setter
    def state_keys(self, v):
        self._sk = v

    @property
    def state_vals(self) -> torch.Tensor:
        self._drain_inflight()
        return self._stacked(self._sv)

    @state_vals.setter
    def state_vals(self, v):
        self._sv = v

    @property
    def _local_workers(self) -> int:
        """Workers this process holds: all of them stacked, or its own one."""
        return self.num_workers if self.group is None else 1

    def _stacked(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of this process's workers as the ``[W, ...]`` of all of
        them: itself when stacked, gathered in rank order over a group."""
        return t if self.group is None else self.group.gather_rows(t)[0]

    def _total(self, t: torch.Tensor) -> int:
        """A count over this process's workers, summed over the group."""
        if self.group is not None:
            t = self.group.sum(t)[0]
        return int(host_fetch(t))

    def _agree_walls(self, signals):
        """``signals`` with every wall the policies read (the window's and
        its phase walls, and the per-backend wall EWMAs, written back to the
        telemetry) at its max over the group, so that every rank decides on
        the same numbers; unchanged when stacked."""
        if self.group is None:
            return signals
        tel = self.telemetry
        names = BACKEND_NAMES
        fields = ("window_wall_s", "exchange_wall_s", "exchange_count_wall_s",
                  "exchange_ship_wall_s", "exchange_hidden_wall_s")
        vec = self.group.host_max([getattr(signals, f) for f in fields]
                                  + [tel.wall_ewma.get(n, -1.0) for n in names])
        tel.wall_ewma = {n: float(v) for n, v in zip(names, vec[len(fields):]) if v >= 0.0}
        return dataclasses.replace(
            signals, **{f: float(v) for f, v in zip(fields, vec)},
            backend_wall_ewma=dict(tel.wall_ewma) if tel.wall_ewma else None)

    def _check_agreement(self) -> None:
        """Compare a digest of the decision just logged, and of the
        partitioner after it, across the group; a rank that decided
        otherwise raises on every rank.  Nothing to compare when stacked."""
        if self.group is None:
            return
        d = self.drm.decisions.records[-1]
        part = self.drm.partitioner
        h = hashlib.blake2b(digest_size=8)
        h.update(repr((d.tick, d.kind, d.taken, d.reason, d.imbalance,
                       sorted(d.detail.items()), part.num_partitions, part.seed,
                       self.drm.exchange_backend.name)).encode())
        for a in (part.heavy_keys, part.heavy_parts, part.host_to_part, part.heavy_repl):
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
        digests = self.group.host_gather(np.frombuffer(h.digest(), np.int64))
        if not (digests == digests[0]).all():
            raise RuntimeError(f"the ranks decided differently at tick {d.tick}: rank "
                               f"{self.group.rank} took {d.kind} ({d.reason}); digests "
                               f"{digests.ravel().tolist()}")

    def _overlap_active(self) -> bool:
        return self.drm.config.overlap_exchange and overlap_enabled()

    def _depth2_active(self) -> bool:
        # the environment's switch wins over the configured depth: serial
        # means serial
        return self._overlap_active() and self.drm.config.pipeline_depth >= 2

    def _discard_staged(self) -> None:
        """Drop the staged lookahead start: its device work completes in the
        background and its outputs are never read.  The send-buffer set it
        took is lost to the pool (the next start allocates fresh)."""
        self._staged = None

    def _take_staged(self, raw_keys, has_values: bool):
        """``(pending, host ShuffleStart, event)`` of the staged start if it
        still routes ``raw_keys`` correctly, else ``None`` (the caller routes
        afresh).  Valid only for this very array (``run`` hands the same
        object back), no caller-supplied values (staging uses the all-ones
        payload), and the very partitioner and step the staged route used:
        a taken action swaps the partitioner, a rebuild swaps the step."""
        st, self._staged = self._staged, None
        if st is None:
            return None
        src, part, step, pending, res, ready = st
        if (not has_values and src is raw_keys
                and part is self.drm.partitioner and step is self._shuffle):
            return pending, res, ready
        return None

    def _stage_next(self, raw: np.ndarray) -> None:
        """Upload the lookahead batch and enqueue its route + bucketize +
        count phase behind the current in-flight ship (depth 2), with its
        control outputs copied to the host behind it.  Routes with today's
        partitioner (see :meth:`_take_staged`).  Skipped when the lookahead's
        lane capacity differs from the live step's: the rebuild must not
        race the batch still using it (that boundary runs at depth 1)."""
        w = self.num_workers
        total = -(-len(raw) // w) * w
        cap = int(np.ceil(self.capacity_factor * total / w / 8.0) * 8)
        if (cap, self.num_partitions) != self._shuffle_sig:
            return
        shuffle = self._shuffle
        pending, start = shuffle.start(self._tables(), *self._upload(raw, None),
                                       self._part_loads)
        res, ready = copy_to_host(start)
        self._staged = (raw, self.drm.partitioner, shuffle, pending, res, ready)

    def _consume_inflight(self) -> None:
        """Enqueue the pending finish + merge (no wait)."""
        fin, self._inflight = self._inflight, None
        if fin is not None:
            fin()

    def _drain_inflight(self) -> None:
        """Complete the in-flight finish + merge, blocking, and record the
        un-hidden ship wall (and whatever host wall it did hide)."""
        if self._inflight is None:
            return
        t = time.perf_counter()
        hidden = None if self._hidden_since is None else t - self._hidden_since
        self._hidden_since = None
        self._consume_inflight()
        with safe_point():  # a drain is a safe point: the wait is sanctioned
            rows = self._total(state_size(self._sk).sum())  # waits for the merge
        self.telemetry.record_exchange(ExchangeStats(
            rows=0, ship_wall_s=time.perf_counter() - t, hidden_wall_s=hidden))
        self._last_state_rows = rows

    # ------------------------------------------------------------------
    def _build(self, n: int):
        """(Re)build the shuffle step when the lane capacity changed.  ``n``
        is the padded batch size over all workers, so a lane holds
        ``capacity_factor`` times one worker's fair share of the batch."""
        cap = int(np.ceil(self.capacity_factor * n / self.num_workers / 8.0) * 8)
        sig = (cap, self.num_partitions)
        if self._shuffle is not None and sig == self._shuffle_sig:
            return
        self._shuffle_sig = sig
        self._shuffle_spec = ExchangeSpec(num_lanes=self.num_workers, capacity=cap,
                                          axis="data", topology=self.exchange_topology,
                                          group=self.group)
        self._shuffle = make_shuffle_step(
            num_workers=self.num_workers, num_partitions=self.num_partitions,
            capacity=cap, hist_k=self.hist_k,
            num_hosts=self.drm.partitioner.num_hosts, seed=self.seed,
            backend=self.exchange_backend, topology=self.exchange_topology,
            group=self.group)

    def _migrate_step(self, lane_capacity: int):
        """Migrate step with lanes >= ``lane_capacity`` rows, rounded up to a
        power of two (capped at the state table) so repeated repartitions
        reuse a handful of steps."""
        cap = 8
        while cap < min(lane_capacity, self.state_capacity):
            cap *= 2
        cap = min(cap, self.state_capacity)
        if cap not in self._migrate_steps:
            self._migrate_steps[cap] = make_migrate_step(
                num_workers=self.num_workers, state_capacity=self.state_capacity,
                num_hosts=self.drm.partitioner.num_hosts, seed=self.seed,
                spec=ExchangeSpec(num_lanes=self.num_workers, capacity=cap, axis="data",
                                  topology=self.exchange_topology, group=self.group),
                backend=self.exchange_backend)
        return self._migrate_steps[cap], cap

    def _tables(self):
        """The current partitioner's device tables, uploaded once per
        partitioner (the DR master replaces, never edits, its partitioner)."""
        part = self.drm.partitioner
        if self._tables_of is not part:
            self._tables_of, self._device_tables = part, part.tables(self.device)
        return self._device_tables

    def _upload(self, keys: np.ndarray, values: np.ndarray | None):
        """``(keys int32[W, n], vals f32[W, n, ...], valid bool[W, n])`` on
        the device: the batch padded with sentinel keys to a multiple of
        ``num_workers``, worker ``i`` taking the ``i``-th contiguous chunk,
        as ``shard_map`` splits it in the reference (over a group this
        process uploads its own chunk, ``[1, n]``).  Without ``values`` the
        payload is all ones, made on the device."""
        local_n = -(-len(keys) // self.num_workers)
        if self.group is not None:
            lo = self.group.rank * local_n
            keys = keys[lo: lo + local_n]
            values = None if values is None else values[lo: lo + local_n]
        w = self._local_workers
        parts = [(keys, _SENT, torch.int32)]
        if values is not None:
            parts.append((values, 0.0, torch.float32))
        up = self._staging.upload(parts, local_n * w)
        k = up[0].view(w, local_n)
        if values is None:
            v = torch.ones((w, local_n, self.payload_dim), dtype=torch.float32,
                           device=self.device)
        else:
            v = up[1].view((w, local_n) + tuple(values.shape[1:]))
        return k, v, k != _SENT

    # ------------------------------------------------------------------
    def process_batch(self, keys: np.ndarray, values: np.ndarray | None = None) -> BatchMetrics:
        """Run one micro-batch through shuffle + stateful reduce + DR.

        With ``DRConfig.snapshot_interval > 0`` this is also the zero-loss
        recovery loop: the first auto-snapshot is taken lazily, every
        processed batch joins the replay buffer, and a
        :class:`~repro_torch.exchange.WorkerLostError` from the fault seam
        triggers recovery (:meth:`_recover_from_loss`), then the replay of
        the gap batches and the retry of this one on the surviving workers.
        At most ``num_workers + 1`` losses in a row are absorbed (a
        completed batch resets the budget).  With ``snapshot_interval ==
        0`` a loss propagates."""
        cfg = self.drm.config
        if cfg.snapshot_interval > 0 and self._auto_snap is None:
            # the lazy first snapshot: the zero state is trivially consistent
            self._auto_snap = self.snapshot()
            self._replay = []
        pending_rec: tuple[RecoveryStats, float] | None = None
        replaying: list = []  # gap batches still to re-run before this one
        budget = self.num_workers + 1
        while True:
            try:
                while replaying:
                    rk, rv = replaying[0]
                    self._process_batch_inner(rk, rv)
                    replaying.pop(0)
                    # a completed batch is progress: the budget guards against
                    # recovery that cannot advance, not against a stream that
                    # keeps losing (distinct) workers
                    budget = self.num_workers + 1
                m = self._process_batch_inner(keys, values)
                break
            except WorkerLostError as loss:
                budget -= 1
                if budget <= 0 or cfg.snapshot_interval <= 0:
                    raise
                t_rec = time.perf_counter()
                kind = self._recover_from_loss(loss)
                replaying = list(self._replay)
                rec = RecoveryStats(lane=loss.lane, kind=kind, replayed=len(replaying),
                                    workers=self.num_workers)
                self.recoveries.append(rec)
                pending_rec = (rec, t_rec)
        if pending_rec is not None:
            rec, t_rec = pending_rec
            rec.wall_s = time.perf_counter() - t_rec
            rec.workers = self.num_workers
        if cfg.snapshot_interval > 0:
            if m.action in ("quarantine", "evict", "recover"):
                # the workers changed under the snapshot: take it again, so a
                # later restore lands on the live layout
                self._auto_snap = self.snapshot()
                self._replay = []
            else:
                self._replay.append((keys, values))
                if len(self._replay) >= cfg.snapshot_interval:
                    self._auto_snap = self.snapshot()
                    self._replay = []
        return m

    def _process_batch_inner(self, keys: np.ndarray,
                             values: np.ndarray | None = None) -> BatchMetrics:
        t0 = time.perf_counter()
        raw_keys = keys
        w = self.num_workers
        self._build(-(-len(keys) // w) * w)
        batch_backend = self.exchange_backend.name
        overlap = self._overlap_active()
        staged = self._take_staged(raw_keys, values is not None) if overlap else None
        pipelined = staged is not None
        # the batch's host preparation (cast, pad, copy into pinned staging)
        # stays outside the exchange wall, as the reference's numpy
        # preparation does; the upload itself is enqueued without waiting
        batch = None if pipelined else self._upload(keys, values)

        t_ex = time.perf_counter()
        if overlap:
            # enqueue this batch's start (unless depth 2 staged it last
            # batch) and the copies of its control outputs, then the
            # previous batch's ship + merge behind them, and wait only for
            # the copies: the stream runs in order, so the wait covers the
            # start phase, and the merge runs under the decision section
            shuffle = self._shuffle
            if pipelined:
                pending, res, ready = staged
            else:
                pending, start = shuffle.start(self._tables(), *batch, self._part_loads)
                res, ready = copy_to_host(start)
            self._consume_inflight()

            def _fin_shuffle(fin=shuffle.finish, pending=pending):
                rk, rv, rva, _rp = fin(pending)
                self._sk, self._sv, _ = merge_into(self._sk, self._sv, rk, rv, rva)

            self._inflight = _fin_shuffle
            with safe_point():
                host_wait(ready)  # the start phase and its copies only
                loads = host_fetch(res.loads)
            exchange_wall = time.perf_counter() - t_ex
            count_wall = exchange_wall
        else:
            self._discard_staged()  # overlap turned off mid-stream: route afresh
            self._drain_inflight()
            res = self._shuffle(self._tables(), *batch, self._part_loads)
            # stateful reduce: fold received records into per-worker state
            self._sk, self._sv, _ = merge_into(self._sk, self._sv, res.keys, res.values,
                                               res.valid)
            with safe_point():
                loads = host_fetch(res.loads)  # waits for the batch's device work
            exchange_wall = time.perf_counter() - t_ex
            count_wall = None
        # the next route reads this batch's loads (all three drivers route
        # batch N+1 on batch N's, set here before any lookahead stages)
        if self.drm.config.split_least_load:
            self._part_loads = to_device(np.asarray(loads, np.float32), self.device)
        # depth 2: upload the lookahead batch and enqueue its start now,
        # behind this batch's in-flight ship
        if self._next_batch is not None and self._depth2_active():
            self._stage_next(self._next_batch)
        # the decision section below reads only the start phase's outputs
        # (host copies when overlapped)
        self._hidden_since = time.perf_counter() if overlap else None

        with safe_point():
            stats = shuffle_stats(res, self._shuffle_spec, w, wall_s=exchange_wall,
                                  count_wall_s=count_wall, backend=batch_backend,
                                  replica_rows=self._replica_rows(raw_keys))
            shuffle_shipped = int(stats.rows)
            overflow_i = int(host_fetch(res.overflow))
            self.telemetry.record_exchange(stats)
            self.telemetry.record_overflow(shuffle=overflow_i)
            self.telemetry.record_batch(float(loads.sum()))
            # fault evidence: drain the seam's per-lane report (keyed by
            # original lane id) into telemetry at the current rows; a plain
            # transport has no report and a never-firing plan drains empty
            drain = getattr(self.exchange_backend, "drain_report", None)
            if drain is not None:
                for orig, rec in drain().items():
                    if orig in self._lane_ids:
                        self.telemetry.record_fault(
                            self._lane_ids.index(orig),
                            straggle_s=rec.get("straggle_s", 0.0),
                            retries=rec.get("retries", 0))
            self.drm.observe(host_fetch(res.hist_keys), host_fetch(res.hist_counts),
                             total_records=float(loads.sum()))
        at_checkpoint = (len(self.metrics) + 1) % self.checkpoint_interval == 0
        requested = None
        if at_checkpoint and self._pending_resize is not None:
            requested, self._pending_resize = self._pending_resize, None
        signals = self.telemetry.snapshot(
            loads=loads, num_workers=w,
            # overlapped: the count as of the last drain (the migration
            # planner reads the real keys after the pre-action drain)
            state_rows=self._last_state_rows if overlap else self._state_rows(),
            at_safe_point=at_checkpoint)
        if at_checkpoint:
            # only a safe point decides (and logs): off one, the walls are
            # not read and there is no new decision to compare
            signals = self._agree_walls(signals)
        action = self.drm.evaluate(signals, requested_resize=requested,
                                   policies_enabled=self.dr_enabled)
        if at_checkpoint:
            self._check_agreement()

        # execute the action (state only moves here, at the safe point).  A
        # taken action first drains the in-flight ship + merge (a migration
        # must see this batch merged) and discards the staged start (its
        # route used the partitioner this action replaces)
        if action.taken:
            self._drain_inflight()
            self._discard_staged()
        migration = (0.0, 0, 0, 0, 0, 0, None)
        if isinstance(action, Resize):
            migration = self._apply_resize(action.target)
        elif isinstance(action, Repartition):
            migration = self._migrate_state(action.prev)
        elif isinstance(action, Unsplit):
            # the DR master already dropped the key from the replica table: a
            # home-routed migration off the still-split partitioner pulls
            # every replica's partial home, where the merge sums them
            migration = self._migrate_state(action.prev, full_lanes=True)
        elif isinstance(action, SwitchBackend):
            # the DR master installed the new transport; no state moves
            self._apply_backend_switch()
        elif isinstance(action, Quarantine):
            # the circuit breaker opens: the sick lane leaves the stack, its
            # label is parked for a Recover, and the survivors adopt its
            # state (the modulo placement re-folds the partitions)
            self._apply_lane_removal(action.lane, park=True)
        elif isinstance(action, Evict):
            self._apply_lane_removal(action.lane, park=False)
        elif isinstance(action, Recover):
            self._apply_recover()
        # a Split needs nothing here: the next batch's route fans the key out
        (rel_mig, mig_overflow, mig_rows, plan_rows, mig_shipped, mig_moved,
         mig_by_class) = migration
        if mig_rows:
            self.telemetry.record_exchange(migrate_stats(
                shipped_rows=mig_shipped * w,  # helper re-divides per worker
                buffer_rows=mig_rows, moved_rows=mig_moved,
                overflow=mig_overflow, num_workers=w,
                shipped_rows_by_class=mig_by_class))
            self.telemetry.record_overflow(migration=mig_overflow)
        # shipped rows by class, the shuffle's and the migration's, per
        # worker (each divided on its own, as in the reference); zeros when
        # the job has no topology
        by_class = np.zeros(DISTANCE_CLASSES, np.int64)
        if stats.rows_by_class is not None:
            by_class += stats.rows_by_class
        if mig_by_class is not None:
            by_class += mig_by_class // w

        m = BatchMetrics(
            batch=len(self.metrics),
            imbalance=signals.imbalance,
            worker_imbalance=signals.worker_imbalance,
            repartitioned=action.taken and action.moves_state,
            relative_migration=rel_mig,
            overflow=overflow_i + mig_overflow,
            state_rows=(self._last_state_rows if overlap else
                        (signals.state_rows if isinstance(action, NoOp)
                         else self._state_rows())),
            wall_time_s=time.perf_counter() - t0,
            reason=action.reason,
            migration_rows=mig_rows,
            resized=isinstance(action, Resize),
            num_partitions=self.num_partitions,
            migration_plan_rows=plan_rows,
            action=action.kind,
            shipped_rows=shuffle_shipped + mig_shipped,
            padded_rows=self._shuffle_spec.rows + mig_rows,
            backend=batch_backend,
            exchange_wall_s=exchange_wall,
            overlapped=overlap,
            pipelined=pipelined,
            overlap_fraction=signals.overlap_fraction,
            split_keys=len(self.drm.split_keys),
            shipped_rows_by_class=tuple(int(x) for x in by_class),
            lanes=self.num_workers,
        )
        # the host wall since the count sync ran under this batch's (or the
        # migration's) in-flight ship: the latency the overlap hid.  Recorded
        # at batch end, so it lands in the next telemetry window.
        if self._inflight is not None and self._hidden_since is not None:
            self.telemetry.record_exchange(ExchangeStats(
                rows=0, hidden_wall_s=time.perf_counter() - self._hidden_since))
        self._hidden_since = None
        self.metrics.append(m)
        return m

    def _replica_rows(self, keys: np.ndarray) -> np.ndarray | None:
        """Rows the split keys of ``keys`` land on each partition (the host
        twin of the route's replica pick over the batch as the workers hold
        it: sentinel-padded to a multiple of ``num_workers``); ``None`` while
        nothing is split, and under the least-load pick, whose load vector
        the twin does not see (as in the reference)."""
        if not self.drm.split_keys or self.drm.config.split_least_load:
            return None
        w = self.num_workers
        padded = np.full(-(-len(keys) // w) * w, _SENT, np.int32)
        padded[: len(keys)] = keys
        return split_replica_rows(self.drm.partitioner, padded, w, padded != _SENT)

    def _state_rows(self) -> int:
        """Live keyed-state rows across all workers (drains first)."""
        self._drain_inflight()
        with safe_point():
            self._last_state_rows = self._total(state_size(self._sk).sum())
        return self._last_state_rows

    def _migrate_state(self, old_part: Partitioner, *, full_lanes: bool = False):
        """Ship keyed state to where ``self.drm.partitioner`` now maps it.

        Plans on the host (``plan_migration`` over the live keys, across
        sizes too), sizes the exchange lanes from the plan, and folds the
        received rows back into the kept state.  ``full_lanes``, and any
        installed split, give every lane the whole state table: a split's
        partials live off home, where the home-diff plan cannot see them,
        yet the home-routed step ships each of them home.  Overlapped, only
        the start phase is waited for: the ship and merge stay in flight
        across the safe point.  Returns ``(relative_migration, overflow,
        buffer_rows, planned_lane_rows, shipped_rows per worker,
        moved_rows, shipped_rows_by_class)``, the last summed over the
        workers (int64[C], zeros on a flat spec)."""
        with safe_point():
            sk = host_fetch(self.state_keys).reshape(-1)
        live = sk[sk != _SENT].astype(np.int64)
        plan = plan_migration(old_part, self.drm.partitioner, live)
        if full_lanes or self.drm.split_keys:
            plan_rows = self.state_capacity
        else:
            plan_rows = migration_capacity(plan, num_workers=self.num_workers)
        migrate, lane_cap = self._migrate_step(plan_rows)
        tables = self._tables()
        if self._overlap_active():
            pending, st = migrate.start(tables, self._sk, self._sv)
            (moved, total, mig_ov, lane_ov, mig_shipped, mig_by), ready = copy_to_host(
                (st.moved, st.total, st.overflow, st.lane_overflow, st.shipped_rows,
                 st.shipped_rows_by_class))
            # interim state = the kept rows; the pending merge adds the
            # received ones (readers drain first, so never see the interim)
            self._sk = torch.where(st.kept_valid, st.kept_keys, _SENT)
            self._sv = st.kept_vals
            self._hidden_since = time.perf_counter()

            def _fin_migrate(fin=migrate.finish, pending=pending):
                rk, rv, rva = fin(pending)
                self._sk, self._sv, _ = merge_into(self._sk, self._sv, rk, rv, rva)

            self._inflight = _fin_migrate
        else:
            out = migrate(tables, self._sk, self._sv)
            kept_keys = torch.where(out.kept_valid, out.kept_keys, _SENT)
            self._sk, self._sv, _ = merge_into(
                kept_keys, out.kept_vals, out.recv_keys, out.recv_vals, out.recv_valid)
            moved, total, mig_ov, lane_ov, mig_shipped, mig_by = (
                out.moved, out.total, out.overflow, out.lane_overflow, out.shipped_rows,
                out.shipped_rows_by_class)
            ready = None
        with safe_point():
            host_wait(ready)
            moved_i = int(host_fetch(moved))
            total_i = int(host_fetch(total))
            mig_shipped_i = int(host_fetch(mig_shipped))
            mig_ov_i = int(host_fetch(mig_ov))
            lane_ov = host_fetch(lane_ov)
            mig_by_np = np.asarray(host_fetch(mig_by), np.int64)
        rel_mig = float(moved_i) / max(float(total_i), 1e-9)
        mig_rows = self.num_workers * lane_cap  # rows received per worker
        self.telemetry.record_exchange(ExchangeStats(rows=0, lane_overflow=lane_ov))
        return (rel_mig, mig_ov_i, mig_rows, plan_rows,
                mig_shipped_i // self.num_workers, moved_i, mig_by_np)

    # ------------------------------------------------------------------
    def run(self, batches: Iterable[np.ndarray]) -> list[BatchMetrics]:
        """Process ``batches`` in order.  At depth 2 batch N+1 is parked
        where ``process_batch`` stages its start behind batch N's ship; the
        check runs per batch, so turning overlap off mid-stream falls back
        to depth 1 instead of staging work nobody claims."""
        out: list[BatchMetrics] = []
        seq = list(batches)
        for i, b in enumerate(seq):
            self._next_batch = (seq[i + 1] if self._depth2_active() and i + 1 < len(seq)
                                else None)
            out.append(self.process_batch(b))
        self._next_batch = None
        return out

    def resize(self, num_partitions: int) -> None:
        """Request an elastic grow or shrink to ``num_partitions``, applied
        at the next checkpoint safe point (state moves only there); works
        with ``dr_enabled=False`` too."""
        n = int(num_partitions)
        if n < self.num_workers:
            raise ValueError(
                f"cannot resize to {n} partitions: the job has {self.num_workers} workers")
        self._pending_resize = n

    def _apply_resize(self, n: int):
        """Execute a resize at a safe point: re-plan across sizes, migrate
        the state through lanes the cross-size plan sizes, and drop the
        shuffle step, whose loads vector follows the partition count (its
        send buffers, ``[W, W, cap]``, do not: the migrate steps, keyed by
        lane capacity, stay)."""
        old = self.drm.partitioner
        self.drm.replan_resize(n)
        stats = self._migrate_state(old)
        self.num_partitions = n
        self._shuffle = None
        self._shuffle_sig = None
        self._part_loads = None  # re-seeded at the new width
        return stats

    def _adopt_backend(self, backend) -> None:
        """Run on ``backend`` from now on (the DR master's choice).  An armed
        fault seam stays armed: the wrapper is re-pointed at the new
        transport instead of being replaced."""
        if isinstance(self.exchange_backend, FaultyBackend):
            self.exchange_backend.inner = resolve_backend(backend)
            self.drm.exchange_backend = self.exchange_backend
        else:
            self.exchange_backend = backend

    def _apply_backend_switch(self) -> None:
        """Adopt the DR master's newly installed transport at a safe point:
        the shuffle and migrate steps were built for the old one, so both
        go, and the next batch rebuilds them (as after a resize)."""
        self._adopt_backend(self.drm.exchange_backend)
        self._shuffle = None
        self._shuffle_sig = None
        self._migrate_steps.clear()

    # -- failure domains: lane removal, re-admission, recovery -----------
    def _set_workers(self, n: int) -> None:
        """Run on ``n`` stacked workers from now on, and drop everything
        built for the old count: the shuffle and migrate steps, the
        in-flight and staged stages, and the least-load vector.  The
        partitioner stays: the partitions re-fold onto the new count
        through the modulo placement.  Over a process group the workers are
        the ranks, and changing them needs a rebuilt group: raises."""
        self._refuse_worker_change()
        self.num_workers = int(n)
        self._shuffle = None
        self._shuffle_sig = None
        self._migrate_steps.clear()
        self._part_loads = None
        self._inflight = None
        self._hidden_since = None
        self._staged = None

    def _refuse_worker_change(self) -> None:
        if self.group is not None:
            raise NotImplementedError(
                "changing the set of workers over a process group (Quarantine, Evict, "
                "Recover) needs a rebuilt group (ROADMAP.md, queue 1)")

    def _fetch_state(self) -> tuple[np.ndarray, np.ndarray]:
        """The state tables on the host, stacked (the pre-action drain is
        done)."""
        with safe_point():
            return host_fetch(self._stacked(self._sk)), host_fetch(self._stacked(self._sv))

    def _apply_lane_removal(self, lane: int, *, park: bool) -> None:
        """Execute a Quarantine (``park=True``) or an Evict at a safe point:
        fetch the state, remove row ``lane`` from the stack and fold its
        rows onto the survivors."""
        self._refuse_worker_change()
        sk, sv = self._fetch_state()
        orig = self._lane_ids.pop(lane)
        if park:
            self._parked.append(orig)
        backend = self.exchange_backend
        if isinstance(backend, FaultyBackend):
            (backend.note_quarantined if park else backend.note_evicted)(orig)
        self._set_workers(self.num_workers - 1)
        self._adopt_state(sk, sv)

    def _apply_recover(self) -> None:
        """Execute a Recover at a safe point: re-admit the oldest parked lane
        as the last row and spread the state back over the grown stack."""
        self._refuse_worker_change()
        if not self._parked:
            # a restored ledger can outlive the parked list (the snapshot
            # predates the quarantine): reconcile, and run on unchanged
            self.drm.quarantined.clear()
            return
        sk, sv = self._fetch_state()
        orig = self._parked.pop(0)
        self._lane_ids.append(orig)
        backend = self.exchange_backend
        if isinstance(backend, FaultyBackend):
            backend.note_recovered(orig)
        self._set_workers(self.num_workers + 1)
        self._adopt_state(sk, sv)

    def _reconcile_quarantine(self) -> None:
        """The parked list is ground truth for what can be re-admitted: trim
        the DR master's quarantine ledger to it."""
        while len(self.drm.quarantined) > len(self._parked):
            self.drm.quarantined.pop()

    def _recover_from_loss(self, loss: WorkerLostError) -> str:
        """Zero-loss recovery from a hard worker loss: drain the survivors'
        in-flight stages, evict the lost lane (the last worker restarts in
        place instead), restore the last auto-snapshot onto the surviving
        workers and record the forced eviction.  The caller replays the gap
        and retries the lost batch.  Returns ``"evict"`` or ``"restart"``."""
        try:
            self._drain_inflight()  # the state is replaced below, but the
        except Exception:           # stream must run empty first
            self._inflight = None
            self._hidden_since = None
        self._discard_staged()
        backend = self.exchange_backend
        kind = "evict"
        if self.num_workers > 1 and loss.lane in self._lane_ids:
            self._lane_ids.remove(loss.lane)
            self._set_workers(self.num_workers - 1)
            if isinstance(backend, FaultyBackend):
                backend.note_evicted(loss.lane)
        else:
            # a single worker (or a lane already removed): restore and replay
            # in place; the restarted lane stays eligible for later faults,
            # only its standing death clears
            kind = "restart"
            if isinstance(backend, FaultyBackend):
                backend.note_restarted(loss.lane)
        self.restore(self._auto_snap, _keep_recovery_log=True)
        # the restored DR master predates the loss: log the forced eviction,
        # and reconcile its quarantine ledger with the parked lanes
        self.drm.note_lost(loss.lane, reason=str(loss))
        self._reconcile_quarantine()
        while len(self.drm.quarantined) < len(self._parked):
            self.drm.quarantined.append((-1, self.drm.batches_seen))
        return kind

    # -- state inspection ----------------------------------------------
    def state_count(self, key: int) -> float:
        """Total aggregated value for one key across all workers (test hook;
        drains the in-flight merge)."""
        with safe_point():
            hit = self.state_keys == int(key)
            return float(host_fetch(self.state_vals[hit].sum()))

    # -- checkpoint / restore --------------------------------------------
    def snapshot(self) -> dict:
        """State tables plus the DRM snapshot under ``drm_`` — the keys of the
        reference's ``StreamingJob.snapshot``.  Drains the in-flight merge
        first.  The tables are copies: an auto-snapshot outlives several
        batches and must not share memory with the live state."""
        with safe_point():
            return {
                "state_keys": np.array(host_fetch(self.state_keys)),
                "state_vals": np.array(host_fetch(self.state_vals)),
                **{f"drm_{k}": v for k, v in self.drm.snapshot().items()},
            }

    def _adopt_state(self, sk: np.ndarray, sv: np.ndarray) -> None:
        """Lay host state tables out on this job's worker count, on the host
        at a safe point: duplicate keys merge (split partials from different
        workers meet here, and the reduce is a sum), every key goes to its
        home partition's worker, and each worker keeps at most
        ``state_capacity`` rows; the rest count as migration overflow.  Over
        a process group this process keeps its own worker's row."""
        w, cap = self.num_workers, self.state_capacity
        keys = np.asarray(sk).reshape(-1)
        vals = np.asarray(sv).reshape(-1, np.asarray(sv).shape[-1])
        live = keys != _SENT
        keys, vals = keys[live], vals[live]
        uniq, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros((len(uniq),) + vals.shape[1:], vals.dtype)
        np.add.at(acc, inv, vals)
        dest = self.drm.partitioner.lookup_np(uniq.astype(np.int32)) % w
        new_k = np.full((w, cap), _SENT, np.int32)
        new_v = np.zeros((w, cap) + vals.shape[1:], np.float32)
        overflow = 0
        for worker in range(w):
            rows = np.nonzero(dest == worker)[0]
            if len(rows) > cap:
                overflow += len(rows) - cap
                rows = rows[:cap]
            new_k[worker, : len(rows)] = uniq[rows]
            new_v[worker, : len(rows)] = acc[rows]
        self._last_state_rows = int((new_k != _SENT).sum())
        if self.group is not None:
            r = self.group.rank
            new_k, new_v = new_k[r: r + 1], new_v[r: r + 1]
        self.state_keys = torch.from_numpy(new_k).to(self.device)
        self.state_vals = torch.from_numpy(new_v).to(self.device)
        if overflow:
            self.telemetry.record_overflow(migration=overflow)

    def restore(self, snap: dict, *, _keep_recovery_log: bool = False) -> None:
        """Resume from a snapshot of either package.  The snapshot's
        transport and partition count win over the ones this job was built
        with (an armed fault seam stays armed, re-pointed at the snapshot's
        transport).  A snapshot of another worker count is re-folded onto
        this job's workers and state capacity (:meth:`_adopt_state`).  The
        in-flight finish belongs to the replaced state and the staged start
        to the replaced partitioner: both go, as do a pending resize and the
        least-load vector (measured before the restore).  An external
        restore starts a new failure epoch: the auto-snapshot and the replay
        buffer go too (the recovery protocol keeps them, since it is about
        to replay that buffer).  A snapshot's lane topology wins too; a flat
        snapshot keeps the one this job was built with."""
        drm_snap = {k[4:]: v for k, v in snap.items() if k.startswith("drm_")}
        snap_keys = np.asarray(snap["state_keys"])
        self._inflight = None
        self._hidden_since = None
        self._staged = None
        self._pending_resize = None
        self._part_loads = None
        self.drm = DRMaster.restore(drm_snap, self.drm.config)
        if snap_keys.shape[0] != self.num_workers:
            self._adopt_state(snap_keys, np.asarray(snap["state_vals"]))
        else:
            rows = (slice(None) if self.group is None
                    else slice(self.group.rank, self.group.rank + 1))
            self.state_keys = torch.tensor(snap_keys[rows], dtype=torch.int32,
                                           device=self.device)
            self.state_vals = torch.tensor(np.asarray(snap["state_vals"])[rows],
                                           dtype=torch.float32, device=self.device)
            self.state_capacity = int(snap_keys.shape[1])
        self.payload_dim = int(self._sv.shape[2])
        if "exchange_backend" in drm_snap:  # the snapshot's transport wins
            self._adopt_backend(self.drm.exchange_backend)
        else:  # a snapshot older than the backends: this job's stands
            self.drm.exchange_backend = self.exchange_backend
        if self.drm.exchange_topology is not None:  # the snapshot's topology wins
            self.exchange_topology = self.drm.exchange_topology
        else:  # a flat snapshot: the topology this job was built with stands
            self.drm.exchange_topology = self.exchange_topology
        n = self.drm.partitioner.num_partitions
        if n < self.num_workers:
            raise ValueError(f"snapshot has {n} partitions < {self.num_workers} workers")
        self.num_partitions = n
        self._shuffle = None
        self._shuffle_sig = None
        self._migrate_steps.clear()
        if not _keep_recovery_log:
            self._auto_snap = None
            self._replay = []
        self._reconcile_quarantine()
        self._state_rows()  # refresh the drain-time row count
