"""Micro-batch streaming runtime with on-the-fly Dynamic Repartitioning.

The job graph is the paper's canonical stateful pipeline::

    source -> map -> [shuffle by key] -> stateful reduce (keyed state)

Per micro-batch the runtime runs the shuffle step (which also emits the
DRW histograms and global loads), folds the received records into the keyed
state, then gives the DR master a safe point: telemetry snapshots into a
``Signals`` record, ``DRMaster.evaluate`` runs the policy stack, and a taken
``Repartition`` migrates the keyed state through the same exchange before
the next batch.

A port of ``repro.core.streaming.StreamingJob``'s serial driver.  The W
workers are stacked on one device (``num_workers``, default 1 — what the
reference's default mesh gives on one device).  ``overlap_exchange`` is
accepted and runs serially: the reference's overlapped driver is
bit-identical to its serial one by construction.  Elastic resize, hot-key
splitting, backend switching, lane health, depth-2 staging and zero-loss
recovery are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.compat import host_fetch, resolve_device, safe_point
from repro_torch.control import NoOp, Repartition, Telemetry
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.hashing import DEFAULT_NUM_HOSTS, KEY_SENTINEL
from repro_torch.core.migration import migration_capacity, plan_migration
from repro_torch.core.partitioner import Partitioner, heavy_capacity_for, uniform_partitioner
from repro_torch.core.shuffle import (
    make_migrate_step,
    make_shuffle_step,
    migrate_stats,
    shuffle_stats,
)
from repro_torch.core.state import empty_state, merge_into, state_size
from repro_torch.exchange import ExchangeSpec, ExchangeStats, resolve_backend
from repro_torch.exchange.spec import DISTANCE_CLASSES

__all__ = ["BatchMetrics", "StreamingJob"]

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
    state_rows: int
    wall_time_s: float
    reason: str
    migration_rows: int = 0     # rows of all-to-all buffer a repartition exchanged
    resized: bool = False       # always False: elastic resize is not ported yet
    num_partitions: int = 0     # topology after this batch
    migration_plan_rows: int = 0  # migration_capacity() of the plan (pre-pow2)
    action: str = "noop"        # control-plane action kind this safe point took
    shipped_rows: int = 0       # rows the backend moved this batch (per worker)
    padded_rows: int = 0        # rows the specs provisioned (per worker)
    backend: str = "dense"      # exchange backend the batch ran on
    exchange_wall_s: float = 0.0  # wall blocking on the shuffle exchange path
    overlapped: bool = False    # always False: the port runs the serial driver
    pipelined: bool = False     # always False: depth-2 staging is not ported
    overlap_fraction: float = 0.0
    split_keys: int = 0         # hot keys replicated after this safe point
    shipped_rows_by_class: tuple = (0, 0, 0)  # zeros: flat exchange
    lanes: int = 0              # live workers after this batch


class StreamingJob:
    """Long-running stateful streaming job with DR, on ``num_workers``
    stacked workers of one device.

    ``device=None`` is the CUDA device and raises when there is none;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    ``payload_dim`` is the record payload width (the reduce is a per-key
    vector sum — the word-count family of stateful operators).
    """

    def __init__(
        self,
        *,
        num_partitions: int | None = None,
        num_workers: int = 1,
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
    ):
        self.device = resolve_device(device)
        if topology is not None:
            raise NotImplementedError(
                "ExchangeTopology is not ported yet (ROADMAP.md, queue 1 item 4)")
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
        cfg = dr or DRConfig()
        heavy_cap = heavy_capacity_for(cfg.lam, self.num_partitions)
        part = initial or uniform_partitioner(
            self.num_partitions, DEFAULT_NUM_HOSTS, seed, heavy_capacity=heavy_cap)
        self.drm = DRMaster(part, cfg, exchange_backend=self.exchange_backend)
        self.telemetry = Telemetry("stream")
        self._shuffle = None
        self._shuffle_sig = None    # (capacity, num_partitions) the step was built for
        self._shuffle_spec: ExchangeSpec | None = None
        self._migrate_steps: dict[int, object] = {}  # lane capacity -> step
        self.state_keys, self.state_vals = empty_state(
            state_capacity, payload_dim, num_workers=self.num_workers, device=self.device)
        self.metrics: list[BatchMetrics] = []

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
                                          axis="data")
        self._shuffle = make_shuffle_step(
            num_workers=self.num_workers, num_partitions=self.num_partitions,
            capacity=cap, hist_k=self.hist_k,
            num_hosts=self.drm.partitioner.num_hosts, seed=self.seed,
            backend=self.exchange_backend)

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
                spec=ExchangeSpec(num_lanes=self.num_workers, capacity=cap, axis="data"),
                backend=self.exchange_backend)
        return self._migrate_steps[cap], cap

    def _tensor(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).reshape(self.num_workers, -1,
                                                       *a.shape[1:]).to(self.device)

    # ------------------------------------------------------------------
    def process_batch(self, keys: np.ndarray, values: np.ndarray | None = None) -> BatchMetrics:
        """Run one micro-batch through shuffle + stateful reduce + DR.

        The batch is padded with sentinel keys to a multiple of
        ``num_workers`` and worker ``i`` takes the ``i``-th contiguous
        chunk, as ``shard_map`` splits it in the reference."""
        t0 = time.perf_counter()
        n = len(keys)
        w = self.num_workers
        local_n = int(np.ceil(n / w))
        pad = local_n * w - n
        keys = np.concatenate([keys, np.full(pad, _SENT, np.int64)]).astype(np.int32)
        if values is None:
            values = np.ones((len(keys), self.payload_dim), np.float32)
        else:
            values = np.concatenate(
                [values, np.zeros((pad,) + values.shape[1:], np.float32)])
        valid = keys != _SENT
        self._build(local_n * w)
        batch_backend = self.exchange_backend.name

        t_ex = time.perf_counter()
        res = self._shuffle(
            self.drm.partitioner.tables(self.device), self._tensor(keys, torch.int32),
            self._tensor(values, torch.float32), self._tensor(valid, torch.bool))
        # stateful reduce: fold received records into per-worker state
        self.state_keys, self.state_vals, _ = merge_into(
            self.state_keys, self.state_vals, res.keys, res.values, res.valid)
        with safe_point():
            loads = host_fetch(res.loads)  # forces the batch's device work
        exchange_wall = time.perf_counter() - t_ex

        with safe_point():
            stats = shuffle_stats(res, self._shuffle_spec, w, wall_s=exchange_wall)
            shuffle_shipped = int(stats.rows)
            overflow_i = int(host_fetch(res.overflow))
            self.telemetry.record_exchange(stats)
            self.telemetry.record_overflow(shuffle=overflow_i)
            self.telemetry.record_batch(float(loads.sum()))
            self.drm.observe(host_fetch(res.hist_keys), host_fetch(res.hist_counts),
                             total_records=float(loads.sum()))
        at_checkpoint = (len(self.metrics) + 1) % self.checkpoint_interval == 0
        signals = self.telemetry.snapshot(
            loads=loads, num_workers=w, state_rows=self._state_rows(),
            at_safe_point=at_checkpoint)
        action = self.drm.evaluate(signals, policies_enabled=self.dr_enabled)

        # execute the action (state only moves here, at the safe point)
        rel_mig, mig_overflow, mig_rows, plan_rows, mig_shipped, mig_moved = (
            0.0, 0, 0, 0, 0, 0)
        if isinstance(action, Repartition):
            (rel_mig, mig_overflow, mig_rows, plan_rows, mig_shipped,
             mig_moved) = self._migrate_state(action.prev)
        elif not isinstance(action, NoOp):
            raise NotImplementedError(
                f"executing a {action.kind} action is not ported yet "
                "(ROADMAP.md, queue 1 item 7)")
        if mig_rows:
            self.telemetry.record_exchange(migrate_stats(
                shipped_rows=mig_shipped * w,  # helper re-divides per worker
                buffer_rows=mig_rows, moved_rows=mig_moved,
                overflow=mig_overflow, num_workers=w))
            self.telemetry.record_overflow(migration=mig_overflow)

        m = BatchMetrics(
            batch=len(self.metrics),
            imbalance=signals.imbalance,
            worker_imbalance=signals.worker_imbalance,
            repartitioned=action.taken and action.moves_state,
            relative_migration=rel_mig,
            overflow=overflow_i + mig_overflow,
            state_rows=(signals.state_rows if isinstance(action, NoOp)
                        else self._state_rows()),
            wall_time_s=time.perf_counter() - t0,
            reason=action.reason,
            migration_rows=mig_rows,
            num_partitions=self.num_partitions,
            migration_plan_rows=plan_rows,
            action=action.kind,
            shipped_rows=shuffle_shipped + mig_shipped,
            padded_rows=self._shuffle_spec.rows + mig_rows,
            backend=batch_backend,
            exchange_wall_s=exchange_wall,
            overlap_fraction=0.0,  # serial: nothing hidden
            split_keys=len(self.drm.split_keys),
            shipped_rows_by_class=(0,) * DISTANCE_CLASSES,
            lanes=self.num_workers,
        )
        self.metrics.append(m)
        return m

    def _state_rows(self) -> int:
        """Live keyed-state rows across all workers."""
        with safe_point():
            return int(host_fetch(state_size(self.state_keys)).sum())

    def _migrate_state(self, old_part: Partitioner):
        """Ship keyed state to where ``self.drm.partitioner`` now maps it.

        Plans on the host (``plan_migration`` over the live keys), sizes the
        exchange lanes from the plan, and folds the received rows back into
        the kept state.  Returns ``(relative_migration, overflow,
        buffer_rows, planned_lane_rows, shipped_rows per worker,
        moved_rows)``."""
        with safe_point():
            sk = host_fetch(self.state_keys).reshape(-1)
        live = sk[sk != _SENT].astype(np.int64)
        plan = plan_migration(old_part, self.drm.partitioner, live)
        plan_rows = migration_capacity(plan, num_workers=self.num_workers)
        migrate, lane_cap = self._migrate_step(plan_rows)
        out = migrate(self.drm.partitioner.tables(self.device),
                      self.state_keys, self.state_vals)
        kept_keys = torch.where(out.kept_valid, out.kept_keys, _SENT)
        self.state_keys, self.state_vals, _ = merge_into(
            kept_keys, out.kept_vals, out.recv_keys, out.recv_vals, out.recv_valid)
        with safe_point():
            moved_i = int(host_fetch(out.moved))
            total_i = int(host_fetch(out.total))
            mig_shipped_i = int(host_fetch(out.shipped_rows))
            mig_ov_i = int(host_fetch(out.overflow))
            lane_ov = host_fetch(out.lane_overflow)
        rel_mig = float(moved_i) / max(float(total_i), 1e-9)
        mig_rows = self.num_workers * lane_cap  # rows received per worker
        self.telemetry.record_exchange(ExchangeStats(rows=0, lane_overflow=lane_ov))
        return (rel_mig, mig_ov_i, mig_rows, plan_rows,
                mig_shipped_i // self.num_workers, moved_i)

    # ------------------------------------------------------------------
    def run(self, batches: Iterable[np.ndarray]) -> list[BatchMetrics]:
        return [self.process_batch(b) for b in batches]

    def resize(self, num_partitions: int) -> None:
        raise NotImplementedError(
            "elastic resize is not ported yet (ROADMAP.md, queue 1 item 6)")

    def _recover_from_loss(self, loss) -> str:
        raise NotImplementedError(
            "zero-loss recovery from a lost worker is not ported yet "
            "(ROADMAP.md, queue 1 item 7)")

    # -- state inspection ----------------------------------------------
    def state_count(self, key: int) -> float:
        """Total aggregated value for one key across all workers (test hook)."""
        with safe_point():
            hit = self.state_keys == int(key)
            return float(host_fetch(self.state_vals[hit].sum()))

    # -- checkpoint / restore --------------------------------------------
    def snapshot(self) -> dict:
        """State tables plus the DRM snapshot under ``drm_`` — the keys of the
        reference's ``StreamingJob.snapshot`` (flat, same worker count)."""
        with safe_point():
            return {
                "state_keys": host_fetch(self.state_keys),
                "state_vals": host_fetch(self.state_vals),
                **{f"drm_{k}": v for k, v in self.drm.snapshot().items()},
            }

    def restore(self, snap: dict) -> None:
        """Resume from a snapshot of the same worker count (either package's).
        The snapshot's transport and partition count win over the ones this
        job was built with."""
        drm_snap = {k[4:]: v for k, v in snap.items() if k.startswith("drm_")}
        snap_keys = np.asarray(snap["state_keys"])
        if snap_keys.shape[0] != self.num_workers:
            raise NotImplementedError(
                f"restoring a {snap_keys.shape[0]}-worker snapshot onto "
                f"{self.num_workers} workers is not ported yet (ROADMAP.md, queue 1 item 7)")
        self.drm = DRMaster.restore(drm_snap, self.drm.config)
        self.state_keys = torch.tensor(snap_keys, dtype=torch.int32, device=self.device)
        self.state_vals = torch.tensor(np.asarray(snap["state_vals"]), dtype=torch.float32,
                                       device=self.device)
        self.state_capacity = int(snap_keys.shape[1])
        self.payload_dim = int(self.state_vals.shape[2])
        self.exchange_backend = self.drm.exchange_backend
        n = self.drm.partitioner.num_partitions
        if n < self.num_workers:
            raise ValueError(f"snapshot has {n} partitions < {self.num_workers} workers")
        self.num_partitions = n
        self._shuffle = None
        self._shuffle_sig = None
        self._migrate_steps.clear()
