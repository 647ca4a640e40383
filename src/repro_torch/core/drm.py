"""Dynamic Repartitioning Master — host of the control-plane policy stack.

Lives in the driver process.  Per safe point it

1. merges the DRW local histograms into the global counter sketch,
2. runs the policy stack over the window's
   :class:`~repro_torch.control.Signals` (``evaluate``) in the reference's
   precedence — an explicit resize request, then health, resize, split,
   repartition, backend — and
3. records every decision, declined ones included, in the
   :class:`~repro_torch.control.DecisionLog`, installing a taken
   repartition, split, unsplit or backend switch and handing every taken
   action back to the driver to execute at the safe point (a resize
   re-plans through :meth:`DRMaster.replan_resize`).

A port of ``repro.core.drm``: every ``DRConfig`` field and its validation
are copied, and so is the failure-domain state (the :class:`LaneHealth`
record, the quarantine ledger, :meth:`DRMaster.note_lost`).  Snapshots
carry the reference's keys, so they round-trip between the packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.control.actions import (
    Action,
    Evict,
    NoOp,
    Quarantine,
    Recover,
    Repartition,
    Resize,
    Split,
    SwitchBackend,
    Unsplit,
)
from repro_torch.control.health import HealthPolicy, LaneHealth
from repro_torch.control.log import DecisionLog
from repro_torch.control.policy import (
    BackendPolicy,
    RepartitionPolicy,
    ResizePolicy,
    SplitPolicy,
)
from repro_torch.control.signals import Signals
from repro_torch.core.histogram import CounterSketch
from repro_torch.core.partitioner import Partitioner, heavy_capacity_for, resize_partitioner
from repro_torch.exchange.backends import resolve_backend
from repro_torch.exchange.spec import ExchangeTopology

__all__ = ["DRConfig", "DRDecision", "DRMaster"]


@dataclasses.dataclass(frozen=True)
class DRConfig:
    """Control-plane configuration for the DR module (one frozen record).

    Most fields tune one policy each (see the inline comments); the
    exchange-pipeline knobs interact and deserve spelling out:

    * ``overlap_exchange`` (default on) — the streaming driver issues batch
      N+1's route/count phase before batch N's row ship drains (pipeline
      depth 1 of latency hiding).  Bit-identical to the serial driver by
      construction.
    * ``pipeline_depth`` — ``1`` keeps the ship-behind-host-work overlap;
      ``2`` additionally pre-routes batch N+1 (route -> bucketize -> start)
      before batch N's decision section runs, so the device pipeline holds
      two in-flight stages and the per-batch start sync costs ~nothing.
      Any taken control action first drains *both* stages and replays the
      pre-routed batch under the new partitioner, so trajectories stay
      bit-identical to serial.  Values outside ``{1, 2}`` raise
      ``ValueError`` at construction.  Depth 2 engages only in
      ``StreamingJob.run`` (the driver needs one batch of lookahead);
      direct ``process_batch`` calls degrade gracefully to depth 1.
    * ``split_least_load`` — replica pick for split hot keys: off (default)
      every route uses the stateless fmix32 offset; on, the lower-loaded of
      two hashed replica candidates, by the previous batch's loads.

    Every field and its validation are the reference's.
    """

    lam: float = 2.0                 # histogram scale factor: B = lam * N
    eps: float = 0.01                # KIP load slack
    ewma_alpha: float = 0.5          # weight of the newest histogram
    sketch_capacity: int = 512       # DRM counter sketch size
    sketch_decay: float = 0.9
    imbalance_trigger: float = 1.2   # repartition when measured imb exceeds
    migration_cost_weight: float = 1.0  # batches of gain a migration must pay for
    min_batches_between: int = 1     # safe-point spacing (1 = every boundary)
    mode: str = "stream"             # "stream" | "batch" (replay-once)
    tight: bool = True               # waterfilled host re-binning (beyond-paper;
                                     # False = faithful Algorithm 1 packing)
    # -- elastic resize: grow/shrink the partition (logical worker) count --
    elastic: bool = False            # let the DRM decide to resize
    min_partitions: int = 1          # shrink floor (also floored at num_workers)
    max_partitions: int = 256        # grow ceiling
    grow_trigger: float = 1.5        # sustained imbalance above this => grow
    shrink_trigger: float = 1.05     # sustained imbalance below this => shrink
    resize_patience: int = 2         # consecutive safe points before acting
    resize_factor: int = 2           # grow/shrink multiplies/divides by this
    # -- control-plane hysteresis + capacity-target signal -----------------
    resize_cooldown: int = 0         # min safe points between resizes (0 = off);
                                     # the oscillation guard on top of patience
    target_throughput: float = 0.0   # per-worker records/s capacity target;
                                     # sustained below => shrink even if the
                                     # imbalance sits in the trigger dead zone
    # -- exchange-transport actuator (dense <-> ragged auto-selection) -----
    auto_backend: bool = False       # let the BackendPolicy flip the transport
    backend_ragged_below: float = 0.5  # dense -> ragged when the padding
                                     # fraction stays below this
    backend_dense_above: float = 0.9 # ragged -> dense when it stays above
                                     # (the gap between the two is the dead
                                     # zone that stops threshold straddling)
    backend_patience: int = 2        # consecutive safe points before flipping
    backend_cooldown: int = 0        # min safe points between flips (0 = off)
    # -- hot-key splitting (Partial-Key-Grouping as a control action) ------
    split_keys_enabled: bool = False # let the SplitPolicy replicate hot keys
    split_max_replicas: int = 8      # fan-out ceiling per split key
    split_trigger: float = 1.3       # split when the top key's share alone
                                     # exceeds this many worker fair budgets
    unsplit_trigger: float = 0.8     # collapse a split key cooled below this
                                     # (the gap to split_trigger is the dead
                                     # zone that stops split/unsplit churn)
    split_patience: int = 2          # consecutive safe points before acting
    split_cooldown: int = 0          # min safe points between split actions
    # -- split-phase exchange overlap --------------------------------------
    overlap_exchange: bool = True    # issue batch N+1's route/count phase
                                     # before batch N's row ship drains
                                     # (bit-identical to serial; the
                                     # port runs the serial driver)
    pipeline_depth: int = 1          # 1 = ship-behind-host-work overlap;
                                     # 2 = additionally pre-route batch N+1
                                     # before batch N's decision section
                                     # (see the class docstring)
    split_least_load: bool = False   # two-choice least-load replica pick
                                     # for split hot keys
    # -- failure domains: auto-snapshots, replay, lane health --------------
    snapshot_interval: int = 0       # auto-snapshot every N batches (0 = off);
                                     # also bounds the zero-loss replay
                                     # buffer — a worker loss restores the
                                     # last snapshot and replays at most
                                     # this many batches
    health_enabled: bool = False     # let the HealthPolicy act on per-lane
                                     # straggle/failure evidence
    health_straggler_ms: float = 50.0  # quarantine when a lane's straggle
                                     # EWMA stays past this many ms
    health_failure_threshold: int = 3  # evict after this many *consecutive*
                                     # failed windows on one lane
    health_patience: int = 2         # consecutive sick safe points before
                                     # a health action may fire
    health_cooldown: int = 0         # min safe points between health
                                     # actions (0 = off)
    health_recover_after: int = 0    # probe (re-admit) a quarantined lane
                                     # after this many safe points
                                     # (0 = never re-admit)

    def __post_init__(self):
        if self.pipeline_depth not in (1, 2):
            raise ValueError(
                f"pipeline_depth must be 1 (ship-behind-host-work overlap) or "
                f"2 (batch-ahead route), got {self.pipeline_depth!r}"
            )
        # knob relationships are validated unconditionally — a config whose
        # dead zones are inverted is wrong even while its feature flag is off
        if self.grow_trigger <= self.shrink_trigger:
            raise ValueError(
                "elastic resize needs a trigger-gap dead zone: "
                f"grow_trigger {self.grow_trigger} <= shrink_trigger "
                f"{self.shrink_trigger}"
            )
        if self.backend_ragged_below >= self.backend_dense_above:
            raise ValueError(
                "backend auto-selection needs a threshold dead zone: "
                f"backend_ragged_below {self.backend_ragged_below} >= "
                f"backend_dense_above {self.backend_dense_above}"
            )
        if self.split_trigger <= self.unsplit_trigger:
            raise ValueError(
                "hot-key splitting needs a trigger-gap dead zone: "
                f"split_trigger {self.split_trigger} <= "
                f"unsplit_trigger {self.unsplit_trigger}"
            )
        for knob in ("min_batches_between", "resize_patience",
                     "resize_cooldown", "backend_patience",
                     "backend_cooldown", "split_patience", "split_cooldown",
                     "snapshot_interval", "health_patience",
                     "health_cooldown", "health_recover_after",
                     "health_straggler_ms", "target_throughput"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob} must be >= 0, got {getattr(self, knob)!r}")
        if self.health_failure_threshold < 1:
            raise ValueError(
                "health_failure_threshold must be >= 1 (0 would evict a "
                f"healthy lane), got {self.health_failure_threshold!r}")



@dataclasses.dataclass(frozen=True)
class DRDecision:
    repartition: bool
    partitioner: Partitioner
    planned_imbalance: float
    measured_imbalance: float
    est_migration: float
    reason: str


class DRMaster:
    def __init__(self, initial: Partitioner, config: DRConfig = DRConfig(),
                 *, consumer: str = "stream", exchange_backend=None,
                 exchange_topology: ExchangeTopology | None = None):
        self.config = config
        self.partitioner = initial
        # the transport the hosted runtime exchanges through — its sizing
        # rule prices candidate migration plans.  None = dense.
        self.exchange_backend = resolve_backend(exchange_backend)
        # the lanes' locality: with it, plan pricing weighs each (src, dst)
        # cell by distance class (exchange_lane_cost's topology).  None is
        # the flat world, every lane priced alike
        self.exchange_topology = exchange_topology
        self.sketch = CounterSketch(config.sketch_capacity, decay=config.sketch_decay)
        self.batches_seen = 0
        self.last_repartition = -(10**9)
        self.last_resize = -(10**9)
        self.last_backend_switch = -(10**9)
        self.history: list[dict] = []
        # elastic resize: consecutive safe points the grow / shrink
        # condition has held
        self.grow_streak = 0
        self.shrink_streak = 0
        # the backend policy's patience streak (its cooldown stamp is
        # last_backend_switch)
        self.backend_streak = 0
        # hot-key splitting: the installed replica map (key -> d), stamped
        # onto every partitioner this master installs, the split policy's
        # patience streak and its cooldown stamp
        self.split_keys: dict[int, int] = dict(initial.split_map())
        self.split_streak = 0
        self.last_split = -(10**9)
        # failure domains: the health of each live lane (built lazily at the
        # first safe point's worker count), the quarantine ledger — (lane
        # label, tick quarantined), oldest first — and the health cooldown
        self.lane_health: LaneHealth | None = None
        self.quarantined: list[tuple[int, int]] = []
        self.last_health_action = -(10**9)
        self.repartition_policy = RepartitionPolicy()
        self.resize_policy = ResizePolicy()
        self.backend_policy = BackendPolicy()
        self.split_policy = SplitPolicy()
        self.health_policy = HealthPolicy()
        self.decisions = DecisionLog(consumer)

    # -- DRW ingestion ------------------------------------------------------
    def observe(self, hist_keys: np.ndarray, hist_counts: np.ndarray,
                total_records: float | None = None) -> None:
        """Merge stacked worker histograms [W, K] into the DRM sketch.

        ``total_records`` is the true number of records the workers saw
        (top-k summaries undercount the tail mass)."""
        k = np.asarray(hist_keys).reshape(-1)
        c = np.asarray(hist_counts).reshape(-1).astype(np.float64)
        m = (k >= 0) & (c > 0)
        if m.any():
            keys, inv = np.unique(k[m], return_inverse=True)
            counts = np.zeros(len(keys))
            np.add.at(counts, inv, c[m])
            self.sketch.update_counts(keys.astype(np.int64), counts, total=total_records)

    # -- the one safe-point entry -------------------------------------------
    def evaluate(self, signals: Signals, *, requested_resize: int | None = None,
                 policies_enabled: bool = True) -> Action:
        """Run the policy stack over one safe point's signals, in the
        reference's precedence: an explicit resize request wins, then the
        health, resize, split, repartition and backend policies (the last
        only when nothing structural fired).  A taken repartition, split,
        unsplit or backend switch is installed here; a taken resize is
        returned for the driver to execute (:meth:`replan_resize`), and so
        are an unsplit's merging migration and a switch's step rebuild.
        Every safe-point outcome lands in :attr:`decisions`."""
        n = self.partitioner.num_partitions
        detail: dict = {}
        if not signals.at_safe_point:
            return NoOp("not-checkpoint-tick", signals.imbalance)
        if requested_resize is not None and int(requested_resize) != n:
            action = Resize(reason=f"resize {n}->{int(requested_resize)}",
                            target=int(requested_resize), requested=True)
        elif not policies_enabled:
            action = NoOp("dr-disabled", signals.imbalance)
        else:
            # failure domains first: a sick lane invalidates every
            # load-based signal the policies below key on
            action = self._evaluate_health(signals, detail)
            if action is None:
                action = self.resize_policy.evaluate(self, signals)
                if isinstance(action, NoOp):
                    if action.reason != "elastic-disabled":
                        detail["resize_declined"] = action.reason
                    action = self.split_policy.evaluate(self, signals)
            if isinstance(action, (Split, Unsplit)):
                self._install_split(action)
            elif isinstance(action, NoOp):
                if action.reason != "split-disabled":
                    detail["split_declined"] = action.reason
                action = self.repartition_policy.evaluate(self, signals)
                if isinstance(action, Repartition):
                    self._install(action)
                elif isinstance(action, NoOp):
                    switch = self.backend_policy.evaluate(self, signals)
                    if isinstance(switch, SwitchBackend):
                        self.note_backend_switch(switch.backend)
                        action = switch
                    elif switch.reason != "auto-backend-disabled":
                        detail["backend_declined"] = switch.reason
        self.decisions.record(action, tick=self.batches_seen,
                              imbalance=signals.imbalance, detail=detail)
        return action

    def _evaluate_health(self, signals: Signals, detail: dict) -> Action | None:
        """Run the failure-domain policy, first in the precedence.  Folds the
        window's fault evidence into :class:`LaneHealth` (built lazily at the
        live worker count, so a restore onto fewer workers starts the view
        afresh) and returns a *taken* health action, bookkept, or ``None``
        to fall through to the load policies."""
        if self.config.health_enabled:
            w = max(int(signals.num_workers), 1)
            if self.lane_health is None or self.lane_health.num_lanes != w:
                self.lane_health = LaneHealth(w, alpha=self.config.ewma_alpha)
            self.lane_health.observe(signals)
        action = self.health_policy.evaluate(self, signals)
        if action.taken:
            self._note_health(action)
            return action
        if action.reason != "health-disabled":
            detail["health_declined"] = action.reason
        return None

    def _note_health(self, action: Action) -> None:
        """Install a taken health action (bookkeeping): it counts as this
        safe point's decision — ``batches_seen`` and ``last_repartition``
        advance as for every state-moving install, and the health cooldown
        starts; the driver removes or re-admits the lane and folds the
        state."""
        self.batches_seen += 1
        self.last_health_action = self.batches_seen
        self.last_repartition = self.batches_seen
        lh = self.lane_health
        if isinstance(action, Quarantine):
            self.quarantined.append((int(action.lane), self.batches_seen))
            if lh is not None and int(action.lane) < lh.num_lanes:
                lh.drop_lane(int(action.lane))
        elif isinstance(action, Evict):
            if lh is not None and 0 <= int(action.lane) < lh.num_lanes:
                lh.drop_lane(int(action.lane))
        elif isinstance(action, Recover):
            if self.quarantined:
                self.quarantined.pop(0)
            if lh is not None:
                lh.add_lane()
        self.history.append({
            "batch": self.batches_seen,
            "health": (action.kind, int(getattr(action, "lane", -1))),
            "reason": action.reason,
        })

    def note_lost(self, lane: int, *, reason: str) -> None:
        """Record a hard worker loss the recovery protocol found, as a
        forced :class:`Evict` in the decision log.  ``lane`` is the lost
        lane's *original* label (the live workers no longer include it), so
        the health view, indexed by the lost layout, is dropped; the next
        safe point rebuilds it at the surviving width."""
        action = Evict(reason=reason, lane=int(lane))
        self.lane_health = None
        self._note_health(action)
        self.decisions.record(action, tick=self.batches_seen, imbalance=1.0,
                              detail={"forced": "worker-lost"})

    def _install(self, action: Repartition) -> None:
        """Swap in a taken repartition at the safe point (DRM bookkeeping)."""
        self.partitioner = action.partitioner
        if self.split_keys:
            self.partitioner = self.partitioner.with_splits(self.split_keys)
        self.last_repartition = self.batches_seen
        d = DRDecision(True, action.partitioner, action.planned_imbalance,
                       action.measured_imbalance, action.est_migration, "repartition")
        self.history.append(dataclasses.asdict(d) | {"batch": self.batches_seen})

    def _install_split(self, action: Split | Unsplit) -> None:
        """Install a taken split or unsplit at the safe point (DR master
        bookkeeping): it counts as this safe point's decision and re-stamps
        the replica table.  A :class:`Split` moves no state (routing fans
        out from the next batch); an :class:`Unsplit` drops the key here and
        the driver runs the home-routed migration off ``action.prev`` that
        merges the partials, so it stamps ``last_repartition`` too."""
        self.batches_seen += 1
        if isinstance(action, Split):
            self.split_keys[int(action.key)] = int(action.replicas)
        else:
            self.split_keys.pop(int(action.key), None)
            self.last_repartition = self.batches_seen
        self.partitioner = self.partitioner.with_splits(self.split_keys)
        self.last_split = self.batches_seen
        self.split_streak = 0
        self.history.append({
            "batch": self.batches_seen,
            "split": (action.kind, int(action.key), int(getattr(action, "replicas", 1))),
            "reason": action.reason,
        })

    def _as_decision(self, action: Action) -> DRDecision:
        if isinstance(action, Repartition):
            return DRDecision(True, action.partitioner, action.planned_imbalance,
                              action.measured_imbalance, action.est_migration,
                              "repartition")
        if not isinstance(action, NoOp):
            raise TypeError(f"no DRDecision for a {action.kind} action")
        return DRDecision(False, self.partitioner, action.planned_imbalance,
                          action.measured_imbalance, action.est_migration, action.reason)

    def decide(self, loads: np.ndarray, state_rows: float = 0.0) -> DRDecision:
        """Run only the repartition policy on measured per-partition loads,
        installing and logging its decision (the reference's deprecated
        pre-control-plane wrapper; :meth:`evaluate` is the safe-point API)."""
        signals = Signals(loads=np.asarray(loads, np.float64), state_rows=int(state_rows))
        action = self.repartition_policy.evaluate(self, signals)
        if isinstance(action, Repartition):
            self._install(action)
        self.decisions.record(action, tick=self.batches_seen, imbalance=signals.imbalance)
        return self._as_decision(action)

    def decide_resize(self, loads: np.ndarray, *, num_workers: int = 1) -> int | None:
        """Run only the elastic resize policy: the new partition count, or
        ``None`` to keep the topology.  No decision is logged (the
        reference's pre-control-plane wrapper; :meth:`evaluate` is the
        safe-point API)."""
        signals = Signals(loads=np.asarray(loads, np.float64), num_workers=num_workers)
        action = self.resize_policy.evaluate(self, signals)
        return action.target if isinstance(action, Resize) else None

    def replan_resize(self, num_partitions: int) -> Partitioner:
        """Re-plan the partitioner across sizes and install it at a safe
        point.  The sketch is re-warmed first (its ``lam * n`` heavy budget
        changes meaning across the resize), the heavy table is sized for the
        new topology, installed splits survive with each fan-out clamped to
        the new count (a shrink may fold one to 1, dropping the key), and
        the swap is recorded by :meth:`note_resize`."""
        cfg = self.config
        n = int(num_partitions)
        self.sketch.rescale()
        hist = self.sketch.histogram(top_b=int(np.ceil(cfg.lam * n)))
        new = resize_partitioner(self.partitioner, n, hist, eps=cfg.eps,
                                 heavy_capacity=heavy_capacity_for(cfg.lam, n),
                                 tight=cfg.tight)
        if self.split_keys:
            new = new.with_splits(self.split_keys)
            self.split_keys = dict(new.split_map())
        self.note_resize(new)
        return new

    def note_backend_switch(self, backend) -> None:
        """Install a taken backend switch (bookkeeping): the master's own
        transport flips at once, so plan pricing (``exchange_lane_cost``)
        follows the transport the job is about to run, and the cooldown
        stamp starts; the driver rebuilds its steps (state never moves)."""
        old = self.exchange_backend.name
        self.exchange_backend = resolve_backend(backend)
        self.last_backend_switch = self.batches_seen
        self.backend_streak = 0
        self.history.append({
            "batch": self.batches_seen,
            "backend": (old, self.exchange_backend.name),
            "reason": f"backend {old}->{self.exchange_backend.name}",
        })

    def note_resize(self, new: Partitioner) -> None:
        """Install a resized partitioner at a safe point (bookkeeping): it
        counts as this safe point's decision (``batches_seen`` and
        ``last_repartition`` advance, so the safe-point spacing applies),
        and ``last_resize`` is stamped for the cooldown guard."""
        old_n = self.partitioner.num_partitions
        self.batches_seen += 1
        self.partitioner = new
        self.last_repartition = self.batches_seen
        self.last_resize = self.batches_seen
        self.grow_streak = self.shrink_streak = 0
        self.history.append({
            "batch": self.batches_seen,
            "resize": (old_n, new.num_partitions),
            "reason": f"resize {old_n}->{new.num_partitions}",
        })

    # -- checkpoint integration ----------------------------------------------
    def snapshot(self) -> dict:
        """The reference's DRM snapshot keys.  The topology's three keys ride
        only when a topology is set, and the failure-domain keys only while
        the health layer is live, so a legacy snapshot stays byte-stable."""
        p = self.partitioner
        split_items = sorted(self.split_keys.items())
        return {
            "num_partitions": p.num_partitions,
            "heavy_keys": p.heavy_keys,
            "heavy_parts": p.heavy_parts,
            "host_to_part": p.host_to_part,
            "seed": p.seed,
            "heavy_repl": (p.heavy_repl if p.heavy_repl is not None
                           else np.ones(p.heavy_keys.shape[0], np.int32)),
            "split_keys": np.asarray([k for k, _ in split_items], np.int64),
            "split_repl": np.asarray([d for _, d in split_items], np.int64),
            "last_split": np.int64(self.last_split),
            "split_streak": np.int64(self.split_streak),
            # copies: the sketch decays its counts in place, which would
            # otherwise rewrite a snapshot kept while the job runs on
            "sketch_keys": self.sketch._keys.copy(),
            "sketch_counts": self.sketch._counts.copy(),
            "sketch_floor": np.float64(self.sketch._floor),
            "sketch_total": np.float64(self.sketch.total),
            "batches_seen": np.int64(self.batches_seen),
            "last_repartition": np.int64(self.last_repartition),
            "last_resize": np.int64(self.last_resize),
            "grow_streak": np.int64(self.grow_streak),
            "shrink_streak": np.int64(self.shrink_streak),
            "last_backend_switch": np.int64(self.last_backend_switch),
            "backend_streak": np.int64(self.backend_streak),
            "exchange_backend": np.str_(self.exchange_backend.name),
            **({
                "topology_lanes_per_host": np.int64(self.exchange_topology.lanes_per_host),
                "topology_num_lanes": np.int64(self.exchange_topology.num_lanes),
                "topology_class_weights": np.asarray(self.exchange_topology.class_weights,
                                                     np.float64),
            } if self.exchange_topology is not None else {}),
            **(self.lane_health.snapshot() if self.lane_health is not None else {}),
            **({
                "quarantined_lane": np.asarray([l for l, _ in self.quarantined], np.int64),
                "quarantined_tick": np.asarray([t for _, t in self.quarantined], np.int64),
                "last_health_action": np.int64(self.last_health_action),
            } if (self.quarantined or self.lane_health is not None) else {}),
            **self.decisions.to_arrays(),
        }

    @classmethod
    def restore(cls, snap: dict, config: DRConfig = DRConfig()) -> "DRMaster":
        """Rebuild a master from a snapshot of either package (a topology
        without its weights takes the default ``(0.0, 1.0, 10.0)``)."""
        p = Partitioner(
            int(snap["num_partitions"]),
            np.asarray(snap["heavy_keys"]),
            np.asarray(snap["heavy_parts"]),
            np.asarray(snap["host_to_part"]),
            int(snap["seed"]),
            heavy_repl=(np.asarray(snap["heavy_repl"], np.int32)
                        if "heavy_repl" in snap else None),
        )
        topo = None
        if "topology_lanes_per_host" in snap:
            topo = ExchangeTopology(
                num_lanes=int(snap.get("topology_num_lanes", snap["num_partitions"])),
                lanes_per_host=int(snap["topology_lanes_per_host"]),
                class_weights=tuple(np.asarray(snap["topology_class_weights"], np.float64))
                if "topology_class_weights" in snap else (0.0, 1.0, 10.0))
        drm = cls(p, config, consumer=str(snap.get("decisions_consumer", "stream")),
                  exchange_backend=str(snap["exchange_backend"])
                  if "exchange_backend" in snap else None,
                  exchange_topology=topo)
        drm.sketch._keys = np.array(snap["sketch_keys"])
        drm.sketch._counts = np.array(snap["sketch_counts"], np.float64)
        drm.sketch._floor = float(snap["sketch_floor"])
        drm.sketch.total = float(snap["sketch_total"])
        drm.batches_seen = int(snap["batches_seen"])
        if "last_repartition" in snap:
            drm.last_repartition = int(snap["last_repartition"])
        drm.last_resize = int(snap.get("last_resize", -(10**9)))
        drm.grow_streak = int(snap.get("grow_streak", 0))
        drm.shrink_streak = int(snap.get("shrink_streak", 0))
        drm.last_backend_switch = int(snap.get("last_backend_switch", -(10**9)))
        drm.backend_streak = int(snap.get("backend_streak", 0))
        if "split_keys" in snap:
            drm.split_keys = dict(zip(
                np.asarray(snap["split_keys"]).astype(int).tolist(),
                np.asarray(snap["split_repl"]).astype(int).tolist(),
            ))
        drm.last_split = int(snap.get("last_split", -(10**9)))
        drm.split_streak = int(snap.get("split_streak", 0))
        # failure-domain state (older snapshots predate the health layer)
        if "health_num_lanes" in snap:
            drm.lane_health = LaneHealth.restore(snap, alpha=config.ewma_alpha)
        if "quarantined_lane" in snap:
            drm.quarantined = list(zip(
                np.asarray(snap["quarantined_lane"]).astype(int).tolist(),
                np.asarray(snap["quarantined_tick"]).astype(int).tolist(),
            ))
        drm.last_health_action = int(snap.get("last_health_action", -(10**9)))
        if "decisions_tick" in snap:
            drm.decisions = DecisionLog.from_arrays(snap)
        return drm
