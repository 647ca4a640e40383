"""Lane health: the failure-domain view of the control plane.

:class:`LaneHealth` tracks, for each *live* lane, an EWMA of observed
straggle wall and a count of consecutive failed windows — both fed from the
fault evidence the driver records into
:class:`~repro_torch.control.signals.Telemetry` (``record_fault`` ->
``Signals.lane_straggle_s`` / ``lane_retries``) during normal work.

:class:`HealthPolicy` turns that state into typed actions at safe points,
*first* in ``DRMaster.evaluate``'s precedence (a sick lane invalidates
every load-based signal below it):

* :class:`~repro_torch.control.actions.Quarantine` — the circuit breaker
  opens: a lane whose straggle EWMA stays past ``health_straggler_ms`` for
  ``health_patience`` consecutive safe points is folded out of the
  collective (its partitions re-land on the healthy workers through the
  modulo placement), with :class:`~repro_torch.control.policy.CooldownGuard`
  hysteresis on ``health_cooldown`` and the fold priced through
  :func:`~repro_torch.core.migration.exchange_lane_cost`.
* :class:`~repro_torch.control.actions.Evict` — permanent loss: a lane whose
  exchanges keep *failing* (``health_failure_threshold`` consecutive failed
  windows) is removed for good.  A hard loss found by the recovery protocol
  takes this path too, through ``DRMaster.note_lost``.
* :class:`~repro_torch.control.actions.Recover` — the half-open probe:
  after ``health_recover_after`` safe points in quarantine the oldest
  parked lane is re-admitted, priced by the fold-back migration against
  the fraction of a worker regained.

The policy is a stateless evaluator over the host (``DRMaster``), which
carries the :class:`LaneHealth` record and the quarantine ledger; both ride
snapshots, so a restored job resumes the same health view.  A port of
``repro.control.health``: the same state, keys, dtypes and reasons.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.control.actions import Action, Evict, NoOp, Quarantine, Recover
from repro_torch.control.policy import CooldownGuard
from repro_torch.control.signals import Signals
from repro_torch.core.migration import MigrationPlan, exchange_lane_cost

__all__ = ["HealthPolicy", "LaneHealth"]


@dataclasses.dataclass
class LaneHealth:
    """Health state for each live lane (straggle EWMA and failure streaks).

    Indexed by *current* lane position: quarantine and evict drop a row
    (:meth:`drop_lane`), recover appends a fresh one (:meth:`add_lane`) —
    the renumbering the driver's lane list undergoes, so row ``i`` always
    describes live lane ``i``.
    """

    num_lanes: int
    alpha: float = 0.5
    wall_ewma: np.ndarray = None
    failures: np.ndarray = None
    sick_streak: np.ndarray = None

    def __post_init__(self):
        if self.wall_ewma is None:
            self.wall_ewma = np.zeros(self.num_lanes, np.float64)
        if self.failures is None:
            self.failures = np.zeros(self.num_lanes, np.int64)
        if self.sick_streak is None:
            self.sick_streak = np.zeros(self.num_lanes, np.int64)

    def observe(self, signals: Signals) -> None:
        """Fold one window's fault evidence.  A window with no evidence for
        a lane decays its EWMA toward zero (health is earned back) and
        resets its failure streak (failures must be *consecutive*)."""
        straggle = np.zeros(self.num_lanes, np.float64)
        if signals.lane_straggle_s is not None:
            v = np.asarray(signals.lane_straggle_s, np.float64)
            straggle[: min(len(v), self.num_lanes)] = v[: self.num_lanes]
        retries = np.zeros(self.num_lanes, np.int64)
        if signals.lane_retries is not None:
            v = np.asarray(signals.lane_retries, np.int64)
            retries[: min(len(v), self.num_lanes)] = v[: self.num_lanes]
        self.wall_ewma = (1.0 - self.alpha) * self.wall_ewma + self.alpha * straggle
        self.failures = np.where(retries > 0, self.failures + 1, 0)

    def drop_lane(self, lane: int) -> None:
        keep = np.arange(self.num_lanes) != int(lane)
        self.wall_ewma = self.wall_ewma[keep]
        self.failures = self.failures[keep]
        self.sick_streak = self.sick_streak[keep]
        self.num_lanes -= 1

    def add_lane(self) -> None:
        self.wall_ewma = np.append(self.wall_ewma, 0.0)
        self.failures = np.append(self.failures, 0)
        self.sick_streak = np.append(self.sick_streak, 0)
        self.num_lanes += 1

    # -- checkpoint integration ------------------------------------------
    def snapshot(self) -> dict:
        return {
            "health_num_lanes": np.int64(self.num_lanes),
            "health_wall_ewma": np.asarray(self.wall_ewma, np.float64),
            "health_failures": np.asarray(self.failures, np.int64),
            "health_sick_streak": np.asarray(self.sick_streak, np.int64),
        }

    @classmethod
    def restore(cls, snap: dict, alpha: float = 0.5) -> "LaneHealth":
        return cls(
            num_lanes=int(snap["health_num_lanes"]),
            alpha=alpha,
            wall_ewma=np.asarray(snap["health_wall_ewma"], np.float64).copy(),
            failures=np.asarray(snap["health_failures"], np.int64).copy(),
            sick_streak=np.asarray(snap["health_sick_streak"], np.int64).copy(),
        )


def _fold_cost(host, num_workers: int, lane: int) -> float:
    """Price the quarantine fold: the sick lane's fair state share (1/W of
    the mass) spread evenly over the W-1 survivors, costed by the active
    transport's sizing rule and the host's lane topology
    (``exchange_lane_cost``; partition-level lanes, as in the reference: no
    ``num_workers``)."""
    w = int(num_workers)
    if w <= 1:
        return 0.0
    transfer = np.zeros((w, w))
    transfer[lane, :] = (1.0 / w) / (w - 1)
    transfer[lane, lane] = 0.0
    dst = np.asarray([d for d in range(w) if d != lane], np.int32)
    plan = MigrationPlan(
        keys=np.zeros(w - 1, np.int64),
        src=np.full(w - 1, lane, np.int32),
        dst=dst,
        weights=np.full(w - 1, (1.0 / w) / (w - 1)),
        transfer=transfer,
        relative_migration=1.0 / w,
        num_src=w, num_dst=w,
    )
    return exchange_lane_cost(plan, backend=getattr(host, "exchange_backend", None),
                              topology=getattr(host, "exchange_topology", None))


class HealthPolicy:
    """Failure-domain policy over :class:`LaneHealth` (see the module doc)."""

    def evaluate(self, host, signals: Signals) -> Action:
        cfg = host.config
        imb = signals.imbalance
        if not getattr(cfg, "health_enabled", False):
            return NoOp("health-disabled", imb, imb)
        lh = host.lane_health
        if lh is None or lh.num_lanes == 0:
            return NoOp("health-no-telemetry", imb, imb)
        w = max(int(signals.num_workers), 1)
        guard = CooldownGuard(cfg.health_cooldown)

        sick_fail = lh.failures >= cfg.health_failure_threshold
        sick_slow = lh.wall_ewma * 1e3 >= cfg.health_straggler_ms
        sick = sick_fail | sick_slow
        lh.sick_streak = np.where(sick, lh.sick_streak + 1, 0)
        if sick.any():
            # the sickest lane first: hard-failing beats merely slow
            score = (sick_fail.astype(np.float64) * 1e9
                     + lh.failures * 1e6 + lh.wall_ewma * 1e3)
            lane = int(np.argmax(np.where(sick, score, -1.0)))
            streak = int(lh.sick_streak[lane])
            if streak < cfg.health_patience:
                return NoOp(f"health-patience {streak}/{cfg.health_patience}", imb, imb)
            if not guard.ready(host.batches_seen, host.last_health_action):
                return NoOp("health-cooldown", imb, imb)
            if w <= 1:
                # the last lane cannot fold anywhere: the recovery protocol
                # (restore and replay in place) is the only move
                return NoOp("health-single-worker", imb, imb)
            failures = int(lh.failures[lane])
            if sick_fail[lane]:
                return Evict(
                    reason=(f"evict lane {lane}: {failures} consecutive "
                            f"failed windows (>= "
                            f"{cfg.health_failure_threshold})"),
                    lane=lane, failures=failures)
            straggle_ms = float(lh.wall_ewma[lane] * 1e3)
            return Quarantine(
                reason=(f"quarantine lane {lane}: straggle EWMA "
                        f"{straggle_ms:.1f}ms >= "
                        f"{cfg.health_straggler_ms:.1f}ms"),
                lane=lane, straggle_ms=straggle_ms, failures=failures,
                est_migration=_fold_cost(host, w, lane))

        # the circuit breaker half-open: probe the oldest quarantined lane
        if host.quarantined and cfg.health_recover_after > 0:
            lane_label, since = host.quarantined[0]
            waited = host.batches_seen - int(since)
            if waited < cfg.health_recover_after:
                return NoOp(f"health-probe-timer {waited}/{cfg.health_recover_after}",
                            imb, imb)
            if not guard.ready(host.batches_seen, host.last_health_action):
                return NoOp("health-cooldown", imb, imb)
            # priced re-admission: the fold-back ships the lane's fair share
            # (1/(W+1) of the mass) and regains one worker's fraction of the
            # capacity; decline when the move costs more than that relief
            est = cfg.migration_cost_weight * _fold_cost(host, w + 1, w)
            relief = 1.0 / (w + 1)
            if est > relief:
                return NoOp(f"health-recover-cost {est:.3f}>{relief:.3f}", imb, imb)
            return Recover(
                reason=(f"recover lane {lane_label} after {waited} "
                        f"quarantined safe points"),
                lane=int(lane_label), est_migration=est)
        return NoOp("health-ok", imb, imb)
