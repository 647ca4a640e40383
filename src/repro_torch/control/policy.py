"""Composable policies: Signals in, typed Actions out.

* :class:`RepartitionPolicy` — the paper's §4 trigger: repartition when the
  measured imbalance exceeds the trigger *and* the balance gain exceeds the
  state-migration cost, estimated with the active exchange backend's
  sizing rule on the candidate plan
  (:func:`repro_torch.core.migration.exchange_lane_cost`).  A port of
  ``repro.control.policy.RepartitionPolicy``, bit for bit.
* :class:`ResizePolicy`, :class:`SplitPolicy`, :class:`BackendPolicy` —
  only their disabled branches are ported: with their ``DRConfig`` flag
  off (the default) each returns its ``NoOp`` reason, exactly as the
  reference does; the enabled policies are not ported yet.

Policies are stateless evaluators over a *host* (``DRMaster``) that
carries the durable decision state (sketch, streaks, last-action ticks).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.control.actions import Action, NoOp, Repartition
from repro_torch.control.signals import Signals
from repro_torch.core.migration import exchange_lane_cost, plan_migration
from repro_torch.core.partitioner import expected_loads, heavy_capacity_for, kip_update

__all__ = [
    "BackendPolicy",
    "CooldownGuard",
    "RepartitionPolicy",
    "ResizePolicy",
    "SplitPolicy",
]


@dataclasses.dataclass(frozen=True)
class CooldownGuard:
    """Hysteresis shared by every state-moving policy: at least ``min_gap``
    safe points must pass since the last action before the next may fire.

    Patience streaks decide *whether* a condition is sustained; the guard
    decides whether acting on it is *allowed yet*.  A declined action keeps
    its streak, so once the cooldown expires a still-sustained condition
    fires immediately.  ``min_gap=0`` disables the guard (the pre-control-
    plane behavior)."""

    min_gap: int = 0

    def ready(self, tick: int, last_action_tick: int) -> bool:
        return self.min_gap <= 0 or (tick - last_action_tick) >= self.min_gap


class RepartitionPolicy:
    """§4 trigger + exchange-lane-costed migration gate (see module doc)."""

    def evaluate(self, host, signals: Signals) -> Action:
        """One safe-point decision.  Mirrors the DRM bookkeeping exactly:
        advances ``host.batches_seen`` whether or not anything fires, so the
        safe-point spacing rule counts every safe point."""
        cfg = host.config
        host.batches_seen += 1
        measured = signals.imbalance
        n = host.partitioner.num_partitions

        hist = host.sketch.histogram(top_b=int(cfg.lam * n))
        if len(hist) == 0:
            return NoOp("no-histogram", measured, measured, 0.0)
        if host.batches_seen - host.last_repartition < cfg.min_batches_between:
            return NoOp("safe-point-spacing", measured, measured, 0.0)
        if cfg.mode == "batch" and host.last_repartition > 0:
            return NoOp("batch-replayed-once", measured, measured, 0.0)
        if measured < cfg.imbalance_trigger:
            return NoOp("balanced", measured, measured, 0.0)

        # fixed heavy-table width => stable table shapes across swaps
        cap = heavy_capacity_for(cfg.lam, n,
                                 floor=host.partitioner.heavy_keys.shape[0])
        candidate = kip_update(host.partitioner, hist, eps=cfg.eps,
                               heavy_capacity=cap, tight=cfg.tight)
        planned = expected_loads(candidate, hist)
        planned_imb = float(planned.max() * n)
        gain = measured - planned_imb
        # migration cost from exchange-lane accounting: the peak (src, dst)
        # lane mass x slack the candidate plan would make migration_capacity
        # provision, on the frequency-weighted plan (same O(1) scale as gain).
        # Sketch keys are diffed exactly; the untracked tail rides the host
        # tables, so each re-binned host carries an equal share of tail mass
        # (the same uniform-tail model KIP's load bound uses).
        plan = plan_migration(host.partitioner, candidate, hist.keys,
                              state_weights=hist.freqs)
        transfer = plan.transfer.copy()
        old_hp = host.partitioner.host_to_part
        new_hp = candidate.host_to_part
        moved = old_hp != new_hp
        if moved.any() and hist.tail_mass > 0:
            np.add.at(transfer, (old_hp[moved], new_hp[moved]),
                      hist.tail_mass / len(old_hp))
        plan = dataclasses.replace(plan, transfer=transfer)
        est = exchange_lane_cost(plan, num_workers=signals.num_workers,
                                 backend=getattr(host, "exchange_backend", None),
                                 topology=getattr(host, "exchange_topology", None))
        cost = cfg.migration_cost_weight * est
        if gain <= cost:
            return NoOp(f"gain {gain:.3f} <= cost {cost:.3f}",
                        measured, planned_imb, est)
        return Repartition(
            reason="repartition",
            partitioner=candidate,
            prev=host.partitioner,
            planned_imbalance=planned_imb,
            measured_imbalance=measured,
            est_migration=est,
        )


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1 item {item})")


class ResizePolicy:
    """Elastic grow/shrink; only the disabled branch is ported."""

    def evaluate(self, host, signals: Signals) -> Action:
        if not host.config.elastic:
            return NoOp("elastic-disabled")
        raise _not_ported("the elastic ResizePolicy", 6)


class SplitPolicy:
    """Hot-key splitting; only the disabled branch is ported."""

    def evaluate(self, host, signals: Signals) -> Action:
        imb = signals.imbalance
        if not host.config.split_keys_enabled:
            return NoOp("split-disabled", imb, imb)
        raise _not_ported("the hot-key SplitPolicy", 6)


class BackendPolicy:
    """Dense <-> ragged transport selection; only the disabled branch is
    ported."""

    def evaluate(self, host, signals: Signals) -> Action:
        imb = signals.imbalance
        if not host.config.auto_backend:
            return NoOp("auto-backend-disabled", imb, imb)
        raise _not_ported("the BackendPolicy", 6)
