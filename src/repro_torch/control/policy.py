"""Composable policies: Signals in, typed Actions out.

* :class:`RepartitionPolicy` — the paper's §4 trigger: repartition when the
  measured imbalance exceeds the trigger *and* the balance gain exceeds the
  state-migration cost, estimated with the active exchange backend's
  sizing rule on the candidate plan
  (:func:`repro_torch.core.migration.exchange_lane_cost`).  A port of
  ``repro.control.policy.RepartitionPolicy``, bit for bit.
* :class:`ResizePolicy` — the same trigger one level up: sustained
  imbalance grows the topology; sustained balance (or, inside the trigger
  dead zone, per-worker throughput below the capacity target) shrinks it.
  Patience streaks, a :class:`CooldownGuard` and the
  ``shrink_trigger < grow_trigger`` dead zone give it hysteresis.
* :class:`SplitPolicy` — Partial-Key-Grouping as a control action: when the
  hottest key alone exceeds ``split_trigger`` fair budgets, no repartition
  can help, so the key is replicated over ``d`` consecutive partitions,
  priced like every other action (the relief ``share * (1 - 1/d)`` must pay
  for the replica -> home backhaul plan's lane cost).  A key cooled below
  ``unsplit_trigger`` collapses first, through a home-routed migration.
* :class:`BackendPolicy` — the transport as an actuator: when the measured
  ``exchange_padding_fraction`` (occupied / provisioned rows) stays below
  ``backend_ragged_below``, a dense job ships padding the ragged count-first
  transport would skip, so it flips; a ragged job whose fraction stays
  above ``backend_dense_above`` flips back.  The gap between the two is a
  dead zone, and a patience streak, a :class:`CooldownGuard` and a guard on
  the measured walls of both transports add hysteresis.
* :class:`PlacementPolicy` — the MoE expert re-placement trigger over EP
  shard loads, with the shared cooldown guard; with expert-weight costing
  on it also picks which candidate placement wins (or declines them all).

Each is a port of its ``repro.control.policy`` namesake, bit for bit.

Policies are stateless evaluators over a *host* (``DRMaster``) that
carries the durable decision state (sketch, streaks, last-action ticks).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.control.actions import (
    Action,
    NoOp,
    Repartition,
    Replace,
    Resize,
    Split,
    SwitchBackend,
    Unsplit,
)
from repro_torch.control.signals import Signals
from repro_torch.core.migration import MigrationPlan, exchange_lane_cost, plan_migration
from repro_torch.core.partitioner import expected_loads, heavy_capacity_for, kip_update

__all__ = [
    "BackendPolicy",
    "CooldownGuard",
    "PlacementPolicy",
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


class ResizePolicy:
    """Elastic grow/shrink on sustained imbalance or idle throughput (see
    the module docstring).  The streaks live on the host (``grow_streak``,
    ``shrink_streak``), so snapshots carry them."""

    def evaluate(self, host, signals: Signals) -> Action:
        cfg = host.config
        if not cfg.elastic:
            return NoOp("elastic-disabled")
        n = host.partitioner.num_partitions
        imb = signals.imbalance
        floor = max(cfg.min_partitions, signals.num_workers)
        # throughput below the capacity target: the stream is idle even if
        # balanced, and over-partitioning is pure overhead
        low_throughput = (
            cfg.target_throughput > 0.0
            and signals.throughput > 0.0
            and signals.per_worker_throughput < cfg.target_throughput
        )
        guard = CooldownGuard(cfg.resize_cooldown)
        if imb >= cfg.grow_trigger and n < cfg.max_partitions:
            host.grow_streak += 1
            host.shrink_streak = 0
            if host.grow_streak >= cfg.resize_patience:
                if not guard.ready(host.batches_seen, host.last_resize):
                    return NoOp("resize-cooldown", imb, imb)
                host.grow_streak = 0
                target = min(n * cfg.resize_factor, cfg.max_partitions)
                return Resize(reason=f"resize {n}->{target}", target=target)
            return NoOp(f"grow-patience {host.grow_streak}/{cfg.resize_patience}",
                        imb, imb)
        elif ((imb <= cfg.shrink_trigger
               or (low_throughput and imb < cfg.grow_trigger)) and n > floor):
            # the low-throughput shrink covers the trigger dead zone only: a
            # hot-spotted stream at max_partitions is never shrunk for idling
            host.shrink_streak += 1
            host.grow_streak = 0
            if host.shrink_streak >= cfg.resize_patience:
                if not guard.ready(host.batches_seen, host.last_resize):
                    return NoOp("resize-cooldown", imb, imb)
                host.shrink_streak = 0
                target = max(n // cfg.resize_factor, floor)
                return Resize(reason=f"resize {n}->{target}", target=target)
            return NoOp(f"shrink-patience {host.shrink_streak}/{cfg.resize_patience}",
                        imb, imb)
        else:
            host.grow_streak = host.shrink_streak = 0
        if imb >= cfg.grow_trigger:
            return NoOp("at-max", imb, imb)
        if imb <= cfg.shrink_trigger or low_throughput:
            return NoOp("at-floor", imb, imb)
        return NoOp("dead-zone", imb, imb)


class SplitPolicy:
    """Hot-key splitting and un-splitting over the DR master's sketch (see
    the module docstring).  The streak, the cooldown stamp and the installed
    replica map live on the host (``split_streak``, ``last_split``,
    ``split_keys``), so snapshots carry them.  The policy only decides: the
    host stamps the replica table on a taken :class:`Split`, and the driver
    runs a taken :class:`Unsplit` as a home-routed state migration whose
    merge sums the scattered partials."""

    def evaluate(self, host, signals: Signals) -> Action:
        cfg = host.config
        imb = signals.imbalance
        if not cfg.split_keys_enabled:
            return NoOp("split-disabled", imb, imb)
        n = host.partitioner.num_partitions
        hist = host.sketch.histogram(top_b=int(cfg.lam * n))
        if len(hist) == 0:
            return NoOp("split-no-histogram", imb, imb)
        splits = host.split_keys
        guard = CooldownGuard(cfg.split_cooldown)
        # a key's load in fair-budget units: freq * N is 1.0 when the key
        # fills exactly one partition's even share
        share = {int(k): float(f) * n for k, f in zip(hist.keys, hist.freqs)}

        # unsplit first: a cooled key collapses (merging its partials)
        # before any new split may fire
        for k in sorted(splits):
            if share.get(k, 0.0) < cfg.unsplit_trigger:
                host.split_streak += 1
                if host.split_streak < cfg.split_patience:
                    return NoOp(
                        f"split-patience {host.split_streak}/{cfg.split_patience}",
                        imb, imb)
                if not guard.ready(host.batches_seen, host.last_split):
                    return NoOp("split-cooldown", imb, imb)
                return Unsplit(
                    reason=(f"unsplit key {k} (share {share.get(k, 0.0):.2f} < "
                            f"{cfg.unsplit_trigger})"),
                    key=k, prev=host.partitioner)

        # split: the hottest key not yet split whose load alone exceeds one
        # worker's budget (moving such a key cannot balance it)
        top_key, top_share = None, 0.0
        for k, f in zip(hist.keys, hist.freqs):
            if int(k) not in splits:
                top_key, top_share = int(k), float(f) * n
                break
        if top_key is None or top_share <= cfg.split_trigger or n < 2:
            host.split_streak = 0
            return NoOp(f"split-dead-zone {top_share:.2f}", imb, imb)
        host.split_streak += 1
        if host.split_streak < cfg.split_patience:
            return NoOp(f"split-patience {host.split_streak}/{cfg.split_patience}",
                        imb, imb)
        if not guard.ready(host.batches_seen, host.last_split):
            return NoOp("split-cooldown", imb, imb)
        # enough replicas to bring the per-replica share under budget
        d = int(min(max(2, int(np.ceil(top_share))), cfg.split_max_replicas, n))
        home = int(host.partitioner.lookup_np(np.asarray([top_key], np.int32))[0])
        # the relief must pay for the merge backhaul the split commits to:
        # each replica ships its partial home, f/d mass replica -> home,
        # priced by the transport's sizing rule like a repartition plan
        f = top_share / n
        transfer = np.zeros((n, n))
        repls = (home + np.arange(1, d)) % n
        np.add.at(transfer, (repls, np.full(d - 1, home)), f / d)
        plan = MigrationPlan(
            keys=np.full(d - 1, top_key, np.int64),
            src=repls.astype(np.int32),
            dst=np.full(d - 1, home, np.int32),
            weights=np.full(d - 1, f / d),
            transfer=transfer,
            relative_migration=0.0,
            num_src=n, num_dst=n,
        )
        est = exchange_lane_cost(plan, num_workers=signals.num_workers,
                                 backend=getattr(host, "exchange_backend", None),
                                 topology=getattr(host, "exchange_topology", None))
        relief = top_share * (1.0 - 1.0 / d)
        cost = cfg.migration_cost_weight * est
        if relief <= cost:
            return NoOp(f"split relief {relief:.3f} <= cost {cost:.3f}", imb, imb, est)
        return Split(
            reason=(f"split key {top_key} x{d} (share {top_share:.2f} > "
                    f"{cfg.split_trigger})"),
            key=top_key, replicas=d, home=home,
            top_share=top_share, est_relief=relief, est_migration=est,
        )


class BackendPolicy:
    """Dense <-> ragged transport selection over the measured lane occupancy
    (see the module docstring).  The streak and the last switch live on the
    host (``backend_streak``, ``last_backend_switch``), so snapshots carry
    them; the host installs a taken switch by ``note_backend_switch``."""

    def evaluate(self, host, signals: Signals) -> Action:
        cfg = host.config
        imb = signals.imbalance
        if not cfg.auto_backend:
            return NoOp("auto-backend-disabled", imb, imb)
        frac = signals.exchange_padding_fraction
        if signals.exchange_padded_rows <= 0:
            # no exchange ran this window: nothing measured, keep the streak
            return NoOp("backend-no-exchange-window", imb, imb)
        name = getattr(host.exchange_backend, "name", str(host.exchange_backend))
        if name == "dense" and frac < cfg.backend_ragged_below:
            target = "ragged"
        elif name == "ragged" and frac > cfg.backend_dense_above:
            target = "dense"
        else:
            host.backend_streak = 0
            return NoOp(f"backend-dead-zone {frac:.2f}", imb, imb)
        host.backend_streak += 1
        if host.backend_streak < cfg.backend_patience:
            return NoOp(f"backend-patience {host.backend_streak}/{cfg.backend_patience}",
                        imb, imb)
        if not CooldownGuard(cfg.backend_cooldown).ready(host.batches_seen,
                                                         host.last_backend_switch):
            return NoOp("backend-cooldown", imb, imb)
        # measured-wall evidence: once both transports have a wall EWMA, do
        # not switch onto one measured markedly slower than the current one
        # (with no measurement of the target the guard is inert)
        ewma = signals.backend_wall_ewma or {}
        if target in ewma and name in ewma and ewma[target] > 1.5 * ewma[name]:
            return NoOp(f"backend-wall-evidence {target} {ewma[target]*1e3:.1f}ms > "
                        f"{name} {ewma[name]*1e3:.1f}ms", imb, imb)
        return SwitchBackend(
            reason=f"backend {name}->{target} (padding fraction {frac:.2f})",
            backend=target, padding_fraction=frac)


class PlacementPolicy:
    """Expert re-placement trigger over shard loads (see module doc).

    Without weight costing (``host.expert_weight_bytes == 0``) the policy
    only decides *whether*: the host computes the KIP placement on a bare
    :class:`Replace`.  With it, the policy also gates *which* placement
    wins, mirroring the streaming cost model: the host's candidate
    placements (``plan_candidates``) are priced by folding expert-weight
    bytes through :func:`~repro_torch.core.migration.exchange_lane_cost` on the
    shard-to-shard weight-transfer matrix, and the candidate minimizing
    ``planned_imbalance + cost_weight * moved_bytes / total_bytes`` is
    chosen — including the zero-move "stay" candidate, so a re-placement
    whose balance gain cannot pay for its weight movement is declined."""

    def evaluate(self, host, signals: Signals) -> Action:
        imb = signals.imbalance
        if host.e <= host.n:
            return NoOp("too-few-experts", imb, imb)
        if imb < host.trigger:
            return NoOp("balanced", imb, imb)
        guard = CooldownGuard(host.min_steps_between)
        if not guard.ready(host.steps, host.last_update):
            return NoOp("cooldown", imb, imb)
        weight_bytes = float(getattr(host, "expert_weight_bytes", 0.0))
        if weight_bytes <= 0:
            return Replace(reason=f"imbalance {imb:.3f} >= trigger {host.trigger:.3f}")
        total = weight_bytes * host.e
        candidates = host.plan_candidates()
        cost_w = float(getattr(host, "cost_weight", 1.0))

        def score(c: dict) -> float:
            return c["planned_imbalance"] + cost_w * c["est_migration"] / max(total, 1e-12)

        best = min(candidates, key=score)
        if best["moved"] == 0:
            # the stay candidate won: no placement's gain pays for its bytes
            alt = min((c for c in candidates if c["moved"]), key=score, default=None)
            detail = (f" (best alternative {alt['choice']}: imb "
                      f"{alt['planned_imbalance']:.3f}, "
                      f"{alt['est_migration']:.0f} bytes)" if alt else "")
            return NoOp(f"placement gain <= migration cost{detail}",
                        imb, best["planned_imbalance"], 0.0)
        return Replace(
            reason=(f"placement {best['choice']}: imbalance {imb:.3f} -> "
                    f"{best['planned_imbalance']:.3f}, "
                    f"{best['est_migration']:.0f} bytes"),
            placement=best["placement"],
            perm=best["perm"],
            choice=best["choice"],
            planned_imbalance=best["planned_imbalance"],
            est_migration=best["est_migration"],
        )
