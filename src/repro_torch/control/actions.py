"""Typed actions the policy stack returns to its drivers (all of the
reference's action classes; the streaming driver executes ``NoOp``,
``Repartition``, ``Resize``, ``Split`` and ``Unsplit``).

A policy never mutates the runtime: it returns an :class:`Action` and the
driver (``StreamingJob``, ``DRScheduler``, the MoE train loop) executes it
at the safe point — migrate state, add/remove replicas, permute expert
weights.  ``NoOp`` carries the decline reason so declined decisions are as
observable as taken ones.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

from repro_torch.core.partitioner import Partitioner

__all__ = [
    "Action",
    "Evict",
    "NoOp",
    "Quarantine",
    "Recover",
    "Repartition",
    "Resize",
    "Replace",
    "SwitchBackend",
    "Split",
    "Unsplit",
]


@dataclasses.dataclass(frozen=True)
class Action:
    """Base decision record; ``reason`` is always human-readable."""

    reason: str
    kind: ClassVar[str] = "action"
    # whether executing this action migrates state (rows, sessions, expert
    # weights).  Consumers that count "repartitions" — anything dividing
    # migration rows by a taken-action count — gate on this instead of
    # re-listing the exceptions at every call site.
    moves_state: ClassVar[bool] = True

    @property
    def taken(self) -> bool:
        return not isinstance(self, NoOp)


@dataclasses.dataclass(frozen=True)
class NoOp(Action):
    """Decline — keep the current topology/contents.  Carries the decision
    diagnostics so compat wrappers can rebuild a full ``DRDecision``."""

    measured_imbalance: float = 0.0
    planned_imbalance: float = 0.0
    est_migration: float = 0.0
    kind: ClassVar[str] = "noop"


@dataclasses.dataclass(frozen=True)
class Repartition(Action):
    """Swap partition *contents*: install ``partitioner``, migrate state off
    ``prev`` (the paper's §4 trigger outcome)."""

    partitioner: Partitioner = None
    prev: Partitioner = None
    planned_imbalance: float = 0.0
    measured_imbalance: float = 0.0
    est_migration: float = 0.0     # exchange-lane cost estimate (peak lane mass x slack)
    kind: ClassVar[str] = "repartition"


@dataclasses.dataclass(frozen=True)
class Resize(Action):
    """Change the partition/replica *count* to ``target`` (elastic resize,
    serving scale-out/in).  ``requested=True`` marks an explicit driver
    request rather than a policy decision."""

    target: int = 0
    requested: bool = False
    kind: ClassVar[str] = "resize"


@dataclasses.dataclass(frozen=True)
class Replace(Action):
    """Re-place experts onto shards (MoE expert placement — state migration
    is a permutation of the stacked expert arrays).

    When the policy priced candidate placements (expert-weight bytes through
    the exchange backend's sizing rule), the winning placement rides the
    action: ``placement``/``perm`` are the chosen tables, ``choice`` names
    the candidate, and ``est_migration`` is its weight-bytes cost.  A bare
    ``Replace`` (all defaults) asks the host to compute the placement
    itself — the pre-costing behavior."""

    placement: object = None       # ExpertPlacement | None
    perm: object = None            # int32[E_phys] slot permutation | None
    choice: str = ""               # candidate name ("" = host decides)
    planned_imbalance: float = 0.0
    est_migration: float = 0.0     # expert-weight bytes through the exchange
    kind: ClassVar[str] = "replace"


@dataclasses.dataclass(frozen=True)
class Split(Action):
    """Replicate one hot key over ``replicas`` consecutive partitions
    starting at its ``home`` — the Partial-Key-Grouping move for a key whose
    load alone exceeds what one worker sustains (isolation can only *move*
    it; splitting *shrinks* it).

    Install-only: the DRM stamps the replica table
    (``Partitioner.with_splits``) and the route kernels start fanning the
    key out; no state moves.  The scattered partial aggregates stay correct
    because the keyed reduce is a sum and every later migration routes by
    *home*, converging and merging the partials there."""

    key: int = 0
    replicas: int = 2
    home: int = 0
    top_share: float = 0.0         # the key's share of one worker's load
    est_relief: float = 0.0        # load (worker units) the split sheds
    est_migration: float = 0.0     # priced merge-backhaul lane cost
    kind: ClassVar[str] = "split"
    moves_state: ClassVar[bool] = False  # table stamp only; no rows migrate


@dataclasses.dataclass(frozen=True)
class Unsplit(Action):
    """Collapse a cooled-down split key back to its home partition.

    Executing it *is* a state migration off ``prev`` (the partitioner that
    still carried the split): the home route pulls every replica's partial
    rows back to the key's home, where ``merge_into`` sums them — the
    combiner-side merge riding the ordinary backhaul path."""

    key: int = 0
    prev: Partitioner = None
    kind: ClassVar[str] = "unsplit"


@dataclasses.dataclass(frozen=True)
class Quarantine(Action):
    """Circuit-break a sick lane: fold its partitions onto the healthy
    workers (the modulo placement re-folds them once the lane leaves the
    collective) and park the device for a possible :class:`Recover`.

    Executing it *is* a state migration — every row the sick lane held
    re-lands on a surviving worker — priced like any other move
    (``est_migration``, the fold's exchange-lane cost under the active
    transport).  ``lane`` is the *current* lane index; the driver maps it
    to the physical device."""

    lane: int = 0
    straggle_ms: float = 0.0       # the lane's EWMA straggle the decision keyed on
    failures: int = 0              # consecutive failed windows at decision time
    est_migration: float = 0.0     # priced fold (exchange-lane cost units)
    kind: ClassVar[str] = "quarantine"


@dataclasses.dataclass(frozen=True)
class Evict(Action):
    """Remove a lane for good (permanent loss): hard worker loss discovered
    by the recovery protocol, or a lane whose exchanges keep failing past
    the retry budget.  Like :class:`Quarantine` the surviving workers adopt
    the lane's state, but the device is never re-admitted."""

    lane: int = 0
    failures: int = 0
    kind: ClassVar[str] = "evict"


@dataclasses.dataclass(frozen=True)
class Recover(Action):
    """Re-admit the oldest quarantined lane after its probe timer expires
    (the circuit breaker's half-open transition).  Priced: the fold-back
    migration (``est_migration``) must pay for the capacity the extra
    worker regains."""

    lane: int = -1                 # original lane label (diagnostic)
    est_migration: float = 0.0
    kind: ClassVar[str] = "recover"


@dataclasses.dataclass(frozen=True)
class SwitchBackend(Action):
    """Swap the exchange *transport* (dense <-> ragged) at a safe point —
    the transport as one more control-plane actuator.  The driver rebuilds
    its jitted shuffle/migrate steps for the new backend exactly like a
    resize rebuilds them for a new lane count; no state moves.
    ``padding_fraction`` records the occupancy signal the decision keyed on.
    """

    backend: str = ""              # target transport name ("dense" | "ragged")
    padding_fraction: float = 0.0  # occupied / provisioned rows this window
    kind: ClassVar[str] = "switch_backend"
    moves_state: ClassVar[bool] = False  # steps rebuild; no rows migrate
