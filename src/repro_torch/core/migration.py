"""State-migration planning for partitioner swaps (host numpy).

When the DRM swaps partitioners at a safe point, every live key whose
partition changed must have its operator state moved.  The planner produces
the per-key move list, the [N, N] transfer matrix and the *relative state
migration* metric of the paper's Fig. 3.  Bit-identical to
``repro.core.migration`` on flat (topology-free) exchanges.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partitioner import Partitioner

__all__ = [
    "MigrationPlan",
    "plan_migration",
    "migration_capacity",
    "exchange_lane_cost",
    "fold_to_workers",
]


def fold_to_workers(values: np.ndarray, num_workers: int) -> np.ndarray:
    """Fold per-partition accounting to worker granularity.

    Partition ``p`` lives on worker ``p % W`` — the one placement rule the
    runtime, the migration planner, and the control-plane signals all share.
    Accepts a ``[N]`` vector (loads) or a ``[N, N]`` matrix (transfer) and
    returns the ``[W]`` / ``[W, W]`` worker-folded equivalent.
    """
    v = np.asarray(values, np.float64)
    n = v.shape[0]
    w = np.arange(n) % num_workers
    if v.ndim == 1:
        out = np.zeros(num_workers)
        np.add.at(out, w, v)
        return out
    assert v.ndim == 2 and v.shape[0] == v.shape[1], v.shape
    out = np.zeros((num_workers, num_workers))
    np.add.at(out, (w[:, None], w[None, :]), v)
    return out


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    keys: np.ndarray          # int64[M] keys that move
    src: np.ndarray           # int32[M]
    dst: np.ndarray           # int32[M]
    weights: np.ndarray       # float64[M] state size per moved key
    transfer: np.ndarray      # float64[N, N] bytes moved src->dst
    relative_migration: float # moved / total state weight
    # cross-size (elastic resize) bookkeeping: the plan's src axis spans the
    # old topology, the dst axis the new one; ``transfer`` is padded square
    # to max(num_src, num_dst) so worker folding works either way.
    num_src: int = 0          # old partition count
    num_dst: int = 0          # new partition count

    @property
    def num_moves(self) -> int:
        return len(self.keys)


def plan_migration(
    old: Partitioner,
    new: Partitioner,
    live_keys: np.ndarray,
    state_weights: np.ndarray | None = None,
) -> MigrationPlan:
    """Diff two partitioners over the live key set.

    ``old`` and ``new`` may have different partition counts (elastic
    resize): the transfer matrix is padded square to the larger topology,
    and every key whose partition changed under the new lookup moves —
    including keys folded off removed partitions on a shrink.
    """
    live_keys = np.asarray(live_keys, np.int64)
    if state_weights is None:
        state_weights = np.ones(len(live_keys))
    state_weights = np.asarray(state_weights, np.float64)
    assert live_keys.shape == state_weights.shape

    src = old.lookup_np(live_keys.astype(np.int32))
    dst = new.lookup_np(live_keys.astype(np.int32))
    moved = src != dst
    n = max(old.num_partitions, new.num_partitions)
    transfer = np.zeros((n, n))
    np.add.at(transfer, (src[moved], dst[moved]), state_weights[moved])
    total = float(state_weights.sum())
    rel = float(state_weights[moved].sum() / total) if total > 0 else 0.0
    return MigrationPlan(
        keys=live_keys[moved],
        src=src[moved].astype(np.int32),
        dst=dst[moved].astype(np.int32),
        weights=state_weights[moved],
        transfer=transfer,
        relative_migration=rel,
        num_src=old.num_partitions,
        num_dst=new.num_partitions,
    )


def migration_capacity(
    plan: MigrationPlan,
    row_bytes: float = 1.0,
    slack: float = 1.25,
    num_workers: int | None = None,
) -> int:
    """Static per-(src,dst) lane capacity for the all-to-all state exchange.

    Exchange lanes have a static capacity: size each lane to the largest
    planned transfer times ``slack`` (rounded up to a multiple of 8 rows).

    With ``num_workers`` the [N, N] partition-level transfer matrix is first
    folded to worker granularity (partition p lives on worker ``p % W``) and
    same-worker moves are dropped — they never cross the exchange.  This is
    the lane size ``repro_torch.core.shuffle.make_migrate_step`` wants: the
    exchanged buffer shrinks from ``W * state_capacity`` rows to the planned
    peak transfer x slack.
    """
    transfer = plan.transfer
    if transfer.size == 0:
        return 8
    if num_workers is not None:
        transfer = fold_to_workers(transfer, num_workers)
        np.fill_diagonal(transfer, 0.0)  # same-worker moves don't ship
    peak = float(transfer.max()) / max(row_bytes, 1e-12)
    cap = int(np.ceil(peak * slack / 8.0) * 8)
    return max(cap, 8)


def exchange_lane_cost(
    plan: MigrationPlan,
    *,
    num_workers: int | None = None,
    slack: float = 1.25,
    backend=None,
    topology=None,
) -> float:
    """Migration-cost estimate from the *active exchange backend's* sizing
    rule.

    The default (dense) rule is the quantity :func:`migration_capacity`
    quantizes into lane rows — the peak planned (src, dst) transfer times
    ``slack``, since a capacity-padded transport provisions every lane to
    the peak.  A ragged backend's rule averages real rows over the lanes
    (``backend.cost``), and a local backend is free — so the control
    plane's :class:`~repro_torch.control.policy.RepartitionPolicy` weighs the
    balance gain against what the transport the job actually runs would
    move, not a one-size heuristic.  The estimate stays in the plan's own
    weight units so it can be evaluated on a *relative* (frequency-weighted)
    candidate plan before any state exists.

    With ``num_workers > 1`` the transfer folds to worker granularity and
    same-worker moves cost nothing (they never cross the exchange); on a
    single worker — or when the worker count is unknown — partition-level
    lanes are the accounting unit.  ``backend`` is any object with the
    :class:`~repro_torch.exchange.backends.ExchangeBackend` ``cost`` verb (or
    ``None`` for the dense rule).

    ``topology`` (an :class:`~repro_torch.exchange.spec.ExchangeTopology`)
    makes the estimate locality-priced: each (src, dst) cell of the
    worker-folded transfer is weighted by its distance class before the
    backend's rule sees it, so a plan that keeps its mass within a host
    costs less than one that scatters it across hosts (10x a row by
    default), which can flip a decision the flat estimate would take.
    """
    transfer = plan.transfer
    if transfer.size == 0:
        return 0.0
    if num_workers is not None and num_workers > 1:
        transfer = fold_to_workers(transfer, num_workers)
        np.fill_diagonal(transfer, 0.0)
    if topology is not None:
        transfer = transfer * topology.weight_matrix(transfer.shape[0])
    if backend is not None:
        return float(backend.cost(None, transfer, slack=slack))
    return float(transfer.max()) * slack
