"""KIP-based expert -> EP-shard placement, the paper's technique in-model
(a port of ``repro.moe.kip_placement``).

Mapping onto the paper's objects:

* keys            -> logical expert ids (all "heavy": E is small, tail empty)
* partitions      -> EP shards (``Policy.ep_shards``, stacked on one device)
* key histogram   -> per-expert token loads (DRW = router statistics,
                     gathered during normal forward work, zero extra passes)
* state migration -> moving expert weights between shards = permuting the
                     stacked ``[E, ...]`` expert tensors

The controller runs KIPUPDATE on the expert-load histogram, then
post-processes the shard assignment into exactly ``E/shards`` slots per
shard (KIP knows load bounds, not slot counts), preferring to keep every
expert where it was.  The *whether* of a re-placement routes through the
control plane: router statistics feed a :class:`~repro_torch.control.
Telemetry` window, the :class:`~repro_torch.control.PlacementPolicy`
returns a typed action, and every decision lands in the controller's
:class:`~repro_torch.control.DecisionLog`.  All of it is host numpy, as in
the reference; only :func:`apply_placement_to_weights` and
:func:`apply_placement_in_place` touch tensors, on the weights' own device.

Under a process mesh (``Policy.mesh``) each rank holds its model shard's
slots, and the safe point's move crosses ranks: a slot whose expert comes
from another model rank receives its weights and both Adam moments over
the model axis's subgroup (one uneven all-to-all a tensor, the moved
slots only), the operator-state migration done between processes.
Every rank's controller observes the same mesh-summed counts and so
decides alike; :meth:`PlacementController.check_agreement` compares a
digest of each decision across the group and raises if a rank decided
otherwise.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.control import DecisionLog, PlacementPolicy, Replace, Telemetry
from repro_torch.core.histogram import Histogram
from repro_torch.core.migration import MigrationPlan, exchange_lane_cost
from repro_torch.core.partitioner import Partitioner, kip_update, uniform_partitioner
from repro_torch.exchange.backends import resolve_backend

__all__ = ["ExpertPlacement", "PlacementController", "apply_placement_in_place",
           "apply_placement_to_weights", "placement_from_assignment", "replicated_assignment"]


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    place: np.ndarray      # int32[E_phys] physical slot -> logical expert
    inv_place: np.ndarray  # int32[E]      logical expert -> physical slot
    n_shards: int

    @property
    def num_experts(self) -> int:
        return len(self.inv_place)

    def shard_of(self, logical: np.ndarray) -> np.ndarray:
        e_loc = len(self.place) // self.n_shards
        return self.inv_place[logical] // e_loc

    @staticmethod
    def identity(num_experts: int, n_shards: int) -> "ExpertPlacement":
        p = np.arange(num_experts, dtype=np.int32)
        return ExpertPlacement(p.copy(), p.copy(), n_shards)


def _slot_constrained(shard_of: np.ndarray, loads: np.ndarray, n_shards: int) -> np.ndarray:
    """Evict lightest experts from over-full shards into free slots."""
    e = len(shard_of)
    e_loc = e // n_shards
    shard_of = shard_of.copy()
    for s in range(n_shards):
        members = np.where(shard_of == s)[0]
        if len(members) <= e_loc:
            continue
        # keep the heaviest e_loc here; move the rest to shards with room
        order = members[np.argsort(-loads[members])]
        for m in order[e_loc:]:
            room = [q for q in range(n_shards) if (shard_of == q).sum() < e_loc]
            # least-loaded shard with a free slot
            q = min(room, key=lambda q: loads[shard_of == q].sum())
            shard_of[m] = q
    return shard_of


def placement_from_assignment(
    shard_of: np.ndarray, prev: ExpertPlacement, n_shards: int
) -> ExpertPlacement:
    """Build slot tables, keeping an expert's previous slot when its shard
    did not change (zero migration for unmoved experts)."""
    e = len(shard_of)
    e_loc = e // n_shards
    place = np.full(e, -1, np.int32)
    taken = np.zeros(e, bool)
    # pass 1: unmoved experts keep their physical slot
    for ex in range(e):
        old_slot = prev.inv_place[ex]
        if old_slot // e_loc == shard_of[ex]:
            place[old_slot] = ex
            taken[old_slot] = True
    # pass 2: moved experts fill free slots of their new shard
    for ex in range(e):
        old_slot = prev.inv_place[ex]
        if old_slot // e_loc == shard_of[ex]:
            continue
        s = shard_of[ex]
        free = [p for p in range(s * e_loc, (s + 1) * e_loc) if not taken[p]]
        p = free[0]
        place[p] = ex
        taken[p] = True
    inv = np.zeros(e, np.int32)
    inv[place] = np.arange(e, dtype=np.int32)
    return ExpertPlacement(place, inv, n_shards)


class PlacementController:
    """DRM for experts: EWMA load sketch + KIP placement updates.

    ``expert_weight_bytes`` (bytes one expert's weights occupy)
    turns on the richer placement costing: candidate placements are priced
    by folding the bytes they would move through the exchange backend's
    sizing rule (:func:`~repro_torch.core.migration.exchange_lane_cost`), and the
    :class:`~repro_torch.control.PlacementPolicy` picks the candidate —
    including "stay" — whose balance gain best pays for its weight
    movement (``cost_weight`` scales how many imbalance units one full
    weight-set move is worth).  At 0.0 (default) the pre-costing behavior
    holds: the policy decides *whether*, this host computes the placement.
    """

    def __init__(self, num_experts: int, n_shards: int, *, eps: float = 0.02,
                 alpha: float = 0.5, trigger: float = 1.15, min_steps_between: int = 1,
                 expert_weight_bytes: float = 0.0, cost_weight: float = 1.0,
                 exchange_backend: str | object | None = None,
                 exchange_topology=None):
        self.placement = ExpertPlacement.identity(num_experts, n_shards)
        self.e, self.n = num_experts, n_shards
        self.eps, self.alpha, self.trigger = eps, alpha, trigger
        self.min_steps_between = min_steps_between
        self.expert_weight_bytes = float(expert_weight_bytes)
        self.cost_weight = float(cost_weight)
        self.exchange_backend = resolve_backend(exchange_backend)
        # EP-shard locality (ExchangeTopology over the shards): weight-move
        # candidates are priced per distance class, so two placements with
        # equal balance tie-break toward the one keeping experts on-host
        self.exchange_topology = exchange_topology
        self.loads_ewma = np.zeros(num_experts)
        self.steps = 0
        self.last_update = -(10**9)
        self.history: list[dict] = []
        # control plane: the trigger/cooldown decision is a shared policy,
        # fed by telemetry gathered from normal router statistics
        self.policy = PlacementPolicy()
        self.telemetry = Telemetry("moe")
        self.decisions = DecisionLog("moe")

    def shard_loads(self, loads: np.ndarray) -> np.ndarray:
        e_loc = self.e // self.n
        return loads[self.placement.place].reshape(self.n, e_loc).sum(axis=1)

    def observe(self, counts: np.ndarray, exchange=None) -> None:
        """Fold one step's router counts (and optionally its dispatch
        traffic, as a plane-constructed
        :class:`~repro_torch.exchange.ExchangeStats` from
        ``MoEOut.exchange_stats()``) into the telemetry window."""
        c = np.asarray(counts, np.float64)
        tot = max(c.sum(), 1e-9)
        self.loads_ewma = (1 - self.alpha) * self.loads_ewma + self.alpha * (c / tot)
        self.steps += 1
        self.telemetry.record_batch(float(c.sum()))
        if exchange is not None:
            self.telemetry.record_exchange(exchange)

    def _prev_partitioner(self) -> Partitioner:
        """Previous placement as a Partitioner (explicit routing for all keys)."""
        base = uniform_partitioner(self.n, num_hosts=256, heavy_capacity=0)
        hk = np.arange(self.e, dtype=np.int32)
        order = np.argsort(hk)
        return Partitioner(
            self.n,
            hk[order],
            self.placement.shard_of(hk[order]).astype(np.int32),
            base.host_to_part,
        )

    def _build_candidate(self, choice: str, tight: bool) -> dict:
        """One KIP placement candidate, priced in expert-weight bytes."""
        hist = Histogram.from_counts(np.arange(self.e), np.maximum(self.loads_ewma, 1e-9))
        kip = kip_update(self._prev_partitioner(), hist, num_partitions=self.n,
                         eps=self.eps, heavy_capacity=self.e, tight=tight)
        shard_of = kip.lookup_np(np.arange(self.e, dtype=np.int32))
        shard_of = _slot_constrained(shard_of, self.loads_ewma, self.n)
        new = placement_from_assignment(shard_of, self.placement, self.n)
        # slot permutation: new physical slot p holds logical new.place[p],
        # whose weights currently sit at old slot inv_old[new.place[p]]
        perm = self.placement.inv_place[new.place].astype(np.int32)
        return self._describe(choice, new, perm)

    def _describe(self, choice: str, new: ExpertPlacement, perm: np.ndarray) -> dict:
        ex = np.arange(self.e, dtype=np.int32)
        old_shard = self.placement.shard_of(ex).astype(np.int32)
        new_shard = new.shard_of(ex).astype(np.int32)
        moved_mask = old_shard != new_shard
        bytes_each = self.expert_weight_bytes or 1.0
        transfer = np.zeros((self.n, self.n))
        np.add.at(transfer, (old_shard[moved_mask], new_shard[moved_mask]), bytes_each)
        plan = MigrationPlan(
            keys=ex[moved_mask].astype(np.int64),
            src=old_shard[moved_mask], dst=new_shard[moved_mask],
            weights=np.full(int(moved_mask.sum()), bytes_each),
            transfer=transfer,
            relative_migration=float(moved_mask.mean()),
            num_src=self.n, num_dst=self.n,
        )
        new_sl = self.loads_ewma[new.place].reshape(self.n, -1).sum(axis=1)
        return {
            "choice": choice,
            "placement": new,
            "perm": perm,
            "moved": int((perm != np.arange(self.e)).sum()),
            "planned_imbalance": float(new_sl.max() / max(new_sl.mean(), 1e-12)),
            # weight bytes through the active transport's sizing rule — the
            # same (locality-priced) cost model the streaming
            # RepartitionPolicy prices with
            "est_migration": exchange_lane_cost(
                plan, backend=self.exchange_backend,
                topology=self.exchange_topology,
            ),
        }

    def plan_candidates(self) -> list[dict]:
        """Candidate placements for the weight-costed policy gate: the two
        KIP host-binning modes plus the zero-move "stay" option."""
        stay = self._describe(
            "stay", self.placement, np.arange(self.e, dtype=np.int32)
        )
        return [
            stay,
            self._build_candidate("pack", tight=False),
            self._build_candidate("waterfill", tight=True),
        ]

    def maybe_update(self) -> tuple[bool, ExpertPlacement, np.ndarray]:
        """Returns (changed, placement, slot_perm) where ``slot_perm[p_new] =
        p_old`` is the permutation to apply to stacked expert weights."""
        sl = self.shard_loads(self.loads_ewma)
        signals = self.telemetry.snapshot(loads=sl, num_workers=self.n)
        action = self.policy.evaluate(self, signals)
        detail = {"choice": action.choice} if isinstance(action, Replace) and action.choice else {}
        self.decisions.record(action, tick=self.steps, imbalance=signals.imbalance,
                              detail=detail)
        if not isinstance(action, Replace):
            return False, self.placement, np.arange(self.e, dtype=np.int32)
        imb = signals.imbalance

        if action.placement is not None:
            # the policy already picked the winning (weight-costed) candidate
            new, perm = action.placement, np.asarray(action.perm, np.int32)
            est = action.est_migration
        else:
            cand = self._build_candidate("pack", tight=False)
            new, perm, est = cand["placement"], cand["perm"], cand["est_migration"]
        moved = int((perm != np.arange(self.e)).sum())
        new_sl = self.loads_ewma[new.place].reshape(self.n, -1).sum(axis=1)
        self.history.append({
            "step": self.steps, "imbalance_before": imb,
            "imbalance_planned": float(new_sl.max() / max(new_sl.mean(), 1e-12)),
            "experts_moved": moved,
            "migration_bytes": float(est) if self.expert_weight_bytes else 0.0,
            "choice": action.choice or "pack",
        })
        self.placement = new
        self.last_update = self.steps
        return moved > 0, new, perm


    def check_agreement(self, group) -> int:
        """Compare a digest of the decision just logged, of the load
        estimate it read and of the placement after it across ``group`` (a
        :class:`~repro_torch.exchange.dist.WorkerGroup`; every rank calls
        it at the same safe point); a rank that saw other counts or decided
        otherwise raises on every rank.  Returns the digest, the same on
        every rank."""
        d = self.decisions.records[-1] if self.decisions.records else None
        h = hashlib.blake2b(digest_size=8)
        h.update(repr(None if d is None else (d.tick, d.kind, d.taken, d.reason, d.imbalance,
                                              sorted(d.detail.items()))).encode())
        h.update(np.ascontiguousarray(self.loads_ewma, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.placement.place, np.int32).tobytes())
        digests = group.host_gather(np.frombuffer(h.digest(), np.int64))
        if not (digests == digests[0]).all():
            kind = None if d is None else d.kind
            raise RuntimeError(f"the ranks placed the experts differently at step "
                               f"{self.steps}: rank {group.rank} took {kind}; digests "
                               f"{digests.ravel().tolist()}")
        return int(digests.ravel()[0])


def replicated_assignment(loads: np.ndarray, n_shards: int, replicas: int,
                          eps: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Beyond-paper: heavy-expert replication (serving-oriented).

    The paper can only *isolate* a heavy key; an expert, unlike a keygroup,
    can be cloned — its traffic splits across replicas, beating the
    single-key floor N*f1 that caps every pure partitioner.  Greedy: give
    the ``replicas`` extra physical slots to the heaviest experts (halving/
    thirding their effective load), then KIP-place the E + R virtual
    experts onto shards.

    Returns (owner[E + R] -> logical expert, shard_of[E + R]).
    """
    e = len(loads)
    assert (e + replicas) % n_shards == 0, "E + R must divide into shard slots"
    loads = np.asarray(loads, np.float64) / max(loads.sum(), 1e-12)
    counts = np.ones(e, np.int64)  # replicas per expert
    for _ in range(replicas):
        eff = loads / counts
        counts[int(np.argmax(eff))] += 1
    owner = np.repeat(np.arange(e), counts).astype(np.int32)
    eff_load = (loads / counts)[owner]
    hist = Histogram.from_counts(np.arange(len(owner)), np.maximum(eff_load, 1e-9))
    part = kip_update(uniform_partitioner(n_shards, num_hosts=256, heavy_capacity=0),
                      hist, eps=eps, heavy_capacity=len(owner), tight=True)
    shard_of = part.lookup_np(np.arange(len(owner), dtype=np.int32))
    shard_of = _slot_constrained(shard_of, eff_load, n_shards)
    return owner, shard_of.astype(np.int32)


def apply_placement_to_weights(moe_params: dict, perm) -> dict:
    """Permute the stacked expert tensors to the new physical slots (the
    state migration): ``wi`` and ``wo`` by ``index_select`` on dim 0, on
    the weights' own device; the router and the shared expert stay."""

    def permute(name, arr):
        if name in ("wi", "wo"):
            idx = torch.as_tensor(np.asarray(perm, np.int64), device=arr.device)
            return torch.index_select(arr, 0, idx)
        return arr

    return {k: permute(k, v) if not isinstance(v, dict) else v for k, v in moe_params.items()}


def apply_placement_in_place(moe_trees, perm, mesh=None, *, tp_axis: str = "model") -> None:
    """The training safe point's state migration: ``wi`` and ``wo`` of each
    dict of ``moe_trees`` (every MoE layer's parameters and each of its
    two Adam moments, as ``train.train_step.moe_state`` lists them)
    permuted to the new physical slots by ``perm`` on dim 0, copied into
    the same tensors under ``torch.no_grad()``: a parameter stays the leaf
    that requires grad, and its moments stay paired with it.  The
    reference's launcher moves the weights alone and leaves the moments
    where they were (ROADMAP.md, queue 3).

    Under ``mesh`` (a :class:`~repro_torch.launch.mesh.ProcessMesh`) each
    tensor holds this rank's slots ``[j * e_loc, (j + 1) * e_loc)`` on
    model coordinate ``j`` (``carry.rank_params``), and every rank calls it
    together with the same ``perm``: see :func:`_move_across_ranks`."""
    if mesh is not None:
        _move_across_ranks(moe_trees, np.asarray(perm, np.int64), mesh.subgroup(tp_axis))
        return
    idx = None
    with torch.no_grad():
        for tree in moe_trees:
            for name in ("wi", "wo"):
                t = tree[name]
                if idx is None or idx.device != t.device:
                    idx = torch.as_tensor(np.asarray(perm, np.int64), device=t.device)
                t.copy_(torch.index_select(t, 0, idx))


@torch.no_grad()
def _move_across_ranks(moe_trees, perm: np.ndarray, group) -> None:
    """``perm`` applied to slots cut over ``group`` (the model axis's ranks,
    ``e_loc`` slots each): new slot ``p`` of rank ``j`` takes old slot
    ``perm[p]``.  Slots whose old slot is on this rank are copied here; the
    others arrive over the group, one uneven all-to-all a tensor carrying
    only those slots (rows to each rank in its slot order, so each source's
    rows land in the order it sent them).  With no slot crossing ranks (all
    ranks know ``perm``) nothing ships."""
    n, j = group.world_size, group.rank
    e_loc = len(perm) // n
    src = perm // e_loc
    mine = np.arange(j * e_loc, (j + 1) * e_loc)
    send_rows = [perm[p] - j * e_loc for r in range(n) if r != j
                 for p in range(r * e_loc, (r + 1) * e_loc) if src[p] == j]
    send = [0 if r == j else int((src[r * e_loc:(r + 1) * e_loc] == j).sum())
            for r in range(n)]
    recv_slots = [p - j * e_loc for s in range(n) if s != j for p in mine if src[p] == s]
    recv = [0 if s == j else int((src[mine] == s).sum()) for s in range(n)]
    local = [p for p in mine if src[p] == j]
    crossing = bool((src != np.arange(len(perm)) // e_loc).any())
    idx = {}
    for tree in moe_trees:
        for name in ("wi", "wo"):
            t = tree[name]
            if t.shape[0] != e_loc:
                raise ValueError(f"a rank holds its model shard's {e_loc} slots "
                                 f"(carry.rank_params), got {tuple(t.shape)}")
            if t.device not in idx:
                as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=t.device)
                idx[t.device] = (as_t(send_rows), as_t([p - j * e_loc for p in local]),
                                 as_t([perm[p] - j * e_loc for p in local]), as_t(recv_slots))
            send_i, to_i, from_i, recv_i = idx[t.device]
            new = torch.empty_like(t)
            new[to_i] = t[from_i]
            if crossing:
                new[recv_i] = group.all_to_all_uneven(t[send_i], send, recv)
            t.copy_(new)
