"""KIP expert placement (``repro_torch.moe.kip_placement``) and the
``PlacementPolicy`` against the reference, on the CPU.

Every case of ``tests/test_moe.py::TestPlacement`` and ``TestReplication``
and the ``PlacementController`` cases of ``tests/test_control.py`` run on
both packages side by side, with the reference's own assertions kept.
Equal exactly: ``place`` / ``inv_place``, the slot permutation, the EWMA
loads, ``history`` and every ``DecisionLog`` entry (reasons and details
included); ``apply_placement_to_weights`` moves torch tensors as the
reference moves its arrays.  The placement is host numpy in both packages,
so nothing here needs a tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoESpec as JSpec
from repro.exchange import ExchangeStats as JStats
from repro.exchange import ExchangeTopology as JTopology
from repro.moe import kip_placement as jkp
from repro.moe.layer import init_moe as j_init_moe
from repro_torch.control import PlacementPolicy
from repro_torch.exchange import ExchangeStats, ExchangeTopology
from repro_torch.moe import kip_placement as tkp


def _pair(*args, **kw):
    """The reference's controller and the port's, built alike (a topology
    keyword is built in each package)."""
    jkw, tkw = dict(kw), dict(kw)
    topo = kw.get("exchange_topology")
    if topo is not None:
        jkw["exchange_topology"] = JTopology(*topo)
        tkw["exchange_topology"] = ExchangeTopology(*topo)
    return jkp.PlacementController(*args, **jkw), tkp.PlacementController(*args, **tkw)


def _same_placement(j, t):
    np.testing.assert_array_equal(t.place, j.place)
    np.testing.assert_array_equal(t.inv_place, j.inv_place)
    assert t.n_shards == j.n_shards
    assert t.place.dtype == j.place.dtype and t.inv_place.dtype == j.inv_place.dtype


def _same_controller(j, t):
    _same_placement(j.placement, t.placement)
    np.testing.assert_array_equal(t.loads_ewma, j.loads_ewma)
    assert (t.steps, t.last_update) == (j.steps, j.last_update)
    assert t.history == j.history
    assert [dataclasses.asdict(d) for d in t.decisions.records] == [
        dataclasses.asdict(d) for d in j.decisions.records]
    assert t.decisions.counts() == j.decisions.counts()


def _update_both(j, t):
    jres, tres = j.maybe_update(), t.maybe_update()
    assert tres[0] == jres[0]
    _same_placement(jres[1], tres[1])
    np.testing.assert_array_equal(tres[2], jres[2])
    assert tres[2].dtype == jres[2].dtype
    _same_controller(j, t)
    return tres


def _skewed():
    loads = np.ones(16)
    loads[0], loads[1] = 20.0, 15.0  # two hot experts on shard 0
    return loads


# ---------------------------------------------------------------------------
# tests/test_moe.py::TestPlacement
# ---------------------------------------------------------------------------


def test_identity():
    j, t = jkp.ExpertPlacement.identity(8, 4), tkp.ExpertPlacement.identity(8, 4)
    _same_placement(j, t)
    np.testing.assert_array_equal(t.place, np.arange(8))
    np.testing.assert_array_equal(t.shard_of(np.arange(8)), np.arange(8) // 2)
    np.testing.assert_array_equal(t.shard_of(np.arange(8)), j.shard_of(np.arange(8)))
    assert t.num_experts == j.num_experts == 8


def test_controller_balances_skewed_loads():
    j, t = _pair(16, 4, trigger=1.05)
    loads = _skewed()
    for _ in range(3):
        j.observe(loads)
        t.observe(loads)
    before = t.shard_loads(t.loads_ewma)
    np.testing.assert_array_equal(before, j.shard_loads(j.loads_ewma))
    changed, placement, perm = _update_both(j, t)
    after = t.shard_loads(t.loads_ewma)
    assert changed
    assert after.max() / after.mean() < before.max() / before.mean()
    assert sorted(placement.place.tolist()) == list(range(16))
    assert np.bincount(placement.inv_place // 4, minlength=4).tolist() == [4, 4, 4, 4]


def test_migration_minimal_when_balanced():
    j, t = _pair(16, 4, trigger=1.15)
    j.observe(np.ones(16))
    t.observe(np.ones(16))
    changed, _, perm = _update_both(j, t)
    assert not changed
    np.testing.assert_array_equal(perm, np.arange(16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_permutation_follows_placement(dtype):
    spec = JSpec(num_experts=8, top_k=1, d_ff_expert=8, shared_expert=True)
    jp = j_init_moe(jax.random.PRNGKey(0), 4, spec, "swiglu", jnp.float32)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)).to(dtype), jp)
    tp["router"] = tp["router"].float()
    perm = np.array([3, 1, 2, 0, 4, 5, 6, 7], np.int32)
    jp2 = jkp.apply_placement_to_weights(jp, perm)
    tp2 = tkp.apply_placement_to_weights(tp, perm)
    assert set(tp2) == set(jp2)
    for k in ("wi", "wo", "router"):
        np.testing.assert_array_equal(tp2[k].float().numpy(),
                                      torch.as_tensor(np.array(jp2[k])).to(dtype).float().numpy())
        assert tp2[k].dtype == tp[k].dtype and tp2[k].device == tp[k].device
    torch.testing.assert_close(tp2["wi"][0], tp["wi"][3], rtol=0, atol=0)
    torch.testing.assert_close(tp2["wo"][3], tp["wo"][0], rtol=0, atol=0)
    assert tp2["router"] is tp["router"] and tp2["shared"] is tp["shared"]


def test_repeated_updates_converge():
    rng = np.random.default_rng(0)
    j, t = _pair(32, 8, trigger=1.1)
    loads = rng.zipf(1.5, 32).astype(float)
    for _ in range(6):
        j.observe(loads)
        t.observe(loads)
        _update_both(j, t)
    j.observe(loads)
    t.observe(loads)
    _, _, perm = _update_both(j, t)
    assert int((perm != np.arange(32)).sum()) == 0


# ---------------------------------------------------------------------------
# tests/test_moe.py::TestReplication
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,replicas,hot", [(8, 8, 8.0), (4, 4, 30.0), (8, 0, 2.0)])
def test_replicated_assignment_matches_reference(n_shards, replicas, hot):
    loads = np.ones(16)
    loads[0] = hot
    jowner, jshard = jkp.replicated_assignment(loads, n_shards=n_shards, replicas=replicas)
    owner, shard_of = tkp.replicated_assignment(loads, n_shards=n_shards, replicas=replicas)
    np.testing.assert_array_equal(owner, jowner)
    np.testing.assert_array_equal(shard_of, jshard)
    assert owner.dtype == jowner.dtype and shard_of.dtype == jshard.dtype
    assert np.bincount(shard_of, minlength=n_shards).tolist() == [
        (16 + replicas) // n_shards] * n_shards


def test_replicated_assignment_beats_partitioning_floor():
    loads = np.ones(16)
    loads[0] = 8.0
    owner, shard_of = tkp.replicated_assignment(loads, n_shards=8, replicas=8)
    assert len(owner) == 24 and sorted(set(owner.tolist())) == list(range(16))
    counts = np.bincount(owner, minlength=16)
    assert counts[0] >= 3
    rel = loads / loads.sum()
    eff = (rel / counts)[owner]
    sl = np.zeros(8)
    np.add.at(sl, shard_of, eff)
    assert sl.max() / sl.mean() < 8 * rel.max()
    assert np.bincount(shard_of, minlength=8).tolist() == [3] * 8


def test_placement_from_assignment_keeps_unmoved_slots():
    rng = np.random.default_rng(4)
    prev_j = jkp.ExpertPlacement.identity(16, 4)
    prev_t = tkp.ExpertPlacement.identity(16, 4)
    for _ in range(5):
        shard_of = rng.permutation(np.repeat(np.arange(4), 4)).astype(np.int32)
        loads = rng.random(16)
        j = jkp.placement_from_assignment(jkp._slot_constrained(shard_of, loads, 4), prev_j, 4)
        t = tkp.placement_from_assignment(tkp._slot_constrained(shard_of, loads, 4), prev_t, 4)
        _same_placement(j, t)
        prev_j, prev_t = j, t
    over = np.zeros(16, np.int32)  # every expert on shard 0: evict to free slots
    np.testing.assert_array_equal(tkp._slot_constrained(over, np.arange(16.0), 4),
                                  jkp._slot_constrained(over, np.arange(16.0), 4))


# ---------------------------------------------------------------------------
# tests/test_control.py: the PlacementController on the control plane
# ---------------------------------------------------------------------------


def test_placement_controller_logs_decisions():
    j, t = _pair(16, 4, trigger=1.05)
    j.observe(np.ones(16))
    t.observe(np.ones(16))
    changed, _, _ = _update_both(j, t)
    assert not changed
    assert t.decisions.records[-1].reason == "balanced"
    for _ in range(3):
        j.observe(_skewed())
        t.observe(_skewed())
    changed, _, _ = _update_both(j, t)
    assert changed
    d = t.decisions.records[-1]
    assert d.taken and d.kind == "replace" and d.consumer == "moe"
    assert t.decisions.counts() == (1, 1)


@pytest.mark.parametrize("cost_weight", [0.0, 1.0, 1e9])
def test_placement_weight_costing_gates_which_placement_wins(cost_weight):
    j, t = _pair(16, 4, trigger=1.05, expert_weight_bytes=4096.0, cost_weight=cost_weight)
    for _ in range(3):
        j.observe(_skewed())
        t.observe(_skewed())
    jc, tc = j.plan_candidates(), t.plan_candidates()
    assert [c["choice"] for c in tc] == [c["choice"] for c in jc] == ["stay", "pack",
                                                                       "waterfill"]
    for a, b in zip(tc, jc):
        _same_placement(b["placement"], a["placement"])
        np.testing.assert_array_equal(a["perm"], b["perm"])
        assert (a["moved"], a["planned_imbalance"], a["est_migration"]) == (
            b["moved"], b["planned_imbalance"], b["est_migration"])
    changed, _, perm = _update_both(j, t)
    if cost_weight == 0.0:
        assert changed and (perm != np.arange(16)).any()
        assert t.history[-1]["migration_bytes"] > 0
        assert t.history[-1]["choice"] in ("pack", "waterfill")
        assert t.decisions.records[-1].detail["choice"] == t.history[-1]["choice"]
    if cost_weight == 1e9:
        assert not changed and (perm == np.arange(16)).all()
        d = t.decisions.records[-1]
        assert not d.taken and d.reason.startswith("placement gain <= migration cost")


def test_placement_costing_off_keeps_legacy_behavior():
    j, t = _pair(16, 4, trigger=1.05)
    loads = np.ones(16)
    loads[0] = 20.0
    for _ in range(3):
        j.observe(loads)
        t.observe(loads)
    changed, _, _ = _update_both(j, t)
    assert changed
    assert t.decisions.records[-1].reason.startswith("imbalance ")
    assert t.history[-1]["migration_bytes"] == 0.0


@pytest.mark.parametrize("backend,topology", [
    ("ragged", None), ("dense", (4, 2)), ("hierarchical", (4, 2)), ("dense", (4, 1))])
def test_costed_controller_on_transports_and_topologies(backend, topology):
    """Weight bytes priced by each transport's sizing rule, per distance
    class under a topology, with the cooldown between updates and a
    cooled-off hot set; every decision equal."""
    j, t = _pair(16, 4, trigger=1.05, expert_weight_bytes=251_658_240.0, cost_weight=0.5,
                 exchange_backend=backend, exchange_topology=topology, min_steps_between=2)
    rng = np.random.default_rng(7)
    for step in range(8):
        loads = rng.zipf(1.4, 16).astype(float) if step < 5 else np.ones(16)
        j.observe(loads)
        t.observe(loads)
        _update_both(j, t)
    assert len(t.decisions.records) == 8


def test_observe_takes_router_counts_and_exchange_stats():
    """``observe`` folds the router's counts and the dispatch traffic into
    the telemetry window, as the reference's."""
    j, t = _pair(8, 4, trigger=1.05)
    counts = np.asarray([9, 1, 1, 1, 1, 1, 1, 1], np.float32)
    j.observe(counts, exchange=JStats(rows=64, padded_rows=96, occupied_rows=40,
                                      backend="dense"))
    t.observe(counts, exchange=ExchangeStats(
        rows=64, padded_rows=96, occupied_rows=40, backend="dense"))
    js = j.telemetry.snapshot(loads=j.shard_loads(j.loads_ewma), num_workers=4)
    ts = t.telemetry.snapshot(loads=t.shard_loads(t.loads_ewma), num_workers=4)
    assert ts.imbalance == js.imbalance
    assert ts.records == js.records
    assert ts.exchange_padding_fraction == js.exchange_padding_fraction
    _update_both(j, t)


def test_policy_declines_with_too_few_experts_and_in_cooldown():
    j, t = _pair(4, 4, trigger=1.05)
    j.observe(_skewed()[:4])
    t.observe(_skewed()[:4])
    _update_both(j, t)
    assert t.decisions.records[-1].reason == "too-few-experts"
    j, t = _pair(16, 4, trigger=1.05, min_steps_between=3)
    reasons = []
    for _ in range(3):
        j.observe(_skewed())
        t.observe(_skewed())
        _update_both(j, t)
        reasons.append(t.decisions.records[-1].reason)
    assert reasons[1] == "cooldown"
    assert isinstance(t.policy, PlacementPolicy)
