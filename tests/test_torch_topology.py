"""The lane topology in the port against the reference, on the CPU.

* Every case of ``tests/test_topology.py``: the class tables, the weight
  matrix, resize, the frozen caches, the spec's snap and resize,
  ``exchange_topology_of``, the lane cost that flips a plan, the
  repartition policy seeing the topology, the per-class split of each
  backend, a flat spec stamping none, ``resolve_backend``, the plan's
  fallbacks, telemetry folding and the snapshots of ``DRMaster`` and
  ``StreamingJob``; each held to the reference's outputs on the same
  inputs.
* At W=8 (the reference in one subprocess with eight host devices on an
  ``Auto``-axis mesh, its ragged transport on the masked fallback,
  ``REPRO_DISABLE_NATIVE_RAGGED=1``): the collectives with their per-class
  split and the hierarchical plan; three jobs (flat dense, dense with a
  two-host topology, hierarchical) by the three drivers, every
  ``BatchMetrics`` field but the walls and ``overlap_fraction``, the
  snapshot and ``inter_host_fraction`` equal; the hierarchical job under a
  lane kill, evicted onto 7 lanes where the ship falls back to flat.
* Decisions: the bench's locality decisions, the health policy's priced
  fold and the serving scheduler, each with a topology, against the
  reference's decision logs.

Integer outputs are compared exactly; the float outputs compared here
(costs, imbalances, fractions) are equal exactly too.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.control import Signals as JSignals
from repro.control import Telemetry as JTelemetry
from repro.control.health import _fold_cost as j_fold_cost
from repro.core.drm import DRConfig as JDRConfig
from repro.core.drm import DRMaster as JDRMaster
from repro.core.migration import MigrationPlan as JMigrationPlan
from repro.core.migration import exchange_lane_cost as j_lane_cost
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.core.streaming import StreamingJob as JStreamingJob
from repro.exchange import ExchangeSpec as JSpec
from repro.exchange import ExchangeStats as JStats
from repro.exchange import ExchangeTopology as JTopology
from repro.exchange.spec import _class_tables as j_class_tables
from repro.launch.mesh import exchange_topology_of as j_topology_of
from repro.serve.scheduler import DRScheduler as JScheduler
from repro_torch.control import Signals, Telemetry
from repro_torch.control.health import _fold_cost
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.migration import MigrationPlan, exchange_lane_cost
from repro_torch.core.partitioner import uniform_partitioner
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import drifting_zipf
from repro_torch.exchange import (
    ExchangeSpec,
    ExchangeStats,
    ExchangeTopology,
    FaultPlan,
    FaultyBackend,
    HierarchicalBackend,
    Payload,
    make_exchange,
    resolve_backend,
)
from repro_torch.exchange.spec import DISTANCE_CLASSES, _class_tables
from repro_torch.launch.mesh import exchange_topology_of
from repro_torch.serve.scheduler import DRScheduler

REPO = Path(__file__).resolve().parents[1]
DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
TOPOLOGIES = [(8, 4), (7, 4), (8, 2), (4, 2), (1, 1), (5, 1), (16, 4), (6, 6), (3, 8)]


def _t(x):
    return torch.as_tensor(np.array(x))


def _fields(m) -> dict:
    d = m if isinstance(m, dict) else dataclasses.asdict(m)
    d = {k: v for k, v in d.items() if k not in WALLS}
    d["shipped_rows_by_class"] = [int(x) for x in d["shipped_rows_by_class"]]
    return d


def _assert_same_snapshot(ref: dict, port: dict):
    assert sorted(ref) == sorted(port)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _decision_rows(log):
    return [(d.tick, d.kind, d.taken, d.reason, d.imbalance, sorted(d.detail.items()))
            for d in log.records]


# ---------------------------------------------------------------------------
# ExchangeTopology: distance-class tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes,per_host", TOPOLOGIES)
def test_topology_class_tables(lanes, per_host):
    """The class matrix, the per-worker class counts and the one-hot masks
    are the reference's, table for table and dtype for dtype."""
    topo, ref = ExchangeTopology(lanes, per_host), JTopology(lanes, per_host)
    assert topo.num_hosts == ref.num_hosts
    for name in ("class_matrix", "class_lane_counts", "class_onehot"):
        a, b = getattr(topo, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(topo.class_lane_counts.sum(axis=1), np.full(lanes, lanes))
    np.testing.assert_array_equal(topo.class_onehot.sum(axis=2), topo.class_lane_counts)
    if (lanes, per_host) == (8, 4):
        cm = topo.class_matrix
        np.testing.assert_array_equal(np.diag(cm), np.zeros(8))
        assert cm[0, 3] == 1 and cm[4, 7] == 1 and cm[0, 4] == 2 and cm[7, 0] == 2
        np.testing.assert_array_equal(topo.class_lane_counts, np.tile([1, 3, 4], (8, 1)))


def test_topology_weight_matrix_and_resize():
    topo = ExchangeTopology(8, 4, (0.0, 1.0, 10.0))
    ref = JTopology(8, 4, (0.0, 1.0, 10.0))
    wm = topo.weight_matrix()
    assert wm[0, 0] == 0.0 and wm[0, 1] == 1.0 and wm[0, 4] == 10.0
    small = topo.resized(4)
    assert small.num_hosts == 1 and small.weight_matrix().max() == 1.0
    assert topo.weight_matrix(4).shape == (4, 4)
    for n in (None, 4, 7, 12):
        a, b = topo.weight_matrix(n), ref.weight_matrix(n)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for n in (1, 4, 7, 16):
        a, b = topo.resized(n), ref.resized(n)
        assert (a.num_lanes, a.lanes_per_host, a.class_weights, a.num_hosts) == (
            b.num_lanes, b.lanes_per_host, b.class_weights, b.num_hosts)
    # 8 lanes at 4 a host shrunk to 7: two hosts of 4 and 3
    np.testing.assert_array_equal(topo.resized(7).class_lane_counts,
                                  [[1, 3, 3]] * 4 + [[1, 2, 4]] * 3)


def test_topology_tables_are_cached_and_frozen():
    a = _class_tables(8, 4)
    assert a is _class_tables(8, 4)
    for table in a:
        with pytest.raises(ValueError):
            table.flat[0] = 7
    # the reference's tables are the same constants
    for x, y in zip(a, j_class_tables(8, 4)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bad", [dict(num_lanes=0, lanes_per_host=1),
                                 dict(num_lanes=4, lanes_per_host=0),
                                 dict(num_lanes=4, lanes_per_host=2, class_weights=(0.0, 1.0))])
def test_topology_checks(bad):
    """Both packages refuse a topology without lanes, without hosts, or with
    the wrong number of class weights (the reference by assertion)."""
    with pytest.raises(ValueError):
        ExchangeTopology(**bad)
    with pytest.raises(AssertionError):
        JTopology(**bad)
    # weights are stored as floats, as the reference stores them
    weights = (0, 2, 5)
    assert ExchangeTopology(4, 2, weights).class_weights == JTopology(4, 2, weights).class_weights


def test_spec_resized_rederives_topology():
    topo = ExchangeTopology(8, 4)
    spec = ExchangeSpec(num_lanes=8, capacity=32, axis="data", topology=topo)
    jspec = JSpec(num_lanes=8, capacity=32, axis="data", topology=JTopology(8, 4))
    for kw in (dict(num_lanes=16), dict(num_lanes=4), dict(num_lanes=7), dict(capacity=64),
               dict(num_lanes=5, capacity=3)):
        a, b = spec.resized(**kw), jspec.resized(**kw)
        assert (a.num_lanes, a.capacity, a.axis, a.rows) == (b.num_lanes, b.capacity, b.axis,
                                                             b.rows)
        assert (a.topology.num_lanes, a.topology.lanes_per_host, a.topology.num_hosts) == (
            b.topology.num_lanes, b.topology.lanes_per_host, b.topology.num_hosts)
    assert spec.resized(num_lanes=16).topology.num_hosts == 4
    assert spec.resized(num_lanes=4).topology.num_hosts == 1
    assert spec.resized(capacity=64).topology == topo
    assert ExchangeSpec(8, 32, axis="data").resized(num_lanes=4).topology is None


def test_spec_snaps_mismatched_topology():
    spec = ExchangeSpec(num_lanes=16, capacity=8, axis="data", topology=ExchangeTopology(8, 4))
    assert spec.topology == ExchangeTopology(16, 4)
    jspec = JSpec(num_lanes=16, capacity=8, axis="data", topology=JTopology(8, 4))
    assert (jspec.topology.num_lanes, jspec.topology.lanes_per_host) == (16, 4)


def test_exchange_topology_of():
    """One process has no host boundary: all lanes on one host, as the
    reference's topology of a single-process mesh; a modelled boundary
    and custom pricing thread through."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("data",))
    ref = j_topology_of(mesh)
    topo = exchange_topology_of(mesh.shape["data"])
    assert (topo.num_lanes, topo.lanes_per_host, topo.num_hosts, topo.class_weights) == (
        ref.num_lanes, ref.lanes_per_host, ref.num_hosts, ref.class_weights)
    topo = exchange_topology_of(8)
    assert topo.lanes_per_host == topo.num_lanes == 8 and topo.num_hosts == 1
    ref = j_topology_of(mesh, lanes_per_host=1, class_weights=(0.0, 2.0, 5.0))
    topo = exchange_topology_of(mesh.shape["data"], lanes_per_host=1,
                                class_weights=(0.0, 2.0, 5.0))
    assert (topo.num_lanes, topo.lanes_per_host, topo.num_hosts, topo.class_weights) == (
        ref.num_lanes, ref.lanes_per_host, ref.num_hosts, ref.class_weights)
    assert exchange_topology_of(8, lanes_per_host=4) == ExchangeTopology(8, 4)


# ---------------------------------------------------------------------------
# locality-priced plan cost, and the policies that read it
# ---------------------------------------------------------------------------


def _plan_moving(cls, src: int, dst: int, rows: float, n: int = 4):
    transfer = np.zeros((n, n))
    transfer[src, dst] = rows
    return cls(keys=np.zeros(1, np.int64), src=np.array([src], np.int32),
               dst=np.array([dst], np.int32), weights=np.array([rows]),
               transfer=transfer, relative_migration=0.1, num_src=n, num_dst=n)


def test_exchange_lane_cost_topology_flips_plan_choice():
    """Flat pricing prefers the plan that moves less mass across hosts'
    boundary; the 10x inter-host price flips the order; self traffic is
    free.  Every value is the reference's."""
    for cost, plan, topo in ((exchange_lane_cost, MigrationPlan, ExchangeTopology(4, 2)),
                             (j_lane_cost, JMigrationPlan, JTopology(4, 2))):
        a, b = _plan_moving(plan, 0, 1, 100.0), _plan_moving(plan, 0, 2, 90.0)
        flat = (cost(a, num_workers=4), cost(b, num_workers=4))
        priced = (cost(a, num_workers=4, topology=topo), cost(b, num_workers=4, topology=topo))
        assert flat[1] < flat[0] and priced[0] < priced[1]
        assert cost(_plan_moving(plan, 1, 1, 50.0), topology=topo) == 0.0
        if cost is exchange_lane_cost:
            port = (flat, priced)
        else:
            assert (flat, priced) == port


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("workers", [None, 2, 4, 8])
def test_exchange_lane_cost_matches_reference(seed, workers):
    """Random plans over 8 partitions, folded to the worker count (or not),
    under three topologies and both backends' rules."""
    from repro.exchange import DenseBackend as JDense
    from repro.exchange import RaggedBackend as JRagged
    from repro_torch.exchange import DenseBackend, RaggedBackend

    rng = np.random.default_rng(seed)
    transfer = rng.random((8, 8)) * rng.integers(1, 100)
    for topo in ((8, 4), (4, 1), (8, 8)):
        for be, jbe in ((None, None), (DenseBackend(), JDense()), (RaggedBackend(), JRagged())):
            port = MigrationPlan(np.zeros(1, np.int64), np.zeros(1, np.int32),
                                 np.zeros(1, np.int32), np.ones(1), transfer, 0.1, 8, 8)
            ref = JMigrationPlan(np.zeros(1, np.int64), np.zeros(1, np.int32),
                                 np.zeros(1, np.int32), np.ones(1), transfer, 0.1, 8, 8)
            a = exchange_lane_cost(port, num_workers=workers, backend=be,
                                   topology=ExchangeTopology(*topo, (0.0, 1.0, 7.5)))
            b = j_lane_cost(ref, num_workers=workers, backend=jbe,
                            topology=JTopology(*topo, (0.0, 1.0, 7.5)))
            assert a == b, (topo, be)


def _policy_window(seed=0):
    rng = np.random.default_rng(seed)
    keys = np.repeat(np.arange(64), rng.integers(1, 200, 64))
    loads = np.bincount(uniform_partitioner(4, seed=0).lookup_np(keys.astype(np.int32)),
                        minlength=4).astype(float)
    return keys, loads


def test_repartition_policy_sees_host_topology():
    """The same imbalanced window is cheap to fix when moves stay within a
    host's price and dear when every move crosses hosts at 1e6: the first
    repartitions, the second declines, in both packages with equal
    decisions."""
    keys, loads = _policy_window()
    for name, weights in (("cheap", (0.0, 1.0, 1.0)), ("dear", (0.0, 1e6, 1e6))):
        out = []
        for master, cfg, part, topo, tel in (
                (DRMaster, DRConfig, uniform_partitioner, ExchangeTopology, Telemetry),
                (JDRMaster, JDRConfig, j_uniform, JTopology, JTelemetry)):
            drm = master(part(4, seed=0), cfg(imbalance_trigger=1.05, migration_cost_weight=1.0),
                         exchange_topology=topo(4, 1, weights))
            drm.observe(keys.reshape(1, -1).astype(np.int32), np.ones((1, len(keys)), np.int32))
            t = tel("t")
            t.record_batch(float(len(keys)))
            out.append(drm.evaluate(t.snapshot(loads=loads, num_workers=4, at_safe_point=True)))
            out.append(_decision_rows(drm.decisions))
        assert out[1] == out[3]
        assert dataclasses.asdict(out[0]).keys() == dataclasses.asdict(out[2]).keys()
        assert out[0].taken == (name == "cheap"), out[0].reason
        assert (out[0].kind, out[0].taken, out[0].reason) == (out[2].kind, out[2].taken,
                                                              out[2].reason)


def test_locality_decisions_match_the_bench():
    """``benchmarks/bench_streaming.py::_topology_decisions``: the same four
    windows through a blind master and one under an all-inter topology at
    400x.  The decision logs equal the reference's, blind and aware, and
    the aware master takes fewer actions."""
    def logs(master, cfg, part, topo_cls, tel_cls):
        rng = np.random.default_rng(29)
        keys = np.repeat(np.arange(64), rng.integers(1, 200, 64)).astype(np.int32)
        out = {}
        for tag, topo in (("blind", None), ("aware", topo_cls(4, 1, (0.0, 1.0, 400.0)))):
            drm = master(part(4, seed=0), cfg(imbalance_trigger=1.05, migration_cost_weight=1.0),
                         exchange_topology=topo)
            for _ in range(4):
                drm.observe(keys.reshape(1, -1), np.ones((1, len(keys)), np.int32),
                            total_records=float(len(keys)))
                tel = tel_cls("bench")
                tel.record_batch(float(len(keys)))
                loads = np.bincount(drm.partitioner.lookup_np(keys), minlength=4).astype(float)
                drm.evaluate(tel.snapshot(loads=loads, num_workers=4, at_safe_point=True))
            out[tag] = _decision_rows(drm.decisions)
        return out

    port = logs(DRMaster, DRConfig, uniform_partitioner, ExchangeTopology, Telemetry)
    ref = logs(JDRMaster, JDRConfig, j_uniform, JTopology, JTelemetry)
    assert port == ref
    taken = {tag: sum(r[2] for r in rows) for tag, rows in port.items()}
    flips = sum(a[1:3] != b[1:3] for a, b in zip(port["aware"], port["blind"]))
    assert flips >= 1 and taken["aware"] < taken["blind"], port


def _health_signals(sig_cls, w, straggle=None):
    return sig_cls(loads=np.ones(w), num_workers=w, at_safe_point=True,
                   lane_straggle_s=None if straggle is None else np.asarray(straggle, np.float64))


@pytest.mark.parametrize("weights", [(0.0, 1.0, 10.0), (0.0, 1.0, 400.0), (0.0, 3.0, 3.0)])
def test_fold_cost_prices_with_host_topology(weights):
    """The health policy prices a quarantine's fold (and a recovery's
    fold-back) with the host's topology, as the reference does: the cost
    and the actions equal the reference's, and the cost differs from the
    flat one."""
    slow = [0.0, 0.0, 0.2, 0.0]
    steps = [(4, slow), (4, slow), (3, None), (3, None), (3, None)]
    cfg = dict(health_enabled=True, health_straggler_ms=50.0, health_patience=2,
               health_recover_after=2, imbalance_trigger=1e9, migration_cost_weight=0.02)
    out = []
    for master, conf, part, topo, sig in (
            (DRMaster, DRConfig, uniform_partitioner, ExchangeTopology, Signals),
            (JDRMaster, JDRConfig, j_uniform, JTopology, JSignals)):
        drm = master(part(4, 64, 0), conf(**cfg), exchange_topology=topo(4, 2, weights))
        actions = [drm.evaluate(_health_signals(sig, w, s)) for w, s in steps]
        out.append(([(a.kind, dataclasses.asdict(a)) for a in actions],
                    _decision_rows(drm.decisions),
                    _fold_cost(drm, 4, 2) if master is DRMaster else j_fold_cost(drm, 4, 2)))
    assert out[0] == out[1]
    kinds = [kind for kind, _ in out[0][0]]
    assert "quarantine" in kinds, kinds
    flat = _fold_cost(DRMaster(uniform_partitioner(4, 64, 0), DRConfig(**cfg)), 4, 2)
    assert out[0][2] != flat
    quarantine = next(a for kind, a in out[0][0] if kind == "quarantine")
    assert quarantine["est_migration"] == out[0][2]


@pytest.mark.parametrize("topo", [(8, 4), (8, 1, (0.0, 1.0, 400.0)), (8, 2, (0.0, 2.0, 3.0))])
def test_scheduler_with_topology_matches_reference(topo):
    """``DRScheduler(topology=...)`` reaches its DR master: every route,
    checkpoint and decision equals the reference's."""
    rng = np.random.default_rng(3)
    hot = np.array([7, 13, 99, 1234])
    r = rng.random(8000)
    keys = np.where(r < 0.4, hot[rng.integers(0, 4, 8000)],
                    rng.integers(0, 5000, 8000)).astype(np.int64)
    scheds = (DRScheduler(8, topology=ExchangeTopology(*topo)),
              JScheduler(8, topology=JTopology(*topo)))
    assert scheds[0].drm.exchange_topology == ExchangeTopology(*topo)
    traces = []
    for sched in scheds:
        trace = []
        for i in range(8):
            win = keys[i * 1000: (i + 1) * 1000]
            trace.append([sched.route(int(k), cost_tokens=1.0) for k in win])
            trace.append(sched.checkpoint(win))
            sched.drain(tokens_per_replica=150)
        traces.append(trace)
    assert traces[0] == traces[1]
    assert _decision_rows(scheds[0].drm.decisions) == _decision_rows(scheds[1].drm.decisions)
    _assert_same_snapshot(scheds[1].drm.snapshot(), scheds[0].drm.snapshot())


# ---------------------------------------------------------------------------
# per-class accounting on the backends, and the plan
# ---------------------------------------------------------------------------


def _exchange_inputs(seed, w, n=96, payload_dim=3):
    rng = np.random.default_rng(seed)
    lane = rng.integers(0, w, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) < 0.85
    vals = rng.normal(size=(w, n, payload_dim)).astype(np.float32)
    return lane, valid, vals


@pytest.mark.parametrize("backend", ["dense", "ragged", "hierarchical"])
@pytest.mark.parametrize("lanes,per_host", [(4, 2), (8, 4), (8, 1), (8, 8), (6, 4)])
@pytest.mark.parametrize("split", [False, True])
def test_by_class_sums_to_scalar_and_rows_bit_identical(backend, lanes, per_host, split):
    """Each backend's per-class split refines its own ``shipped_rows``,
    worker by worker, while the received rows, the mask and the overflow
    stay the dense backend's, fused or split-phase."""
    lane, valid, vals = _exchange_inputs(lanes * 10 + per_host, lanes)
    spec = ExchangeSpec(lanes, 16, axis="data", topology=ExchangeTopology(lanes, per_host))
    args = (_t(lane), _t(valid), [Payload(_t(vals), -1.0)])
    ex = make_exchange(spec, backend)
    res = ex.finish(ex.start(*args)) if split else ex(*args)
    ref = make_exchange(spec, "dense")(*args)
    assert torch.equal(res.valid, ref.valid) and torch.equal(res.payloads[0], ref.payloads[0])
    assert torch.equal(res.send.overflow, ref.send.overflow)
    by = res.shipped_rows_by_class
    assert by.shape == (lanes, DISTANCE_CLASSES)
    assert torch.equal(by.sum(dim=1), res.shipped_rows)
    if backend == "hierarchical":
        # the intra tier dense, the inter tier the rows sent to other hosts
        counts = ref.valid.sum(dim=2).T  # rows each worker sent on each lane
        other = torch.as_tensor(ExchangeTopology(lanes, per_host).class_matrix == 2)
        assert torch.equal(by[:, 2], (counts * other).sum(dim=1))
        assert (by[:, 0] == 16).all() and (by[:, 1] == (lanes - 1) * 16).all()


def test_flat_spec_stamps_no_classes():
    ex = make_exchange(ExchangeSpec(num_lanes=3, capacity=4))
    res = ex(_t([[0, 1, 2]]), torch.ones((1, 3), dtype=torch.bool),
             [Payload(torch.arange(3, dtype=torch.float32)[None], 0)])
    assert res.shipped_rows_by_class is None and res.stats().rows_by_class is None
    for be in ("dense", "ragged", "hierarchical"):
        res = make_exchange(ExchangeSpec(2, 4, axis="data"), be)(
            _t([[0, 1], [1, 0]]), torch.ones((2, 2), dtype=torch.bool),
            [Payload(torch.ones(2, 2), 0)])
        assert res.shipped_rows_by_class is None and res.stats().rows_by_class is None


def test_resolve_backend_knows_hierarchical():
    assert isinstance(resolve_backend("hierarchical"), HierarchicalBackend)
    assert resolve_backend("hierarchical").name == "hierarchical"
    assert make_exchange(ExchangeSpec(8, 4, axis="data"), "hierarchical").backend.name == (
        "hierarchical")


def test_hierarchical_plan_fallback_conditions():
    """The two-hop plan needs a topology, more than one host, more than one
    lane a host, lanes a multiple of the host width, and one stacked
    worker a lane; everything else ships flat."""
    be = HierarchicalBackend()
    topo = ExchangeTopology(8, 4)
    assert be._plan(ExchangeSpec(8, 4, axis="data", topology=topo), 8) == (2, 4)
    assert be._plan(ExchangeSpec(8, 4, axis="data", topology=topo), 1) is None  # one worker
    assert be._plan(ExchangeSpec(8, 4, axis="data"), 8) is None                 # no topology
    assert be._plan(ExchangeSpec(8, 4, axis="data", topology=ExchangeTopology(8, 8)), 8) is None
    assert be._plan(ExchangeSpec(8, 4, axis="data", topology=ExchangeTopology(8, 1)), 8) is None
    assert be._plan(ExchangeSpec(7, 4, axis="data", topology=topo), 7) is None  # 7 % 4
    assert be._plan(ExchangeSpec(8, 4, axis="data", topology=ExchangeTopology(8, 12)), 8) is None
    # the reference, outside any mesh, has no axis size: flat too
    from repro.exchange import HierarchicalBackend as JHier
    assert JHier()._plan(JSpec(8, 4, axis="data", topology=JTopology(8, 4))) is None


# ---------------------------------------------------------------------------
# telemetry and snapshots
# ---------------------------------------------------------------------------


def test_telemetry_folds_rows_by_class_into_signals():
    out = []
    for tel, stats in ((Telemetry, ExchangeStats), (JTelemetry, JStats)):
        t = tel("test")
        t.record_exchange(stats(rows=30, rows_by_class=np.array([10, 10, 10])))
        t.record_exchange(stats(rows=6, rows_by_class=np.array([2, 2, 2])))
        t.record_exchange(stats(rows=0))
        s = t.snapshot(loads=np.ones(3))
        np.testing.assert_array_equal(s.exchange_rows_by_class, [12, 12, 12])
        assert s.inter_host_fraction == pytest.approx(12 / 36)
        s2 = tel("flat").snapshot(loads=np.ones(3))
        assert s2.exchange_rows_by_class is None and s2.inter_host_fraction == 0.0
        out.append((s.exchange_rows_by_class.dtype, s.inter_host_fraction))
    assert out[0] == out[1]
    # an all-zero window has a well-defined zero fraction
    assert Signals(loads=np.ones(2), exchange_rows_by_class=np.zeros(3)).inter_host_fraction == 0.0


def test_drm_snapshot_roundtrips_topology():
    """The three ``topology_*`` keys ride only when a topology is set, with
    the reference's dtypes, and cross the packages both ways; a snapshot
    without the weights takes the default weights."""
    for master, cfg, part, topo_cls in ((DRMaster, DRConfig, uniform_partitioner, ExchangeTopology),
                                        (JDRMaster, JDRConfig, j_uniform, JTopology)):
        topo = topo_cls(4, 2, (0.0, 2.0, 7.0))
        snap = master(part(4, seed=0), cfg(), exchange_topology=topo).snapshot()
        assert master.restore(snap, cfg()).exchange_topology == topo
        flat = master(part(4, seed=0), cfg()).snapshot()
        assert not any(k.startswith("topology_") for k in flat)
        assert master.restore(flat, cfg()).exchange_topology is None
        if master is DRMaster:
            port_snap, port_flat = snap, flat
        else:
            _assert_same_snapshot(snap, port_snap)
            _assert_same_snapshot(flat, port_flat)
            assert np.asarray(snap["topology_class_weights"]).dtype == np.float64
    back = JDRMaster.restore(port_snap, JDRConfig()).exchange_topology
    assert (back.num_lanes, back.lanes_per_host, back.class_weights) == (4, 2, (0.0, 2.0, 7.0))
    assert DRMaster.restore(snap, DRConfig()).exchange_topology == ExchangeTopology(
        4, 2, (0.0, 2.0, 7.0))
    no_weights = {k: v for k, v in port_snap.items()
                  if k not in ("topology_class_weights", "topology_num_lanes")}
    port = DRMaster.restore(no_weights, DRConfig()).exchange_topology
    ref = JDRMaster.restore(no_weights, JDRConfig()).exchange_topology
    assert (port.num_lanes, port.lanes_per_host, port.class_weights) == (
        ref.num_lanes, ref.lanes_per_host, ref.class_weights) == (4, 2, (0.0, 1.0, 10.0))


def _copied(snap: dict) -> dict:
    """A snapshot's arrays copied: the reference's snapshot holds its live
    sketch counts, which the next batch decays in place (ROADMAP.md, queue
    3)."""
    return {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in snap.items()}


def _w1_reference(**kw):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    return JStreamingJob(mesh=mesh, state_capacity=512, **kw)


def test_streaming_snapshot_carries_topology():
    """A one-worker job with a topology: its snapshot restored into a job
    built flat adopts the topology (job and master), and the next batch's
    classes sum to its shipped rows; the reference does the same, with
    equal metrics and snapshots."""
    batch = np.arange(64, dtype=np.int64)
    runs = []
    for make, topo in ((lambda **kw: StreamingJob(device="cpu", state_capacity=512, **kw),
                        ExchangeTopology(1, 1)),
                       (_w1_reference, JTopology(1, 1))):
        job = make(topology=topo)
        first = job.process_batch(batch)
        snap = _copied(job.snapshot())
        fresh = make()
        fresh.restore(_copied(snap))
        assert fresh.exchange_topology == topo and fresh.drm.exchange_topology == topo
        m = fresh.process_batch(batch)
        assert sum(m.shipped_rows_by_class) == m.shipped_rows > 0
        runs.append((first, m, snap, _copied(fresh.snapshot())))
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert _fields(a) == _fields(b)
    _assert_same_snapshot(runs[1][2], runs[0][2])
    _assert_same_snapshot(runs[1][3], runs[0][3])


def test_restore_keeps_the_construction_topology_of_a_flat_snapshot():
    """A flat snapshot keeps the topology the job was built with, and the
    snapshot's own topology wins over it, as in the reference."""
    batch = np.arange(256, dtype=np.int64)
    built = ExchangeTopology(2, 1, (0.0, 1.0, 3.0))
    flat = StreamingJob(device="cpu", num_workers=2, state_capacity=512)
    flat.process_batch(batch)
    job = StreamingJob(device="cpu", num_workers=2, state_capacity=512, topology=built)
    job.restore(flat.snapshot())
    assert job.exchange_topology == job.drm.exchange_topology == built
    m = job.process_batch(batch)
    assert sum(m.shipped_rows_by_class) == m.shipped_rows and m.shipped_rows_by_class[2] > 0
    other = StreamingJob(device="cpu", num_workers=2, state_capacity=512,
                         topology=ExchangeTopology(2, 2))
    other.restore(job.snapshot())
    assert other.exchange_topology == other.drm.exchange_topology == built


# ---------------------------------------------------------------------------
# W=8: the collectives and three jobs against the reference
# ---------------------------------------------------------------------------

REFERENCE_W8 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.core.drm import DRConfig
    from repro.core.streaming import StreamingJob
    from repro.data.generators import drifting_zipf
    from repro.exchange import (ExchangeSpec, ExchangeTopology, FaultPlan, FaultyBackend,
                                HierarchicalBackend, Payload, make_exchange)
    cases, jobs, drivers, cfg, stream, loss = json.loads(sys.argv[2])
    inputs = np.load(sys.argv[3])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("data",))
    out = {}
    topo_of = lambda t: None if t is None else ExchangeTopology(*t)
    for name, (backend, topo, split) in cases.items():
        ex = make_exchange(ExchangeSpec(8, 16, axis="data", topology=topo_of(topo)), backend)

        def body(lane, valid, vals):
            args = (lane, valid, [Payload(vals, -1.0)])
            res = ex.finish(ex.start(*args)) if split else ex(*args)
            va, (v,) = res.unpack()
            by = res.shipped_rows_by_class
            by = jnp.full(3, -9, jnp.int32) if by is None else by
            plan = HierarchicalBackend()._plan(ex.spec)
            plan = jnp.asarray((-1, -1) if plan is None else plan, jnp.int32)
            return (va[None], v[None], res.shipped_rows[None], by[None], plan[None],
                    res.send.overflow[None], res.send.lane_overflow[None])

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 3,
                              out_specs=(P("data"),) * 7, check_vma=False))
        got = f(*(jnp.asarray(inputs[k]) for k in ("lane", "valid", "vals")))
        for k, v in zip(("valid", "vals", "shipped", "by_class", "plan", "overflow",
                         "lane_overflow"), got):
            out[f"{name}/{k}"] = np.asarray(v)

    copied = lambda snap: {k: v.copy() if isinstance(v, np.ndarray) else v
                           for k, v in snap.items()}
    class CopyingJob(StreamingJob):  # snapshots taken and restored as copies
        def snapshot(self):
            return copied(super().snapshot())
        def restore(self, snap, **kw):
            super().restore(copied(snap), **kw)

    def record(job, name):
        fractions = []
        snapshot = job.telemetry.snapshot
        def spy(*a, **k):
            sig = snapshot(*a, **k)
            fractions.append(sig.inter_host_fraction)
            return sig
        job.telemetry.snapshot = spy
        return fractions

    def feed(job, dname, batches):
        if dname == "depth 1":
            for b in batches:
                job.process_batch(b)
        else:
            job.run(batches)

    batches = list(drifting_zipf(3, 8192, **stream))
    for jname, (topo, backend) in jobs.items():
        for dname, extra in drivers.items():
            job = StreamingJob(mesh=mesh, num_partitions=8, state_capacity=4096,
                               dr=DRConfig(**cfg, **extra), topology=topo_of(topo),
                               exchange_backend=backend)
            fractions = record(job, jname)
            feed(job, dname, batches)
            name = f"{jname}/{dname}"
            out[f"{name}/metrics"] = json.dumps([dataclasses.asdict(m) for m in job.metrics])
            out[f"{name}/fractions"] = np.asarray(fractions)
            for k, v in job.snapshot().items():
                out[f"{name}/snap/{k}"] = np.asarray(v)

    lcfg, plan, topo = loss
    batches = list(drifting_zipf(8, 8192, **stream))
    for dname, extra in drivers.items():
        job = CopyingJob(mesh=mesh, num_partitions=8, state_capacity=4096,
                         dr=DRConfig(**lcfg, **extra), topology=topo_of(topo),
                         exchange_backend=FaultyBackend("hierarchical",
                                                        FaultPlan.from_dict(plan)))
        feed(job, dname, batches)
        name = f"loss/{dname}"
        out[f"{name}/metrics"] = json.dumps([dataclasses.asdict(m) for m in job.metrics])
        out[f"{name}/extra"] = json.dumps(dict(
            recoveries=[(r.lane, r.kind, r.replayed, r.workers) for r in job.recoveries],
            lane_ids=job._lane_ids))
        for k, v in job.snapshot().items():
            out[f"{name}/snap/{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")

# the collectives at W=8, 96 records a worker into lanes of 16: name ->
# (backend, topology or None, split phase)
W8_CASES = {
    "dense/8x4": ("dense", (8, 4), False),
    "dense/8x1/split": ("dense", (8, 1), True),
    "ragged/8x4": ("ragged", (8, 4), False),
    "ragged/8x8": ("ragged", (8, 8), True),
    "ragged/8x1": ("ragged", (8, 1), False),
    "hierarchical/8x4": ("hierarchical", (8, 4), False),
    "hierarchical/8x2/split": ("hierarchical", (8, 2), True),
    "hierarchical/8x3": ("hierarchical", (8, 3), False),
    "hierarchical/flat": ("hierarchical", None, False),
}
# the three jobs of the probe: name -> (topology, backend)
W8_JOBS = {"flat dense": (None, "dense"), "dense": ((8, 4), "dense"),
           "hierarchical": ((8, 4), "hierarchical")}
W8_CFG = dict(imbalance_trigger=1.05, migration_cost_weight=0.0)
W8_STREAM = dict(num_keys=2000, exponent=1.5, drift_every=2, drift_fraction=0.4, seed=3)
# the loss: lane 5 killed at tick 4, auto-snapshots every 3 batches
W8_LOSS = (dict(W8_CFG, snapshot_interval=3),
           dict(faults=[dict(tick=4, lane=5, kind="kill")]), (8, 4))
# the probe's hierarchical rows by class, per worker, batch by batch
HIER_BY_CLASS = [[2176, 15232, 523], [2048, 14336, 514], [2304, 16128, 540]]


@pytest.fixture(scope="module")
def reference_w8(tmp_path_factory):
    d = tmp_path_factory.mktemp("topology_w8")
    lane, valid, vals = _exchange_inputs(21, 8)
    np.savez(d / "in.npz", lane=lane.reshape(-1), valid=valid.reshape(-1),
             vals=vals.reshape(-1, 3))
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    args = json.dumps([W8_CASES, W8_JOBS, DRIVERS, W8_CFG, W8_STREAM, W8_LOSS])
    proc = subprocess.run([sys.executable, "-c", REFERENCE_W8, str(d / "out.npz"), args,
                           str(d / "in.npz")], env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return (lane, valid, vals), np.load(d / "out.npz")


@pytest.mark.parametrize("name", list(W8_CASES))
def test_w8_collective_matches_reference(reference_w8, name):
    """Received rows, shipped rows, the per-class split, overflow and the
    hierarchical plan equal the reference's, worker by worker."""
    (lane, valid, vals), ref = reference_w8
    backend, topo, split = W8_CASES[name]
    spec = ExchangeSpec(8, 16, axis="data",
                        topology=None if topo is None else ExchangeTopology(*topo))
    ex = make_exchange(spec, backend)
    args = (_t(lane), _t(valid), [Payload(_t(vals), -1.0)])
    res = ex.finish(ex.start(*args)) if split else ex(*args)
    va, (v,) = res.unpack()
    np.testing.assert_array_equal(va.numpy(), ref[f"{name}/valid"])
    np.testing.assert_array_equal(v.numpy(), ref[f"{name}/vals"])
    np.testing.assert_array_equal(res.shipped_rows.numpy(), ref[f"{name}/shipped"])
    np.testing.assert_array_equal(res.send.overflow.numpy(), ref[f"{name}/overflow"])
    np.testing.assert_array_equal(res.send.lane_overflow.numpy(), ref[f"{name}/lane_overflow"])
    by = (np.full((8, 3), -9) if res.shipped_rows_by_class is None
          else res.shipped_rows_by_class.numpy())
    np.testing.assert_array_equal(by, ref[f"{name}/by_class"])
    plan = HierarchicalBackend()._plan(spec, 8)
    np.testing.assert_array_equal(np.asarray((-1, -1) if plan is None else plan),
                                  ref[f"{name}/plan"][0])
    if backend == "hierarchical":
        assert (ex.backend.two_hop_ships, ex.backend.flat_ships) == (
            (1, 0) if plan is not None else (0, 1))


def _ref_metrics(ref, name):
    return [_fields(m) for m in json.loads(str(ref[f"{name}/metrics"]))]


def _ref_snapshot(ref, name):
    prefix = f"{name}/snap/"
    return {k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}


def _feed(job, driver, batches):
    if driver == "depth 1":
        for b in batches:
            job.process_batch(b)
    else:
        job.run(batches)


def _port_w8_job(jname, driver, **kw):
    topo, backend = W8_JOBS[jname]
    return StreamingJob(device="cpu", num_workers=8, num_partitions=8, state_capacity=4096,
                        dr=DRConfig(**W8_CFG, **DRIVERS[driver]),
                        topology=None if topo is None else ExchangeTopology(*topo),
                        exchange_backend=backend, **kw)


@pytest.mark.parametrize("driver", list(DRIVERS))
@pytest.mark.parametrize("jname", list(W8_JOBS))
def test_w8_jobs_match_reference(reference_w8, jname, driver):
    """Every metric but the walls (``shipped_rows`` and its classes
    included), the snapshot (topology keys included) and the inter-host
    fraction of every safe point equal the reference's."""
    _, ref = reference_w8
    batches = list(drifting_zipf(3, 8192, **W8_STREAM))
    job = _port_w8_job(jname, driver)
    fractions = []
    snapshot = job.telemetry.snapshot

    def spy(*a, **k):
        sig = snapshot(*a, **k)
        fractions.append(sig.inter_host_fraction)
        return sig

    job.telemetry.snapshot = spy
    _feed(job, driver, batches)
    name = f"{jname}/{driver}"
    assert [_fields(m) for m in job.metrics] == _ref_metrics(ref, name)
    np.testing.assert_array_equal(np.asarray(fractions), ref[f"{name}/fractions"])
    _assert_same_snapshot(_ref_snapshot(ref, name), job.snapshot())
    for m in job.metrics:
        assert sum(m.shipped_rows_by_class) == (m.shipped_rows if jname != "flat dense" else 0)
    if jname == "hierarchical":
        assert [list(m.shipped_rows_by_class) for m in job.metrics] == HIER_BY_CLASS
        assert job.exchange_backend.flat_ships == 0 and job.exchange_backend.two_hop_ships > 0
    assert [m.action for m in job.metrics] == ["repartition", "noop", "repartition"]


def test_w8_backends_agree_but_for_their_traffic():
    """The three jobs take the same actions into the same state with the
    same overflow; dense ships the same rows with or without a topology,
    hierarchical ships more, its inter-host rows above 0 and below
    dense's."""
    batches = list(drifting_zipf(3, 8192, **W8_STREAM))
    jobs = {name: _port_w8_job(name, "serial") for name in W8_JOBS}
    for job in jobs.values():
        job.run(batches)
    base = jobs["flat dense"]
    for name, job in jobs.items():
        for a, b in zip(job.metrics, base.metrics, strict=True):
            assert (a.action, a.overflow, a.imbalance, a.migration_rows) == (
                b.action, b.overflow, b.imbalance, b.migration_rows)
        assert torch.equal(job.state_keys, base.state_keys)
        assert torch.equal(job.state_vals, base.state_vals)
    for d, h, f in zip(jobs["dense"].metrics, jobs["hierarchical"].metrics, base.metrics):
        assert d.shipped_rows == f.shipped_rows < h.shipped_rows
        assert 0 < h.shipped_rows_by_class[2] < d.shipped_rows_by_class[2]


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_w8_hierarchical_loss_matches_reference(reference_w8, driver):
    """Lane 5 killed at tick 4: the job is evicted onto 7 lanes (two hosts
    of 4 and 3), where the hierarchical ship falls back to flat; no row is
    lost, and the metrics, the recovery and the snapshot equal the
    reference's."""
    _, ref = reference_w8
    cfg, plan, topo = W8_LOSS
    batches = list(drifting_zipf(8, 8192, **W8_STREAM))
    job = StreamingJob(device="cpu", num_workers=8, num_partitions=8, state_capacity=4096,
                       dr=DRConfig(**cfg, **DRIVERS[driver]), topology=ExchangeTopology(*topo),
                       exchange_backend=FaultyBackend("hierarchical", FaultPlan.from_dict(plan)))
    ships = []
    recover = job._recover_from_loss

    def counting(loss):
        inner = job.exchange_backend.inner
        ships.append((inner.two_hop_ships, inner.flat_ships))
        return recover(loss)

    job._recover_from_loss = counting
    _feed(job, driver, batches)
    name = f"loss/{driver}"
    assert [_fields(m) for m in job.metrics] == _ref_metrics(ref, name)
    extra = json.loads(str(ref[f"{name}/extra"]))
    assert [[r.lane, r.kind, r.replayed, r.workers] for r in job.recoveries] == extra["recoveries"]
    assert job._lane_ids == extra["lane_ids"] == [0, 1, 2, 3, 4, 6, 7]
    _assert_same_snapshot(_ref_snapshot(ref, name), job.snapshot())
    # before the loss every ship took two hops; after it (a new transport
    # since the restore) every ship is flat
    assert ships[0][0] > 0 and ships[0][1] == 0
    after = job.exchange_backend.inner
    assert after.two_hop_ships == 0 and after.flat_ships > 0
    assert job._shuffle_spec.topology == ExchangeTopology(7, 4)
    # zero rows lost: the live rows sum to the records fed
    keys, vals = job.state_keys.numpy(), job.state_vals.numpy()
    live = keys != 2**31 - 1
    assert float(vals[live].sum()) == sum(len(b) for b in batches)
    assert all(m.overflow == 0 for m in job.metrics)
