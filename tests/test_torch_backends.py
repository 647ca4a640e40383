"""The ragged transport and the BackendPolicy in the port against the
reference, on the CPU.

* The exchange layer: bucketize is the same for every backend (the
  reference's, its ``lane_counts`` included); at W=4 the dense and ragged
  collectives give the reference's unpacked rows, overflow, per-lane
  overflow, ``shipped_rows``, ``lane_counts`` and ``recv_counts`` (the
  reference in a subprocess with four host devices, its ragged transport
  on the masked fallback, ``REPRO_DISABLE_NATIVE_RAGGED=1``: XLA:CPU has no
  ragged all-to-all); the count phase is priced in row bytes; start +
  finish equals the fused call; names resolve; the cost rules.
* The control plane: ``exchange_padding_fraction`` and ``hot_lane``, the
  ``BackendPolicy`` (patience, the no-exchange window, the dead zone, the
  cooldown, the wall-evidence guard), ``note_backend_switch`` across a
  snapshot, ``DRMaster.decide`` and the serving scheduler's parked policy,
  each against the reference's decisions.
* Whole jobs at W=1 (the reference in this process, on an ``Auto``-axis
  mesh): the auto switch end to end and through the depth-2 pipeline, and
  ragged-pinned jobs by the three drivers; trajectories (walls and
  ``overlap_fraction`` apart), snapshots and state equal bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.control.signals import Signals as JSignals
from repro.control.signals import Telemetry as JTelemetry
from repro.core.drm import DRConfig as JDRConfig
from repro.core.drm import DRMaster as JDRMaster
from repro.core.migration import exchange_lane_cost as j_lane_cost
from repro.core.migration import plan_migration as j_plan_migration
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.core.streaming import StreamingJob as JStreamingJob
from repro.exchange import ExchangeSpec as JSpec
from repro.exchange import ExchangeStats as JStats
from repro.exchange import Payload as JPayload
from repro.exchange import make_exchange as j_make_exchange
from repro.serve.scheduler import DRScheduler as JScheduler
from repro_torch.control import NoOp, Signals, SwitchBackend, Telemetry
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.migration import exchange_lane_cost, plan_migration
from repro_torch.core.partitioner import uniform_partitioner
from repro_torch.core.streaming import StreamingJob
from repro_torch.exchange import (
    DenseBackend,
    ExchangeSpec,
    ExchangeStats,
    HierarchicalBackend,
    LocalBackend,
    Payload,
    RaggedBackend,
    make_exchange,
    resolve_backend,
)
from repro_torch.kernels import ops
from repro_torch.serve.scheduler import DRScheduler

DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
REPO = Path(__file__).resolve().parents[1]
FLAT = np.array([1.0, 1.0, 1.0, 1.0])
# tests/test_control.py's auto-switch job: padded 4x, policies but the
# backend one kept quiet by the trigger
AUTO = dict(auto_backend=True, backend_patience=2, backend_cooldown=50, imbalance_trigger=1e9)
AUTO_JOB = dict(num_partitions=4, state_capacity=2048, capacity_factor=4.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _fields(m):
    d = dataclasses.asdict(m)
    d["shipped_rows_by_class"] = list(d["shipped_rows_by_class"])
    return {k: v for k, v in d.items() if k not in WALLS}


def _assert_same_metrics(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert _fields(a) == _fields(b), a


def _assert_same_snapshot(ref: dict, port: dict):
    assert sorted(ref) == sorted(port)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _random_input(rng, n, num_lanes, payload_dim=3):
    lane = rng.integers(0, num_lanes, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    vals = rng.normal(size=(n, payload_dim)).astype(np.float32)
    ints = rng.integers(0, 1000, n).astype(np.int32)
    return lane, valid, vals, ints


# ---------------------------------------------------------------------------
# bucketize: transport-independent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,num_lanes,capacity,seed", [
    (1, 1, 1, 0), (64, 4, 4, 1), (300, 16, 8, 2), (512, 7, 32, 3), (33, 3, 1, 4)])
@pytest.mark.parametrize("counts", [False, True])
def test_bucketize_bit_identical_across_backends(n, num_lanes, capacity, seed, counts):
    """Dense, ragged and local bucketize alike and as the reference does:
    buffers, overflow, per-lane overflow and the clipped ``lane_counts`` the
    ragged count phase reads (from the dispatch counts handed in, or those
    bucketize derives)."""
    from repro.kernels import ref as jref

    lane, valid, vals, ints = _random_input(np.random.default_rng(seed), n, num_lanes)
    jslot = jcounts = slot = cnt = None
    if counts:
        jslot, jcounts = jref.dispatch_count_ref(jnp.asarray(lane), jnp.asarray(valid),
                                                 num_parts=num_lanes)
        slot, cnt = _t(np.asarray(jslot))[None], _t(np.asarray(jcounts))[None]
    want = j_make_exchange(JSpec(num_lanes=num_lanes, capacity=capacity)).bucketize(
        jnp.asarray(lane), jnp.asarray(valid),
        [JPayload(jnp.asarray(vals), 0), JPayload(jnp.asarray(ints), -1)],
        slot=jslot, counts=jcounts)
    spec = ExchangeSpec(num_lanes=num_lanes, capacity=capacity)
    for be in ("dense", "ragged", "local"):
        got = make_exchange(spec, be).bucketize(
            _t(lane)[None], _t(valid)[None], [Payload(_t(vals)[None], 0),
                                              Payload(_t(ints)[None], -1)],
            slot=slot, counts=cnt)
        np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
        for g, w in zip(got.payloads, want.payloads):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w), err_msg=be)
        assert int(got.send.overflow[0]) == int(want.send.overflow)
        np.testing.assert_array_equal(got.send.lane_overflow[0].numpy(),
                                      np.asarray(want.send.lane_overflow))
        np.testing.assert_array_equal(got.lane_counts[0].numpy(),
                                      np.asarray(want.lane_counts))


def test_fused_route_hands_the_count_phase_its_counts():
    """The route kernel's bucketize (``route_bucketize``) stamps the clipped
    dispatch counts, as the reference's fused route does."""
    from repro_torch.exchange import route_bucketize

    part = uniform_partitioner(8, 4096, 0)
    keys = torch.as_tensor(np.random.default_rng(0).integers(0, 900, (4, 500)), dtype=torch.int32)
    valid = torch.ones_like(keys, dtype=torch.bool)
    ex = make_exchange(ExchangeSpec(num_lanes=4, capacity=100, axis="data"), "ragged")
    _, res = route_bucketize(ex, part.tables("cpu"), keys, valid,
                             torch.ones((4, 500, 1)), num_hosts=4096, seed=0)
    counts = ops.route_slots(keys, valid, part.tables("cpu"), num_hosts=4096,
                             num_lanes=4)[2]
    assert torch.equal(res.lane_counts, counts.clamp(max=100))
    assert int(res.send.overflow.sum()) == int((counts - 100).clamp(min=0).sum()) > 0


# ---------------------------------------------------------------------------
# the collective at W=4: dense and ragged against the reference
# ---------------------------------------------------------------------------

W4_EXCHANGE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.exchange import ExchangeSpec, Payload, make_exchange
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    cases = json.loads(sys.argv[2])
    inputs = np.load(sys.argv[3])
    out = {}
    for name, (backend, cap, split) in cases.items():
        ex = make_exchange(ExchangeSpec(num_lanes=4, capacity=cap, axis="data"), backend)

        def body(lane, valid, vals, ints):
            payloads = [Payload(vals, -1.0), Payload(ints, 7)]
            if split:
                pend = ex.start(lane, valid, payloads)
                res = ex.finish(pend)
            else:
                res = ex(lane, valid, payloads)
            va, (v, i) = res.unpack()
            none = jnp.full(4, -9, jnp.int32)
            lc = none if res.lane_counts is None else res.lane_counts
            rc = none if res.recv_counts is None else res.recv_counts
            return (va[None], v[None], i[None], res.shipped_rows[None],
                    res.send.overflow[None], res.send.lane_overflow[None], lc[None], rc[None])

        mapped = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 4,
                                   out_specs=(P("data"),) * 8, check_vma=False))
        got = mapped(*(jnp.asarray(inputs[f"{name}/{k}"])
                       for k in ("lane", "valid", "vals", "ints")))
        for k, v in zip(("valid", "vals", "ints", "shipped", "overflow", "lane_overflow",
                         "lane_counts", "recv_counts"), got):
            out[f"{name}/{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")

# name -> (backend, capacity, split phase) over W=4 workers of 192 records:
# uniform lanes (full at capacity 32) and every record on lane 0 (overflowing)
W4_CASES = {f"{be}/{skew}/{'split' if split else 'fused'}/{cap}": (be, cap, split)
            for be in ("dense", "ragged") for skew in ("uniform", "hot")
            for split in (False, True) for cap in (32, 96)}


def _w4_inputs():
    rng = np.random.default_rng(21)
    arrays = {}
    for name in W4_CASES:
        skew = name.split("/")[1]
        n = 4 * 192
        lane = (np.zeros(n, np.int32) if skew == "hot"
                else rng.integers(0, 4, n).astype(np.int32))
        arrays[f"{name}/lane"] = lane
        arrays[f"{name}/valid"] = rng.random(n) < 0.85
        arrays[f"{name}/vals"] = rng.normal(size=(n, 3)).astype(np.float32)
        arrays[f"{name}/ints"] = rng.integers(0, 1000, n).astype(np.int32)
    return arrays


@pytest.fixture(scope="module")
def exchange_w4(tmp_path_factory):
    d = tmp_path_factory.mktemp("backends_w4")
    arrays = _w4_inputs()
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", W4_EXCHANGE, str(d / "out.npz"), json.dumps(W4_CASES),
         str(d / "in.npz")], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return arrays, np.load(d / "out.npz")


def _port_w4(arrays, name, backend=None):
    be, cap, split = W4_CASES[name]
    ex = make_exchange(ExchangeSpec(num_lanes=4, capacity=cap, axis="data"), backend or be)
    lane, valid, vals, ints = (_t(arrays[f"{name}/{k}"]) for k in
                               ("lane", "valid", "vals", "ints"))
    args = (lane.view(4, -1), valid.view(4, -1),
            [Payload(vals.view(4, -1, 3), -1.0), Payload(ints.view(4, -1), 7)])
    return ex.finish(ex.start(*args)) if split else ex(*args)


@pytest.mark.parametrize("name", sorted(W4_CASES))
def test_w4_collective_matches_reference(exchange_w4, name):
    """Unpacked rows, overflow, per-lane overflow, shipped rows and both
    count vectors equal the reference's, per worker; ragged rows equal the
    dense rows (a hot lane overflows at capacity 32)."""
    arrays, ref = exchange_w4
    res = _port_w4(arrays, name)
    va, (v, i) = res.unpack()
    np.testing.assert_array_equal(va.numpy(), ref[f"{name}/valid"])
    np.testing.assert_array_equal(v.numpy(), ref[f"{name}/vals"])
    np.testing.assert_array_equal(i.numpy(), ref[f"{name}/ints"])
    np.testing.assert_array_equal(res.shipped_rows.numpy(), ref[f"{name}/shipped"])
    np.testing.assert_array_equal(res.send.overflow.numpy(), ref[f"{name}/overflow"])
    np.testing.assert_array_equal(res.send.lane_overflow.numpy(), ref[f"{name}/lane_overflow"])
    backend = W4_CASES[name][0]
    if backend == "ragged":
        np.testing.assert_array_equal(res.lane_counts.numpy(), ref[f"{name}/lane_counts"])
        np.testing.assert_array_equal(res.recv_counts.numpy(), ref[f"{name}/recv_counts"])
        dense = _port_w4(arrays, name, backend="dense")
        dva, dflat = dense.unpack()
        assert torch.equal(va, dva) and all(torch.equal(a, b) for a, b in zip((v, i), dflat))
        assert torch.equal(res.send.overflow, dense.send.overflow)
        # the rows sent plus the count phase: 16 bytes of counts, 16-byte rows
        assert torch.equal(res.shipped_rows, res.lane_counts.sum(dim=1) + 1)
    if "/hot/" in name:
        assert int(res.send.overflow.sum()) > 0


def test_ragged_count_phase_priced_in_row_bytes():
    """The count phase is 4 bytes a lane: a wide payload pays a fraction of
    a row for it, a narrow payload up to one row a lane."""
    rng = np.random.default_rng(5)
    w, n, cap = 8, 128, 32
    lane = _t(rng.integers(0, w, (w, n)).astype(np.int32))
    valid = torch.ones((w, n), dtype=torch.bool)
    ex = make_exchange(ExchangeSpec(num_lanes=w, capacity=cap, axis="data"), "ragged")

    def shipped(payload):
        res = ex(lane, valid, [Payload(payload, 0)])
        return res.shipped_rows - res.lane_counts.sum(dim=1)

    narrow = shipped(torch.zeros((w, n), dtype=torch.int32))        # 4 B a row
    wide = shipped(torch.zeros((w, n, 16), dtype=torch.float32))    # 64 B a row
    assert (narrow == w).all() and (wide == int(np.ceil(4 * w / 64))).all()
    # a state migration's (keys, vals[D]) rows: 4 + 4 D bytes
    mig = shipped(torch.zeros((w, n, 3), dtype=torch.float32))
    assert (mig == int(np.ceil(4 * w / 12))).all()


def test_ragged_without_dispatch_counts_counts_the_valid_cells():
    """A bucketize without counts leaves ``lane_counts`` unset; the count
    phase then counts the occupied cells, as the reference's does."""
    rng = np.random.default_rng(9)
    lane = _t(rng.integers(0, 4, (4, 50)).astype(np.int32))
    valid = _t(rng.random((4, 50)) < 0.7)
    ex = make_exchange(ExchangeSpec(num_lanes=4, capacity=8, axis="data"), "ragged")
    buffers = ex.bucketize(lane, valid, [Payload(torch.ones((4, 50)), 0.0)])
    started = ex.start_from(buffers).buffers
    assert torch.equal(started.lane_counts, buffers.valid.sum(dim=2, dtype=torch.int32))
    assert torch.equal(started.recv_counts, started.lane_counts.T)


def test_resolve_backend_names():
    assert isinstance(resolve_backend(None, ExchangeSpec(2, 4)), LocalBackend)
    assert isinstance(resolve_backend(None, ExchangeSpec(2, 4, axis="data")), DenseBackend)
    assert isinstance(resolve_backend(None), DenseBackend)
    assert isinstance(resolve_backend("ragged"), RaggedBackend)
    assert resolve_backend("ragged").name == "ragged"
    be = RaggedBackend()
    assert resolve_backend(be) is be
    with pytest.raises(ValueError):
        resolve_backend("nccl")
    assert isinstance(resolve_backend("hierarchical"), HierarchicalBackend)
    assert resolve_backend("hierarchical").name == "hierarchical"
    with pytest.raises(ValueError, match="dense or ragged"):
        LocalBackend().a2a_start(ExchangeSpec(2, 4, axis="data"), None)


@pytest.mark.parametrize("seed", range(5))
def test_cost_rules_ordering(seed):
    from repro.exchange import DenseBackend as JDense
    from repro.exchange import RaggedBackend as JRagged

    rng = np.random.default_rng(seed)
    transfer = rng.random((6, 6)) * rng.integers(1, 100)
    np.fill_diagonal(transfer, 0.0)
    dense, ragged = DenseBackend().cost(None, transfer), RaggedBackend().cost(None, transfer)
    assert 0.0 <= ragged <= dense and LocalBackend().cost(None, transfer) == 0.0
    assert (dense, ragged) == (JDense().cost(None, transfer), JRagged().cost(None, transfer))
    assert RaggedBackend().cost(None, np.zeros((0, 0))) == 0.0


def test_exchange_lane_cost_backend_rules():
    """The policy-facing helper: default == the dense rule, ragged cheaper
    on a skewed plan, local free; the reference's values."""
    from repro.exchange import RaggedBackend as JRagged

    live = np.arange(512, dtype=np.int64)
    plan = plan_migration(uniform_partitioner(4, seed=0), uniform_partitioner(4, seed=3), live)
    jplan = j_plan_migration(j_uniform(4, seed=0), j_uniform(4, seed=3), live)
    base = exchange_lane_cost(plan, num_workers=2)
    dense = exchange_lane_cost(plan, num_workers=2, backend=DenseBackend())
    ragged = exchange_lane_cost(plan, num_workers=2, backend=RaggedBackend())
    assert base == dense > 0 and 0 < ragged < dense
    assert exchange_lane_cost(plan, num_workers=2, backend=LocalBackend()) == 0.0
    assert ragged == j_lane_cost(jplan, num_workers=2, backend=JRagged())


# ---------------------------------------------------------------------------
# signals and the BackendPolicy, against the reference's decisions
# ---------------------------------------------------------------------------


def _warm(cfg, n=4):
    """Both masters with the reference's skewed sketch (tests/test_control.py)."""
    out = []
    for master, part in ((DRMaster, uniform_partitioner), (JDRMaster, j_uniform)):
        drm = master(part(n, heavy_capacity=128), cfg[master is JDRMaster])
        keys = np.arange(8, dtype=np.int64)
        counts = np.array([400.0, 100, 50, 25, 12, 6, 3, 1])
        drm.observe(keys[None], counts[None], total_records=2.0 * float(counts.sum()))
        out.append(drm)
    return out


def _configs(**kw):
    return DRConfig(**kw), JDRConfig(**kw)


def _exchange_signals(fraction, padded=1000, **kw):
    args = dict(loads=FLAT, exchange_padded_rows=padded,
                exchange_occupied_rows=int(fraction * padded), exchange_rows=padded, **kw)
    return Signals(**args), JSignals(**args)


def _decision_rows(log):
    return [(d.tick, d.kind, d.taken, d.reason, d.imbalance, sorted(d.detail.items()))
            for d in log.records]


def _same_masters(port, ref):
    assert (port.exchange_backend.name, port.backend_streak, port.last_backend_switch,
            port.batches_seen) == (ref.exchange_backend.name, ref.backend_streak,
                                   ref.last_backend_switch, ref.batches_seen)
    assert _decision_rows(port.decisions) == _decision_rows(ref.decisions)
    assert ([h for h in port.history if "backend" in h]
            == [h for h in ref.history if "backend" in h])


def test_repartition_cost_uses_host_backend():
    """Ragged prices a migration below dense, so a gain that cannot pay for
    the dense pad pays for the ragged rows: the transport changes the
    decision, in both packages alike."""
    loads = np.array([500.0, 30, 30, 37])
    from repro.exchange import DenseBackend as JDense
    from repro.exchange import RaggedBackend as JRagged

    def decide(backend, weight):
        port, ref = _warm(_configs(imbalance_trigger=1.05, migration_cost_weight=weight))
        port.exchange_backend = resolve_backend(backend)
        ref.exchange_backend = {"dense": JDense, "ragged": JRagged}[backend]()
        a = port.evaluate(Signals(loads=loads, num_workers=4))
        b = ref.evaluate(JSignals(loads=loads, num_workers=4))
        assert (a.kind, a.reason, getattr(a, "est_migration", None)) == (
            b.kind, b.reason, getattr(b, "est_migration", None))
        return a

    dense_free, ragged_free = decide("dense", 0.0), decide("ragged", 0.0)
    assert 0 < ragged_free.est_migration < dense_free.est_migration
    gain = dense_free.measured_imbalance - dense_free.planned_imbalance
    weight = gain / ((dense_free.est_migration + ragged_free.est_migration) / 2.0)
    assert isinstance(decide("dense", weight), NoOp)
    assert decide("ragged", weight).kind == "repartition"


def test_telemetry_padded_vs_shipped_and_hot_lane():
    sigs = []
    for tel, stats in ((Telemetry("stream"), ExchangeStats), (JTelemetry("stream"), JStats)):
        tel.record_exchange(stats(rows=100, wall_s=0.1, padded_rows=400,
                                  lane_overflow=np.array([0, 7, 0])))
        tel.record_exchange(stats(rows=50))
        tel.record_exchange(stats(rows=0, lane_overflow=np.array([0, 2, 1])))
        full, empty = tel.snapshot(loads=FLAT), tel.snapshot(loads=FLAT)
        sigs.append((full.exchange_rows, full.exchange_padded_rows,
                     full.exchange_padding_fraction, full.lane_overflow.tolist(),
                     full.hot_lane, empty.hot_lane, empty.exchange_padding_fraction))
    assert sigs[0] == sigs[1]
    assert sigs[0][2] == pytest.approx(150 / 450) and sigs[0][4] == 1 and sigs[0][5] == -1


def test_telemetry_explicit_zero_occupancy_is_a_measurement():
    out = []
    for tel, stats in ((Telemetry("stream"), ExchangeStats), (JTelemetry("stream"), JStats)):
        tel.record_exchange(stats(rows=100, padded_rows=100, occupied_rows=0))
        first = tel.snapshot(loads=FLAT).exchange_padding_fraction
        tel.record_exchange(stats(rows=50, padded_rows=100))
        second = tel.snapshot(loads=FLAT)
        out.append((first, second.exchange_occupied_rows, second.exchange_padding_fraction))
    assert out[0] == out[1] == (0.0, 50, 0.5)


def test_backend_wall_ewma_accumulates_across_windows():
    out = []
    for tel, stats in ((Telemetry("test"), ExchangeStats), (JTelemetry("test"), JStats)):
        tel.record_exchange(stats(rows=10, wall_s=0.4, backend="dense"))
        tel.snapshot(loads=np.ones(2))
        tel.record_exchange(stats(rows=10, wall_s=0.2, backend="dense"))
        tel.record_exchange(stats(rows=10, wall_s=0.1, backend="ragged"))
        out.append(tel.snapshot(loads=np.ones(2)).backend_wall_ewma)
    assert out[0] == out[1]
    assert out[0]["dense"] == pytest.approx(0.7 * 0.4 + 0.3 * 0.2)


def test_backend_policy_flips_dense_to_ragged_with_patience():
    """The decline, the switch, the streak kept through a window with no
    exchange and reset in the dead zone: the reference's actions, streaks,
    decision logs and history."""
    port, ref = _warm(_configs(auto_backend=True, backend_patience=2, imbalance_trigger=1e9))
    for frac in (0.2, 0.2):
        a, b = port.evaluate(_exchange_signals(frac)[0]), ref.evaluate(_exchange_signals(frac)[1])
        assert (a.kind, a.reason) == (b.kind, b.reason)
    assert isinstance(a, SwitchBackend) and a.backend == "ragged"
    assert a.padding_fraction == pytest.approx(0.2) == b.padding_fraction
    assert port.exchange_backend.name == "ragged"
    _same_masters(port, ref)
    assert port.history[-1] == ref.history[-1]
    assert port.history[-1]["backend"] == ("dense", "ragged")
    port, ref = _warm(_configs(auto_backend=True, backend_patience=2, imbalance_trigger=1e9))
    for sig in (_exchange_signals(0.2), (Signals(loads=FLAT), JSignals(loads=FLAT)),
                _exchange_signals(0.7)):
        a, b = port.evaluate(sig[0]), ref.evaluate(sig[1])
        assert (a.kind, a.reason) == (b.kind, b.reason)
        assert port.backend_streak == ref.backend_streak
    assert port.backend_streak == 0
    _same_masters(port, ref)


@pytest.mark.parametrize("cooldown", [0, 100])
def test_backend_switch_oscillation_guard(cooldown):
    """An occupancy straddling both thresholds ping-pongs without the
    cooldown and switches once within it, as in the reference."""
    port, ref = _warm(_configs(auto_backend=True, backend_patience=1,
                               backend_cooldown=cooldown, imbalance_trigger=1e9))
    switches = []
    for t in range(12):
        p, j = _exchange_signals(0.2 if t % 2 == 0 else 1.0)
        a, b = port.evaluate(p), ref.evaluate(j)
        assert (a.kind, a.reason) == (b.kind, b.reason)
        if isinstance(a, SwitchBackend):
            switches.append(a.backend)
    _same_masters(port, ref)
    assert switches == (["ragged"] if cooldown else ["ragged", "dense"] * 6)


def test_backend_wall_evidence_guard():
    """Once both transports have a wall EWMA, no switch onto one measured
    more than 1.5x slower; with no measurement of the target the guard is
    inert."""
    for ewma, kind in (({"dense": 0.01, "ragged": 0.02}, "noop"),
                       ({"dense": 0.01, "ragged": 0.012}, "switch_backend"),
                       ({"dense": 0.01}, "switch_backend")):
        port, ref = _warm(_configs(auto_backend=True, backend_patience=1,
                                   imbalance_trigger=1e9))
        p, j = _exchange_signals(0.1, backend_wall_ewma=ewma)
        a, b = port.evaluate(p), ref.evaluate(j)
        assert (a.kind, a.reason) == (b.kind, b.reason) and a.kind == kind
        _same_masters(port, ref)


def test_backend_switch_survives_snapshot_restore():
    """The switched transport and its cooldown stamp ride the snapshot, in
    both packages and across them; the restored master cannot reverse
    inside the cooldown."""
    cfgs = _configs(auto_backend=True, backend_patience=1, backend_cooldown=50,
                    imbalance_trigger=1e9)
    port, ref = _warm(cfgs)
    assert isinstance(port.evaluate(_exchange_signals(0.1)[0]), SwitchBackend)
    ref.evaluate(_exchange_signals(0.1)[1])
    for restored in (DRMaster.restore(port.snapshot(), cfgs[0]),
                     DRMaster.restore(ref.snapshot(), cfgs[0])):
        assert restored.exchange_backend.name == "ragged"
        assert restored.last_backend_switch == port.last_backend_switch
        b = restored.evaluate(_exchange_signals(1.0)[0])
        assert isinstance(b, NoOp)
        assert restored.decisions.records[-1].detail["backend_declined"] == "backend-cooldown"
    back = JDRMaster.restore(port.snapshot(), cfgs[1])
    assert back.exchange_backend.name == "ragged"


def test_drm_snapshot_restore_decide_roundtrip():
    """The deprecated ``decide``: the reference's decisions, through a
    snapshot, the safe-point spacing honoured by the restored master."""
    cfgs = _configs(imbalance_trigger=1.05, migration_cost_weight=0.0, min_batches_between=3)
    out = []
    for drm, cfg in ((DRMaster(uniform_partitioner(4, heavy_capacity=128), cfgs[0]), cfgs[0]),
                     (JDRMaster(j_uniform(4, heavy_capacity=128), cfgs[1]), cfgs[1])):
        keys = np.arange(8, dtype=np.int64)
        counts = np.array([400.0, 100, 50, 25, 12, 6, 3, 1])
        drm.observe(keys[None], counts[None], total_records=float(counts.sum()))
        loads = np.array([500.0, 30, 30, 37])
        d1 = drm.decide(loads)
        restored = type(drm).restore(drm.snapshot(), cfg)
        d_live, d_rest = drm.decide(loads), restored.decide(loads)
        out.append((d1.repartition, d1.reason, d1.planned_imbalance, d1.est_migration,
                    d_live.reason, d_rest.reason, d_rest.repartition,
                    restored.last_repartition, drm.partitioner.heavy_keys.tolist(),
                    drm.partitioner.heavy_parts.tolist()))
    assert out[0] == out[1]
    assert out[0][0] and out[0][5] == "safe-point-spacing"


def test_scheduler_backend_policy_parks_without_lane_telemetry():
    """The serving scheduler records no lane occupancy, so the enabled
    policy declines with the no-exchange-window reason: the reference's
    checkpoints and decisions."""
    cfg = dict(auto_backend=True, backend_patience=1, imbalance_trigger=1e9)
    port, ref = DRScheduler(4, dr=DRConfig(**cfg)), JScheduler(4, dr=JDRConfig(**cfg))
    rng = np.random.default_rng(3)
    for _ in range(3):
        window = rng.integers(0, 100, 50)
        for s in window:
            assert port.route(int(s), 8.0) == ref.route(int(s), 8.0)
        r = port.checkpoint(window)
        assert r == ref.checkpoint(window)
        assert r["backend"] == "dense" and not r["repartitioned"]
    assert all(d.detail.get("backend_declined") == "backend-no-exchange-window"
               for d in port.drm.decisions.records)
    assert _decision_rows(port.drm.decisions) == _decision_rows(ref.drm.decisions)


# ---------------------------------------------------------------------------
# whole jobs at W=1 against the reference
# ---------------------------------------------------------------------------


@pytest.fixture
def ragged_fallback(monkeypatch):
    """The reference's ragged transport on its masked dense fallback (XLA:CPU
    has no ragged all-to-all); read when its step is traced."""
    monkeypatch.setenv("REPRO_DISABLE_NATIVE_RAGGED", "1")


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _auto_batches(n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 500, 2048) for _ in range(n)]


def _feed(job, driver, batches):
    if driver == "depth 1":
        return [job.process_batch(b) for b in batches]
    return job.run(batches)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_streaming_auto_backend_switch_end_to_end(ragged_fallback, driver):
    """A padded dense job flips to ragged once, at a safe point: the
    reference's metrics, decision log and snapshot; no state moves (equal
    to a dense-pinned job's), ragged batches ship below their provision,
    and a restore resumes on the switched transport."""
    batches = _auto_batches()
    ref = JStreamingJob(mesh=_mesh(), dr=JDRConfig(**AUTO, **DRIVERS[driver]), **AUTO_JOB)
    _feed(ref, driver, batches)
    job = StreamingJob(device="cpu", dr=DRConfig(**AUTO, **DRIVERS[driver]), **AUTO_JOB)
    ms = _feed(job, driver, batches)
    _assert_same_metrics(ref.metrics, ms)
    _assert_same_snapshot(ref.snapshot(), job.snapshot())
    switches = [m for m in ms if m.action == "switch_backend"]
    assert len(switches) == 1 and job.exchange_backend.name == "ragged"
    assert job.drm.exchange_backend is job.exchange_backend
    sw = switches[0].batch
    assert not switches[0].repartitioned and not switches[0].resized
    assert all(m.backend == "dense" for m in ms[:sw + 1])
    assert all(m.backend == "ragged" and m.shipped_rows < m.padded_rows for m in ms[sw + 1:])
    pinned = StreamingJob(device="cpu", dr=DRConfig(imbalance_trigger=1e9), **AUTO_JOB)
    pinned.run(batches)
    assert torch.equal(job.state_keys, pinned.state_keys)
    assert torch.equal(job.state_vals, pinned.state_vals)
    fresh = StreamingJob(device="cpu", dr=DRConfig(**AUTO), **AUTO_JOB)
    assert fresh.exchange_backend.name == "dense"
    fresh.restore(job.snapshot())
    assert fresh.exchange_backend.name == "ragged"
    assert fresh.process_batch(batches[0]).backend == "ragged"


def test_depth2_through_backend_switch(ragged_fallback):
    """The switch drops the steps: the staged start (the old step's) is
    rejected, the batch re-routes on the new transport, later batches
    pipeline again; the serial trajectory and state."""
    batches = _auto_batches()
    serial = StreamingJob(device="cpu", dr=DRConfig(**AUTO, overlap_exchange=False), **AUTO_JOB)
    serial.run(batches)
    job = StreamingJob(device="cpu", dr=DRConfig(**AUTO, pipeline_depth=2), **AUTO_JOB)
    ms = job.run(batches)
    skip = {"state_rows", "overlapped", "pipelined"}
    assert ([{k: v for k, v in _fields(m).items() if k not in skip} for m in serial.metrics]
            == [{k: v for k, v in _fields(m).items() if k not in skip} for m in ms])
    sw = [m.batch for m in ms if m.action == "switch_backend"]
    assert len(sw) == 1
    assert not ms[sw[0] + 1].pipelined
    assert all(m.pipelined for m in ms[sw[0] + 2:])
    assert torch.equal(job.state_keys, serial.state_keys)
    assert torch.equal(job.state_vals, serial.state_vals)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_ragged_pinned_job_matches_reference(ragged_fallback, driver):
    """``exchange_backend="ragged"`` from the start, with repartitions (the
    migrations ride the ragged transport too): the reference's metrics and
    snapshot, and the dense job's state."""
    from repro_torch.data.generators import drifting_zipf

    batches = list(drifting_zipf(6, 4096, num_keys=2000, exponent=1.3, drift_every=2, seed=0))
    kw = dict(num_partitions=8, state_capacity=16_384)
    cfg = dict(imbalance_trigger=1.2, **DRIVERS[driver])
    ref = JStreamingJob(mesh=_mesh(), dr=JDRConfig(**cfg), exchange_backend="ragged", **kw)
    _feed(ref, driver, batches)
    job = StreamingJob(device="cpu", dr=DRConfig(**cfg), exchange_backend="ragged", **kw)
    ms = _feed(job, driver, batches)
    _assert_same_metrics(ref.metrics, ms)
    _assert_same_snapshot(ref.snapshot(), job.snapshot())
    assert any(m.repartitioned for m in ms)
    assert all(m.backend == "ragged" and m.shipped_rows < m.padded_rows for m in ms)
    dense = StreamingJob(device="cpu", dr=DRConfig(**cfg), **kw)
    _feed(dense, driver, batches)
    assert torch.equal(job.state_keys, dense.state_keys)
    assert torch.equal(job.state_vals, dense.state_vals)


@pytest.mark.parametrize("built_with", ["dense", "ragged"])
def test_restore_legacy_snapshot_without_backend_key(built_with):
    """A snapshot without ``drm_exchange_backend`` (older than the backends)
    leaves the job's own transport standing, and counts stay exact."""
    from repro_torch.data.generators import zipf_keys

    def mk():
        return StreamingJob(device="cpu", num_partitions=4, state_capacity=4096,
                            dr=DRConfig(imbalance_trigger=1e9), exchange_backend=built_with)

    batches = [zipf_keys(2048, num_keys=300, exponent=1.3, seed=s) for s in range(3)]
    job = mk()
    job.process_batch(batches[0])
    job.process_batch(batches[1])
    snap = {k: v for k, v in job.snapshot().items() if not k.startswith("drm_exchange_backend")}
    job2 = mk()
    job2.restore(snap)
    assert job2.exchange_backend.name == built_with
    assert job2.process_batch(batches[2]).backend == built_with
    keys = np.concatenate(batches)
    for key in np.unique(keys)[:5]:
        assert job2.state_count(int(key)) == float((keys == key).sum())
