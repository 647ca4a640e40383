"""Failure domains on the streaming DR loop of the port, against the
unpatched reference on an ``Auto``-axis mesh, on the CPU.

W=1 jobs by the serial, depth-1 and depth-2 drivers mirror
``tests/test_faults.py``: a never-firing plan, transient faults retried to
zero loss, transients past the budget, the latency report (with lane health
on), a kill without snapshots, kill recovery (restart in place) at several
ticks and intervals, a second kill during the replay, and seed determinism.
W=4 jobs run in one subprocess with four host devices: a kill evicted onto
three workers, Quarantine then Recover, an Evict from transients, and a
transient past the budget.  Every ``BatchMetrics`` field is compared except
the walls and ``overlap_fraction``; so are the recoveries (``wall_s``
apart), the snapshots (decision logs, health keys and state, dtypes
included), the lane ids and the seam's counters.  Also: the seam survives a
``SwitchBackend`` and an external restore, the auto-snapshot shares no
memory with the live state, and the no-DR and crash/restore sections of
``examples/streaming_wordcount.py``.  The drivers are held to each other
only for a never-firing plan: depth 2's lookahead starts take ticks.
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

from repro.core.drm import DRConfig as JDRConfig
from repro.core.streaming import StreamingJob as JStreamingJob
from repro.data.generators import drifting_zipf as j_drifting_zipf
from repro.exchange import FaultPlan as JFaultPlan
from repro.exchange import FaultyBackend as JFaultyBackend
from repro.exchange import WorkerLostError as JWorkerLostError
from repro_torch.core.drm import DRConfig
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import drifting_zipf
from repro_torch.exchange import FaultPlan, FaultyBackend, RaggedBackend, WorkerLostError

DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
REPO = Path(__file__).resolve().parents[1]
SENT = 2**31 - 1
QUIET = dict(imbalance_trigger=1e9)


class _CopyingJob(JStreamingJob):
    """The reference's job with its snapshots taken and restored as copies.
    Its DR master's snapshot holds the live sketch's count array, which the
    next batch decays in place, and its restore adopts the array it is
    given (ROADMAP.md, queue 3): a recovery would restore a sketch decayed
    after the snapshot.  The port copies on both sides;
    ``test_unrepaired_reference_recovery_restores_a_decayed_sketch`` pins
    the fault."""

    def snapshot(self):
        return _copied(super().snapshot())

    def restore(self, snap, **kw):
        super().restore(_copied(snap), **kw)


def _copied(snap):
    return {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in snap.items()}


def _batches(n=8, keys=50, rows=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, keys, rows).astype(np.int64) for _ in range(n)]


def _mesh(w=1):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:w]), ("data",))


def _fields(m):
    d = dataclasses.asdict(m) if dataclasses.is_dataclass(m) else dict(m)
    d["shipped_rows_by_class"] = list(d["shipped_rows_by_class"])
    return {k: v for k, v in d.items() if k not in WALLS}


def _recoveries(job):
    return [(r.lane, r.kind, r.replayed, r.workers) for r in job.recoveries]


def _seam(job):
    b = job.exchange_backend
    return (b.transients, b.retries, b.kills, b.injected_sleep_s)


def _assert_same_snapshot(ref: dict, port: dict):
    assert sorted(ref) == sorted(port)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_same_job(ref, port):
    assert [_fields(m) for m in ref.metrics] == [_fields(m) for m in port.metrics]
    assert _recoveries(ref) == _recoveries(port)
    assert ref._lane_ids == port._lane_ids
    if isinstance(port.exchange_backend, FaultyBackend):
        assert _seam(ref) == _seam(port)
    _assert_same_snapshot(ref.snapshot(), port.snapshot())


def _assert_exact_counts(job, batches):
    uniq, counts = np.unique(np.concatenate(batches), return_counts=True)
    keys = job.state_keys.reshape(-1).numpy()
    vals = job.state_vals.reshape(-1).numpy()
    live = keys != SENT
    order = np.argsort(keys[live])
    np.testing.assert_array_equal(keys[live][order], uniq)
    np.testing.assert_array_equal(vals[live][order], counts)


def _feed(job, driver, batches):
    if driver == "depth 1":
        for b in batches:
            job.process_batch(b)
    else:
        job.run(batches)
    return job


def _pair(driver, cfg, plan=None, job_kw=None, batches=None):
    """The reference's and the port's job over the same batches and plan
    (``plan=None``: no seam).  An exception is returned beside each job."""
    job_kw = job_kw or {}
    batches = _batches() if batches is None else batches
    out = []
    for make, conf, seam, fp in (
            (lambda **kw: _CopyingJob(mesh=_mesh(), **kw), JDRConfig, JFaultyBackend,
             JFaultPlan),
            (lambda **kw: StreamingJob(device="cpu", **kw), DRConfig, FaultyBackend,
             FaultPlan)):
        backend = None if plan is None else seam("dense", fp.from_dict(plan))
        job = make(dr=conf(**cfg, **DRIVERS[driver]), exchange_backend=backend, **job_kw)
        try:
            _feed(job, driver, batches)
            err = None
        except (JWorkerLostError, WorkerLostError) as e:
            err = (type(e).__name__, e.lane, e.tick, e.cause)
        out.append((job, err))
    return out


def _kill(tick, lane=0):
    return dict(faults=[dict(tick=tick, lane=lane, kind="kill")])


# ---------------------------------------------------------------------------
# W=1, by each driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_never_firing_plan_is_bit_identical(driver):
    """A seam that never fires leaves the trajectory, the repartitions'
    migrations included, equal to no seam at all — and to the reference."""
    cfg = dict(imbalance_trigger=1.1, migration_cost_weight=0.2)
    job_kw = dict(num_partitions=4)
    (ref, _), (port, err) = _pair(driver, cfg, dict(), job_kw)
    assert err is None
    bare = _feed(StreamingJob(device="cpu", dr=DRConfig(**cfg, **DRIVERS[driver]), **job_kw),
                 driver, _batches())
    _assert_same_job(ref, port)
    assert [_fields(m) for m in bare.metrics] == [_fields(m) for m in port.metrics]
    assert any(m.repartitioned for m in port.metrics)
    assert _seam(port) == (0, 0, 0, 0.0)
    _assert_exact_counts(port, _batches())


def test_never_firing_drivers_agree():
    """Only for a plan that never fires are the drivers held to each other."""
    runs = [_feed(StreamingJob(device="cpu", num_partitions=4,
                               dr=DRConfig(imbalance_trigger=1.1, **DRIVERS[d]),
                               exchange_backend=FaultyBackend("dense", FaultPlan())),
                  d, _batches()) for d in DRIVERS]
    skip = {"state_rows", "overlapped", "pipelined"}
    rows = [[{k: v for k, v in _fields(m).items() if k not in skip} for m in job.metrics]
            for job in runs]
    assert rows[0] == rows[1] == rows[2]
    for job in runs[1:]:
        assert torch.equal(job.state_keys, runs[0].state_keys)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_transient_faults_retry_to_zero_loss(driver):
    plan = dict(faults=[dict(tick=2, lane=0, kind="transient", failures=2),
                        dict(tick=5, lane=0, kind="transient", failures=1)], max_retries=3)
    (ref, _), (port, err) = _pair(driver, QUIET, plan)
    assert err is None
    _assert_same_job(ref, port)
    assert _seam(port)[:2] == (2, 3) and not port.recoveries
    _assert_exact_counts(port, _batches())


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_transient_past_budget_escalates_to_loss(driver):
    """``snapshot_interval=0``: the loss propagates, from the same tick."""
    plan = dict(faults=[dict(tick=2, lane=0, kind="transient", failures=5)], max_retries=2)
    (ref, ref_err), (port, port_err) = _pair(driver, QUIET, plan)
    assert port_err is not None and port_err == ref_err
    assert port_err[3] == "3 transient failures exceed retry budget 2"
    assert [_fields(m) for m in ref.metrics] == [_fields(m) for m in port.metrics]
    assert _seam(ref) == _seam(port)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_latency_report_reaches_lane_health(driver):
    """The straggle drains into telemetry each safe point; at W=1 the
    health policy can only decline (``health-single-worker``)."""
    plan = dict(faults=[dict(tick=1, lane=0, kind="latency", delay_s=0.002, span=3)])
    cfg = dict(QUIET, health_enabled=True, health_straggler_ms=1.0, health_patience=1)
    (ref, _), (port, err) = _pair(driver, cfg, plan, batches=_batches(6))
    assert err is None
    _assert_same_job(ref, port)
    assert port.exchange_backend.injected_sleep_s == pytest.approx(0.006)
    assert port.exchange_backend.drain_report() == {}
    declined = [d.detail.get("health_declined") for d in port.drm.decisions.records]
    assert "health-single-worker" in declined


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_kill_without_snapshots_propagates(driver):
    (ref, ref_err), (port, port_err) = _pair(driver, QUIET, _kill(3))
    assert port_err == ref_err == ("WorkerLostError", 0, 3, "killed")
    assert [_fields(m) for m in ref.metrics] == [_fields(m) for m in port.metrics]


@pytest.mark.parametrize("driver", list(DRIVERS))
@pytest.mark.parametrize("kill_tick,interval", [(4, 3), (2, 1), (6, 5)])
def test_kill_recovery_is_zero_loss(driver, kill_tick, interval):
    (ref, _), (port, err) = _pair(driver, dict(QUIET, snapshot_interval=interval),
                                  _kill(kill_tick))
    assert err is None
    _assert_same_job(ref, port)
    assert [r.kind for r in port.recoveries] == ["restart"]
    assert port.recoveries[0].wall_s > 0.0
    _assert_exact_counts(port, _batches())


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_unrepaired_reference_recovery_restores_a_decayed_sketch(driver):
    """A restart in place replays the very batches since the snapshot, so the
    recovered DR master's sketch must equal an uninterrupted run's.  The
    port's does; the unrepaired reference's does not (its auto-snapshot
    shares the sketch's count array, which the batches after it decayed in
    place), while its state is exact."""
    cfg = dict(QUIET, snapshot_interval=3, **DRIVERS[driver])
    plan = JFaultPlan.from_dict(_kill(5))  # two batches observed after the snapshot
    ref = _feed(JStreamingJob(mesh=_mesh(), dr=JDRConfig(**cfg),
                              exchange_backend=JFaultyBackend("dense", plan)),
                driver, _batches())
    port = _feed(StreamingJob(device="cpu", dr=DRConfig(**cfg),
                              exchange_backend=FaultyBackend("dense", FaultPlan.from_dict(
                                  _kill(5)))), driver, _batches())
    whole = _feed(StreamingJob(device="cpu", dr=DRConfig(**cfg)), driver, _batches())
    assert ref.recoveries and port.recoveries
    np.testing.assert_array_equal(port.drm.sketch._counts, whole.drm.sketch._counts)
    np.testing.assert_array_equal(port.drm.sketch._keys, whole.drm.sketch._keys)
    assert not np.array_equal(ref.drm.sketch._counts, whole.drm.sketch._counts)
    _assert_exact_counts(port, _batches())
    for k in range(50):
        assert ref.state_count(k) == port.state_count(k)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_double_kill_during_replay_is_zero_loss(driver):
    plan = dict(faults=[dict(tick=4, lane=0, kind="kill"), dict(tick=6, lane=0, kind="kill")])
    (ref, ref_err), (port, err) = _pair(driver, dict(QUIET, snapshot_interval=3), plan)
    assert err == ref_err
    _assert_same_job(ref, port)
    if driver == "depth 2":
        # the lookahead start of batch 4 takes tick 4 and the retried batch
        # 3's takes tick 6: no batch completes between the two losses, so
        # the budget of W + 1 = 2 runs out and the loss propagates
        assert err == ("WorkerLostError", 0, 6, "killed") and len(port.recoveries) == 1
    else:
        assert err is None and len(port.recoveries) == 2
        _assert_exact_counts(port, _batches())


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_seed_determinism(driver):
    """The same generated plan gives the same trajectory and recoveries run
    to run, and the reference's."""
    plan = FaultPlan.generate(21, num_lanes=1, ticks=10, latency_rate=0.3,
                              transient_rate=0.2, delay_s=0.001, kill_at=(6, 0)).to_dict()
    cfg = dict(QUIET, snapshot_interval=2)
    (ref, _), (port, err) = _pair(driver, cfg, plan)
    (_, _), (again, _) = _pair(driver, cfg, plan)
    assert err is None
    _assert_same_job(ref, port)
    assert [_fields(m) for m in again.metrics] == [_fields(m) for m in port.metrics]
    assert _recoveries(again) == _recoveries(port) and port.recoveries
    _assert_exact_counts(port, _batches())


# ---------------------------------------------------------------------------
# W=4, in a subprocess with four host devices
# ---------------------------------------------------------------------------

W4_JOB = dict(num_partitions=8, state_capacity=4096)
W4_STREAM = dict(num_keys=2000, exponent=1.3, drift_every=3, drift_fraction=0.3, seed=0)
W4_SCENARIOS = {
    # a kill on lane 2 at tick 3: evicted onto three workers
    "kill": (dict(QUIET, snapshot_interval=2), _kill(3, lane=2)),
    # a straggling lane 1: quarantined, then re-admitted
    "quarantine": (dict(QUIET, health_enabled=True, health_straggler_ms=5.0,
                        health_patience=2, health_recover_after=2, snapshot_interval=3),
                   dict(faults=[dict(tick=1, lane=1, kind="latency", delay_s=0.008,
                                     span=4)])),
    # single-failure transients on lane 3 at five ticks in a row: evicted
    "evict": (dict(QUIET, health_enabled=True, health_patience=2, snapshot_interval=3),
              dict(faults=[dict(tick=t, lane=3, kind="transient", failures=1)
                           for t in range(1, 6)])),
    # four failures against a budget of two: a loss, evicted by recovery
    "past budget": (dict(QUIET, snapshot_interval=2),
                    dict(faults=[dict(tick=2, lane=1, kind="transient", failures=4)],
                         max_retries=2)),
}

REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, numpy as np
    from repro.core.drm import DRConfig
    from repro.core.streaming import StreamingJob
    from repro.data.generators import drifting_zipf
    from repro.exchange import FaultPlan, FaultyBackend
    scenarios, drivers, job_kw, stream = json.loads(sys.argv[2])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    batches = list(drifting_zipf(10, 4096, **stream))
    copied = lambda snap: {k: v.copy() if isinstance(v, np.ndarray) else v
                           for k, v in snap.items()}
    class CopyingJob(StreamingJob):  # as _CopyingJob below
        def snapshot(self):
            return copied(super().snapshot())
        def restore(self, snap, **kw):
            super().restore(copied(snap), **kw)
    out = {}
    for sname, (cfg, plan) in scenarios.items():
        for dname, extra in drivers.items():
            job = CopyingJob(mesh=mesh, dr=DRConfig(**cfg, **extra), **job_kw,
                               exchange_backend=FaultyBackend("dense", FaultPlan.from_dict(plan)))
            if dname == "depth 1":
                for b in batches:
                    job.process_batch(b)
            else:
                job.run(batches)
            b = job.exchange_backend
            name = f"{sname}/{dname}"
            out[f"{name}/metrics"] = json.dumps([dataclasses.asdict(m) for m in job.metrics])
            out[f"{name}/extra"] = json.dumps(dict(
                recoveries=[(r.lane, r.kind, r.replayed, r.workers) for r in job.recoveries],
                lane_ids=job._lane_ids,
                seam=(b.transients, b.retries, b.kills, b.injected_sleep_s)))
            for k, v in job.snapshot().items():
                out[f"{name}/snap/{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("recovery_w4") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    args = json.dumps([W4_SCENARIOS, DRIVERS, W4_JOB, W4_STREAM])
    proc = subprocess.run([sys.executable, "-c", REFERENCE_W4, str(out), args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


W4_EXPECTED = {
    "kill": ["evict"],
    "quarantine": ["quarantine", "recover"],
    "evict": ["evict"],
    "past budget": ["evict"],
}


@pytest.mark.parametrize("driver", list(DRIVERS))
@pytest.mark.parametrize("scenario", list(W4_SCENARIOS))
def test_w4_failure_domains_match_reference(reference_w4, scenario, driver):
    cfg, plan = W4_SCENARIOS[scenario]
    batches = list(drifting_zipf(10, 4096, **W4_STREAM))
    port = StreamingJob(device="cpu", num_workers=4, dr=DRConfig(**cfg, **DRIVERS[driver]),
                        exchange_backend=FaultyBackend("dense", FaultPlan.from_dict(plan)),
                        **W4_JOB)
    _feed(port, driver, batches)
    name = f"{scenario}/{driver}"
    ref_metrics = json.loads(str(reference_w4[f"{name}/metrics"]))
    assert [_fields(m) for m in ref_metrics] == [_fields(m) for m in port.metrics]
    extra = json.loads(str(reference_w4[f"{name}/extra"]))
    assert [list(r) for r in _recoveries(port)] == extra["recoveries"]
    assert port._lane_ids == extra["lane_ids"]
    assert list(_seam(port)) == extra["seam"]
    prefix = f"{name}/snap/"
    snap = {k[len(prefix):]: reference_w4[k] for k in reference_w4.files
            if k.startswith(prefix)}
    _assert_same_snapshot(snap, port.snapshot())
    # what each scenario is for: the lane changes, and no row lost
    changes = [m.action for m in port.metrics if m.action != "noop"]
    changes += [r.kind for r in port.recoveries]
    assert changes == W4_EXPECTED[scenario]
    assert port.num_workers == (4 if scenario == "quarantine" else 3)
    _assert_exact_counts(port, batches)


# ---------------------------------------------------------------------------
# the seam across a backend switch and a restore; snapshot memory
# ---------------------------------------------------------------------------


@pytest.fixture
def ragged_fallback(monkeypatch):
    """The reference's ragged transport on its masked dense fallback (XLA:CPU
    has no ragged all-to-all)."""
    monkeypatch.setenv("REPRO_DISABLE_NATIVE_RAGGED", "1")


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_seam_survives_a_backend_switch(ragged_fallback, driver):
    """``auto_backend=True`` flips dense -> ragged: the wrapper stays armed
    around the new transport, and a kill after the switch is recovered."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 500, 2048) for _ in range(8)]
    cfg = dict(auto_backend=True, backend_patience=2, backend_cooldown=50,
               imbalance_trigger=1e9, snapshot_interval=2)
    job_kw = dict(num_partitions=4, state_capacity=2048, capacity_factor=4.0)
    (ref, _), (port, err) = _pair(driver, cfg, _kill(6), job_kw, batches)
    assert err is None
    _assert_same_job(ref, port)
    assert any(m.action == "switch_backend" for m in port.metrics)
    seam = port.exchange_backend
    assert isinstance(seam, FaultyBackend) and isinstance(seam.inner, RaggedBackend)
    assert port.drm.exchange_backend is seam and seam.kills == 1
    assert [r.kind for r in port.recoveries] == ["restart"]
    _assert_exact_counts(port, batches)


def test_seam_survives_an_external_restore(ragged_fallback):
    """An external restore keeps the seam armed (re-pointed at the
    snapshot's transport) and starts a new failure epoch: the auto-snapshot
    and the replay buffer go."""
    batches = _batches()
    cfg = dict(QUIET, snapshot_interval=3)
    first = StreamingJob(device="cpu", dr=DRConfig(**cfg), exchange_backend="ragged")
    first.run(batches[:4])
    out = []
    for make, conf, seam, fp in (
            (lambda **kw: _CopyingJob(mesh=_mesh(), **kw), JDRConfig, JFaultyBackend,
             JFaultPlan),
            (lambda **kw: StreamingJob(device="cpu", **kw), DRConfig, FaultyBackend,
             FaultPlan)):
        job = make(dr=conf(**cfg), exchange_backend=seam("dense", fp.from_dict(_kill(5))))
        job.run(batches[:2])
        assert job._auto_snap is not None
        job.restore(first.snapshot())
        assert job._auto_snap is None and job._replay == []
        assert isinstance(job.exchange_backend, seam)
        assert job.exchange_backend.name == "ragged"
        job.run(batches[4:])
        out.append(job)
    ref, port = out
    _assert_same_job(ref, port)
    assert [r.kind for r in port.recoveries] == ["restart"]


def test_auto_snapshot_shares_no_memory_with_the_live_state():
    """The snapshot taken after batch k is unchanged three batches later."""
    batches = _batches()
    job = StreamingJob(device="cpu", num_workers=2, num_partitions=4,
                       dr=DRConfig(**QUIET, snapshot_interval=4, overlap_exchange=False))
    job.run(batches[:4])  # the lazy first snapshot, then one after batch 3
    snap = job._auto_snap
    assert (snap["state_keys"] != SENT).any()
    kept = {k: np.array(v, copy=True) for k, v in snap.items()}
    job.run(batches[3:6])
    assert job._auto_snap is snap
    for k in kept:
        np.testing.assert_array_equal(np.asarray(snap[k]), kept[k], err_msg=k)
    assert not np.shares_memory(snap["state_keys"], job.state_keys.numpy())
    assert not np.shares_memory(snap["state_vals"], job.state_vals.numpy())


# ---------------------------------------------------------------------------
# examples/streaming_wordcount.py: the no-DR and crash/restore sections
# ---------------------------------------------------------------------------

WORDCOUNT_CFG = dict(imbalance_trigger=1.15, migration_cost_weight=0.2, ewma_alpha=0.6)


def test_wordcount_no_dr_and_crash_restore_sections_match_reference():
    """The example's first two sections, its config and batches: the no-DR
    job's imbalances, the DR job with a snapshot after batch 5, and the job
    restored from it after a crash, all equal to the reference's, with the
    example's exact count.  The reference keeps its snapshot as a copy
    (``_CopyingJob``): as the example runs it, the DR job decays the
    snapshot's sketch counts at batch 6, so the restored job plans from
    another sketch and one heavy key's partition differs."""
    batches = list(j_drifting_zipf(12, 16_384, num_keys=4_000, exponent=1.4,
                                   drift_every=4, drift_fraction=0.4, seed=3))
    for ours, theirs in zip(drifting_zipf(12, 16_384, num_keys=4_000, exponent=1.4,
                                          drift_every=4, drift_fraction=0.4, seed=3), batches):
        np.testing.assert_array_equal(ours, theirs)
    jobs = []
    for make, conf in ((lambda **kw: _CopyingJob(mesh=_mesh(), **kw), JDRConfig),
                       (lambda **kw: StreamingJob(device="cpu", **kw), DRConfig)):
        def job(dr_enabled, make=make, conf=conf):
            return make(num_partitions=8, state_capacity=32_768, dr_enabled=dr_enabled,
                        dr=conf(**WORDCOUNT_CFG))
        base = job(False)
        base.run(batches)
        dr = job(True)
        snap = None
        for i, b in enumerate(batches):
            dr.process_batch(b)
            if i == 5:
                snap = dr.snapshot()
        crashed = job(True)
        crashed.restore(snap)
        for b in batches[6:]:
            crashed.process_batch(b)
        jobs.append((base, dr, crashed, snap))
    for ref, port in zip(*jobs):
        if isinstance(ref, dict):
            _assert_same_snapshot(ref, port)
        else:
            _assert_same_job(ref, port)
    _, dr, crashed, _ = jobs[1]
    assert any(m.repartitioned for m in dr.metrics)
    all_keys = np.concatenate(batches)
    k = int(np.unique(all_keys)[7])
    assert crashed.state_count(k) == float((all_keys == k).sum())
    assert torch.equal(crashed.state_keys, dr.state_keys)
