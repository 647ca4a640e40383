"""The port's fault seam and lane health against the reference, on the CPU.

``FaultPlan`` (round trips, ``generate`` by seed, validation, plans
crossing the packages), ``FaultyBackend`` fed the same ``inject`` sequence
as the reference's (raises, sleeps, reports, counters, the ``note_*``
lifecycle and retry escalation), ``maybe_inject``, ``Telemetry.record_fault``,
``LaneHealth`` and the enabled ``HealthPolicy`` over scripted ``Signals``,
``DRMaster`` decision logs with health on, ``note_lost``, and snapshots with
the health keys crossing the packages both ways.  Integers, reasons and
snapshots must be equal exactly, dtypes included.
"""
import dataclasses

import numpy as np
import pytest

from repro.control import Signals as JSignals
from repro.control import Telemetry as JTelemetry
from repro.control.health import LaneHealth as JLaneHealth
from repro.core.drm import DRConfig as JDRConfig
from repro.core.drm import DRMaster as JDRMaster
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.exchange import FaultPlan as JFaultPlan
from repro.exchange import FaultyBackend as JFaultyBackend
from repro_torch.control import Signals, Telemetry
from repro_torch.control.health import LaneHealth
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.partitioner import uniform_partitioner
from repro_torch.exchange import (
    DenseBackend,
    FaultPlan,
    FaultyBackend,
    LaneFault,
    RaggedBackend,
    TransientExchangeError,
    WorkerLostError,
    maybe_inject,
)

KILL_PLAN = dict(faults=[dict(tick=3, lane=1, kind="latency", delay_s=0.001, span=2),
                         dict(tick=5, lane=0, kind="transient", failures=2),
                         dict(tick=9, lane=2, kind="kill")],
                 max_retries=4, backoff_s=0.0005, seed=7)


def _plans(d):
    return FaultPlan.from_dict(d), JFaultPlan.from_dict(d)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def test_fault_plan_round_trips_and_crosses_the_packages():
    port, ref = _plans(KILL_PLAN)
    assert FaultPlan.from_dict(port.to_dict()) == port
    assert port.to_dict() == ref.to_dict()
    # a plan written by either package drives the other
    assert JFaultPlan.from_dict(port.to_dict()) == ref
    assert FaultPlan.from_dict(ref.to_dict()) == port
    assert not port.never_fires and FaultPlan().never_fires == JFaultPlan().never_fires


@pytest.mark.parametrize("seed", [0, 11, 12, 21, 1234])
@pytest.mark.parametrize("kw", [
    dict(num_lanes=4, ticks=32, kill_at=(20, 3)),
    dict(num_lanes=8, ticks=16, latency_rate=0.2, transient_rate=0.3, delay_s=0.01,
         max_retries=3, backoff_s=0.002),
    dict(num_lanes=1, ticks=10, latency_rate=0.3, transient_rate=0.2, delay_s=0.001,
         kill_at=(6, 0)),
])
def test_fault_plan_generate_matches_reference(seed, kw):
    port, ref = FaultPlan.generate(seed, **kw), JFaultPlan.generate(seed, **kw)
    assert port.to_dict() == ref.to_dict()
    assert port == FaultPlan.generate(seed, **kw)


@pytest.mark.parametrize("make", [
    lambda m: m.LaneFault(0, 0, "meteor"),
    lambda m: m.LaneFault(-1, 0, "kill"),
    lambda m: m.LaneFault(0, -2, "kill"),
    lambda m: m.LaneFault(0, 0, "transient", failures=0),
    lambda m: m.LaneFault(0, 0, "latency", delay_s=-0.1),
    lambda m: m.LaneFault(0, 0, "latency", span=0),
    lambda m: m.FaultPlan(max_retries=-1),
    lambda m: m.FaultPlan(backoff_s=-1.0),
])
def test_fault_plan_validation_matches_reference(make):
    import repro.exchange.faults as jfaults
    import repro_torch.exchange.faults as tfaults

    with pytest.raises(ValueError) as ref:
        make(jfaults)
    with pytest.raises(ValueError) as port:
        make(tfaults)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the seam alone
# ---------------------------------------------------------------------------


def _drive_seam(backend, ops):
    """Apply ``ops`` to a seam; the events (raises, reports, counters)."""
    events = []
    for op, *args in ops:
        if op == "inject":
            try:
                backend.inject("shuffle")
                events.append(("ok",))
            except Exception as e:  # noqa: BLE001 - the class is compared
                events.append((type(e).__name__, e.lane, e.tick, getattr(e, "cause", None),
                               str(e)))
        elif op == "drain":
            events.append(("report", backend.drain_report()))
        else:
            getattr(backend, op)(*args)
        events.append((backend.transients, backend.retries, backend.kills,
                       round(backend.injected_sleep_s, 9)))
    return events


SEAM_CASES = {
    # standing death: a killed lane fails every later tick until evicted
    "kill, standing, evicted": (KILL_PLAN, [("inject",)] * 11 + [("note_evicted", 2)]
                                + [("inject",)] * 2 + [("drain",)]),
    # a restart clears the death but keeps the lane eligible for later faults
    "restart": (dict(faults=[dict(tick=1, lane=0, kind="kill"),
                             dict(tick=4, lane=0, kind="kill")]),
                [("inject",)] * 3 + [("note_restarted", 0)] + [("inject",)] * 3
                + [("drain",)]),
    # retries inside the budget, then one past it escalates to a loss
    "escalation": (dict(faults=[dict(tick=0, lane=1, kind="transient", failures=2),
                                dict(tick=2, lane=3, kind="transient", failures=3)],
                        max_retries=2, backoff_s=0.0002),
                   [("inject",), ("drain",), ("inject",), ("inject",), ("inject",),
                    ("drain",)]),
    # quarantine suspends a lane's faults, recover resumes them
    "quarantine": (dict(faults=[dict(tick=0, lane=1, kind="latency", delay_s=0.0005,
                                     span=6),
                                dict(tick=2, lane=1, kind="transient", failures=1),
                                dict(tick=4, lane=1, kind="transient", failures=1)]),
                   [("inject",), ("note_quarantined", 1), ("inject",), ("inject",),
                    ("drain",), ("note_recovered", 1), ("inject",), ("inject",),
                    ("drain",)]),
    "never fires": (dict(), [("inject",)] * 4 + [("drain",)]),
}


@pytest.mark.parametrize("case", list(SEAM_CASES))
def test_seam_matches_reference(case):
    plan, ops = SEAM_CASES[case]
    port = FaultyBackend("dense", FaultPlan.from_dict(plan))
    ref = JFaultyBackend("dense", JFaultPlan.from_dict(plan))
    assert _drive_seam(port, ops) == _drive_seam(ref, ops)


def test_seam_forwards_the_backend_and_the_plain_probe_is_a_no_op():
    seam = FaultyBackend("ragged")
    assert isinstance(seam.inner, RaggedBackend) and seam.name == "ragged"
    assert seam.cost(None, np.full((2, 2), 8.0)) == RaggedBackend().cost(None, np.full((2, 2), 8.0))
    seam.inner = DenseBackend()  # a switch re-points the wrapper
    assert seam.name == "dense"
    maybe_inject(DenseBackend())  # no hook: nothing happens
    with pytest.raises(WorkerLostError):
        maybe_inject(FaultyBackend("dense", FaultPlan(faults=(LaneFault(0, 0, "kill"),))))
    err = TransientExchangeError(1, 2, 0)
    assert (err.lane, err.tick, err.attempt) == (1, 2, 0)


# ---------------------------------------------------------------------------
# telemetry and lane health
# ---------------------------------------------------------------------------


def test_record_fault_matches_reference():
    port, ref = Telemetry("test"), JTelemetry("test")
    for tel in (port, ref):
        tel.record_fault(2, straggle_s=0.1, retries=1)
        tel.record_fault(0, straggle_s=0.05)
        tel.record_fault(2, retries=2)
        tel.record_fault(4, straggle_s=-1.0, retries=-3)  # clamped at zero
    sp, sr = port.snapshot(np.ones(3)), ref.snapshot(np.ones(3))
    for name in ("lane_straggle_s", "lane_retries"):
        a, b = getattr(sp, name), getattr(sr, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the next window starts clean in both
    assert port.snapshot(np.ones(3)).lane_straggle_s is None
    assert ref.snapshot(np.ones(3)).lane_straggle_s is None


def _signals(pkg, w, straggle=None, retries=None, loads=None):
    return pkg(loads=np.ones(w) if loads is None else loads, num_workers=w,
               at_safe_point=True,
               lane_straggle_s=None if straggle is None else np.asarray(straggle, np.float64),
               lane_retries=None if retries is None else np.asarray(retries, np.int64))


def test_lane_health_matches_reference():
    port, ref = LaneHealth(4, alpha=0.6), JLaneHealth(4, alpha=0.6)
    steps = [([0.0, 0.2, 0.0, 0.01], [0, 0, 1, 0]), (None, [0, 0, 1, 0]),
             ([0.05, 0.0], None), ([0.1] * 6, [1] * 6)]
    for lh, sig in ((port, Signals), (ref, JSignals)):
        for straggle, retries in steps:
            lh.observe(_signals(sig, 4, straggle, retries))
        lh.drop_lane(1)
        lh.observe(_signals(sig, 3, [0.3, 0.0, 0.0], [0, 2, 0]))
        lh.add_lane()
    a, b = port.snapshot(), ref.snapshot()
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = LaneHealth.restore(b, alpha=0.6)
    np.testing.assert_array_equal(back.wall_ewma, port.wall_ewma)
    assert JLaneHealth.restore(a).num_lanes == port.num_lanes == 4


def _health_cfg(**kw):
    kw = dict(health_enabled=True, health_straggler_ms=50.0, health_failure_threshold=3,
              health_patience=2, imbalance_trigger=1e9) | kw
    return kw


def _slow(lane, w=4, s=0.2):
    v = np.zeros(w)
    v[lane] = s
    return dict(straggle=v)


def _failing(lane, w=4, r=2):
    v = np.zeros(w, np.int64)
    v[lane] = r
    return dict(retries=v)


# (config, the workers and evidence of each safe point, the kinds expected)
HEALTH_SCRIPTS = {
    "quarantine after patience": (
        _health_cfg(), [(4, _slow(2))] * 2 + [(3, {})], ["noop", "quarantine", "noop"]),
    "evict on consecutive failures": (
        _health_cfg(), [(4, _failing(1))] * 4, ["noop", "noop", "noop", "evict"]),
    "failure streak resets": (
        _health_cfg(), [(4, _failing(1, r=1))] * 2 + [(4, {})] + [(4, _failing(1, r=1))] * 2,
        ["noop"] * 5),
    "recover after the timer": (
        _health_cfg(health_recover_after=2),
        [(4, _slow(0))] * 2 + [(3, {})] * 3, ["noop", "quarantine", "noop", "noop", "recover"]),
    "no recover without a timer": (
        _health_cfg(health_recover_after=0), [(4, _slow(0))] * 2 + [(3, {})] * 4,
        ["noop", "quarantine"] + ["noop"] * 4),
    "recover declined by its cost": (
        _health_cfg(health_recover_after=1, migration_cost_weight=50.0),
        [(4, _slow(3))] * 2 + [(3, {})] * 3, ["noop", "quarantine"] + ["noop"] * 3),
    "cooldown": (
        _health_cfg(health_cooldown=3),
        [(4, _slow(1))] * 2 + [(3, _slow(0, w=3))] * 4,
        ["noop", "quarantine", "noop", "noop", "noop", "quarantine"]),
    "single worker never folds": (
        _health_cfg(), [(1, dict(straggle=[0.5]))] * 4, ["noop"] * 4),
    "disabled": (
        dict(imbalance_trigger=1e9), [(4, _slow(2))] * 3, ["noop"] * 3),
    "straggler and failer": (
        _health_cfg(health_straggler_ms=20.0, health_failure_threshold=2, health_patience=1),
        [(4, dict(straggle=[0.0, 0.05, 0.0, 0.0], retries=[0, 0, 0, 1])),
         (3, dict(retries=[0, 0, 1])), (3, {})],
        ["quarantine", "evict", "noop"]),
}


def _run_script(pkg, cfg, steps):
    master_cls, config_cls, uniform, sig = pkg
    drm = master_cls(uniform(4, 64, 0), config_cls(**cfg))
    actions = [drm.evaluate(_signals(sig, w, **ev)) for w, ev in steps]
    return drm, actions


def _decision_rows(log):
    return [(d.tick, d.kind, d.taken, d.reason, d.imbalance, d.detail) for d in log.records]


def _assert_same_snapshot(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


PORT = (DRMaster, DRConfig, uniform_partitioner, Signals)
REF = (JDRMaster, JDRConfig, j_uniform, JSignals)


@pytest.mark.parametrize("name", list(HEALTH_SCRIPTS))
def test_health_decisions_match_reference(name):
    cfg, steps, kinds = HEALTH_SCRIPTS[name]
    port, pa = _run_script(PORT, cfg, steps)
    ref, ra = _run_script(REF, cfg, steps)
    assert [a.kind for a in pa] == [a.kind for a in ra] == kinds
    for a, b in zip(pa, ra):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert _decision_rows(port.decisions) == _decision_rows(ref.decisions)
    assert port.history == ref.history
    assert port.quarantined == ref.quarantined
    _assert_same_snapshot(port.snapshot(), ref.snapshot())


@pytest.mark.parametrize("name", ["recover after the timer", "cooldown", "no recover without a timer"])
def test_health_snapshots_cross_the_packages(name):
    """A master with the health keys restores in the other package and takes
    the same decisions from there on, in both directions."""
    cfg, steps, _ = HEALTH_SCRIPTS[name]
    half = len(steps) // 2
    port, _ = _run_script(PORT, cfg, steps[:half])
    ref, _ = _run_script(REF, cfg, steps[:half])
    assert any(k.startswith("health_") for k in port.snapshot())
    into_port = DRMaster.restore(ref.snapshot(), DRConfig(**cfg))
    into_ref = JDRMaster.restore(port.snapshot(), JDRConfig(**cfg))
    for drm, sig in ((into_port, Signals), (into_ref, JSignals), (port, Signals), (ref, JSignals)):
        for w, ev in steps[half:]:
            drm.evaluate(_signals(sig, w, **ev))
    _assert_same_snapshot(into_port.snapshot(), ref.snapshot())
    _assert_same_snapshot(into_ref.snapshot(), port.snapshot())


@pytest.mark.parametrize("lane", [0, 2])
def test_note_lost_matches_reference(lane):
    out = []
    for master_cls, config_cls, uniform, sig in (PORT, REF):
        drm = master_cls(uniform(4, 64, 0), config_cls(**_health_cfg()))
        drm.evaluate(_signals(sig, 4, **_slow(1)))
        drm.note_lost(lane, reason=f"worker lost on lane {lane} (tick 3: killed)")
        assert drm.lane_health is None
        drm.evaluate(_signals(sig, 3))
        out.append(drm)
    port, ref = out
    assert _decision_rows(port.decisions) == _decision_rows(ref.decisions)
    assert port.history == ref.history
    _assert_same_snapshot(port.snapshot(), ref.snapshot())


def test_legacy_snapshot_stays_byte_stable():
    """With health off (or never observed) no health key rides the snapshot."""
    for cfg in (dict(), _health_cfg()):
        drm = DRMaster(uniform_partitioner(4, 64, 0), DRConfig(**cfg))
        snap = drm.snapshot()
        assert not any(k.startswith(("health_", "quarantined_")) or k == "last_health_action"
                       for k in snap)
        back = DRMaster.restore(snap, DRConfig(**cfg))
        assert back.lane_health is None and back.quarantined == []
        _assert_same_snapshot(snap, JDRMaster(j_uniform(4, 64, 0), JDRConfig(**cfg)).snapshot())

