"""The overlapped streaming drivers (depth 1 and depth 2) of the port
against the reference's, and against the port's serial driver, on the CPU.

The reference runs unpatched on an ``Auto``-axis mesh
(``jax.sharding.Mesh(np.asarray(jax.devices()[:W]), ("data",))``); its W=4
runs go to a subprocess with four host devices.  Every ``BatchMetrics``
field must be equal except the host walls (``wall_time_s``,
``exchange_wall_s``) and ``overlap_fraction``, a ratio of walls; the final
``[W, S]`` state must be equal bit for bit.  Between the port's own
drivers ``state_rows`` differs too (overlapped: as of the last drain), as
in the reference.
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
from repro_torch import compat
from repro_torch.control import Telemetry
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.partitioner import uniform_partitioner
from repro_torch.core.shuffle import make_migrate_step, make_shuffle_step
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import drifting_zipf
from repro_torch.exchange import ExchangeSpec, ExchangeStats, Payload, make_exchange
from repro_torch.kernels.ref import route_bucketize_ref

CFG = dict(imbalance_trigger=1.1, migration_cost_weight=0.2)
JOB = dict(num_partitions=8, state_capacity=16_384)
STREAM = dict(num_keys=2000, exponent=1.3, drift_every=2, seed=0)
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
REPO = Path(__file__).resolve().parents[1]


def _batches(n=6, size=4096):
    return list(drifting_zipf(n, size, **STREAM))


def _port_job(depth=1, overlap=True, **kw):
    return StreamingJob(device="cpu", dr=DRConfig(pipeline_depth=depth, overlap_exchange=overlap,
                                                  **CFG), **JOB, **kw)


def _fields(m, skip):
    d = dataclasses.asdict(m) if dataclasses.is_dataclass(m) else dict(m)
    d["shipped_rows_by_class"] = list(d["shipped_rows_by_class"])
    return {k: v for k, v in d.items() if k not in skip}


def _assert_same(ref_metrics, port_metrics, skip=WALLS):
    assert len(ref_metrics) == len(port_metrics)
    for a, b in zip(ref_metrics, port_metrics):
        assert _fields(a, skip) == _fields(b, skip), a


def _assert_overlap_fraction(metrics):
    fractions = [m.overlap_fraction for m in metrics]
    assert all(0.0 <= f <= 1.0 for f in fractions), fractions
    # a drain (before each repartition) records ship and hidden walls, which
    # the next window reads
    drained = [i for i, m in enumerate(metrics) if m.repartitioned]
    assert any(fractions[i + 1] > 0 for i in drained if i + 1 < len(metrics)), fractions


def _port_state(job):
    return job.state_keys.numpy(), job.state_vals.numpy()


@pytest.mark.parametrize("depth", [1, 2])
def test_w1_overlapped_driver_matches_reference(depth):
    """One worker, the unpatched reference in this process: every field but
    the walls equal (``state_rows`` as of the last drain, ``overlapped``,
    ``pipelined``), and the final state bit-equal."""
    batches = _batches()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = JStreamingJob(mesh=mesh, dr=JDRConfig(pipeline_depth=depth, **CFG), **JOB)
    port = _port_job(depth)
    ref_metrics, port_metrics = ref.run(batches), port.run(batches)
    _assert_same(ref_metrics, port_metrics)
    assert all(m.overlapped for m in port_metrics)
    assert any(m.pipelined for m in port_metrics) == (depth == 2)
    assert sum(m.repartitioned for m in port_metrics) >= 2
    _assert_overlap_fraction(port_metrics)
    keys, vals = _port_state(port)
    np.testing.assert_array_equal(np.asarray(ref.state_keys), keys)
    np.testing.assert_array_equal(np.asarray(ref.state_vals), vals)


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, numpy as np
    from repro.core.drm import DRConfig
    from repro.core.streaming import StreamingJob
    from repro.data.generators import drifting_zipf
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    batches = list(drifting_zipf(8, 4096, num_keys=2000, exponent=1.3, drift_every=2,
                                 seed=0))
    out = {}
    for depth in (1, 2):
        job = StreamingJob(mesh=mesh, num_partitions=8, state_capacity=16_384,
                           dr=DRConfig(imbalance_trigger=1.1, migration_cost_weight=0.2,
                                       pipeline_depth=depth))
        metrics = [dataclasses.asdict(m) for m in job.run(batches)]
        out[f"keys{depth}"] = np.asarray(job.state_keys)
        out[f"vals{depth}"] = np.asarray(job.state_vals)
        out[f"metrics{depth}"] = json.dumps(metrics)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_w4") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", REFERENCE_W4, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


@pytest.mark.parametrize("depth", [1, 2])
def test_w4_overlapped_driver_matches_reference(reference_w4, depth):
    """Four workers over 8 batches, the reference on a 4-device ``Auto``
    mesh in a subprocess: equal trajectories (``state_rows`` included: the
    re-anchor's 725 against 1017 at batch 2 is gone) and state."""
    port = _port_job(depth, num_workers=4)
    port.run(_batches(8))
    ref_metrics = json.loads(str(reference_w4[f"metrics{depth}"]))
    _assert_same(ref_metrics, port.metrics)
    assert ref_metrics[2]["state_rows"] == port.metrics[2].state_rows
    assert any(m.relative_migration > 0 for m in port.metrics)
    _assert_overlap_fraction(port.metrics)
    keys, vals = _port_state(port)
    np.testing.assert_array_equal(reference_w4[f"keys{depth}"], keys)
    np.testing.assert_array_equal(reference_w4[f"vals{depth}"], vals)


@pytest.mark.parametrize("workers", [1, 3])
def test_serial_depth1_depth2_agree(workers):
    """The port's three drivers: equal trajectories and state; only the
    walls, ``state_rows`` and the driver's own flags differ."""
    batches = _batches(8)
    jobs = {name: _port_job(depth, overlap, num_workers=workers)
            for name, depth, overlap in (("serial", 1, False), ("d1", 1, True), ("d2", 2, True))}
    runs = {name: job.run(batches) for name, job in jobs.items()}
    skip = WALLS | {"state_rows", "overlapped", "pipelined"}
    _assert_same(runs["serial"], runs["d1"], skip)
    _assert_same(runs["serial"], runs["d2"], skip)
    _assert_same(runs["d1"], runs["d2"], WALLS | {"pipelined"})
    assert not any(m.overlapped for m in runs["serial"])
    assert all(m.overlapped for m in runs["d1"] + runs["d2"])
    assert not any(m.pipelined for m in runs["d1"]) and any(m.pipelined for m in runs["d2"])
    assert not runs["d2"][0].pipelined  # nothing is staged before the first batch
    for name in ("d1", "d2"):
        assert torch.equal(jobs[name].state_keys, jobs["serial"].state_keys)
        assert torch.equal(jobs[name].state_vals, jobs["serial"].state_vals)


def test_overlapped_state_rows_are_as_of_the_last_drain():
    """Overlapped ``state_rows`` lag the live count until a drain; the
    serial driver's do not."""
    batches = _batches(8)
    serial, overlapped = _port_job(overlap=False), _port_job()
    s, o = serial.run(batches), overlapped.run(batches)
    assert [m.state_rows for m in s] != [m.state_rows for m in o]
    for i, m in enumerate(o):
        if i and not o[i - 1].repartitioned and not m.repartitioned:
            assert m.state_rows == o[i - 1].state_rows


@pytest.mark.parametrize("depth", [1, 2])
def test_env_switch_forces_serial(monkeypatch, depth):
    monkeypatch.setenv("REPRO_DISABLE_OVERLAP", "1")
    job = _port_job(depth)
    ms = job.run(_batches(3))
    assert not any(m.overlapped or m.pipelined for m in ms)
    assert job._staged is None and job._inflight is None
    assert all(m.overlap_fraction == 0.0 for m in ms)


def test_mid_stream_snapshot_drains_the_inflight_merge():
    """A snapshot between batches captures the in-flight merge: restored into
    a fresh job, the state equals the serial run's."""
    batches = _batches(5)
    serial = _port_job(overlap=False)
    serial.run(batches)
    job = _port_job()
    job.run(batches)
    assert job._inflight is not None
    snap = job.snapshot()
    assert job._inflight is None
    fresh = _port_job()
    fresh.restore(snap)
    assert torch.equal(fresh.state_keys, serial.state_keys)
    assert torch.equal(fresh.state_vals, serial.state_vals)


def test_depth2_restore_discards_the_staged_start():
    """A restore swaps the partitioner from under the pipeline: the staged
    start goes, and the resumed run equals a serial job's."""
    batches = _batches(6)
    job = _port_job(2)
    job.run(batches[:3])
    snap = job.snapshot()
    job._next_batch = batches[4]
    job.process_batch(batches[3])  # stages batches[4]
    assert job._staged is not None
    job._next_batch = None
    job.restore(snap)
    assert job._staged is None and job._inflight is None
    resumed = job.run(batches[3:])
    ref = _port_job(overlap=False)
    ref.run(batches[:3])
    want = ref.run(batches[3:])
    # the restored job numbers its batches on from its own metrics
    _assert_same(want, resumed, WALLS | {"batch", "state_rows", "overlapped", "pipelined"})
    assert torch.equal(job.state_keys, ref.state_keys)
    assert torch.equal(job.state_vals, ref.state_vals)


def test_staged_start_is_rejected_for_another_batch():
    """A staged start routes only the very array it was staged for: a
    different batch (or caller-supplied values) is routed afresh."""
    batches = _batches(3)
    calm = dict(imbalance_trigger=1e9)  # no action discards the stage first
    job = StreamingJob(device="cpu", dr=DRConfig(pipeline_depth=2, **calm), **JOB)
    for other in (batches[1].copy(), batches[1]):
        job._next_batch = batches[1]
        job.process_batch(batches[0])
        assert job._staged is not None
        job._next_batch = None
        values = None if other is not batches[1] else np.ones((len(other), 1), np.float32)
        m = job.process_batch(other, values)
        assert not m.pipelined and job._staged is None
    ref = StreamingJob(device="cpu", dr=DRConfig(overlap_exchange=False, **calm), **JOB)
    ref.run([batches[0], batches[1]] * 2)
    assert torch.equal(job.state_keys, ref.state_keys)
    assert torch.equal(job.state_vals, ref.state_vals)


def _shuffle_args(part, batch):
    keys = torch.as_tensor(batch)[None]
    vals = torch.ones((1, len(batch), 2))
    return part.tables("cpu"), keys, vals, keys != 2**31 - 1


def test_two_starts_in_flight_share_the_buffer_pool():
    """The depth-2 queue shape at the step: two starts live before the first
    finish, then a third start claims the set the first finish recycled.
    Every finish returns the fused step's rows on fresh buffers."""
    part = uniform_partitioner(2)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 100, 64).astype(np.int32) for _ in range(3)]
    make = lambda: make_shuffle_step(num_workers=1, num_partitions=2, capacity=64,  # noqa: E731
                                     num_hosts=part.num_hosts)
    step = make()
    args = [_shuffle_args(part, b) for b in batches]
    p1, _ = step.start(*args[0])
    p2, _ = step.start(*args[1])
    got = [step.finish(p1)]
    p3, _ = step.start(*args[2])
    assert p3.buffers.valid is p1.buffers.valid  # the recycled set
    got += [step.finish(p2), step.finish(p3)]
    for (rk, rv, rva, rp), a in zip(got, args):
        want = make()(*a)
        for g, w in zip((rk, rv, rva, rp), (want.keys, want.values, want.valid, want.part)):
            assert torch.equal(g, w)


def test_migrate_start_finish_equals_the_fused_step():
    part = uniform_partitioner(6, seed=3)
    new = uniform_partitioner(6, seed=4)
    rng = np.random.default_rng(1)
    keys = torch.as_tensor(np.sort(rng.choice(5000, (3, 40), replace=False), axis=1),
                           dtype=torch.int32)
    keys[:, -5:] = 2**31 - 1
    vals = torch.as_tensor(rng.normal(size=(3, 40, 2)), dtype=torch.float32)
    step = make_migrate_step(num_workers=3, state_capacity=40, num_hosts=part.num_hosts,
                             lane_capacity=16)
    want = step(new.tables("cpu"), keys, vals)
    for _ in range(3):  # the second and third starts reuse drained sets
        pending, st = step.start(new.tables("cpu"), keys, vals)
        rk, rv, rva = step.finish(pending)
        got = (*st[:3], rk, rv, rva, *st[3:])
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _dirty(t):
    t.view(-1).view(torch.uint8).fill_(0x5A) if t.numel() else None
    return t


@pytest.mark.parametrize("cap", [3, 40])
def test_route_bucketize_ref_into_recycled_dirty_buffers(cap):
    """The plain ``route_bucketize`` with ``out=`` a set full of junk equals
    the fresh path (``cap=3`` drops rows, which must not land anywhere)."""
    part = uniform_partitioner(4, seed=1)
    t = part.tables("cpu")
    rng = np.random.default_rng(2)
    keys = torch.as_tensor(rng.integers(0, 300, (2, 50)), dtype=torch.int32)
    keys[0, :7] = 2**31 - 1
    valid = keys != 2**31 - 1
    vals = torch.as_tensor(rng.normal(size=(2, 50, 3)), dtype=torch.float32)
    kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=2, capacity=cap,
              key_fill=2**31 - 1)
    want = route_bucketize_ref(keys, valid, vals, t.heavy_keys, t.heavy_parts,
                               t.host_to_part, **kw)
    out = tuple(_dirty(torch.empty_like(b)) for b in want[3:])
    got = route_bucketize_ref(keys, valid, vals, t.heavy_keys, t.heavy_parts,
                              t.host_to_part, out=out, **kw)
    assert all(g is o for g, o in zip(got[3:], out))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (cap == 3) == bool((want[2] > cap).any())


@pytest.mark.parametrize("cap", [2, 30])
def test_exchange_bucketize_into_recycled_dirty_buffers(cap):
    """``Exchange.bucketize(buffers=)`` (the migrate path's scatter, no slot
    given, out-of-range lanes dropped) equals fresh buffers."""
    ex = make_exchange(ExchangeSpec(num_lanes=3, capacity=cap, axis="data"))
    rng = np.random.default_rng(3)
    lane = torch.as_tensor(rng.integers(-1, 4, (3, 30)), dtype=torch.int32)
    valid = torch.as_tensor(rng.random((3, 30)) < 0.8)
    payloads = [Payload(torch.as_tensor(rng.integers(0, 99, (3, 30)), dtype=torch.int32), -7),
                Payload(torch.as_tensor(rng.normal(size=(3, 30, 2)), dtype=torch.float32), 0)]
    want = ex.bucketize(lane, valid, payloads)
    bufs = (_dirty(torch.empty_like(want.valid)),
            tuple(_dirty(torch.empty_like(b)) for b in want.payloads))
    got = ex.bucketize(lane, valid, payloads, buffers=bufs)
    assert got.valid is bufs[0] and all(g is b for g, b in zip(got.payloads, bufs[1]))
    assert torch.equal(got.valid, want.valid)
    for g, w in zip(got.payloads, want.payloads):
        assert torch.equal(g, w)
    assert int(want.send.overflow.sum()) > 0
    pending = ex.start(lane, valid, payloads, buffers=bufs)
    fused = ex.all_to_all(want)
    moved = ex.finish(pending)
    assert torch.equal(moved.valid, fused.valid)
    assert torch.equal(pending.buffers.shipped_rows, fused.shipped_rows)


def test_overlap_fraction_signal():
    """hidden / (hidden + ship); 0.0 with nothing recorded and with only the
    fused wall recorded; degenerate walls clamp to zero and are counted."""
    t = Telemetry("test")
    assert t.snapshot(loads=np.ones(2)).overlap_fraction == 0.0
    t.record_exchange(ExchangeStats(rows=10, wall_s=0.5))
    assert t.snapshot(loads=np.ones(2)).overlap_fraction == 0.0
    t.record_exchange(ExchangeStats(rows=10, wall_s=0.2, count_wall_s=0.2))
    t.record_exchange(ExchangeStats(rows=0, ship_wall_s=0.1, hidden_wall_s=0.3))
    sig = t.snapshot(loads=np.ones(2))
    assert sig.exchange_count_wall_s == pytest.approx(0.2)
    assert sig.exchange_ship_wall_s == pytest.approx(0.1)
    assert sig.exchange_hidden_wall_s == pytest.approx(0.3)
    assert sig.overlap_fraction == pytest.approx(0.75)
    t.record_exchange(ExchangeStats(rows=0, ship_wall_s=float("nan"), hidden_wall_s=-1.0))
    sig = t.snapshot(loads=np.ones(2))
    assert sig.overlap_fraction == 0.0 and sig.degenerate_walls == 2
    assert t.degenerate_walls_total == 2


def test_pipeline_depth_2_is_accepted():
    DRMaster(uniform_partitioner(4), DRConfig(pipeline_depth=2))
    for bad in (0, 3):
        with pytest.raises(ValueError, match="pipeline_depth"):
            DRConfig(pipeline_depth=bad)


def test_host_sync_audit_counts_blocking_fetches_only_outside_safe_points():
    compat.reset_host_sync_count()
    assert compat.host_sync_count() == 0
    compat.host_wait(None)
    host, event = compat.copy_to_host((torch.ones(3),))
    assert event is None and host[0].device.type == "cpu"
    job = _port_job(2)
    job.run(_batches(4))
    assert compat.host_sync_count() == 0  # CPU tensors are never counted


def test_staged_upload_survives_its_source_being_overwritten():
    """The staged batch is copied before ``_stage_next`` returns: the caller
    may overwrite its array, and the staged route keeps the original keys."""
    batches = _batches(3)
    calm = dict(imbalance_trigger=1e9)
    job = StreamingJob(device="cpu", dr=DRConfig(pipeline_depth=2, **calm), **JOB)
    job.process_batch(batches[0])
    src = batches[1].copy()
    job._stage_next(src)
    src[:] = batches[2]
    assert job.process_batch(src).pipelined
    ref = StreamingJob(device="cpu", dr=DRConfig(overlap_exchange=False, **calm), **JOB)
    ref.run(batches[:2])
    assert torch.equal(job.state_keys, ref.state_keys)
    assert torch.equal(job.state_vals, ref.state_vals)
