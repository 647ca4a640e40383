"""Elastic resize in the port against the reference, on the CPU.

``resize_partitioner``, the ``ResizePolicy`` (streaks, floors, ceilings,
cooldown, the low-throughput shrink), ``decide_resize`` / ``note_resize``,
the elastic section of ``examples/streaming_wordcount.py`` by each of the
three drivers, an explicit ``resize`` that waits for the checkpoint tick, a
W=4 elastic job (grow, shrink, a requested resize and a second grow) by each
driver against the reference in a subprocess with four host devices, a
restore across worker counts in both directions, and ``DRScheduler``'s
replica scale-out and scale-in.  Trajectories (walls and
``overlap_fraction`` apart), snapshots and state must be equal bit for bit.
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

from repro.control.signals import Signals as JSignals
from repro.core.drm import DRConfig as JDRConfig
from repro.core.drm import DRMaster as JDRMaster
from repro.core.histogram import Histogram as JHistogram
from repro.core.partitioner import resize_partitioner as j_resize_partitioner
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.core.streaming import StreamingJob as JStreamingJob
from repro.data.generators import sawtooth_skew as j_sawtooth_skew
from repro.data.generators import zipf_keys as j_zipf_keys
from repro.serve.scheduler import DRScheduler as JScheduler
from repro_torch.control import Signals
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.histogram import Histogram
from repro_torch.core.partitioner import resize_partitioner, uniform_partitioner
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import sawtooth_skew, zipf_keys
from repro_torch.serve.scheduler import DRScheduler

DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
REPO = Path(__file__).resolve().parents[1]
SENT = 2**31 - 1

# examples/streaming_wordcount.py, its elastic section
EXAMPLE_CFG = dict(elastic=True, min_partitions=4, max_partitions=8, grow_trigger=1.6,
                   shrink_trigger=1.3, resize_patience=2, imbalance_trigger=1.2,
                   migration_cost_weight=0.1)
# a W=4 job over a small sawtooth: grow 8->16 at batch 1, shrink 16->8 at
# batch 4, the requested 8->12 at batch 6 and the policy's 12->16 at batch 8
W4_CFG = dict(elastic=True, min_partitions=8, max_partitions=16, grow_trigger=4.0,
              shrink_trigger=2.5, resize_patience=2, imbalance_trigger=1.2,
              migration_cost_weight=0.1)
W4_JOB = dict(num_partitions=8, state_capacity=16_384)
W4_STREAM = dict(num_keys=2000, exponent=1.8, period=3, seed=0)
W4_REQUEST = (5, 12)  # resize(12) after batch 5: applied at batch 6's safe point


def _fields(m):
    d = dataclasses.asdict(m) if dataclasses.is_dataclass(m) else dict(m)
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


def _assert_exact_counts(job, batches):
    """Every fed key's count, and one state row a key (the state must hold
    every key)."""
    uniq, counts = np.unique(np.concatenate(batches), return_counts=True)
    keys = job.state_keys.reshape(-1).numpy()
    vals = job.state_vals.reshape(-1).numpy()
    live = keys != SENT
    order = np.argsort(keys[live])
    np.testing.assert_array_equal(keys[live][order], uniq)
    np.testing.assert_array_equal(vals[live][order], counts)


def _mesh(w=1):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:w]), ("data",))


def _drive(job, batches, driver, requests=()):
    """Run ``batches``: depth 1 batch by batch, the others through ``run``;
    ``requests`` are ``(after batch, n)`` resize requests."""
    requests = dict(requests)
    if driver == "depth 1" or requests:
        for i, b in enumerate(batches):
            job.process_batch(b)
            if i in requests:
                job.resize(requests[i])
    else:
        job.run(batches)
    return job


def test_sawtooth_skew_matches_reference():
    for ours, theirs in zip(sawtooth_skew(7, 2000, num_keys=300, exponent=1.5, period=2, seed=4),
                            j_sawtooth_skew(7, 2000, num_keys=300, exponent=1.5, period=2, seed=4)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def _hist(pkg_hist, seed=0):
    keys = zipf_keys(20_000, num_keys=3000, exponent=1.4, seed=seed)
    u, c = np.unique(keys, return_counts=True)
    order = np.argsort(-c, kind="stable")[:24]
    f = c[order] / len(keys)
    return pkg_hist(u[order].astype(np.int64), f.astype(np.float64), float(1.0 - f.sum()))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 12, 16])
@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("tight", [True, False])
def test_resize_partitioner_matches_reference(n, with_hist, tight):
    """Shrinks fold ``p % n``, grows re-bin hosts; with or without a
    histogram, waterfilled or not: the same tables as the reference."""
    port = uniform_partitioner(6, 4096, 1, heavy_capacity=128)
    ref = j_uniform(6, 4096, 1, heavy_capacity=128)
    got = resize_partitioner(port, n, _hist(Histogram) if with_hist else None, eps=0.02,
                             heavy_capacity=128, tight=tight)
    want = j_resize_partitioner(ref, n, _hist(JHistogram) if with_hist else None, eps=0.02,
                                heavy_capacity=128, tight=tight)
    assert got.num_partitions == want.num_partitions == n
    for x, y in zip(got.tables("cpu"), want.tables()):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if tight and not with_hist:  # a resize before any histogram still re-bins hosts
        assert np.bincount(got.host_to_part, minlength=n).min() > 0


def test_resize_partitioner_rejects_zero_partitions():
    with pytest.raises(ValueError):
        j_resize_partitioner(j_uniform(4), 0)
    with pytest.raises(ValueError):
        resize_partitioner(uniform_partitioner(4), 0)


def _elastic_masters(n=8, **kw):
    cfg = dict(elastic=True, imbalance_trigger=50.0, **kw)
    return (DRMaster(uniform_partitioner(n, 4096, 0, heavy_capacity=128), DRConfig(**cfg)),
            JDRMaster(j_uniform(n, 4096, 0, heavy_capacity=128), JDRConfig(**cfg)))


def _loads(n, imbalance):
    loads = np.full(n, 1000.0)
    loads[0] = 1000.0 * imbalance * (n - 1) / (n - imbalance) if imbalance > 1 else 1000.0
    return loads


def _row(a):
    return (a.kind, a.taken, a.reason, getattr(a, "target", None))


# (name, config, [(imbalance, records/s per worker)] per safe point, kinds)
RESIZE_CASES = [
    ("grow after patience", {}, [(2.0, 0)] * 3, ["noop", "resize", "noop"]),
    ("patience 3", dict(resize_patience=3), [(2.0, 0)] * 3, ["noop", "noop", "resize"]),
    ("ceiling", dict(max_partitions=8), [(2.0, 0)] * 3, ["noop"] * 3),
    ("grow capped at the ceiling", dict(max_partitions=12), [(2.0, 0)] * 2, ["noop", "resize"]),
    ("shrink after patience", {}, [(1.0, 0)] * 3, ["noop", "resize", "noop"]),
    ("floor", dict(min_partitions=8), [(1.0, 0)] * 3, ["noop"] * 3),
    ("dead zone resets the streaks", {}, [(2.0, 0), (1.2, 0), (2.0, 0), (2.0, 0)],
     ["noop", "noop", "noop", "resize"]),
    ("cooldown holds a second grow", dict(resize_cooldown=4), [(2.0, 0)] * 8,
     ["noop", "resize", "noop", "noop", "noop", "noop", "resize", "noop"]),
    ("low throughput shrinks in the dead zone", dict(target_throughput=1e12),
     [(1.2, 1)] * 2, ["noop", "resize"]),
    ("low throughput never shrinks a hot spot", dict(target_throughput=1e12,
                                                     max_partitions=8),
     [(2.0, 1)] * 3, ["noop"] * 3),
]


@pytest.mark.parametrize("name,cfg,steps,kinds", RESIZE_CASES, ids=[c[0] for c in RESIZE_CASES])
def test_resize_policy_matches_reference(name, cfg, steps, kinds):
    """Streaks, floors, ceilings, cooldown and the low-throughput shrink:
    the same action, reason and streaks at every safe point; a taken
    resize is applied through ``replan_resize`` on both masters."""
    port, ref = _elastic_masters(**cfg)
    got = []
    for imb, rate in steps:
        n = port.partitioner.num_partitions
        loads = _loads(n, imb)
        extra = dict(records=float(rate) * 2, window_wall_s=1.0) if rate else {}
        a = port.evaluate(Signals(loads=loads, num_workers=2, **extra))
        b = ref.evaluate(JSignals(loads=loads, num_workers=2, **extra))
        assert _row(a) == _row(b)
        if a.kind == "resize":
            port.replan_resize(a.target)
            ref.replan_resize(b.target)
        assert (port.grow_streak, port.shrink_streak, port.last_resize, port.batches_seen) == (
            ref.grow_streak, ref.shrink_streak, ref.last_resize, ref.batches_seen)
        got.append(a.kind)
    assert got == kinds
    _assert_same_snapshot(ref.snapshot(), port.snapshot())


@pytest.mark.parametrize("imbalance", [1.0, 1.3, 2.0])
def test_decide_resize_and_note_resize_match_reference(imbalance):
    port, ref = _elastic_masters(min_partitions=2)
    for _ in range(3):
        loads = _loads(8, imbalance)
        assert port.decide_resize(loads, num_workers=2) == ref.decide_resize(loads, num_workers=2)
        assert (port.grow_streak, port.shrink_streak) == (ref.grow_streak, ref.shrink_streak)
    assert port.decisions.records == [] and ref.decisions.records == []
    port.note_resize(uniform_partitioner(12, 4096, 0))
    ref.note_resize(j_uniform(12, 4096, 0))
    assert port.history == ref.history
    _assert_same_snapshot(ref.snapshot(), port.snapshot())


def _example_batches():
    rng = np.random.default_rng(11)
    hot = [j_zipf_keys(16_384, num_keys=3_000, exponent=1.5, seed=s) for s in range(4)]
    idle = [rng.integers(0, 200_000, 16_384) for _ in range(6)]
    return hot + idle


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_wordcount_elastic_section_matches_reference(driver):
    """The example's elastic job, config and batches: per-batch imbalance,
    partition count and reason (every metric, walls apart) equal to the
    reference's, 4 -> 8 -> 4, and every count exact."""
    batches = _example_batches()
    ref = _drive(JStreamingJob(mesh=_mesh(), num_partitions=4, state_capacity=32_768,
                               dr=JDRConfig(**EXAMPLE_CFG, **DRIVERS[driver])), batches, driver)
    port = _drive(StreamingJob(device="cpu", num_partitions=4, state_capacity=32_768,
                               dr=DRConfig(**EXAMPLE_CFG, **DRIVERS[driver])), batches, driver)
    _assert_same_metrics(ref.metrics, port.metrics)
    assert [(m.batch, m.reason) for m in port.metrics if m.resized] == [
        (1, "resize 4->8"), (7, "resize 8->4")]
    assert [m.num_partitions for m in port.metrics] == [4] + [8] * 6 + [4] * 3
    # the example's own check (its 32,768-row table cannot hold all 80,229
    # keys of the idle batches)
    all_keys = np.concatenate(batches)
    k = int(np.unique(all_keys)[3])
    assert port.state_count(k) == float((all_keys == k).sum()) == ref.state_count(k)
    _assert_same_snapshot(ref.snapshot(), port.snapshot())


@pytest.mark.parametrize("dr_enabled", [True, False])
def test_explicit_resize_waits_for_the_checkpoint_tick(dr_enabled):
    """``resize(12)`` after batch 0 with ``checkpoint_interval=2`` applies at
    batch 1, the first tick, even with the policies off; the same as the
    reference."""
    batches = list(sawtooth_skew(5, 4096, num_keys=2000, exponent=1.3, period=2, seed=1))
    kw = dict(num_partitions=8, state_capacity=16_384, checkpoint_interval=2,
              dr_enabled=dr_enabled)
    jobs = [JStreamingJob(mesh=_mesh(), dr=JDRConfig(migration_cost_weight=0.2), **kw),
            StreamingJob(device="cpu", dr=DRConfig(migration_cost_weight=0.2), **kw)]
    for job in jobs:
        job.process_batch(batches[0])
        job.resize(12)
        for b in batches[1:]:
            job.process_batch(b)
    ref, port = jobs
    _assert_same_metrics(ref.metrics, port.metrics)
    assert [m.resized for m in port.metrics] == [False, True, False, False, False]
    assert [m.num_partitions for m in port.metrics] == [8, 12, 12, 12, 12]
    assert port.metrics[1].reason == "resize 8->12" and port.metrics[1].migration_rows > 0
    _assert_exact_counts(port, batches)


def test_resize_below_the_worker_count_raises():
    with pytest.raises(ValueError, match="workers"):
        StreamingJob(device="cpu", num_workers=4, num_partitions=8).resize(3)
    with pytest.raises(ValueError):
        JStreamingJob(mesh=_mesh(), num_partitions=4).resize(0)
    job = StreamingJob(device="cpu", num_workers=4, num_partitions=8)
    job.resize(4)  # the worker count itself is allowed
    assert job._pending_resize == 4


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, numpy as np
    from repro.core.drm import DRConfig
    from repro.core.streaming import StreamingJob
    from repro.data.generators import sawtooth_skew
    cfg, job_kw, stream, drivers, (after, n) = json.loads(sys.argv[2])
    mesh = lambda w: jax.sharding.Mesh(np.asarray(jax.devices()[:w]), ("data",))
    batches = list(sawtooth_skew(9, 4096, **stream))
    out = {}
    def save(name, job):
        out[f"{name}/metrics"] = json.dumps([dataclasses.asdict(m) for m in job.metrics])
        for k, v in job.snapshot().items():
            out[f"{name}/snap/{k}"] = np.asarray(v)
    for name, extra in drivers.items():
        job = StreamingJob(mesh=mesh(4), dr=DRConfig(**cfg, **extra), **job_kw)
        for i, b in enumerate(batches):
            job.process_batch(b)
            if i == after:
                job.resize(n)
        save(name, job)
    # restores across worker counts: W=4 onto 1 and 2 after batch 4, W=1 onto 4
    for src, dst in ((4, 1), (4, 2), (1, 4)):
        first = StreamingJob(mesh=mesh(src), dr=DRConfig(**cfg), **job_kw)
        first.run(batches[:5])
        job = StreamingJob(mesh=mesh(dst), dr=DRConfig(**cfg), **job_kw)
        job.restore(first.snapshot())
        job.run(batches[5:])
        save(f"{src}to{dst}", job)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic_w4") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    args = json.dumps([W4_CFG, W4_JOB, W4_STREAM, DRIVERS, W4_REQUEST])
    proc = subprocess.run([sys.executable, "-c", REFERENCE_W4, str(out), args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


def _ref_run(reference, name):
    prefix = f"{name}/snap/"
    snap = {k[len(prefix):]: reference[k] for k in reference.files if k.startswith(prefix)}
    return json.loads(str(reference[f"{name}/metrics"])), snap


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_w4_elastic_job_matches_reference(reference_w4, driver):
    """Four workers: grow 8->16, shrink 16->8, the requested 8->12 and the
    policy's 12->16; cross-size migrations exact, equal to the reference."""
    batches = list(sawtooth_skew(9, 4096, **W4_STREAM))
    port = StreamingJob(device="cpu", num_workers=4, dr=DRConfig(**W4_CFG, **DRIVERS[driver]),
                        **W4_JOB)
    _drive(port, batches, driver, [W4_REQUEST])
    metrics, snap = _ref_run(reference_w4, driver)
    _assert_same_metrics(metrics, port.metrics)
    assert [(m.batch, m.reason) for m in port.metrics if m.resized] == [
        (1, "resize 8->16"), (4, "resize 16->8"), (6, "resize 8->12"), (8, "resize 12->16")]
    assert all(m.overflow == 0 for m in port.metrics)
    _assert_same_snapshot(snap, port.snapshot())
    _assert_exact_counts(port, batches)


@pytest.mark.parametrize("src,dst", [(4, 1), (4, 2), (1, 4)])
def test_restore_across_worker_counts_matches_reference(reference_w4, src, dst):
    """A snapshot cut on ``src`` workers resumes on ``dst``: rows re-folded
    on the host, trajectory and state equal to the reference's restore."""
    batches = list(sawtooth_skew(9, 4096, **W4_STREAM))
    first = StreamingJob(device="cpu", num_workers=src, dr=DRConfig(**W4_CFG), **W4_JOB)
    first.run(batches[:5])
    job = StreamingJob(device="cpu", num_workers=dst, dr=DRConfig(**W4_CFG), **W4_JOB)
    job.restore(first.snapshot())
    assert job.num_workers == dst and job.state_keys.shape == (dst, W4_JOB["state_capacity"])
    job.run(batches[5:])
    metrics, snap = _ref_run(reference_w4, f"{src}to{dst}")
    _assert_same_metrics(metrics, job.metrics)
    _assert_same_snapshot(snap, job.snapshot())
    _assert_exact_counts(job, batches)


def _sessions(sched):
    return [(r.rid, sorted(r.sessions), r.queued_tokens) for r in sched.replicas]


def _session_keys(n, hot, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 5000, n)
    keys[rng.random(n) < hot] = 7
    return keys


def test_scheduler_elastic_scale_out_and_in_matches_reference():
    """Auto scale-out under a hot tenant, scale-in once the queues run dry,
    then explicit resizes: the checkpoint records, sessions, queued tokens
    and migrations equal to the reference's at every step."""
    cfg = dict(lam=4.0, imbalance_trigger=1.25, elastic=True, grow_trigger=1.5,
               shrink_trigger=1.1, min_partitions=2, max_partitions=8, resize_patience=1)
    jsched = JScheduler(4, dr=JDRConfig(**cfg), seed=3)
    tsched = DRScheduler(4, dr=DRConfig(**cfg), seed=3)
    sizes = []
    for i, (hot, served) in enumerate([(0.5, 600.0)] * 3 + [(0.0, 1e9)] * 3):
        keys = _session_keys(1500, hot, i)
        for k in keys:
            assert tsched.route(int(k), 3.0) == jsched.route(int(k), 3.0)
        tsched.drain(served)
        jsched.drain(served)
        assert tsched.checkpoint(keys) == jsched.checkpoint(keys)
        assert _sessions(tsched) == _sessions(jsched)
        assert (tsched.migrations, tsched.routed) == (jsched.migrations, jsched.routed)
        sizes.append(len(tsched.replicas))
    assert max(sizes) > 4 and sizes[-1] < max(sizes), sizes
    for n in (6, 2, 2, 5):
        assert tsched.resize(n) == jsched.resize(n)
        assert _sessions(tsched) == _sessions(jsched)
    assert tsched.migrations == jsched.migrations > 0
    _assert_same_snapshot(jsched.drm.snapshot(), tsched.drm.snapshot())
    with pytest.raises(ValueError):
        tsched.resize(0)
