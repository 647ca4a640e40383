"""Hot-key splitting in the port against the reference, on the CPU.

``split_replica_rows`` (the host twin of the route's replica pick), the
``SplitPolicy`` (fires after its patience, its dead zone, its priced relief,
the unsplit of a cooled key), replica tables across a resize, and whole
jobs over a small ``hotspot_flip`` stream that take both a ``Split`` and an
``Unsplit``: at W=1 (the reference in this process, on an ``Auto``-axis
mesh) and W=4 (the reference in a subprocess with four host devices), by
the serial, depth-1 and depth-2 drivers.  Trajectories (walls and
``overlap_fraction`` apart), decision logs, snapshots and final state must
be equal bit for bit, and a snapshot with installed splits must carry over
between the packages in both directions.
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
from repro.core.partitioner import split_replica_rows as j_split_replica_rows
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.core.streaming import StreamingJob as JStreamingJob
from repro.data.generators import hotspot_flip as j_hotspot_flip
from repro_torch.carry import job_from_reference_snapshot
from repro_torch.control import Signals
from repro_torch.core.drm import DRConfig, DRMaster
from repro_torch.core.partitioner import split_replica_rows, uniform_partitioner
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import hotspot_flip

# a small stream that splits its hot key at batch 1, un-splits it at batch 6
# (the key went cold at the flip, batch 4) and splits the new one at batch 8
CFG = dict(imbalance_trigger=1.2, migration_cost_weight=0.2, split_keys_enabled=True,
           sketch_decay=0.5)
JOB = dict(num_partitions=8, state_capacity=16_384)
STREAM = dict(num_keys=2000, exponent=1.3, flip_at=4, seed=0)
DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
REPO = Path(__file__).resolve().parents[1]


def _batches(n=10, size=4096):
    return list(hotspot_flip(n, size, **STREAM))


def _fields(m):
    d = dataclasses.asdict(m) if dataclasses.is_dataclass(m) else dict(m)
    d["shipped_rows_by_class"] = list(d["shipped_rows_by_class"])
    return {k: v for k, v in d.items() if k not in WALLS}


def _assert_same_metrics(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert _fields(a) == _fields(b), a


def _assert_same_snapshot(ref: dict, port: dict):
    """Equal keys, and for every key an equal value of the same dtype."""
    assert sorted(ref) == sorted(port)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _run_port(driver, batches, **kw):
    job = StreamingJob(device="cpu", dr=DRConfig(**CFG, **DRIVERS[driver]), **JOB, **kw)
    if driver == "depth 1":
        for b in batches:
            job.process_batch(b)
    else:
        job.run(batches)
    return job


def test_hotspot_flip_matches_reference():
    for ours, theirs in zip(hotspot_flip(6, 3000, num_keys=500, exponent=1.4, flip_at=2, seed=5),
                            j_hotspot_flip(6, 3000, num_keys=500, exponent=1.4, flip_at=2, seed=5)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    default = list(hotspot_flip(4, 100, seed=1))  # flip at the midpoint
    np.testing.assert_array_equal(np.concatenate(default),
                                  np.concatenate(list(j_hotspot_flip(4, 100, seed=1))))


@pytest.mark.parametrize("workers", [1, 3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_split_replica_rows_matches_reference(workers, masked):
    """The host twin, split keys at fan-outs 2-8 (one more than the partition
    count, clamped), a split key absent from the batch, per-worker chunks."""
    rng = np.random.default_rng(workers)
    keys = rng.integers(0, 50, 12 * 1024).astype(np.int32)
    valid = rng.random(len(keys)) > 0.2 if masked else None
    splits = {3: 2, 7: 8, 11: 5, 10**6: 3}
    port = uniform_partitioner(7, 4096, 3, heavy_capacity=128).with_splits(splits)
    ref = j_uniform(7, 4096, 3, heavy_capacity=128).with_splits(splits)
    got = split_replica_rows(port, keys, workers, valid)
    want = j_split_replica_rows(ref, keys, workers, valid)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    sent = (np.isin(keys, [3, 7, 11]) & (valid if masked else True)).sum()
    assert got.sum() == sent
    # no split installed: zeros
    np.testing.assert_array_equal(split_replica_rows(uniform_partitioner(7), keys, workers),
                                  np.zeros(7, np.int64))


def _hist_feed(rng, hot_share, n=4096, hot_key=17):
    """A top-k histogram batch whose hottest key holds ``hot_share``."""
    keys = rng.integers(100, 5000, n)
    keys[: int(hot_share * n)] = hot_key
    u, c = np.unique(keys, return_counts=True)
    order = np.argsort(-c, kind="stable")[:64]
    return u[order][None], c[order][None], float(n)


def _masters(**kw):
    cfg = dict(split_keys_enabled=True, imbalance_trigger=50.0, **kw)
    return (DRMaster(uniform_partitioner(8, 4096, 0, heavy_capacity=128), DRConfig(**cfg)),
            JDRMaster(j_uniform(8, 4096, 0, heavy_capacity=128), JDRConfig(**cfg)))


def _action_row(a):
    return (a.kind, a.taken, a.reason, getattr(a, "key", None), getattr(a, "replicas", None),
            round(float(getattr(a, "est_migration", 0.0)), 12))


# (name, config, hot shares fed one safe point each, kinds expected)
SPLIT_CASES = [
    ("fires after its patience", {}, [0.5, 0.5, 0.5], ["noop", "split", "noop"]),
    ("patience 3", dict(split_patience=3), [0.5] * 4, ["noop", "noop", "split", "noop"]),
    ("dead zone", {}, [0.1] * 3, ["noop"] * 3),
    ("priced relief declines", dict(migration_cost_weight=1e6), [0.5] * 3, ["noop"] * 3),
    ("cooldown", dict(split_cooldown=5), [0.5, 0.5] + [0.0] * 7,
     ["noop", "split"] + ["noop"] * 5 + ["unsplit", "noop"]),
    ("unsplit when cooled", {}, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
     ["noop", "split", "noop", "noop", "unsplit", "noop"]),
    ("fan-out clamped to split_max_replicas", dict(split_max_replicas=3), [0.9, 0.9],
     ["noop", "split"]),
]


@pytest.mark.parametrize("name,cfg,shares,kinds", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_policy_matches_reference(name, cfg, shares, kinds):
    """Both masters fed the same histograms: the same actions, reasons,
    streaks, replica maps, tables and decision logs at every safe point."""
    port, ref = _masters(sketch_decay=0.3, **cfg)
    rng = np.random.default_rng(0)
    got = []
    for share in shares:
        hk, hc, total = _hist_feed(rng, share)
        port.observe(hk, hc, total_records=total)
        ref.observe(hk, hc, total_records=total)
        loads = np.full(8, 512.0)
        loads[0] += share * 4096
        a = port.evaluate(Signals(loads=loads, num_workers=2))
        b = ref.evaluate(JSignals(loads=loads, num_workers=2))
        assert _action_row(a) == _action_row(b)
        assert (port.split_streak, port.last_split, port.split_keys) == (
            ref.split_streak, ref.last_split, ref.split_keys)
        for x, y in zip(port.partitioner.tables("cpu"), ref.partitioner.tables()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        got.append(a.kind)
    assert got == kinds
    if "split" in kinds and "clamped" in name:
        assert port.split_keys == {17: 3}
    _assert_same_snapshot(ref.snapshot(), port.snapshot())


@pytest.mark.parametrize("target", [16, 4, 2, 1])
def test_with_splits_survive_a_resize(target):
    """``replan_resize`` keeps installed splits with each fan-out clamped to
    the new count (at one partition every split folds away)."""
    port, ref = _masters()
    rng = np.random.default_rng(1)
    for _ in range(3):
        hk, hc, total = _hist_feed(rng, 0.6)
        port.observe(hk, hc, total_records=total)
        ref.observe(hk, hc, total_records=total)
    for m in (port, ref):
        m.split_keys = {17: 8, 4242: 3}
        m.partitioner = m.partitioner.with_splits(m.split_keys)
    new, jnew = port.replan_resize(target), ref.replan_resize(target)
    assert port.split_keys == ref.split_keys
    assert port.split_keys == {k: d for k, d in {17: min(8, target),
                                                 4242: min(3, target)}.items() if d > 1}
    for x, y in zip(new.tables("cpu"), jnew.tables()):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    _assert_same_snapshot(ref.snapshot(), port.snapshot())


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_w1_split_job_matches_reference(driver):
    """One worker, the reference in this process: a Split, an Unsplit and a
    second Split; equal metrics, decision logs, snapshots and state, and
    every key's count exact (partials summed at the unsplit)."""
    batches = _batches()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = JStreamingJob(mesh=mesh, dr=JDRConfig(**CFG, **DRIVERS[driver]), **JOB)
    if driver == "depth 1":
        for b in batches:
            ref.process_batch(b)
    else:
        ref.run(batches)
    port = _run_port(driver, batches)
    _assert_same_metrics(ref.metrics, port.metrics)
    assert [m.action for m in port.metrics].count("split") == 2
    assert [m.batch for m in port.metrics if m.action == "unsplit"] == [6]
    assert all(m.overflow == 0 for m in port.metrics)
    _assert_same_snapshot(ref.snapshot(), port.snapshot())
    keys = np.concatenate(batches)
    uniq, counts = np.unique(keys, return_counts=True)
    got = port.state_keys.reshape(-1).numpy()
    vals = port.state_vals.reshape(-1).numpy()
    live = got != 2**31 - 1
    np.testing.assert_array_equal(np.sort(got[live]), uniq)  # one row a key: partials merged
    np.testing.assert_array_equal(vals[live][np.argsort(got[live])], counts)


def test_split_telemetry_counts_replica_rows():
    """While a split is installed the telemetry carries the host twin's rows
    per partition, and they land on the split key's ``d`` partitions."""
    batches = _batches(4)
    job = StreamingJob(device="cpu", dr=DRConfig(**CFG), **JOB)
    seen = []
    record = job.telemetry.record_exchange

    def spy(stats):
        if stats.replica_rows is not None:
            seen.append((len(job.metrics), np.asarray(stats.replica_rows)))
        record(stats)

    job.telemetry.record_exchange = spy
    job.run(batches)
    assert [m.action for m in job.metrics][:2] == ["repartition", "split"]
    assert [i for i, _ in seen] == [2, 3]  # the batches after the split
    (key, d), = job.drm.split_keys.items()
    home = int(job.drm.partitioner.lookup_np(np.asarray([key], np.int32))[0])
    for i, rows in seen:
        np.testing.assert_array_equal(rows, split_replica_rows(job.drm.partitioner,
                                                               batches[i], 1))
        assert set(np.nonzero(rows)[0]) == {(home + r) % 8 for r in range(d)}
        assert rows.sum() == (batches[i] == key).sum()


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, numpy as np
    from repro.core.drm import DRConfig
    from repro.core.streaming import StreamingJob
    from repro.data.generators import hotspot_flip
    cfg, job_kw, stream, drivers = json.loads(sys.argv[2])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    batches = list(hotspot_flip(10, 4096, **stream))
    out = {}
    for name, extra in drivers.items():
        job = StreamingJob(mesh=mesh, dr=DRConfig(**cfg, **extra), **job_kw)
        if name == "depth 1":
            for b in batches:
                job.process_batch(b)
        else:
            job.run(batches)
        out[f"{name}/metrics"] = json.dumps([dataclasses.asdict(m) for m in job.metrics])
        for k, v in job.snapshot().items():
            out[f"{name}/snap/{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("split_w4") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(out), json.dumps([CFG, JOB, STREAM, DRIVERS])],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_w4_split_job_matches_reference(reference_w4, driver):
    """Four workers: the same actions as the reference, splits fanned over
    workers, partials summed across workers at the unsplit."""
    port = _run_port(driver, _batches(), num_workers=4)
    _assert_same_metrics(json.loads(str(reference_w4[f"{driver}/metrics"])), port.metrics)
    assert "unsplit" in [m.action for m in port.metrics]
    assert "split" in [m.action for m in port.metrics]
    prefix = f"{driver}/snap/"
    ref_snap = {k[len(prefix):]: reference_w4[k] for k in reference_w4.files
                if k.startswith(prefix)}
    _assert_same_snapshot(ref_snap, port.snapshot())


def test_split_snapshot_carries_between_packages():
    """A port snapshot taken with a split installed resumes in the reference,
    and the reference's in the port: both go on as the uninterrupted job
    does (the unsplit at batch 6 included)."""
    batches = _batches()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    whole = _run_port("serial", batches)
    port = _run_port("serial", batches[:3])
    snap = port.snapshot()
    assert snap["drm_split_keys"].size == 1
    ref = JStreamingJob(mesh=mesh, dr=JDRConfig(**CFG, **DRIVERS["serial"]), **JOB)
    ref.restore(snap)
    ref.run(batches[3:])
    _assert_same_metrics([m for m in whole.metrics[3:]],
                         [dataclasses.replace(m, batch=m.batch + 3) for m in ref.metrics])
    np.testing.assert_array_equal(np.asarray(ref.state_keys), whole.state_keys.numpy())
    np.testing.assert_array_equal(np.asarray(ref.state_vals), whole.state_vals.numpy())

    ref = JStreamingJob(mesh=mesh, dr=JDRConfig(**CFG, **DRIVERS["serial"]), **JOB)
    ref.run(batches[:3])
    back = job_from_reference_snapshot(ref.snapshot(), config=DRConfig(**CFG, **DRIVERS["serial"]),
                                       device="cpu")
    assert back.drm.split_keys and back.drm.split_keys == port.drm.split_keys
    back.run(batches[3:])
    _assert_same_metrics(whole.metrics[3:],
                         [dataclasses.replace(m, batch=m.batch + 3) for m in back.metrics])
    assert torch.equal(back.state_keys, whole.state_keys)
    assert torch.equal(back.state_vals, whole.state_vals)
