"""Whole-slice parity: the port's ``StreamingJob`` on the CPU against the
reference ``StreamingJob`` — per-batch trajectories and final keyed state,
exactly.

The reference job's merge step (``StreamingJob._merge``, a
``jit(vmap(merge_into))``) fails on a live job under jax 0.9 with
"Mapped away dimension ... inconsistent axis specs: None vs data" at the
first batch.  The tests therefore replace that attribute on the reference
*instance* with the same ``jit(vmap(merge_into))`` applied to host copies of
its five arguments — ``merge_into``'s own semantics, with no file of the
reference changed.  Both packages run their serial drivers
(``overlap_exchange=False``); ``tests/test_torch_overlap.py`` holds the
overlapped drivers to each other.
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
from repro.core.state import merge_into as j_merge
from repro.core.streaming import StreamingJob as JStreamingJob
from repro_torch.carry import job_from_reference_snapshot
from repro_torch.core.drm import DRConfig
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import drifting_zipf
from repro_torch.exchange import ExchangeTopology, FaultPlan, FaultyBackend, LaneFault

CFG = dict(imbalance_trigger=1.1, migration_cost_weight=0.2, overlap_exchange=False)
JOB = dict(num_partitions=8, state_capacity=16_384)
STREAM = dict(num_keys=2000, exponent=1.3, drift_every=2, seed=0)
# host walls differ run to run
UNCOMPARED = {"wall_time_s", "exchange_wall_s"}
REPO = Path(__file__).resolve().parents[1]


def _with_host_merge(job):
    merge = jax.jit(jax.vmap(j_merge))
    job._merge = lambda *args: merge(*[np.asarray(a) for a in args])
    return job


def _reference_job(**kw):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    return _with_host_merge(JStreamingJob(
        mesh=mesh, dr=JDRConfig(**CFG), **JOB, **kw))


def _port_job(**kw):
    return StreamingJob(device="cpu", dr=DRConfig(**CFG), **JOB, **kw)


def _metrics_dict(m, skip=()):
    d = dataclasses.asdict(m) if dataclasses.is_dataclass(m) else dict(m)
    d["shipped_rows_by_class"] = list(d["shipped_rows_by_class"])
    return {k: v for k, v in d.items() if k not in UNCOMPARED and k not in skip}


def _assert_same_trajectory(ref_metrics, port_metrics, skip=()):
    assert len(ref_metrics) == len(port_metrics)
    for a, b in zip(ref_metrics, port_metrics):
        assert _metrics_dict(a, skip) == _metrics_dict(b, skip), a


def _assert_same_state(ref_keys, ref_vals, job):
    np.testing.assert_array_equal(np.asarray(ref_keys), job.state_keys.numpy())
    np.testing.assert_array_equal(np.asarray(ref_vals), job.state_vals.numpy())


def test_w1_whole_slice_parity():
    """The quickstart configuration at a small size on one worker: equal
    trajectories (repartitions at batches 0, 1 and 4) and state."""
    batches = list(drifting_zipf(5, 4096, **STREAM))
    ref = _reference_job()
    port = _port_job()
    _assert_same_trajectory(ref.run(batches), port.run(batches))
    assert [m.batch for m in port.metrics if m.repartitioned] == [0, 1, 4]
    assert all(m.relative_migration == 0.0 for m in port.metrics)
    _assert_same_state(ref.state_keys, ref.state_vals, port)


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, numpy as np
    from repro.core.drm import DRConfig
    from repro.core.state import merge_into
    from repro.core.streaming import StreamingJob
    from repro.data.generators import drifting_zipf
    job = StreamingJob(mesh=jax.make_mesh((4,), ("data",)), num_partitions=8,
                       state_capacity=16_384,
                       dr=DRConfig(imbalance_trigger=1.1, migration_cost_weight=0.2,
                                   overlap_exchange=False))
    merge = jax.jit(jax.vmap(merge_into))
    job._merge = lambda *a: merge(*[np.asarray(x) for x in a])
    batches = list(drifting_zipf(5, 4096, num_keys=2000, exponent=1.3,
                                 drift_every=2, seed=0))
    metrics = [dataclasses.asdict(m) for m in job.run(batches)]
    np.savez(sys.argv[1], state_keys=np.asarray(job.state_keys),
             state_vals=np.asarray(job.state_vals), metrics=json.dumps(metrics))
""")


def test_w4_whole_slice_parity_moves_state(tmp_path):
    """Four workers, the reference on a 4-device CPU mesh in a subprocess:
    equal trajectories — relative migration, overflow and shipped rows
    included — and a bit-identical final [4, S] state."""
    out = tmp_path / "ref_w4.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", REFERENCE_W4, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(out)
    port = _port_job(num_workers=4)
    port.run(drifting_zipf(5, 4096, **STREAM))
    _assert_same_trajectory(json.loads(str(ref["metrics"])), port.metrics)
    assert any(m.relative_migration > 0 for m in port.metrics)
    assert [m.shipped_rows for m in port.metrics] == [8448, 8224, 8192, 8192, 9216]
    _assert_same_state(ref["state_keys"], ref["state_vals"], port)


def test_exact_counts_w8_after_repartitions():
    batches = list(drifting_zipf(6, 8192, num_keys=3000, exponent=1.4, drift_every=2, seed=3))
    job = StreamingJob(device="cpu", num_workers=8, num_partitions=16, state_capacity=4096,
                       dr=DRConfig(**CFG))
    job.run(batches)
    assert sum(m.repartitioned for m in job.metrics) >= 2
    assert all(m.overflow == 0 for m in job.metrics)
    all_keys = np.concatenate(batches)
    uniq, counts = np.unique(all_keys, return_counts=True)
    for i in np.random.default_rng(0).choice(len(uniq), 40, replace=False):
        assert job.state_count(int(uniq[i])) == float(counts[i])
    assert job.state_count(int(uniq[np.argmax(counts)])) == float(counts.max())
    live = job.state_keys != 2**31 - 1
    assert int(live.sum()) == len(uniq)


def test_carry_reference_snapshot_across():
    """The reference runs three batches and snapshots; a port job built from
    that snapshot and the reference both run two more: equal trajectories
    and state."""
    batches = list(drifting_zipf(5, 4096, **STREAM))
    ref = _reference_job()
    ref.run(batches[:3])
    snap = ref.snapshot()
    port = job_from_reference_snapshot(snap, config=DRConfig(**CFG), device="cpu")
    assert port.drm.batches_seen == 3 and len(port.drm.decisions) == 3
    _assert_same_state(snap["state_keys"], snap["state_vals"], port)
    # a restored job numbers its batches from 0, in both packages
    _assert_same_trajectory(ref.run(batches[3:]), port.run(batches[3:]), skip={"batch"})
    _assert_same_state(ref.state_keys, ref.state_vals, port)
    port_snap = port.snapshot()
    ref_snap = ref.snapshot()
    assert sorted(port_snap) == sorted(ref_snap)
    for k in ref_snap:
        np.testing.assert_array_equal(np.asarray(ref_snap[k]), np.asarray(port_snap[k]),
                                      err_msg=k)


def test_port_snapshot_restore_round_trip():
    batches = list(drifting_zipf(5, 4096, **STREAM))
    whole = _port_job(num_workers=2)
    whole.run(batches)
    first = _port_job(num_workers=2)
    first.run(batches[:3])
    resumed = _port_job(num_workers=2)
    resumed.restore(first.snapshot())
    resumed.run(batches[3:])
    _assert_same_trajectory(whole.metrics[3:], resumed.metrics, skip={"batch"})
    assert torch.equal(whole.state_keys, resumed.state_keys)
    assert torch.equal(whole.state_vals, resumed.state_vals)


@pytest.mark.parametrize("key", ["drm_topology_lanes_per_host", "drm_health_num_lanes",
                                 "drm_quarantined_lane"])
def test_carry_rejects_unported_snapshot_keys(key):
    """The keys once unported carry into the port.  A reference snapshot
    with a lane topology (its three ``topology_*`` keys), or with the health
    record (and, for ``drm_quarantined_lane``, a quarantine ledger naming a
    lane that no job has parked, which both restores trim) carries into the
    port, and both jobs run on alike."""
    from repro.exchange import ExchangeTopology as JTopology

    batches = list(drifting_zipf(4, 1024, **STREAM))
    topology = key == "drm_topology_lanes_per_host"
    cfg = CFG if topology else dict(CFG, health_enabled=True)
    kw = dict(topology=JTopology(1, 1, (0.0, 2.0, 7.0))) if topology else {}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = JStreamingJob(mesh=mesh, dr=JDRConfig(**cfg), **JOB, **kw)
    ref.run(batches[:2])
    snap = ref.snapshot()
    assert key in snap
    if key == "drm_quarantined_lane":
        snap |= {key: np.asarray([3], np.int64), "drm_quarantined_tick": np.asarray([1], np.int64)}
    ref.restore(snap)
    port = job_from_reference_snapshot(snap, config=DRConfig(**cfg), device="cpu")
    if topology:
        assert port.exchange_topology == port.drm.exchange_topology
        assert (port.exchange_topology.num_lanes, port.exchange_topology.lanes_per_host,
                port.exchange_topology.class_weights) == (1, 1, (0.0, 2.0, 7.0))
    assert port.drm.quarantined == ref.drm.quarantined == []
    _assert_same_trajectory(ref.run(batches[2:]), port.run(batches[2:]), skip={"batch"})
    ref_snap, port_snap = ref.snapshot(), port.snapshot()
    assert sorted(ref_snap) == sorted(port_snap)
    for k in ref_snap:
        np.testing.assert_array_equal(np.asarray(ref_snap[k]), np.asarray(port_snap[k]),
                                      err_msg=k)


@pytest.mark.parametrize("make,ported", [
    (lambda: _port_job(exchange_backend="ragged"), True),
    (lambda: _port_job(exchange_backend="hierarchical"), True),
    (lambda: _port_job(topology=ExchangeTopology(1, 1)), True),
    (lambda: StreamingJob(device="cpu", dr=DRConfig(split_least_load=True)), True),
    (lambda: StreamingJob(device="cpu", dr=DRConfig(snapshot_interval=1),
                          exchange_backend=FaultyBackend(
                              "dense", FaultPlan(faults=(LaneFault(1, 0, "kill"),)))), True),
])
def test_unported_paths_raise(make, ported):
    """What is not ported raises, citing its ROADMAP item; the ragged and
    hierarchical transports, the lane topology, the least-load pick and
    zero-loss recovery are ported, and their jobs run
    (``tests/test_torch_backends.py``, ``tests/test_torch_topology.py``,
    ``tests/test_torch_least_load.py`` and ``tests/test_torch_recovery.py``
    hold them to the reference)."""
    if ported:
        job = make()
        job.run(list(drifting_zipf(2, 1024, **STREAM)))
        assert len(job.metrics) == 2
        assert len(job.recoveries) == isinstance(job.exchange_backend, FaultyBackend)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()
