"""The two-choice least-load replica pick in the port against the reference,
on the CPU.

The pick's plain version against the reference's twin (``split_choice_ref``
and the fused route twins, equal and tied loads, a hot replica), the
plane's route with a load vector, the shuffle step with a load vector
against the reference's, and whole jobs with ``DRConfig(split_least_load=
True)``: at W=1 (the reference in this process, on an ``Auto``-axis mesh)
and W=4 (the reference in a subprocess with four host devices, with
``auto_backend`` too), by the serial, depth-1 and depth-2 drivers.
Trajectories (walls and ``overlap_fraction`` apart), decision logs,
snapshots and final state must be equal bit for bit.

The reference's ``StreamingJob._build`` (``src/repro/core/streaming.py:
412-421``) builds its shuffle step without ``least_load=``, so its jobs feed
the route a load vector the route then ignores: they route as the hash pick
does (``test_unrepaired_reference_job_ignores_its_loads`` pins this).  The
port routes on the loads, as ``DRConfig.split_least_load`` documents.  So
the job tests hold the port against the reference with that one argument
supplied in the test's own process (the ``repaired_reference`` fixture and
the W=4 subprocess); nothing under ``src/repro`` changes.
"""
import dataclasses
import functools
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

import repro.core.shuffle as jshuffle
import repro.core.streaming as jstreaming
from repro.core.drm import DRConfig as JDRConfig
from repro.core.partitioner import uniform_partitioner as j_uniform
from repro.exchange.plane import route_dispatch as j_route_dispatch
from repro.kernels import ref as jref
from repro_torch.core.drm import DRConfig
from repro_torch.core.partitioner import uniform_partitioner
from repro_torch.core.shuffle import make_shuffle_step
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import hotspot_flip
from repro_torch.exchange import route_dispatch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# tests/test_torch_split.py's stream: a split at batch 1, an unsplit at 6
CFG = dict(imbalance_trigger=1.2, migration_cost_weight=0.2, split_keys_enabled=True,
           sketch_decay=0.5, split_least_load=True)
JOB = dict(num_partitions=8, state_capacity=16_384)
STREAM = dict(num_keys=2000, exponent=1.3, flip_at=4, seed=0)
# the W=4 job also lets the BackendPolicy switch to ragged (at batch 3)
W4_CFG = dict(CFG, auto_backend=True, backend_patience=2, backend_cooldown=50)
DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
REPO = Path(__file__).resolve().parents[1]
SENT = 2**31 - 1


def _t(x):
    return torch.as_tensor(np.array(x))


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
    assert sorted(ref) == sorted(port)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _feed(job, driver, batches):
    if driver == "depth 1":
        for b in batches:
            job.process_batch(b)
    else:
        job.run(batches)
    return job


def _split_case(n=512, key=7, d=4, n_parts=8):
    """(reference partitioner, keys all ``key``, its home) with ``key``
    split ``d`` ways, as the reference's own least-load test builds it."""
    part = j_uniform(n_parts, 4096, 0, heavy_capacity=128).with_splits({key: d})
    keys = np.full(n, key, np.int32)
    home = int(part.lookup_np(np.array([key], np.int32))[0])
    return part, keys, home


def _port_pick(part, keys, home, loads):
    t = part.tables()
    return tref.split_choice_ref(
        _t(keys), _t(np.asarray(t.heavy_keys)), _t(np.asarray(t.heavy_repl)),
        seed=part.seed, num_partitions=part.num_partitions,
        home=torch.full((len(keys),), home, dtype=torch.int32),
        part_loads=None if loads is None else _t(loads))


def test_least_load_two_choice_ref():
    """The port's pick equals the reference twin's; it steers split traffic
    off an overloaded replica, never leaves the replica set, and with an
    all-equal load vector (or none) routes as the hash pick does."""
    part, keys, home = _split_case()
    t = part.tables()
    kw = dict(seed=part.seed, num_partitions=8)
    homes = jnp.full(len(keys), home, jnp.int32)
    _, off0 = jref.split_choice_ref(jnp.asarray(keys), t.heavy_keys, t.heavy_repl, **kw)
    for loads in (np.ones(8, np.float32), None):
        _, off = _port_pick(part, keys, home, loads)
        np.testing.assert_array_equal(off.numpy(), np.asarray(off0))
    dest0 = (home + np.asarray(off0)) % 8
    hot_rep = np.bincount(dest0, minlength=8).argmax()
    loads = np.ones(8, np.float32)
    loads[hot_rep] = 1e9
    want = jref.split_choice_ref(jnp.asarray(keys), t.heavy_keys, t.heavy_repl, home=homes,
                                 part_loads=jnp.asarray(loads), **kw)
    hit, off = _port_pick(part, keys, home, loads)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want[1]))
    dest = (home + off.numpy()) % 8
    assert (dest == hot_rep).sum() < (dest0 == hot_rep).sum()
    assert set(np.unique(dest).tolist()) <= {(home + j) % 8 for j in range(4)}


def test_least_load_ties_keep_the_first_hash():
    """Only a strictly lower load moves a record: with the load vector
    constant over the replicas the pick is the hash pick, whatever the
    other partitions hold; with one replica lower, exactly the records whose
    second hash lands on it move there."""
    part, keys, home = _split_case(n=2048, d=8)
    reps = [(home + j) % 8 for j in range(8)]
    _, off0 = _port_pick(part, keys, home, None)
    loads = np.full(8, 5.0, np.float32)
    _, off = _port_pick(part, keys, home, loads)
    assert torch.equal(off, off0)
    low = reps[3]
    loads[low] = 4.0
    _, off = _port_pick(part, keys, home, loads)
    dest0, dest = (home + off0.numpy()) % 8, (home + off.numpy()) % 8
    moved = dest != dest0
    assert moved.any() and (dest[moved] == low).all()


def test_route_with_loads_has_no_gate_and_matches_the_twin():
    """The port's plane takes a load vector on the route itself (no gate to
    another path: on the card the kernels read it).  Its route equals the
    reference's twin route with the same vector, and equal loads route as
    no loads do (the reference's ``test_least_load_gates_pallas_statically``
    mirror)."""
    part = uniform_partitioner(8, 4096, 0, heavy_capacity=128).with_splits({7: 4})
    jpart = j_uniform(8, 4096, 0, heavy_capacity=128).with_splits({7: 4})
    rng = np.random.default_rng(1)
    keys = np.where(rng.random(64) < 0.7, 7, rng.integers(0, 500, 64)).astype(np.int32)
    valid = np.ones(64, bool)
    for loads in (np.ones(8, np.float32), rng.random(8).astype(np.float32)):
        want = j_route_dispatch(jpart.tables(), jnp.asarray(keys), jnp.asarray(valid),
                                num_hosts=4096, seed=0, num_lanes=4, num_partitions=8,
                                part_loads=jnp.asarray(loads))
        got = route_dispatch(part.tables("cpu"), _t(keys)[None], _t(valid)[None],
                             num_hosts=4096, seed=0, num_lanes=4, num_partitions=8,
                             part_loads=_t(loads))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    plain = route_dispatch(part.tables("cpu"), _t(keys)[None], _t(valid)[None],
                           num_hosts=4096, seed=0, num_lanes=4, num_partitions=8)
    equal = route_dispatch(part.tables("cpu"), _t(keys)[None], _t(valid)[None],
                           num_hosts=4096, seed=0, num_lanes=4, num_partitions=8,
                           part_loads=torch.ones(8))
    assert all(torch.equal(a, b) for a, b in zip(plain, equal))


@pytest.mark.parametrize("loads", ["ties", "hot replica"])
def test_route_bucketize_with_loads_matches_reference(loads):
    """The fused route + bucketize wrapper (tables padded to the tile, as on
    the card) with a load vector: all seven outputs equal the reference's
    twin on unpadded tables, split keys at fan-outs 8, 4 and 2."""
    from repro.core import Histogram, kip_update
    from repro.data.generators import zipf_keys

    stream = zipf_keys(8192, num_keys=2_000, exponent=1.2, seed=0)
    hist = Histogram.exact(stream).top(64)
    jp = kip_update(j_uniform(16, heavy_capacity=128), hist)
    jp = jp.with_splits({int(hist.keys[i]): d for i, d in enumerate((8, 4, 2))})
    t = jp.tables()
    rng = np.random.default_rng(3)
    keys = stream[:3000].astype(np.int32)
    valid = rng.random(3000) < 0.85
    keys = np.where(valid, keys, SENT).astype(np.int32)
    vals = rng.normal(size=(3000, 2)).astype(np.float32)
    vec = (np.repeat(np.arange(4.0), 4) if loads == "ties"
           else np.where(np.arange(16) == int(jp.lookup_np(hist.keys[:1].astype(np.int32))[0]),
                         1e9, 1.0)).astype(np.float32)
    want = jref.route_bucketize_ref(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(vals), t.heavy_keys, t.heavy_parts,
        t.host_to_part, seed=jp.seed, num_hosts=jp.num_hosts, num_lanes=8, capacity=300,
        key_fill=SENT, heavy_repl=t.heavy_repl, num_partitions=16,
        part_loads=jnp.asarray(vec))
    from repro_torch.core.partitioner import PartitionerTables
    pt = PartitionerTables(*(_t(np.asarray(x)).to(torch.int32) for x in t))
    got = ops.route_bucketize(_t(keys)[None], _t(valid)[None], pt, _t(vals)[None],
                              num_hosts=jp.num_hosts, seed=jp.seed, num_lanes=8,
                              capacity=300, key_fill=SENT, num_partitions=16,
                              part_loads=_t(vec))
    for name, g, w in zip(("part", "slot", "counts", "valid", "keys", "vals", "part buf"),
                          got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w), err_msg=name)


def test_shuffle_step_with_loads_matches_reference():
    """The shuffle step with a load vector against the reference's built
    with ``least_load=True``, on a one-device ``Auto`` mesh: every
    ``ShuffleResult`` field, with a load vector and without one (equal
    loads)."""
    part = uniform_partitioner(8, 4096, 0, heavy_capacity=128).with_splits({7: 4, 11: 8})
    jpart = j_uniform(8, 4096, 0, heavy_capacity=128).with_splits({7: 4, 11: 8})
    rng = np.random.default_rng(2)
    n = 2048
    keys = np.where(rng.random(n) < 0.5, rng.choice([7, 11], n),
                    rng.integers(0, 3000, n)).astype(np.int32)
    keys[-40:] = SENT
    valid = keys != SENT
    vals = np.ones((n, 1), np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    kw = dict(num_partitions=8, capacity=2 * n, hist_k=16, num_hosts=4096, seed=0)
    jstep = jshuffle.make_shuffle_step(mesh, least_load=True, **kw)
    step = make_shuffle_step(num_workers=1, **kw)
    for loads in (None, rng.random(8).astype(np.float32)):
        want = jstep(jpart.tables(), jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid),
                     None if loads is None else jnp.asarray(loads))
        got = step(part.tables("cpu"), _t(keys)[None], _t(vals)[None], _t(valid)[None],
                   None if loads is None else _t(loads))
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.fixture
def repaired_reference(monkeypatch):
    """The reference's ``StreamingJob`` with its shuffle step built with
    ``least_load=True`` (the argument its ``_build`` leaves out), in this
    process only.  With ``split_least_load`` off its load vector stays
    ``None``, which routes as equal loads do: the hash pick."""
    monkeypatch.setattr(jstreaming, "make_shuffle_step",
                        functools.partial(jshuffle.make_shuffle_step, least_load=True))
    return jstreaming.StreamingJob


def _w1_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_w1_least_load_job_matches_reference(repaired_reference, driver):
    """One worker: a split, an unsplit and a second split under the pick;
    equal metrics, decision logs, snapshots and state, counts exact."""
    batches = _batches()
    ref = _feed(repaired_reference(mesh=_w1_mesh(), dr=JDRConfig(**CFG, **DRIVERS[driver]),
                                   **JOB), driver, batches)
    port = _feed(StreamingJob(device="cpu", dr=DRConfig(**CFG, **DRIVERS[driver]), **JOB),
                 driver, batches)
    _assert_same_metrics(ref.metrics, port.metrics)
    assert [m.action for m in port.metrics].count("split") == 2
    assert "unsplit" in [m.action for m in port.metrics]
    _assert_same_snapshot(ref.snapshot(), port.snapshot())
    keys = np.concatenate(batches)
    for key in np.unique(keys)[:50].tolist() + list(ref.drm.split_keys):
        assert port.state_count(int(key)) == float((keys == key).sum())


def test_least_load_job_bit_identical_across_drivers():
    """The reference's own end-to-end case: the three drivers route each
    batch on the previous batch's loads, so trajectories and state agree,
    and the split key's count stays exact (on eight partitions: one cannot
    split)."""
    rng = np.random.default_rng(0)
    batches = [np.where(rng.random(4096) < 0.5, 7, rng.integers(100, 600, 4096))
               for _ in range(6)]
    out = {}
    for name, extra in DRIVERS.items():
        cfg = DRConfig(split_keys_enabled=True, split_patience=1, imbalance_trigger=100.0,
                       split_least_load=True, **extra)
        job = StreamingJob(device="cpu", num_partitions=8, state_capacity=8192, dr=cfg,
                           seed=0)
        ms = job.run(batches)
        out[name] = (job, [(m.action, m.reason, m.overflow, m.shipped_rows, m.padded_rows,
                            m.backend, m.split_keys, m.imbalance) for m in ms])
    assert out["serial"][1] == out["depth 1"][1] == out["depth 2"][1]
    assert any(t[0] == "split" for t in out["depth 2"][1])
    true = float(sum((b == 7).sum() for b in batches))
    for name in out:
        assert out[name][0].state_count(7) == true, name


def test_unrepaired_reference_job_ignores_its_loads():
    """The reference's fault, pinned: its job with ``split_least_load=True``
    routes as its job without it (the loads never reach the route), while
    the port's job with the pick routes differently from its hash-pick
    job, and equals the reference's only with the step's argument
    supplied."""
    batches = _batches(4)
    on = JDRConfig(**CFG, overlap_exchange=False)
    off = JDRConfig(**{**CFG, "split_least_load": False}, overlap_exchange=False)
    ref_on = jstreaming.StreamingJob(mesh=_w1_mesh(), dr=on, **JOB)
    ref_on.run(batches)
    ref_off = jstreaming.StreamingJob(mesh=_w1_mesh(), dr=off, **JOB)
    ref_off.run(batches)
    assert [m.imbalance for m in ref_on.metrics] == [m.imbalance for m in ref_off.metrics]
    port_on = StreamingJob(device="cpu", dr=DRConfig(**CFG, overlap_exchange=False), **JOB)
    port_on.run(batches)
    port_off = StreamingJob(device="cpu", dr=DRConfig(**{**CFG, "split_least_load": False},
                                                      overlap_exchange=False), **JOB)
    port_off.run(batches)
    _assert_same_metrics(ref_off.metrics, port_off.metrics)
    assert [m.action for m in port_on.metrics][1] == "split"
    assert ([m.imbalance for m in port_on.metrics][2:]
            != [m.imbalance for m in port_off.metrics][2:])


def test_telemetry_under_the_pick_has_no_replica_rows(monkeypatch):
    """Under the pick the driver never calls the host twin and records no
    replica rows, as the reference does (the twin does not see the loads)."""
    import repro_torch.core.streaming as streaming

    def twin(*a, **k):
        raise AssertionError("the host twin ran under the least-load pick")

    monkeypatch.setattr(streaming, "split_replica_rows", twin)
    job = StreamingJob(device="cpu", dr=DRConfig(**CFG), **JOB)
    seen = []
    snapshot = job.telemetry.snapshot

    def recording(*a, **k):
        sig = snapshot(*a, **k)
        seen.append(sig.exchange_replica_rows)
        return sig

    job.telemetry.snapshot = recording
    job.run(_batches(5))
    assert job.drm.split_keys and seen and all(r is None for r in seen)


def test_load_vector_follows_batches_and_resets():
    """The driver holds the last batch's loads as float32 (what the next
    route reads), and drops them at a resize (the width changes) and at a
    restore (they predate it)."""
    batches = _batches(4)
    job = StreamingJob(device="cpu", dr=DRConfig(**CFG), **JOB)
    assert job._part_loads is None
    job.process_batch(batches[0])
    loads = job._part_loads
    assert loads.dtype == torch.float32 and loads.shape == (8,)
    assert float(loads.sum()) == float((batches[0] != SENT).sum())
    snap = job.snapshot()
    job.resize(16)
    job.process_batch(batches[1])
    assert job.metrics[-1].resized and job._part_loads is None
    job.process_batch(batches[2])
    assert job._part_loads.shape == (16,)
    job.restore(snap)
    assert job._part_loads is None and job.num_partitions == 8


REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, functools, json
    import jax, numpy as np
    import repro.core.shuffle as jshuffle
    import repro.core.streaming as jstreaming
    from repro.core.drm import DRConfig
    from repro.data.generators import hotspot_flip
    # the shuffle step with the argument the reference's _build leaves out
    jstreaming.make_shuffle_step = functools.partial(jshuffle.make_shuffle_step,
                                                     least_load=True)
    cfg, job_kw, stream, drivers = json.loads(sys.argv[2])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    batches = list(hotspot_flip(10, 4096, **stream))
    out = {}
    for name, extra in drivers.items():
        job = jstreaming.StreamingJob(mesh=mesh, dr=DRConfig(**cfg, **extra), **job_kw)
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
    out = tmp_path_factory.mktemp("least_load_w4") / "ref.npz"
    # XLA:CPU has no ragged all-to-all: the reference's ragged transport
    # runs its masked dense fallback
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_W4, str(out),
         json.dumps([W4_CFG, JOB, STREAM, DRIVERS])],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_w4_least_load_and_auto_backend_job_matches_reference(reference_w4, driver):
    """Four workers, the pick and the BackendPolicy together: the switch to
    ragged at batch 3, then repartitions, the unsplit and a split through
    the ragged transport; equal metrics, snapshots and state."""
    batches = _batches()
    port = _feed(StreamingJob(device="cpu", num_workers=4,
                              dr=DRConfig(**W4_CFG, **DRIVERS[driver]), **JOB),
                 driver, batches)
    _assert_same_metrics(json.loads(str(reference_w4[f"{driver}/metrics"])), port.metrics)
    actions = [m.action for m in port.metrics]
    assert actions[3] == "switch_backend" and {"split", "unsplit"} <= set(actions)
    assert [m.backend for m in port.metrics] == ["dense"] * 4 + ["ragged"] * 6
    assert all(m.shipped_rows < m.padded_rows for m in port.metrics[4:])
    prefix = f"{driver}/snap/"
    ref_snap = {k[len(prefix):]: reference_w4[k] for k in reference_w4.files
                if k.startswith(prefix)}
    _assert_same_snapshot(ref_snap, port.snapshot())
    keys = np.concatenate(batches)
    for key in np.unique(keys)[:50]:
        assert port.state_count(int(key)) == float((keys == key).sum())
