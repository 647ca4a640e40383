"""The process-group transport on the CPU: four gloo processes, one worker
each, against the stacked transport and against the reference's
four-device mesh.

A module fixture spawns four ranks once (``tests/dist_cases.py``, the
spawn start method, a ``file://`` store under the test's temporary
directory, so that parallel test workers never share a port) and, beside
them, one reference subprocess with four host devices on an ``Auto``-axis
mesh (``REPRO_DISABLE_NATIVE_RAGGED=1``: XLA:CPU has no ragged
all-to-all).  The ranks save what they saw; the tests compare:

* every backend's exchange, rank by rank, with the stacked transport's
  rows of the same inputs (received rows, masks, counts, overflow, shipped
  rows and their classes, the split phase, a recycled dirty send set and
  the backhaul), the native ragged ship and the masked one both, and the
  bytes each hands the group;
* ``StreamingJob(group=...)`` under the serial, depth-1 and depth-2
  drivers on the dense, ragged and hierarchical exchanges with the
  reference's run of the same driver: every ``BatchMetrics`` field but the
  walls (``overlap_fraction`` is a ratio of walls), the gathered final
  state bit for bit, and every rank's ``DecisionLog`` equal;
* a resize, the split / unsplit with the least-load pick, the
  BackendPolicy's switch and a safe point every second batch
  (``checkpoint_interval=2``) with the port's stacked job;
* the refusals (a ``FaultPlan``, the worker-set actions), the decision
  digest, the topology a group reads, and a one-rank group.

The whole file takes about 40-60 s on an 8-core CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import dist_cases as dc
from repro.launch.mesh import exchange_topology_of as j_exchange_topology_of
from repro_torch.compat import has_ragged_all_to_all
from repro_torch.core.drm import DRConfig
from repro_torch.core.streaming import StreamingJob
from repro_torch.data.generators import drifting_zipf, hotspot_flip
from repro_torch.exchange import ExchangeTopology
from repro_torch.launch.mesh import exchange_topology_of, lanes_per_host_of

REPO = Path(__file__).resolve().parents[1]
WALLS = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}

REFERENCE_W4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, numpy as np
    from repro.core.drm import DRConfig
    from repro.core.streaming import StreamingJob
    from repro.data.generators import drifting_zipf
    from repro.exchange import ExchangeTopology
    cfg, job_kw, stream, n, jobs, drivers = json.loads(sys.argv[2])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    batches = list(drifting_zipf(n, 4096, **stream))
    out = {}
    for backend, topo in jobs.items():
        for driver, extra in drivers.items():
            job = StreamingJob(mesh=mesh, dr=DRConfig(**cfg, **extra), exchange_backend=backend,
                               topology=None if topo is None else ExchangeTopology(*topo),
                               **job_kw)
            if driver == "depth 1":
                for b in batches:
                    job.process_batch(b)
            else:
                job.run(batches)
            name = f"{backend}/{driver}"
            out[f"{name}/metrics"] = json.dumps([dataclasses.asdict(m) for m in job.metrics])
            out[f"{name}/keys"] = np.asarray(job.state_keys)
            out[f"{name}/vals"] = np.asarray(job.state_vals)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, from one spawn and one
    subprocess running side by side."""
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DISABLE_NATIVE_RAGGED="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    args = json.dumps([dc.CFG, dc.JOB, dc.STREAM, dc.NUM_BATCHES, dc.JOBS, dc.DRIVERS])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_W4, str(d / "ref.npz"), args],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = dc.spawn(d, dc.W, {"sections": ("backends", "jobs", "extras", "one rank")})
        _, err = ref.communicate(timeout=dc.SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    return ranks, np.load(d / "ref.npz")


def _fields(m):
    d = dataclasses.asdict(m) if dataclasses.is_dataclass(m) else dict(m)
    d["shipped_rows_by_class"] = list(d["shipped_rows_by_class"])
    return {k: v for k, v in d.items() if k not in WALLS}


def _assert_same_metrics(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert _fields(a) == _fields(b), a


def _assert_job_equals_stacked(ranks, name, stacked):
    rec = ranks[0][name]
    _assert_same_metrics(stacked.metrics, rec["metrics"])
    np.testing.assert_array_equal(rec["keys"], stacked.state_keys.numpy())
    np.testing.assert_array_equal(rec["vals"], stacked.state_vals.numpy())
    assert all(r[name]["decisions"] == rec["decisions"] for r in ranks)


# ---------------------------------------------------------------------------
# The exchange: every backend against the stacked transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(dc.EXCHANGES))
def test_exchange_equals_stacked(runs, name):
    """Rank r's outputs are row r of the stacked transport's, for every
    field the exchange returns (the ragged ships, native and masked, give
    the pad rows the payloads' fills)."""
    ranks, _ = runs
    backend = dc.EXCHANGES[name][0]
    want = dc.exchange_case(dc.exchange_spec(name), backend, *dc.exchange_inputs())
    got = [r[f"exchange/{name}"] for r in ranks]
    assert sorted(got[0]) == sorted(want)
    for k, v in want.items():
        if k == "ships":  # the stacked instance counts all workers' ships once
            assert all((g[k] == v).all() for g in got), k
            continue
        np.testing.assert_array_equal(np.concatenate([g[k] for g in got]), v, err_msg=k)
    if backend != "local":
        lane_counts = want["lane_counts"]
        assert (lane_counts[:, 2] == 0).all() and (want["lane_overflow"][:, 0] > 0).all()


@pytest.mark.parametrize("topo", ["flat", "4x2"])
def test_native_ragged_equals_masked(runs, topo):
    """The native uneven ship and ``REPRO_DISABLE_NATIVE_RAGGED=1``'s masked
    dense ship give the same receive tensors on every rank, pad rows
    included; only the bytes differ."""
    ranks, _ = runs
    for r in ranks:
        native, masked = r[f"exchange/ragged/{topo}"], r[f"exchange/ragged/{topo}/masked"]
        assert sorted(native) == sorted(masked)
        for k in native:
            np.testing.assert_array_equal(native[k], masked[k], err_msg=k)
        assert r[f"traffic/ragged/{topo}"]["all_to_all_uneven"] > 0
        assert r[f"traffic/ragged/{topo}/masked"]["all_to_all_uneven"] == 0


def test_native_ragged_ships_only_the_counted_rows(runs):
    """A fused ragged call hands the group its lane counts (one int32 a
    lane) and, natively, each counted row once (12 bytes of values and 4
    of ids); the masked ship hands it every padded row."""
    ranks, _ = runs
    row = 3 * 4 + 4
    for r in ranks:
        native, masked = r["fused traffic/ragged/flat"], r["fused traffic/ragged/flat/masked"]
        counted = int(r["fused counts/ragged/flat"].sum())
        assert native == {"all_to_all": 4 * dc.W, "all_to_all_uneven": counted * row,
                          "all_reduce": 0, "all_gather": 0, "shift": 0}
        assert masked == {"all_to_all": 4 * dc.W + dc.W * dc.CAP * row,
                          "all_to_all_uneven": 0, "all_reduce": 0, "all_gather": 0,
                          "shift": 0}
        assert counted < dc.W * dc.CAP


def test_a_bound_spec_needs_one_lane_a_rank(runs):
    ranks, _ = runs
    assert all("needs one lane a rank" in r["lanes refused"] for r in ranks)


@pytest.mark.parametrize("value,native", [(None, True), ("0", True), ("false", True),
                                          ("1", False), ("true", False)])
def test_has_ragged_all_to_all_reads_the_switch(monkeypatch, value, native):
    if value is None:
        monkeypatch.delenv("REPRO_DISABLE_NATIVE_RAGGED", raising=False)
    else:
        monkeypatch.setenv("REPRO_DISABLE_NATIVE_RAGGED", value)
    assert has_ragged_all_to_all() is native


# ---------------------------------------------------------------------------
# The streaming job against the reference's four-device run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver", list(dc.DRIVERS))
@pytest.mark.parametrize("backend", list(dc.JOBS))
def test_job_matches_reference(runs, backend, driver):
    """Four ranks, one worker each: every metric but the walls equal the
    reference's run by the same driver, the gathered state is bit-equal,
    and every rank logged the same decisions."""
    ranks, ref = runs
    name = f"{backend}/{driver}"
    rec = ranks[0][f"job/{name}"]
    _assert_same_metrics(json.loads(str(ref[f"{name}/metrics"])), rec["metrics"])
    np.testing.assert_array_equal(rec["keys"], ref[f"{name}/keys"])
    np.testing.assert_array_equal(rec["vals"], ref[f"{name}/vals"])
    assert sum(m["repartitioned"] for m in rec["metrics"]) >= 2
    assert all(m["overflow"] == 0 and m["backend"] == backend for m in rec["metrics"])
    assert all(r[f"job/{name}"]["decisions"] == rec["decisions"] for r in ranks)
    assert all(np.array_equal(r[f"job/{name}"]["keys"], rec["keys"]) for r in ranks)
    if backend == "hierarchical":
        assert all(sum(m["shipped_rows_by_class"]) == m["shipped_rows"] for m in rec["metrics"])


@pytest.mark.parametrize("driver", list(dc.DRIVERS))
def test_split_pick_and_switch_equal_stacked(runs, driver):
    """The least-load pick's split, the BackendPolicy's switch to ragged at
    batch 3 and the unsplit, over four ranks: equal to the stacked job."""
    ranks, _ = runs
    stacked = StreamingJob(device="cpu", num_workers=dc.W,
                           dr=DRConfig(**dc.SPLIT_CFG, **dc.DRIVERS[driver]), **dc.JOB)
    dc.feed(stacked, driver, list(hotspot_flip(10, 4096, **dc.SPLIT_STREAM)))
    actions = [m.action for m in stacked.metrics]
    assert actions[3] == "switch_backend" and {"split", "unsplit"} <= set(actions)
    _assert_job_equals_stacked(ranks, f"split/{driver}", stacked)


@pytest.mark.parametrize("driver", ["serial", "depth 1"])
def test_resize_equals_stacked(runs, driver):
    """A requested resize 8 -> 16 after two batches: equal to the stacked
    job."""
    ranks, _ = runs
    stacked = StreamingJob(device="cpu", num_workers=dc.W,
                           dr=DRConfig(**dc.CFG, **dc.DRIVERS[driver]), **dc.JOB)
    batches = list(drifting_zipf(dc.NUM_BATCHES, 4096, **dc.STREAM))
    dc.feed(stacked, driver, batches[:2])
    stacked.resize(16)
    dc.feed(stacked, driver, batches[2:])
    assert [m.resized for m in stacked.metrics] == [False, False, True, False, False]
    _assert_job_equals_stacked(ranks, f"resize/{driver}", stacked)


@pytest.mark.parametrize("driver", dc.INTERVAL_DRIVERS)
def test_checkpoint_interval_2_equals_stacked(runs, driver):
    """A safe point every second batch: the ticks between log no decision
    and compare none across the ranks; equal to the stacked job."""
    ranks, _ = runs
    stacked = StreamingJob(device="cpu", num_workers=dc.W, checkpoint_interval=2,
                           dr=DRConfig(**dc.CFG, **dc.DRIVERS[driver]), **dc.JOB)
    dc.feed(stacked, driver, list(drifting_zipf(dc.NUM_BATCHES, 4096, **dc.STREAM)))
    assert len(stacked.drm.decisions.records) == 2  # batches 1 and 3 of 5
    assert any(m.repartitioned for m in stacked.metrics)
    _assert_job_equals_stacked(ranks, f"interval 2/{driver}", stacked)


@pytest.mark.parametrize("name", ["own", "from W=2"])
def test_restore_equals_stacked(runs, name):
    """A group job restored from its own gathered snapshot, and from a
    stacked two-worker one (re-folded onto the four ranks), then run by the
    depth-1 driver: equal to the stacked job restored the same way."""
    ranks, _ = runs
    batches = list(drifting_zipf(dc.NUM_BATCHES, 4096, **dc.STREAM))
    if name == "own":
        first = StreamingJob(device="cpu", num_workers=dc.W,
                             dr=DRConfig(**dc.CFG, overlap_exchange=False), **dc.JOB)
        first.run(batches[:2])
        snap = first.snapshot()
    else:
        snap = dc.two_worker_snapshot(batches)
    stacked = StreamingJob(device="cpu", num_workers=dc.W, dr=DRConfig(**dc.CFG), **dc.JOB)
    stacked.restore(snap)
    dc.feed(stacked, "depth 1", batches[2:])
    _assert_job_equals_stacked(ranks, f"restore/{name}", stacked)


@pytest.mark.parametrize("kind", dc.REFUSALS)
def test_worker_set_changes_raise(runs, kind):
    """A FaultPlan and the actions that change the set of workers need a
    rebuilt group: each raises NotImplementedError on every rank."""
    ranks, _ = runs
    assert all(r["refused"][kind] is not None and "ROADMAP.md" in r["refused"][kind]
               for r in ranks)


def test_a_rank_that_decides_otherwise_stops_every_rank(runs):
    ranks, _ = runs
    assert all(r["mismatch"] is not None and "decided differently" in r["mismatch"]
               for r in ranks)


@pytest.mark.parametrize("backend", ["dense", "ragged"])
def test_one_rank_group_equals_stacked(runs, backend):
    ranks, _ = runs
    stacked = StreamingJob(device="cpu", exchange_backend=backend,
                           dr=DRConfig(**dc.CFG, overlap_exchange=False), **dc.JOB)
    stacked.run(list(drifting_zipf(4, 4096, **dc.STREAM)))
    _assert_job_equals_stacked(ranks[:1], f"one/{backend}", stacked)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def test_group_reads_one_host(runs):
    """Four processes on one machine are one host; the override stands."""
    ranks, _ = runs
    for r in ranks:
        read, override = r["topology"]
        assert read == ExchangeTopology(4, 4) and override == ExchangeTopology(4, 2)


@dataclasses.dataclass
class _Device:
    process_index: int


@dataclasses.dataclass
class _Mesh:
    """What the reference's ``exchange_topology_of`` reads off a mesh."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


@pytest.mark.parametrize("procs", [
    [0] * 8, [0, 0, 0, 0, 1, 1, 1, 1], [0, 0, 1, 1, 2, 2, 3, 3], [0, 1, 2, 3],
    [0, 0, 0, 1, 1, 1], [5, 5, 2, 2, 5, 5, 2, 2], [3]])
@pytest.mark.parametrize("model", [1, 2])
def test_lanes_per_host_rule_matches_reference(procs, model):
    """The port's rule over process ids equals the reference's over a
    duck-typed mesh whose ``data`` axis carries them (with a ``model`` axis
    of 2 beside it, the first column is read)."""
    devs = np.array([[_Device(p) for _ in range(model)] for p in procs], dtype=object)
    mesh = _Mesh(devs, ("data", "model"))
    want = j_exchange_topology_of(mesh).lanes_per_host
    assert lanes_per_host_of(procs) == want
    assert exchange_topology_of(len(procs), lanes_per_host=lanes_per_host_of(procs)) == \
        ExchangeTopology(len(procs), want)
