"""The cases the process-group tests run in each of their spawned ranks.

``tests/test_torch_dist.py`` (four gloo processes on the CPU) and
``tests/test_torch_gpu.py`` (two on the card) spawn :func:`run` once a
rank; it joins the group through a ``file://`` store, runs the cases its
plan names, and saves what it saw to ``rank<r>.pt`` beside the store.  The
tests then compare those files with the stacked transport, the reference
and each other.  This module imports torch and the port only, so a spawned
rank never loads jax.
"""
from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch

W = 4
CAP = 8
# the collectives: name -> (backend, topology or None, REPRO_DISABLE_NATIVE_RAGGED)
EXCHANGES = {
    "dense/4x2": ("dense", (4, 2), False),
    "dense/flat": ("dense", None, False),
    "ragged/4x2": ("ragged", (4, 2), False),
    "ragged/flat": ("ragged", None, False),
    "ragged/4x2/masked": ("ragged", (4, 2), True),
    "ragged/flat/masked": ("ragged", None, True),
    "hierarchical/4x2": ("hierarchical", (4, 2), False),
    "hierarchical/flat": ("hierarchical", None, False),
    "local": ("local", None, False),
}
# tests/test_torch_streaming.py's stream and job, by each driver
CFG = dict(imbalance_trigger=1.1, migration_cost_weight=0.2)
JOB = dict(num_partitions=8, state_capacity=16_384)
STREAM = dict(num_keys=2000, exponent=1.3, drift_every=2, seed=0)
NUM_BATCHES = 5
DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
JOBS = {"dense": None, "ragged": None, "hierarchical": (4, 2)}
# tests/test_torch_least_load.py's W=4 job: a split at batch 1, the
# BackendPolicy's switch to ragged at batch 3, then the unsplit
SPLIT_CFG = dict(imbalance_trigger=1.2, migration_cost_weight=0.2, split_keys_enabled=True,
                 sketch_decay=0.5, split_least_load=True, auto_backend=True,
                 backend_patience=2, backend_cooldown=50)
SPLIT_STREAM = dict(num_keys=2000, exponent=1.3, flip_at=4, seed=0)
INTERVAL_DRIVERS = ("serial", "depth 2")  # the jobs with checkpoint_interval=2
SPAWN_TIMEOUT_S = 300
REFUSALS = ("fault plan", "health policy", "set workers", "quarantine", "evict", "recover")


def exchange_inputs(seed: int = 21, n: int = 24):
    """``(lane, valid, vals, ids)`` for W workers: lane 2 empty, lane 0
    over its capacity on every worker, a tenth of the records invalid, a
    ``[n, 3]`` and a 1-D payload."""
    rng = np.random.default_rng(seed)
    lane = rng.integers(1, W, (W, n))
    lane[lane == 2] = 3
    lane[:, : CAP + 4] = 0
    valid = rng.random((W, n)) < 0.9
    vals = rng.standard_normal((W, n, 3)).astype(np.float32)
    ids = rng.integers(0, 1000, (W, n)).astype(np.int32)
    return (torch.as_tensor(lane, dtype=torch.int32), torch.as_tensor(valid),
            torch.as_tensor(vals), torch.as_tensor(ids))


def exchange_case(spec, backend: str, lane, valid, vals, ids) -> dict:
    """Every output of one exchange, fused, split-phase and into a recycled
    dirty send set, and the backhaul of its received values, as numpy."""
    from repro_torch.exchange import Payload, make_exchange

    ex = make_exchange(spec, backend)
    payloads = [Payload(vals, -1.0), Payload(ids, -7)]
    fused = ex(lane, valid, payloads)
    split = ex.finish(ex.start(lane, valid, payloads))
    w = lane.shape[0]
    shape = (w, spec.num_lanes, spec.capacity)
    dirty = (torch.ones(shape, dtype=torch.bool), (torch.full(shape + (3,), 5.5),
                                                   torch.full(shape, 99, dtype=torch.int32)))
    recycled = ex.finish(ex.start(lane, valid, payloads, buffers=dirty))
    out = {}
    for tag, r in (("fused", fused), ("split", split), ("recycled", recycled)):
        va, (v, i) = r.unpack()
        out[f"{tag}/valid"], out[f"{tag}/vals"], out[f"{tag}/ids"] = va, v, i
    for k in ("recv_counts", "lane_counts", "shipped_rows", "shipped_rows_by_class"):
        x = getattr(fused, k)
        if x is not None:
            out[k] = x
    out["overflow"] = fused.send.overflow
    out["lane_overflow"] = fused.send.lane_overflow
    if spec.axis is not None:
        rows, shipped, occupied = ex.backhaul(fused.payloads[0], forward=fused)
        out["backhaul/rows"], out["backhaul/shipped"], out["backhaul/occupied"] = (
            rows, shipped, occupied)
    if backend == "hierarchical":
        out["ships"] = torch.tensor([[ex.backend.two_hop_ships, ex.backend.flat_ships]])
    return {k: v.numpy() for k, v in out.items()}


def exchange_spec(name: str, group=None):
    from repro_torch.exchange import ExchangeSpec, ExchangeTopology

    backend, topo, _ = EXCHANGES[name]
    return ExchangeSpec(W, CAP, axis=None if backend == "local" else "data",
                        topology=None if topo is None else ExchangeTopology(*topo),
                        group=group)


def feed(job, driver: str, batches) -> list:
    """Run ``batches`` as the tests' drivers do: depth 1 batch by batch
    through ``process_batch``, the others through ``run``."""
    if driver == "depth 1":
        for b in batches:
            job.process_batch(b)
    else:
        job.run(batches)
    return job.metrics


def two_worker_snapshot(batches) -> dict:
    """The snapshot of a stacked two-worker job after ``batches[:2]``."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob

    job = StreamingJob(device="cpu", num_workers=2, dr=DRConfig(**CFG, overlap_exchange=False),
                       **JOB)
    job.run(batches[:2])
    return job.snapshot()


def _masked(flag: bool):
    if flag:
        os.environ["REPRO_DISABLE_NATIVE_RAGGED"] = "1"
    else:
        os.environ.pop("REPRO_DISABLE_NATIVE_RAGGED", None)


def _job_record(job) -> dict:
    """Metrics, the gathered final state and this rank's decision log."""
    return dict(
        metrics=[dataclasses.asdict(m) for m in job.metrics],
        keys=job.state_keys.cpu().numpy(), vals=job.state_vals.cpu().numpy(),
        decisions=[(d.tick, d.kind, d.taken, d.reason, d.imbalance, sorted(d.detail.items()))
                   for d in job.drm.decisions.records])


def _backend_cases(g, out) -> None:
    lane, valid, vals, ids = exchange_inputs()
    r = slice(g.rank, g.rank + 1)
    for name, (_, _, masked) in EXCHANGES.items():
        _masked(masked)
        before = dict(g.traffic)
        out[f"exchange/{name}"] = exchange_case(exchange_spec(name, g), EXCHANGES[name][0],
                                                lane[r], valid[r], vals[r], ids[r])
        out[f"traffic/{name}"] = {k: g.traffic[k] - before[k] for k in g.traffic}
    _masked(False)
    # the fused call alone, for the bytes each ragged ship hands the group
    from repro_torch.exchange import Payload, make_exchange
    for name in ("ragged/flat", "ragged/flat/masked"):
        _masked(EXCHANGES[name][2])
        ex = make_exchange(exchange_spec(name, g), "ragged")
        before = dict(g.traffic)
        res = ex(lane[r], valid[r], [Payload(vals[r], -1.0), Payload(ids[r], -7)])
        out[f"fused traffic/{name}"] = {k: g.traffic[k] - before[k] for k in g.traffic}
        out[f"fused counts/{name}"] = res.lane_counts.numpy()
    _masked(False)
    try:
        exchange_spec("dense/flat", g).resized(num_lanes=W - 1)
    except ValueError as e:
        out["lanes refused"] = str(e)


def _job_cases(g, out, device) -> None:
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf
    from repro_torch.exchange import ExchangeTopology

    batches = list(drifting_zipf(NUM_BATCHES, 4096, **STREAM))
    for backend, topo in JOBS.items():
        for driver, extra in DRIVERS.items():
            _masked(False)
            job = StreamingJob(group=g, device=device, dr=DRConfig(**CFG, **extra),
                               exchange_backend=backend, **JOB,
                               topology=None if topo is None else ExchangeTopology(*topo))
            feed(job, driver, batches)
            out[f"job/{backend}/{driver}"] = _job_record(job)


def _extra_cases(g, out, device) -> None:
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf, hotspot_flip
    from repro_torch.exchange import FaultPlan, FaultyBackend
    from repro_torch.launch.mesh import exchange_topology_of

    batches = list(hotspot_flip(10, 4096, **SPLIT_STREAM))
    for driver, extra in DRIVERS.items():
        job = StreamingJob(group=g, device=device, dr=DRConfig(**SPLIT_CFG, **extra), **JOB)
        feed(job, driver, batches)
        out[f"split/{driver}"] = _job_record(job)
    batches = list(drifting_zipf(NUM_BATCHES, 4096, **STREAM))
    for driver in ("serial", "depth 1"):
        job = StreamingJob(group=g, device=device, dr=DRConfig(**CFG, **DRIVERS[driver]), **JOB)
        feed(job, driver, batches[:2])
        job.resize(16)
        feed(job, driver, batches[2:])
        out[f"resize/{driver}"] = _job_record(job)
    # a safe point every second batch: the ticks between decide nothing
    for driver in INTERVAL_DRIVERS:
        job = StreamingJob(group=g, device=device, checkpoint_interval=2,
                           dr=DRConfig(**CFG, **DRIVERS[driver]), **JOB)
        feed(job, driver, batches)
        out[f"interval 2/{driver}"] = _job_record(job)
    # restores: the group's own snapshot onto a new group job, and a
    # stacked two-worker snapshot re-folded onto the four ranks
    job = StreamingJob(group=g, device=device, dr=DRConfig(**CFG, overlap_exchange=False),
                       **JOB)
    feed(job, "serial", batches[:2])
    for name, snap in (("own", job.snapshot()), ("from W=2", two_worker_snapshot(batches))):
        job = StreamingJob(group=g, device=device, dr=DRConfig(**CFG), **JOB)
        job.restore(snap)
        feed(job, "depth 1", batches[2:])
        out[f"restore/{name}"] = _job_record(job)
    # the refusals: each raises NotImplementedError on every rank
    refused = {}
    make = dict(group=g, device=device, **JOB)
    for kind in REFUSALS:
        try:
            if kind == "fault plan":
                StreamingJob(exchange_backend=FaultyBackend("dense", FaultPlan()), **make)
            elif kind == "health policy":
                StreamingJob(dr=DRConfig(health_enabled=True), **make)
            else:
                job = StreamingJob(**make)
                {"set workers": lambda: job._set_workers(W - 1),
                 "quarantine": lambda: job._apply_lane_removal(1, park=True),
                 "evict": lambda: job._apply_lane_removal(1, park=False),
                 "recover": job._apply_recover}[kind]()
            refused[kind] = None
        except NotImplementedError as e:
            refused[kind] = str(e)
    out["refused"] = refused
    # rank 0 decides on another trigger: the digest check stops every rank
    trigger = 1.1 if g.rank == 0 else 100.0
    job = StreamingJob(group=g, device=device,
                       dr=DRConfig(imbalance_trigger=trigger, overlap_exchange=False), **JOB)
    try:
        job.process_batch(batches[0])
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    out["topology"] = (exchange_topology_of(group=g),
                       exchange_topology_of(group=g, lanes_per_host=2))


def _one_rank_cases(store: str, out, device) -> None:
    """A world of one: rank 0 alone, after the others have left."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf
    from repro_torch.exchange.dist import WorkerGroup

    g = WorkerGroup.init(backend="gloo", rank=0, world_size=1,
                         init_method=f"file://{store}.one", device=device)
    batches = list(drifting_zipf(4, 4096, **STREAM))
    for backend in ("dense", "ragged"):
        job = StreamingJob(group=g, device=device, exchange_backend=backend,
                           dr=DRConfig(**CFG, overlap_exchange=False), **JOB)
        feed(job, "serial", batches)
        out[f"one/{backend}"] = _job_record(job)
    g.close()


def run(rank: int, world: int, store: str, plan: dict) -> None:
    """One rank: join the gloo group through ``store``, run the sections
    ``plan["sections"]`` names (``backends``, ``jobs``, ``extras``,
    ``one rank``) on ``plan["device"]``, and save the results beside the
    store.  Any failure raises, and the spawning parent re-raises it."""
    torch.set_num_threads(1)
    from repro_torch.exchange.dist import WorkerGroup

    device = plan.get("device", "cpu")
    g = WorkerGroup.init(backend="gloo", rank=rank, world_size=world,
                         init_method=f"file://{store}", device=device)
    out: dict = {"rank": rank}
    sections = plan["sections"]
    if "backends" in sections:
        _backend_cases(g, out)
    if "jobs" in sections:
        _job_cases(g, out, device)
    if "extras" in sections:
        _extra_cases(g, out, device)
    if "gpu job" in sections:
        from repro_torch.core.drm import DRConfig
        from repro_torch.core.streaming import StreamingJob
        from repro_torch.data.generators import drifting_zipf
        for driver in ("serial", "depth 2"):
            job = StreamingJob(group=g, dr=DRConfig(**CFG, **DRIVERS[driver]), **JOB)
            feed(job, driver, list(drifting_zipf(NUM_BATCHES, 16_384, **STREAM)))
            out[f"gpu/{driver}"] = _job_record(job)
    g.close()
    if "one rank" in sections and rank == 0:
        _one_rank_cases(store, out, device)
    torch.save(out, Path(store).parent / f"rank{rank}.pt")


def spawn(d: Path, world: int, plan: dict, timeout_s: float = SPAWN_TIMEOUT_S,
          target=run) -> list:
    """Spawn ``world`` ranks of ``target(rank, world, store, plan)`` (default
    :func:`run`) with their store in ``d``, wait for them (a rank that
    raises makes this raise) and return their saved results, in rank
    order."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(target, args=(world, str(d / "store"), plan), nprocs=world,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
