#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one CUDA card (an H100 is the
target).  Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the card's name and power
   limit and the CUDA toolkit version.
2. The full-size DR loop: ``StreamingJob`` on 8 stacked workers, 32
   partitions, 8 x 262,144 state rows, over 8 drifting-Zipf batches of
   4 Mi records; asserts zero overflow, at least one repartition that
   lowers the mean imbalance, exact counts of 64 sampled keys, and that
   both kernels were launched by that run.
3. Each kernel against its plain PyTorch version on the card, on inputs
   from phase 2 (split replicas on and off, invalid sentinel records, an
   empty heavy table, a capacity that overflows): every output must be
   equal exactly.
4. The phase-2 configuration on a small stream, on the card and on the
   CPU: identical per-batch metrics and final state.
5. Times: each kernel and its plain version (CUDA events, median of 20
   after 3 warm-ups) beside the kernel's byte bound; the median wall per
   batch and the device time of one state merge.
6. The batch path at the paper's size (Fig. 4, as
   ``benchmarks/bench_spark_like.py`` records it): 10,000,000-record Zipf
   jobs over 1,000,000 keys, 35 partitions, exponents 1.0 to 2.0, a 10%
   prefix sample and ``DRConfig(mode="batch", lam=4.0, eps=0.003)``.  Each
   ``BatchJob`` on the card must equal the same job on the CPU in every
   field and the host ``Partitioner.lookup_np``; the replayed buffer is
   bucketized into its 35 partitions without a slot (zero overflow, every
   record exactly once); ``ops.count_sketch`` at widths 2048 and 8192 must
   equal the host ``CountMinSketch`` (a check: no entry point of either
   package calls the sketch, so its launches there are counted apart and
   its path count is 0).  ``partition_apply`` and ``dispatch_count`` must
   have been launched by that run.
7. Each batch kernel against its plain version on the card (heavy tables
   full, empty and hit by sentinel keys, 35 stacked rows; out-of-range and
   invalid destinations, 1 to 1024 parts; sketch widths 1000 to 8192,
   depths 1 to 8, invalid records): every output equal exactly.
8. Times of the batch kernels at phase 6's shapes (exponent 1.2), as in
   phase 5, and the median ``BatchJob.run`` wall per job, split into the
   host planning, the upload and the device passes.
9. Serving at gemma-2b's full published width and depth (18 layers, bf16
   parameters and compute, random weights from a seeded generator on the
   card): 32 requests with the traffic of the reference launcher
   (``src/repro/launch/serve.py``: session 7 with probability 0.3, else
   uniform over [0, 1000)), prompts of 256-2048 tokens, 16 new tokens,
   routed by ``DRScheduler.route`` to 4 replicas, each a 4-slot
   ``ServeEngine`` with ``max_len`` 2064, then ``checkpoint``.  Asserts 16
   tokens in the vocabulary for every request, finite logits, one
   flash-kernel launch per layer per prefill (576) and the checkpoint's
   schema.
10. The flash kernel against its plain version on the card: gemma-2b's
    prefill shapes (G = 1, P = 8, hd = 256, Sq = Sk in 1, 100, 512, 2048)
    and hd 16, 64, 128, 192 with G > 1, P in 1, 2; causal, non-causal and
    window 96; in both ``p_bf16`` modes.  float32 within 2e-5, bf16 within
    2e-2 and, with ``p_bf16=False``, 8e-3; ``p_bf16=True`` rounds the
    weights to bf16 in both versions, so 2e-2 for float32 inputs too.  And
    float32 weights through the bf16 tensor cores keep float32 precision:
    the bf16 outputs lie within half an ulp plus 2e-4 of the float32 plain
    version on the same inputs, where the plain version with bf16 weights
    (the control, which must fail that limit) does not.
11. The card against the CPU: gemma-2b at full width but depth 2 in
    float32 (TF32 off), both from the same CPU-initialised weights; four
    prompts of 128-256 tokens, 8 teacher-forced steps: logits within 1e-3,
    greedy tokens equal wherever the CPU's top-two margin exceeds 1e-2.
12. Times: the bf16 flash kernel (tensor cores) at gemma-2b's prefill
    shapes (Sq 512, 1024, 2048, causal), in both ``p_bf16`` modes, beside
    its bound, its plain version and ``scaled_dot_product_attention`` on
    the same inputs (k, v expanded to the 8 heads; timed only): each with
    CUDA events around one call (the ``ms`` of every kernel), and the
    kernel and SDPA also as device time over 20 calls (``torch.profiler``,
    no host time in it); the float32 kernel at 2048; the prefill wall at
    those lengths and the kernel's share of it; a profile of a 1024-token
    prefill and of 8 decode steps;
    phase 9's median prefill wall per request, decode wall per token and
    tokens per second.

The last two lines of standard output are the ``kernels`` JSON line and
the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (at the 700 W limit)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor cores; f32
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCE = "src/repro_torch/kernels/csrc/route_kernels.cu"
BATCH_SOURCE = "src/repro_torch/kernels/csrc/batch_kernels.cu"
REPLACES = {
    "route_bucketize": "src/repro/kernels/route_bucketize.py:155",
    "lookup_dispatch": "src/repro/kernels/lookup_dispatch.py:136",
    "partition_apply": "src/repro/kernels/partition_apply.py:72",
    "dispatch_count": "src/repro/kernels/dispatch_count.py:60",
    "sketch_update": "src/repro/kernels/sketch_update.py:50",
    "flash_attention": "src/repro/kernels/flash_attention.py:73",
}
# phase 6: the paper's Fig. 4 batch jobs (benchmarks/bench_spark_like.py)
BATCH_RECORDS = 10_000_000
BATCH_KEYS = 1_000_000
BATCH_PARTS = 35
EXPONENTS = (1.0, 1.2, 1.4, 1.6, 1.8, 2.0)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, *, warmup=3, reps=20) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, *, n=20) -> float:
    """Device time of ``fn()`` in ms: the summed durations of the card's
    kernels, copies and memsets over ``n`` calls (``torch.profiler``)
    divided by ``n``, after a warm-up; the host's launch time is not in
    it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert events, "the profiler saw no device activity"
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / n


def excess_over_bf16_rounding(got, ref) -> float:
    """The most by which bf16 ``got`` lies farther from the float32 ``ref``
    than half a bf16 ulp (the output's own rounding): what the computation
    before the final rounding got wrong, in absolute terms."""
    got = got.float()
    _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
    half_ulp = torch.ldexp(torch.ones_like(ref), e - 9)  # bf16 keeps 8 significant bits
    return float(((got - ref).abs() - half_ulp).max())


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.dtype}{list(g.shape)} vs {w.dtype}{list(w.shape)}")
        if g.numel():
            err = max(err, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
    return err


def route_bytes(keys, vals, tables, num_lanes, capacity=None, split=False) -> int:
    """Bytes the function must move: each input read once, each output
    written once (every send-buffer cell, fills included)."""
    w, n = keys.shape
    b = tables[0].numel()
    nbytes = w * n * (4 + 1)                       # keys, valid
    nbytes += b * 4 * (3 if split else 2) + tables[2].numel() * 4
    nbytes += w * n * 8 + w * num_lanes * 4        # part, slot, counts
    if capacity is not None:
        dim = vals.shape[2]
        nbytes += w * n * 4 * dim                  # vals
        nbytes += w * num_lanes * capacity * (1 + 4 + 4 + 4 * dim)
    return nbytes


def kernel_rows(timing, source, launches, errs, equal, *, phase, path_phase) -> list[dict]:
    """The ``kernels`` line's entries: ``timing[name] = (ms, plain_ms,
    bytes)``; no single PyTorch call computes any of these functions, so
    ``library_ms`` is null."""
    rows = []
    for name, (k_ms, p_ms, nbytes) in timing.items():
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "equal": all(equal[name]),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bytes": nbytes, "library_ms": None,
        })
        log(f"phase {phase}: {name}: {k_ms:.4f} ms (bound {bound_ms:.4f} ms from {nbytes} "
            f"bytes, plain {p_ms:.4f} ms); launches in phase {path_phase}: {launches[name]}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.hashing import KEY_SENTINEL
    from repro_torch.core.partitioner import uniform_partitioner
    from repro_torch.core.state import merge_into
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch, lookup_dispatch_plain
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sent = int(KEY_SENTINEL)

    # ---- phase 1: build and describe -----------------------------------
    t = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t
    card = card_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    built = ", ".join(p.name for p in build.sources())
    log(f"phase 1: built {built} in {build_s:.2f} s; card {card}; "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; {nvcc}")

    # ---- phase 2: the full-size DR loop --------------------------------
    dr = DRConfig(imbalance_trigger=1.2, migration_cost_weight=0.2)
    job_kw = dict(num_workers=8, num_partitions=32, state_capacity=262_144,
                  capacity_factor=2.0, dr=dr)
    t = time.perf_counter()
    batches = list(drifting_zipf(8, 4_194_304, num_keys=1_000_000, exponent=1.3,
                                 drift_every=3, drift_fraction=0.3, seed=0))
    log(f"phase 2: generated 8 x 4,194,304 keys in {time.perf_counter() - t:.1f} s")
    job = StreamingJob(device="cuda", **job_kw)
    route_bucketize.launches = 0
    lookup_dispatch.launches = 0
    walls = []
    for b in batches:
        t = time.perf_counter()
        m = job.process_batch(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        log(f"  batch {m.batch}: imbalance {m.imbalance:.4f} worker {m.worker_imbalance:.4f} "
            f"{m.action} rel_mig {m.relative_migration:.4f} overflow {m.overflow} "
            f"state_rows {m.state_rows} shipped {m.shipped_rows} wall {walls[-1]:.3f} s")
    launches = {"route_bucketize": route_bucketize.launches,
                "lookup_dispatch": lookup_dispatch.launches}
    ms = job.metrics
    assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
    reps = [i for i, m in enumerate(ms) if m.repartitioned]
    assert reps, "no repartition was taken"
    before = np.mean([m.imbalance for m in ms[: reps[0] + 1]])
    after = np.mean([m.imbalance for m in ms[reps[0] + 1:]])
    assert after < before, (before, after)
    all_keys = torch.as_tensor(np.concatenate(batches), device=dev)
    uniq, counts = torch.unique(all_keys, return_counts=True)
    assert int(counts.max()) < 2**24
    rng = np.random.default_rng(0)
    pick = np.concatenate([[int(torch.argmax(counts))],
                           rng.choice(len(uniq), 63, replace=False)])
    for i in pick:
        key, want = int(uniq[i]), float(counts[i])
        got = job.state_count(key)
        assert got == want, (key, got, want)
    assert all(v > 0 for v in launches.values()), launches
    log(f"phase 2: repartitions at batches {reps}; mean imbalance {before:.4f} -> "
        f"{after:.4f}; 64 exact counts; launches {launches}")

    # ---- phase 3: each kernel against its plain version ----------------
    part = job.drm.partitioner
    w = job.num_workers
    keys = torch.as_tensor(batches[-1].astype(np.int32), device=dev).reshape(w, -1)
    valid = keys != sent
    vals = torch.ones(keys.shape + (1,), dtype=torch.float32, device=dev)
    cap = job._shuffle_spec.capacity
    state_keys = job.state_keys.clone()
    state_valid = state_keys != sent
    top = int(uniq[pick[0]])
    split = part.with_splits({top: 4})
    empty = uniform_partitioner(job.num_partitions, part.num_hosts, part.seed)

    def padded(p, *, n_part, pad_empty):
        return ops.pad_heavy_tables(p.tables(dev), num_partitions=n_part, pad_empty=pad_empty)

    equal = {"route_bucketize": [], "lookup_dispatch": []}
    errs = {"route_bucketize": 0.0, "lookup_dispatch": 0.0}
    # the same keys with a seeded tenth turned into invalid sentinel records
    gen = torch.Generator(device=dev).manual_seed(0)
    holes = torch.rand(keys.shape, generator=gen, device=dev) < 0.1
    keys_holed = keys.masked_fill(holes, sent)
    valid_holed = keys_holed != sent
    rb_cases = [
        ("main path, splits on", part, 32, cap, True, keys, valid),
        ("splits off", part, 0, cap, True, keys, valid),
        ("split key x4", split, 32, cap, True, keys, valid),
        ("invalid sentinel records", split, 32, cap, True, keys_holed, valid_holed),
        ("empty heavy table, tile padded", empty, 32, cap, True, keys, valid),
        ("empty heavy table, unpadded", empty, 0, cap, False, keys, valid),
        ("capacity overflow", split, 32, 4096, True, keys, valid),
    ]
    for name, p, n_part, c, pad_empty, k, v in rb_cases:
        hk, hp, hr = padded(p, n_part=n_part, pad_empty=pad_empty)
        args = (k, v, vals, hk, hp, p.tables(dev).host_to_part, hr)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=w, capacity=c,
                  key_fill=sent, num_partitions=n_part)
        got = route_bucketize(*args, **kw)
        want = route_bucketize_plain(*args, **kw)
        torch.cuda.synchronize()
        ok = all(torch.equal(g, x) for g, x in zip(got, want))
        errs["route_bucketize"] = max(errs["route_bucketize"], max_abs_err(got, want))
        equal["route_bucketize"].append(ok)
        dropped = int((got[2] - c).clamp(min=0).sum())
        log(f"phase 3: route_bucketize [{name}] B={hk.numel()} cap={c} "
            f"invalid={int((~v).sum())} dropped={dropped} equal={ok}")
    ld_cases = [
        ("migrate path (final state)", part, 0, state_keys, state_valid),
        ("split key x4", split, 32, state_keys, state_valid),
        ("empty heavy table", empty, 0, keys, valid),
    ]
    for name, p, n_part, k, v in ld_cases:
        hk, hp, hr = padded(p, n_part=n_part, pad_empty=False)
        args = (k, v, hk, hp, p.tables(dev).host_to_part, hr)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=w, num_partitions=n_part)
        got = lookup_dispatch(*args, **kw)
        want = lookup_dispatch_plain(*args, **kw)
        torch.cuda.synchronize()
        ok = all(torch.equal(g, x) for g, x in zip(got, want))
        errs["lookup_dispatch"] = max(errs["lookup_dispatch"], max_abs_err(got, want))
        equal["lookup_dispatch"].append(ok)
        log(f"phase 3: lookup_dispatch [{name}] B={hk.numel()} n={k.shape[1]} equal={ok}")
    assert all(all(v) for v in equal.values()), equal

    # ---- phase 4: card against CPU -------------------------------------
    small = list(drifting_zipf(6, 65_536, num_keys=50_000, exponent=1.3,
                               drift_every=2, seed=1))
    runs = {}
    for device in ("cuda", "cpu"):
        j = StreamingJob(device=device, **job_kw)
        j.run(small)
        runs[device] = j
    skip = {"wall_time_s", "exchange_wall_s"}
    for a, b in zip(runs["cuda"].metrics, runs["cpu"].metrics):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        diff = {k: (da[k], db[k]) for k in da if k not in skip and da[k] != db[k]}
        assert not diff, (a.batch, diff)
    for name in ("state_keys", "state_vals"):
        assert torch.equal(getattr(runs["cuda"], name).cpu(), getattr(runs["cpu"], name)), name
    log(f"phase 4: card and CPU trajectories identical over {len(small)} batches "
        f"(repartitions {sum(m.repartitioned for m in runs['cpu'].metrics)}), state equal")

    # ---- phase 5: times --------------------------------------------------
    hk, hp, hr = padded(part, n_part=32, pad_empty=True)
    h2p = part.tables(dev).host_to_part
    rb_args = (keys, valid, vals, hk, hp, h2p, hr)
    rb_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, capacity=cap,
                 key_fill=sent, num_partitions=32)
    lk, lp, _ = padded(part, n_part=0, pad_empty=False)
    ld_args = (state_keys, state_valid, lk, lp, h2p, None)
    ld_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, num_partitions=0)
    timing = {
        "route_bucketize": (
            cuda_ms(lambda: route_bucketize(*rb_args, **rb_kw)),
            cuda_ms(lambda: route_bucketize_plain(*rb_args, **rb_kw)),
            route_bytes(keys, vals, (hk, hp, h2p), w, cap, split=True)),
        "lookup_dispatch": (
            cuda_ms(lambda: lookup_dispatch(*ld_args, **ld_kw)),
            cuda_ms(lambda: lookup_dispatch_plain(*ld_args, **ld_kw)),
            route_bytes(state_keys, None, (lk, lp, h2p), w)),
    }
    res = job._shuffle(part.tables(dev), keys, vals, valid)
    merge_ms = cuda_ms(lambda: merge_into(job.state_keys, job.state_vals, res.keys,
                                          res.values, res.valid), warmup=1, reps=5)
    wall_ms = statistics.median(walls) * 1e3
    kernels = kernel_rows(timing, SOURCE, launches, errs, equal, phase=5, path_phase=2)
    log(f"phase 5: median wall per batch {wall_ms:.1f} ms; state merge {merge_ms:.3f} ms "
        f"on the device; card {card}")
    del job, runs, res, batches, all_keys
    torch.cuda.empty_cache()

    kernels += batch_phases(dev, sent)
    torch.cuda.empty_cache()
    kernels += serve_phases(dev, card)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def batch_phases(dev, sent) -> list[dict]:
    """Phases 6-8: the batch replay path and its three kernels."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.histogram import CountMinSketch, Histogram
    from repro_torch.core.partitioner import kip_update, uniform_partitioner
    from repro_torch.core.replay import BatchJob, replay_partition
    from repro_torch.data.generators import zipf_keys
    from repro_torch.exchange import ExchangeSpec, Payload, make_exchange
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
    from repro_torch.kernels.partition_apply import partition_apply, partition_apply_plain
    from repro_torch.kernels.sketch_update import sketch_update, sketch_update_plain

    names = ("partition_apply", "dispatch_count", "sketch_update")
    dr = DRConfig(mode="batch", lam=4.0, eps=0.003)

    # ---- phase 6: the batch path at the paper's size -------------------
    jobs, run_walls = {}, []
    partition_apply.launches = dispatch_count.launches = sketch_update.launches = 0
    sketch_checks = 0
    for e in EXPONENTS:
        keys = zipf_keys(BATCH_RECORDS, num_keys=BATCH_KEYS, exponent=e, seed=int(e * 10))
        t = time.perf_counter()
        got = BatchJob(BATCH_PARTS, dr=dr, device=dev).run(keys)
        torch.cuda.synchronize()
        run_walls.append(time.perf_counter() - t)
        want = BatchJob(BATCH_PARTS, dr=dr, device="cpu").run(keys)
        assert (got.imbalance_before, got.imbalance_after, got.replayed_records,
                got.sample_fraction) == (want.imbalance_before, want.imbalance_after,
                                         want.replayed_records, want.sample_fraction), e
        gp, wp = got.partitioner, want.partitioner
        assert (gp.num_partitions, gp.seed, gp.heavy_repl) == (wp.num_partitions, wp.seed,
                                                               wp.heavy_repl), e
        for tab in ("heavy_keys", "heavy_parts", "host_to_part"):
            assert np.array_equal(getattr(gp, tab), getattr(wp, tab)), (e, tab)
        assign = got.assignments
        assert assign.device.type == dev.type and assign.dtype == torch.int32
        assert torch.equal(assign.cpu(), want.assignments), e
        assert np.array_equal(assign.cpu().numpy(), gp.lookup_np(keys)), e
        assert got.imbalance_after <= got.imbalance_before, e

        # the shuffle reads the replayed buffer: bucketize it, no slot given
        dkeys = torch.as_tensor(keys.astype(np.int32), device=dev)
        loads = torch.bincount(assign, minlength=BATCH_PARTS)
        cap = int(loads.max())
        valid = torch.ones((1, BATCH_RECORDS), dtype=torch.bool, device=dev)
        res = make_exchange(ExchangeSpec(num_lanes=BATCH_PARTS, capacity=cap)).bucketize(
            assign[None], valid, [Payload(dkeys[None], sent)])
        assert int(res.send.overflow.sum()) == 0 and bool(res.send.ok.all())
        assert int(res.valid.sum()) == BATCH_RECORDS
        cell_keys = res.payloads[0][0][assign.long(), res.send.slot[0].long()]
        assert torch.equal(cell_keys, dkeys), e       # every record in its own cell
        assert torch.equal(res.valid[0].sum(dim=1), loads), e

        # count-min sketches of the job's keys: a check, not the path (no
        # entry point of either package calls count_sketch), so their
        # launches are counted apart
        sketch_max = 0.0
        path_sketches = sketch_update.launches
        for width in (2048, 8192):
            sk = ops.count_sketch(dkeys, depth=4, width=width)
            cms = CountMinSketch(4, width)
            cms.update(keys)
            sketch_max = max(sketch_max, float(sk.max()))
            assert sketch_max < 2**24
            assert np.array_equal(sk.cpu().numpy().astype(np.float64), cms.table), (e, width)
        sketch_checks += sketch_update.launches - path_sketches
        sketch_update.launches = path_sketches
        jobs[e] = (keys, got)
        log(f"phase 6: exponent {e}: imbalance {got.imbalance_before:.4f} -> "
            f"{got.imbalance_after:.4f}, replayed {got.replayed_records}, heavy keys "
            f"{gp.num_heavy}, largest partition {cap}, largest sketch cell {sketch_max:.0f}; "
            f"card == CPU == lookup_np; bucketize overflow 0; sketches == CountMinSketch; "
            f"run wall {run_walls[-1]:.3f} s")
    launches = {"partition_apply": partition_apply.launches,
                "dispatch_count": dispatch_count.launches,
                "sketch_update": sketch_update.launches}
    assert launches["partition_apply"] > 0 and launches["dispatch_count"] > 0, launches
    assert sketch_checks == 2 * len(EXPONENTS), sketch_checks
    assert jobs[1.2][1].imbalance_after < jobs[1.2][1].imbalance_before
    log(f"phase 6: {len(EXPONENTS)} jobs of {BATCH_RECORDS:,} records; launches on the path "
        f"{launches}; sketch_update in the sketch checks {sketch_checks}")

    # ---- phase 7: each batch kernel against its plain version ----------
    keys, job = jobs[1.2]
    dkeys = torch.as_tensor(keys.astype(np.int32), device=dev)
    assign = job.assignments
    kip = job.partitioner
    uhp = uniform_partitioner(BATCH_PARTS)
    gen = torch.Generator(device=dev).manual_seed(0)
    holes = torch.rand(dkeys.shape, generator=gen, device=dev) < 0.1
    rows = BATCH_PARTS * (BATCH_RECORDS // BATCH_PARTS)
    equal = {n: [] for n in names}
    errs = {n: 0.0 for n in names}

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        errs[name] = max(errs[name], max_abs_err(got, want))
        equal[name].append(ok)
        log(f"phase 7: {name} [{label}] equal={ok}")

    for label, p, k in [("KIP table", kip, dkeys), ("empty heavy table", uhp, dkeys),
                        ("10% sentinel keys", kip, dkeys.masked_fill(holes, sent)),
                        ("35 stacked rows", kip, dkeys[:rows].view(BATCH_PARTS, -1))]:
        hk, hp, _ = ops.pad_heavy_tables(p.tables(dev), num_partitions=0, pad_empty=False)
        args = (k, hk, hp, p.tables(dev).host_to_part)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts)
        hold("partition_apply", f"{label}, B={hk.numel()}", partition_apply(*args, **kw),
             partition_apply_plain(*args, **kw))
    ones = torch.ones_like(dkeys, dtype=torch.bool)
    wild = assign.clone()
    wild[holes] = torch.where(dkeys[holes] % 2 == 0, -3, BATCH_PARTS + 5).to(torch.int32)
    some = ~(torch.rand(dkeys.shape, generator=gen, device=dev) < 0.2)
    for label, d, v, n in [
            ("replay assignments", assign, ones, BATCH_PARTS),
            ("out-of-range destinations", wild, ones, BATCH_PARTS),
            ("out-of-range + invalid", wild, some, BATCH_PARTS),
            ("1 part", (dkeys % 3 - 1).to(torch.int32), some, 1),
            ("1024 parts", (dkeys % 1030 - 2).to(torch.int32), some, 1024),
            ("35 stacked rows", wild[:rows].view(BATCH_PARTS, -1),
             some[:rows].view(BATCH_PARTS, -1), BATCH_PARTS)]:
        hold("dispatch_count", label, dispatch_count(d, v, num_parts=n),
             dispatch_count_plain(d, v, num_parts=n))
    for depth, width, v in [(4, 2048, ones), (4, 8192, ones), (8, 8192, some),
                            (1, 1000, some), (8, 1000, ones), (8, 2048, some)]:
        got = sketch_update(dkeys, v, depth=depth, width=width)
        assert float(got.max()) < 2**24
        hold("sketch_update", f"depth {depth}, width {width}, invalid {int((~v).sum())}",
             got, sketch_update_plain(dkeys, v, depth=depth, width=width))
    assert all(all(v) for v in equal.values()), equal

    # ---- phase 8: times ------------------------------------------------
    hk, hp, _ = ops.pad_heavy_tables(kip.tables(dev), num_partitions=0, pad_empty=False)
    h2p = kip.tables(dev).host_to_part
    pa_args, pa_kw = (dkeys, hk, hp, h2p), dict(seed=kip.seed, num_hosts=kip.num_hosts)
    n = BATCH_RECORDS
    timing = {
        "partition_apply": (
            cuda_ms(lambda: partition_apply(*pa_args, **pa_kw)),
            cuda_ms(lambda: partition_apply_plain(*pa_args, **pa_kw)),
            n * (4 + 4) + (hk.numel() + hp.numel() + h2p.numel()) * 4),
        "dispatch_count": (
            cuda_ms(lambda: dispatch_count(assign, ones, num_parts=BATCH_PARTS)),
            cuda_ms(lambda: dispatch_count_plain(assign, ones, num_parts=BATCH_PARTS)),
            n * (4 + 1 + 4) + BATCH_PARTS * 4),
        "sketch_update": (
            cuda_ms(lambda: sketch_update(dkeys, ones, depth=4, width=2048)),
            cuda_ms(lambda: sketch_update_plain(dkeys, ones, depth=4, width=2048)),
            n * (4 + 1) + 4 * 2048 * 4),
    }
    kernels = kernel_rows(timing, BATCH_SOURCE, launches, errs, equal, phase=8, path_phase=6)

    # one job's wall, split: host planning, upload, device passes (exponent 1.2)
    plan, upload, passes = [], [], []
    for _ in range(5):
        t = time.perf_counter()
        u = uniform_partitioner(BATCH_PARTS)
        hist = Histogram.exact(keys[: int(0.1 * n)]).top(int(dr.lam * BATCH_PARTS))
        k = kip_update(u, hist, eps=dr.eps)
        t1 = time.perf_counter()
        buf = torch.as_tensor(keys.astype(np.int32), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p in (u, k):
            torch.bincount(replay_partition(p, buf), minlength=BATCH_PARTS).cpu()
        t3 = time.perf_counter()
        plan.append(t1 - t)
        upload.append(t2 - t1)
        passes.append(t3 - t2)
    log(f"phase 8: BatchJob.run median wall per job {statistics.median(run_walls) * 1e3:.1f} ms "
        f"over {len(EXPONENTS)} exponents; at exponent 1.2: host planning (prefix histogram "
        f"+ kip_update) {statistics.median(plan) * 1e3:.1f} ms, upload (int32 cast + copy) "
        f"{statistics.median(upload) * 1e3:.1f} ms, device passes (2 x partition_apply + "
        f"load counts) {statistics.median(passes) * 1e3:.2f} ms (medians of 5)")
    return kernels


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def causal_flash_cost(g, p, s, hd, dtype):
    """(bytes, FLOPs) causal flash attention over Sq = Sk = s needs: q, k,
    v read once and the output written once; 4*hd FLOPs per visible (q, k)
    pair, s(s+1)/2 of them."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * g * p * s * hd + 2 * g * s * hd) * size
    return nbytes, 4 * g * p * hd * (s * (s + 1) // 2)


def profile_serving(model, params, cfg, pol, rng, dev, max_len) -> None:
    """Device time by kernel (``torch.profiler``) of one 1024-token prefill
    and of 8 decode steps, beside the same work's wall clock unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1024)), device=dev)
    one = torch.zeros((1, 1), dtype=torch.int64, device=dev)

    def prefill(_=None):
        return model.prefill(params, {"tokens": toks}, cfg, pol, max_len=max_len)[1]

    def decode(cache):
        for _ in range(8):
            model.decode_step(params, cache, one, cfg, pol)

    cases = {"prefill of 1024 tokens": (lambda: None, prefill),
             "8 decode steps after it": (prefill, decode)}
    for name, (setup, work) in cases.items():
        walls = []
        for _ in range(3):
            state = setup()
            torch.cuda.synchronize()
            t = time.perf_counter()
            work(state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        state = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            work(state)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy: dict[str, float] = {}
        for e in kern:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        total = sum(busy.values())
        wall = statistics.median(walls) * 1e3
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase 12: profile, {name}: wall {wall:.2f} ms unprofiled (median of 3); "
            f"{len(kern)} kernel launches, device busy {total:.2f} ms "
            f"({100 * total / wall:.1f}% of the wall, idle {100 - 100 * total / wall:.1f}%)")
        for kname, ms in top:
            log(f"phase 12:   {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  {kname[:90]}")


def serve_phases(dev, card) -> list[dict]:
    """Phases 9-12: DR-routed serving of gemma-2b and the flash kernel."""
    import repro_torch.models.model as model
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler

    bf16 = torch.bfloat16
    cfg = get_config("gemma-2b")
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)

    # ---- phase 9: full-width serving through DRScheduler + ServeEngine ----
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"phase 9: gemma-2b: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} q heads "
        f"over {cfg.num_kv_heads} kv head, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"initialised on the card in {time.perf_counter() - t:.1f} s")
    n_req, max_new, n_rep, slots, max_len = 32, 16, 4, 4, 2064
    rng = np.random.default_rng(0)
    sessions = np.where(rng.random(n_req) < 0.3, 7, rng.integers(0, 1000, n_req))
    lens = rng.integers(256, 2049, n_req)
    sched = DRScheduler(n_rep)
    engines = [ServeEngine(cfg, params, pol, slots=slots, max_len=max_len, device=dev)
               for _ in range(n_rep)]
    queues: list[list] = [[] for _ in range(n_rep)]
    for i in range(n_req):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32),
                      max_new_tokens=max_new, session_key=int(sessions[i]))
        queues[sched.route(req.session_key, cost_tokens=max_new)].append(req)

    # time each prefill and decode step the engines make, and check their logits
    walls = {"prefill": [], "decode": []}
    finite = []
    orig = {"prefill": model.prefill, "decode": model.decode_step}

    def timed(kind):
        def call(*a, **k):
            t0 = time.perf_counter()
            logits, cache = orig[kind](*a, **k)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits, cache
        return call

    model.prefill, model.decode_step = timed("prefill"), timed("decode")
    try:
        flash_attention.launches = 0
        t = time.perf_counter()
        for r, (eng, q) in enumerate(zip(engines, queues)):
            eng.run(q, max_ticks=200)
            log(f"phase 9: replica {r}: {len(q)} requests, {eng.tokens_out} tokens, "
                f"{eng.steps} ticks")
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        launches = flash_attention.launches
    finally:
        model.prefill, model.decode_step = orig["prefill"], orig["decode"]
    info = sched.checkpoint(sessions)
    reqs = [r for q in queues for r in q]
    assert len(reqs) == n_req
    for r in reqs:
        assert len(r.out_tokens) == max_new and r.done, (r.rid, r.out_tokens)
        assert all(0 <= x < cfg.vocab_size for x in r.out_tokens), (r.rid, r.out_tokens)
    assert finite and all(finite), "non-finite logits"
    assert launches == cfg.num_layers * n_req, launches
    assert set(info) == {"repartitioned", "resized", "num_replicas", "imbalance",
                         "moved_sessions", "reason", "backend", "overlapped"}, info
    tokens = sum(len(r.out_tokens) for r in reqs)
    prefill_ms = statistics.median(walls["prefill"]) * 1e3
    decode_ms = statistics.median(walls["decode"]) * 1e3
    log(f"phase 9: routed={sched.routed} imbalance={sched.imbalance():.2f}; prompts "
        f"{int(lens.min())}-{int(lens.max())} tokens (mean {lens.mean():.1f}); {tokens} tokens "
        f"in {serve_s:.2f} s ({tokens / serve_s:.1f} tokens/s); flash launches {launches} "
        f"(= {cfg.num_layers} layers x {n_req} prefills); all logits finite")
    log(f"phase 9: DR checkpoint: {info}")
    del engines
    torch.cuda.empty_cache()

    # ---- phase 10: the flash kernel against its plain version -------------
    # p_bf16 rounds the weights to bf16 in both versions, so a last-bit
    # difference in a score may flip a rounding: 2e-2 for float32 inputs too
    errs = {(dt, pb): 0.0 for dt in (torch.float32, bf16) for pb in (False, True)}
    # bf16 outputs with float32 weights, held to the float32 plain version on
    # the same (bf16) inputs beyond the output's own rounding: P_hi + P_lo
    # keeps P to about 2**-17, so the excess is float32 noise; weights rounded
    # to bf16 (plain p_bf16=True, the control) leave ~1e-3
    excess = {"kernel": -1.0, "control": -1.0}
    EXCESS_LIMIT = 2e-4
    tol = {(torch.float32, False): 2e-5, (torch.float32, True): 2e-2,
           (bf16, False): 2e-2, (bf16, True): 2e-2}
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(1, 8, sq, 256) for sq in (1, 100, 512, 2048)]
    cases += [(g, p, sq, hd) for hd, g, p in ((16, 3, 2), (64, 2, 1), (128, 4, 2), (192, 2, 2))
              for sq in (7, 300)]
    n_cases = 0
    for g, p, sq, hd in cases:
        for dtype in (torch.float32, bf16):
            q = torch.randn((g, p, sq, hd), generator=gen, device=dev).to(dtype)
            k = torch.randn((g, sq, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((g, sq, hd), generator=gen, device=dev).to(dtype)
            for causal, window in ((True, 0), (False, 0), (True, 96)):
                for pb in (False, True):
                    got = flash_attention(q, k, v, causal=causal, window=window, p_bf16=pb)
                    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                                 p_bf16=pb)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype and got.shape == q.shape
                    err = float((got.float() - want.float()).abs().max())
                    errs[dtype, pb] = max(errs[dtype, pb], err)
                    n_cases += 1
                    assert err <= tol[dtype, pb], (g, p, sq, hd, dtype, causal, window, pb, err)
                    if dtype == bf16 and not pb:
                        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                                    causal=causal, window=window)
                        control = flash_attention_plain(q, k, v, causal=causal, window=window,
                                                        p_bf16=True)
                        excess["kernel"] = max(excess["kernel"],
                                               excess_over_bf16_rounding(got, ref))
                        excess["control"] = max(excess["control"],
                                                excess_over_bf16_rounding(control, ref))
    # float32 weights through the bf16 tensor cores (P_hi + P_lo) keep
    # float32-level precision: the check tells bf16 weights apart (control)
    assert errs[bf16, False] <= 8e-3, errs
    assert excess["kernel"] <= EXCESS_LIMIT < excess["control"], excess
    log(f"phase 10: flash_attention: {n_cases} cases within tolerance; max abs error with "
        f"p_bf16=False: {errs[torch.float32, False]:.3g} in float32 (<= 2e-5), "
        f"{errs[bf16, False]:.3g} in bf16 (<= 8e-3); with p_bf16=True: "
        f"{errs[torch.float32, True]:.3g} in float32, {errs[bf16, True]:.3g} in bf16 (<= 2e-2)")
    log(f"phase 10: bf16 outputs against the float32 plain version beyond the output's own "
        f"rounding: kernel (p_bf16=False) {excess['kernel']:.3g} (<= {EXCESS_LIMIT:g}); "
        f"control, plain with p_bf16=True {excess['control']:.3g} (> {EXCESS_LIMIT:g})")

    # ---- phase 11: card against CPU, full width, depth 2, float32 ---------
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    pol32 = Policy()
    cpu_params = model.init_params(cfg2, 1, pol32, device="cpu")
    card_params = _to(cpu_params, dev)
    rng = np.random.default_rng(1)
    worst, checked, margins_skipped = 0.0, 0, 0
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(128, 257)))
        toks = torch.as_tensor(prompt[None].astype(np.int64))
        lc, cc = model.prefill(cpu_params, {"tokens": toks}, cfg2, pol32, max_len=272)
        lg, cg = model.prefill(card_params, {"tokens": toks.to(dev)}, cfg2, pol32, max_len=272)
        for step in range(8):
            a = lc[0, -1, :cfg.vocab_size]
            b = lg[0, -1, :cfg.vocab_size].cpu()
            assert bool(torch.isfinite(b).all())
            worst = max(worst, float((a - b).abs().max()))
            checked += 1
            top2 = torch.topk(a.double(), 2).values
            nxt = int(torch.argmax(a))
            if float(top2[0] - top2[1]) > 1e-2:
                assert int(torch.argmax(b)) == nxt, (i, step)
            else:
                margins_skipped += 1
            if step == 7:
                break
            lc, cc = model.decode_step(cpu_params, cc, torch.tensor([[nxt]]), cfg2, pol32)
            lg, cg = model.decode_step(card_params, cg, torch.tensor([[nxt]], device=dev),
                                       cfg2, pol32)
    assert worst <= 1e-3, worst
    log(f"phase 11: gemma-2b depth 2, float32, TF32 off: {checked} teacher-forced steps over 4 "
        f"prompts; max |logit card - CPU| {worst:.3g} (<= 1e-3); greedy tokens equal "
        f"({margins_skipped} steps with a top-two margin <= 1e-2 not compared)")
    del cpu_params, card_params, cc, cg
    torch.cuda.empty_cache()

    # ---- phase 12: times ----------------------------------------------------
    import torch.nn.functional as F

    rows = {}
    for sq in (512, 1024, 2048):
        q = torch.randn((1, 8, sq, 256), generator=gen, device=dev).to(bf16)
        k = torch.randn((1, sq, 256), generator=gen, device=dev).to(bf16)
        v = torch.randn((1, sq, 256), generator=gen, device=dev).to(bf16)
        ke, ve = (x[:, None].expand(1, 8, sq, 256).contiguous() for x in (k, v))
        # ms: CUDA events around one call (as every kernel's ms); dev: the
        # device's own time over 20 calls (torch.profiler), no host in it
        k_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
        kb_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, p_bf16=True))
        p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
        k_dev = device_ms(lambda: flash_attention(q, k, v, causal=True))
        kb_dev = device_ms(lambda: flash_attention(q, k, v, causal=True, p_bf16=True))
        l_dev = device_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
        nbytes, flops = causal_flash_cost(1, 8, sq, 256, bf16)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[bf16]) * 1e3
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, sq)), device=dev)
        pre = []
        for _ in range(4):
            t = time.perf_counter()
            model.prefill(params, {"tokens": toks}, cfg, pol, max_len=max_len)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t)
        pre_ms = statistics.median(pre[1:]) * 1e3
        rows[sq] = (k_ms, p_ms, l_ms, k_dev, l_dev, bound_ms, nbytes, flops)
        log(f"phase 12: flash_attention G=1 P=8 hd=256 Sq=Sk={sq} bf16 causal, events around "
            f"one call: kernel {k_ms:.4f} ms, p_bf16=True {kb_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"SDPA {l_ms:.4f} ms; device time: kernel {k_dev:.4f} ms ({flops / k_dev / 1e9:.1f} "
            f"TFLOP/s, {100 * bound_ms / k_dev:.1f}% of the bound {bound_ms:.4f} ms by "
            f"operations: {flops:,} FLOP, {nbytes:,} bytes), p_bf16=True {kb_dev:.4f} ms, SDPA "
            f"{l_dev:.4f} ms (kernel / SDPA {k_dev / l_dev:.2f}); prefill of {sq} tokens "
            f"{pre_ms:.2f} ms, of which flash {cfg.num_layers} x {k_ms:.4f} ms = "
            f"{100 * cfg.num_layers * k_ms / pre_ms:.1f}% (by device time "
            f"{100 * cfg.num_layers * k_dev / pre_ms:.1f}%)")
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = cuda_ms(lambda: flash_attention(q32, k32, v32, causal=True))
    f32_dev = device_ms(lambda: flash_attention(q32, k32, v32, causal=True), n=5)
    log(f"phase 12: flash_attention float32 (scalar kernel) at Sq=Sk=2048: {f32_ms:.4f} ms "
        f"(events around one call), device time {f32_dev:.4f} ms "
        f"({flops / f32_dev / 1e9:.1f} TFLOP/s)")
    profile_serving(model, params, cfg, pol, rng, dev, max_len)
    log(f"phase 12: phase 9 medians: prefill {prefill_ms:.2f} ms per request "
        f"({len(walls['prefill'])} prefills), decode {decode_ms:.2f} ms per token "
        f"({len(walls['decode'])} steps, one slot each); {tokens / serve_s:.1f} tokens/s; "
        f"card {card}")
    k_ms, p_ms, l_ms, k_dev, l_dev, bound_ms, nbytes, flops = rows[2048]
    return [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": REPLACES["flash_attention"], "launches": launches,
        "max_abs_err": max(errs.values()), "max_abs_err_f32": errs[torch.float32, False],
        "max_abs_err_bf16": errs[bf16, False],
        "p_bf16_max_abs_err": max(errs[torch.float32, True], errs[bf16, True]),
        "p_bf16_max_abs_err_f32": errs[torch.float32, True],
        "p_bf16_max_abs_err_bf16": errs[bf16, True],
        "excess_over_bf16_rounding": excess["kernel"], "ms": k_ms, "plain_ms": p_ms,
        "device_ms": k_dev, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_FLOPS[bf16] > nbytes / HBM_BYTES_PER_S
        else "bytes", "bytes": nbytes, "flops": flops, "library_ms": l_ms,
        "library_device_ms": l_dev,
        "shape": "G=1 P=8 Sq=Sk=2048 hd=256 bf16 causal",
    }]


if __name__ == "__main__":
    sys.exit(main())
