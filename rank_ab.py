"""The one-pass rank kernels against the three-pass design they replace, in
one process on one CUDA card: route_bucketize and lookup_dispatch at the
streaming path's shapes, dispatch_count at the batch path's.

    git archive 500a841 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 rank_ab.py

``build/parent`` (git-ignored) holds the three-pass sources (commit 500a841:
per-block lane counts, a scan over blocks, a stable in-block rank, a fill
pass); this script builds them beside the port's own kernels, checks that
both give the same outputs, then times them in turns (old, new, new, old):
CUDA events around one call, and device time by kernel name over 20 calls
(``chip_smoke.own_device_time``, an L2 flush between calls for
route_bucketize and dispatch_count), which splits the old design by pass.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OLD_SRC = REPO / "build/parent/src/repro_torch/kernels/csrc"
OLD_LIB = REPO / "build/parent/librank_parent.so"
OLD_PASSES = {
    "route_bucketize": ("route_count_kernel", "lane_scan_kernel", "rank_kernel", "fill_kernel"),
    "lookup_dispatch": ("route_count_kernel", "lane_scan_kernel", "rank_kernel"),
    "dispatch_count": ("dest_count_kernel", "lane_scan_kernel", "dest_rank_kernel"),
}


def build_old(nvcc):
    """The parent's route and batch kernels as one library with its C entry
    points (block_counts scratch of [W, L, ceil(n / block)] int32)."""
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    objs = [OLD_LIB.with_name(f"{name}.o") for name in ("route_kernels", "batch_kernels")]
    procs = [subprocess.Popen([nvcc, *flags, "-c", str(OLD_SRC / f"{o.stem}.cu"), "-o", str(o)])
             for o in objs]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on the parent's kernels")
    subprocess.run([nvcc, "-shared", "-o", str(OLD_LIB), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(OLD_LIB))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for name, args in {
            "rk_block_records": [],
            "rk_lookup_dispatch": [p, p, i, i, p, p, p, i, p, i, u, i, i, p, p, p, p, p],
            "rk_route_bucketize": [p, p, p, i, i, i, p, p, p, i, p, i, u, i, i, i, i, p, p, p, p,
                                   p, p, p, p, p],
            "bk_dispatch_count": [p, p, i, i, i, p, p, p, p]}.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    return lib


def old_calls(lib, dev):
    """The parent's wrappers around ``lib``, for CUDA tensors."""
    from repro_torch.core.hashing import seed_mix

    block = lib.rk_block_records()

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def scratch(w, n, lanes):
        return torch.empty((w, lanes, -(-n // block)), dtype=torch.int32, device=dev)

    def route_bucketize(keys, valid, vals, hk, hp, h2p, hr, *, seed, num_hosts, num_lanes,
                        capacity, key_fill, num_partitions):
        w, n = keys.shape
        part, slot = torch.empty_like(keys), torch.empty_like(keys)
        counts = torch.empty((w, num_lanes), dtype=torch.int32, device=dev)
        shape = (w, num_lanes, capacity)
        bufs = (torch.empty(shape, dtype=torch.bool, device=dev),
                torch.empty(shape, dtype=torch.int32, device=dev),
                torch.empty(shape + vals.shape[2:], dtype=torch.float32, device=dev),
                torch.empty(shape, dtype=torch.int32, device=dev))
        assert lib.rk_route_bucketize(
            keys.data_ptr(), valid.data_ptr(), vals.data_ptr(), vals.shape[2], w, n,
            hk.data_ptr(), hp.data_ptr(), hr.data_ptr() if num_partitions > 0 else None,
            hk.shape[0], h2p.data_ptr(), num_hosts, seed_mix(seed), num_lanes, num_partitions,
            capacity, key_fill, part.data_ptr(), slot.data_ptr(), counts.data_ptr(),
            scratch(w, n, num_lanes).data_ptr(), *(b.data_ptr() for b in bufs), stream()) == 0
        return (part, slot, counts, *bufs)

    def lookup_dispatch(keys, valid, hk, hp, h2p, hr, *, seed, num_hosts, num_lanes,
                        num_partitions):
        w, n = keys.shape
        part, slot = torch.empty_like(keys), torch.empty_like(keys)
        counts = torch.empty((w, num_lanes), dtype=torch.int32, device=dev)
        assert lib.rk_lookup_dispatch(
            keys.data_ptr(), valid.data_ptr(), w, n, hk.data_ptr(), hp.data_ptr(),
            hr.data_ptr() if num_partitions > 0 else None, hk.shape[0], h2p.data_ptr(),
            num_hosts, seed_mix(seed), num_lanes, num_partitions, part.data_ptr(),
            slot.data_ptr(), counts.data_ptr(), scratch(w, n, num_lanes).data_ptr(),
            stream()) == 0
        return part, slot, counts

    def dispatch_count(dest, valid, *, num_parts):
        w, n = dest.shape
        slot = torch.empty_like(dest)
        counts = torch.empty((w, num_parts), dtype=torch.int32, device=dev)
        assert lib.bk_dispatch_count(dest.data_ptr(), valid.data_ptr(), w, n, num_parts,
                                     slot.data_ptr(), counts.data_ptr(),
                                     scratch(w, n, num_parts).data_ptr(), stream()) == 0
        return slot, counts

    return {"route_bucketize": route_bucketize, "lookup_dispatch": lookup_dispatch,
            "dispatch_count": dispatch_count}


def path_inputs(dev):
    """(args, kwargs) of each kernel at its path's shapes: phase 2's DR loop
    (its last batch, partitioner and final state) and phase 6's job at
    exponent 1.2 (its assignments; its keys and KIP tables for
    partition_apply), as chip_smoke.py makes them."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.hashing import KEY_SENTINEL
    from repro_torch.core.replay import BatchJob
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf, zipf_keys
    from repro_torch.kernels import ops

    sent = int(KEY_SENTINEL)
    job = StreamingJob(device="cuda", num_workers=8, num_partitions=32, state_capacity=262_144,
                       capacity_factor=2.0,
                       dr=DRConfig(imbalance_trigger=1.2, migration_cost_weight=0.2))
    batches = list(drifting_zipf(8, 4_194_304, num_keys=1_000_000, exponent=1.3,
                                 drift_every=3, drift_fraction=0.3, seed=0))
    for b in batches:
        job.process_batch(b)
    part, w = job.drm.partitioner, job.num_workers
    keys = torch.as_tensor(batches[-1].astype(np.int32), device=dev).reshape(w, -1)
    h2p = part.tables(dev).host_to_part
    hk, hp, hr = ops.pad_heavy_tables(part.tables(dev), num_partitions=32, pad_empty=True)
    lk, lp, _ = ops.pad_heavy_tables(part.tables(dev), num_partitions=0, pad_empty=False)
    state = job.state_keys.clone()
    ones = torch.ones(keys.shape + (1,), dtype=torch.float32, device=dev)
    batch_keys = zipf_keys(10_000_000, num_keys=1_000_000, exponent=1.2, seed=12)
    batch = BatchJob(35, dr=DRConfig(mode="batch", lam=4.0, eps=0.003), device=dev).run(
        batch_keys)
    assign = batch.assignments[None]
    kip = batch.partitioner
    bk, bp, _ = ops.pad_heavy_tables(kip.tables(dev), num_partitions=0, pad_empty=False)
    return {
        "route_bucketize": ((keys, keys != sent, ones, hk, hp, h2p, hr),
                            dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w,
                                 capacity=job._shuffle_spec.capacity, key_fill=sent,
                                 num_partitions=32)),
        "lookup_dispatch": ((state, state != sent, lk, lp, h2p, None),
                            dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w,
                                 num_partitions=0)),
        "dispatch_count": ((assign, torch.ones_like(assign, dtype=torch.bool)),
                           dict(num_parts=35)),
        "partition_apply": ((torch.as_tensor(batch_keys.astype(np.int32), device=dev), bk, bp,
                             kip.tables(dev).host_to_part),
                            dict(seed=kip.seed, num_hosts=kip.num_hosts)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.dispatch_count import dispatch_count
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch
    from repro_torch.kernels.route_bucketize import route_bucketize

    if not OLD_SRC.is_dir():
        print(f"rank_ab: {OLD_SRC} is missing (see the docstring)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    build.library()
    old = old_calls(build_old(build.nvcc_path()), dev)
    new = {"route_bucketize": route_bucketize, "lookup_dispatch": lookup_dispatch,
           "dispatch_count": dispatch_count}
    inputs = path_inputs(dev)
    flush = cs.l2_flush(dev)
    card = cs.card_line()
    print(card, flush=True)
    for name in OLD_PASSES:
        args, kw = inputs[name]
        calls = {"old": lambda: old[name](*args, **kw), "new": lambda: new[name](*args, **kw)}
        a, b = calls["old"](), calls["new"]()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        del a, b
        names = {"old": OLD_PASSES[name], "new": cs.DEVICE_NAMES[name]}
        flushed = flush if name != "lookup_dispatch" else None
        seen = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            ms = cs.cuda_ms(calls[which])
            d_ms, split, ops = cs.own_device_time(calls[which], names[which], flush=flushed)
            seen[which].append((ms, d_ms))
            print(f"{name} {which}: events {ms:.4f} ms, device {d_ms:.4f} ms ({ops:g} device "
                  f"operations a call): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
                  flush=True)
        for which, rows in seen.items():
            print(f"{name} {which}, mean of 2: events {statistics.mean(r[0] for r in rows):.4f} "
                  f"ms, device {statistics.mean(r[1] for r in rows):.4f} ms", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
