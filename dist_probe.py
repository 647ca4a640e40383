#!/usr/bin/env python3
"""What the card's process groups accept, on a machine with one CUDA card.
Run from the repository root:

    python3 dist_probe.py

Three spawned groups, each rank writing what it saw under the git-ignored
``build/dist_probe/``, printed by the parent:

1. two and eight gloo ranks sharing ``cuda:0``: whether gloo takes CUDA
   tensors (dense and uneven ``all_to_all_single``, bool included,
   ``all_reduce``, ``all_gather``), the wall of a dense all-to-all of
   one lane of 131,072 rows to each rank (int32 keys, float32 values and
   bool valid: 9 bytes a row) on the card and from host tensors, and the
   card's memory in use with every rank up;
2. one nccl rank: ``all_reduce`` and a bool ``all_to_all_single``;
3. two nccl ranks on the one card: the error NCCL gives.

A group that hangs is killed after its time limit, and the script says so.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT = Path(__file__).resolve().parent / "build" / "dist_probe"
LANE_ROWS = 131_072


def _try(res, name, fn):
    try:
        res[name] = fn()
    except Exception as e:  # the probe records what the build refuses
        res[name] = f"FAIL {type(e).__name__}: {str(e)[:300]}"


def gloo_rank(rank, world, store):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = {}

    def a2a(dtype):
        x = (torch.arange(world * 4, device=dev) + 100 * rank).to(dtype)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y.cpu().tolist()

    def uneven():
        send, recv = [r + 1 for r in range(world)], [rank + 1] * world
        x = torch.full((sum(send), 2), float(rank), device=dev)
        y = torch.empty((sum(recv), 2), device=dev)
        dist.all_to_all_single(y, x, output_split_sizes=recv, input_split_sizes=send)
        return y[:, 0].cpu().tolist()

    def reduce():
        x = torch.full((5,), rank + 1, dtype=torch.int64, device=dev)
        dist.all_reduce(x)
        return x.cpu().tolist()

    def gather():
        x = torch.full((3,), rank, dtype=torch.int32, device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [p.cpu().tolist() for p in parts]

    _try(res, "all_to_all int32", lambda: a2a(torch.int32))
    _try(res, "all_to_all bool", lambda: a2a(torch.bool))
    _try(res, "all_to_all uneven", uneven)
    _try(res, "all_reduce", reduce)
    _try(res, "all_gather", gather)
    keys = torch.randint(0, 1 << 30, (world, LANE_ROWS), dtype=torch.int32, device=dev)
    bufs = (keys, torch.rand(world, LANE_ROWS, device=dev), keys % 2 == 0)
    for where in ("cuda", "host"):
        ms = []
        for _ in range(4):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for b in bufs:
                b = b if where == "cuda" else b.cpu()
                dist.all_to_all_single(torch.empty_like(b), b)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t) * 1e3, 2))
        res[f"ship ms, {where} tensors"] = ms
    dist.barrier()
    if rank == 0:
        res["nvidia-smi memory.used"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    dist.barrier()
    (OUT / f"{Path(store).name}.{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def nccl_rank(rank, world, store):
    res = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world, device_id=torch.device("cuda", 0))
        x = torch.full((4,), rank + 1, device="cuda")
        dist.all_reduce(x)
        res["all_reduce"] = x.cpu().tolist()
        y = torch.empty(world * 2, dtype=torch.bool, device="cuda")
        dist.all_to_all_single(y, torch.ones(world * 2, dtype=torch.bool, device="cuda"))
        res["all_to_all bool"] = y.cpu().tolist()
        dist.destroy_process_group()
    except Exception as e:
        res["error"] = f"{type(e).__name__}: {str(e)[:1500]}"
    (OUT / f"{Path(store).name}.{rank}.json").write_text(json.dumps(res))


def probe(fn, world, tag, timeout_s):
    store = OUT / tag
    store.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    t = time.perf_counter()
    procs = [ctx.Process(target=fn, args=(r, world, str(store))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(1.0, timeout_s - (time.perf_counter() - t)))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    print(f"{tag}: {world} ranks, {time.perf_counter() - t:.1f} s, hung ranks {hung}, "
          f"exit codes {[p.exitcode for p in procs]}", flush=True)
    for r in range(world):
        f = OUT / f"{tag}.{r}.json"
        print(f"  rank {r}: {f.read_text() if f.exists() else 'no result'}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    probe(gloo_rank, 2, "gloo2", 120)
    probe(gloo_rank, 8, "gloo8", 180)
    probe(nccl_rank, 1, "nccl1", 90)
    probe(nccl_rank, 2, "nccl2", 90)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    sys.exit(main())
