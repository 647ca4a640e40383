"""Do the route and sketch kernels' checks catch a broken look-back, fill,
heavy-key probe, fastmod or cross-cluster sum?  (Needs one CUDA card.)

    python3 route_mutations.py

Builds the port's kernels from copies of ``src/`` in a temporary directory,
each with one deliberate fault in ``csrc/lane_rank.cuh`` (the one-pass
rank that ``route_bucketize``, ``lookup_dispatch`` and ``dispatch_count``
share), ``csrc/route_kernels.cu`` (the fill) or ``csrc/route_common.cuh``
(the heavy-key probe that ``route_bucketize``, ``lookup_dispatch`` and
``partition_apply`` share), ``csrc/sketch_kernels.cu`` (the sketch's sum
over clusters) or ``kernels/sketch_update.py`` (the sketch's fastmod
constant), and reads what these checks read on it:

* ``edges``: the GPU tests' edge cases (``test_route_kernels_edge_cases``,
  ``test_heavy_probe_edge_cases``, ``test_dispatch_count_edge_cases``,
  ``test_sketch_update_edge_cases`` in ``tests/test_torch_gpu.py``: below
  one tile, k tiles + 1, many tiles, 35 rows, 1024 lanes, ragged
  capacities, capacity 0, every record invalid, no records; heavy tables of 0, 1, 128, 1024 and 1025 rows, 127 sentinel
  rows, runs of equal keys, colliding probe slots, ragged and misaligned
  keys; sketches at widths 1 to 40,961, skewed, misaligned, ragged,
  stacked and split over a cluster; each with every tensor the wrapper
  allocates filled with 0x5A bytes first); the cases that fail are named;
* ``main``: ``route_bucketize`` at the streaming path's shapes (8 workers of
  524,288 keys, 8 lanes, 32 partitions, a split key, capacity 131,072),
  ``dispatch_count`` at the batch path's (10,000,000 records, 35 parts) and
  ``sketch_update`` at the batch path's (10,000,000 keys at exponent 1.2,
  depth 4, width 2048), each against its plain version, as
  ``chip_smoke.py`` phases 3 and 7 do;
* ``load``: both kernels on four streams at once beside a busy copy, as
  ``test_rank_kernels_are_deterministic_under_concurrent_load`` runs them,
  five times over, and the sketch likewise; the outputs that differ from
  the plain version's are counted.

The faults: (a) the look-back takes an earlier tile's aggregate as its
inclusive prefix and stops; (b) the fill skips its last partial vector;
(c) the release fence before a tile's flag is removed (the flag may be
seen before the counts it stands for); (d) the probe table keeps the last
row of each run of equal heavy keys instead of the first; (e) a probe
stops at its key's home slot, taken or not, instead of walking on past
other keys; (f) the sketch's fastmod constant is one less
(``2**64 // width``); (g) the last cluster of an eighth skips the first
cluster's partial in its sum; (h) the fences around the sketch's tickets
are removed (a last cluster may sum partials before they land).  The
unchanged kernels must pass every check, and (a), (b), (d), (e), (f) and
(g) must each fail the check named beside them; (c) and (h) are races
whose window a run may never hit, so their readings are printed, not
required.  Exits 0 when all of that holds.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
RANK = Path("src/repro_torch/kernels/csrc/lane_rank.cuh")
ROUTE = Path("src/repro_torch/kernels/csrc/route_kernels.cu")
COMMON = Path("src/repro_torch/kernels/csrc/route_common.cuh")
SKETCH = Path("src/repro_torch/kernels/csrc/sketch_kernels.cu")
SKETCH_PY = Path("src/repro_torch/kernels/sketch_update.py")
SENT = 2**31 - 1


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"mutation anchor found {text.count(old)} times: {old!r}")
    return text.replace(old, new)


MUTATIONS = {
    "(a) look-back stops at an aggregate": (RANK, lambda t: _replace(
        t, "const unsigned found = __ballot_sync(kFull, f == kPrefix);",
        "const unsigned found = __ballot_sync(kFull, f != 0);")),
    "(b) fill skips its last partial vector": (ROUTE, lambda t: _replace(
        t, "    if (gid < (seg.bytes & 15))\n", "    if (false && gid < (seg.bytes & 15))\n")),
    "(c) no release fence before a flag": (RANK, lambda t: _replace(_replace(
        t, "  if (wrote) __threadfence();\n", ""),
        "st.release.gpu.global.s32", "st.relaxed.gpu.global.s32")),
    "(d) probe keeps the last equal row": (COMMON, lambda t: _replace(
        t, "first[r] = j < num_heavy && (j == 0 || heavy_keys[j - 1] != key[r]);",
        "first[r] = j < num_heavy && (j + 1 == num_heavy || heavy_keys[j + 1] != key[r]);")),
    "(e) probe stops at the home slot": (COMMON, lambda t: _replace(
        t, "return slot.y < 0 || slot.x == key ? slot.y : kWalkOn;",
        "return slot.x == key ? slot.y : -1;")),
    "(f) fastmod constant one less": (SKETCH_PY, lambda t: _replace(
        t, "return (2**64 // width + 1) % 2**64", "return (2**64 // width) % 2**64")),
    "(g) last cluster skips a partial": (SKETCH, lambda t: _replace(
        t, "    for (int j = 0; j < a.clusters; ++j) {  // the loads in flight together\n",
        "    for (int j = 1; j < a.clusters; ++j) {\n")),
    "(h) no fences around the tickets": (SKETCH, lambda t: _replace(_replace(
        t, "  __threadfence();  // the partial before the ticket (release)\n", ""),
        "  __threadfence();  // the other clusters' partials after their tickets (acquire)\n",
        "")),
}
# which probe must fail on each fault
CAUGHT_BY = {"(a) look-back stops at an aggregate": "main",
             "(b) fill skips its last partial vector": "edges",
             "(c) no release fence before a flag": None,
             "(d) probe keeps the last equal row": "edges",
             "(e) probe stops at the home slot": "edges",
             "(f) fastmod constant one less": "edges",
             "(g) last cluster skips a partial": "edges",
             "(h) no fences around the tickets": None}


def _inputs(dev):
    """The streaming path's route_bucketize arguments, the batch path's
    dispatch_count arguments and its sketch's keys, from seeded numpy
    draws."""
    from repro_torch.core.histogram import Histogram
    from repro_torch.core.partitioner import kip_update, uniform_partitioner
    from repro_torch.data.generators import zipf_keys
    from repro_torch.kernels import ops

    w, n = 8, 524_288
    stream = zipf_keys(w * n, num_keys=1_000_000, exponent=1.3, seed=0)
    hist = Histogram.exact(stream).top(128)
    p = kip_update(uniform_partitioner(32, heavy_capacity=128), hist)
    p = p.with_splits({int(hist.keys[0]): 4})
    keys = torch.as_tensor(stream.astype(np.int32).reshape(w, n), device=dev)
    t = p.tables(dev)
    hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=32, pad_empty=True)
    rb = ((keys, keys != SENT, torch.ones((w, n, 1), device=dev), hk, hp, t.host_to_part, hr),
          dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=w, capacity=131_072,
               key_fill=SENT, num_partitions=32))
    rng = np.random.default_rng(6)
    dc = (torch.as_tensor(rng.integers(-1, 36, (1, 10_000_000)).astype(np.int32), device=dev),
          torch.as_tensor(rng.random((1, 10_000_000)) < 0.9, device=dev))
    sk = torch.as_tensor(zipf_keys(10_000_000, num_keys=1_000_000, exponent=1.2,
                                   seed=12).astype(np.int32), device=dev)
    return rb, dc, sk


def _calls(dev):
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain
    from repro_torch.kernels.sketch_update import sketch_update, sketch_update_plain

    (rb_args, rb_kw), (dest, valid), sk = _inputs(dev)
    ones = torch.ones_like(sk, dtype=torch.bool)
    return {
        "sketch_update": (lambda: (sketch_update(sk, ones),),
                          lambda: (sketch_update_plain(sk, ones),)),
        "route_bucketize": (lambda: route_bucketize(*rb_args, **rb_kw),
                            lambda: route_bucketize_plain(*rb_args, **rb_kw)),
        "dispatch_count": (lambda: dispatch_count(dest, valid, num_parts=35),
                           lambda: dispatch_count_plain(dest, valid, num_parts=35)),
    }


def _same(got, want) -> bool:
    return all(torch.equal(g, x) for g, x in zip(got, want))


def probe_main() -> bool:
    dev = torch.device("cuda")
    ok = True
    for name, (kernel, plain) in _calls(dev).items():
        want = plain()
        equal = [_same(kernel(), want) for _ in range(3)]
        torch.cuda.synchronize()
        print(f"    main: {name} equal to its plain version in {sum(equal)} of 3 calls",
              flush=True)
        ok &= all(equal)
    return ok


def probe_load() -> bool:
    dev = torch.device("cuda")
    src = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    streams = [torch.cuda.Stream() for _ in range(5)]
    differ = total = 0
    for name, (kernel, plain) in _calls(dev).items():
        want = plain()
        torch.cuda.synchronize()
        for _ in range(5):
            outs = []
            with torch.cuda.stream(streams[4]):
                for _ in range(4):
                    dst.copy_(src)
            for st in streams[:4]:
                with torch.cuda.stream(st):
                    outs.append(kernel())
            torch.cuda.synchronize()
            differ += sum(not _same(o, want) for o in outs)
            total += len(outs)
            del outs
    print(f"    load: {differ} of {total} outputs differ from the plain version's", flush=True)
    return differ == 0


PROBES = {"main": probe_main, "load": probe_load}


def run_probe(root: Path, name: str) -> bool:
    """One probe in a fresh process that imports the port from ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    if name == "edges":
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rf", "-p", "no:cacheprovider",
             "tests/test_torch_gpu.py", "-k", "edge_cases"],
            env=env, cwd=root, timeout=900, capture_output=True, text=True)
        failed = [ln.split("::")[-1] for ln in proc.stdout.splitlines()
                  if ln.startswith("FAILED")]
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else proc.stderr[-300:]
        print(f"    edges: {last}" + (f"; failed: {', '.join(failed)}" if failed else ""),
              flush=True)
        return proc.returncode == 0
    proc = subprocess.run([sys.executable, str(REPO / "route_mutations.py"), "--probe", name],
                          env=env, cwd=root, timeout=900)
    return proc.returncode == 0


def _copy(root: Path) -> None:
    shutil.copytree(REPO / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "tests").mkdir(parents=True)
    for f in ("tests/test_torch_gpu.py", "tests/conftest.py", "pyproject.toml"):
        shutil.copy(REPO / f, root / f)


def main() -> int:
    if not torch.cuda.is_available():
        print("route_mutations: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--probe"]:
        return 0 if PROBES[sys.argv[2]]() else 1
    good = True
    names = ["edges", *PROBES]
    with tempfile.TemporaryDirectory(prefix="route_mutations_") as tmp:
        root = Path(tmp) / "unchanged"
        _copy(root)
        print("unchanged kernels", flush=True)
        for name in names:
            passed = run_probe(root, name)
            good &= passed
            print(f"  {name}: {'pass' if passed else 'FAIL'}", flush=True)
        for fault, (path, mutate) in MUTATIONS.items():
            root = Path(tmp) / fault.split(")")[0].strip("(")
            _copy(root)
            (root / path).write_text(mutate((REPO / path).read_text()))
            print(f"fault {fault}", flush=True)
            for name in names:
                passed = run_probe(root, name)
                caught = CAUGHT_BY[fault] == name
                if caught:
                    good &= not passed
                print(f"  {name}: {'pass' if passed else 'FAIL'}"
                      f"{' (must fail)' if caught else ''}", flush=True)
    print("faults (a), (b), (d), (e), (f) and (g) caught, unchanged kernels pass" if good
          else "NOT as required")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
