"""sketch_update against its parent's, in one process on one CUDA card, at
the batch path's shape: 10,000,000 keys of the paper's Fig. 4 job (Zipf
over 1,000,000 keys, as ``chip_smoke.py`` phase 6 draws them), all valid.

    mkdir -p build/sketch_parent
    git archive cd6bcde src/repro_torch/kernels/csrc | tar -x -C build/sketch_parent
    python3 sketch_ab.py             # parent against change, the A/B, the splits
    python3 sketch_ab.py --parent    # the parent alone: its times and its split
    python3 sketch_ab.py --sass      # the port's loop, instructions by pipe

``build/sketch_parent`` (git-ignored) holds the parent's sources (commit
cd6bcde: 256-thread blocks, as many as are resident, each with one copy of
the rows in shared memory and a warp match on the column of every row,
flushing each nonzero cell into an int32 accumulator with a global atomic;
a memset before and a float conversion after).  The script builds them
beside the port's own kernels, checks that both give the plain version's
sketch, then times each cell (``CELLS``: depth 4 at widths 2048 and 8192
over exponents 1.0, 1.2 and 2.0, and depth 8 at width 8192, rows too large
for one block's shared memory) in turns (parent, new, new, parent): CUDA
events around one call, and device time by kernel name over 20 calls
(``chip_smoke.own_device_time``) without and with a 128 MiB L2 flush
between calls.

The A/B of the warp aggregation: the port's kernel (no match: every valid
record adds 1 to its cells) against a copy built with one (``MATCH``:
equal keys of a warp add once, by their leader), in turns, at width 2048
over exponents 1.0, 1.2 and 2.0 and at width 8192 over 1.0 and 2.0.
Then, from copies with block marks alone, when each block of one flushed
call started, had zeroed its rows, ended its loop, stored its cluster's
partial and ended (``TIMELINE_CELLS``).

Then it splits the parent's time by phase, as ``route_ab.py`` does: a copy
of the parent's sources with ``%globaltimer`` stamps at the phase
boundaries (``PARENT_STAMPS``), built in a temporary directory, sums each
warp's time by phase over 20 flushed calls; each phase ends only when its
loads or atomics have returned, so the split says where a warp waits, not
what the kernel overlaps.  The memset and the float conversion are timed by
the profiler as kernels of their own.  Beside the split it prints when each
block reached its marks in one flushed call (start, rows zeroed, loop done,
barrier passed, end) from a copy with the marks alone.

``--sass`` needs no parent: it builds the port's kernels, reads their
SASS with ``cuobjdump``, finds the main loop of ``sketch_rows_kernel`` (the
backward branch whose body holds the most shared atomics) at depth 4 and
8 with a power-of-two width, counts its instructions by the pipe that runs
them (``PIPES``) and prints them a record beside ``chip_smoke.sketch_ops``,
the count the operation bound takes.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc")
PARENT = REPO / "build/sketch_parent"
RECORDS = 10_000_000
KEYS = 1_000_000
# (depth, width, exponent); depth 8 x width 8192 is 256 KiB of rows
CELLS = [(4, 2048, 1.0), (4, 2048, 1.2), (4, 2048, 2.0), (4, 8192, 1.0), (4, 8192, 1.2),
         (4, 8192, 2.0), (8, 8192, 1.2)]
AB_CELLS = [(4, 2048, 1.0), (4, 2048, 1.2), (4, 2048, 2.0), (4, 8192, 1.0), (4, 8192, 2.0)]
SPLIT_CELLS = [(4, 2048, 1.2), (4, 2048, 2.0), (8, 8192, 1.2)]
TIMELINE_CELLS = [(4, 2048, 1.2), (4, 8192, 1.2), (8, 8192, 1.2)]
PARENT_NAMES = ("sketch_count_kernel", "to_float_kernel", "Memset")
PHASES = ("zero rows", "loads", "hash, column and match", "shared atomics",
          "global atomics", "barrier", "flush")
P = {name: i for i, name in enumerate(PHASES)}
MARKS = ("start", "rows zeroed", "loop done", "barrier passed", "end")
NEW_MARKS = ("start", "rows zeroed", "loop done", "partial stored", "end")
SKETCH = "sketch_kernels.cu"
# SASS opcodes by the pipe that runs them on Hopper; an opcode starting with
# U (and S2UR) runs on the uniform datapath; any other is "other"
PIPES = {
    "alu": ("LOP3", "LOP", "SHF", "LEA", "IADD3", "ISETP", "SEL", "PRMT", "IABS", "IMNMX",
            "BMSK", "SGXT", "PLOP3", "MOV", "BREV", "FLO"),
    "fma": ("IMAD", "IMUL", "VIADD", "FFMA", "FMUL", "FADD", "IDP"),
    "memory": ("LDG", "LDS", "STS", "STG", "ATOMS", "ATOM", "ATOMG", "RED", "LD", "ST", "LDC",
               "LDGSTS"),
    "control": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC", "BAR", "NOP"),
}
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)[.A-Z0-9_]*\s*([^;]*);")
# The port's kernel with a warp match on the key: equal keys of a warp add
# once, by their leader (every lane of a warp runs the same iterations, so
# the match sees all 32).
MATCH = [(SKETCH, "      if (on) sketch_add<kDepth, kPow2, kSplit>(key, 1, a, row, d0, d1);\n",
          "      const unsigned live = __ballot_sync(kFull, on);\n"
          "      if (on) {\n"
          "        const unsigned peers = __match_any_sync(live, key);\n"
          "        if (lane == __ffs(peers) - 1)\n"
          "          sketch_add<kDepth, kPow2, kSplit>(key, __popc(peers), a, row, d0, d1);\n"
          "      }\n")]


def _wait_atomic(expr: str) -> str:
    return f"{{ const int r_ = {expr}; stamp_wait(static_cast<unsigned>(r_)); }}"


# The parent's sketch_count_kernel (batch_kernels.cu at cd6bcde) with
# stamps: each atomic returns its old value, which the stamp waits for.
PARENT_STAMPS = [
    ("route_common.cuh", "\n}  // namespace\n", "STAMP_HEADER\n}  // namespace\n"),
    ("batch_kernels.cu", "  extern __shared__ int32_t s_rows[];  // [depth][width] when kShared\n",
     "  extern __shared__ int32_t s_rows[];\n  stamp_begin();\n"),
    ("batch_kernels.cu",
     "    for (int c = threadIdx.x; c < cells; c += kThreads) s_rows[c] = 0;\n"
     "    __syncthreads();\n  }\n",
     "    for (int c = threadIdx.x; c < cells; c += kThreads) s_rows[c] = 0;\n"
     f"    __syncthreads();\n  }}\n  stamp({P['zero rows']});\n  stamp_mark(1);\n"),
    ("batch_kernels.cu",
     "    const uint32_t key = on ? static_cast<uint32_t>(keys[row + i]) : 0u;\n",
     "    const uint32_t key = on ? static_cast<uint32_t>(keys[row + i]) : 0u;\n"
     f"    stamp_wait(key ^ on);\n    stamp({P['loads']});\n"),
    ("batch_kernels.cu", "      const unsigned peers = __match_any_sync(kFull, col);\n",
     "      const unsigned peers = __match_any_sync(kFull, col);\n"
     f"      stamp({P['hash, column and match']});\n"),
    ("batch_kernels.cu", "        atomicAdd(cell, __popc(peers));\n      }\n",
     "        " + _wait_atomic("atomicAdd(cell, __popc(peers))") + "\n      }\n"
     f"      stamp(kShared ? {P['shared atomics']} : {P['global atomics']});\n"),
    ("batch_kernels.cu", "  if (kShared) {\n    __syncthreads();\n",
     f"  stamp_mark(2);\n  if (kShared) {{\n    __syncthreads();\n    stamp({P['barrier']});\n"
     "    stamp_mark(3);\n    unsigned sink_ = 0;\n"),
    ("batch_kernels.cu",
     "      if (s_rows[c]) atomicAdd(rows + c, s_rows[c]);\n  }\n}\n",
     "      if (s_rows[c]) sink_ ^= atomicAdd(rows + c, s_rows[c]);\n"
     f"    stamp_wait(sink_);\n    stamp({P['flush']});\n  }}\n  stamp_end();\n}}\n"),
]
PARENT_MARKS = [
    ("route_common.cuh", "\n}  // namespace\n", "STAMP_HEADER\n}  // namespace\n"),
    ("batch_kernels.cu", "  extern __shared__ int32_t s_rows[];  // [depth][width] when kShared\n",
     "  extern __shared__ int32_t s_rows[];\n  stamp_mark(0);\n"),
    ("batch_kernels.cu",
     "    for (int c = threadIdx.x; c < cells; c += kThreads) s_rows[c] = 0;\n"
     "    __syncthreads();\n  }\n",
     "    for (int c = threadIdx.x; c < cells; c += kThreads) s_rows[c] = 0;\n"
     "    __syncthreads();\n  }\n  stamp_mark(1);\n"),
    ("batch_kernels.cu", "  if (kShared) {\n    __syncthreads();\n",
     "  stamp_mark(2);\n  if (kShared) {\n    __syncthreads();\n    stamp_mark(3);\n"),
    ("batch_kernels.cu",
     "      if (s_rows[c]) atomicAdd(rows + c, s_rows[c]);\n  }\n}\n",
     "      if (s_rows[c]) atomicAdd(rows + c, s_rows[c]);\n  }\n  __syncthreads();\n"
     "  stamp_mark(4);\n}\n"),
]


# The port's kernel with block marks alone (a block that is not the last
# of its eighth marks its end where it leaves).
NEW_MARK_EDITS = [
    ("route_common.cuh", "\n}  // namespace\n", "STAMP_HEADER\n}  // namespace\n"),
    (SKETCH, "  cg::cluster_group cluster = cg::this_cluster();\n",
     "  cg::cluster_group cluster = cg::this_cluster();\n  stamp_mark(0);\n"),
    (SKETCH, "(d - d0) * a.stride;\n  __syncthreads();\n",
     "(d - d0) * a.stride;\n  __syncthreads();\n  stamp_mark(1);\n"),
    (SKETCH, "  // the head and the tail, under 4 records each",
     "  stamp_mark(2);\n  // the head and the tail, under 4 records each"),
    (SKETCH, "  cluster.sync();   // and no block leaves while another reads its rows\n",
     "  cluster.sync();   // and no block leaves while another reads its rows\n"
     "  stamp_mark(3);\n"),
    (SKETCH, "  if (!s_last) return;\n",
     "  if (!s_last) {\n    stamp_mark(4);\n    return;\n  }\n"),
    (SKETCH, "static_cast<float>(e[j]);\n    }\n  }\n}\n",
     "static_cast<float>(e[j]);\n    }\n  }\n  __syncthreads();\n  stamp_mark(4);\n}\n"),
]


def _edits(edits):
    """``edits`` with the stamp header of route_ab.py put in."""
    import route_ab

    return [(f, old, new.replace("STAMP_HEADER", route_ab.STAMP_HEADER)) for f, old, new in edits]


def parent_lib(path: Path):
    """The parent's library at ``path``, with its C signature for
    bk_sketch_update (keys valid W n depth width | acc out | stream)."""
    import route_ab

    lib = route_ab.load(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bk_sketch_update.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.bk_sketch_update.restype = i
    return lib


def parent_call(lib, keys, valid, depth, width):
    """A call of the parent's wrapper on ``lib``: ``() -> float32[W, depth,
    width]`` (or ``[depth, width]`` for one row of keys)."""
    k2 = keys if keys.dim() == 2 else keys.unsqueeze(0)
    w, n = k2.shape

    def call():
        acc = torch.empty((w, depth, width), dtype=torch.int32, device=keys.device)
        out = torch.empty((w, depth, width), dtype=torch.float32, device=keys.device)
        code = lib.bk_sketch_update(k2.data_ptr(), valid.data_ptr(), w, n, depth, width,
                                    acc.data_ptr(), out.data_ptr(),
                                    torch.cuda.current_stream(keys.device).cuda_stream)
        assert code == 0, code
        return out if keys.dim() == 2 else out[0]
    return call


def time_turns(label, calls, names, flush, order):
    """Times each of ``calls`` in the turns ``order``: events around one
    call, device time unflushed and flushed; returns the means by name."""
    import chip_smoke as cs

    seen = {k: [] for k in calls}
    for which in order:
        ms = cs.cuda_ms(calls[which])
        warm, _, _ = cs.own_device_time(calls[which], names[which])
        cold, by, ops = cs.own_device_time(calls[which], names[which], flush=flush)
        seen[which].append((ms, warm, cold, by))
        print(f"{label} {which}: events {ms:.4f} ms; device {warm:.4f} ms unflushed, "
              f"{cold:.4f} ms flushed ({ops:g} device operations a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in by.items()) + ")", flush=True)
    means = {}
    for which, rows in seen.items():
        mean = [statistics.mean(r[i] for r in rows) for i in range(3)]
        by = {k: statistics.mean(r[3][k] for r in rows) for k in rows[0][3]}
        means[which] = (*mean, by)
        print(f"{label} {which}, mean of {len(rows)}: events {mean[0]:.4f} ms, device "
              f"{mean[1]:.4f} ms unflushed, {mean[2]:.4f} ms flushed", flush=True)
    return means


def pipe_of(op: str) -> str:
    if op.startswith("U") or op == "S2UR":
        return "uniform"
    return next((pipe for pipe, ops in PIPES.items() if op in ops), "other")


def loop_counts(sass: str, kernel: str) -> tuple[int, dict, dict]:
    """The main loop of the function whose name holds ``kernel`` in
    cuobjdump's ``sass``: ``(shared atomics in it, instructions by pipe,
    by opcode)``, every branch of its body counted once."""
    body = sass.split(kernel, 1)[1].split("Function :", 1)[0]
    code = [(int(m[1], 16), m[2], m[3]) for m in SASS_LINE.finditer(body)]
    best = (0, 0, 0)
    for i, (_, op, args) in enumerate(code):
        target = re.match(r"\s*(?:`\()?0x([0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target[1], 16) <= code[i][0]:
            lo = next(j for j, c in enumerate(code) if c[0] == int(target[1], 16))
            atoms = sum(c[1] == "ATOMS" for c in code[lo:i + 1])
            best = max(best, (atoms, lo, i + 1))
    ops: dict[str, int] = {}
    for _, op, _ in code[best[1]:best[2]]:
        ops[op] = ops.get(op, 0) + 1
    pipes: dict[str, int] = {}
    for op, k in ops.items():
        pipes[pipe_of(op)] = pipes.get(pipe_of(op), 0) + k
    return best[0], pipes, ops


def sass_main() -> int:
    """Prints the main loop's instructions by pipe at depth 4 and 8 (a
    power-of-two width) beside chip_smoke.sketch_ops."""
    import chip_smoke as cs
    from repro_torch.kernels import build

    lib = build.library()
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    print(cs.card_line(), flush=True)
    for depth, split in ((4, False), (8, False), (8, True)):
        kernel = f"sketch_rows_kernelILi{depth}ELb1ELb{int(split)}E"
        atoms, pipes, ops = loop_counts(sass, kernel)
        records = atoms // depth  # one atomic a valid record-row
        want = cs.sketch_ops(records, records, depth)
        print(f"sass {kernel}: main loop, {records} records an iteration, every one valid: "
              + ", ".join(f"{pipe} {k} ({k / records:g} a record)"
                          for pipe, k in sorted(pipes.items()))
              + f"; sketch_ops a record: alu {want['alu'] / records:g}, fma "
              f"{want['fma'] / records:g}; opcodes: "
              + ", ".join(f"{op} {k}" for op, k in sorted(ops.items())), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--sass"]:
        sys.path.insert(0, str(REPO / "src"))
        sys.path.insert(0, str(REPO))
        return sass_main()
    if not torch.cuda.is_available():
        print("sketch_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (PARENT / CSRC).is_dir():
        print(f"sketch_ab: {PARENT / CSRC} is missing (see the docstring)", file=sys.stderr)
        return 2
    parent_only = sys.argv[1:] == ["--parent"]
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import route_ab
    from repro_torch.data.generators import zipf_keys
    from repro_torch.kernels import build
    from repro_torch.kernels.sketch_update import sketch_update, sketch_update_plain

    dev = torch.device("cuda")
    nvcc = build.nvcc_path()
    with tempfile.TemporaryDirectory(prefix="sketch_ab_") as tmp:
        tmp = Path(tmp)
        jobs = {"parent": route_ab.nvcc_lib(nvcc, [PARENT / CSRC / "batch_kernels.cu"],
                                            tmp / "libparent.so")}
        for kind, edits in (("stamped", PARENT_STAMPS), ("marked", PARENT_MARKS)):
            route_ab.stamped_copy(PARENT / CSRC, _edits(edits), tmp / f"{kind}_parent")
            jobs[f"parent {kind}"] = route_ab.nvcc_lib(
                nvcc, [tmp / f"{kind}_parent" / "batch_kernels.cu"],
                tmp / f"lib_{kind}_parent.so")
        if not parent_only:
            for kind, edits in (("match", MATCH), ("marked", NEW_MARK_EDITS)):
                route_ab.stamped_copy(REPO / CSRC, _edits(edits), tmp / f"{kind}_new")
                with open(tmp / f"{kind}_new" / SKETCH, "a") as f:
                    f.write(route_ab.STAMP_ENTRY if kind == "marked" else "")
                jobs[f"new {kind}"] = route_ab.nvcc_lib(nvcc, [tmp / f"{kind}_new" / SKETCH],
                                                        tmp / f"lib_{kind}_new.so")
            build.library()
        for label, proc in jobs.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {label}:\n{err}")
        parent = parent_lib(tmp / "libparent.so")
        stamped = parent_lib(tmp / "lib_stamped_parent.so")
        marked = parent_lib(tmp / "lib_marked_parent.so")
        res = ctypes.c_ulonglong()
        assert stamped.stamp_resolution(ctypes.byref(res)) == 0
        card = cs.card_line()
        print(card, flush=True)
        print(f"%globaltimer step on this card: {res.value} ns", flush=True)

        keys = {e: torch.as_tensor(zipf_keys(RECORDS, num_keys=KEYS, exponent=e,
                                             seed=int(e * 10)).astype(np.int32), device=dev)
                for e in sorted({c[2] for c in CELLS})}
        ones = torch.ones(RECORDS, dtype=torch.bool, device=dev)
        flush = cs.l2_flush(dev)
        names = {"parent": PARENT_NAMES, "new": cs.DEVICE_NAMES["sketch_update"]}
        results = {}
        for depth, width, e in CELLS:
            label = f"depth {depth} width {width} exponent {e}"
            calls = {"parent": parent_call(parent, keys[e], ones, depth, width)}
            if not parent_only:
                calls["new"] = lambda k=keys[e], d=depth, w=width: sketch_update(
                    k, ones, depth=d, width=w)
            want = sketch_update_plain(keys[e], ones, depth=depth, width=width)
            for which, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                assert torch.equal(got, want), (label, which)
            hot = int(torch.unique(keys[e], return_counts=True)[1].max())
            print(f"{label}: {', '.join(calls)} equal the plain version (largest cell "
                  f"{float(want.max()):.0f}; the hottest key {hot} records)", flush=True)
            del want, got
            order = ("parent",) * 2 if parent_only else ("parent", "new", "new", "parent")
            results[depth, width, e] = time_turns(label, calls, names, flush, order)
            bytes_ms = (RECORDS * 5 + depth * width * 4) / cs.HBM_BYTES_PER_S * 1e3
            ops_ms = cs.ops_ms(cs.sketch_ops(RECORDS, RECORDS, depth))
            print(f"{label}: bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f} ms, "
                  f"integer operations {ops_ms:.4f} ms); flushed device time "
                  + ", ".join(f"{k} {v[2]:.4f} ms ({100 * max(bytes_ms, ops_ms) / v[2]:.1f}%)"
                              for k, v in results[depth, width, e].items()), flush=True)

        if not parent_only:
            match = route_ab.load(tmp / "lib_match_new.so")
            names["match"] = names["new"]
            for depth, width, e in AB_CELLS:
                label = f"A/B depth {depth} width {width} exponent {e}"
                kernel = lambda k=keys[e], d=depth, w=width: sketch_update(  # noqa: E731
                    k, ones, depth=d, width=w)
                calls = {"new": kernel, "match": route_ab.through(match, kernel)}
                assert torch.equal(calls["match"](), calls["new"]())
                time_turns(label, calls, names, flush, ("new", "match", "match", "new"))
            marked_new = route_ab.load(tmp / "lib_marked_new.so")
            for depth, width, e in TIMELINE_CELLS:
                fn = lambda k=keys[e], d=depth, w=width: sketch_update(  # noqa: E731
                    k, ones, depth=d, width=w)
                cold, _, _ = cs.own_device_time(route_ab.through(marked_new, fn), names["new"],
                                                flush=flush)
                print(f"new timeline at depth {depth} width {width} exponent {e}, copy with "
                      f"block marks alone ({cold:.4f} ms flushed): "
                      f"{route_ab.timeline(marked_new, fn, flush, NEW_MARKS)}", flush=True)
            print(card, flush=True)

        for depth, width, e in SPLIT_CELLS:
            fn = parent_call(stamped, keys[e], ones, depth, width)
            acc, warps = route_ab.split(stamped, fn, flush)
            cold, _, _ = cs.own_device_time(fn, PARENT_NAMES, flush=flush)
            base_ms, by = results[depth, width, e]["parent"][2:]
            kernel_ms = by.get("sketch_count_kernel", base_ms)
            total = sum(acc)
            parts = [f"{PHASES[p]} {100 * v / total:.1f}% ({v / total * kernel_ms:.4f} ms)"
                     for p, v in enumerate(acc) if v]
            rest = ", ".join(f"{k} {v:.4f} ms" for k, v in by.items()
                             if k != "sketch_count_kernel")
            print(f"parent split at depth {depth} width {width} exponent {e} ({warps // 20} "
                  f"warps a call; stamped copy {cold:.4f} ms flushed, unstamped "
                  f"{base_ms:.4f} ms of which sketch_count_kernel {kernel_ms:.4f} ms, {rest}): "
                  + ", ".join(parts), flush=True)
            mfn = parent_call(marked, keys[e], ones, depth, width)
            cold, _, _ = cs.own_device_time(mfn, PARENT_NAMES, flush=flush)
            print(f"parent timeline at depth {depth} width {width} exponent {e}, copy with "
                  f"block marks alone ({cold:.4f} ms flushed): "
                  f"{route_ab.timeline(marked, mfn, flush, MARKS)}", flush=True)
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
