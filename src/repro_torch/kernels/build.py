"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source to an object, all at once in parallel, and
links them into a shared library with a plain C interface under
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources and headers (``csrc/*.cuh``) so an edited kernel or header is
rebuilt; ``ctypes`` loads it.  Each source compiles with ``-Xptxas -v``,
and what ptxas printed (registers, spills, serialised wgmma) is kept beside
the library, one ``<library>.<source>.ptxas.txt`` a source, for
:func:`ptxas_report`.  Nothing here runs at import: the CPU tests import
every module on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_dir", "check", "library", "library_path", "nvcc_path", "parse_ptxas",
           "ptxas_report", "require_cuda", "sources"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO = Path(__file__).resolve().parents[3]
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_int64
_LP = ctypes.POINTER(ctypes.c_int64)

_SIGNATURES = {
    # kernel (0 lookup_dispatch, 1 route_bucketize, 2 dispatch_count) | W n L
    "rk_tile_records": ([_I], _I),
    # B -> slots of the heavy-key probe table (0: the binary search)
    "rk_probe_slots": ([_I], _I),
    "rk_scratch_words": ([_I, _I, _I, _I], _L),
    "rk_error_string": ([_I], ctypes.c_char_p),
    # keys valid W n | hk hp hr B | h2p H seed_mix | L N part_loads |
    # part slot counts scratch | stream
    "rk_lookup_dispatch": ([_P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _U, _I, _I, _P,
                            _P, _P, _P, _P, _P], _I),
    # keys valid vals D W n | hk hp hr B | h2p H seed_mix | L N part_loads cap
    # key_fill | part slot counts scratch | buf_valid buf_keys buf_vals buf_part |
    # stream
    "rk_route_bucketize": ([_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _U,
                            _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    # keys total | hk hp B | h2p H seed_mix | part | stream
    "bk_partition_apply": ([_P, _L, _P, _P, _I, _P, _I, _U, _P, _P], _I),
    # dest valid W n N | slot counts scratch | stream
    "bk_dispatch_count": ([_P, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    # keys valid W n depth width | magic clusters split | scratch out | stream
    "bk_sketch_update": ([_P, _P, _I, _I, _I, _I, ctypes.c_uint64, _I, _I, _P, _P, _P], _I),
    # clusters of sketch blocks that fit on the card at once (< 0: -error)
    "bk_sketch_clusters": ([], _I),
    # q k v o lse ls | B G P Sq Sk hd dtype p_bf16 | causal window q_offset
    # scale | q k v o strides | stream
    "fa_flash_forward": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, ctypes.c_float, _LP, _LP, _LP, _LP, _P], _I),
    # q k v o dout dq dk dv lse dsum part | B G P Sq Sk hd dtype causal
    # window q_offset scale | ls have_lse nsplit | q k v o dout dq dk dv
    # strides | stream
    "fa_flash_backward": ([_P] * 11 + [_I] * 10 + [ctypes.c_float, _L, _I, _I] + [_LP] * 8
                          + [_P], _I),
}

_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def build_dir() -> Path:
    return _REPO / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH`` or
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once and return their standard errors; raise
    with the first failure's errors."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    fails, errs = [], []
    for proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            fails.append(f"nvcc failed ({proc.returncode}):\n{err}")
    if fails:
        raise RuntimeError("\n".join(fails))
    return errs


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.tmp"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    objs = [out.with_name(f"{src.stem}{tag}.o") for src in sources()]
    try:
        errs = _run_all([[nvcc_path(), *flags, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(sources(), objs)])
        for src, err in zip(sources(), errs):
            _ptxas_path(out, src.stem).write_text(err)
        tmp = out.with_name(out.name + tag)
        _run_all([[nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def library_path() -> Path:
    """Where the library for the current sources lives: named by a hash of
    every source and header (``csrc/*.cu``, ``csrc/*.cuh``), so an edit to
    any of them, a shared header included, builds every source anew."""
    digest = hashlib.sha256(b"".join(
        p.name.encode() + p.read_bytes() for p in sorted(_CSRC.glob("*.cu*")))).hexdigest()
    return build_dir() / f"librepro_torch_kernels_{digest[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first call in this process."""
    global _lib, _lib_path
    if _lib is None:
        path = library_path()
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib, _lib_path = lib, path
    return _lib


def _ptxas_path(lib: Path, stem: str) -> Path:
    return lib.with_name(f"{lib.name}.{stem}.ptxas.txt")


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier in a mangled name and its template
    arguments as mangled (``flash_bwd_dq_wgmma_kernelILi4EE``): one key a
    template instance.  An identifier is mangled after its length, which
    may follow other digits (a namespace's hash), so every suffix of a
    digit run is tried as that length."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[i:m.end()])]
            if name.endswith("_kernel") and name.isidentifier():
                args = re.match(r"I\w*?E(?=E?v)", mangled[m.end() + len(name):])
                return name + (args.group(0) if args else "")
    return mangled


def parse_ptxas(text: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` (spills in
    bytes) from ``nvcc -Xptxas -v`` output, each kernel named by
    :func:`_kernel_name`, plus ``"warnings"``: the lines
    that report a serialised wgmma."""
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    out["warnings"] = [line.strip() for line in text.splitlines()
                       if "C7512" in line or "serialized" in line]
    return out


def ptxas_report(stem: str) -> dict:
    """:func:`parse_ptxas` of the loaded library's build of ``csrc/<stem>.cu``
    (registers and spills by kernel); the library must be loaded, and must
    have been built by this repository's :func:`library` (which keeps what
    ptxas printed)."""
    if _lib_path is None:
        raise RuntimeError("ptxas_report: load the library first (build.library())")
    path = _ptxas_path(_lib_path, stem)
    if not path.is_file():
        raise RuntimeError(f"ptxas_report: no ptxas output at {path}; remove the library to "
                           "rebuild it")
    return parse_ptxas(path.read_text())


def check(code: int, what: str) -> None:
    """Raise when a launch sequence returned a CUDA error code."""
    if code != 0:
        msg = library().rk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require_cuda(what: str, *tensors) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous tensor on
    one CUDA device (the kernels take nothing else)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} input: tensor on {dev}; the kernel path takes CUDA "
                         "tensors only")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what} input: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} input: tensors must be contiguous")
