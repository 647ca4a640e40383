"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source to an object, all at once in parallel, and
links them into a shared library with a plain C interface under
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources and headers (``csrc/*.cuh``) so an edited kernel or header is
rebuilt; ``ctypes`` loads it.  Nothing here runs at import: the CPU tests
import every module on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_dir", "check", "library", "nvcc_path", "require_cuda", "sources"]

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
    # q k v o | B G P Sq Sk hd dtype p_bf16 | causal window q_offset scale |
    # q k v o strides | stream
    "fa_flash_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          ctypes.c_float, _LP, _LP, _LP, _LP, _P], _I),
    # q k v o dout dq dk dv lse dsum | B G P Sq Sk hd dtype causal window
    # q_offset scale | q k v o dout dq dk dv strides | stream
    "fa_flash_backward": ([_P] * 10 + [_I] * 10 + [ctypes.c_float] + [_LP] * 8 + [_P], _I),
}

_lib: ctypes.CDLL | None = None


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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the first failure's errors."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    fails = []
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            fails.append(f"nvcc failed ({proc.returncode}):\n{err}")
    if fails:
        raise RuntimeError("\n".join(fails))


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.tmp"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    objs = [out.with_name(f"{src.stem}{tag}.o") for src in sources()]
    try:
        _run_all([[nvcc_path(), *flags, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)])
        tmp = out.with_name(out.name + tag)
        _run_all([[nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first call in this process."""
    global _lib
    if _lib is None:
        digest = hashlib.sha256(b"".join(  # sources and headers (*.cu, *.cuh)
            p.name.encode() + p.read_bytes() for p in sorted(_CSRC.glob("*.cu*")))).hexdigest()
        path = build_dir() / f"librepro_torch_kernels_{digest[:16]}.so"
        if not path.is_file():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
    return _lib


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
