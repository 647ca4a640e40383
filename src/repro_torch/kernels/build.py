"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles the sources into a shared library with a plain C
interface under ``build/repro_torch_kernels/`` at the repository root, named
by a hash of the sources so an edited kernel is rebuilt; ``ctypes`` loads
it.  Nothing here runs at import: the CPU tests import every module on a
machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_dir", "check", "library", "nvcc_path", "sources"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO = Path(__file__).resolve().parents[3]
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32

_SIGNATURES = {
    "rk_block_records": ([], _I),
    "rk_error_string": ([_I], ctypes.c_char_p),
    # keys valid W n | hk hp hr B | h2p H seed_mix | L N | part slot counts scratch | stream
    "rk_lookup_dispatch": ([_P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _U, _I, _I,
                            _P, _P, _P, _P, _P], _I),
    # keys valid vals D W n | hk hp hr B | h2p H seed_mix | L N cap key_fill |
    # part slot counts scratch | buf_valid buf_keys buf_vals buf_part | stream
    "rk_route_bucketize": ([_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _U,
                            _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
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


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first call in this process."""
    global _lib
    if _lib is None:
        digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources())).hexdigest()
        path = build_dir() / f"libroute_kernels_{digest[:16]}.so"
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
