"""Fault-tolerant checkpointing: atomic npz + manifest, keep-last-k (a port
of ``repro.train.checkpoint``, in its on-disk format).

Layout::

    <dir>/step_000000123/
        arrays.npz        the flattened tree (keys joined by "/")
        manifest.json     step, keys, adler32 checksums

Writes go to ``<dir>/.tmp_<step>`` then ``os.rename``, so a crash
mid-write never corrupts the latest checkpoint; ``restore`` verifies the
checksums and falls back to the newest intact checkpoint.

A leaf may be a tensor (on any device) or a numpy array.  A bf16 tensor is
stored as the reference stores a bf16 array (2-byte ``V2`` records holding
the bf16 bits), so a directory written by either package restores in the
other for the same flat tree; ``restore`` turns each array into the
like-leaf's type, dtype and device.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["latest_step", "restore", "save"]

SEP = "/"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(x)


def _from_numpy(a: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return a
    a = np.array(a, order="C")  # a writable copy; keeps a 0-d array 0-d
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind in "Vui":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip(SEP)] = _to_numpy(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray], like: Any, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}{SEP}") for k, v in like.items()}
    if isinstance(like, tuple):
        vals = [_unflatten(flat, v, f"{prefix}{i}{SEP}") for i, v in enumerate(like)]
        return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)
    if isinstance(like, list):
        return [_unflatten(flat, v, f"{prefix}{i}{SEP}") for i, v in enumerate(like)]
    if like is None:
        return None
    return _from_numpy(flat[prefix.rstrip(SEP)], like)


def save(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    tmp = os.path.join(directory, f".tmp_{step}")
    final = os.path.join(directory, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "checksums": {k: zlib.adler32(np.ascontiguousarray(v).tobytes()) for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def _intact(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k, want in manifest["checksums"].items():
                got = zlib.adler32(np.ascontiguousarray(z[k]).tobytes())
                if got != want:
                    return False
        return True
    except Exception:
        return False


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")
    )
    return steps[-1] if steps else None


def restore(directory: str, like: Any) -> tuple[int, Any] | None:
    """Restore the newest *intact* checkpoint (corrupted ones are skipped)
    in the structure, types and devices of ``like``."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        (d for d in os.listdir(directory) if d.startswith("step_")), reverse=True
    )
    for d in steps:
        path = os.path.join(directory, d)
        if not _intact(path):
            continue
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "manifest.json")) as f:
            step = json.load(f)["step"]
        return step, _unflatten(flat, like)
    return None
