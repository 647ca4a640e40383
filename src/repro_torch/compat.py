"""Runtime helpers shared by the port: device resolution and the host-sync
audit.

``resolve_device`` is the one place an entry point turns its ``device``
argument into a ``torch.device``: ``None`` means the card, and a card that
is absent is an error, never a silent fall back to the CPU.

Host-sync instrumentation (``host_fetch`` / ``safe_point`` /
``host_sync_count``) mirrors the reference's: the streaming driver routes
its device->host conversions through :func:`host_fetch`, which counts
fetches of tensors that live off the CPU made outside a
``with safe_point():`` region.

:func:`overlap_enabled` reads the reference's ``REPRO_DISABLE_OVERLAP``
switch; the serving scheduler reports it at each checkpoint.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

__all__ = [
    "host_fetch",
    "host_sync_count",
    "overlap_enabled",
    "resolve_device",
    "safe_point",
]

_sync_state = {"count": 0, "depth": 0}


def resolve_device(device) -> torch.device:
    """``None`` -> ``cuda``; raises when the requested card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch targets the CUDA device by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def host_sync_count() -> int:
    """Device->host fetches observed *outside* safe-point regions."""
    return _sync_state["count"]


@contextlib.contextmanager
def safe_point():
    """Mark a region where blocking device->host fetches are sanctioned."""
    _sync_state["depth"] += 1
    try:
        yield
    finally:
        _sync_state["depth"] -= 1


def host_fetch(x):
    """``numpy`` view of ``x`` that audits device->host transfers.

    A tensor on the card fetched outside a :func:`safe_point` region counts
    as a blocking sync; CPU tensors and host values pass through uncounted.
    """
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" and _sync_state["depth"] == 0:
            _sync_state["count"] += 1
        return x.detach().cpu().numpy()
    return np.asarray(x)


def overlap_enabled() -> bool:
    """True unless ``REPRO_DISABLE_OVERLAP`` forces the serial exchange path
    (``0``/``false``/unset leave the overlap on), as the reference's."""
    disabled = os.environ.get("REPRO_DISABLE_OVERLAP", "")
    return disabled.lower() in ("", "0", "false")
