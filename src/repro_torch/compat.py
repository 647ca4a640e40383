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

On the card a fetch waits for everything queued on the stream, so the
overlapped driver never fetches a start phase's outputs directly: it
copies them into pinned host memory without blocking
(:func:`copy_to_host`), queues the ship and merge behind the copies, and
waits on the copies' event alone (:func:`host_wait`, counted like a fetch
when it blocks outside a safe point).  :func:`to_device` is the matching
upload: pinned and non-blocking on the card, so it never waits for the
stream either.

:func:`overlap_enabled` reads the reference's ``REPRO_DISABLE_OVERLAP``
switch; the serving scheduler reports it at each checkpoint.
:func:`has_ragged_all_to_all` reads its ``REPRO_DISABLE_NATIVE_RAGGED``
switch: the process-group transport (:mod:`repro_torch.exchange.dist`)
ships the ragged exchange's counted rows through the uneven
``all_to_all_single`` unless the switch forces the masked dense ship, which
gives the same receive tensors bit for bit.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

__all__ = [
    "copy_to_host",
    "has_ragged_all_to_all",
    "host_fetch",
    "host_sync_count",
    "host_wait",
    "overlap_enabled",
    "reset_host_sync_count",
    "resolve_device",
    "safe_point",
    "to_device",
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


def reset_host_sync_count() -> None:
    """Zero the counter (call it before a measured segment)."""
    _sync_state["count"] = 0


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


def has_ragged_all_to_all() -> bool:
    """True unless ``REPRO_DISABLE_NATIVE_RAGGED`` forces the ragged
    exchange's masked dense ship (``0``/``false``/unset leave the native
    uneven collective on), as the reference's switch.  ``torch.distributed``
    always has the uneven ``all_to_all_single``; stacked workers never ship
    natively (their exchange is a transpose on one device)."""
    disabled = os.environ.get("REPRO_DISABLE_NATIVE_RAGGED", "")
    return disabled.lower() in ("", "0", "false")


def copy_to_host(tensors):
    """``(host copies, event)`` of a tuple of tensors, without blocking.

    Tensors on the card are copied into pinned host tensors with
    ``non_blocking=True`` on the current stream, and an event is recorded
    after the copies: read the copies only after :func:`host_wait` on it.
    CPU tensors come back as they are, with no event.  A named tuple keeps
    its type."""
    if not any(isinstance(t, torch.Tensor) and t.device.type != "cpu" for t in tensors):
        return tensors, None
    out = []
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        out.append(t)
    event = torch.cuda.Event()
    event.record()
    out = type(tensors)(*out) if hasattr(tensors, "_fields") else type(tensors)(out)
    return out, event


def host_wait(event) -> None:
    """Block until ``event`` (from :func:`copy_to_host` or an upload) has
    completed; ``None`` returns at once.  A wait that has to block outside
    a :func:`safe_point` region counts as a host sync, as a fetch does."""
    if event is None:
        return
    if not event.query():
        if _sync_state["depth"] == 0:
            _sync_state["count"] += 1
        event.synchronize()


def to_device(array, device, dtype=None) -> torch.Tensor:
    """``array`` (numpy or a CPU tensor) as a tensor on ``device``.  On the
    card the upload goes through pinned memory with ``non_blocking=True``:
    a pageable upload would wait for the whole stream.  The pinned block is
    the caching host allocator's, which keeps it until the copy is done."""
    t = torch.as_tensor(array, dtype=dtype)
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.contiguous().pin_memory().to(device, non_blocking=True)
