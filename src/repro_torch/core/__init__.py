"""Dynamic Repartitioning core: hashing, histograms, partitioners, keyed
state, migration planning, the shuffle, the streaming job and the batch
replay.

The batch path's names are exported here (``from repro_torch.core import
BatchJob``); they load on first use, because the kernel wrappers they reach
import ``repro_torch.core.hashing`` themselves.
"""
import importlib

_EXPORTS = {
    "BatchJob": "repro_torch.core.replay",
    "BatchResult": "repro_torch.core.replay",
    "CountMinSketch": "repro_torch.core.histogram",
    "replay_partition": "repro_torch.core.replay",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
