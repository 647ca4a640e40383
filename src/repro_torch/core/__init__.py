"""Dynamic Repartitioning core: hashing, histograms, partitioners, keyed
state, migration planning, the shuffle, the streaming job and the batch
replay.

The batch path's names and the paper's baselines are exported here
(``from repro_torch.core import BatchJob, make_baseline``); they load on
first use, because the kernel wrappers the batch path reaches import
``repro_torch.core.hashing`` themselves.
"""
import importlib

_EXPORTS = {
    "BatchJob": "repro_torch.core.replay",
    "BatchResult": "repro_torch.core.replay",
    "CountMinSketch": "repro_torch.core.histogram",
    "LossyCounting": "repro_torch.core.histogram",
    "SpaceSaving": "repro_torch.core.histogram",
    "make_baseline": "repro_torch.core.baselines",
    "mixed_update": "repro_torch.core.baselines",
    "readj_update": "repro_torch.core.baselines",
    "redist_update": "repro_torch.core.baselines",
    "replay_partition": "repro_torch.core.replay",
    "scan_update": "repro_torch.core.baselines",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
