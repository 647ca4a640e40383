"""Hand-written CUDA kernels for the port, each beside its plain PyTorch
version (:mod:`repro_torch.kernels.ref`).

* :mod:`~repro_torch.kernels.lookup_dispatch` — partition lookup + lane slot.
* :mod:`~repro_torch.kernels.route_bucketize` — the same plus the scatter
  into the send buffers.
* :mod:`~repro_torch.kernels.partition_apply` — partition lookup alone (the
  batch replay's pass).
* :mod:`~repro_torch.kernels.dispatch_count` — stable rank within a given
  destination + counts.
* :mod:`~repro_torch.kernels.sketch_update` — the count-min sketch.
* :mod:`~repro_torch.kernels.ops` — the padding/sentinel wrappers the
  exchange plane and the batch replay call.
* :mod:`~repro_torch.kernels.build` — compiles ``csrc/*.cu`` at first use.

The batch path's public wrappers are exported here and load on first use
(``ops`` imports ``repro_torch.core``, which reaches back into this
package).  Each kernel's own wrapper shares its module's name, so it is
imported from that module.
"""
import importlib

_EXPORTS = {
    "apply_partitioner": "repro_torch.kernels.ops",
    "count_sketch": "repro_torch.kernels.ops",
    "dispatch_slots": "repro_torch.kernels.ops",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
