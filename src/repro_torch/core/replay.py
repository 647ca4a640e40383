"""Batch-mode replay: repartition while data is still in the mapper buffers.

In a batch job the paper intervenes early: mapper output is buffered, a
histogram is taken over the first fraction of the input, KIPUPDATE builds a
better partitioner, and the *buffered* records are re-assigned (replayed)
before the shuffle — so the cost is one extra partition-assignment pass over
the buffer, not a re-execution of the mappers.

``replay_partition`` is that pass; :class:`BatchJob` drives measure -> update
-> replay -> shuffle for a static dataset.  The planning (prefix histogram,
``kip_update``) runs on the host as in ``repro.core.replay``; the passes over
the whole buffer run on the device through the ``partition_apply`` kernel
(:func:`repro_torch.kernels.ops.apply_partitioner`), which keeps the
buffered keys and their assignments where the shuffle reads them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.drm import DRConfig
from repro_torch.core.histogram import Histogram
from repro_torch.core.partitioner import Partitioner, kip_update, uniform_partitioner
from repro_torch.kernels import ops

__all__ = ["BatchJob", "BatchResult", "replay_partition"]


def replay_partition(partitioner: Partitioner, buffered_keys: torch.Tensor) -> torch.Tensor:
    """Re-assign buffered mapper output under a new partitioner (the
    replay): ``int32`` partition ids on the buffer's device."""
    return ops.apply_partitioner(buffered_keys, partitioner.tables(buffered_keys.device),
                                 num_hosts=partitioner.num_hosts, seed=partitioner.seed)


def _imbalance(parts: torch.Tensor, num_partitions: int) -> float:
    """``max(load) / mean(load)``: loads counted on the device as integers,
    the ratio taken on the host with ``load_imbalance``'s float64 formula."""
    loads = torch.bincount(parts, minlength=num_partitions).cpu().numpy().astype(np.int64)
    return float(loads.max() / max(loads.mean(), 1e-12))


@dataclasses.dataclass(frozen=True)
class BatchResult:
    partitioner: Partitioner
    assignments: torch.Tensor  # int32[n] on the job's device
    imbalance_before: float
    imbalance_after: float
    replayed_records: int
    sample_fraction: float


class BatchJob:
    """Static-dataset job: measure a small prefix, repartition once, replay.

    ``sample_fraction`` mirrors "a batch job is repartitioned only in an
    early stage of the execution so that the cost of replay does not exceed
    the expected gains".  ``device=None`` means the CUDA card (and raises
    without one); ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, num_partitions: int, sample_fraction: float = 0.1,
                 dr: DRConfig | None = None, seed: int = 0, device=None):
        self.num_partitions = num_partitions
        self.sample_fraction = sample_fraction
        self.cfg = dr or DRConfig(mode="batch")
        self.seed = seed
        self.device = resolve_device(device)

    def run(self, keys) -> BatchResult:
        """Plan on the prefix, then measure both partitioners and replay over
        the whole buffer on the device.  ``keys`` is a numpy array or a
        tensor (on any device; it is moved to the job's)."""
        n = len(keys)
        cut = max(1, int(self.sample_fraction * n))
        if isinstance(keys, torch.Tensor):
            prefix = keys[:cut].cpu().numpy()
            buf = keys.to(self.device, torch.int32)
        else:
            keys = np.asarray(keys)
            prefix = keys[:cut]
            buf = torch.as_tensor(keys.astype(np.int32), device=self.device)
        uhp = uniform_partitioner(self.num_partitions, seed=self.seed)
        hist = Histogram.exact(prefix).top(int(self.cfg.lam * self.num_partitions))
        kip = kip_update(uhp, hist, eps=self.cfg.eps)
        uhp_parts = replay_partition(uhp, buf)
        kip_parts = replay_partition(kip, buf)
        before = _imbalance(uhp_parts, self.num_partitions)
        after = _imbalance(kip_parts, self.num_partitions)
        if after >= before:  # repartitioning must pay for the replay
            return BatchResult(uhp, uhp_parts, before, before, 0, self.sample_fraction)
        return BatchResult(kip, kip_parts, before, after, cut, self.sample_fraction)
