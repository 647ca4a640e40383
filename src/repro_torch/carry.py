"""Carry a reference job's state across: build a port ``StreamingJob`` from
the numpy dict ``repro.core.streaming.StreamingJob.snapshot()`` returns.

The snapshot's keys are the reference's own (state tables, partitioner
tables with ``heavy_repl``, split fields, sketch, tick counters, decision
log), and the port's ``snapshot()`` writes the same keys, so a snapshot
round-trips between the packages.  Keys of features the port does not run
yet — ``topology_*``, lane health / quarantine, a backend other than
``dense`` / ``local`` — raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.drm import DRConfig
from repro_torch.core.streaming import StreamingJob

__all__ = ["job_from_reference_snapshot"]


def job_from_reference_snapshot(snap: dict, *, config: DRConfig | None = None,
                                device=None, **job_kwargs) -> StreamingJob:
    """A port job resuming ``snap`` on ``device`` (``None``: the CUDA device).

    The worker count, state capacity, payload width, partition count and
    partitioner seed come from the snapshot; ``config`` is the DR
    configuration the reference job ran with, and ``job_kwargs`` the other
    ``StreamingJob`` arguments it was built with (``capacity_factor``,
    ``hist_k``, ...)."""
    state_keys = np.asarray(snap["state_keys"])
    state_vals = np.asarray(snap["state_vals"])
    job = StreamingJob(
        num_partitions=int(snap["drm_num_partitions"]),
        num_workers=state_keys.shape[0],
        device=device,
        state_capacity=state_keys.shape[1],
        payload_dim=state_vals.shape[2],
        dr=config,
        seed=int(snap["drm_seed"]),
        exchange_backend=str(snap.get("drm_exchange_backend", "dense")),
        **job_kwargs,
    )
    job.restore(snap)
    return job
