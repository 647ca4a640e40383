"""The exchange plane's lane topology, for stacked workers or a process
group.

The reference reads a mesh's process placement
(``repro.launch.mesh.exchange_topology_of``): lanes are host-major, and
``lanes_per_host`` is the contiguous run of the first host along the
axis.  The port's stacked workers live in one process, which has no host
boundary to read, so every lane sits on one host unless the caller models
a boundary with ``lanes_per_host``, as the reference does for a
single-process mesh.  Over a process group (``group=``) each rank is a
lane, and the ranks' host names give the placement, read by the
reference's rule (:func:`lanes_per_host_of`); ``lanes_per_host`` still
overrides it.
"""
from __future__ import annotations

import socket
from typing import Sequence

from repro_torch.exchange.spec import ExchangeTopology

__all__ = ["exchange_topology_of", "lanes_per_host_of"]


def lanes_per_host_of(process_ids: Sequence) -> int:
    """Lanes a host, from each lane's process (or host) id in lane order:
    the contiguous run of the first lane's id, at least 1; one id for
    every lane is one host (the flat world).  The reference's rule over a
    mesh's ``process_index`` along its axis."""
    ids = list(process_ids)
    if not ids:
        raise ValueError("no lanes to place")
    run = next((i for i, p in enumerate(ids) if p != ids[0]), len(ids))
    return max(run, 1)


def exchange_topology_of(num_lanes: int | None = None, *, group=None,
                         lanes_per_host: int | None = None,
                         class_weights: tuple[float, ...] | None = None
                         ) -> ExchangeTopology:
    """The :class:`ExchangeTopology` of ``num_lanes`` stacked workers, or of
    the ranks of ``group`` (a :class:`~repro_torch.exchange.dist.
    WorkerGroup`, one lane a rank; every rank calls it together).

    ``lanes_per_host`` overrides the placement: ``None`` is one host for
    stacked workers, and for a group the run of the first rank's host name
    (:func:`lanes_per_host_of` over every rank's ``socket.gethostname()``).
    ``class_weights`` prices a row of each distance class (``None``: the
    default, an inter-host row 10x an intra-host one)."""
    if group is not None:
        if num_lanes is not None and int(num_lanes) != group.world_size:
            raise ValueError(f"a group of {group.world_size} ranks has as many lanes, "
                             f"not {num_lanes}")
        num_lanes = group.world_size
        if lanes_per_host is None:
            lanes_per_host = lanes_per_host_of(group.all_gather_object(socket.gethostname()))
    elif num_lanes is None:
        raise ValueError("give num_lanes or group")
    lanes_per_host = num_lanes if lanes_per_host is None else lanes_per_host
    kw = {} if class_weights is None else {"class_weights": tuple(class_weights)}
    return ExchangeTopology(num_lanes=int(num_lanes), lanes_per_host=int(lanes_per_host),
                            **kw)
