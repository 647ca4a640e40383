"""The exchange plane's lane topology for the port's stacked workers.

The reference reads a mesh's process placement
(``repro.launch.mesh.exchange_topology_of``).  The port's workers are
stacked in one process, which has no host boundary to read, so every lane
sits on one host unless the caller models a boundary with
``lanes_per_host``, as the reference does for a single-process mesh.
Reading the placement of several processes waits for the
``torch.distributed`` transport (ROADMAP.md, queue 1 step 5).
"""
from __future__ import annotations

from repro_torch.exchange.spec import ExchangeTopology

__all__ = ["exchange_topology_of"]


def exchange_topology_of(num_lanes: int, *, lanes_per_host: int | None = None,
                         class_weights: tuple[float, ...] | None = None
                         ) -> ExchangeTopology:
    """The :class:`ExchangeTopology` of ``num_lanes`` stacked workers:
    ``lanes_per_host`` of them a host (``None``: all of them, one host), and
    ``class_weights`` pricing a row of each distance class (``None``: the
    default, an inter-host row 10x an intra-host one)."""
    lanes_per_host = num_lanes if lanes_per_host is None else lanes_per_host
    kw = {} if class_weights is None else {"class_weights": tuple(class_weights)}
    return ExchangeTopology(num_lanes=int(num_lanes), lanes_per_host=int(lanes_per_host),
                            **kw)
