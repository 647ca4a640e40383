"""Mesh descriptions and the exchange plane's lane topology, for stacked
workers or a process group.

:class:`MeshShape` is a mesh without devices: its axis sizes and names,
which is all the sharding rules (``launch/sharding.py``) read of a mesh.
:func:`make_production_mesh` gives the reference's two production
shapes, :func:`dp_axes_of`, :func:`tp_size` and :func:`dp_size` read one,
and :func:`device_mesh` lays one over the ranks of a process group as a
``torch.distributed`` ``DeviceMesh``.  These are functions, never module
constants: importing this module touches no device and no process group,
as the reference's rule says.

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

import dataclasses
import math
import socket
from typing import Sequence

from repro_torch.exchange.spec import ExchangeTopology

__all__ = ["MeshShape", "device_mesh", "dp_axes_of", "dp_size", "exchange_topology_of",
           "lanes_per_host_of", "make_production_mesh", "tp_size"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh's shape without its devices: ``dims`` (one size an
    axis) over ``axis_names``.  It reads as a jax ``Mesh`` or
    ``AbstractMesh`` does where the sharding rules read one:
    ``.shape[axis]`` and ``.axis_names``."""

    dims: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(n) for n in self.dims))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"{len(self.dims)} sizes for the axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        if any(n < 1 for n in self.dims):
            raise ValueError(f"axis sizes must be positive, got {self.dims}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """One pod: 256 devices as (16, 16) over ("data", "model").  Two pods:
    512 as (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def dp_axes_of(mesh) -> tuple[str, ...]:
    """The data-parallel axes, ``"pod"`` and ``"data"``, in mesh order."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_size(mesh) -> int:
    return mesh.shape["model"]


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes_of(mesh):
        n *= mesh.shape[a]
    return n


def device_mesh(mesh: MeshShape, group):
    """``mesh`` laid over the ranks of ``group`` (a :class:`~repro_torch.
    exchange.dist.WorkerGroup`) in rank order, as a ``torch.distributed``
    ``DeviceMesh`` with the mesh's axis names.  Every rank calls it
    together (the mesh builds a subgroup an axis).  Raises ``ValueError``
    unless the group has as many ranks as the mesh has devices."""
    if group.world_size != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} devices {mesh.dims} cannot be laid over a "
                         f"group of {group.world_size} ranks")
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(mesh.size).reshape(mesh.dims)
    return DeviceMesh(group.device.type, ranks, mesh_dim_names=mesh.axis_names)


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
