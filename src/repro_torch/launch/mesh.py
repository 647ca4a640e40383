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

:class:`ProcessMesh` is a ``MeshShape`` laid over the ranks of a
:class:`~repro_torch.exchange.dist.WorkerGroup` in rank order, one rank a
device, as ``device_mesh`` lays it: this rank's coordinates, and the
subgroup of any axis or tuple of axes (:meth:`WorkerGroup.split` views),
built by every rank together when the mesh is made.  It reads as a
``MeshShape`` does, so ``dp_axes_of``, ``tp_size`` and the rules take it;
``Policy(mesh=...)`` executes under it (``launch/sharding.py``
``make_policy``, ``moe/layer.py``).

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
import itertools
import math
import socket
from typing import Sequence

import numpy as np

from repro_torch.exchange.spec import ExchangeTopology

__all__ = ["MeshShape", "ProcessMesh", "device_mesh", "dp_axes_of", "dp_size",
           "exchange_topology_of", "lanes_per_host_of", "make_production_mesh", "tp_size"]


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


class ProcessMesh:
    """``layout`` (a :class:`MeshShape`) laid over the ranks of ``group``
    (the world's :class:`~repro_torch.exchange.dist.WorkerGroup`) in rank
    order, the last axis minor: rank ``r`` sits at ``np.unravel_index(r,
    layout.dims)``.  A ``(data, model)`` mesh's model subgroups are then
    the contiguous runs ``WorkerGroup.tiers(model)`` calls hosts.

    Every rank makes it together (``ValueError`` unless the group has as
    many ranks as the mesh has devices): it builds the subgroup of every
    non-empty tuple of axes, in one order, and keeps this rank's.  A
    subgroup numbers its ranks by their coordinates along its axes, major
    first.  ``.shape``, ``.axis_names`` and ``.dims`` read as
    ``MeshShape``'s."""

    def __init__(self, layout: MeshShape, group):
        if group.world_size != layout.size:
            raise ValueError(f"a mesh of {layout.size} devices {layout.dims} cannot be laid "
                             f"over a group of {group.world_size} ranks")
        self.layout, self.group = layout, group
        names, dims = layout.axis_names, layout.dims
        self.coords = {a: int(c) for a, c in zip(names, np.unravel_index(group.rank, dims))}
        grid = np.arange(layout.size).reshape(dims)
        self._subgroups = {}
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if n == len(names):
                    self._subgroups[axes] = group
                    continue
                keep = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in keep]
                parts = grid.transpose(rest + keep).reshape(-1, math.prod(dims[i] for i in keep))
                self._subgroups[axes] = group.split(parts.tolist())

    @property
    def shape(self) -> dict[str, int]:
        return self.layout.shape

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.layout.axis_names

    @property
    def dims(self) -> tuple[int, ...]:
        return self.layout.dims

    def _axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def subgroup(self, axes):
        """The :class:`~repro_torch.exchange.dist.WorkerGroup` view of the
        ranks that share this rank's coordinates off ``axes`` (a name or a
        tuple of names): all of them is the world's group itself."""
        return self._subgroups[self._axes(axes)]

    def index(self, axes) -> int:
        """This rank's linear index along ``axes`` (mesh order, major
        first): its rank in :meth:`subgroup`; 0 for no axes."""
        axes = self._axes(axes)
        return self._subgroups[axes].rank if axes else 0

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.dims}, {self.axis_names}, rank {self.group.rank} at "
                f"{self.coords})")


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
