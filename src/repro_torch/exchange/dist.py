"""The process-group transport's handle: one worker per process.

The port's first transport stacks all W workers on one device as ``[W,
...]`` tensors.  Its second runs one worker per process of a
``torch.distributed`` process group: an
:class:`~repro_torch.exchange.spec.ExchangeSpec` bound to a
:class:`WorkerGroup` (``ExchangeSpec(..., group=g)``) crosses processes,
and each process's tensors carry a leading worker axis of 1.  The same
four backends move the rows (:mod:`repro_torch.exchange.backends`), and
the streaming job runs on it with ``StreamingJob(..., group=g)``.

:class:`WorkerGroup` holds the group's rank, world size and device, the
intra-host and inter-host subgroups the hierarchical backend needs, and
the thin collective helpers the port calls: the dense and the uneven
``all_to_all_single``, sum and max ``all_reduce`` (several tensors packed
into one call; float64 for floats, or float32 with ``dtype=``), an
``all_gather`` of rows in rank order, and :meth:`WorkerGroup.shift`, the
hand-off of one tensor from each rank to the next (jax's ``ppermute``
over ``i -> i + 1``).  Each helper adds the bytes it hands the collective
to :attr:`WorkerGroup.traffic`.

The helpers carry gradients.  When autograd records and a floating input
requires grad, each runs as a ``torch.autograd.Function`` whose backward
is the collective's transpose, as jax's is under ``shard_map``: the dense
all-to-all's backward is the same all-to-all, the uneven one's swaps the
forward's split sizes (kept, never fetched again), ``gather_rows``' is this
rank's own row (every rank differentiates the same replicated value),
``sum``'s is the identity, ``shift``'s hands each gradient back to the
rank before, and :meth:`WorkerGroup.sum_grads` is the identity forward
and the all-reduce backward: a replicated input whose ranks each use part
of it (jax's transpose of a ``P()`` input).  Integer tensors carry no
gradient.  A backward that calls collectives is safe only when every
rank's graph holds the same collectives in the same order, so every rank
makes the same calls with tensors that require grad alike.

:meth:`WorkerGroup.split` cuts the world into subgroups (one mesh axis's
ranks, say) and returns this rank's as a view: a ``WorkerGroup`` with its
own ``rank``, ``world_size`` and ``ranks``, whose collectives run on the
subgroup and add to the world's ``traffic``.  An
``ExchangeSpec(group=view)`` ships over that axis alone, through the same
backends.

The backend is the caller's choice, ``"gloo"`` or ``"nccl"``, and it is
never switched on a failure: a collective that fails raises.  Gloo takes
CUDA tensors and stages them through host memory inside the collective;
NCCL keeps them on the card, and needs one card a rank.

Start W processes with ``torch.multiprocessing`` under the spawn start
method (forking after CUDA is up breaks the children) and call
:meth:`WorkerGroup.init` in each with its rank, the world size and a
shared ``init_method`` (``file://`` or ``tcp://``); under ``torchrun``
call it with no arguments, and it reads ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` from the environment.  Build the CUDA kernels
(:func:`repro_torch.kernels.build.library`) in the parent before the
spawn, so the children load one library instead of racing to build it.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device

__all__ = ["WorkerGroup"]

BACKENDS = ("gloo", "nccl")


class WorkerGroup:
    """The default process group as the exchange plane sees it (or, from
    :meth:`split`, a view of one of its subgroups): this process's
    ``rank`` among ``world_size`` workers, the ``device`` its worker's
    tensors live on, and the collectives over them.

    ``traffic`` maps each collective kind (``"all_to_all"``,
    ``"all_to_all_uneven"``, ``"all_reduce"``, ``"all_gather"``,
    ``"shift"``) to the bytes this rank handed it, its own share
    included."""

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("WorkerGroup needs an initialized process group "
                               "(WorkerGroup.init or torch.distributed.init_process_group)")
        self.backend = str(dist.get_backend())
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl group moves CUDA tensors; give it a CUDA device")
        # host values (walls, digests, placement) ride tensors on this device:
        # nccl takes CUDA tensors only, gloo host ones without a copy
        self.host_device = self.device if self.backend == "nccl" else torch.device("cpu")
        self.traffic = {"all_to_all": 0, "all_to_all_uneven": 0, "all_reduce": 0,
                        "all_gather": 0, "shift": 0}
        self.ranks = tuple(range(self.world_size))  # global ranks, in this group's order
        self._pg = None                              # None: the default (world) group
        self._tiers: dict[int, tuple] = {}
        self._splits: dict[tuple, WorkerGroup] = {}

    @classmethod
    def init(cls, *, backend: str = "gloo", rank: int | None = None,
             world_size: int | None = None, init_method: str | None = None,
             device=None) -> "WorkerGroup":
        """Join the process group and return its handle.

        ``rank``, ``world_size`` and ``init_method`` default to what
        ``torchrun`` exports (``RANK``, ``WORLD_SIZE``, ``env://``).
        ``device=None`` (or ``"cuda"``) is the card: ``cuda:LOCAL_RANK``
        modulo the cards present, so W ranks on one card share
        ``cuda:0``."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        rank = int(os.environ["RANK"]) if rank is None else int(rank)
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
        device = resolve_device(device)
        if device.type == "cuda":
            if device.index is None:
                local = int(os.environ.get("LOCAL_RANK", rank))
                device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
        return cls(device)

    def close(self) -> None:
        """Leave the process group (every rank calls it on the world's
        handle; that ends every subgroup too)."""
        if self._pg is not None:
            raise ValueError("close the world's WorkerGroup, not a subgroup's view")
        dist.destroy_process_group()

    # -- subgroups --------------------------------------------------------
    def split(self, partition) -> "WorkerGroup":
        """This rank's view of its part of ``partition``: disjoint lists of
        global ranks that cover the world, each in the order its subgroup
        numbers them.  Every rank calls it together with the same
        ``partition`` (``dist.new_group`` is collective and builds every
        part on every rank, in the listed order); a later call with the
        same partition returns the cached view.

        The view's ``rank`` and ``world_size`` are its place and size in
        the subgroup, ``ranks`` its members' global ranks; its collectives
        run on the subgroup and add their bytes to this group's
        ``traffic``."""
        if self._pg is not None:
            raise ValueError("split the world's WorkerGroup, not a subgroup's view")
        parts = tuple(tuple(int(r) for r in part) for part in partition)
        members = sorted(r for part in parts for r in part)
        if members != list(range(self.world_size)):
            raise ValueError(f"a partition of the {self.world_size} ranks must hold each "
                             f"once, got {[list(p) for p in parts]}")
        if parts not in self._splits:
            mine = None
            for part in parts:
                pg = dist.new_group(list(part))
                if self.rank in part:
                    mine = (part, pg)
            self._splits[parts] = self._view(*mine)
        return self._splits[parts]

    def _view(self, ranks: tuple, pg) -> "WorkerGroup":
        view = object.__new__(WorkerGroup)
        view.backend, view.device, view.host_device = self.backend, self.device, self.host_device
        view.rank, view.world_size = ranks.index(self.rank), len(ranks)
        view.ranks, view._pg = ranks, pg
        view.traffic = self.traffic
        view._tiers, view._splits = {}, {}
        return view

    def tiers(self, lanes_per_host: int) -> tuple:
        """``(intra, inter)``: this rank's subgroup of the ranks on its
        modeled host (``rank // lanes_per_host``) and of the ranks at its
        place on every host (``rank % lanes_per_host``).  The first call for
        a ``lanes_per_host`` builds every such subgroup on every rank, in
        one order (``dist.new_group`` is collective), so all ranks must
        make it together; later calls return the cached pair."""
        g = int(lanes_per_host)
        if self._pg is not None:
            raise ValueError("build the tiers on the world's WorkerGroup, not a subgroup's view")
        if g not in self._tiers:
            w = self.world_size
            if g < 1 or w % g:
                raise ValueError(f"{w} ranks do not split into hosts of {g}")
            h = w // g
            intra = [dist.new_group([x * g + s for s in range(g)]) for x in range(h)]
            inter = [dist.new_group([x * g + r for x in range(h)]) for r in range(g)]
            self._tiers[g] = (intra[self.rank // g], inter[self.rank % g])
        return self._tiers[g]

    # -- collectives ------------------------------------------------------
    def all_to_all(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """The dense all-to-all over dim 0 of ``x`` (split evenly among the
        ranks of ``group``, default all): chunk ``j`` goes to rank ``j``,
        and chunk ``j`` of the result came from rank ``j``.  A new
        tensor; its backward is the same all-to-all."""
        if _records(x):
            return _AllToAll.apply(x, self, group)
        return self._all_to_all(x, group)

    def _all_to_all(self, x: torch.Tensor, group=None) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self.traffic["all_to_all"] += x.numel() * x.element_size()
        dist.all_to_all_single(out, x, group=self._pg if group is None else group)
        return out

    def all_to_all_uneven(self, x: torch.Tensor, send: list[int],
                          recv: list[int]) -> torch.Tensor:
        """The uneven all-to-all: ``send[j]`` rows of ``x`` (in rank order)
        go to rank ``j``, and ``recv[j]`` rows of the result came from
        rank ``j``.  Its backward ships the gradients back with the two
        lists swapped."""
        send, recv = [int(s) for s in send], [int(r) for r in recv]
        if _records(x):
            return _AllToAllUneven.apply(x, self, send, recv)
        return self._all_to_all_uneven(x, send, recv)

    def _all_to_all_uneven(self, x: torch.Tensor, send: list[int],
                           recv: list[int]) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((int(sum(recv)),) + tuple(x.shape[1:]))
        self.traffic["all_to_all_uneven"] += x.numel() * x.element_size()
        dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send,
                               group=self._pg)
        return out

    def _reduce(self, tensors, op, dtype=None) -> tuple:
        """Each of ``tensors`` reduced by ``op`` over the group, packed into
        one all-reduce in ``dtype`` (``None``: int64, or float64 when any is
        floating); the results keep their shapes and dtypes."""
        if dtype is None:
            dtype = (torch.float64 if any(t.is_floating_point() for t in tensors)
                     else torch.int64)
        flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
        self.traffic["all_reduce"] += flat.numel() * flat.element_size()
        dist.all_reduce(flat, op=op, group=self._pg)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at: at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return tuple(out)

    def sum(self, *tensors: torch.Tensor, dtype: torch.dtype | None = None) -> tuple:
        """Each tensor summed over the ranks (one collective for all), in
        float64 (int64 for integers) unless ``dtype`` names the type the
        sum runs in: ``torch.float32`` sums as a float32 ``psum`` does.
        The backward is the identity: every rank differentiates the same
        summed value, so each rank's term takes its gradient as it is."""
        if _records(*tensors):
            return _Sum.apply(self, dtype, *tensors)
        return self._reduce(tensors, dist.ReduceOp.SUM, dtype)

    def sum_grads(self, *tensors: torch.Tensor) -> tuple:
        """The tensors as they are, forward; backward, their gradients
        summed over the ranks in one all-reduce a dtype, each in its own
        dtype (jax's ``psum`` of a replicated input's cotangent).  For a
        value every rank holds whole and each rank uses part of: its
        gradient is then the whole one on every rank.  Without autograd
        recording, the tensors themselves."""
        if _records(*tensors):
            return _SumGrads.apply(self, *tensors)
        return tensors

    def max(self, *tensors: torch.Tensor) -> tuple:
        """Each tensor's elementwise max over the ranks."""
        return self._reduce(tensors, dist.ReduceOp.MAX)

    def gather_rows(self, *tensors: torch.Tensor) -> tuple:
        """Each ``[1, ...]`` tensor as the stacked ``[W, ...]`` of every
        rank's, in rank order.  Tensors of one dtype ride one all-gather.
        The backward takes this rank's own row of each gradient: every
        rank differentiates the same gathered value."""
        if _records(*tensors):
            return _GatherRows.apply(self, *tensors)
        return self._gather_rows(*tensors)

    def _gather_rows(self, *tensors: torch.Tensor) -> tuple:
        out: list = [None] * len(tensors)
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            if t.shape[0] != 1:
                raise ValueError(f"gather_rows takes one row a rank, got {tuple(t.shape)}")
            by_dtype.setdefault(t.dtype, []).append(i)
        w = self.world_size
        for dtype, idx in by_dtype.items():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in range(w)]
            self.traffic["all_gather"] += flat.numel() * flat.element_size()
            dist.all_gather(parts, flat, group=self._pg)
            rows = torch.stack(parts)
            at = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = rows[:, at: at + n].reshape((w,) + tuple(tensors[i].shape[1:]))
                at += n
        return tuple(out)

    def shift(self, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """Each rank's ``x`` handed to rank ``rank + offset``: the result is
        what rank ``rank - offset`` handed over, or zeros where there is no
        such rank (jax's ``ppermute`` over ``[(i, i + offset)]``).  Every
        rank calls it, with tensors of one shape and dtype.  One uneven
        ``all_to_all_single``; gloo stages CUDA tensors through host memory
        inside it.  The backward hands each gradient back (``-offset``)."""
        if _records(x):
            return _Shift.apply(x, self, offset)
        return self._shift(x, offset)

    def _shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        flat = x.contiguous().view(-1)
        n, w, r = flat.numel(), self.world_size, self.rank
        send = [n if j == r + offset else 0 for j in range(w)]
        recv = [n if j == r - offset else 0 for j in range(w)]
        out = torch.zeros_like(flat)
        self.traffic["shift"] += sum(send) * flat.element_size()
        dist.all_to_all_single(out[: sum(recv)], flat[: sum(send)], output_split_sizes=recv,
                               input_split_sizes=send, group=self._pg)
        return out.view(x.shape)

    def host_max(self, values) -> np.ndarray:
        """float64 host values, elementwise max over the ranks."""
        t = torch.tensor(np.asarray(values, np.float64), device=self.host_device)
        return self.max(t)[0].cpu().numpy()

    def host_gather(self, values) -> np.ndarray:
        """int64 host values of every rank, ``[W, ...]`` in rank order."""
        t = torch.tensor(np.asarray(values, np.int64), device=self.host_device)
        return self.gather_rows(t[None])[0].cpu().numpy()

    def all_gather_object(self, obj) -> list:
        """A picklable value of every rank, in rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self._pg)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self._pg)

    def __repr__(self) -> str:
        sub = "" if self._pg is None else f", ranks={list(self.ranks)}"
        return (f"WorkerGroup(backend={self.backend!r}, rank={self.rank}, "
                f"world_size={self.world_size}{sub}, device={str(self.device)!r})")



# ---------------------------------------------------------------------------
# the collectives under autograd
# ---------------------------------------------------------------------------


def _records(*tensors) -> bool:
    """Whether autograd records a collective of ``tensors``: grad mode on
    and a floating tensor among them that requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad and t.is_floating_point() for t in tensors)


class _AllToAll(torch.autograd.Function):
    """The dense all-to-all; its transpose is itself."""

    @staticmethod
    def forward(ctx, x, group, pg):
        ctx.group, ctx.pg = group, pg
        return group._all_to_all(x, pg)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._all_to_all(g, ctx.pg), None, None


class _AllToAllUneven(torch.autograd.Function):
    """The uneven all-to-all; the backward ships the gradients back over
    the forward's split sizes, swapped."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return group._all_to_all_uneven(x, send, recv)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._all_to_all_uneven(g, ctx.recv, ctx.send), None, None, None


class _GatherRows(torch.autograd.Function):
    """``[1, ...]`` rows gathered to ``[W, ...]``; the backward is this
    rank's own row of each gradient."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.rank = group.rank
        ctx.set_materialize_grads(True)
        return group._gather_rows(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        r = ctx.rank
        return (None,) + tuple(g[r: r + 1] for g in grads)


class _Sum(torch.autograd.Function):
    """Tensors summed over the ranks; the backward is the identity (each
    rank's term of the same replicated sum).  A sum of a tensor that needs
    no gradient comes out needing none."""

    @staticmethod
    def forward(ctx, group, dtype, *tensors):
        ctx.floating = [t.is_floating_point() and t.requires_grad for t in tensors]
        out = group._reduce(tensors, dist.ReduceOp.SUM, dtype)
        ctx.mark_non_differentiable(*(o for o, f in zip(out, ctx.floating) if not f))
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(g if f else None for g, f in zip(grads, ctx.floating))


class _SumGrads(torch.autograd.Function):
    """The identity forward; the backward sums the gradients over the
    ranks, one all-reduce a dtype, each in its own dtype."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.set_materialize_grads(True)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        out: list = list(grads)
        by_dtype: dict = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            summed = ctx.group._reduce([grads[i] for i in idx], dist.ReduceOp.SUM, dtype)
            for i, g in zip(idx, summed):
                out[i] = g
        return (None,) + tuple(out)


class _Shift(torch.autograd.Function):
    """Each rank's tensor to rank ``rank + offset``; the backward hands each
    gradient back to rank ``rank - offset``."""

    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return group._shift(x, offset)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._shift(g, -ctx.offset), None, None
