"""int8 gradient compression with error feedback (a port of
``repro.train.compression``).

Each rank quantizes its local float32 gradient plus the error it carried
(per tensor, symmetric: ``scale = max(|x|, 1e-12) / 127``, ``q =
clip(round_half_even(x / scale), -127, 127)`` in int8), the dequantized
values ``q * scale`` are summed over the ranks in float32 and divided by
the rank count, and the quantization residual ``x - q * scale`` is the
next step's error, which keeps the sum of the synced gradients unbiased.

As the reference does (``psum(q.astype(f32) * scale)``), the sum runs on
the float32 dequantized values: no int8 payload crosses the group.  The
leaves ride float32 all-reduces packed in buckets of at most
``BUCKET_ELEMS`` elements (a larger leaf rides alone); the sum is
elementwise and each leaf keeps its own scale, so the packing changes no
value.  Beyond two ranks the order of a float32 sum is the collective's;
``WorkerGroup.sum`` at its default float64 would round once where a
float32 ``psum`` rounds at every add, so the sync passes ``dtype=
torch.float32``.

``compressed_grad_sync(group)`` over a :class:`~repro_torch.exchange.dist.
WorkerGroup` takes each rank's own local gradients and error (the
reference's per-replica contract); ``group=None`` is one replica (the
reference's one-device mesh): the mean is the dequantized gradient.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import leaves, tree_map

__all__ = ["BUCKET_ELEMS", "compressed_grad_sync", "init_error_feedback"]

BUCKET_ELEMS = 1 << 26  # float32 elements an all-reduce (256 MB)


def init_error_feedback(grads):
    """float32 zeros shaped like ``grads``, on their devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _quantize(x: torch.Tensor):
    """``(q int8, scale float32[])``: per-tensor symmetric int8 of ``x``
    (float32)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _buckets(sizes: list[int], cap: int) -> list[list[int]]:
    """Consecutive leaf indices packed into runs of at most ``cap``
    elements (a leaf above ``cap`` alone)."""
    out, cur, n = [], [], 0
    for i, s in enumerate(sizes):
        if cur and n + s > cap:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += s
    if cur:
        out.append(cur)
    return out


def compressed_grad_sync(group=None, mesh=None, axes: tuple[str, ...] = ("data",)):
    """``sync(local_grads, error) -> (mean_grads, new_error)`` over the
    ranks of ``group`` (every rank calls it together, with trees of one
    structure).  ``mesh`` and ``axes`` are the reference's: given a mesh
    (a :class:`~repro_torch.launch.mesh.MeshShape`), the replicas along
    ``axes`` must be the group's ranks, or ``ValueError``.

    ``mean_grads`` are float32: the mean over the ranks of each rank's
    dequantized ``grad + error``.  ``new_error`` is ``error`` with each
    leaf overwritten in place by this rank's residual (the tensors it was
    given: a second float32 copy of a model's error need not fit beside
    it).  Raises ``ValueError`` on trees that do not match."""
    n = 1 if group is None else int(group.world_size)
    if mesh is not None:
        replicas = 1
        for a in axes:
            replicas *= mesh.shape[a]
        if replicas != n:
            raise ValueError(f"{replicas} replicas along {axes} of the mesh {mesh.shape}, "
                             f"but the group has {n} ranks")

    @torch.no_grad()
    def sync(grads, error):
        flat_g, flat_e = leaves(grads), leaves(error)
        if len(flat_g) != len(flat_e):
            raise ValueError(f"{len(flat_g)} gradients against {len(flat_e)} error leaves")
        means = [None] * len(flat_g)
        for idx in _buckets([g.numel() for g in flat_g], BUCKET_ELEMS):
            deq = []
            for i in idx:
                g, e = flat_g[i], flat_e[i]
                if e.shape != g.shape or e.dtype != torch.float32:
                    raise ValueError(f"error leaf {i}: {tuple(e.shape)} {e.dtype} against the "
                                     f"gradient's {tuple(g.shape)} (float32 wanted)")
                g32 = g.to(torch.float32) + e
                q, scale = _quantize(g32)
                d = q.to(torch.float32) * scale
                torch.sub(g32, d, out=e)  # error feedback, in place
                deq.append(d)
            if group is not None:
                deq = group.sum(*deq, dtype=torch.float32)
            for i, d in zip(idx, deq):
                means[i] = d / n
        it = iter(means)
        return tree_map(lambda _: next(it), grads), error

    return sync
