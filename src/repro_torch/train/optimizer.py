"""AdamW with global-norm clipping and a configurable moment dtype (a port
of ``repro.train.optimizer``; bf16 moments are the reference's rule for
archs of 100 B parameters and more).

Parameters, grads and moments are the port's parameter dicts (nested
dicts and lists of tensors).  ``apply_updates`` runs where the tensors
lie, with no host sync: the norm, the clip scale, the learning rate and
the bias corrections stay device scalars.

Two departures from the reference, both exact:

* The update is in place.  Each parameter and each moment is overwritten
  with ``copy_`` under ``torch.no_grad()``, so a parameter stays the leaf
  tensor that requires grad (and that the moments pair with), and no
  second copy of the state is ever alive.
* A large tensor is updated in flat slices of at most ``SLICE`` elements.
  The reference's ``upd`` makes about five float32 temporaries of a whole
  tensor; for one Llama 4 Scout layer's ``wi`` (1.34 G elements) that
  would be about 27 GB.  The update is elementwise, so each slice gives
  the bits the whole tensor would.  The squared norm is summed by slices
  too (its summation order is not the reference's, which sums each whole
  leaf in XLA's order).

Under a process mesh (``mesh=``, ``Policy.mesh``) a rank holds every dense
leaf whole and its model shard's expert slots (``carry.rank_params``),
their gradients already summed as the reference's in_specs sum them
(``moe/layer.py``).  The global norm then counts the dense leaves once and
sums the expert slots' squares over the model axis: each rank gathers the
model axis's partial sums (a copy) and adds them in rank order, so the
norm, the clip scale and the learning rate come out equal bit for bit on
every rank.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["SLICE", "OptConfig", "OptState", "apply_updates", "expert_flags", "global_norm",
           "init_opt", "leaves", "tree_map"]

SLICE = 1 << 24  # elements per slice of the update and of the squared norm


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    warmup: int = 100


class OptState(NamedTuple):
    step: torch.Tensor   # int32[] on the parameters' device
    m: dict
    v: dict


def leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return None if tree is None else fn(tree, *rest)


def init_opt(params, cfg: OptConfig) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).to(torch.float32) / max(cfg.warmup, 1), max=1.0)
    return cfg.lr * warm


def _flat_slices(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[i:i + SLICE] for i in range(0, flat.numel(), SLICE)]


def expert_flags(tree) -> list[bool]:
    """For each leaf of ``tree`` (in :func:`leaves`' order), whether it is
    a MoE layer's expert slots: ``wi`` or ``wo`` of a dict that also holds
    a ``router`` (the leaves a rank of a mesh holds a cut of)."""
    if isinstance(tree, dict):
        moe = {"router", "wi", "wo"} <= set(tree)
        return [f for k, v in tree.items()
                for f in ([True] * len(leaves(v)) if moe and k in ("wi", "wo")
                          else expert_flags(v))]
    if isinstance(tree, (list, tuple)):
        return [f for v in tree for f in expert_flags(v)]
    return [] if tree is None else [False]


def _square_sum(flat: list):
    total = None
    for g in flat:
        for part in _flat_slices(g.detach().contiguous()):
            sq = torch.sum(torch.square(part.to(torch.float32)))
            total = sq if total is None else total + sq
    return total


def _norm(flat: list, flags: list, mesh, tp_axis: str) -> torch.Tensor:
    if mesh is None:
        return torch.sqrt(_square_sum(flat))
    dense = _square_sum([g for g, f in zip(flat, flags) if not f])
    experts = _square_sum([g for g, f in zip(flat, flags) if f])
    dev = flat[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dense = zero if dense is None else dense
    experts = zero if experts is None else experts
    parts, = mesh.subgroup(tp_axis).gather_rows(experts.reshape(1))
    total = dense
    for part in parts.unbind():
        total = total + part
    return torch.sqrt(total)


def global_norm(tree, mesh=None, *, tp_axis: str = "model") -> torch.Tensor:
    """``sqrt(sum of g**2)`` in float32 over every leaf, summed by slices.
    Under ``mesh`` (a :class:`~repro_torch.launch.mesh.ProcessMesh`) ``tree``
    is a rank's cut: the expert slots' squares are summed over the model
    axis, the dense leaves counted once; every rank calls it together."""
    return _norm(leaves(tree), expert_flags(tree), mesh, tp_axis)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig, mesh=None, *,
                  tp_axis: str = "model"):
    """One AdamW step, in place.  Returns ``(params, state, metrics)``:
    the same parameter tensors updated, the state with ``step + 1`` and
    its moments updated in place, and ``{"grad_norm", "lr"}`` as device
    scalars.  ``grads`` is a tree like ``params`` or its flat leaves.
    Under ``mesh`` every rank calls it together with its own cut
    (:func:`global_norm`)."""
    gnorm = _norm(leaves(grads), expert_flags(params), mesh, tp_axis)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * u
        p.copy_(newp)
        m.copy_(m32)
        v.copy_(v32)

    flat_p, flat_g = leaves(params), leaves(grads)
    flat_m, flat_v = leaves(state.m), leaves(state.v)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"apply_updates: {len(flat_p)} parameters, {len(flat_g)} grads, "
                         f"{len(flat_m)} and {len(flat_v)} moments")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("apply_updates: parameters and moments must be contiguous")
        g = g.contiguous()
        for parts in zip(*(_flat_slices(t) for t in (p, g, m, v))):
            upd(*parts)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
