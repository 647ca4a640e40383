"""Train-step factory: loss + grad + AdamW update, DR expert stats out (a
port of ``repro.train.train_step``).

``make_train_step`` closes over (cfg, policy, opt config) and returns
``step(params, opt_state, batch, inv_place) -> (params, opt_state,
metrics)``.  The MoE expert-load counts ride along in ``metrics``: they are
the DRW histogram the ``PlacementController`` consumes between steps (safe
points = step boundaries, the paper's micro-batch integration).

The grads come from ``torch.autograd.grad`` over the parameter leaves, and
``apply_updates`` overwrites the same leaves in place, so the returned
``params`` and ``opt_state`` hold the tensors they were given.  A leaf that
does not require grad yet is switched on here (a view, as
``carry.params_from_jax`` hands out, is first replaced by its own copy in
the tree).  ``metrics`` holds device tensors: ``loss``, ``overflow``,
``expert_counts`` (MoE), ``grad_norm`` and ``lr``.

Under ``pol.mesh`` (``launch.sharding.make_policy(cfg, mesh, "train",
opts)``, the step the reference's dry run lowers) every rank of the
:class:`~repro_torch.launch.mesh.ProcessMesh` calls the step together
with its own cut of the parameters and moments (``carry.rank_params``,
``carry.rank_opt``) and the whole batch.  The MoE layers sum each
gradient over the ranks the reference's in_specs name, inside the
backward (``moe/layer.py``), and ``apply_updates`` takes the mesh for the
global norm, so every rank's dense leaves, ``expert_counts``, loss,
``grad_norm`` and ``lr`` come out equal.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model
from repro_torch.models.modules import Policy
from repro_torch.train.optimizer import OptConfig, OptState, apply_updates, leaves

__all__ = ["make_eval_step", "make_train_step", "moe_state", "trainable"]


def trainable(params):
    """``params`` with every leaf a contiguous tensor that requires grad,
    in place where it is one already (the same dicts and lists)."""
    def fix(node):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in list(items):
            if isinstance(v, (dict, list)):
                fix(v)
            elif not v.requires_grad:
                if v._base is not None or not v.is_contiguous():
                    v = v.detach().clone(memory_format=torch.contiguous_format)
                    node[k] = v
                v.requires_grad_(True)
    fix(params)
    return params


def moe_state(params, opt_state: OptState | None = None) -> list[dict]:
    """Every MoE block's parameter dict and, with ``opt_state``, its two
    Adam moment dicts: what the safe point's placement move permutes."""
    trees = [params] + ([opt_state.m, opt_state.v] if opt_state is not None else [])
    out = []
    for tree in trees:
        blocks = list(tree["layers"]) + [v for k, v in tree.items() if k.startswith("tail")]
        out += [blk["moe"] for blk in blocks if "moe" in blk]
    return out


def make_train_step(cfg: ArchConfig, pol: Policy, opt: OptConfig):
    def step(params, opt_state: OptState, batch: dict, inv_place=None):
        trainable(params)
        flat = leaves(params)
        loss, metrics = model.loss_fn(params, batch, cfg, pol, inv_place)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
        params, opt_state, opt_metrics = apply_updates(params, grads, opt_state, opt,
                                                       pol.mesh, tp_axis=pol.tp_axis)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **opt_metrics}

    return step


def make_eval_step(cfg: ArchConfig, pol: Policy):
    @torch.no_grad()
    def step(params, batch: dict, inv_place=None):
        loss, metrics = model.loss_fn(params, batch, cfg, pol, inv_place)
        return {"loss": loss, **metrics}

    return step
