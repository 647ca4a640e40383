"""GPipe pipeline parallelism over the ranks of a process group (a port of
``repro.launch.pipeline``).

The layer stack is split into ``S`` contiguous stages, one a rank of a
:class:`~repro_torch.exchange.dist.WorkerGroup`, and only that rank holds
its stage's layers; the embedding, the LM head and the final norm are
replicated on every rank, as the reference's ``P()`` inputs are.  The
batch is cut into ``M`` microbatches and runs the reference's ``M + S - 1``
tick loop: at tick ``t`` rank ``i`` works on microbatch ``t - i`` (active
while ``0 <= t - i < M``); stage 0 embeds it, every stage runs its layers
(``transformer._apply_block``, under ``torch.utils.checkpoint`` with
``Policy.remat``), the last stage adds the microbatch's
``chunked_softmax_xent``, and every rank hands its activation to the next
(``WorkerGroup.shift``).  The loss, the sum of the last stage's
microbatch losses over their count, is the same on every rank.  Uniform
patterns only (one block kind, no tail), as in the reference.

Gradients flow back through autograd, through the group's collectives
(:mod:`repro_torch.exchange.dist`): the hand-off (``WorkerGroup.shift``)
ships each gradient from rank ``i + 1`` back to rank ``i`` in its
backward, the replicated leaves enter through ``WorkerGroup.sum_grads``,
whose backward sums their gradients over the ranks in their own dtype
(the reference's transpose of a ``P()`` input), and the loss is a
``WorkerGroup.sum`` whose backward is the identity, so every rank ends
with the plain model's gradient of what it holds.  Differentiate with respect to every parameter
a rank holds.

A collective in a backward is only safe when every rank's graph holds the
same collectives in the same order.  The loop keeps the reference's
structure for that: each tick's activation is computed on every rank and
masked where inactive (``where(active, y, 0)``), stage 0's input keeps the
received buffer in its graph (``where(sid == 0, x0, buf)``), and a rank
that does not take the microbatch's loss ties its activation into the
loss with a zero gradient; so every hand-off's output is in every rank's
graph.  The replicated leaves' sum runs last on every rank: it waits for
tick 0's embedding, which waits for every hand-off's backward.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.attention import head_layout
from repro_torch.models.modules import Policy, apply_norm, chunked_softmax_xent, embed

__all__ = ["make_pp_loss", "stack_stage_params", "stage_params"]


def stack_stage_params(cfg: ArchConfig, params: dict, n_stages: int) -> dict:
    """``params`` with ``layers`` split into ``n_stages`` contiguous stages:
    ``layers[s]`` is stage ``s``'s list of layers (the reference's
    ``[periods] -> [n_stages, periods / n_stages]`` restack).  Raises
    ``ValueError`` for a pattern of more than one block, a tail, or a
    period count the stages do not divide."""
    if len(cfg.pattern) != 1 or cfg.tail:
        raise ValueError(f"{cfg.name}: the pipeline supports uniform-pattern archs (one "
                         f"block kind, no tail), got {len(cfg.pattern)} and {len(cfg.tail)}")
    per = cfg.num_periods
    if n_stages < 1 or per % n_stages:
        raise ValueError(f"{cfg.name}: {per} periods do not split into {n_stages} stages")
    k = per // n_stages
    layers = params["layers"]
    return {**params, "layers": [list(layers[s * k:(s + 1) * k]) for s in range(n_stages)]}


def stage_params(stacked: dict, stage: int) -> dict:
    """What rank ``stage`` holds of :func:`stack_stage_params`' tree: its
    stage's layers (``layers``) and the replicated leaves."""
    return {**stacked, "layers": stacked["layers"][stage]}


class _Tie(torch.autograd.Function):
    """``a``, with ``b`` kept in the graph at a zero gradient."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.like = (b.shape, b.dtype, b.device)
        return a.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def make_pp_loss(cfg: ArchConfig, pol: Policy, group, *, microbatches: int):
    """``loss_fn(params, batch) -> loss``, pipelined over the ranks of
    ``group`` (every rank calls it together).  ``params`` is what this
    rank holds (:func:`stage_params`), ``batch`` the whole batch
    (``tokens``, ``labels``, ``mask`` ``[B, S]``, the same on every rank),
    cut into ``microbatches`` microbatches of ``B / microbatches`` rows.
    The loss is the mean of the microbatches' mean losses (the plain
    model's loss where the masks are full), a float32 scalar equal on
    every rank.  As in the reference, no logit softcap or MoE auxiliary
    loss is added."""
    n_stages = group.world_size
    sid = group.rank
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    blk = cfg.pattern[0]
    m = int(microbatches)

    def layer(x, p, pos):
        return transformer._apply_block(blk, p, x, cfg, lay, pol, pos=pos)[0]

    def stage_blocks(layers, x, pos):
        for p in layers:
            if pol.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(layer, x, p, pos, use_reentrant=False)
            else:
                x = layer(x, p, pos)
        return x

    def loss_fn(params, batch):
        tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
        b, s = tokens.shape
        if m < 1 or b % m:
            raise ValueError(f"a batch of {b} rows does not split into {m} microbatches")
        mb, d, dev = b // m, cfg.d_model, tokens.device
        tied = "lm_head" not in params
        rep = [params["embed"]["tok"]] + ([] if tied else [params["lm_head"]])
        norm_keys = sorted(params["final_norm"])
        rep = group.sum_grads(*rep, *(params["final_norm"][k] for k in norm_keys))
        embed_tok, lm_head = rep[0], rep[0] if tied else rep[1]
        final_norm = dict(zip(norm_keys, rep[len(rep) - len(norm_keys):]))
        pos = transformer._positions(cfg, mb, s, 0, device=dev)
        flags = torch.tensor([False, True], device=dev)
        first = flags[int(sid == 0)]
        buf = torch.zeros((mb, s, d), dtype=pol.compute_dtype, device=dev)
        total = torch.zeros((2,), dtype=torch.float32, device=dev)   # [loss, count]
        is_last = sid == n_stages - 1
        for t in range(m + n_stages - 1):
            i = min(max(t - sid, 0), m - 1)
            rows = slice(i * mb, (i + 1) * mb)
            active = 0 <= t - sid < m
            x0 = embed({"tok": embed_tok}, tokens[rows], scale=cfg.embed_scale, d=d, pol=pol)
            x = torch.where(first, x0, buf)
            y = stage_blocks(params["layers"], x, pos)
            y = torch.where(flags[int(active)], y, torch.zeros((), dtype=y.dtype, device=dev))
            if is_last and active:
                h = apply_norm(final_norm, y, cfg.norm_kind)
                mb_loss = chunked_softmax_xent(h, lm_head, labels[rows], mask[rows], pol,
                                               cfg.vocab_size, chunk=min(512, s))
                total = total + torch.stack([mb_loss, torch.ones_like(mb_loss)])
            elif torch.is_grad_enabled() and y.requires_grad:
                total = _Tie.apply(total, y)
            buf = group.shift(y, 1)
        loss, count = group.sum(total, dtype=torch.float32)[0].unbind()
        return loss / torch.clamp(count, min=1.0)

    return loss_fn
