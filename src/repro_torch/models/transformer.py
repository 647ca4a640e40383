"""Decoder-only LM assembled from the config's block pattern, for training
and serving (a port of ``repro.models.transformer``: the ``attn``,
``local_attn``, ``mamba``, ``mlstm`` and ``slstm`` mixers with dense, MoE
or no FFNs).

The reference scans over *periods* with weights stacked ``[periods,
...]``; eager PyTorch needs no scan, so parameters and caches hold one
entry per layer: ``params["layers"][i]`` is layer ``i = period *
len(pattern) + j`` (pattern position ``j``), and the non-repeating tail
blocks stay ``params["tail{j}"]``, as in the reference.

A ``moe`` FFN runs ``repro_torch.moe.layer`` with the reference's rule.
Under ``Policy.mesh``: ``moe_apply`` when ``Policy.tp`` divides the
sequence and it is longer than one token, else ``moe_apply_replicated``;
both paths serve and train there (their gradients summed over the mesh
as the reference's ``shard_map`` sums them, ``train.train_step``).
Without a mesh: the dense oracle ``moe_ref`` without EP shards
(``Policy.ep_shards == 0``, the reference's ``mesh=None``), else
``moe_apply`` when the sequence splits over the stacked shards and is
longer than one token, else ``moe_apply_replicated``.  ``inv_place`` (logical expert -> physical slot,
``None``: the identity) is the KIP placement the expert weights are laid
out by.

The recurrent mixers (Mamba, ``models/ssm.py``; the xLSTM's,
``models/xlstm.py``) return a new state dict, where attention updates its
cache in place; ``backbone`` stores every layer's returned cache back into
``cache["layers"][i]`` (``cache["tail{j}"]``).  Mamba and the mLSTM cut a
sequence into chunks of ``min(256, S)``, so a prompt longer than 256
tokens must be a multiple of 256 (``ValueError``).

``loss_fn`` is the training loss: the backbone under autograd (the flash
kernel's backward on the card), then ``chunked_softmax_xent``, plus the
MoE layers' auxiliary loss.  With ``Policy.remat`` each period's blocks run
under ``torch.utils.checkpoint`` (non-reentrant) in training, never the
tail's, as in the reference; see :func:`backbone`.

M-RoPE (qwen2-vl) runs on the reference's text stub: the three position
streams ``[3, B, S]`` are the same ``offset + arange(S)``.  Vision tokens
are its stubbed frontend: a batch's ``vision_embeds [B, V, d]`` replace
the prompt's first ``V`` rows, which needs ``S >= V`` (``ValueError``; the
reference fails there with a shape error).
"""
from __future__ import annotations

import itertools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.models.attention import (
    HeadLayout,
    attention_block,
    head_layout,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.modules import (
    Policy,
    apply_ffn,
    apply_norm,
    chunked_softmax_xent,
    embed,
    init_embed,
    init_ffn,
    init_norm,
    normal,
    pad_vocab,
    unembed_logits,
)
from repro_torch.models.ssm import init_mamba, init_mamba_state, mamba_forward
from repro_torch.models.xlstm import (
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
    mlstm_forward,
    slstm_forward,
)
from repro_torch.moe.layer import init_moe, moe_apply, moe_apply_replicated, moe_ref

__all__ = ["backbone", "decode_step", "init_cache", "init_params", "loss_fn", "prefill"]

def layers(cfg: ArchConfig) -> list[Block]:
    """The periodic blocks in execution order (``params["layers"]``)."""
    return [blk for _ in range(cfg.num_periods) for blk in cfg.pattern]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ArchConfig, blk: Block, lay: HeadLayout,
                pol: Policy, experts=None) -> dict:
    dt, dev = pol.param_dtype, gen.device
    p: dict[str, Any] = {"ln1": init_norm(cfg.norm_kind, cfg.d_model, dt, dev)}
    if blk.mixer == "mamba":
        p["mamba"] = init_mamba(gen, cfg.d_model, expand=cfg.mamba_expand,
                                d_state=cfg.mamba_d_state, d_conv=cfg.mamba_conv, dtype=dt)
    elif blk.mixer == "mlstm":
        p["mlstm"] = init_mlstm(gen, cfg.d_model, cfg.num_heads, _heads_p(cfg, pol), dtype=dt)
    elif blk.mixer == "slstm":
        p["slstm"] = init_slstm(gen, cfg.d_model, cfg.num_heads, _heads_p(cfg, pol), dtype=dt)
    else:
        p["attn"] = init_attention(gen, cfg.d_model, lay, cfg.head_dim, qk_norm=cfg.qk_norm,
                                   norm_kind=cfg.norm_kind, dtype=dt)
    if blk.ffn == "dense":
        p["ln2"] = init_norm(cfg.norm_kind, cfg.d_model, dt, dev)
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dt)
    elif blk.ffn == "moe":
        p["ln2"] = init_norm(cfg.norm_kind, cfg.d_model, dt, dev)
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe, cfg.ffn_kind, dt, experts)
    return p


def _heads_p(cfg: ArchConfig, pol: Policy) -> int:
    """The xLSTM mixers' heads padded up to a multiple of ``pol.tp``."""
    h = cfg.num_heads
    return -(-h // pol.tp) * pol.tp


def init_params(cfg: ArchConfig, gen: torch.Generator, pol: Policy, experts=None) -> dict:
    """Random parameters drawn from ``gen`` on its device; every MoE layer
    keeps only ``experts`` (logical ids in slot order, ``None``: all; see
    ``moe.layer.init_moe``)."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    params: dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, pol.param_dtype),
        "final_norm": init_norm(cfg.norm_kind, cfg.d_model, pol.param_dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (pad_vocab(cfg.vocab_size), cfg.d_model),
                                   cfg.d_model**-0.5, pol.param_dtype)
    params["layers"] = [_init_block(gen, cfg, blk, lay, pol, experts) for blk in layers(cfg)]
    for j, blk in enumerate(cfg.tail):
        params[f"tail{j}"] = _init_block(gen, cfg, blk, lay, pol, experts)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, pol: Policy, *,
               device=None) -> dict:
    """Decode caches, one per layer (a ring cache for ``local_attn``, the
    recurrent state for ``mamba``, ``mlstm`` and ``slstm``)."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    hp = _heads_p(cfg, pol)

    def one(blk: Block) -> dict:
        if blk.mixer == "mamba":
            return init_mamba_state(batch, cfg.d_model, expand=cfg.mamba_expand,
                                    d_state=cfg.mamba_d_state, d_conv=cfg.mamba_conv,
                                    dtype=pol.compute_dtype, device=device)
        if blk.mixer == "mlstm":
            di = 2 * cfg.d_model
            return init_mlstm_state(batch, hp, di // cfg.num_heads, di, dtype=pol.compute_dtype,
                                    device=device)
        if blk.mixer == "slstm":
            return init_slstm_state(batch, hp, cfg.d_model // cfg.num_heads, device=device)
        window = cfg.window if blk.mixer == "local_attn" else 0
        return init_kv_cache(batch, max_len, lay, cfg.head_dim, window=window,
                             dtype=pol.compute_dtype, device=device)

    cache: dict[str, Any] = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    cache["layers"] = [one(blk) for blk in layers(cfg)]
    for j, blk in enumerate(cfg.tail):
        cache[f"tail{j}"] = one(blk)
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _moe_fn(h: torch.Tensor, pol: Policy):
    """The reference's path rule: under a mesh by ``pol.tp``; without one,
    ``pol.ep_shards`` stands for the mesh's model-axis size and no shards
    is its ``mesh=None``."""
    if pol.mesh is not None:
        if h.shape[1] % pol.tp == 0 and h.shape[1] > 1:
            return moe_apply         # prefill: the sequence splits over the model axis
        return moe_apply_replicated  # decode: tokens replicated over EP
    if pol.ep_shards == 0:
        return moe_ref
    if h.shape[1] % pol.ep_shards == 0 and h.shape[1] > 1:
        return moe_apply             # prefill: the sequence splits over the shards
    return moe_apply_replicated      # decode: tokens replicated over EP


def _apply_mixer(blk: Block, p: dict, x: torch.Tensor, cfg: ArchConfig, lay: HeadLayout,
                 pol: Policy, *, pos, cache=None):
    """The block's first half, ``x + mixer(norm(x))``.  Returns ``(x,
    new_cache)``."""
    h = apply_norm(p["ln1"], x, cfg.norm_kind)
    if blk.mixer == "mamba":
        y, new_cache = mamba_forward(p["mamba"], h, pol, d_state=cfg.mamba_d_state,
                                     chunk=min(256, h.shape[1]), state=cache)
    elif blk.mixer == "mlstm":
        y, new_cache = mlstm_forward(p["mlstm"], h, pol, chunk=min(256, h.shape[1]), state=cache)
    elif blk.mixer == "slstm":
        y, new_cache = slstm_forward(p["slstm"], h, pol, state=cache)
    else:
        local = blk.mixer == "local_attn"
        y, new_cache = attention_block(
            p["attn"], h, lay, pol, pos=pos, causal=True, window=cfg.window if local else 0,
            theta=cfg.rope_local_theta if (local and cfg.rope_local_theta) else cfg.rope_theta,
            rope_pct=cfg.rope_pct, rope_kind=cfg.rope_kind,
            mrope_sections=_mrope_sections(cfg) if cfg.rope_kind == "mrope" else None,
            norm_kind=cfg.norm_kind, cache=cache)
    return pol.shard(x + y, "act_btd"), new_cache


def _apply_ffn(blk: Block, p: dict, x: torch.Tensor, cfg: ArchConfig, pol: Policy, *,
               inv_place=None):
    """The block's second half, ``x + ffn(norm(x))`` (``x`` itself for
    ``ffn == "none"``).  Returns ``(x, moe_stats)``, ``moe_stats =
    (counts, overflow, aux_loss)`` for a MoE block, else ``None``."""
    if blk.ffn == "none":
        return x, None
    h = apply_norm(p["ln2"], x, cfg.norm_kind)
    if blk.ffn == "dense":
        return pol.shard(x + apply_ffn(p["ffn"], h, cfg.ffn_kind, pol), "act_btd"), None
    out = _moe_fn(h, pol)(p["moe"], h, cfg.moe, cfg.ffn_kind, pol, inv_place)
    return pol.shard(x + out.y, "act_btd"), (out.counts, out.overflow, out.aux_loss)


def _apply_block(blk: Block, p: dict, x: torch.Tensor, cfg: ArchConfig, lay: HeadLayout,
                 pol: Policy, *, pos, cache=None, inv_place=None):
    """Pre-norm residual block.  Returns ``(x, new_cache, moe_stats)``."""
    x, new_cache = _apply_mixer(blk, p, x, cfg, lay, pol, pos=pos, cache=cache)
    x, moe_stats = _apply_ffn(blk, p, x, cfg, pol, inv_place=inv_place)
    return x, new_cache, moe_stats


def _remat_period(x: torch.Tensor, first: int, params: dict, cfg: ArchConfig, lay: HeadLayout,
                  pol: Policy, *, pos, inv_place=None):
    """One period's blocks (layers ``first`` to ``first + len(pattern) - 1``)
    under activation checkpointing.  Returns ``(x, [moe_stats, ...])``.

    ``"nothing"`` runs the whole period as one checkpointed segment: the
    backward recomputes every block.  ``"save_moe"`` runs each MoE FFN half
    outside the segments, so its activations are kept and its dispatch is
    never recomputed (the reference's intent: "never re-run the expert
    all-to-all in the backward pass"), and checkpoints the runs of halves
    between them.  The MoE statistics leave a segment as its outputs."""
    halves = [(first + j, half) for j in range(len(cfg.pattern)) for half in ("mixer", "ffn")]

    def run(x, part):
        stats = []
        for i, half in part:
            blk, p = cfg.pattern[i % len(cfg.pattern)], params["layers"][i]
            if half == "mixer":
                x, _ = _apply_mixer(blk, p, x, cfg, lay, pol, pos=pos)
            else:
                x, ms = _apply_ffn(blk, p, x, cfg, pol, inv_place=inv_place)
                if ms is not None:
                    stats.append(ms)
        return x, stats

    def kept(i, half):
        return (pol.remat_policy == "save_moe" and half == "ffn"
                and cfg.pattern[i % len(cfg.pattern)].ffn == "moe")

    stats = []
    for keep, part in itertools.groupby(halves, key=lambda ih: kept(*ih)):
        part = list(part)
        if keep:
            x, st = run(x, part)
        else:
            x, st = torch.utils.checkpoint.checkpoint(run, x, part, use_reentrant=False)
        stats += st
    return x, stats


def _mrope_sections(cfg: ArchConfig) -> tuple:
    """M-RoPE's (t, h, w) split of the ``hd_rot / 2`` rotary frequencies:
    a quarter to t, the rest halved between h and w ((16, 24, 24) at hd
    128)."""
    half = int(cfg.head_dim * cfg.rope_pct) // 2
    t = half // 4
    rest = half - t
    return (t, rest // 2, rest - rest // 2)


def _positions(cfg: ArchConfig, b: int, s: int, offset, device=None) -> torch.Tensor:
    """int32 ``[B, S]`` positions ``offset + arange(S)`` (offset an int or
    an int ``[B]`` tensor); ``[3, B, S]`` for M-RoPE, the three streams
    equal (the reference's text stub, t = h = w)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        pos = pos + offset.to(torch.int32)[:, None]
    else:
        pos = pos + offset
    pos = pos.expand(b, s)
    if cfg.rope_kind == "mrope":
        return pos[None].expand(3, b, s)
    return pos


def backbone(params: dict, x: torch.Tensor, cfg: ArchConfig, pol: Policy, *, pos,
             cache: dict | None = None, inv_place: torch.Tensor | None = None):
    """Embedded input ``[B, S, d]`` -> final hidden ``[B, S, d]``.

    Returns ``(x, cache, moe_counts, overflow, aux_loss)`` as the reference
    does: ``moe_counts`` f32[E] summed over the periodic MoE layers (``None``
    without MoE; empty where a MoE config's periodic blocks hold no MoE
    FFN), their dropped pairs summed, and their aux losses summed
    over the number of periods (the mean over periods of each period's
    sum; the tail's MoE stats are not counted, as in the reference).  Each
    layer's returned cache is stored back in ``cache`` (the attention
    caches are the same dicts, updated in place; the recurrent states are
    new ones).

    With ``pol.remat``, when autograd records and there is no cache (a
    training forward), each period runs through :func:`_remat_period`; the
    tail blocks never do, as in the reference."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    stats = []
    if pol.remat and cache is None and torch.is_grad_enabled():
        for per in range(cfg.num_periods):
            x, st = _remat_period(x, per * len(cfg.pattern), params, cfg, lay, pol, pos=pos,
                                  inv_place=inv_place)
            stats += st
    else:
        for i, blk in enumerate(layers(cfg)):
            c = cache["layers"][i] if cache is not None else None
            x, nc, ms = _apply_block(blk, params["layers"][i], x, cfg, lay, pol, pos=pos,
                                     cache=c, inv_place=inv_place)
            if cache is not None:
                cache["layers"][i] = nc
            if ms is not None:
                stats.append(ms)
    for j, blk in enumerate(cfg.tail):
        c = cache[f"tail{j}"] if cache is not None else None
        x, nc, _ = _apply_block(blk, params[f"tail{j}"], x, cfg, lay, pol, pos=pos, cache=c,
                                inv_place=inv_place)
        if cache is not None:
            cache[f"tail{j}"] = nc
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    if cfg.moe is None or not stats:
        # filled on the device: an upload of a host scalar would wait for the stream.
        # A MoE config whose periodic blocks hold no MoE FFN (a depth cut of
        # jamba's period) counts no expert: empty counts, as the reference's
        # sum over [periods, 0]
        zeros = torch.zeros(2, dtype=torch.float32, device=x.device)
        counts = None if cfg.moe is None else torch.zeros(0, dtype=torch.float32,
                                                          device=x.device)
        return x, cache, counts, zeros[0], zeros[1]
    counts, overflow, aux = (torch.stack(s) for s in zip(*stats))
    return x, cache, counts.sum(dim=0), overflow.sum(), aux.sum() / cfg.num_periods


# ---------------------------------------------------------------------------
# entry points (train / prefill / decode)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch: dict, cfg: ArchConfig, pol: Policy) -> torch.Tensor:
    """The tokens' embeddings ``[B, S, d]``; with ``vision_embeds [B, V,
    d]`` in the batch (a model with vision tokens), the patches, cast to
    the compute dtype, replace the first ``V`` rows (the reference's stub).
    Raises ``ValueError`` when ``S < V``: the reference's concatenation
    then has ``V`` rows against ``S`` positions and fails."""
    x = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale, d=cfg.d_model, pol=pol)
    if cfg.vision_tokens and "vision_embeds" in batch:
        v = batch["vision_embeds"].to(pol.compute_dtype)
        if x.shape[1] < v.shape[1]:
            raise ValueError(f"a prompt of {x.shape[1]} tokens cannot take {v.shape[1]} patch "
                             f"embeddings: the patches replace the prompt's first rows, so it "
                             f"needs at least {v.shape[1]} tokens")
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return pol.shard(x, "act_btd")


def _unembed_w(params, cfg: ArchConfig):
    return params["lm_head"] if not cfg.tie_embeddings else params["embed"]["tok"]


def loss_fn(params, batch: dict, cfg: ArchConfig, pol: Policy,
            inv_place: torch.Tensor | None = None):
    """Training loss of ``batch`` (``tokens``, ``labels`` int ``[B, S]``,
    ``mask`` bool / float ``[B, S]``): ``(loss, metrics)`` with
    ``metrics = {"overflow"}``, plus ``"expert_counts"`` f32[E] for MoE."""
    tokens = batch["tokens"]
    x = _embed_inputs(params, batch, cfg, pol)
    pos = _positions(cfg, *tokens.shape, 0, device=tokens.device)
    x, _, counts, overflow, aux = backbone(params, x, cfg, pol, pos=pos, inv_place=inv_place)
    loss = chunked_softmax_xent(x, _unembed_w(params, cfg), batch["labels"], batch["mask"], pol,
                                cfg.vocab_size, softcap=cfg.logit_softcap)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    metrics = {"overflow": overflow}
    if counts is not None:
        metrics["expert_counts"] = counts
    return loss, metrics


def prefill(params, batch: dict, cfg: ArchConfig, pol: Policy, max_len: int,
            inv_place: torch.Tensor | None = None):
    """Fill caches for the prompt ``batch["tokens"] [B, S]``; return the
    last token's logits ``[B, 1, Vp]`` and the cache."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, pol, device=tokens.device)
    x = _embed_inputs(params, batch, cfg, pol)
    pos = _positions(cfg, b, s, 0, device=tokens.device)
    x, cache, _, _, _ = backbone(params, x, cfg, pol, pos=pos, cache=cache,
                                 inv_place=inv_place)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    logits = unembed_logits(x[:, -1:], _unembed_w(params, cfg), pol)
    return logits, cache


def decode_step(params, cache: dict, tokens: torch.Tensor, cfg: ArchConfig, pol: Policy,
                inv_place: torch.Tensor | None = None):
    """One token step.  tokens ``[B, 1]``.  Returns ``(logits [B, 1, Vp],
    cache)``; ``cache`` is updated in place."""
    b = tokens.shape[0]
    x = embed(params["embed"], tokens, scale=cfg.embed_scale, d=cfg.d_model, pol=pol)
    pos = _positions(cfg, b, 1, cache["pos"], device=tokens.device)
    x, cache, _, _, _ = backbone(params, x, cfg, pol, pos=pos, cache=cache,
                                 inv_place=inv_place)
    cache["pos"] = cache["pos"] + 1
    return unembed_logits(x, _unembed_w(params, cfg), pol), cache
