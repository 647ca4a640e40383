"""Decoder-only LM assembled from the config's block pattern, for training
and serving (a port of ``repro.models.transformer`` for ``attn`` /
``local_attn`` mixers with dense or MoE FFNs).

The reference scans over *periods* with weights stacked ``[periods,
...]``; eager PyTorch needs no scan, so parameters and caches hold one
entry per layer: ``params["layers"][i]`` is layer ``i = period *
len(pattern) + j`` (pattern position ``j``), and the non-repeating tail
blocks stay ``params["tail{j}"]``, as in the reference.

A ``moe`` FFN runs ``repro_torch.moe.layer`` with the reference's rule:
the dense oracle ``moe_ref`` without EP shards (``Policy.ep_shards == 0``,
the reference's ``mesh=None``), else ``moe_apply`` when the sequence
splits over the shards and is longer than one token, else
``moe_apply_replicated``.  ``inv_place`` (logical expert -> physical slot,
``None``: the identity) is the KIP placement the expert weights are laid
out by.

``loss_fn`` is the training loss: the backbone under autograd (the flash
kernel's backward on the card), then ``chunked_softmax_xent``, plus the
MoE layers' auxiliary loss.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item:
the ``mamba``, ``mlstm`` and ``slstm`` mixers, M-RoPE and vision tokens.
"""
from __future__ import annotations

from typing import Any

import torch

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
from repro_torch.moe.layer import init_moe, moe_apply, moe_apply_replicated, moe_ref

__all__ = ["backbone", "decode_step", "init_cache", "init_params", "loss_fn", "prefill"]

_UNPORTED_MIXERS = {"mamba": "the Mamba mixer (models/ssm.py)",
                    "mlstm": "the mLSTM mixer (models/xlstm.py)",
                    "slstm": "the sLSTM mixer (models/xlstm.py)"}


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1 item {item})")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for any part of ``cfg`` this port does not run yet."""
    for blk in cfg.pattern + cfg.tail:
        if blk.mixer in _UNPORTED_MIXERS:
            raise _not_ported(_UNPORTED_MIXERS[blk.mixer], 10)
    if cfg.rope_kind == "mrope":
        raise _not_ported("M-RoPE", 10)
    if cfg.vision_tokens:
        raise _not_ported("vision tokens", 10)


def layers(cfg: ArchConfig) -> list[Block]:
    """The periodic blocks in execution order (``params["layers"]``)."""
    return [blk for _ in range(cfg.num_periods) for blk in cfg.pattern]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ArchConfig, blk: Block, lay: HeadLayout,
                pol: Policy) -> dict:
    dt, dev = pol.param_dtype, gen.device
    p: dict[str, Any] = {"ln1": init_norm(cfg.norm_kind, cfg.d_model, dt, dev)}
    p["attn"] = init_attention(gen, cfg.d_model, lay, cfg.head_dim, qk_norm=cfg.qk_norm,
                               norm_kind=cfg.norm_kind, dtype=dt)
    if blk.ffn == "dense":
        p["ln2"] = init_norm(cfg.norm_kind, cfg.d_model, dt, dev)
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dt)
    elif blk.ffn == "moe":
        p["ln2"] = init_norm(cfg.norm_kind, cfg.d_model, dt, dev)
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe, cfg.ffn_kind, dt)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, pol: Policy) -> dict:
    """Random parameters drawn from ``gen`` on its device."""
    check_supported(cfg)
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    params: dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, pol.param_dtype),
        "final_norm": init_norm(cfg.norm_kind, cfg.d_model, pol.param_dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (pad_vocab(cfg.vocab_size), cfg.d_model),
                                   cfg.d_model**-0.5, pol.param_dtype)
    params["layers"] = [_init_block(gen, cfg, blk, lay, pol) for blk in layers(cfg)]
    for j, blk in enumerate(cfg.tail):
        params[f"tail{j}"] = _init_block(gen, cfg, blk, lay, pol)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, pol: Policy, *,
               device=None) -> dict:
    """Decode caches, one per layer (a ring cache for ``local_attn``)."""
    check_supported(cfg)
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)

    def one(blk: Block) -> dict:
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
    """The reference's path rule (``pol.ep_shards`` stands for the mesh's
    model-axis size; no shards is its ``mesh=None``)."""
    if pol.ep_shards == 0:
        return moe_ref
    if h.shape[1] % pol.ep_shards == 0 and h.shape[1] > 1:
        return moe_apply             # prefill: the sequence splits over the shards
    return moe_apply_replicated      # decode: tokens replicated over EP


def _apply_block(blk: Block, p: dict, x: torch.Tensor, cfg: ArchConfig, lay: HeadLayout,
                 pol: Policy, *, pos, cache=None, inv_place=None):
    """Pre-norm residual block.  Returns ``(x, new_cache, moe_stats)``,
    ``moe_stats = (counts, overflow, aux_loss)`` for a MoE block, else
    ``None``."""
    h = apply_norm(p["ln1"], x, cfg.norm_kind)
    local = blk.mixer == "local_attn"
    y, new_cache = attention_block(
        p["attn"], h, lay, pol, pos=pos, causal=True, window=cfg.window if local else 0,
        theta=cfg.rope_local_theta if (local and cfg.rope_local_theta) else cfg.rope_theta,
        rope_pct=cfg.rope_pct, rope_kind=cfg.rope_kind, norm_kind=cfg.norm_kind,
        cache=cache)
    x = pol.shard(x + y, "act_btd")
    moe_stats = None
    if blk.ffn == "dense":
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        x = pol.shard(x + apply_ffn(p["ffn"], h, cfg.ffn_kind, pol), "act_btd")
    elif blk.ffn == "moe":
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        out = _moe_fn(h, pol)(p["moe"], h, cfg.moe, cfg.ffn_kind, pol, inv_place)
        moe_stats = (out.counts, out.overflow, out.aux_loss)
        x = pol.shard(x + out.y, "act_btd")
    return x, new_cache, moe_stats


def _positions(cfg: ArchConfig, b: int, s: int, offset, device=None) -> torch.Tensor:
    """int32 ``[B, S]`` positions ``offset + arange(S)`` (offset an int or
    an int ``[B]`` tensor)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        pos = pos + offset.to(torch.int32)[:, None]
    else:
        pos = pos + offset
    return pos.expand(b, s)


def backbone(params: dict, x: torch.Tensor, cfg: ArchConfig, pol: Policy, *, pos,
             cache: dict | None = None, inv_place: torch.Tensor | None = None):
    """Embedded input ``[B, S, d]`` -> final hidden ``[B, S, d]``.

    Returns ``(x, cache, moe_counts, overflow, aux_loss)`` as the reference
    does: ``moe_counts`` f32[E] summed over the periodic MoE layers (``None``
    without MoE), their dropped pairs summed, and their aux losses summed
    over the number of periods (the mean over periods of each period's
    sum; the tail's MoE stats are not counted, as in the reference).  The
    cache's layers are updated in place."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    stats = []
    for i, blk in enumerate(layers(cfg)):
        c = cache["layers"][i] if cache is not None else None
        x, _, ms = _apply_block(blk, params["layers"][i], x, cfg, lay, pol, pos=pos, cache=c,
                                inv_place=inv_place)
        if ms is not None:
            stats.append(ms)
    for j, blk in enumerate(cfg.tail):
        c = cache[f"tail{j}"] if cache is not None else None
        x, _, _ = _apply_block(blk, params[f"tail{j}"], x, cfg, lay, pol, pos=pos, cache=c,
                               inv_place=inv_place)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    if cfg.moe is None:
        # filled on the device: an upload of a host scalar would wait for the stream
        zeros = torch.zeros(2, dtype=torch.float32, device=x.device)
        return x, cache, None, zeros[0], zeros[1]
    counts, overflow, aux = (torch.stack(s) for s in zip(*stats))
    return x, cache, counts.sum(dim=0), overflow.sum(), aux.sum() / cfg.num_periods


# ---------------------------------------------------------------------------
# entry points (train / prefill / decode)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch: dict, cfg: ArchConfig, pol: Policy) -> torch.Tensor:
    if cfg.vision_tokens:
        raise _not_ported("vision tokens", 10)
    x = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale, d=cfg.d_model, pol=pol)
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
