"""Encoder-decoder backbone (whisper-base), a port of
``repro.models.encdec``.

The audio frontend (conv1 / conv2 over mel spectrograms) is a stub, as in
the reference: the batch carries precomputed frame embeddings
``enc_embeds [B, enc_len, d]``.  The encoder is bidirectional attention
blocks over sinusoidal positions; the decoder is causal self-attention,
cross-attention over the encoder's output and a GELU FFN, over learned
positions.

The port's own copies of the reference's pieces (line numbers in
``src/repro/models/encdec.py``): ``MAX_DEC_POS`` (:35), ``_sinusoid``
(:38-42), ``init_params`` (:45-82), ``encode`` (:85-106), ``_decoder``
(:109-131), ``_embed_dec`` (:134-138), ``loss_fn`` (:141-149),
``_precompute_xcache`` (:152-167), ``prefill`` (:170-187) and
``decode_step`` (:190-199).

The reference stacks the layers ``[L, ...]`` and scans over them; here
``params["enc"]`` and ``params["dec"]`` hold one dict per layer, as the
decoder-only port's ``params["layers"]``, and so do the caches:
``cache["blocks"][i]`` (self-attention, updated in place by
``decode_step``) and ``cache["xcaches"][i]`` (the cross-attention's k/v,
computed once by ``prefill`` and never written).  Every flash call runs the
hand-written kernel on the card: the encoder's non-causal self-attention,
the decoder's causal self-attention and its non-causal cross-attention
(decode attention, at one token, is plain PyTorch, as in the reference).

With ``Policy.remat``, when autograd records and there is no cache, each
encoder and decoder layer runs as one non-reentrant
``torch.utils.checkpoint`` segment: the reference's
``jax.checkpoint(body, nothing_saveable)`` over each scanned layer, which
reads no ``remat_policy``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (
    _project,
    attention_block,
    head_layout,
    init_attention,
    init_kv_cache,
    physical_kv,
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
    unembed_logits,
)

__all__ = ["MAX_DEC_POS", "decode_step", "encode", "init_params", "loss_fn", "prefill"]

MAX_DEC_POS = 32_768  # learned decoder position table size (mechanical bound)


def _sinusoid(n: int, d: int) -> np.ndarray:
    """The encoder's ``[n, d]`` position table: computed in float64, then
    cast to float32, as the reference does (equal bit for bit)."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / (10_000 ** (2 * i / d))
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _sinusoid_on(n: int, d: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_sinusoid`` cast to ``dtype`` on ``device``, uploaded once: a
    pageable upload in every call would wait for the whole stream."""
    return torch.from_numpy(_sinusoid(n, d)).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator, pol: Policy) -> dict:
    """Random parameters drawn from ``gen`` on its device, in the
    reference's tree but for the per-layer lists ``enc`` and ``dec``."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    dt, dev, d = pol.param_dtype, gen.device, cfg.d_model

    def attn():
        return init_attention(gen, d, lay, cfg.head_dim, qk_norm=False,
                              norm_kind=cfg.norm_kind, dtype=dt)

    def norm():
        return init_norm(cfg.norm_kind, d, dt, dev)

    def enc_block():
        return {"ln1": norm(), "attn": attn(), "ln2": norm(),
                "ffn": init_ffn(gen, d, cfg.d_ff, cfg.ffn_kind, dt)}

    def dec_block():
        return {"ln1": norm(), "attn": attn(), "lnx": norm(), "xattn": attn(), "ln2": norm(),
                "ffn": init_ffn(gen, d, cfg.d_ff, cfg.ffn_kind, dt)}

    return {
        "embed": init_embed(gen, cfg.vocab_size, d, dt),
        "dec_pos": normal(gen, (MAX_DEC_POS, d), 0.01, dt),
        "enc": [enc_block() for _ in range(cfg.enc_layers)],
        "dec": [dec_block() for _ in range(cfg.num_layers)],
        "enc_ln": norm(),
        "final_norm": norm(),
    }


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def _remat(pol: Policy, cache) -> bool:
    return pol.remat and cache is None and torch.is_grad_enabled()


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def encode(params, enc_embeds: torch.Tensor, cfg: ArchConfig, pol: Policy) -> torch.Tensor:
    """Stubbed-frontend encoder: ``[B, enc_len, d] -> [B, enc_len, d]``."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    b, s, d = enc_embeds.shape
    cd = pol.compute_dtype
    x = enc_embeds.to(cd) + _sinusoid_on(s, d, enc_embeds.device, cd)[None]
    x = pol.shard(x, "act_btd")
    pos = _positions(b, s, enc_embeds.device)

    def body(x, p):
        h = apply_norm(p["ln1"], x, cfg.norm_kind)
        y, _ = attention_block(p["attn"], h, lay, pol, pos=pos, causal=False, rope_kind="none",
                               norm_kind=cfg.norm_kind)
        x = pol.shard(x + y, "act_btd")
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        return pol.shard(x + apply_ffn(p["ffn"], h, cfg.ffn_kind, pol), "act_btd")

    remat = _remat(pol, None)
    for p in params["enc"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(body, x, p, use_reentrant=False)
        else:
            x = body(x, p)
    return apply_norm(params["enc_ln"], x, cfg.norm_kind)


def _decoder(params, x, enc_out, cfg: ArchConfig, pol: Policy, *, pos, caches=None,
             xcaches=None):
    """The decoder layers and the final norm.  ``caches`` (self-attention,
    one a layer) are updated in place; ``xcaches`` (cross-attention) are
    read, else k and v come from ``enc_out``."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)

    def body(x, p, enc_out, cache, xcache):
        h = apply_norm(p["ln1"], x, cfg.norm_kind)
        y, _ = attention_block(p["attn"], h, lay, pol, pos=pos, causal=True, rope_kind="none",
                               norm_kind=cfg.norm_kind, cache=cache)
        x = pol.shard(x + y, "act_btd")
        h = apply_norm(p["lnx"], x, cfg.norm_kind)
        y, _ = attention_block(p["xattn"], h, lay, pol, pos=pos, causal=False, rope_kind="none",
                               norm_kind=cfg.norm_kind, cache=xcache,
                               xkv=enc_out if xcache is None else None,
                               static_cache=xcache is not None)
        x = pol.shard(x + y, "act_btd")
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        return pol.shard(x + apply_ffn(p["ffn"], h, cfg.ffn_kind, pol), "act_btd")

    remat = _remat(pol, caches)
    for i, p in enumerate(params["dec"]):
        cache = caches[i] if caches is not None else None
        xcache = xcaches[i] if xcaches is not None else None
        if remat:
            x = torch.utils.checkpoint.checkpoint(body, x, p, enc_out, cache, xcache,
                                                  use_reentrant=False)
        else:
            x = body(x, p, enc_out, cache, xcache)
    return apply_norm(params["final_norm"], x, cfg.norm_kind)


def _embed_dec(params, tokens: torch.Tensor, offset, cfg: ArchConfig, pol: Policy):
    """Token embeddings plus the learned position rows ``offset + arange(S)``
    (``offset`` an int or an int tensor of one element: the rows are
    gathered on the device, with no sync)."""
    x = embed(params["embed"], tokens, scale=False, d=cfg.d_model, pol=pol)
    idx = torch.arange(tokens.shape[1], dtype=torch.int64, device=tokens.device) + offset
    return x + params["dec_pos"][idx].to(pol.compute_dtype)[None]


# ---------------------------------------------------------------------------
# entry points (train / prefill / decode)
# ---------------------------------------------------------------------------


def loss_fn(params, batch: dict, cfg: ArchConfig, pol: Policy, inv_place=None):
    """Training loss of ``batch`` (``enc_embeds [B, enc_len, d]``,
    ``tokens``, ``labels`` int ``[B, S]``, ``mask [B, S]``): ``(loss,
    {"overflow": 0})``."""
    enc_out = encode(params, batch["enc_embeds"], cfg, pol)
    tokens = batch["tokens"]
    x = pol.shard(_embed_dec(params, tokens, 0, cfg, pol), "act_btd")
    x = _decoder(params, x, enc_out, cfg, pol, pos=_positions(*tokens.shape, tokens.device))
    loss = chunked_softmax_xent(x, params["embed"]["tok"], batch["labels"], batch["mask"], pol,
                                cfg.vocab_size)
    return loss, {"overflow": torch.zeros((), dtype=torch.float32, device=x.device)}


def _precompute_xcache(params, enc_out: torch.Tensor, cfg: ArchConfig, pol: Policy) -> list:
    """Each decoder layer's cross-attention k/v from the encoder's output
    (static: once a prefill, never a decoded token)."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    cd = pol.compute_dtype
    b, s, _ = enc_out.shape
    pos = _positions(b, s, enc_out.device)
    out = []
    for p in params["dec"]:
        k, v = physical_kv(_project(enc_out, p["xattn"]["wk"].to(cd)),
                           _project(enc_out, p["xattn"]["wv"].to(cd)), lay)
        out.append({"k": k, "v": v, "pos": pos, "offset": s})
    return out


def prefill(params, batch: dict, cfg: ArchConfig, pol: Policy, max_len: int, inv_place=None):
    """Encode ``batch["enc_embeds"]`` and run the decoder over the prompt
    ``batch["tokens"] [B, S]``; return the last token's logits ``[B, 1,
    Vp]`` and the cache ``{"pos", "blocks", "xcaches"}``."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
    tokens = batch["tokens"]
    enc_out = encode(params, batch["enc_embeds"], cfg, pol)
    b, s = tokens.shape
    dev = tokens.device
    caches = [init_kv_cache(b, max_len, lay, cfg.head_dim, dtype=pol.compute_dtype, device=dev)
              for _ in range(cfg.num_layers)]
    xcaches = _precompute_xcache(params, enc_out, cfg, pol)
    x = pol.shard(_embed_dec(params, tokens, 0, cfg, pol), "act_btd")
    x = _decoder(params, x, enc_out, cfg, pol, pos=_positions(b, s, dev), caches=caches,
                 xcaches=xcaches)
    logits = unembed_logits(x[:, -1:], params["embed"]["tok"], pol)
    cache = {"pos": torch.full((b,), s, dtype=torch.int32, device=dev), "blocks": caches,
             "xcaches": xcaches}
    return logits, cache


def decode_step(params, cache: dict, tokens: torch.Tensor, cfg: ArchConfig, pol: Policy,
                inv_place=None):
    """One token step.  tokens ``[B, 1]``.  Returns ``(logits [B, 1, Vp],
    cache)``; the self-attention caches and ``cache["pos"]`` are updated in
    place of the old ones, the cross-attention's are read."""
    b = tokens.shape[0]
    x = pol.shard(_embed_dec(params, tokens, cache["pos"][:1], cfg, pol), "act_btd")
    pos = cache["pos"][:, None].expand(b, 1)
    x = _decoder(params, x, None, cfg, pol, pos=pos, caches=cache["blocks"],
                 xcaches=cache["xcaches"])
    cache["pos"] = cache["pos"] + 1
    return unembed_logits(x, params["embed"]["tok"], pol), cache
