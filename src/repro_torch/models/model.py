"""Model facade: family dispatch (a port of ``repro.models.model``): the
decoder-only families to ``models/transformer.py``, the enc-dec family
(``cfg.encdec``, whisper-base) to ``models/encdec.py``.

``init_params`` runs on the card unless the caller passes
``device="cpu"``; without a card it raises, never falling back to the CPU.
``loss_fn``, ``prefill``, ``decode_step`` and ``init_cache`` run where
their inputs lie.  An enc-dec batch carries ``enc_embeds [B, enc_len,
d]`` beside its tokens, and its caches come from ``prefill`` alone:
``init_cache`` raises ``ValueError``, as the reference's does.  A model
with vision tokens (qwen2-vl) may carry ``vision_embeds [B,
vision_tokens, d]``, its stubbed frontend's patches, as the reference's
``input_specs`` lays them out; ``vision_embeds`` draws seeded ones.
"""
from __future__ import annotations

import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import head_layout, init_kv_cache
from repro_torch.models.modules import Policy

__all__ = ["ShapeOnly", "abstract_params", "decode_input_specs", "decode_step", "init_cache",
           "init_params", "input_specs", "is_encdec", "loss_fn", "prefill", "vision_embeds"]

META = torch.device("meta")


class ShapeOnly:
    """The stand-in for a ``torch.Generator`` on the meta device, where a
    generator cannot live: ``modules.normal`` draws nothing from it and
    returns an empty meta tensor."""

    device = META


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.encdec


def init_params(cfg: ArchConfig, seed: int, pol: Policy, *, device=None,
                experts=None) -> dict:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    (``device=None``: the CUDA device).  ``device="meta"`` gives their
    shapes and dtypes only (:func:`abstract_params`).  ``experts`` keeps
    only those logical experts, in slot order, in every MoE layer
    (``carry.init_rank_params``)."""
    if device is not None and torch.device(device) == META:
        gen = ShapeOnly()
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
    if is_encdec(cfg):
        if experts is not None:
            raise ValueError(f"{cfg.name} has no MoE layers to keep experts of")
        return encdec.init_params(cfg, gen, pol)
    return transformer.init_params(cfg, gen, pol, experts)


def loss_fn(params, batch, cfg: ArchConfig, pol: Policy, inv_place=None):
    if is_encdec(cfg):
        return encdec.loss_fn(params, batch, cfg, pol, inv_place)
    return transformer.loss_fn(params, batch, cfg, pol, inv_place)


def prefill(params, batch, cfg: ArchConfig, pol: Policy, max_len: int, inv_place=None):
    if is_encdec(cfg):
        return encdec.prefill(params, batch, cfg, pol, max_len, inv_place)
    return transformer.prefill(params, batch, cfg, pol, max_len, inv_place)


def decode_step(params, cache, tokens, cfg: ArchConfig, pol: Policy, inv_place=None):
    if is_encdec(cfg):
        return encdec.decode_step(params, cache, tokens, cfg, pol, inv_place)
    return transformer.decode_step(params, cache, tokens, cfg, pol, inv_place)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, pol: Policy, *, device=None):
    if is_encdec(cfg):
        raise ValueError("enc-dec caches are produced by prefill()")
    return transformer.init_cache(cfg, batch, max_len, pol, device=resolve_device(device))


def vision_embeds(cfg: ArchConfig, batch: int, pol: Policy, gen: torch.Generator, *,
                  device) -> torch.Tensor:
    """Seeded patch embeddings ``[batch, cfg.vision_tokens, d]`` in
    ``pol.compute_dtype`` on ``device``: standard normal float32 draws from
    ``gen`` (a generator on ``device``), then cast, so the float32 and bf16
    policies see the same patches."""
    if not cfg.vision_tokens:
        raise ValueError(f"{cfg.name} has no vision tokens")
    x = torch.randn((batch, cfg.vision_tokens, cfg.d_model), generator=gen,
                    device=torch.device(device))
    return x.to(pol.compute_dtype)


# ---------------------------------------------------------------------------
# shape-only inputs (the reference's dry-run specs)
# ---------------------------------------------------------------------------


def abstract_params(cfg: ArchConfig, pol: Policy) -> dict:
    """The parameters' shapes and dtypes, as meta tensors (the reference's
    ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, 0, pol, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, pol: Policy) -> dict:
    """The batch of a train or prefill cell, as meta tensors: int32
    ``tokens`` (and ``labels``, float32 ``mask`` to train) ``[B, S]``, and
    the stubbed frontends' ``enc_embeds`` or ``vision_embeds`` in the
    compute dtype."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, device=META)
        batch["mask"] = torch.empty((b, s), dtype=torch.float32, device=META)
    if is_encdec(cfg):
        batch["enc_embeds"] = torch.empty((b, cfg.enc_len, cfg.d_model),
                                          dtype=pol.compute_dtype, device=META)
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.empty((b, cfg.vision_tokens, cfg.d_model),
                                             dtype=pol.compute_dtype, device=META)
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig, pol: Policy):
    """``(cache, tokens)`` of a decode cell as meta tensors, laid out as the
    port's caches are: ``init_cache``'s, or for an enc-dec model what
    ``prefill`` returns (``blocks`` and ``xcaches``, one a decoder
    layer)."""
    b, s = shape.global_batch, shape.seq_len
    if is_encdec(cfg):
        lay = head_layout(cfg.num_heads, cfg.num_kv_heads, pol.tp)
        kv = (b, cfg.enc_len, lay.hkv_p, cfg.head_dim)
        cache = {
            "pos": torch.empty((b,), dtype=torch.int32, device=META),
            "blocks": [init_kv_cache(b, s, lay, cfg.head_dim, dtype=pol.compute_dtype,
                                     device=META) for _ in range(cfg.num_layers)],
            "xcaches": [{"k": torch.empty(kv, dtype=pol.compute_dtype, device=META),
                         "v": torch.empty(kv, dtype=pol.compute_dtype, device=META),
                         "pos": torch.empty((b, cfg.enc_len), dtype=torch.int32, device=META),
                         "offset": cfg.enc_len} for _ in range(cfg.num_layers)],
        }
    else:
        cache = transformer.init_cache(cfg, b, s, pol, device=META)
    return cache, torch.empty((b, 1), dtype=torch.int32, device=META)
