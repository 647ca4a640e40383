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
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.modules import Policy

__all__ = ["decode_step", "init_cache", "init_params", "is_encdec", "loss_fn", "prefill",
           "vision_embeds"]


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.encdec


def init_params(cfg: ArchConfig, seed: int, pol: Policy, *, device=None) -> dict:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    (``device=None``: the CUDA device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if is_encdec(cfg):
        return encdec.init_params(cfg, gen, pol)
    return transformer.init_params(cfg, gen, pol)


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
