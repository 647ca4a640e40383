"""Model facade: family dispatch (a port of ``repro.models.model`` for the
decoder-only families; enc-dec raises ``NotImplementedError``).

``init_params`` runs on the card unless the caller passes
``device="cpu"``; without a card it raises, never falling back to the CPU.
``loss_fn``, ``prefill``, ``decode_step`` and ``init_cache`` run where
their inputs lie.
"""
from __future__ import annotations

import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.modules import Policy

__all__ = ["decode_step", "init_cache", "init_params", "is_encdec", "loss_fn", "prefill"]


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.encdec


def _dense_only(cfg: ArchConfig) -> None:
    if is_encdec(cfg):
        raise NotImplementedError(
            "enc-dec models (models/encdec.py) are not ported yet (ROADMAP.md, queue 1 item 10)")


def init_params(cfg: ArchConfig, seed: int, pol: Policy, *, device=None) -> dict:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    (``device=None``: the CUDA device)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    return transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(int(seed)), pol)


def loss_fn(params, batch, cfg: ArchConfig, pol: Policy, inv_place=None):
    _dense_only(cfg)
    return transformer.loss_fn(params, batch, cfg, pol, inv_place)


def prefill(params, batch, cfg: ArchConfig, pol: Policy, max_len: int, inv_place=None):
    _dense_only(cfg)
    return transformer.prefill(params, batch, cfg, pol, max_len, inv_place)


def decode_step(params, cache, tokens, cfg: ArchConfig, pol: Policy, inv_place=None):
    _dense_only(cfg)
    return transformer.decode_step(params, cache, tokens, cfg, pol, inv_place)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, pol: Policy, *, device=None):
    _dense_only(cfg)
    return transformer.init_cache(cfg, batch, max_len, pol, device=resolve_device(device))
