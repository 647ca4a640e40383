"""Module substrate: the dtype policy, parameter init, norms, embeddings,
activations and the FFN (a port of ``repro.models.modules``).

Parameters are nested dicts of tensors.  Random init draws from an
explicit ``torch.Generator`` on the target device, so the same seed gives
the same weights on that device; it does not give the reference's
``jax.random`` weights (``repro_torch.carry.params_from_jax`` carries
those across).  ``chunked_softmax_xent`` is training and is not ported
(ROADMAP.md, queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "Policy",
    "act_fn",
    "apply_ffn",
    "apply_norm",
    "embed",
    "init_embed",
    "init_ffn",
    "init_norm",
    "no_shard",
    "normal",
    "pad_vocab",
    "unembed_logits",
]

Shard = Callable[[torch.Tensor, str], torch.Tensor]  # (x, logical_name) -> x


def no_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class Policy:
    """dtype policy threaded through the model (one device: ``shard`` is
    the identity and ``tp`` only pads the head layout).

    ``mesh``, ``remat`` and the MoE fields of the reference's policy are
    kept so that setting one fails loudly: they raise
    ``NotImplementedError`` (ROADMAP.md, queue 1 items 9 and 10)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    shard: Shard = no_shard
    tp: int = 1                      # head padding target
    mesh: object = None
    remat: bool = False
    attn_q_chunk: int = 2048         # the plain flash version's chunks
    attn_kv_chunk: int = 2048
    attn_block_skip: bool = True     # skip fully-masked kv blocks
    attn_p_bf16: bool = False        # bf16 softmax weights for the PV product
    remat_policy: str = "nothing"
    moe_capacity_factor: float = 0.0
    exchange_backend: object = None

    def __post_init__(self):
        for field, unset, item in (("mesh", None, 10), ("remat", False, 10),
                                   ("remat_policy", "nothing", 10),
                                   ("moe_capacity_factor", 0.0, 9),
                                   ("exchange_backend", None, 9)):
            if getattr(self, field) != unset:
                raise NotImplementedError(
                    f"Policy.{field}={getattr(self, field)!r} is not ported yet "
                    f"(ROADMAP.md, queue 1 item {item})")


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on ``gen``'s device, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.zeros((d,), dtype=dtype, device=device)}  # gemma-style (1 + w)
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        nx = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (nx * (1.0 + p["w"].to(torch.float32))).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    nx = (xf - mu) * torch.rsqrt(var + eps)
    return (nx * p["w"].to(torch.float32) + p["b"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def pad_vocab(v: int, mult: int = 256) -> int:
    return int(np.ceil(v / mult) * mult)


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    return {"tok": normal(gen, (pad_vocab(vocab), d), d**-0.5, dtype)}


def embed(p: dict, tokens: torch.Tensor, *, scale: bool, d: int, pol: Policy) -> torch.Tensor:
    x = p["tok"][tokens.long()].to(pol.compute_dtype)
    if scale:
        # the sqrt(d) factor is rounded to the compute dtype first
        x = x * float(torch.tensor(np.sqrt(d), dtype=pol.compute_dtype))
    return x


def unembed_logits(x: torch.Tensor, w: torch.Tensor, pol: Policy) -> torch.Tensor:
    """``[..., d] @ [V, d]^T -> [..., V]``."""
    return pol.shard(torch.matmul(x, w.to(pol.compute_dtype).t()), "logits")


# ---------------------------------------------------------------------------
# activations / ffn
# ---------------------------------------------------------------------------


def act_fn(kind: str):
    if kind in ("swiglu",):
        return F.silu
    if kind in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def init_ffn(gen: torch.Generator, d: int, f: int, kind: str, dtype) -> dict:
    gate = 2 if kind in ("swiglu", "geglu") else 1
    return {
        "wi": normal(gen, (d, gate, f), d**-0.5, dtype),
        "wo": normal(gen, (f, d), f**-0.5, dtype),
    }


def apply_ffn(p: dict, x: torch.Tensor, kind: str, pol: Policy) -> torch.Tensor:
    """``x [B, S, d]``; ``wi [d, gate, f]``, ``wo [f, d]``."""
    wi = p["wi"].to(pol.compute_dtype)
    d, gate, f = wi.shape
    h = torch.matmul(x, wi.reshape(d, gate * f)).unflatten(-1, (gate, f))
    h = pol.shard(h, "ffn_hidden4")
    a = act_fn(kind)
    h = a(h[..., 0, :]) * h[..., 1, :] if gate == 2 else a(h[..., 0, :])
    return torch.matmul(h, p["wo"].to(pol.compute_dtype))
