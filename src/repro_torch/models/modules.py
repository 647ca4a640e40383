"""Module substrate: the dtype policy, parameter init, norms, embeddings,
activations and the FFN (a port of ``repro.models.modules``).

Parameters are nested dicts of tensors.  Random init draws from an
explicit ``torch.Generator`` on the target device, so the same seed gives
the same weights on that device; it does not give the reference's
``jax.random`` weights (``repro_torch.carry.params_from_jax`` carries
those across).  ``chunked_softmax_xent`` is the training loss over the
vocab in sequence chunks, each chunk under ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

__all__ = [
    "Policy",
    "act_fn",
    "apply_ffn",
    "apply_norm",
    "chunked_softmax_xent",
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
REMAT_POLICIES = ("nothing", "save_moe")


def no_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class Policy:
    """dtype policy threaded through the model.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.ProcessMesh`: a mesh laid
    over the ranks of a process group; ``None``: one process) runs the
    model SPMD, every rank the same calls on the same inputs, as
    ``launch/sharding.py`` ``make_policy`` sets it up.  Every rank holds
    the activations and the dense leaves whole (``shard``, the reference's
    layout constraint, changes no value: the identity here), and only its
    own expert slots (``carry.rank_params``).  The MoE layers run the
    reference's ``shard_map`` bodies on each rank over the mesh's
    ``tp_axis`` subgroup, the batch over ``dp_axes``
    (``moe/layer.py``).  Anything else as ``mesh``, a bare ``MeshShape``
    included (it has no ranks to run on), raises ``ValueError``; so does
    ``mesh`` with ``ep_shards``.

    ``ep_shards`` stands for what the reference reads as
    ``mesh.shape[tp_axis]`` on one process: the number of expert-parallel
    shards, stacked on the one device.  At 0 (and no mesh) the MoE layers
    run the dense oracle ``moe_ref``, as the reference does with
    ``mesh=None``; ``tp`` alone never switches the path (it pads the head
    layout).  ``moe_capacity_factor`` (0: the config's) and
    ``exchange_backend`` (the dispatch transport: ``"dense"``,
    ``"ragged"``, an instance, or ``None`` for dense) are the reference's.

    ``remat`` checkpoints each period's activations in training
    (``transformer.backbone``): ``remat_policy="nothing"`` recomputes the
    whole period in the backward, ``"save_moe"`` keeps each MoE layer's
    activations and recomputes the rest, so the expert dispatch never runs
    again; any other policy raises ``ValueError``.  ``recurrent_bf16``
    rounds the mLSTM's ``[chunk, chunk]`` weight products' operands to
    bf16 (float32 sums), and ``slstm_unroll`` is the reference's sLSTM
    scan grouping, which changes no bit (``models/xlstm.py``)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    shard: Shard = no_shard
    tp: int = 1                      # model-axis size (head padding target)
    mesh: object = None              # ProcessMesh (None: one process)
    dp_axes: tuple = ("data",)       # batch axes ("pod", "data") multi-pod
    tp_axis: str = "model"
    remat: bool = False
    attn_q_chunk: int = 2048         # the plain flash version's chunks
    attn_kv_chunk: int = 2048
    attn_block_skip: bool = True     # skip fully-masked kv blocks
    attn_p_bf16: bool = False        # bf16 softmax weights for the PV product
    recurrent_bf16: bool = False     # bf16 operands of the mLSTM's weight products
    slstm_unroll: int = 1            # steps per sLSTM scan tick in the reference
    remat_policy: str = "nothing"    # "nothing" | "save_moe"
    moe_capacity_factor: float = 0.0  # 0 = use config value
    exchange_backend: object = None   # MoE dispatch transport
    ep_shards: int = 0               # stacked EP shards (0: the moe_ref path)

    def __post_init__(self):
        if self.mesh is not None:
            from repro_torch.launch.mesh import ProcessMesh

            if not isinstance(self.mesh, ProcessMesh):
                raise ValueError(
                    f"Policy.mesh needs a ProcessMesh (launch.mesh.ProcessMesh: a MeshShape "
                    f"laid over the ranks of a WorkerGroup), got {self.mesh!r}; a bare "
                    f"MeshShape has no ranks to run on")
            if self.ep_shards:
                raise ValueError(f"Policy.mesh and Policy.ep_shards={self.ep_shards} both set: "
                                 f"the mesh's {self.tp_axis!r} axis holds the EP shards")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"Policy.remat_policy must be one of {REMAT_POLICIES}, got "
                             f"{self.remat_policy!r}")
        if self.ep_shards < 0:
            raise ValueError(f"Policy.ep_shards must be >= 0, got {self.ep_shards}")


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on ``gen``'s device, then cast.
    The draw is scaled in place: one of jamba's stacked expert weights is
    25.8 GB in float32, and a second such copy does not fit beside its
    model on an 80 GB card.  A ``gen`` on the meta device
    (:class:`~repro_torch.models.model.ShapeOnly`) draws nothing: the
    result is an empty meta tensor of the shape and dtype."""
    if gen.device.type == "meta":  # shapes only (model.abstract_params)
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


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


# ---------------------------------------------------------------------------
# chunked cross-entropy (huge-vocab safe: never materializes [B, S, V])
# ---------------------------------------------------------------------------


def _xent_chunk(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                pol: Policy, vocab: int, softcap: float) -> torch.Tensor:
    """The summed masked loss of one chunk ``x [B, c, d]``: float32 logits,
    softcap, padded-vocab columns at -1e30, logsumexp minus the gold
    logit."""
    logits = unembed_logits(x, w, pol).to(torch.float32)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    live = torch.arange(w.shape[0], device=x.device) < vocab
    logits = torch.where(live, logits, torch.full((), -1e30, device=x.device))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask.to(torch.float32))


def chunked_softmax_xent(x: torch.Tensor, w_unembed: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, pol: Policy, vocab: int, chunk: int = 512,
                         softcap: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of ``x [B, S, d]`` against ``labels [B, S]`` over
    the ``mask``, in ``max(1, S // chunk)`` sequence chunks as the
    reference cuts them (``S`` must split evenly).  Each chunk runs under
    ``torch.utils.checkpoint``: the forward keeps none of its ``[B, c,
    Vp]`` logits, and the backward rebuilds one chunk's at a time."""
    b, s, d = x.shape
    nchunk = max(1, s // chunk)
    if s % nchunk:
        raise ValueError(f"chunked_softmax_xent: sequence {s} does not split into "
                         f"{nchunk} chunks")
    c = s // nchunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nchunk):
        sl = slice(i * c, (i + 1) * c)
        args = (x[:, sl], w_unembed, labels[:, sl], mask[:, sl], pol, vocab, softcap)
        if torch.is_grad_enabled() and (x.requires_grad or w_unembed.requires_grad):
            part = torch.utils.checkpoint.checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            part = _xent_chunk(*args)
        total = total + part
    return total / torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
