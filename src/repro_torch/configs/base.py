"""Architecture + shape configuration system.

Every assigned architecture is a :class:`ArchConfig` built from a repeating
``block pattern`` (the unit the runtime scans over), e.g. gemma3's
``5 local + 1 global`` or jamba's 8-layer Mamba/attention period.  Each block
entry names its mixer (attention / mamba / mlstm / slstm) and its FFN kind
(dense / moe / none).

``ShapeConfig`` encodes the four assigned input shapes; ``Cell`` = one
(arch x shape) dry-run unit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Mixer = Literal["attn", "local_attn", "mamba", "mlstm", "slstm"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class Block:
    mixer: Mixer
    ffn: Ffn = "dense"


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = True
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[Block, ...]
    tail: tuple[Block, ...] = ()     # non-repeating final blocks (gemma3: 62 = 6*10 + 2)
    window: int = 1024               # for local_attn blocks
    moe: MoESpec | None = None
    ffn_kind: str = "swiglu"         # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    rope_kind: str = "rope"          # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # partial rotary (stablelm: 0.25)
    rope_local_theta: float = 0.0    # separate theta for local_attn (gemma3)
    qk_norm: bool = False
    embed_scale: bool = False        # gemma: embeddings scaled by sqrt(d)
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    # enc-dec (whisper)
    encdec: bool = False
    enc_layers: int = 0
    enc_len: int = 0                 # stub frontend sequence length
    # vlm stub
    vision_tokens: int = 0
    # ssm
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    # capability flags
    subquadratic: bool = False       # may run long_500k
    notes: str = ""

    def __post_init__(self):
        assert (self.num_layers - len(self.tail)) % len(self.pattern) == 0, (
            f"{self.name}: {self.num_layers} - tail {len(self.tail)} not a "
            f"multiple of pattern length {len(self.pattern)}"
        )
        assert self.num_heads % self.num_kv_heads == 0

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.tail)) // len(self.pattern)

    # ---- parameter count (for MODEL_FLOPS = 6*N*D) -----------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        n = 0
        n += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        blocks = [(b, self.num_periods) for b in self.pattern] + [(b, 1) for b in self.tail]
        for blk, per in blocks:
            if blk.mixer in ("attn", "local_attn"):
                n += per * d * (self.num_heads + 2 * self.num_kv_heads) * hd
                n += per * self.num_heads * hd * d  # wo
            elif blk.mixer == "mamba":
                di = self.mamba_expand * d
                n += per * (2 * d * di + di * self.mamba_conv + di * (2 * self.mamba_d_state + 2) + di * d)
            elif blk.mixer in ("mlstm", "slstm"):
                di = 2 * d
                n += per * (2 * d * di + 3 * di * di // max(self.num_heads, 1) + di * d + d * di)
            if blk.ffn == "dense":
                gate = 2 if self.ffn_kind in ("swiglu", "geglu") else 1
                n += per * (gate + 1) * d * self.d_ff
            elif blk.ffn == "moe":
                m = self.moe
                gate = 2 if self.ffn_kind in ("swiglu", "geglu") else 1
                e = m.top_k if active_only else m.num_experts
                n += per * e * (gate + 1) * d * m.d_ff_expert
                if m.shared_expert:
                    n += per * (gate + 1) * d * m.d_ff_expert
                n += per * d * m.num_experts  # router
        if self.encdec:
            # encoder self-attn + ffn
            n += self.enc_layers * (d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d)
            n += self.enc_layers * 2 * d * self.d_ff
            # decoder cross-attn
            n += self.num_layers * (d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[str]:
    """Shape cells this arch runs (long_500k only for sub-quadratic archs)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (one period, thin dims)."""
    pat = cfg.pattern
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(moe.num_experts, 4), d_ff_expert=64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=len(pat) + len(cfg.tail),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=moe,
        enc_layers=min(cfg.enc_layers, 2),
        enc_len=min(cfg.enc_len, 32) if cfg.enc_len else 0,
        vision_tokens=min(cfg.vision_tokens, 8) if cfg.vision_tokens else 0,
        window=min(cfg.window, 16),
    )
