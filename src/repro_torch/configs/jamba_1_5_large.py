"""jamba-1.5-large-398b [hybrid]: 72L, d=8192, 64H (kv=8), d_ff=24576,
vocab=65536, Mamba:attention 7:1 interleave, MoE 16e top-2 every other layer.
9 periods of the 8-layer Jamba block (attention at position 3, MoE at odd
positions).  [arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig, Block, MoESpec

_M = lambda ffn: Block("mamba", ffn)
_A = lambda ffn: Block("attn", ffn)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=(
        _M("dense"), _M("moe"), _M("dense"), _A("moe"),
        _M("dense"), _M("moe"), _M("dense"), _M("moe"),
    ),
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=24576, shared_expert=False),
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    mamba_d_state=16,
    mamba_expand=2,
    mamba_conv=4,
    tie_embeddings=False,
    subquadratic=True,  # 63/72 layers are Mamba; attention KV is seq-sharded
    notes="DR/KIP expert placement applies; long_500k runs (hybrid)",
)
