"""llama4-maverick-400b-a17b [moe]: 48L, d=5120, 40H (kv=8), vocab=202048,
MoE 128 experts top-1 (interleaved every other layer, d_ff_expert=8192,
shared expert) + dense layers d_ff=16384.  [hf:meta-llama/Llama-4 family]"""
from repro_torch.configs.base import ArchConfig, Block, MoESpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=202048,
    pattern=(Block("attn", "dense"), Block("attn", "moe")),
    moe=MoESpec(num_experts=128, top_k=1, d_ff_expert=8192, shared_expert=True),
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=False,
    subquadratic=False,
    notes="DR/KIP expert placement applies (128e top-1 is maximally skew-prone); long_500k skipped (full attention)",
)
