"""llama4-scout-17b-a16e [moe]: 48L, d=5120, 40H (kv=8), vocab=202048,
MoE 16 experts top-1 every layer (d_ff_expert=8192, shared expert).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ArchConfig, Block, MoESpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(Block("attn", "moe"),),
    moe=MoESpec(num_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=False,
    subquadratic=False,
    notes="DR/KIP expert placement applies; long_500k skipped (full attention)",
)
