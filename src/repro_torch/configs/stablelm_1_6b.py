"""stablelm-1.6b [dense]: 24L, d=2048, 32H (kv=32, i.e. MHA), d_ff=5632,
vocab=100352, LayerNorm, partial rotary 25%.  [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    pattern=(Block("attn", "dense"),),
    ffn_kind="swiglu",
    norm_kind="layernorm",
    rope_pct=0.25,
    tie_embeddings=False,
    subquadratic=False,
    notes="long_500k skipped: pure full-attention decoder",
)
