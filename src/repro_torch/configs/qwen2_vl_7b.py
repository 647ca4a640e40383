"""qwen2-vl-7b [vlm]: 28L, d=3584, 28H (kv=4), d_ff=18944, vocab=152064,
M-RoPE, dynamic-resolution vision stubbed (precomputed patch embeddings).
[arXiv:2409.12191]"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pattern=(Block("attn", "dense"),),
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    vision_tokens=256,
    tie_embeddings=False,
    subquadratic=False,
    notes="vision frontend is a stub: input_specs() provides [B, 256, d] patch embeddings; long_500k skipped (full attention)",
)
