"""gemma3-27b [dense]: 62L, d=5376, 32H (kv=16), d_ff=21504, vocab=262144.
5:1 local:global attention, 128k context, GeGLU, qk-norm, scaled embeddings.
62 layers = 10 periods of [5 local + 1 global] + 2 local tail.
[hf:google/gemma-3 family]"""
from repro_torch.configs.base import ArchConfig, Block

_L = Block("local_attn", "dense")
_G = Block("attn", "dense")

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=(_L, _L, _L, _L, _L, _G),
    tail=(_L, _L),
    window=1024,
    ffn_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    rope_local_theta=10_000.0,
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=True,  # only 1/6 of layers keep a full-length KV cache
    notes="long_500k runs: local layers cache a 1024 window; global layers seq-shard KV",
)
