"""gemma-2b [dense]: 18L, d=2048, 8H MQA (kv=1), head_dim=256, d_ff=16384,
GeGLU, vocab=256000, scaled embeddings.  [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    pattern=(Block("attn", "dense"),),
    ffn_kind="geglu",
    norm_kind="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=False,
    notes="long_500k skipped: pure full-attention decoder",
)
