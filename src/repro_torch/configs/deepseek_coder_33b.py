"""deepseek-coder-33b [dense]: llama-arch, 62L, d=7168, 56H (GQA kv=8),
d_ff=19200, vocab=32256.  [arXiv:2401.14196]"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    pattern=(Block("attn", "dense"),),
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=100_000.0,
    tie_embeddings=False,
    subquadratic=False,
    notes="long_500k skipped: pure full-attention decoder",
)
