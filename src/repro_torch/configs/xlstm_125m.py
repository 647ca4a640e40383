"""xlstm-125m [ssm]: 12L, d=768, 4H, vocab=50304, alternating mLSTM/sLSTM
blocks (pre-up-projection blocks, no separate FFN: d_ff=0).
[arXiv:2405.04517]"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    pattern=(Block("mlstm", "none"), Block("slstm", "none")),
    norm_kind="layernorm",
    rope_kind="none",
    tie_embeddings=True,
    subquadratic=True,  # recurrent state, O(1) per decoded token
    notes="attention-free; long_500k runs with O(1) recurrent state",
)
