"""whisper-base [audio]: enc-dec, conv frontend stubbed (precomputed frame
embeddings).  6L encoder + 6L decoder, d=512, 8H (kv=8), d_ff=2048,
vocab=51865.  [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    pattern=(Block("attn", "dense"),),
    ffn_kind="gelu",
    norm_kind="layernorm",
    rope_kind="learned",
    encdec=True,
    enc_layers=6,
    enc_len=1500,
    tie_embeddings=True,
    subquadratic=False,
    notes="audio frontend is a stub: input_specs() provides [B, 1500, d] frame embeddings",
)
