"""phi4-mini-3.8b [dense]: 32L d=3072 24H (kv 8) d_ff=8192 vocab=200064,
RoPE + SwiGLU + GQA, tied embeddings. Pure global attention => long_500k
skipped (DESIGN.md §4). [arXiv:2412.08905; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
        d_ff=96, vocab_size=512)
