"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1, head_dim 256) d_ff=16384
vocab=256000, GeGLU, tied + scaled embeddings. Pure global attention =>
long_500k skipped. [arXiv:2403.08295; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512)
