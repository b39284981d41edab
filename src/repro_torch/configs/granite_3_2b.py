"""granite-3-2b [dense]: 40L d=2048 32H (kv 8) d_ff=8192 vocab=49155, GQA,
tied embeddings. Pure global attention => long_500k skipped.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512)
