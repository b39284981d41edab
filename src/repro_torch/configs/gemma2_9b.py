"""gemma2-9b [dense]: 42L d=3584 16H (kv 8, head_dim 256) d_ff=14336
vocab=256000, GeGLU, alternating local(4096)/global attention, attn softcap
50 and final logit softcap 30, pre+post norms, tied + scaled embeddings.
Hybrid-local => long_500k runs (global half carries the 512k KV, sharded).
[arXiv:2408.00118; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    act="gelu",
    layer_pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, window=16)
