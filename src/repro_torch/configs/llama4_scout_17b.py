"""llama4-scout-17b-16e [moe]: 48L d=5120 40H (kv 8) d_ff=8192 vocab=202048,
16 routed experts top-1 + 1 shared, chunked local attention (8192) with a
NoPE global layer every 4th (iRoPE) — sub-quadratic => long_500k runs.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=("chunked",),
    attn_chunk=8192,
    nope_every=4,
    rope_theta=500000.0,
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    d_ff_expert=8192,
    moe_every=1,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, d_ff_expert=128, vocab_size=512, n_experts=4, top_k=1,
        attn_chunk=32, nope_every=4)
