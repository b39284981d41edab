"""jamba-v0.1-52b [hybrid]: 32L d=4096, mamba:attn 7:1 (attention at offset 4
of each 8-layer block), 32H (kv 8) on attention layers, d_ff=14336, MoE 16
experts top-2 on every other layer, vocab=65536, ssm_state=16.
Hybrid => long_500k runs. [arXiv:2403.19887; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, d_ff_expert=128, vocab_size=512, n_experts=4, top_k=2,
        ssm_state=4)
