"""falcon-mamba-7b [ssm]: 64L d=4096 attention-free mamba1, ssm_state=16,
vocab=65024. SSM => long_500k runs. [arXiv:2410.05355; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    layer_pattern=("mamba",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=512, ssm_state=4)
