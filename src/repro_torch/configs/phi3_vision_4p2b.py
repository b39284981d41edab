"""phi-3-vision-4.2b [vlm]: phi3-mini backbone (32L d=3072 32H MHA d_ff=8192
vocab=32064) + CLIP frontend STUB: input_specs() supplies precomputed patch
embeddings (B, 256, d_model) injected over the first 256 positions
(transformer.forward prefix_embeds). Pure global attention => long_500k
skipped. [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision_stub",
    n_prefix_embeds=256,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, n_prefix_embeds=8)
