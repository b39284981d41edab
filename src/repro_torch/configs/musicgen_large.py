"""musicgen-large [audio]: 48L d=2048 32H (kv 32 = MHA) d_ff=8192 vocab=2048
decoder-only over EnCodec tokens. The EnCodec frontend is a STUB:
input_specs() supplies the audio-token ids directly (the backbone is a
standard LM over the 2048-entry codebook). Pure global attention =>
long_500k skipped. [arXiv:2306.05284; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_stub",
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128)
