"""deepseek-v2-236b [moe]: 60L d=5120 128H, MLA (kv_lora=512, q_lora=1536,
rope head 64), 2 shared + 160 routed experts top-6 (d_ff_expert=1536),
first layer dense (d_ff=12288). Pure (latent) global attention => long_500k
skipped (DESIGN.md §4). [arXiv:2405.04434; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,            # per-head nope dim
    d_ff=12288,              # dense (first) layer FFN
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    moe_every=1,
    first_dense=1,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, kv_lora_rank=32, q_lora_rank=48,
        rope_head_dim=8, v_head_dim=16, n_experts=8, n_shared_experts=1,
        top_k=2, d_ff_expert=32, first_dense=1)
