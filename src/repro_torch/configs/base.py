"""Architecture + shape configuration system (port of
`repro.configs.base`, a copy: the port imports nothing of the JAX
package).

Every assigned architecture is a frozen `ArchConfig`; the launcher selects
one with ``--arch <id>`` (see `configs/registry.py`). Shapes are the
assignment's four input-shape cells; `long_500k` is only valid for archs
with sub-quadratic attention structure (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_norms: bool = False       # gemma2 pre+post norm sandwich
    embed_scale: bool = False      # gemma: embeddings scaled by sqrt(d)

    # Per-layer structure: `layer_pattern` is cycled over the depth. Entries:
    # "attn" (global), "local" (windowed), "chunked" (llama4-style chunks),
    # "mamba" (SSM block).
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                # local-attention window
    attn_chunk: int = 0            # chunked-attention chunk length
    nope_every: int = 0            # every Nth layer: global + no RoPE (iRoPE)
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1             # MoE on layers where (l % moe_every)==moe_offset
    moe_offset: int = 0
    first_dense: int = 0           # leading dense layers
    capacity_factor: float = 1.25
    router_dtype: str = "float32"  # router numerics pinned high (DESIGN §4)

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 => ceil(d_model/16)

    # Modality frontend stub
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_prefix_embeds: int = 0       # vision stub: precomputed patch embeds

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def layer_kind(self, layer: int) -> str:
        kind = self.layer_pattern[layer % len(self.layer_pattern)]
        if kind in ("attn", "local", "chunked") and self.nope_every and \
                (layer + 1) % self.nope_every == 0:
            return "attn"          # iRoPE global layer
        return kind

    def is_moe_layer(self, layer: int) -> bool:
        """MoE replaces the FFN on matching layers — including mamba layers
        (Jamba's blocks are mixer + MLP, with MoE on every other layer)."""
        if self.n_experts == 0:
            return False
        if layer < self.first_dense:
            return False
        return (layer % self.moe_every) == self.moe_offset

    @property
    def pattern_len(self) -> int:
        """Length of the repeating block for scan-over-layers (lcm of the
        attention pattern, the MoE cycle, and the iRoPE cycle)."""
        import math
        p = len(self.layer_pattern)
        if self.n_experts:
            p = math.lcm(p, self.moe_every)
        if self.nope_every:
            p = math.lcm(p, self.nope_every)
        return p

    # -- analytic parameter counts (for 6ND roofline bookkeeping) ----------
    def params_per_layer(self, layer: int) -> int:
        d = self.d_model
        kind = self.layer_kind(layer)
        n = 2 * d                                   # norms
        if kind == "mamba":
            di, ds, dtr = self.d_inner, self.ssm_state, self.dt_rank
            n += d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * ds)
            n += dtr * di + di * ds + di + di * d   # dt_proj, A, D, out
            # fall through to the FFN/MoE accounting (Jamba-style blocks);
            # pure-SSM archs have d_ff == 0 and add nothing.
        elif self.use_mla:
            r, rk = self.kv_lora_rank, self.rope_head_dim
            qd = self.head_dim + rk
            vd = self.v_head_dim or self.head_dim
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qd
            else:
                n += d * self.n_heads * qd
            n += d * (r + rk)                       # kv down + k_rope
            n += r * self.n_heads * (self.head_dim + vd)
            n += self.n_heads * vd * d
        else:
            hd = self.head_dim
            n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            n += self.n_heads * hd * d
        # ffn / moe
        if self.is_moe_layer(layer):
            dff = self.d_ff_expert or self.d_ff
            n += self.n_experts * 3 * d * dff
            n += self.n_shared_experts * 3 * d * dff
            n += d * self.n_experts                 # router
        else:
            n += 3 * d * self.d_ff if self.d_ff else 0
        return n

    def params_total(self) -> int:
        n = self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model     # lm head
        n += self.d_model                           # final norm
        n += sum(self.params_per_layer(l) for l in range(self.n_layers))
        return n

    def params_active(self) -> int:
        """Active (per-token) parameters — the MoE 6ND denominator."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model
        for l in range(self.n_layers):
            if self.is_moe_layer(l):
                d = self.d_model
                dff = self.d_ff_expert or self.d_ff
                full = self.params_per_layer(l)
                routed = self.n_experts * 3 * d * dff
                active = self.top_k * 3 * d * dff
                n += full - routed + active
            else:
                n += self.params_per_layer(l)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_long_context(cfg: ArchConfig) -> bool:
    """long_500k runs only for sub-quadratic attention structures
    (SSM / hybrid / windowed / chunked); pure global attention is skipped
    with a DESIGN.md §4 note."""
    kinds = {cfg.layer_kind(l) for l in range(cfg.n_layers)}
    if kinds == {"attn"}:
        return False
    return True


def valid_cells(cfg: ArchConfig):
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if supports_long_context(cfg):
        names.append("long_500k")
    return [SHAPES[n] for n in names]
