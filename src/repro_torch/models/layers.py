"""Shared neural layers (port of `repro.models.layers`): functions over
nested dicts of tensors.

Conventions, as in the reference:
  * params are nested dicts of tensors; `init_*` builds them from an
    explicit `torch.Generator`, apply-style functions consume them;
  * params live in `param_dtype` (float32 master by default); compute
    runs in the caller's `dtype`; norm statistics, softmax and router
    logits are pinned to float32;
  * every matmul of the model routes through `dot()` so a precision
    policy (`policy.matmul(x, w, step)`) can swap in emulated-format
    semantics without touching model code. Without one, `dot` is a plain
    `torch.matmul` in the compute dtype: the reference computes it
    outside any Pallas kernel (`jnp.dot` with float32 accumulation, which
    is what cuBLAS and the CPU do for bf16 and float32 operands).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dot(x: torch.Tensor, w: torch.Tensor, policy=None,
        step: str = "default") -> torch.Tensor:
    """Policy-routable matmul: x @ w in x's dtype."""
    if policy is not None:
        return policy.matmul(x, w, step)
    return torch.matmul(x, w.to(x.dtype))


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """A float32 standard normal draw of `shape` times `scale`, cast to
    `dtype` (the reference's `jax.random.normal(...) * scale`)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def init_dense(gen, d_in: int, d_out: int, dtype, device, lead=(),
               scale: Optional[float] = None):
    """(*lead, d_in, d_out) weights, normal with std 1/sqrt(d_in)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (*lead, d_in, d_out), scale, dtype, device)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    xf = x.float()
    return (cap * torch.tanh(xf / cap)).to(x.dtype)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":            # jax.nn.gelu(approximate=True)
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim/2)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    if cos.dim() == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_ffn(gen, d_model: int, d_ff: int, dtype, device, lead=()):
    return {
        "wi_gate": init_dense(gen, d_model, d_ff, dtype, device, lead),
        "wi_up": init_dense(gen, d_model, d_ff, dtype, device, lead),
        "wo": init_dense(gen, d_ff, d_model, dtype, device, lead),
    }


def ffn(params, x: torch.Tensor, act: str, policy=None) -> torch.Tensor:
    g = activate(dot(x, params["wi_gate"], policy, "ffn"), act)
    u = dot(x, params["wi_up"], policy, "ffn")
    return dot(g * u, params["wo"], policy, "ffn")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device, tie: bool):
    p = {"embedding": normal(gen, (vocab, d_model), 0.02, dtype, device)}
    if not tie:
        p["unembed"] = init_dense(gen, d_model, vocab, dtype, device)
    return p


def embed(params, tokens: torch.Tensor, dtype, scale: bool,
          d_model: int) -> torch.Tensor:
    # Rows first, then the cast: the same values as casting the table.
    x = params["embedding"][tokens].to(dtype)
    if scale:
        # sqrt(d) rounded to the compute dtype first, as the reference's
        # `jnp.asarray(np.sqrt(d_model), dtype)`; held as a host number.
        x = x * float(torch.tensor(math.sqrt(d_model), dtype=dtype))
    return x


def unembed(params, x: torch.Tensor, tie: bool, policy=None) -> torch.Tensor:
    """Logits in float32. The reference's `jnp.dot` returns them in float32
    from its float32 accumulator; a float32 model matches that exactly,
    a bf16 one gets cuBLAS's bf16 result widened (one bf16 rounding)."""
    w = params["embedding"].t() if tie else params["unembed"]
    return torch.matmul(x, w.to(x.dtype)).float()
