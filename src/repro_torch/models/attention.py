"""Attention variants (port of `repro.models.attention`): GQA/MQA (global,
windowed, chunked) and MLA.

The reference computes every attention as a masked einsum and names the
flash kernel as its drop-in (`repro/models/attention.py:3-4`). The port
takes that drop-in by a fixed rule (`flash_rule`), never by failure:

  * the full-sequence self-attention forward (`gqa_forward`, kinds
    "attn", "local" and "chunked") calls
    `kernels.flash_attention.flash_attention_op` wherever the kernel has a
    route for the compute dtype and head dim (its `ROUTES`: float32 and
    bf16 at head dims 16, 32, 64, 128, 256). On a CUDA tensor that
    launches the kernel ("wgmma" for bf16 at D >= 64, "simt" otherwise),
    and a failed launch raises; on a CPU tensor it runs the kernel's
    plain version (`flash_ref`);
  * the plain einsum runs, on any device, where the reference computes
    outside any Pallas kernel and the kernel has no counterpart: the
    decode step (Sq = 1 against a cache with per-row lengths), MLA, and
    a dtype or head dim the kernel lacks (phi-3-vision's 96; float16 and
    float64);
  * `plain_attention()` runs every GQA forward of the block in the plain
    einsum too: the comparisons that hold the flash route against the
    reference's arithmetic on the card use it.

On the flash route the reference's degenerate masks (`attn_mask`: "local"
with window 0 and "chunked" with chunk 0 are plain causal) go to the
kernel as kind "attn", since the wrapper refuses both. The wrapper needs
Sq to be a multiple of min(bq, Sq) with bq = 128, so a longer sequence is
padded at its end to a multiple of 128 and the padded rows dropped: a
padded key lies in the future of every real query, so the causal mask
hides it, and the real rows are the unpadded ones. The kernel's grouped
heads keep the reference's order: query head h reads kv head
h // (Hq / Hkv).

`REPRO_ATTN_QCHUNKS` (the reference's query-chunked einsum, a memory
lever of its einsum path) is not ported: the flash route never builds
the (Sq, Sk) score matrix, and the port reads no environment variables.

The decode steps write the new token's K/V (or latent) row into the
cache tensors in place and return caches that share them.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.chop import chop_op
from repro_torch.kernels.flash_attention import ROUTES as FLASH_ROUTES
from repro_torch.kernels.flash_attention import flash_attention_op

from .layers import (apply_rope, dot, init_dense, normal, rms_norm,
                     rope_freqs, softcap, zeros)

NEG_INF = -2.0 ** 30
FLASH_BQ = 128          # the wrapper's default query and key blocks

_PLAIN = contextvars.ContextVar("plain_attention", default=False)


@contextlib.contextmanager
def plain_attention():
    """Run every GQA forward inside the block in the plain einsum."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def flash_rule(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the self-attention forward takes the flash route: the
    kernel has a route for (dtype, head_dim) and `plain_attention` is not
    in force. The decode step and MLA never take it."""
    return (dtype, head_dim) in FLASH_ROUTES and not _PLAIN.get()


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str,
              window: int = 0, chunk: int = 0) -> torch.Tensor:
    """(..., S_q, S_k) boolean: True = attend."""
    causal = q_pos[..., :, None] >= k_pos[..., None, :]
    if kind == "local" and window:
        causal = causal & ((q_pos[..., :, None] - k_pos[..., None, :])
                           < window)
    if kind == "chunked" and chunk:
        causal = causal & ((q_pos[..., :, None] // chunk)
                           == (k_pos[..., None, :] // chunk))
    return causal


def flash_mask(kind: str, cfg: ArchConfig):
    """(kind, window, chunk) for the flash wrapper: the reference's
    degenerate local (window 0) and chunked (chunk 0) masks are causal."""
    if kind == "local" and cfg.window:
        return "local", cfg.window, 0
    if kind == "chunked" and cfg.attn_chunk:
        return "chunked", 0, cfg.attn_chunk
    return "attn", 0, 0


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg: ArchConfig, dtype, device, lead=()):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": init_dense(gen, d, hq * hd, dtype, device, lead),
        "wk": init_dense(gen, d, hkv * hd, dtype, device, lead),
        "wv": init_dense(gen, d, hkv * hd, dtype, device, lead),
        "wo": init_dense(gen, hq * hd, d, dtype, device, lead),
    }


def sdpa_plain(q, k, v, mask, scale, attn_cap):
    """The reference's `_sdpa_full`: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D),
    grouped heads; scores and softmax in float32, probabilities rounded to
    v's dtype before P V; `mask` broadcasts to (B, Sq, Sk)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    scores = softcap(scores, attn_cap)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(b, sq, hq, d)


def sdpa_flash(q, k, v, kind: str, cfg: ArchConfig, scale: float):
    """Causal self-attention of a whole sequence through the flash
    wrapper, padded at its end to a multiple of `FLASH_BQ` (module
    docstring); q (B, S, Hq, D), k/v (B, S, Hkv, D)."""
    s = q.shape[1]
    kind, window, chunk = flash_mask(kind, cfg)
    pad = -s % FLASH_BQ if s > FLASH_BQ else 0
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = flash_attention_op(q, k, v, kind=kind, window=window, chunk=chunk,
                             softcap=cfg.attn_softcap, scale=scale)
    return out[:, :s] if pad else out


def gqa_forward(params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                positions: torch.Tensor, use_rope: bool = True,
                policy=None) -> torch.Tensor:
    """Train/prefill self-attention. x: (B, S, d); positions: arange(S)
    (the flash route's mask assumes it, as `hidden_states` passes)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dot(x, params["wq"], policy, "attn").reshape(b, s, hq, hd)
    k = dot(x, params["wk"], policy, "attn").reshape(b, s, hkv, hd)
    v = dot(x, params["wv"], policy, "attn").reshape(b, s, hkv, hd)
    if use_rope:
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(hd)
    if flash_rule(q.dtype, hd):
        out = sdpa_flash(q, k, v, kind, cfg, scale)
    else:
        mask = attn_mask(positions, positions, kind, cfg.window,
                         cfg.attn_chunk)[None]
        out = sdpa_plain(q, k, v, mask, scale, cfg.attn_softcap)
    return dot(out.reshape(b, s, hq * hd), params["wo"], policy, "attn")


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_max, Hkv, D), possibly a reduced format
    v: torch.Tensor
    length: torch.Tensor   # (B,) int32 current fill


def init_kv_cache(batch: int, s_max: int, cfg: ArchConfig, dtype,
                  device, lead=()) -> KVCache:
    shape = (*lead, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(zeros(shape, dtype, device), zeros(shape, dtype, device),
                   zeros((*lead, batch), torch.int32, device))


def _round_kv(t: torch.Tensor, cache_fmt) -> torch.Tensor:
    """The KV-format knob: round through the chop kernel's wrapper on the
    float32 carrier (one launch for a CUDA tensor)."""
    return chop_op(t.float().contiguous(), int(cache_fmt)).to(t.dtype)


def gqa_decode(params, x: torch.Tensor, cache: KVCache, cfg: ArchConfig,
               kind: str, use_rope: bool = True, policy=None,
               cache_fmt=None):
    """One-token decode. x: (B, 1, d). Returns (out, cache), the cache's
    K/V written in place (module docstring)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache.length.long()                            # (B,)
    q = dot(x, params["wq"], policy, "attn").reshape(b, 1, hq, hd)
    k = dot(x, params["wk"], policy, "attn").reshape(b, 1, hkv, hd)
    v = dot(x, params["wv"], policy, "attn").reshape(b, 1, hkv, hd)
    if use_rope:
        cos, sin = rope_freqs(hd, cfg.rope_theta, pos[:, None])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache_fmt is not None:
        k = _round_kv(k, cache_fmt)
        v = _round_kv(v, cache_fmt)
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[bidx, pos] = v[:, 0].to(cache.v.dtype)
    s_max = cache.k.shape[1]
    k_pos = torch.arange(s_max, device=x.device)[None, :]
    mask = attn_mask(pos[:, None, None], k_pos[:, None, :], kind,
                     cfg.window, cfg.attn_chunk)[:, 0]   # (B, 1, S_max)
    mask = mask & (k_pos <= pos[:, None])[:, None, :]
    out = sdpa_plain(q, cache.k.to(x.dtype), cache.v.to(x.dtype), mask,
                     1.0 / math.sqrt(hd), cfg.attn_softcap)
    out = dot(out.reshape(b, 1, hq * hd), params["wo"], policy, "attn")
    return out, KVCache(cache.k, cache.v, cache.length + 1)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention), plain by rule
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ArchConfig, dtype, device, lead=()):
    d, h = cfg.d_model, cfg.n_heads
    nd = cfg.head_dim                    # per-head nope dim
    rd = cfg.rope_head_dim
    vd = cfg.v_head_dim or cfg.head_dim
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    p = {
        "w_dkv": init_dense(gen, d, r, dtype, device, lead),
        "w_kr": init_dense(gen, d, rd, dtype, device, lead),
        "kv_norm": zeros((*lead, r), dtype, device),
        "w_uk": normal(gen, (*lead, r, h, nd), 1 / math.sqrt(r), dtype,
                       device),
        "w_uv": normal(gen, (*lead, r, h, vd), 1 / math.sqrt(r), dtype,
                       device),
        "wo": init_dense(gen, h * vd, d, dtype, device, lead),
    }
    if qr:
        p["w_dq"] = init_dense(gen, d, qr, dtype, device, lead)
        p["q_norm"] = zeros((*lead, qr), dtype, device)
        p["w_uq"] = normal(gen, (*lead, qr, h, nd + rd), 1 / math.sqrt(qr),
                           dtype, device)
    else:
        p["w_uq"] = normal(gen, (*lead, d, h, nd + rd), 1 / math.sqrt(d),
                           dtype, device)
    return p


def _ein(eq, a, b):
    """einsum in a's dtype (the reference's preferred-float32 einsum
    rounded back to the compute dtype)."""
    return torch.einsum(eq, a, b.to(a.dtype))


def _mla_q(params, x, cfg, policy):
    if cfg.q_lora_rank:
        cq = dot(x, params["w_dq"], policy, "attn")
        cq = rms_norm(cq, params["q_norm"], cfg.norm_eps)
        q = _ein("bsr,rhd->bshd", cq, params["w_uq"])
    else:
        q = _ein("bsd,dhe->bshe", x, params["w_uq"])
    return q[..., :cfg.head_dim], q[..., cfg.head_dim:]   # nope, rope


def mla_forward(params, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, policy=None) -> torch.Tensor:
    """Train/prefill MLA with full materialization."""
    b, s, _ = x.shape
    h = cfg.n_heads
    vd = cfg.v_head_dim or cfg.head_dim
    q_nope, q_rope = _mla_q(params, x, cfg, policy)
    ckv = dot(x, params["w_dkv"], policy, "attn")
    ckv = rms_norm(ckv, params["kv_norm"], cfg.norm_eps)
    k_rope = dot(x, params["w_kr"], policy, "attn")      # (B,S,rd) one head
    k_nope = _ein("bsr,rhd->bshd", ckv, params["w_uk"])
    v = _ein("bsr,rhv->bshv", ckv, params["w_uv"])
    cos, sin = rope_freqs(cfg.rope_head_dim, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # (B,S,1,rd)
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    mask = attn_mask(positions, positions, "attn")[None]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             k_rope[:, :, 0].float())) * scale
    probs = torch.softmax(torch.where(mask[:, None], scores, NEG_INF), -1)
    out = torch.einsum("bhqk,bkhv->bqhv", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return dot(out.reshape(b, s, h * vd), params["wo"], policy, "attn")


class MLACache(NamedTuple):
    ckv: torch.Tensor      # (B, S_max, kv_lora_rank)
    k_rope: torch.Tensor   # (B, S_max, rope_head_dim)
    length: torch.Tensor


def init_mla_cache(batch: int, s_max: int, cfg: ArchConfig, dtype,
                   device, lead=()) -> MLACache:
    return MLACache(zeros((*lead, batch, s_max, cfg.kv_lora_rank), dtype,
                          device),
                    zeros((*lead, batch, s_max, cfg.rope_head_dim), dtype,
                          device),
                    zeros((*lead, batch), torch.int32, device))


def mla_decode(params, x: torch.Tensor, cache: MLACache, cfg: ArchConfig,
               policy=None):
    """Absorbed-matrix decode: scores and values in the latent space, so
    the per-token cache is kv_lora + rope_head_dim whatever the heads."""
    b = x.shape[0]
    h = cfg.n_heads
    vd = cfg.v_head_dim or cfg.head_dim
    pos = cache.length.long()
    q_nope, q_rope = _mla_q(params, x, cfg, policy)      # (B,1,H,*)
    ckv_new = dot(x, params["w_dkv"], policy, "attn")
    ckv_new = rms_norm(ckv_new, params["kv_norm"], cfg.norm_eps)
    kr_new = dot(x, params["w_kr"], policy, "attn")
    cos, sin = rope_freqs(cfg.rope_head_dim, cfg.rope_theta, pos[:, None])
    q_rope = apply_rope(q_rope, cos, sin)
    kr_new = apply_rope(kr_new[:, :, None, :], cos, sin)[:, :, 0]
    bidx = torch.arange(b, device=x.device)
    cache.ckv[bidx, pos] = ckv_new[:, 0].to(cache.ckv.dtype)
    cache.k_rope[bidx, pos] = kr_new[:, 0].to(cache.k_rope.dtype)
    ckv, krope = cache.ckv.to(x.dtype), cache.k_rope.to(x.dtype)
    # Absorb W_uk into the query: q_abs (B,1,H,r).
    q_abs = _ein("bshd,rhd->bshr", q_nope, params["w_uk"])
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    s_max = ckv.shape[1]
    scores = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             krope.float())) * scale
    valid = (torch.arange(s_max, device=x.device)[None]
             <= pos[:, None])[:, None, None]
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), -1)
    o_lat = torch.einsum("bhst,btr->bshr", probs.to(x.dtype).float(),
                         ckv.float()).to(x.dtype)
    out = _ein("bshr,rhv->bshv", o_lat, params["w_uv"])
    out = dot(out.reshape(b, 1, h * vd), params["wo"], policy, "attn")
    return out, MLACache(cache.ckv, cache.k_rope, cache.length + 1)
