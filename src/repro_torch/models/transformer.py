"""Decoder stack (port of `repro.models.transformer`): heterogeneous layer
patterns over [prefix layers] + [n_groups x pattern].

Layer groups are per-group parameter stacks, as in the reference's tree:
`params["layers"]` holds one entry per position of the arch's repeating
pattern (`"l0"`, `"l1"`, ...), each leaf with the group axis in front, and
a Python loop walks the groups (the reference's `lax.scan`) over views
of one `unbind` a leaf (`_unstack`). `params["prefix"]` lists the
leading dense layers unstacked. So the JAX package's `init_params` tree
converts leaf for leaf (`params_from_reference`). The caches of
`init_caches` are stacked the same way; `decode_step` writes each
group's new cache rows into them in place and returns them.

Entry points (`init_params`, `forward`, `hidden_states`, `loss_fn`,
`init_caches`, `decode_step`) run on CUDA unless the caller passes
`device="cpu"`, and raise when CUDA is asked for and absent. Random
draws take an explicit `torch.Generator` on the target device.
`residual_sharding` is accepted only as None: a residual stream laid
over a mesh comes with the dry-run slice (ROADMAP Queue 1 item 9).

Under autograd (`torch.is_grad_enabled()`) the forward keeps the
reference's memory structure: each layer group runs under
`torch.utils.checkpoint` (the reference's `jax.checkpoint(group_fn)`),
and so does each chunk of `loss_fn`'s unembed and cross entropy (its
`@jax.checkpoint chunk_nll`), so the backward recomputes a group's
activations and a chunk's logits instead of keeping them. Without
autograd (serving, `torch.no_grad`, `torch.inference_mode`) both run
straight through. Remat reruns the group's forward, flash launches
included: a training step launches the flash kernel twice a layer.
"""
from __future__ import annotations

import contextvars
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.precision.backend import resolve_device

from . import attention as attn
from . import mamba as ssm
from . import moe as moe_lib
from .layers import (embed, ffn, init_embed, init_ffn, rms_norm, softcap,
                     unembed, zeros)


def _use_rope_at(cfg: ArchConfig, layer: int) -> bool:
    return not (cfg.nope_every and (layer + 1) % cfg.nope_every == 0)


def tree_map(fn, *trees):
    """`fn` over the tensor leaves of nested dicts, lists and (named)
    tuples of the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        if hasattr(t, "_fields"):
            return type(t)(*out)
        return type(t)(out)
    return fn(*trees)


def tree_leaves(tree):
    """The tensor leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _n_groups(cfg: ArchConfig) -> int:
    body = cfg.n_layers - cfg.first_dense
    if body % cfg.pattern_len:
        raise ValueError(f"{cfg.name}: {body} layers after the dense prefix "
                         f"are not whole groups of {cfg.pattern_len}")
    return body // cfg.pattern_len


def _check_sharding(residual_sharding):
    if residual_sharding is not None:
        raise NotImplementedError(
            "residual_sharding (a residual stream laid over a mesh) is "
            "not ported (ROADMAP Queue 1 item 9: the dry-run slice); "
            "pass None")


def params_device(params, device) -> torch.device:
    """The device an entry point runs on, which must hold the params."""
    dev = resolve_device(device)
    have = params["embed"]["embedding"].device
    if have.type != dev.type:
        raise ValueError(f"params are on {have}, the call asks for {dev}")
    return have


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, layer: int, dtype, device,
                lead=()) -> Dict[str, Any]:
    kind = cfg.layer_kind(layer)
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": zeros((*lead, d), dtype, device)}
    if kind == "mamba":
        p["mixer"] = ssm.init_mamba(gen, cfg, dtype, device, lead)
    elif cfg.use_mla:
        p["mixer"] = attn.init_mla(gen, cfg, dtype, device, lead)
    else:
        p["mixer"] = attn.init_gqa(gen, cfg, dtype, device, lead)
    if kind != "mamba" or cfg.d_ff or cfg.n_experts:
        p["ln2"] = zeros((*lead, d), dtype, device)
        if cfg.is_moe_layer(layer):
            p["ffn"] = moe_lib.init_moe(gen, cfg, dtype, device, lead)
        elif cfg.d_ff:
            p["ffn"] = init_ffn(gen, d, cfg.d_ff, dtype, device, lead)
    if cfg.post_norms:
        p["ln1_post"] = zeros((*lead, d), dtype, device)
        if "ffn" in p:
            p["ln2_post"] = zeros((*lead, d), dtype, device)
    return p


def _build(cfg: ArchConfig, gen, dtype, device) -> Dict[str, Any]:
    n_groups = _n_groups(cfg)
    params: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, device,
                            cfg.tie_embeddings),
        "final_norm": zeros((cfg.d_model,), dtype, device),
    }
    prefix = [_init_block(gen, cfg, l, dtype, device)
              for l in range(cfg.first_dense)]
    if prefix:
        params["prefix"] = prefix
    params["layers"] = {
        f"l{j}": _init_block(gen, cfg, cfg.first_dense + j, dtype, device,
                             (n_groups,))
        for j in range(cfg.pattern_len)}
    return params


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random parameters drawn from `generator` (on the target device)
    straight onto the device, each stacked leaf drawn whole."""
    dev = resolve_device(device)
    return _build(cfg, generator, dtype, dev)


def params_from_reference(tree, cfg: ArchConfig, device=None):
    """This package's parameters from the JAX package's `init_params` tree
    (leaves as numpy arrays, or anything `np.asarray` takes; the group
    axis stacked in front, as here). Checks the tree's structure and
    shapes against this package's own, keeps each leaf's dtype (bf16
    leaves through float32), and puts the leaves on `device`."""
    dev = resolve_device(device)
    like = _build(cfg, None, torch.float32, torch.device("meta"))

    def leaf(want, got):
        got = np.asarray(got)
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{cfg.name}: reference leaf of shape "
                             f"{got.shape}, expected {tuple(want.shape)}")
        if got.dtype.name == "bfloat16":
            return torch.from_numpy(got.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.tensor(got, device=dev)

    def walk(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"{cfg.name}: reference tree at {path} has "
                                 f"{have}, expected {sorted(want)}")
            return {k: walk(want[k], got[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if len(got) != len(want):
                raise ValueError(f"{cfg.name}: reference {path} has "
                                 f"{len(got)} layers, expected {len(want)}")
            return [walk(w, g, f"{path}/{i}")
                    for i, (w, g) in enumerate(zip(want, got))]
        return leaf(want, got)

    return walk(like, tree, "")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn_part(bp, x, cfg: ArchConfig, layer: int, policy):
    if "ffn" not in bp:
        return x
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if cfg.is_moe_layer(layer):
        f = moe_lib.moe_ffn(bp["ffn"], h, cfg, policy)
    else:
        f = ffn(bp["ffn"], h, cfg.act, policy)
    if cfg.post_norms:
        f = rms_norm(f, bp["ln2_post"], cfg.norm_eps)
    return x + f


def _block_forward(bp, x, cfg: ArchConfig, layer: int, positions,
                   policy=None):
    kind = cfg.layer_kind(layer)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "mamba":
        a = ssm.mamba_forward(bp["mixer"], h, cfg, policy)
    elif cfg.use_mla:
        a = attn.mla_forward(bp["mixer"], h, cfg, positions, policy)
    else:
        a = attn.gqa_forward(bp["mixer"], h, cfg, kind, positions,
                             _use_rope_at(cfg, layer), policy)
    if cfg.post_norms:
        a = rms_norm(a, bp["ln1_post"], cfg.norm_eps)
    return _ffn_part(bp, x + a, cfg, layer, policy)


def _remat(fn, *args):
    """fn(*args), under `torch.utils.checkpoint` when autograd records
    (module docstring). The recompute runs in a copy of the forward's
    context variables (`attention.plain_attention()` is one): the
    backward of a CUDA tensor runs on autograd's device thread, which
    does not see them, and a recompute on another attention route would
    save other tensors. The forward draws no random numbers, so no RNG
    state is stashed for the recompute."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(_in_context, contextvars.copy_context(), fn, *args,
                      use_reentrant=False, preserve_rng_state=False)


def _in_context(ctx, fn, *args):
    return ctx.copy().run(fn, *args)


def _unstack(layers, n_groups: int):
    """The per-group trees of the stacked layer parameters, by one
    `unbind` a leaf: its backward stacks the groups' gradients in one
    copy, where a `v[g]` a group would add a zero gradient of the whole
    stack for every group (40 full-size fills and adds a leaf a step at
    granite-3-2b's depth)."""
    if isinstance(layers, dict):
        subs = {k: _unstack(v, n_groups) for k, v in layers.items()}
        return [{k: subs[k][g] for k in layers} for g in range(n_groups)]
    return layers.unbind(0)


def _group_forward(x, gp, cfg: ArchConfig, positions, policy):
    for j in range(cfg.pattern_len):
        x = _block_forward(gp[f"l{j}"], x, cfg, cfg.first_dense + j,
                           positions, policy)
    return x


def hidden_states(params, tokens, cfg: ArchConfig, dtype=torch.bfloat16,
                  policy=None, prefix_embeds: Optional[torch.Tensor] = None,
                  residual_sharding=None, device=None) -> torch.Tensor:
    """Final-norm hidden states (B, S, d): forward() without the unembed."""
    _check_sharding(residual_sharding)
    dev = params_device(params, device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype, cfg.embed_scale, cfg.d_model)
    if prefix_embeds is not None:
        pe = torch.as_tensor(prefix_embeds, device=dev).to(dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(s, device=dev)
    for l, bp in enumerate(params.get("prefix", [])):
        x = _block_forward(bp, x, cfg, l, positions, policy)
    for gp in _unstack(params["layers"], _n_groups(cfg)):
        x = _remat(_group_forward, x, gp, cfg, positions, policy)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _logits(params, x, cfg: ArchConfig, policy):
    logits = unembed(params["embed"], x, cfg.tie_embeddings, policy)
    return softcap(logits, cfg.logit_softcap)


def forward(params, tokens, cfg: ArchConfig, dtype=torch.bfloat16,
            policy=None, prefix_embeds: Optional[torch.Tensor] = None,
            residual_sharding=None, device=None) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab) float32.

    prefix_embeds: modality-stub injection (B, n_prefix, d) replacing the
    embeddings of the first n_prefix positions."""
    x = hidden_states(params, tokens, cfg, dtype, policy, prefix_embeds,
                      residual_sharding, device)
    return _logits(params, x, cfg, policy)


LOSS_CHUNKS = 8


def _chunk_nll(params, xc, tc, mc, cfg: ArchConfig, policy):
    logp = torch.log_softmax(_logits(params, xc, cfg, policy), -1)
    nll = -torch.gather(logp, -1, tc[..., None])[..., 0]
    return torch.sum(nll * mc)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            dtype=torch.bfloat16, policy=None, residual_sharding=None,
            device=None):
    """Next-token cross entropy, chunked over the sequence: one chunk of
    (B, S_chunk, vocab) logits alive at a time, recomputed in the
    backward (module docstring). Differentiable in `params`."""
    x = hidden_states(params, batch["tokens"], cfg, dtype, policy,
                      batch.get("prefix_embeds"), residual_sharding, device)
    tokens = torch.as_tensor(batch["tokens"], device=x.device).long()
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = batch.get("loss_mask")
    mask = torch.ones(tokens.shape, device=x.device) if mask is None else \
        torch.as_tensor(mask, device=x.device).float().clone()
    mask[:, -1] = 0.0

    s = tokens.shape[1]
    n_chunks = LOSS_CHUNKS if s % LOSS_CHUNKS == 0 else 1
    csz = s // n_chunks
    total = torch.zeros((), device=x.device)
    for c in range(n_chunks):
        sl = slice(c * csz, (c + 1) * csz)
        total = total + _remat(_chunk_nll, params, x[:, sl], targets[:, sl],
                               mask[:, sl], cfg, policy)
    ntokens = torch.sum(mask)
    loss = total / torch.clamp(ntokens, min=1.0)
    return loss, {"loss": loss, "ntokens": ntokens}


# ---------------------------------------------------------------------------
# Decode (single token, cached)
# ---------------------------------------------------------------------------

def _init_block_cache(cfg: ArchConfig, layer: int, batch: int, s_max: int,
                      dtype, kv_dtype, device, lead=()):
    kind = cfg.layer_kind(layer)
    if kind == "mamba":
        return ssm.init_mamba_cache(batch, cfg, dtype, device, lead)
    if cfg.use_mla:
        return attn.init_mla_cache(batch, s_max, cfg, kv_dtype, device, lead)
    # Windowed/chunked layers keep full-length caches, as the reference.
    return attn.init_kv_cache(batch, s_max, cfg, kv_dtype, device, lead)


def init_caches(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, kv_dtype=None, device=None):
    dev = resolve_device(device)
    kv_dtype = kv_dtype or dtype
    caches: Dict[str, Any] = {}
    if cfg.first_dense:
        caches["prefix"] = [
            _init_block_cache(cfg, l, batch, s_max, dtype, kv_dtype, dev)
            for l in range(cfg.first_dense)]
    caches["layers"] = {
        f"l{j}": _init_block_cache(cfg, cfg.first_dense + j, batch, s_max,
                                   dtype, kv_dtype, dev, (_n_groups(cfg),))
        for j in range(cfg.pattern_len)}
    return caches


def _block_decode(bp, x, cache, cfg: ArchConfig, layer: int, policy=None,
                  cache_fmt=None):
    kind = cfg.layer_kind(layer)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "mamba":
        a, cache = ssm.mamba_decode(bp["mixer"], h, cache, cfg, policy)
    elif cfg.use_mla:
        a, cache = attn.mla_decode(bp["mixer"], h, cache, cfg, policy)
    else:
        a, cache = attn.gqa_decode(bp["mixer"], h, cache, cfg, kind,
                                   _use_rope_at(cfg, layer), policy,
                                   cache_fmt)
    if cfg.post_norms:
        a = rms_norm(a, bp["ln1_post"], cfg.norm_eps)
    return _ffn_part(bp, x + a, cfg, layer, policy), cache


def _store(dst, src):
    if src is not dst:
        dst.copy_(src)


def decode_step(params, token, caches, cfg: ArchConfig,
                dtype=torch.bfloat16, policy=None, cache_fmt=None,
                device=None):
    """token: (B, 1) int -> (logits (B, 1, vocab) float32, caches), the
    caches updated in place."""
    dev = params_device(params, device)
    token = torch.as_tensor(token, device=dev).long()
    x = embed(params["embed"], token, dtype, cfg.embed_scale, cfg.d_model)
    new_prefix = []
    for l, bp in enumerate(params.get("prefix", [])):
        x, c = _block_decode(bp, x, caches["prefix"][l], cfg, l, policy,
                             cache_fmt)
        new_prefix.append(c)
    for g, gp in enumerate(_unstack(params["layers"], _n_groups(cfg))):
        gc = tree_map(lambda v: v[g], caches["layers"])
        for j in range(cfg.pattern_len):
            x, c = _block_decode(gp[f"l{j}"], x, gc[f"l{j}"], cfg,
                                 cfg.first_dense + j, policy, cache_fmt)
            tree_map(_store, gc[f"l{j}"], c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_caches = {"layers": caches["layers"]}
    if new_prefix:
        new_caches["prefix"] = new_prefix
    return _logits(params, x, cfg, policy), new_caches
