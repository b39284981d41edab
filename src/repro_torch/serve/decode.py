"""Batched serving loop (port of `repro.serve.decode`): prefill + greedy or
temperature decode with caches.

The KV-cache storage format is a precision knob (`cache_fmt`, a format
id of `repro_torch.precision`, the bandit's serve-side action): K and V
are rounded to it through the chop kernel before they enter the cache.
`prefill` feeds the prompt through `decode_step` a token at a time, as
the reference does, and `generate` runs one more `decode_step` per new
token. Sampling (temperature > 0) draws from an explicit
`torch.Generator` on the params' device; greedy needs none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step, init_caches
from repro_torch.models.transformer import params_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    compute_dtype: Any = torch.bfloat16
    cache_fmt: Optional[int] = None   # repro_torch.precision format id


def prefill(params, prompts, cfg: ArchConfig, scfg: ServeConfig,
            s_max: int, device=None):
    """Feed the prompt through decode steps to warm the caches.

    prompts: (B, S_prompt) int. Returns (caches, last_logits (B, vocab))."""
    dev = params_device(params, device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    b, s_prompt = prompts.shape
    caches = init_caches(cfg, b, s_max, scfg.compute_dtype, device=dev)
    last = torch.zeros((b, cfg.vocab_size), device=dev)
    for t in range(s_prompt):
        logits, caches = decode_step(params, prompts[:, t:t + 1], caches,
                                     cfg, scfg.compute_dtype,
                                     cache_fmt=scfg.cache_fmt, device=dev)
        last = logits[:, 0]
    return caches, last


def generate(params, prompts, cfg: ArchConfig,
             scfg: ServeConfig = ServeConfig(),
             generator: Optional[torch.Generator] = None, device=None):
    """Greedy (or sampled) continuation. Returns (B, max_new_tokens)."""
    if scfg.temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    dev = params_device(params, device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    s_max = prompts.shape[1] + scfg.max_new_tokens
    caches, logits = prefill(params, prompts, cfg, scfg, s_max, dev)
    toks = []
    for _ in range(scfg.max_new_tokens):
        if scfg.temperature > 0:
            probs = torch.softmax(logits / scfg.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        logits, caches = decode_step(params, tok[:, None], caches, cfg,
                                     scfg.compute_dtype,
                                     cache_fmt=scfg.cache_fmt, device=dev)
        logits = logits[:, 0]
    return torch.stack(toks, dim=1)
