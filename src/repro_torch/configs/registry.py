"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Dict

from . import (deepseek_v2_236b, falcon_mamba_7b, gemma2_9b, gemma_2b,
               granite_3_2b, jamba_v0_1_52b, llama4_scout_17b,
               musicgen_large, phi3_vision_4p2b, phi4_mini_3p8b)
from .base import ArchConfig

_MODULES = {
    "llama4-scout-17b-16e": llama4_scout_17b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "gemma2-9b": gemma2_9b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "granite-3-2b": granite_3_2b,
    "gemma-2b": gemma_2b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "musicgen-large": musicgen_large,
    "phi-3-vision-4.2b": phi3_vision_4p2b,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return _MODULES[name].smoke_config()


def all_archs():
    return dict(ARCHS)
