"""Batched serving loop of the LM stack (port of `repro.serve`)."""
from .decode import ServeConfig, generate, prefill

__all__ = ["ServeConfig", "generate", "prefill"]
