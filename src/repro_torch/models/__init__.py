"""The LM stack's models (port of `repro.models`): layers, attention (GQA
with the flash kernel on the full-sequence forward, MLA), MoE, Mamba and
the decoder stack."""
from .transformer import (decode_step, forward, hidden_states, init_caches,
                          init_params, loss_fn, params_from_reference)

__all__ = ["decode_step", "forward", "hidden_states", "init_caches",
           "init_params", "loss_fn", "params_from_reference"]
