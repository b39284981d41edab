"""Training of the LM stack (port of `repro.train`): AdamW with optional
int8 moments, the learning-rate schedule, the train step and the
bandit's precision hooks, and the cross-pod gradient sync
(`sync_grads` / `sync_leaf` over a process group)."""
from .grad_sync import sync_grads, sync_leaf
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        global_norm)
from .precision_hooks import (LMPrecisionPolicy, TrainPrecisionController,
                              default_policy)
from .quantize import QTensor, dequantize_int8, quantize_int8
from .schedule import cosine_with_warmup
from .train_step import (TrainState, TrainStepConfig, cast_params,
                         init_train_state, make_train_step,
                         train_state_from_reference)

__all__ = [
    "sync_grads", "sync_leaf", "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "global_norm", "LMPrecisionPolicy", "TrainPrecisionController",
    "default_policy", "QTensor", "dequantize_int8", "quantize_int8",
    "cosine_with_warmup", "TrainState", "TrainStepConfig", "cast_params",
    "init_train_state", "make_train_step", "train_state_from_reference",
]
