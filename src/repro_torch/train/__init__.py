"""Training of the LM stack (port of `repro.train`): AdamW with optional
int8 moments, the learning-rate schedule, the train step and the
bandit's precision hooks. The reference's `sync_grads` / `sync_leaf`
(`train/grad_sync.py`, a "pod" axis across devices) wait for the sharded
executor (ROADMAP Queue 1 item 7)."""
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
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "global_norm", "LMPrecisionPolicy", "TrainPrecisionController",
    "default_policy", "QTensor", "dequantize_int8", "quantize_int8",
    "cosine_with_warmup", "TrainState", "TrainStepConfig", "cast_params",
    "init_train_state", "make_train_step", "train_state_from_reference",
]
