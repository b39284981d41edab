"""Online precision-autotuning service, solver-agnostic (port of
`repro.service`).

Streaming counterpart of `core.autotune`: accepts solve requests for any
hosted `TunableTask` (GMRES-IR, CG-IR, ...), picks per-step precisions
with the live bandit policy, executes them through per-bucket
micro-batches on the task's device (CUDA unless the task was built with
`device="cpu"`), and keeps learning from every observed reward —
continual epsilon control, EWMA-|RPE| drift detection, circuit breakers
that pin to the safe arm, and versioned policy snapshots with atomic
promote/rollback in the JAX package's on-disk format. All
algorithm-specific behavior flows through the task's `TunableTask`
hooks; the server and batcher import no solver.

Not ported yet (ROADMAP.md Queue 1): the HTTP front door
(`service/http`), the rollout controller, crash recovery, and AOT
warmup.
"""
from repro_torch.obs import Observability

from .batcher import BatcherConfig, FlushResult, MicroBatcher
from .breaker import BreakerConfig, CircuitBreakers
from .instrument import LearnerInstruments, ServiceInstruments
from .online import (DriftDetector, EpsilonController, OnlineConfig,
                     OnlineLearner, OnlineUpdate)
from .registry import PolicyRegistry, SnapshotCorrupted
from .server import AutotuneServer, SolveResponse
from .telemetry import Ewma, Telemetry

__all__ = [
    "AutotuneServer", "BatcherConfig", "BreakerConfig", "CircuitBreakers",
    "DriftDetector", "EpsilonController", "Ewma", "FlushResult",
    "LearnerInstruments", "MicroBatcher", "Observability", "OnlineConfig",
    "OnlineLearner", "OnlineUpdate", "PolicyRegistry", "ServiceInstruments",
    "SnapshotCorrupted", "SolveResponse", "Telemetry",
]
