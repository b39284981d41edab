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

Around the server: the asyncio HTTP front door (`service.http`), the
canary rollout controller `ShadowServer` with its off-policy gate
(`eval.ope`), and crash recovery from the registry plus the
trajectory-log tail (`recover_server`, verified through `eval.replay`).
A server may warm its buckets before it reports ready (`warmup=`,
`core.aot`).
"""
from repro_torch.obs import Observability

from .batcher import BatcherConfig, FlushResult, MicroBatcher
from .breaker import BreakerConfig, CircuitBreakers
from .instrument import (LearnerInstruments, RolloutInstruments,
                         ServiceInstruments)
from .online import (DriftDetector, EpsilonController, OnlineConfig,
                     OnlineLearner, OnlineUpdate)
from .recovery import RecoveryReport, recover_server, replay_wal_tail
from .registry import PolicyRegistry, SnapshotCorrupted
from .rollout import (OPEGateRejected, RolloutConfig, RolloutDecision,
                      ShadowServer)
from .server import AutotuneServer, SolveResponse
from .telemetry import Ewma, Telemetry

__all__ = [
    "AutotuneServer", "BatcherConfig", "BreakerConfig", "CircuitBreakers",
    "DriftDetector", "EpsilonController", "Ewma", "FlushResult",
    "LearnerInstruments", "MicroBatcher", "Observability", "OnlineConfig",
    "OnlineLearner", "OnlineUpdate", "OPEGateRejected", "PolicyRegistry",
    "RecoveryReport", "RolloutConfig", "RolloutDecision",
    "RolloutInstruments", "ServiceInstruments", "ShadowServer",
    "SnapshotCorrupted", "SolveResponse", "Telemetry", "recover_server",
    "replay_wal_tail",
]
