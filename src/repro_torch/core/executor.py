"""Solve executors: the dispatch granularity of the engine's and the
micro-batcher's solves (port of `repro.core.executor`; DESIGN.md §7).

The port keeps the `SolveExecutor` contract and its `LocalExecutor`:
one device, the task's own. Dispatch stays the task's `solve_rows`,
which runs its rows as one batched program on the task's device
(`solvers.gmres_ir_batch` / `cg_ir_batch`), so an executor here only
says how many rows one call takes (`preferred_chunk`) and how many
devices run them. The multi-GPU `ShardedExecutor` is not ported yet
(ROADMAP.md Queue 1 item 7), and the port has no executor chosen by an
environment variable: `resolve_executor` takes an instance, ``"local"``
or None (the local executor).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union


class SolveExecutor:
    """Interface shared by all solve executors (duck-typed; this base
    class documents the contract)."""

    name: str = "abstract"

    def preferred_chunk(self, chunk: int, bucket: int = 0) -> int:
        """Dispatch granularity: the smallest batch size >= `chunk` this
        executor can lay out. The engine sizes its chunks and the
        micro-batcher its flush target with this."""
        raise NotImplementedError

    def device_count(self) -> int:
        raise NotImplementedError

    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """Axis-name -> size of the execution mesh (None when local)."""
        return None


@dataclasses.dataclass(frozen=True)
class LocalExecutor(SolveExecutor):
    """One device: the task's. Rows are solved by the task's
    `solve_rows` on its device."""

    name: str = dataclasses.field(default="local", init=False)

    def preferred_chunk(self, chunk: int, bucket: int = 0) -> int:
        return int(chunk)

    def device_count(self) -> int:
        return 1


ExecutorLike = Union[None, str, SolveExecutor]


def default_executor() -> SolveExecutor:
    return LocalExecutor()


def resolve_executor(executor: ExecutorLike = None) -> SolveExecutor:
    """Coerce an executor spec (instance | ``"local"`` | None) into an
    executor instance."""
    if executor is None:
        return default_executor()
    if isinstance(executor, str):
        if executor == "local":
            return LocalExecutor()
        if executor == "sharded":
            raise NotImplementedError(
                "the sharded executor is not ported yet (ROADMAP.md "
                "Queue 1 item 7); use 'local'")
        raise ValueError(f"unknown solve executor {executor!r}; "
                         "known: 'local'")
    return executor
