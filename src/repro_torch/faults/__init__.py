"""Deterministic seeded fault injection (port of `repro.faults`;
DESIGN.md §11.3).

Per test::

    from repro_torch.faults import FaultSpec, injected
    with injected(FaultSpec("batcher.flush", "raise", p=0.5), seed=7):
        ...

The port reads no environment variable: a chaos run builds its injector
with `from_env(plan, seed)` and `install`s it.
"""
from repro_torch.faults.injector import (KINDS, SITES, FaultInjected,
                                         FaultInjector, FaultSpec, active,
                                         corrupt_outcome, from_env,
                                         injected, install, maybe_raise,
                                         uninstall, wrap_clock)

__all__ = [
    "FaultInjected", "FaultInjector", "FaultSpec", "KINDS", "SITES",
    "active", "corrupt_outcome", "from_env", "injected", "install",
    "maybe_raise", "uninstall", "wrap_clock",
]
