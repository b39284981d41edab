"""Deterministic, seeded fault injection for the serving stack (port of
`repro.faults.injector`; DESIGN.md §11.3).

A `FaultInjector` holds a list of `FaultSpec`s — (site, kind, firing
policy) triples — and is consulted from fixed *injection points*
threaded through the production code: the solver outcome path, the
engine's solve cache, micro-batcher flush, registry I/O and
trajectory-log writes. With no injector installed every injection point
is a no-op costing one module-attribute read, so production traffic
pays nothing.

Determinism is the contract: each spec owns a `random.Random((seed << 8)
^ spec_index)` stream and fires on its own hit counter, so a spec list
and a seed give the same fault schedule every run, and the same one as
the JAX package's injector. Faults are installed per test with
``with injected(FaultSpec("batcher.flush", "raise")): ...`` or
explicitly with `install`. Unlike the JAX package, the port never reads
the environment: a chaos run parses its plan with `from_env(plan, seed)`
and installs the injector itself.

Fault kinds:

  ``nan``          corrupt an `Outcome`: every metric (and cost) → NaN,
                   status preserved — the poisoned-reward vector the
                   breaker quarantine must stop.
  ``divergence``   corrupt an `Outcome`: status → FAILED, residual-like
                   metrics → +inf — a diverged solve.
  ``raise``        raise `FaultInjected` (RuntimeError) at the site.
  ``io_error``     raise `OSError` at the site (registry/log I/O).
  ``delay``        sleep `value` seconds at the site (slow solves).
  ``clock_skew``   advance a wrapped clock by `value` seconds per fire.

Every fire is counted fail-open in
``repro_faults_injected_total{site,kind}`` on the port's default metrics
registry.
"""
from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: Injection points (the JAX package's inventory).
SITES = (
    "solver.outcome",     # corrupt a solved Outcome (batcher + engine)
    "engine.solve",       # raise inside the engine solve cache
    "executor.dispatch",  # raise/delay inside SolveExecutor.dispatch
    "batcher.flush",      # raise/delay inside a micro-batch flush
    "registry.io",        # I/O error in snapshot publish/promote/load
    "trajlog.write",      # I/O error appending to the trajectory log
    "http.request",       # raise/delay in the HTTP dispatch path
    "clock",              # skew a wrap_clock()-wrapped server clock
)

KINDS = ("nan", "divergence", "raise", "io_error", "delay", "clock_skew")


class FaultInjected(RuntimeError):
    """Raised at an injection point by a ``raise``-kind spec."""


@dataclasses.dataclass
class FaultSpec:
    """One fault: where, what, and the (deterministic) firing policy.

    ``p`` is the per-hit firing probability, drawn from the spec's own
    seeded stream; ``after`` skips the first N matching hits; hits
    beyond ``max_fires`` fires never fire again. ``match`` is a
    code-only predicate over the injection point's context kwargs
    (e.g. ``lambda ctx: not ctx.get("safe_arm")``)."""

    site: str
    kind: str
    p: float = 1.0
    after: int = 0
    max_fires: Optional[int] = None
    value: float = 0.05         # seconds, for delay / clock_skew
    match: Optional[Callable[[dict], bool]] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")


class FaultInjector:
    """Deterministic fault scheduler over a list of `FaultSpec`s."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        # One independent stream + hit/fire counter per spec: adding a
        # spec to a plan never perturbs the schedule of the others.
        self._rngs = [random.Random((self.seed << 8) ^ i)
                      for i in range(len(self.specs))]
        self.hits: List[int] = [0] * len(self.specs)
        self.fires: List[int] = [0] * len(self.specs)

    def fire(self, site: str, **ctx) -> Optional[FaultSpec]:
        """First spec that fires at `site` for this hit, else None."""
        fired = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.match is not None:
                    try:
                        if not spec.match(ctx):
                            continue
                    except Exception:
                        continue
                self.hits[i] += 1
                if self.hits[i] <= spec.after:
                    continue
                if (spec.max_fires is not None
                        and self.fires[i] >= spec.max_fires):
                    continue
                if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                    continue
                self.fires[i] += 1
                fired = spec
                break
        if fired is not None:
            _count_fire(site, fired.kind)
        return fired

    def counts(self) -> Dict[Tuple[str, str], Tuple[int, int]]:
        """(site, kind) -> (hits, fires) for every spec."""
        with self._lock:
            return {(s.site, s.kind): (h, f) for s, h, f
                    in zip(self.specs, self.hits, self.fires)}


def _count_fire(site: str, kind: str) -> None:
    """Fail-open fire counter on the port's default metrics registry."""
    try:
        from repro_torch.obs.metrics import default_registry
        default_registry().counter(
            "repro_faults_injected_total",
            "Faults fired by the injection subsystem, by site and kind.",
            ("site", "kind")).labels(site=site, kind=kind).inc()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Process-global installation (per test via `injected`, or `install`)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
    """Install `injector` as the process-global fault source (None
    uninstalls). Prefer the `injected` context manager in tests."""
    global _ACTIVE
    _ACTIVE = injector


def uninstall() -> None:
    """Remove any installed injector."""
    install(None)


def active() -> Optional[FaultInjector]:
    """The installed injector, if any."""
    return _ACTIVE


@contextmanager
def injected(*specs: FaultSpec, seed: int = 0):
    """Install a fresh injector for the `with` body, restoring whatever
    was active before (the per-test entry point)."""
    global _ACTIVE
    prev = _ACTIVE
    inj = FaultInjector(specs, seed=seed)
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = prev


def from_env(plan: str, seed: int = 0) -> FaultInjector:
    """Parse a plan string (the JAX package's ``REPRO_FAULTS`` grammar)
    into an injector; the caller installs it.

    Grammar: ``site:kind[:p=F][:after=N][:max=N][:value=F]`` joined by
    ``;``. Example::

        solver.outcome:divergence:p=0.15;trajlog.write:io_error:max=3
    """
    specs: List[FaultSpec] = []
    for part in plan.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"bad fault spec {part!r}: need site:kind")
        kwargs: dict = {}
        for opt in fields[2:]:
            k, _, v = opt.partition("=")
            k = k.strip()
            if k == "p":
                kwargs["p"] = float(v)
            elif k == "after":
                kwargs["after"] = int(v)
            elif k == "max":
                kwargs["max_fires"] = int(v)
            elif k == "value":
                kwargs["value"] = float(v)
            else:
                raise ValueError(f"unknown fault option {opt!r} in {part!r}")
        specs.append(FaultSpec(fields[0].strip(), fields[1].strip(),
                               **kwargs))
    return FaultInjector(specs, seed=seed)


# ---------------------------------------------------------------------------
# Injection-point helpers (what production code calls)
# ---------------------------------------------------------------------------

def _raise_or_delay(spec: FaultSpec, site: str) -> None:
    if spec.kind == "raise":
        raise FaultInjected(f"injected fault at {site}")
    if spec.kind == "io_error":
        raise OSError(f"injected I/O error at {site}")
    if spec.kind == "delay":
        time.sleep(max(float(spec.value), 0.0))


def maybe_raise(site: str, **ctx) -> None:
    """Raise at `site` when a ``raise``/``io_error`` spec fires; apply
    ``delay`` specs too (a slow solve is observed at the same points an
    exception would be)."""
    inj = _ACTIVE
    if inj is None:
        return
    spec = inj.fire(site, **ctx)
    if spec is not None:
        _raise_or_delay(spec, site)


def corrupt_outcome(site: str, outcome, **ctx):
    """Return `outcome`, possibly corrupted by a ``nan``/``divergence``
    spec at `site` (other kinds at the site behave as in maybe_raise)."""
    inj = _ACTIVE
    if inj is None:
        return outcome
    spec = inj.fire(site, **ctx)
    if spec is None:
        return outcome
    from repro_torch.core.task import FAILED, Outcome
    if spec.kind == "nan":
        # Healthy-looking status with poisoned numbers: the reward
        # computed from these metrics is NaN — the quarantine test case.
        return Outcome(status=int(outcome.status), cost=math.nan,
                       metrics={k: math.nan for k in outcome.metrics})
    if spec.kind == "divergence":
        return Outcome(status=FAILED, cost=float(outcome.cost),
                       metrics={k: math.inf for k in outcome.metrics})
    _raise_or_delay(spec, site)
    return outcome


def wrap_clock(clock: Callable[[], float]) -> Callable[[], float]:
    """Wrap a clock callable so ``clock_skew`` specs at site ``clock``
    accumulate an offset (each fire adds `value` seconds). With no
    injector active the wrapper is a transparent pass-through."""
    offset = [0.0]

    def skewed() -> float:
        inj = _ACTIVE
        if inj is not None:
            spec = inj.fire("clock")
            if spec is not None and spec.kind == "clock_skew":
                offset[0] += float(spec.value)
        return clock() + offset[0]

    return skewed
