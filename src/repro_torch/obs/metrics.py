"""Fail-open labeled metrics: Counter / Gauge / Histogram registry
(a copy of `repro.obs.metrics`).

The one hard rule of this module (DESIGN.md §8.1): **instrumentation
must never break the solve path**. Every mutating call on a metric
(`inc` / `dec` / `set` / `observe`) swallows any exception raised inside
metric or sink code and counts it in the registry's self-metric
(exported as ``repro_obs_errors_total``), instead of propagating it into
`submit()`/`step()`. The same contract is available to instrumentation
facades via the `fail_open` decorator.

Conventions (linted by `obs.expo.lint_exposition`, scraped live in CI):

  * metric names: ``repro_<subsystem>_<what>[_unit]``, snake_case;
  * counters end in ``_total``; time histograms end in ``_seconds``;
  * label names are snake_case; label values are free-form strings
    (buckets and actions are stringified ints).

Stdlib-only and thread-safe: the HTTP exposition thread (`obs.expo`)
reads concurrently with the serving loop's writes. Metric families are
get-or-create, so repeated `registry.counter(name, ...)` calls from
several servers share one family — mirroring how the precision-backend
and executor registries are process-global. A module-level default
registry (`default_registry`) plays the role prometheus-client's
``REGISTRY`` does; isolated registries are for tests. The port's default
registry is its own: nothing here touches the JAX package's.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# Latency-shaped default buckets (seconds): micro-batched solves span
# ~100us (cached small bucket) to seconds (first-compile / huge n).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Ratio-shaped buckets for fractions in [0, 1] (pad waste).
RATIO_BUCKETS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.75, 0.9, 1.0)


class MetricsRegistry:
    """Holds metric families + the fail-open error count + sinks."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, "_Family"] = {}
        self._errors = 0
        self._sinks: List[Callable[[str, dict, float], None]] = []

    # -- fail-open accounting ----------------------------------------------
    def count_error(self) -> None:
        with self._lock:
            self._errors += 1

    @property
    def errors(self) -> int:
        """Instrumentation exceptions swallowed so far (self-metric)."""
        return self._errors

    # -- sinks -------------------------------------------------------------
    def add_sink(self, sink: Callable[[str, dict, float], None]) -> None:
        """Register a per-sample callback ``sink(name, labels, value)``.

        Sinks run inside the fail-open guard: a raising sink is counted
        in `errors` and never reaches the caller."""
        with self._lock:
            self._sinks.append(sink)

    def _notify(self, name: str, labels: dict, value: float) -> None:
        for sink in self._sinks:
            try:
                sink(name, labels, value)
            except Exception:
                self.count_error()

    # -- families (get-or-create) ------------------------------------------
    def _family(self, cls, name: str, help: str,
                labelnames: Tuple[str, ...], **kw) -> "_Family":
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(self, name, help, tuple(labelnames), **kw)
                self._families[name] = fam
            elif fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered with labels "
                    f"{tuple(labelnames)!r} != {fam.labelnames!r}")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> "Counter":
        return self._family(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> "Gauge":
        return self._family(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS
                  ) -> "Histogram":
        return self._family(Histogram, name, help, labelnames,
                            buckets=buckets)

    # -- collection --------------------------------------------------------
    def collect(self) -> List["_Family"]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)


class _Family:
    """One named metric with N labeled children."""

    type: str = "untyped"
    Child: type = None          # set by subclasses

    def __init__(self, registry: MetricsRegistry, name: str, help: str,
                 labelnames: Tuple[str, ...]):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labelvalues):
        """Child for one label combination (get-or-create). Wrong label
        names raise here — facade code reaches this only through
        `fail_open`-guarded methods, so the solve path never sees it."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames!r},"
                f" got {tuple(labelvalues)!r}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self.registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = type(self).Child(self, key)
            return child

    def _default_child(self):
        """The single unlabeled child (for labelless families)."""
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames!r}; "
                "use .labels(...)")
        return self.labels()

    def samples(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self.registry._lock:
            return sorted(self._children.items())

    def _labels_dict(self, key: Tuple[str, ...]) -> dict:
        return dict(zip(self.labelnames, key))


class _Child:
    """Shared child plumbing: family backref + label dict."""

    def __init__(self, family: _Family, key: Tuple[str, ...]):
        self._family = family
        self._labels = family._labels_dict(key)

    def _registry(self) -> MetricsRegistry:
        return self._family.registry


class Counter(_Family):
    type = "counter"

    class Child(_Child):
        def __init__(self, family, key):
            super().__init__(family, key)
            self.value = 0.0

        def inc(self, amount: float = 1.0) -> None:
            reg = self._registry()
            try:
                amount = float(amount)
                if amount < 0 or not math.isfinite(amount):
                    raise ValueError(
                        f"counter increment must be finite >= 0, "
                        f"got {amount}")
                with reg._lock:
                    self.value += amount
                reg._notify(self._family.name, self._labels, self.value)
            except Exception:
                reg.count_error()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)


class Gauge(_Family):
    type = "gauge"

    class Child(_Child):
        def __init__(self, family, key):
            super().__init__(family, key)
            self.value = 0.0

        def set(self, value: float) -> None:
            reg = self._registry()
            try:
                with reg._lock:
                    self.value = float(value)
                reg._notify(self._family.name, self._labels, self.value)
            except Exception:
                reg.count_error()

        def inc(self, amount: float = 1.0) -> None:
            reg = self._registry()
            try:
                with reg._lock:
                    self.value += float(amount)
                reg._notify(self._family.name, self._labels, self.value)
            except Exception:
                reg.count_error()

        def dec(self, amount: float = 1.0) -> None:
            self.inc(-amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)


class Histogram(_Family):
    type = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds: Tuple[float, ...] = tuple(bounds)

    class Child(_Child):
        def __init__(self, family, key):
            super().__init__(family, key)
            self.counts = [0] * (len(family.bounds) + 1)  # +Inf tail
            self.sum = 0.0
            self.count = 0

        def observe(self, value: float) -> None:
            reg = self._registry()
            try:
                value = float(value)
                with reg._lock:
                    for i, bound in enumerate(self._family.bounds):
                        if value <= bound:
                            break
                    else:
                        i = len(self._family.bounds)
                    self.counts[i] += 1
                    self.sum += value
                    self.count += 1
                reg._notify(self._family.name, self._labels, value)
            except Exception:
                reg.count_error()

        def cumulative(self) -> List[int]:
            """Cumulative per-`le` counts, +Inf last (Prometheus form)."""
            out, acc = [], 0
            for c in self.counts:
                acc += c
                out.append(acc)
            return out

    def observe(self, value: float) -> None:
        self._default_child().observe(value)


# ---------------------------------------------------------------------------
# Fail-open guard for instrumentation facades
# ---------------------------------------------------------------------------

def fail_open(method):
    """Decorator for instrumentation methods on objects exposing a
    `registry` attribute (a `MetricsRegistry`): any exception is counted
    in the registry's self-metric and never propagated. This is the
    boundary that keeps tracing/logging/exporter faults out of the
    solve path (DESIGN.md §8.1)."""
    @functools.wraps(method)
    def guarded(self, *args, **kwargs):
        try:
            return method(self, *args, **kwargs)
        except Exception:
            try:
                self.registry.count_error()
            except Exception:
                pass
            return None
    return guarded


# ---------------------------------------------------------------------------
# Process-default registry (mirrors prometheus-client's REGISTRY)
# ---------------------------------------------------------------------------

_DEFAULT_REGISTRY: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT_REGISTRY
    with _DEFAULT_LOCK:
        if _DEFAULT_REGISTRY is None:
            _DEFAULT_REGISTRY = MetricsRegistry()
        return _DEFAULT_REGISTRY
