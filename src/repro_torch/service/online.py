"""Continual online learning: epsilon control + drift detection (a copy
of `repro.service.online`).

The offline trainer anneals epsilon to `eps_min` over a fixed episode
budget (Eq. 13) and stops. A long-running service never stops: it keeps a
small exploration floor forever, and must *re-open* exploration when the
instance distribution drifts — "Learning to Relax" (Khodak et al.) treats
the online sequence-of-instances setting; Chen's RL-CG work observes that
precision policies go stale under drift.

Drift signal: two EWMAs of |reward-prediction-error|. The slow one tracks
the long-run surprise baseline; the fast one tracks the current regime. A
fast/slow ratio blow-out (after warmup, with a cooldown between triggers)
means the Q-table's predictions stopped matching observed rewards —
i.e. the request distribution moved — and epsilon is boosted back up to
`eps_boost`, then re-annealed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.bandit import QTable
from repro_torch.service.telemetry import Ewma


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    eps0: float = 0.10            # exploration right after warm-start
    eps_min: float = 0.02         # permanent exploration floor
    eps_boost: float = 0.50       # re-exploration level after drift
    decay_updates: int = 500      # updates to anneal eps -> eps_min
    alpha: Optional[float] = 0.1  # online learning rate (None => 1/N)
    ewma_fast: float = 0.10       # fast |RPE| EWMA coefficient
    ewma_slow: float = 0.01       # baseline |RPE| EWMA coefficient
    drift_ratio: float = 2.0      # trigger: fast > ratio * slow + margin
    drift_margin: float = 0.25    # absolute slack (units of reward)
    warmup_updates: int = 64      # no drift checks before this many updates
    cooldown_updates: int = 128   # min updates between triggers


class EpsilonController:
    """Linear anneal from a (re)startable level down to the floor."""

    def __init__(self, cfg: OnlineConfig):
        self.cfg = cfg
        self._level = cfg.eps0
        self._t = 0

    @property
    def value(self) -> float:
        frac = min(self._t / max(self.cfg.decay_updates, 1), 1.0)
        return max(self.cfg.eps_min,
                   self._level + (self.cfg.eps_min - self._level) * frac)

    def step(self) -> None:
        self._t += 1

    def boost(self) -> None:
        """Drift response: re-open exploration and re-anneal."""
        self._level = self.cfg.eps_boost
        self._t = 0


class DriftDetector:
    """Fast-EWMA vs frozen-then-adaptive baseline on |RPE|.

    The fast EWMA (bias-corrected) tracks the current surprise level. The
    baseline is pinned to the fast value when warmup ends — the established
    regime — and from then on adapts as a plain EWMA over *non-anomalous*
    samples only: a sample that already exceeds the trigger threshold is
    evidence of a new regime and must not drag the reference along before
    the trigger fires. (A naive bias-corrected slow EWMA degenerates to a
    running mean at small sample counts and chases the fast EWMA, so the
    ratio never opens; pin-then-gate avoids that.)
    """

    def __init__(self, cfg: OnlineConfig):
        self.cfg = cfg
        self._fast = Ewma(cfg.ewma_fast)
        self._slow: Optional[float] = None
        self._updates = 0
        self._last_trigger = -cfg.cooldown_updates

    @property
    def fast(self) -> float:
        return self._fast.value

    @property
    def slow(self) -> float:
        return self._slow if self._slow is not None else 0.0

    def update(self, abs_rpe: float) -> bool:
        """Feed one |RPE| sample; True iff this sample triggers drift."""
        c = self.cfg
        x = abs(abs_rpe)
        self._updates += 1
        self._fast.update(x)
        if self._updates < c.warmup_updates:
            return False
        if self._slow is None:        # warmup just ended: pin the baseline
            self._slow = self.fast
        anomalous = self.fast > c.drift_ratio * self._slow + c.drift_margin
        if not anomalous:
            self._slow += c.ewma_slow * (x - self._slow)
        if self._updates - self._last_trigger < c.cooldown_updates:
            return False
        if anomalous:
            self._last_trigger = self._updates
            # Re-baseline so one regime change fires exactly once.
            self._slow = self.fast
            return True
        return False


@dataclasses.dataclass
class OnlineUpdate:
    rpe: float
    eps: float
    drift: bool


class OnlineLearner:
    """Continual-learning wrapper: epsilon control + drift detection on
    top of the single Q-update primitive.

    Accepts the live `QTable` directly, or anything exposing one via a
    `.qtable` attribute (an `AutotuneEngine` or `PrecisionPolicy`), so
    the server can hand it the shared engine.

    `obs` (a `repro_torch.obs.Observability`) exports the live epsilon gauge
    and drift/update counters; the hook is fail-open (DESIGN.md §8.1)
    and optional, so offline/test users pay nothing."""

    def __init__(self, qtable, cfg: OnlineConfig = OnlineConfig(),
                 obs=None):
        self.qtable: QTable = getattr(qtable, "qtable", qtable)
        self.cfg = cfg
        self.epsilon = EpsilonController(cfg)
        self.drift = DriftDetector(cfg)
        self._instr = None
        if obs is not None:
            from repro_torch.service.instrument import LearnerInstruments
            self._instr = LearnerInstruments(obs)

    def select(self, state: int) -> int:
        return self.qtable.select(state, self.epsilon.value)

    def update(self, state: int, action: int, reward: float,
               explore: bool = False) -> OnlineUpdate:
        """Q-update + drift check.

        `explore=True` marks an action taken by the epsilon coin: its RPE
        still trains Q, but is excluded from drift detection — exploratory
        actions have intentionally unconverged Q estimates, so their large
        RPEs are expected noise, not evidence the greedy policy went stale.
        First visits to a state are excluded for the same reason: the RPE
        against an all-zero Q row is trivially the full reward magnitude.
        """
        novel = not self.qtable.visited(state)
        rpe = self.qtable.update(state, action, reward)
        drifted = (False if (explore or novel)
                   else self.drift.update(abs(rpe)))
        if drifted:
            self.epsilon.boost()
        self.epsilon.step()
        upd = OnlineUpdate(rpe, self.epsilon.value, drifted)
        if self._instr is not None:
            self._instr.on_update(upd)
        return upd
