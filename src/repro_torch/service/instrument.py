"""Fail-open bridge from serving-loop events to the obs layer (port of
`repro.service.instrument`, with the rollout controller's
`RolloutInstruments`).

`ServiceInstruments` owns every metric family, trace span, and
trajectory-log record the `AutotuneServer` emits; `LearnerInstruments`
does the same for the `OnlineLearner` (epsilon gauge, drift counter).
`Telemetry` remains the in-process *computation* layer — the gauges
here re-export its EWMAs rather than recomputing them (ROADMAP: "expose
it, don't reinvent it").

Every public method is wrapped in `obs.metrics.fail_open`: an exception
anywhere inside — a raising exporter sink, a monkeypatched tracer, a
full disk under the trajectory log — is swallowed, counted in
``repro_obs_errors_total``, and never reaches `submit()`/`step()`
(DESIGN.md §8.1).

Metric name conventions (linted live in CI): ``repro_`` prefix,
snake_case, counters ``_total``, time histograms ``_seconds``. Labels:
``task`` (TunableTask name), ``bucket`` (padded size bucket),
``executor`` (SolveExecutor name), ``action`` (action-space index),
``mode`` (``explore``/``greedy``).
"""
from __future__ import annotations

import time

from repro_torch.obs import Observability
from repro_torch.obs.metrics import RATIO_BUCKETS, fail_open


class ServiceInstruments:
    """Per-server instrumentation facade (request path)."""

    def __init__(self, obs: Observability, task_name: str,
                 executor_name: str):
        self.obs = obs
        self.registry = obs.registry          # fail_open counts here
        self.task = str(task_name)
        self.executor = str(executor_name)
        r = obs.registry
        self.requests = r.counter(
            "repro_service_requests_total",
            "Solve requests accepted by submit().", ("task", "bucket"))
        self.responses = r.counter(
            "repro_service_responses_total",
            "Completed responses (solve + reward + Q-update).",
            ("task", "bucket"))
        self.pending = r.gauge(
            "repro_service_pending_requests",
            "Requests queued in the micro-batcher.", ("task",))
        self.batches = r.counter(
            "repro_service_solver_batches_total",
            "Fixed-shape micro-batches flushed.",
            ("task", "bucket", "executor"))
        self.rows = r.counter(
            "repro_service_solver_rows_total",
            "Rows solved, including fixed-shape padding.",
            ("task", "bucket"))
        self.pad_rows = r.counter(
            "repro_service_padded_rows_total",
            "Wasted padding rows from fixed-shape flushes.",
            ("task", "bucket"))
        self.pad_waste = r.histogram(
            "repro_service_flush_pad_waste_ratio",
            "Per-flush fraction of rows that were padding.",
            ("task", "bucket"), buckets=RATIO_BUCKETS)
        self.latency = r.histogram(
            "repro_service_request_latency_seconds",
            "Submit-to-response latency.", ("task", "bucket"))
        self.queue_wait = r.histogram(
            "repro_service_queue_wait_seconds",
            "Enqueue-to-solve-start wait in the micro-batcher.",
            ("task", "bucket"))
        self.solve_seconds = r.histogram(
            "repro_service_solve_batch_seconds",
            "Wall time of one micro-batch solve_rows call.",
            ("task", "bucket", "executor"))
        self.reward_ewma = r.gauge(
            "repro_service_reward_ewma",
            "Telemetry reward EWMA (exposed, not recomputed).", ("task",))
        self.abs_rpe_ewma = r.gauge(
            "repro_service_abs_rpe_ewma",
            "Telemetry |reward-prediction-error| EWMA.", ("task",))
        self.actions = r.counter(
            "repro_service_actions_total",
            "Actions selected, by action index and selection mode.",
            ("task", "action", "mode"))
        self.policy_info = r.gauge(
            "repro_service_policy_info",
            "Constant 1 for the live policy version (info pattern).",
            ("task", "version"))
        self.snapshots = r.counter(
            "repro_service_snapshots_total",
            "Live-policy snapshots published from this server.", ("task",))
        self.evicted = r.counter(
            "repro_server_responses_evicted_total",
            "Unclaimed SolveResponses evicted from the bounded LRU "
            "retention (consumers that never poll()).", ("task",))
        # Fault-tolerance surface (DESIGN.md §11).
        self.breaker_state = r.gauge(
            "repro_breaker_state",
            "Per-bucket circuit-breaker state "
            "(0=closed, 0.5=half_open, 1=open).", ("task", "bucket"))
        self.breaker_transitions = r.counter(
            "repro_breaker_transitions_total",
            "Circuit-breaker state changes, by edge.",
            ("task", "bucket", "from", "to"))
        self.quarantined = r.counter(
            "repro_quarantined_updates_total",
            "Rewards observed but NOT applied to the Q-table (breaker "
            "open, pinned traffic, or non-finite reward).",
            ("task", "bucket"))
        self.expired = r.counter(
            "repro_expired_requests_total",
            "Requests answered with a terminal FAILED response because "
            "their batcher deadline expired before a solve ran.",
            ("task", "bucket"))

    # -- request path ------------------------------------------------------
    @fail_open
    def on_submit(self, bucket: int, action: int, explore: bool,
                  pending: int) -> None:
        self.requests.labels(task=self.task, bucket=bucket).inc()
        self.actions.labels(task=self.task, action=action,
                            mode="explore" if explore else "greedy").inc()
        self.pending.labels(task=self.task).set(pending)

    @fail_open
    def on_flush(self, flush, pending: int) -> None:
        n_live = len(flush.req_ids)
        lab = dict(task=self.task, bucket=flush.bucket)
        self.batches.labels(executor=self.executor, **lab).inc()
        self.rows.labels(**lab).inc(flush.n_rows)
        self.pad_rows.labels(**lab).inc(flush.n_rows - n_live)
        self.pad_waste.labels(**lab).observe(
            (flush.n_rows - n_live) / max(flush.n_rows, 1))
        self.solve_seconds.labels(executor=self.executor, **lab).observe(
            flush.solve_s)
        self.pending.labels(task=self.task).set(pending)

    @fail_open
    def on_complete(self, resp, info, flush, telemetry,
                    t_reward: float, t_update: float) -> None:
        """One finished request: metrics + trace spans + trajectory."""
        lab = dict(task=self.task, bucket=resp.bucket)
        self.responses.labels(**lab).inc()
        self.latency.labels(**lab).observe(resp.latency_s)
        self.reward_ewma.labels(task=self.task).set(
            telemetry.reward_ewma.value)
        self.abs_rpe_ewma.labels(task=self.task).set(
            telemetry.abs_rpe_ewma.value)
        self.policy_info.labels(task=self.task,
                                version=resp.policy_version).set(1)
        rid = resp.request_id
        t_sub, t_done = info.submitted_at, info.submitted_at + resp.latency_s
        tracer = self.obs.tracer
        tracer.add_span("request", info.t_accept, t_done, tid=rid,
                        bucket=resp.bucket, action=resp.action,
                        reward=resp.reward)
        tracer.add_span("submit", info.t_accept, t_sub, tid=rid)
        if flush is not None:
            self.queue_wait.labels(**lab).observe(
                max(flush.t_solve_start - t_sub, 0.0))
            tracer.add_span("queue_wait", t_sub, flush.t_solve_start,
                            tid=rid)
            tracer.add_span("solve", flush.t_solve_start,
                            flush.t_solve_end, tid=rid,
                            bucket=resp.bucket, n_rows=flush.n_rows)
            tracer.add_span("reward", flush.t_solve_end, t_reward,
                            tid=rid)
        tracer.add_span("q_update", t_reward, t_update, tid=rid,
                        state=resp.state, drift=resp.drift)
        if self.obs.trajlog is not None:
            rec = resp.record
            self.obs.trajlog.append({
                "ts": time.time(),
                "request_id": rid,
                "task": self.task,
                "bucket": int(resp.bucket),
                "features": [float(x) for x in info.features],
                "state": int(resp.state),
                "action": int(resp.action),
                "action_names": list(resp.action_names),
                "eps": float(resp.eps),
                "explore": bool(info.explore),
                "reward": float(resp.reward),
                "outcome": {"status": int(rec.status),
                            "cost": float(rec.cost),
                            **{k: v for k, v in rec.metrics.items()}},
                "latency_s": float(resp.latency_s),
                "policy_version": resp.policy_version,
                "drift": bool(resp.drift),
                # WAL keys (service.recovery): `seq` orders records
                # against snapshot watermarks; `quarantined` records are
                # skipped on replay — they never trained the live table.
                "seq": int(resp.seq),
                "quarantined": bool(resp.quarantined),
            })

    # -- fault tolerance ---------------------------------------------------
    @fail_open
    def on_breaker_transition(self, bucket: int, old: str,
                              new: str) -> None:
        from repro_torch.service.breaker import STATE_VALUES
        self.breaker_state.labels(task=self.task, bucket=bucket).set(
            STATE_VALUES.get(new, 1.0))
        self.breaker_transitions.labels(
            task=self.task, bucket=bucket,
            **{"from": old, "to": new}).inc()

    @fail_open
    def on_quarantine(self, bucket: int) -> None:
        self.quarantined.labels(task=self.task, bucket=bucket).inc()

    @fail_open
    def on_expired(self, bucket: int) -> None:
        self.expired.labels(task=self.task, bucket=bucket).inc()

    @fail_open
    def on_snapshot(self, version: str) -> None:
        self.snapshots.labels(task=self.task).inc()
        self.policy_info.labels(task=self.task, version=version).set(1)

    @fail_open
    def on_evict(self, n: int = 1) -> None:
        self.evicted.labels(task=self.task).inc(n)


class LearnerInstruments:
    """Epsilon/drift instrumentation for the continual learner."""

    def __init__(self, obs: Observability):
        self.obs = obs
        self.registry = obs.registry
        r = obs.registry
        self.epsilon = r.gauge(
            "repro_online_epsilon",
            "Exploration rate currently in force.")
        self.updates = r.counter(
            "repro_online_updates_total", "Online Q-updates applied.")
        self.drifts = r.counter(
            "repro_online_drift_events_total",
            "Drift-detector triggers (epsilon re-boosts).")

    @fail_open
    def on_update(self, upd) -> None:
        self.epsilon.set(upd.eps)
        self.updates.inc()
        if upd.drift:
            self.drifts.inc()


class RolloutInstruments:
    """Canary rollout-controller instrumentation (service.rollout).

    Label vocabulary extends the service set with ``outcome``
    (``hold``/``promote``/``rollback``/``ope_accept``/``ope_reject``)
    and ``arm`` (``primary``/``candidate``/``shadow``)."""

    def __init__(self, obs: Observability, task_name: str):
        self.obs = obs
        self.registry = obs.registry
        self.task = str(task_name)
        r = obs.registry
        self.decisions = r.counter(
            "repro_rollout_decisions_total",
            "Canary gate decisions, by outcome.", ("task", "outcome"))
        self.routed = r.counter(
            "repro_rollout_requests_total",
            "Requests routed by the shadow server, by arm.",
            ("task", "arm"))
        self.active = r.gauge(
            "repro_rollout_active",
            "1 while a canary rollout is in flight.", ("task",))
        self.windows = r.gauge(
            "repro_rollout_windows_passed",
            "Consecutive decision windows the candidate has passed.",
            ("task",))
        self.candidate_responses = r.gauge(
            "repro_rollout_candidate_responses",
            "Candidate-arm responses accumulated this rollout.", ("task",))

    @fail_open
    def on_route(self, arm: str) -> None:
        self.routed.labels(task=self.task, arm=arm).inc()

    @fail_open
    def on_state(self, active: bool, windows_passed: int,
                 candidate_responses: int) -> None:
        self.active.labels(task=self.task).set(1 if active else 0)
        self.windows.labels(task=self.task).set(windows_passed)
        self.candidate_responses.labels(task=self.task).set(
            candidate_responses)

    @fail_open
    def on_decision(self, outcome: str) -> None:
        self.decisions.labels(task=self.task, outcome=outcome).inc()
