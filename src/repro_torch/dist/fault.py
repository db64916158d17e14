"""Fault tolerance: straggler detection, preemption drain, restart loop
(a copy of ``repro.dist.fault`` that reports to ``repro_torch.obs``).

Single-process analogues of the multi-host policies (the trainer wires
them in; the reference's ``tests/test_substrate.py`` pins the semantics):

  * ``StepWatchdog`` tracks recent step durations; ``check(dur)`` raises
    ``StragglerDetected`` when a step exceeds ``timeout_factor`` x the
    running median — the signal a multi-host deployment uses to evict a
    slow host rather than let it gate every all-reduce.
  * ``PreemptionHandler`` converts SIGTERM (the cloud preemption notice)
    into a flag the training loop drains at the next step boundary.
  * ``run_with_restarts`` is the supervisor: (re)build state from the
    latest checkpoint and run; on a crash, restart up to ``max_restarts``
    times — combined with atomic checkpoints this makes mid-training node
    failure a bounded-cost event instead of a lost run.

All three emit liveness counters through ``repro_torch.obs``
(``watchdog_heartbeats_total`` / ``watchdog_stragglers_total`` /
``preemptions_total`` / ``restarts_total``) — the saturation signals a
fleet scheduler watches; pass ``registry=`` to scope them, default is the
process-global registry.
"""

from __future__ import annotations

import signal
import statistics
import time
from collections import deque
from typing import Any, Callable, Optional, Tuple

from repro_torch.obs import metrics as _obs_metrics


def _registry(registry):
    """Fault-layer metrics default to the process-global registry so a
    supervisor scraping one endpoint sees every component's health."""
    return registry if registry is not None else _obs_metrics.default_registry()


class StragglerDetected(RuntimeError):
    """A step ran anomalously slow vs. the recent-step median."""


class StepWatchdog:
    def __init__(
        self,
        timeout_factor: float = 5.0,
        warmup_steps: int = 5,
        window: int = 50,
        registry=None,  # repro_torch.obs Registry (default: process-global)
    ):
        self.timeout_factor = timeout_factor
        self.warmup_steps = warmup_steps
        self.durations: deque[float] = deque(maxlen=window)
        self._t0: Optional[float] = None
        reg = _registry(registry)
        self._heartbeats = reg.counter(
            "watchdog_heartbeats_total", "completed steps the watchdog saw"
        )
        self._stragglers = reg.counter(
            "watchdog_stragglers_total", "steps flagged as stragglers"
        )

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self) -> float:
        """Record the step duration (no check — jit compiles on step 0 and
        GC pauses are routine; callers probe explicitly via ``check``)."""
        if self._t0 is None:
            raise RuntimeError("end_step without start_step")
        dur = time.monotonic() - self._t0
        self._t0 = None
        self.durations.append(dur)
        self._heartbeats.inc()
        return dur

    def median(self) -> Optional[float]:
        if len(self.durations) < max(self.warmup_steps, 1):
            return None
        return statistics.median(self.durations)

    def check(self, duration: float) -> None:
        """Raise StragglerDetected if ``duration`` is anomalous."""
        med = self.median()
        if med is not None and duration > self.timeout_factor * med:
            self._stragglers.inc()
            raise StragglerDetected(
                f"step took {duration:.3f}s vs median {med:.3f}s "
                f"(factor {self.timeout_factor})"
            )


class PreemptionHandler:
    """SIGTERM -> drain flag.  ``install=False`` for tests / nested use."""

    def __init__(self, install: bool = True, signals=(signal.SIGTERM,),
                 registry=None):
        self.requested = False
        self._preemptions = _registry(registry).counter(
            "preemptions_total", "preemption notices received"
        )
        if install:
            for s in signals:
                signal.signal(s, self.trigger)

    def trigger(self, *_args) -> None:
        self.requested = True
        self._preemptions.inc()


def run_with_restarts(
    make_state: Callable[[], Any],
    run_steps: Callable[[Any, int], Any],
    *,
    steps_per_attempt: int,
    max_restarts: int = 3,
    registry=None,
) -> Tuple[Any, int]:
    """Supervise a training run: rebuild state (resume from the latest
    checkpoint) and run; restart on any crash.  Returns
    ``(final_state, restarts_used)``; re-raises after ``max_restarts``."""
    restart_counter = _registry(registry).counter(
        "restarts_total", "supervisor restarts after a crash"
    )
    restarts = 0
    while True:
        state = make_state()
        try:
            return run_steps(state, steps_per_attempt), restarts
        except Exception:
            restarts += 1
            restart_counter.inc()
            if restarts > max_restarts:
                raise
