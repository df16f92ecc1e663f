"""Circuit breaker for the serving path.

Counterpart of the JAX package's ``resilience/breaker.py``.  Retry
(``retry.py``) handles *transient* faults; a breaker handles *sustained*
ones.  When a serving backend is down, retrying every request multiplies
load and stacks callers behind a dead op.  The breaker counts consecutive
failures and, past a threshold, **opens**: calls fast-fail with a
structured :class:`CircuitOpenError`.  After ``reset_timeout_s`` it goes
**half-open** and lets a limited number of probe calls through; a success
closes it, a failure re-opens it for another timeout window::

    closed --(failure_threshold consecutive failures)--> open
    open   --(reset_timeout_s elapsed)----------------> half-open
    half-open --success--> closed      half-open --failure--> open

Every transition is a ``breaker`` event (:func:`~..telemetry.log_event`),
a ``resilience.breaker.transitions{to=...}`` counter and a state gauge
(``resilience.breaker.state``: 0 closed / 1 half-open / 2 open) in the
registry.  The clock is injectable, so tests drive open -> half-open with a
fake clock.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..telemetry import log_event

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Fast-fail raised while the breaker is open.  ``retry_after_s`` is
    the remaining cool-down — a structured backpressure hint for callers
    (and the batcher's timeout sweep)."""

    def __init__(self, name: str, retry_after_s: float):
        self.breaker = name
        self.retry_after_s = max(0.0, float(retry_after_s))
        super().__init__(
            f"circuit breaker {name!r} is open; retry in "
            f"{self.retry_after_s:.2f}s")


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    Args:
      failure_threshold: consecutive failures that open the circuit.
      reset_timeout_s: cool-down before a half-open probe is allowed.
      half_open_max: probe calls admitted per half-open window (further
        calls fast-fail until a probe resolves).
      name: label for events/metrics (one registry can host many).
      clock: time source, injectable for tests.
      registry: metrics destination (default: the shared process registry).
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, half_open_max: int = 1,
                 name: str = "serving", clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, "
                             f"got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max = int(half_open_max)
        self.name = str(name)
        self._clock = clock
        self.state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._half_open_inflight = 0
        if registry is None:
            from ..telemetry import default_registry
            registry = default_registry()
        self._metrics = registry
        self._metrics.gauge("resilience.breaker.state",
                            breaker=self.name).set(_STATE_GAUGE[self.state])

    # ------------------------------------------------------------------ #
    def _transition(self, to: str, why: str):
        if to == self.state:
            return
        log_event("breaker", f"{self.name}: {self.state} -> {to} ({why})",
                  level="warning" if to == OPEN else "info", verbose=False,
                  name=self.name, from_state=self.state, to_state=to,
                  reason=why)
        self.state = to
        self._metrics.counter("resilience.breaker.transitions",
                              breaker=self.name, to=to).inc()
        self._metrics.gauge("resilience.breaker.state",
                            breaker=self.name).set(_STATE_GAUGE[to])
        if to == OPEN:
            self._opened_at = self._clock()
        if to != HALF_OPEN:
            self._half_open_inflight = 0

    def retry_after_s(self) -> float:
        """Remaining cool-down (0 when a call would be admitted now)."""
        if self.state != OPEN or self._opened_at is None:
            return 0.0
        return max(0.0, self.reset_timeout_s
                   - (self._clock() - self._opened_at))

    def allow(self) -> bool:
        """May a call proceed right now?  Open circuits flip to half-open
        once the cool-down has elapsed; half-open admits up to
        ``half_open_max`` in-flight probes."""
        if self.state == OPEN:
            if self.retry_after_s() > 0.0:
                self._metrics.counter("resilience.breaker.rejected",
                                      breaker=self.name).inc()
                return False
            self._transition(HALF_OPEN, "reset timeout elapsed")
        if self.state == HALF_OPEN:
            if self._half_open_inflight >= self.half_open_max:
                self._metrics.counter("resilience.breaker.rejected",
                                      breaker=self.name).inc()
                return False
            self._half_open_inflight += 1
        return True

    def record_success(self):
        self._consecutive_failures = 0
        if self.state == HALF_OPEN:
            self._transition(CLOSED, "probe succeeded")

    def record_failure(self):
        self._consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._transition(OPEN, "probe failed")
        elif self.state == CLOSED \
                and self._consecutive_failures >= self.failure_threshold:
            self._transition(
                OPEN, f"{self._consecutive_failures} consecutive failures")

    # ------------------------------------------------------------------ #
    def call(self, fn: Callable, *args, **kwargs):
        """Gate + account one call: raises :class:`CircuitOpenError` when
        the circuit rejects it, otherwise runs ``fn`` and records the
        outcome."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return out
