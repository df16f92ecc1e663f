"""Retry with exponential backoff and deterministic jitter.

Counterpart of the JAX package's ``resilience/retry.py``: a failed serving
op is retried a bounded number of times with exponentially growing,
jittered delays before the failure reaches callers.  The jitter comes from
a SEEDED RNG, so two runs of the same workload retry on the same schedule.

:class:`RetryPolicy` is pure configuration (safe to share across
batchers); :func:`retry_call` executes one call under a policy.  The
:class:`~tensordiffeq_tpu_torch.serving.RequestBatcher` drives its own
attempt loop (it checks its circuit breaker between attempts) through
:meth:`RetryPolicy.delay_s` and :meth:`RetryPolicy.retryable`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

import numpy as np

from ..telemetry import log_event


@dataclass
class RetryPolicy:
    """Bounded exponential backoff: attempt ``k`` (1-based) sleeps
    ``min(base_delay_s * multiplier**(k-1), max_delay_s)``, spread by
    ``±jitter`` (fraction) from the policy's seeded RNG.

    ``retry_on`` bounds WHAT is transient: exception types outside the
    tuple propagate immediately (a shape error will never heal by waiting).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    _rng: np.random.RandomState = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        self._rng = np.random.RandomState(self.seed)

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retry_on)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retrying after failed attempt ``attempt``
        (1-based).  Deterministic for a given seed + call sequence."""
        base = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)
        if not self.jitter:
            return base
        spread = self.jitter * (2.0 * self._rng.uniform() - 1.0)
        return max(0.0, base * (1.0 + spread))


def retry_call(fn: Callable, policy: Optional[RetryPolicy] = None, *,
               name: str = "op", sleep: Callable[[float], None] = time.sleep,
               registry=None, verbose: bool = False):
    """Run ``fn()`` under ``policy``; returns its value or raises the last
    failure once attempts are exhausted (or immediately for a
    non-retryable exception type).

    Every retry lands in telemetry: a ``retry`` event per failed attempt
    and ``resilience.retry.attempts`` / ``.recovered`` / ``.exhausted``
    counters in ``registry`` (default: the shared process registry).
    """
    policy = policy or RetryPolicy()
    if registry is None:
        from ..telemetry import default_registry
        registry = default_registry()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            out = fn()
            if attempt > 1:
                registry.counter("resilience.retry.recovered", op=name).inc()
                log_event("retry", f"{name} recovered on attempt {attempt}",
                          verbose=verbose, op=name, attempt=attempt,
                          recovered=True)
            return out
        except BaseException as e:  # noqa: BLE001 — policy decides
            last = e
            if not policy.retryable(e) or attempt >= policy.max_attempts:
                break
            delay = policy.delay_s(attempt)
            registry.counter("resilience.retry.attempts", op=name).inc()
            log_event("retry", f"{name} attempt {attempt}/"
                      f"{policy.max_attempts} failed "
                      f"({type(e).__name__}: {e}); retrying in {delay:.3f}s",
                      level="warning", verbose=verbose, op=name,
                      attempt=attempt, error=f"{type(e).__name__}: {e}",
                      delay_s=delay)
            sleep(delay)
    registry.counter("resilience.retry.exhausted", op=name).inc()
    raise last
