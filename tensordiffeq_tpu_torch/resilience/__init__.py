"""Fault handling for the serving path.

Counterpart of the JAX package's ``resilience/``, so far its retry policy
(:class:`RetryPolicy`, :func:`retry_call`) and circuit breaker
(:class:`CircuitBreaker`, :class:`CircuitOpenError`), which the
:class:`~tensordiffeq_tpu_torch.serving.RequestBatcher` takes as options.
Chaos injection, rollback recovery, preemption and the cluster supervisor
are not ported yet (ROADMAP queue 1 item 7 and item 6).
"""

from .breaker import (CLOSED, HALF_OPEN, OPEN,  # noqa: F401
                      CircuitBreaker, CircuitOpenError)
from .retry import RetryPolicy, retry_call  # noqa: F401
