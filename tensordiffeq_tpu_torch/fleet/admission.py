"""Admission control: decide a request's fate BEFORE it queues.

Counterpart of the JAX package's ``fleet/admission.py``, host code only:
the same checks in the same order, the same decisions, reasons and
``retry_after_s`` for the same sequence of requests and clock readings.

A fleet under overload has exactly two choices: shed load at the front
door with a structured, retryable rejection, or let queues grow until
every tenant's latency collapses together.  This module is the front
door.  Checks run in a fixed order — per-tenant queue bound, fleet-wide
watermarks, then the token-bucket rate limit LAST (consuming a token is
a side effect: a request shed for any other reason must not also burn
rate budget) — and a request that
fails any of them raises :class:`AdmissionRejected` carrying the tenant,
a machine-readable reason, and a ``retry_after_s`` backpressure hint
(the same contract shape as the circuit breaker's
:class:`~tensordiffeq_tpu_torch.resilience.CircuitOpenError`).

Priority is the shedding ORDER, enforced at admission rather than by
re-ordering queues: under fleet-wide pressure low-priority (0) traffic is
shed first at ``shed_watermark``, normal traffic (1) at saturation, and
critical traffic (2) rides the reserved headroom above the watermark —
so by the time the fleet is full, what remains queued is already sorted
by priority without touching the batcher's FIFO coalescing.  Per-tenant
limits (rate, queue bound) apply to every priority: criticality does not
exempt a tenant from its own contract.

Everything is deterministic and clock-injectable; rejections land in the
shared registry (``fleet.admission.rejected{tenant=,reason=}``) and the
run log (``admission`` events), so :func:`tensordiffeq_tpu_torch.telemetry.report`
can narrate an overload window after the fact.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..telemetry import default_registry, log_event
from ..telemetry.tracing import active_tracer, attach_trace

#: priority levels: 0 = batch/background (shed first), 1 = interactive
#: (default), 2 = critical (rides the reserved headroom)
PRIORITIES = (0, 1, 2)


class AdmissionRejected(RuntimeError):
    """Structured front-door rejection.  ``reason`` is machine-readable:
    ``rate_limit`` (tenant over its QPS budget), ``tenant_queue_full``
    (tenant's own queue bound), ``load_shed`` (fleet past the shed
    watermark; priority 0 traffic), or ``fleet_saturated`` (fleet at
    capacity; priority <= 1 traffic).  ``retry_after_s`` is the
    backpressure hint (0 when retrying immediately might succeed, e.g.
    after other tenants drain).  ``trace_id`` is stamped when a
    :class:`~tensordiffeq_tpu_torch.telemetry.Tracer` is active — the id
    resolves the rejection's span in the run log."""

    trace_id = None

    def __init__(self, tenant: str, reason: str,
                 retry_after_s: float = 0.0, detail: str = ""):
        self.tenant = str(tenant)
        self.reason = str(reason)
        self.retry_after_s = max(0.0, float(retry_after_s))
        msg = (f"admission rejected for tenant {tenant!r}: {reason}"
               + (f" ({detail})" if detail else ""))
        if self.retry_after_s > 0:
            msg += f"; retry in {self.retry_after_s:.3f}s"
        super().__init__(msg)


class _TokenBucket:
    """Per-tenant request-rate limiter: ``rate`` tokens/s refill up to
    ``burst``; one admitted request costs one token."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def take(self, now: float) -> Optional[float]:
        """Consume one token; returns None on success, or the seconds
        until one becomes available."""
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 60.0


class AdmissionController:
    """Front-door policy for a :class:`~tensordiffeq_tpu_torch.fleet.FleetRouter`.

    Args:
      max_pending_points: fleet-wide pending-point capacity.  At or past
        it, only priority-2 traffic is admitted (``fleet_saturated``).
      shed_watermark: fraction of ``max_pending_points`` past which
        priority-0 traffic is shed (``load_shed``) — the early-warning
        band that keeps interactive traffic's queue short.
      clock: time source (injectable for tests).
      registry: metrics destination (default: the shared process
        registry; the router passes its own).

    Per-tenant knobs arrive via :meth:`configure` (the router forwards
    them from each tenant's :class:`~tensordiffeq_tpu_torch.fleet.TenantPolicy`):
    ``rate_qps``/``burst`` (token bucket; None = unlimited),
    ``max_queue_points`` (tenant queue bound; None = unbounded), and the
    tenant's default ``priority``.
    """

    def __init__(self, max_pending_points: int = 262_144,
                 shed_watermark: float = 0.75,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if not 0.0 < shed_watermark <= 1.0:
            raise ValueError(f"shed_watermark must be in (0, 1], "
                             f"got {shed_watermark}")
        self.max_pending_points = int(max_pending_points)
        self.shed_watermark = float(shed_watermark)
        self._clock = clock
        self._buckets: dict = {}
        self._limits: dict = {}
        self._nominal: Optional[tuple] = None  # set lazily by degrade()
        self._metrics = (registry if registry is not None
                         else default_registry())

    # ------------------------------------------------------------------ #
    def degrade(self, factor: float = 0.5) -> None:
        """Tighten the fleet-wide watermarks to ``factor`` of their
        NOMINAL values (graceful degradation below replica quorum: with
        half the group gone, half the queue capacity keeps per-request
        latency honest instead of letting survivors drown).  Relative to
        the nominal configuration, so repeated calls are idempotent and
        re-degrading at a different factor never compounds."""
        if not 0.0 < float(factor) <= 1.0:
            raise ValueError(f"factor must be in (0, 1], got {factor}")
        if self._nominal is None:
            self._nominal = (self.max_pending_points, self.shed_watermark)
        nom_cap, nom_shed = self._nominal
        self.max_pending_points = max(1, int(nom_cap * float(factor)))
        self.shed_watermark = nom_shed * float(factor)
        self._metrics.gauge("fleet.admission.degraded").set(1)
        log_event("admission", f"degraded watermarks to {factor:.0%} of "
                  f"nominal (capacity {self.max_pending_points}, shed at "
                  f"{self.shed_watermark:.0%})", level="warning",
                  verbose=False, factor=float(factor),
                  max_pending_points=self.max_pending_points)

    def restore(self) -> None:
        """Undo :meth:`degrade`: watermarks back to nominal (no-op when
        never degraded)."""
        if self._nominal is None:
            return
        self.max_pending_points, self.shed_watermark = self._nominal
        self._nominal = None
        self._metrics.gauge("fleet.admission.degraded").set(0)
        log_event("admission", "restored nominal watermarks (capacity "
                  f"{self.max_pending_points}, shed at "
                  f"{self.shed_watermark:.0%})", verbose=False,
                  max_pending_points=self.max_pending_points)

    # ------------------------------------------------------------------ #
    def configure(self, tenant: str, *, rate_qps: Optional[float] = None,
                  burst: Optional[float] = None,
                  max_queue_points: Optional[int] = None,
                  priority: int = 1) -> None:
        """Install (or replace) one tenant's limits."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority}")
        if rate_qps is not None and rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0 (got {rate_qps}); "
                             "use None for unlimited")
        if burst is not None and burst < 1.0:
            raise ValueError(
                f"burst must be >= 1 (got {burst}): a bucket that can "
                "never hold one whole token admits nothing, forever, "
                "while promising a retry_after_s that cannot come true")
        self._limits[tenant] = {
            "rate_qps": None if rate_qps is None else float(rate_qps),
            "max_queue_points": (None if max_queue_points is None
                                 else int(max_queue_points)),
            "priority": int(priority),
        }
        if rate_qps is not None:
            self._buckets[tenant] = _TokenBucket(
                rate_qps, burst if burst is not None
                else max(1.0, float(rate_qps)), self._clock())
        else:
            self._buckets.pop(tenant, None)

    def priority_for(self, tenant: str) -> int:
        return self._limits.get(tenant, {}).get("priority", 1)

    # ------------------------------------------------------------------ #
    def _reject(self, tenant: str, reason: str, retry_after_s: float,
                detail: str = ""):
        self._metrics.counter("fleet.admission.rejected", tenant=tenant,
                              reason=reason).inc()
        log_event("admission",
                  f"rejected tenant={tenant} reason={reason}"
                  + (f" ({detail})" if detail else ""),
                  level="warning", verbose=False, tenant=tenant,
                  reason=reason, retry_after_s=retry_after_s)
        raise attach_trace(
            AdmissionRejected(tenant, reason, retry_after_s, detail))

    def admit(self, tenant: str, n_points: int,
              priority: Optional[int] = None, *,
              tenant_pending: int = 0, fleet_pending: int = 0) -> None:
        """Gate one request of ``n_points`` rows.  Raises
        :class:`AdmissionRejected` or returns None (admitted); with a
        tracer active the decision is a ``fleet.admission`` span
        (``status=error`` on a shed, carrying the reason).  The
        router passes the live queue depths; standalone callers may
        pass their own."""
        tr = active_tracer()  # one probe when tracing is off
        if tr is None:
            return self._admit(tenant, n_points, priority,
                               tenant_pending=tenant_pending,
                               fleet_pending=fleet_pending)
        with tr.span("fleet.admission", tenant=str(tenant),
                     n=int(n_points)):
            return self._admit(tenant, n_points, priority,
                               tenant_pending=tenant_pending,
                               fleet_pending=fleet_pending)

    def _admit(self, tenant: str, n_points: int,
               priority: Optional[int] = None, *,
               tenant_pending: int = 0, fleet_pending: int = 0) -> None:
        if priority is None:
            priority = self.priority_for(tenant)
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority}")
        limits = self._limits.get(tenant, {})

        # 1. tenant queue bound
        mqp = limits.get("max_queue_points")
        if mqp is not None and tenant_pending + int(n_points) > mqp:
            self._reject(tenant, "tenant_queue_full", 0.0,
                         f"{tenant_pending} pending + {n_points} > {mqp}")

        # 2. fleet-wide watermarks: the priority-ordered shed
        if fleet_pending >= self.max_pending_points and priority < 2:
            self._reject(tenant, "fleet_saturated", 0.0,
                         f"{fleet_pending} >= {self.max_pending_points} "
                         "fleet pending points")
        if fleet_pending >= self.shed_watermark * self.max_pending_points \
                and priority < 1:
            self._reject(tenant, "load_shed", 0.0,
                         f"{fleet_pending} past the "
                         f"{self.shed_watermark:.0%} shed watermark")

        # 3. tenant rate limit LAST — consuming the token is a side
        #    effect, so a request shed for any other reason must not
        #    also burn rate budget (overload retries against a full
        #    queue would otherwise double-penalize the tenant).  It
        #    applies to every priority: criticality does not exempt a
        #    tenant from its own contract.
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            wait = bucket.take(self._clock())
            if wait is not None:
                self._reject(tenant, "rate_limit", wait,
                             f"{limits.get('rate_qps')} req/s budget")

        self._metrics.counter("fleet.admission.admitted",
                              tenant=tenant).inc()
