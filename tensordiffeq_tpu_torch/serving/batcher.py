"""Request coalescing: many small point queries -> one device batch.

Counterpart of the JAX package's ``serving/batcher.py``.  A serving front
end sees many tiny queries (single points, short rows of an adaptive
sampler), and running each on the card alone wastes it on launch overhead.
:class:`RequestBatcher` merges pending queries into one engine call under
the standard serving policy pair:

* **max_batch** — flush as soon as the pending point count reaches it
  (device-utilisation bound);
* **max_latency_s** — flush when the oldest pending request has waited this
  long (tail-latency bound; checked by :meth:`poll`, which hosts call from
  their event loop, or implicitly by a blocking :meth:`result`).

Failure handling (:mod:`tensordiffeq_tpu_torch.resilience`): a flush whose
op raises retries under an optional
:class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy` before failing
every coalesced waiter; an optional
:class:`~tensordiffeq_tpu_torch.resilience.CircuitBreaker` fast-fails NEW
submissions while the backend is down; and every request carries a
deadline (``request_timeout_s``) — a waiter whose batch never executes
raises a structured :class:`RequestTimeout` and is counted ``timed_out``,
never blocks forever.

Per-request latency (submit -> result ready) and throughput are recorded
and summarised through :func:`tensordiffeq_tpu_torch.profiling.percentiles`
and :func:`~tensordiffeq_tpu_torch.profiling.stopwatch`: :meth:`stats`
gives QPS and p50/p90/p99.

Not ported yet (ROADMAP queue 1 item 7): the chaos hook on the op and the
tracing spans (enqueue, flush, timeout) and trace ids.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..profiling import percentiles, stopwatch
from ..resilience.breaker import CircuitOpenError
from ..telemetry import default_registry, log_event


class RequestTimeout(RuntimeError):
    """A request's deadline expired before its batch executed.  Carries
    ``waited_s`` — how long the request sat in the queue."""

    def __init__(self, waited_s: float):
        self.waited_s = float(waited_s)
        super().__init__(
            f"request timed out after {waited_s:.3f}s without its batch "
            "executing (backend down or circuit breaker open)")


class PendingQuery:
    """Handle returned by :meth:`RequestBatcher.submit`."""

    __slots__ = ("_batcher", "_value", "_error", "_done", "_t_submit")

    def __init__(self, batcher, t_submit: float):
        self._batcher = batcher
        self._value = None
        self._error = None
        self._done = False
        self._t_submit = t_submit

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        """The query's rows of the merged batch result.  If the batch has
        not flushed yet, forces a flush (a caller blocking on a result is
        the latency deadline in person).  A batch whose op raised delivers
        that exception to EVERY waiter, not just whoever triggered the
        flush.  When the batch CANNOT execute (circuit breaker open), the
        call waits — bounded by the batcher's ``request_timeout_s`` — and
        raises :class:`RequestTimeout` once this request's deadline
        expires: no caller ever blocks forever on a dead worker."""
        while not self._done:
            try:
                self._batcher.flush()
            except Exception:
                # flush() re-raises to its caller AFTER delivering the
                # failure to every handle — ours included; fall through to
                # raise our own copy below
                pass
            if self._done:
                break
            # flush could not run the batch (breaker open): wait out the
            # cool-down in small ticks, bounded by this request's deadline
            self._batcher._wait_or_expire(self)
        if self._error is not None:
            raise self._error
        return self._value

    def _set(self, value):
        self._value = value
        self._done = True

    def _fail(self, exc: Exception):
        self._error = exc
        self._done = True


class RequestBatcher:
    """Coalesce point queries into device batches under a max-batch /
    max-latency policy.

    Args:
      engine: an :class:`~tensordiffeq_tpu_torch.serving.InferenceEngine`; the
        default op is ``engine.u``.
      op: override the batched op (e.g. ``engine.residual`` or a
        ``lambda X: engine.derivative(X, "x")``) — anything mapping
        ``[N, ndim] -> [N, ...]`` rows (or a tuple of such, for
        multi-equation residuals).
      max_batch: flush when this many points are pending.
      max_latency_s: flush when the oldest pending request is this old.
      retry: optional :class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy` —
        a failed op is retried on the SAME coalesced batch (backoff +
        deterministic jitter) before the failure reaches any waiter.
      breaker: optional
        :class:`~tensordiffeq_tpu_torch.resilience.CircuitBreaker` — records
        every op outcome; while open, :meth:`submit` fast-fails new
        requests with :class:`CircuitOpenError` and queued requests wait
        (bounded by their deadline) for the half-open probe.
      request_timeout_s: per-request deadline.  A request still pending
        this long after submit — its batch never executed — fails with
        :class:`RequestTimeout` and counts ``timed_out``.  ``None``
        disables (then a dead backend with no breaker can block a
        ``result()`` caller indefinitely — serve with a deadline).
      clock: time source (injectable for tests); defaults to
        ``time.monotonic``.
      sleep: blocking-wait primitive used by :meth:`PendingQuery.result`
        while the breaker is open (injectable for tests).
      registry: :class:`~tensordiffeq_tpu_torch.telemetry.MetricsRegistry`
        receiving the batcher's health metrics — live queue depth
        (``serving.batcher.queue_depth`` gauge), request/batch/point/
        failure/retry/timeout counters, the coalesced-batch-size histogram
        and the per-request latency histogram
        (``serving.batcher.latency_s``).  Defaults to the process-wide
        shared registry; :meth:`stats` keeps its original dict contract
        independently.
    """

    def __init__(self, engine=None, op: Optional[Callable] = None,
                 max_batch: int = 4096, max_latency_s: float = 0.01,
                 retry=None, breaker=None,
                 request_timeout_s: Optional[float] = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        if op is None:
            if engine is None:
                raise ValueError("pass an engine or an explicit op")
            op = engine.u
        self._op = op
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.retry = retry
        self.breaker = breaker
        self.request_timeout_s = (None if request_timeout_s is None
                                  else float(request_timeout_s))
        self._clock = clock
        self._sleep = sleep
        self._pending: list = []   # (X, handle, t_submit)
        self._pending_pts = 0
        self._first_submit: Optional[float] = None
        self._latencies: list = []
        self._batch_walls: list = []
        self._n_requests = 0
        self._n_batches = 0
        self._n_points = 0
        self._n_failed = 0
        self._n_timed_out = 0
        self._n_rejected = 0
        self._n_retried_ok = 0
        self._last_flush: Optional[float] = None
        self._metrics = registry if registry is not None else default_registry()

    # ------------------------------------------------------------------ #
    @property
    def pending_points(self) -> int:
        return self._pending_pts

    def submit(self, X) -> PendingQuery:
        """Queue a ``[n, ndim]`` (or single-point ``[ndim]``) query; returns
        a :class:`PendingQuery`.  Flushes inline when the pending point
        count reaches ``max_batch``.  While the circuit breaker is open the
        handle comes back already failed with
        :class:`~tensordiffeq_tpu_torch.resilience.CircuitOpenError` — fast
        structured rejection instead of queue pileup."""
        X = np.atleast_2d(np.asarray(X, np.float32))
        now = self._clock()
        handle = PendingQuery(self, now)
        self._n_requests += 1
        if self.breaker is not None and self.breaker.state == "open" \
                and self.breaker.retry_after_s() > 0.0:
            self._n_rejected += 1
            self._metrics.counter("serving.batcher.rejected").inc()
            handle._fail(CircuitOpenError(self.breaker.name,
                                          self.breaker.retry_after_s()))
            return handle
        if self._first_submit is None:
            self._first_submit = now
        self._pending.append((X, handle, now))
        self._pending_pts += X.shape[0]
        self._metrics.gauge("serving.batcher.queue_depth").set(
            self._pending_pts)
        if self._pending_pts >= self.max_batch:
            self.flush()
        return handle

    def poll(self) -> bool:
        """Flush iff the oldest pending request has exceeded the latency
        deadline (also sweeps out requests past their hard
        ``request_timeout_s``).  Returns whether a flush happened."""
        self._expire_overdue()
        if self._pending and \
                self._clock() - self._pending[0][2] >= self.max_latency_s:
            self.flush()
            return True
        return False

    # ------------------------------------------------------------------ #
    def _expire_overdue(self) -> int:
        """Fail every pending request past its hard deadline with a
        structured :class:`RequestTimeout`.  Only reachable in practice
        while the batch cannot execute (breaker open / callers not
        flushing): a live backend flushes at ``max_latency_s``, orders of
        magnitude sooner."""
        if self.request_timeout_s is None or not self._pending:
            return 0
        now = self._clock()
        keep, expired = [], []
        for item in self._pending:
            (expired if now - item[2] >= self.request_timeout_s
             else keep).append(item)
        if expired:
            self._pending = keep
            self._pending_pts = sum(x.shape[0] for x, _, _ in keep)
            self._metrics.gauge("serving.batcher.queue_depth").set(
                self._pending_pts)
            for x, handle, t in expired:
                handle._fail(RequestTimeout(now - t))
            self._n_timed_out += len(expired)
            self._metrics.counter("serving.batcher.timed_out").inc(
                len(expired))
            log_event("serving", f"{len(expired)} coalesced request(s) "
                      "timed out waiting for a batch that never executed",
                      level="warning", verbose=False, timed_out=len(expired))
        return len(expired)

    def _wait_or_expire(self, handle: PendingQuery) -> None:
        """One blocking-wait tick for :meth:`PendingQuery.result` while the
        breaker is open: expire the handle if its deadline passed,
        otherwise sleep until the breaker's cool-down or the deadline,
        whichever is sooner."""
        self._expire_overdue()
        if handle._done:
            return
        waits = [0.05]
        if self.breaker is not None:
            waits.append(max(self.breaker.retry_after_s(), 0.001))
        if self.request_timeout_s is not None:
            remaining = (handle._t_submit + self.request_timeout_s
                         - self._clock())
            if remaining <= 0.0:
                # deadline passed between the expiry sweep and now
                self._pending = [it for it in self._pending
                                 if it[1] is not handle]
                self._pending_pts = sum(x.shape[0]
                                        for x, _, _ in self._pending)
                self._n_timed_out += 1
                self._metrics.counter("serving.batcher.timed_out").inc()
                handle._fail(RequestTimeout(
                    self._clock() - handle._t_submit))
                return
            waits.append(remaining)
        self._sleep(max(min(waits), 0.001))

    def _run_op(self, X):
        """One op execution with retry policy and breaker accounting."""
        attempt = 0
        while True:
            attempt += 1
            try:
                out = self._op(X)
            except Exception as e:
                if self.breaker is not None:
                    self.breaker.record_failure()
                retriable = (self.retry is not None
                             and attempt < self.retry.max_attempts
                             and self.retry.retryable(e)
                             and (self.breaker is None
                                  or self.breaker.allow()))
                if not retriable:
                    if self.retry is not None:
                        self._metrics.counter(
                            "serving.batcher.retry_exhausted").inc()
                    raise
                delay = self.retry.delay_s(attempt)
                self._metrics.counter("serving.batcher.retries").inc()
                log_event("retry", f"serving op attempt {attempt}/"
                          f"{self.retry.max_attempts} failed "
                          f"({type(e).__name__}: {e}); retrying in "
                          f"{delay:.3f}s", level="warning", verbose=False,
                          op="batcher", attempt=attempt, delay_s=delay,
                          error=f"{type(e).__name__}: {e}")
                self._sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            if attempt > 1:
                self._n_retried_ok += 1
                self._metrics.counter("serving.batcher.retried_ok").inc()
            return out

    def fail_pending(self, exc: Exception) -> int:
        """Fail-and-clear every still-pending request with ``exc``
        (counted ``failed``).  A caller about to drop the engine calls
        this (the JAX package's fleet router does, at eviction): a batch
        that cannot execute right now (breaker open, cool-down running)
        must not strand its waiters behind that engine — they get a
        structured failure at once instead of waiting out their
        deadline."""
        batch, self._pending = self._pending, []
        self._pending_pts = 0
        self._metrics.gauge("serving.batcher.queue_depth").set(0)
        for _x, handle, _t in batch:
            handle._fail(exc)
        if batch:
            self._n_failed += len(batch)
            self._metrics.counter("serving.batcher.failed").inc(len(batch))
        return len(batch)

    def flush(self) -> int:
        """Evaluate every pending query as one merged device batch and
        deliver results to the handles.  Returns the number of requests
        served.  While the circuit breaker is open (cool-down not yet
        elapsed) the batch is NOT executed: pending requests stay queued
        for the half-open probe, minus any past their hard deadline."""
        if not self._pending:
            # ordering matters: an empty flush must not consult the breaker
            # — allow() on a cooled-down open circuit consumes the single
            # half-open probe slot, and with no op outcome to record the
            # breaker would wedge half-open forever
            return 0
        if self.breaker is not None and not self.breaker.allow():
            self._expire_overdue()
            return 0
        batch, self._pending = self._pending, []
        self._pending_pts = 0
        self._metrics.gauge("serving.batcher.queue_depth").set(0)
        X = np.concatenate([x for x, _, _ in batch]) if len(batch) > 1 \
            else batch[0][0]
        try:
            with stopwatch(verbose=False) as sw:
                out = self._run_op(X)
        except Exception as e:
            # the queue is already cleared: deliver the failure to every
            # coalesced waiter (their result() re-raises it) instead of
            # dropping them with a silent None
            for _, handle, _ in batch:
                handle._fail(e)
            self._n_failed += len(batch)
            self._metrics.counter("serving.batcher.failed").inc(len(batch))
            raise
        done = self._clock()
        lat_hist = self._metrics.histogram("serving.batcher.latency_s")
        offset = 0
        for x, handle, t_submit in batch:
            n = x.shape[0]
            if isinstance(out, tuple):
                handle._set(tuple(o[offset:offset + n] for o in out))
            else:
                handle._set(out[offset:offset + n])
            offset += n
            self._latencies.append(done - t_submit)
            lat_hist.observe(done - t_submit)
        self._batch_walls.append(sw["elapsed_s"])
        self._n_batches += 1
        self._n_points += X.shape[0]
        self._metrics.counter("serving.batcher.requests").inc(len(batch))
        self._metrics.counter("serving.batcher.batches").inc()
        self._metrics.counter("serving.batcher.points").inc(int(X.shape[0]))
        self._metrics.histogram("serving.batcher.batch_size").observe(
            X.shape[0])
        self._last_flush = done
        return len(batch)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Serving metrics over everything flushed so far: request/batch/
        point counts, failure/timeout/rejection/retry tallies, QPS over the
        observed span, mean device-batch wall, and per-request latency
        percentiles (seconds)."""
        span = None
        if self._last_flush is not None and self._first_submit is not None:
            span = self._last_flush - self._first_submit
        served = (self._n_requests - len(self._pending) - self._n_failed
                  - self._n_timed_out - self._n_rejected)
        return {
            "requests": served,
            "failed": self._n_failed,
            "timed_out": self._n_timed_out,
            "rejected": self._n_rejected,
            "retried_ok": self._n_retried_ok,
            "batches": self._n_batches,
            "points": self._n_points,
            "qps": None if not span else served / span,
            "batch_wall_mean_s": (float(np.mean(self._batch_walls))
                                  if self._batch_walls else None),
            "latency_s": percentiles(self._latencies),
        }

    def snapshot(self) -> dict:
        """One CONSISTENT observation of this batcher: ``pending_points``
        and the :meth:`stats` dict captured together.  :meth:`stats` reads
        each counter attribute separately, so a flush on another thread
        can land between reads and tear the derived ``requests`` number
        (the router's old two-pass scrape could even report more pending
        points than requests).  Here every field is copied into locals
        first — each copy is atomic under the GIL — and the derived
        values are computed from those copies only, so the result is
        internally consistent even against a concurrent flush."""
        pending = tuple(self._pending)
        n_requests = self._n_requests
        n_failed = self._n_failed
        n_timed_out = self._n_timed_out
        n_rejected = self._n_rejected
        n_retried_ok = self._n_retried_ok
        n_batches = self._n_batches
        n_points = self._n_points
        first = self._first_submit
        last = self._last_flush
        walls = tuple(self._batch_walls)
        lats = tuple(self._latencies)
        span = None
        if last is not None and first is not None:
            span = last - first
        served = max(0, n_requests - len(pending) - n_failed
                     - n_timed_out - n_rejected)
        return {
            "pending_points": sum(x.shape[0] for x, _, _ in pending),
            "stats": {
                "requests": served,
                "failed": n_failed,
                "timed_out": n_timed_out,
                "rejected": n_rejected,
                "retried_ok": n_retried_ok,
                "batches": n_batches,
                "points": n_points,
                "qps": None if not span else served / span,
                "batch_wall_mean_s": (float(np.mean(walls))
                                      if walls else None),
                "latency_s": percentiles(lats),
            },
        }
