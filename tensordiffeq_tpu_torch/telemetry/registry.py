"""Process-local metrics: counters, gauges, streaming histograms.

Counterpart of the JAX package's ``telemetry/registry.py``: cheap host-side
instruments that the serving engine and batcher update as they run,
exported as one plain dict (:meth:`MetricsRegistry.as_dict`).

Histograms are **streaming**: exact count/sum/min/max plus a fixed-size
uniform reservoir (Vitter's algorithm R, deterministically seeded) so a
million observations cost a few KB and percentiles stay answerable at any
point.  The summary goes through
:func:`tensordiffeq_tpu_torch.profiling.percentiles` (linear interpolation,
``None`` on empty).

Instruments are identified by ``name`` plus optional string-able labels::

    reg = MetricsRegistry()
    reg.counter("compiles", kind="u", bucket=256).inc()
    reg.histogram("latency_s").observe(0.004)
    reg.scope(phase="adam").gauge("lr").set(5e-3)   # labeled view
    reg.as_dict()["counters"]["compiles{bucket=256,kind=u}"]  # -> 1

A module-level default registry (:func:`default_registry`) is what the
serving layer shares when no explicit registry is passed — one process, one
scoreboard.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..profiling import percentiles


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        if n < 0:
            raise ValueError(f"counters only go up (inc({n}))")
        self.value += n
        return self


class Gauge:
    """Last-observed value (queue depth, learning rate, bytes in use)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = float(v)
        return self


class Histogram:
    """Streaming distribution: exact count/sum/min/max + uniform reservoir.

    Reservoir sampling keeps an unbiased fixed-size sample of everything
    ever observed (algorithm R), so percentiles over a long run cost
    ``reservoir`` floats of memory instead of the full sample list.  The
    RNG is seeded per-instrument, so two runs observing the same stream
    summarise identically.
    """

    __slots__ = ("_cap", "_rs", "_sample", "count", "sum", "min", "max")

    def __init__(self, reservoir: int = 2048, seed: int = 0):
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self._cap = int(reservoir)
        self._rs = np.random.RandomState(seed)
        self._sample: list = []
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, x):
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        if len(self._sample) < self._cap:
            self._sample.append(x)
        else:
            j = int(self._rs.randint(0, self.count))
            if j < self._cap:
                self._sample[j] = x
        return self

    def observe_many(self, xs):
        for x in np.asarray(xs, dtype=np.float64).ravel():
            self.observe(x)
        return self

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentiles(self, qs=(50, 90, 99)) -> dict:
        """Reservoir percentiles through the single-sourced
        :func:`tensordiffeq_tpu_torch.profiling.percentiles`."""
        return percentiles(self._sample, qs)

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.sum, "mean": self.mean,
               "min": self.min, "max": self.max}
        out.update(self.percentiles())
        return out


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Named, labeled instruments with get-or-create semantics.

    Thread-safe at the instrument-lookup level (the serving batcher may be
    polled from an event loop while a submit runs elsewhere); individual
    updates are plain attribute writes, which is all the host-side hot
    paths can afford.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    def _get(self, table: dict, name: str, labels: dict, make):
        key = _key(name, labels)
        with self._lock:
            inst = table.get(key)
            if inst is None:
                inst = table[key] = make()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name, labels, Gauge)

    def histogram(self, name: str, reservoir: int = 2048,
                  **labels) -> Histogram:
        return self._get(self._hists, name, labels,
                         lambda: Histogram(reservoir=reservoir))

    def scope(self, **labels) -> "MetricsScope":
        """A view that stamps these labels on every instrument it touches
        (nested scopes merge; inner wins on conflict)."""
        return MetricsScope(self, labels)

    def as_dict(self) -> dict:
        """Plain-dict export: counters/gauges as values, histograms as
        summaries — JSON-ready (drops into bench payloads and run
        manifests as-is)."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()},
            }

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


class MetricsScope:
    """Labeled view over a :class:`MetricsRegistry` (see
    :meth:`MetricsRegistry.scope`)."""

    def __init__(self, registry: MetricsRegistry, labels: dict):
        self._registry = registry
        self._labels = dict(labels)

    def _merged(self, labels: dict) -> dict:
        return {**self._labels, **labels}

    def counter(self, name: str, **labels) -> Counter:
        return self._registry.counter(name, **self._merged(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._registry.gauge(name, **self._merged(labels))

    def histogram(self, name: str, reservoir: int = 2048,
                  **labels) -> Histogram:
        return self._registry.histogram(name, reservoir=reservoir,
                                        **self._merged(labels))

    def scope(self, **labels) -> "MetricsScope":
        return MetricsScope(self._registry, self._merged(labels))


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide shared registry (the serving engine's and
    batcher's default)."""
    return _DEFAULT
