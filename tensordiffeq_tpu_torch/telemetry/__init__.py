"""Observability: the metrics registry and the narration path.

Counterpart of the JAX package's ``telemetry/``, so far its registry
(:class:`MetricsRegistry`, reservoir histograms, :func:`default_registry`)
and :func:`log_event`.  The run logger, tracing, cost model, SLOs, the
collector and the flight recorder are not ported yet (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import sys
from typing import Optional

from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, MetricsScope, default_registry)


def log_event(kind: str, message: Optional[str] = None, *,
              level: str = "info", verbose: bool = True,
              prefix: bool = True, **fields):
    """Narrate one event.

    ``message`` prints as ``[kind] message`` iff ``verbose`` (callers pass
    their own ``verbose`` flags through); ``level`` in ``("warning",
    "error")`` prints to stderr, everything else to stdout.  ``prefix=False``
    prints the message bare.  ``fields`` are the event's structured record:
    the JAX package appends them to the active ``RunLogger``; the port has
    no run logger yet (ROADMAP queue 1 item 7), so they are dropped."""
    if verbose and message is not None:
        stream = sys.stderr if level in ("warning", "error") else sys.stdout
        print(f"[{kind}] {message}" if prefix else message,
              file=stream, flush=True)
