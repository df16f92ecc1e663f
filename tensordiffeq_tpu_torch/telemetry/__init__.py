"""Observability: the metrics registry, the run log, training telemetry.

Counterpart of the JAX package's ``telemetry/``:

* :class:`MetricsRegistry` (:mod:`.registry`) — counters, gauges and
  reservoir histograms with labeled scopes, :func:`default_registry`;
* :class:`RunLogger` + :func:`log_event` (:mod:`.runlog`) — the
  schema-versioned JSONL event sink with its run manifest, and the one
  narration path (quiet runs stay quiet; events land in the active sink
  either way);
* :class:`TrainingTelemetry` / :class:`TrainingDiverged` (:mod:`.hooks`) —
  the subscriber ``solver.fit(telemetry=)`` threads through Adam and
  L-BFGS: per-epoch loss rows with the gradient norm, SA-λ summaries, the
  step-time split at the one host read per chunk, redraw statistics and
  the NaN/Inf sentinel;
* :mod:`.costmodel` — the analytic FLOP/MFU accounting (``flops_basis``
  disclosed) with the H100's peaks.

Not ported yet (ROADMAP queue 1 item 7): tracing, SLOs, the collector, the
flight recorder and the report.
"""

from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, MetricsScope, default_registry)
from .runlog import (EVENTS_FILE, MANIFEST_FILE,  # noqa: F401
                     SCHEMA_VERSION, RunLogger, active_logger,
                     event_segments, log_event, read_events, read_manifest)
from . import costmodel  # noqa: F401
from .costmodel import StepCostModel  # noqa: F401
from .hooks import (TrainingDiverged, TrainingTelemetry,  # noqa: F401
                    as_training_telemetry, lambda_summaries)
