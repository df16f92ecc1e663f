"""Timing helpers: a device-synchronised stopwatch and latency percentiles.

Counterpart of the JAX package's ``profiling.py`` (``stopwatch``,
``percentiles``).  An asynchronous CUDA launch returns before the card
finishes, so a host clock around it measures the enqueue; ``stopwatch(sync=
...)`` synchronises the device before it stops the clock.

Not ported yet (ROADMAP queue 1 item 7, telemetry): the profiler trace,
named annotations, ``timeit`` and the device-memory helpers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import numpy as np
import torch


@contextlib.contextmanager
def stopwatch(label: str = "", sync: Optional[Any] = None,
              verbose: bool = True):
    """Context timer.  ``sync=`` a device (``"cuda"``, a ``torch.device``)
    or a tensor on one: on a CUDA device the clock stops after
    ``torch.cuda.synchronize`` of that device.  Yields a dict whose
    ``"elapsed_s"`` is filled on exit."""
    out: dict[str, Any] = {"label": label, "elapsed_s": None}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if sync is not None:
            dev = (sync.device if isinstance(sync, torch.Tensor)
                   else torch.device(sync))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        out["elapsed_s"] = time.perf_counter() - t0
        if label:
            # telemetry imports percentiles from here at module level
            from .telemetry import log_event
            log_event("profile", f"{label}: {out['elapsed_s']:.3f}s",
                      verbose=verbose, elapsed_s=out["elapsed_s"])


def percentiles(samples, qs=(50, 90, 99)) -> dict[str, Optional[float]]:
    """``{"p50": ..., "p90": ..., "p99": ...}`` of a sample list (seconds):
    linear interpolation, ``None`` for an empty window.  The batcher and the
    registry's histograms report through this one definition."""
    if not len(samples):
        return {f"p{int(q)}": None for q in qs}
    arr = np.asarray(samples, dtype=np.float64)
    return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}
