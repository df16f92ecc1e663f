"""Profiling and timing helpers: the profiler trace, a device-synchronised
stopwatch, latency percentiles and the device's memory peak.

Counterpart of the JAX package's ``profiling.py`` (``trace``,
``stopwatch``, ``percentiles``, ``device_memory_peak``).  Its ``trace``
captures an XLA profile; here :func:`trace` runs ``torch.profiler`` with CUDA
activity (kernels, graph replays and copies on the card, through CUPTI) and
writes a Chrome trace (``chrome://tracing``, Perfetto).  An asynchronous
CUDA launch returns before the card finishes, so a host clock around it
measures the enqueue; ``stopwatch(sync=...)`` synchronises the device
before it stops the clock.

Not ported yet (ROADMAP queue 1 item 7, telemetry): named annotations and
``timeit``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write a Chrome trace
    into ``log_dir`` (created) as ``trace.<pid>.<ms>.json``: CPU activity
    and, with a card, CUDA activity (each kernel a record by its name).
    Usage::

        with tdqt.profiling.trace("/tmp/prof"):
            solver.fit(tf_iter=1000)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json"))


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


def device_memory_peak() -> Optional[int]:
    """The CUDA device's peak allocated bytes since the process started (or
    since ``torch.cuda.reset_peak_memory_stats``), or ``None`` without a
    card.  The one definition the telemetry ``fit_end`` event quotes."""
    try:
        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.max_memory_allocated())
    except Exception:
        return None
