"""JSONL event sink + run manifest + the one leveled narration path.

Counterpart of the JAX package's ``telemetry/runlog.py``, with the same
files and record schema (so the same readers parse both packages' runs); the
manifest's environment block describes the PyTorch device instead of the
JAX backend.

A run directory holds two files:

* ``manifest.json`` — schema version, run id, creation time, the run
  config the caller registered, and the environment (backend, devices);
  finalized on :meth:`RunLogger.close` with the end time and a metrics
  snapshot from the attached registry.
* ``events.jsonl`` — append-only, one schema-versioned JSON record per
  line: ``{"v": 2, "t": <unix s>, "kind": "...", ...}``.  Appends are
  flushed per event, so a killed run keeps everything up to the kill.

:func:`log_event` is the single narration path the package routes its
former bare ``print()`` lines through: a message prints only when the
caller's ``verbose`` flag says so (quiet runs are actually quiet), but the
event is *always* appended to the active :class:`RunLogger` when one is
attached — machine-readable even when silent.  Warnings and errors print
to stderr, so a script's JSON-line stdout stays clean.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from typing import Any, Optional

import numpy as np

from .registry import MetricsRegistry, default_registry

# the JAX package's schema: v2 has the `trace` event kind (span records)
# and the `step_cost` event; readers do not filter on `v`
SCHEMA_VERSION = 2
EVENTS_FILE = "events.jsonl"
MANIFEST_FILE = "manifest.json"

# stack, not a single slot: nested runs (a solver fit inside a harness
# that keeps its own log) resolve to the innermost logger
_ACTIVE: list = []

# event taps: callables fed every record any RunLogger appends, AFTER the
# disk write (the JAX package's flight recorder rides this hook); taps
# must never raise into the logging path and are called best-effort.
_TAPS: list = []


def active_logger() -> Optional["RunLogger"]:
    """The innermost attached :class:`RunLogger`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _json_default(obj: Any):
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


# spec-valid JSON has no NaN/Infinity tokens; divergence records are exactly
# where they appear, and a strict consumer (jq, a dashboard ingester) must
# be able to parse exactly those lines — encode them as strings instead
NONFINITE_TOKENS = {"NaN", "Infinity", "-Infinity"}


def _sanitize(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        return "NaN" if math.isnan(v) else (
            "Infinity" if v > 0 else "-Infinity")
    if isinstance(v, np.ndarray):
        return _sanitize(v.tolist())
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


def log_event(kind: str, message: Optional[str] = None, *,
              level: str = "info", verbose: bool = True,
              prefix: bool = True, logger: Optional["RunLogger"] = None,
              **fields):
    """Narrate + record in one call.

    ``message`` prints as ``[kind] message`` iff ``verbose`` (callers pass
    their existing ``verbose`` flags through); ``level`` in
    ``("warning", "error")`` prints to stderr, everything else to stdout.
    ``prefix=False`` prints the message bare (banners).  Independently of
    printing, the event — kind, level, message, and any extra ``fields``
    — is appended to ``logger`` (default: the active run logger) when one
    exists, so a quiet run still leaves a machine-readable trail.
    """
    if verbose and message is not None:
        stream = sys.stderr if level in ("warning", "error") else sys.stdout
        print(f"[{kind}] {message}" if prefix else message,
              file=stream, flush=True)
    lg = logger if logger is not None else active_logger()
    if lg is not None:
        rec = dict(fields)
        if message is not None:
            rec["message"] = message
        if level != "info":
            rec["level"] = level
        lg.event(kind, **rec)


class RunLogger:
    """Schema-versioned JSONL event sink for one run.

    Usage::

        with telemetry.RunLogger("runs/ac_sa_0", config={...}) as run:
            solver.fit(tf_iter=10_000, telemetry=run)
        print(telemetry.report("runs/ac_sa_0"))

    As a context manager the logger also becomes the *active* sink for
    :func:`log_event`, so package narration ([fit]/[autotune]/[causal]
    lines) lands in ``events.jsonl`` alongside the structured training
    events.  ``registry`` defaults to the process-wide
    :func:`~tensordiffeq_tpu_torch.telemetry.default_registry` so serving
    metrics snapshot into the manifest on close.
    """

    def __init__(self, run_dir: str, config: Optional[dict] = None,
                 registry: Optional[MetricsRegistry] = None,
                 run_id: Optional[str] = None, clock=time.time,
                 rotate_bytes: Optional[int] = None):
        self.run_dir = str(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.registry = registry if registry is not None else default_registry()
        self._clock = clock
        self.run_id = run_id or f"run-{os.getpid()}-{int(clock() * 1e3):x}"
        self.n_events = 0
        self._closed = False
        # size-based rotation: when the live file crosses the cap it is
        # renamed to the next `events.jsonl.<n>` segment (``.1`` oldest)
        # and a fresh live file opened.  Rotated segments are final —
        # never renamed again — so a collector tailing by (segment,
        # offset) keeps valid offsets across rotations.
        self.rotate_bytes = int(rotate_bytes) if rotate_bytes else None
        self.n_rotations = 0
        self._manifest = {
            "schema_version": SCHEMA_VERSION,
            "run_id": self.run_id,
            "created": self._clock(),
            "config": dict(config or {}),
            "environment": self._environment(),
        }
        self._write_manifest()
        self._fh = open(os.path.join(self.run_dir, EVENTS_FILE), "a")

    @staticmethod
    def _environment() -> dict:
        try:
            import torch
            env = {"backend": "cuda" if torch.cuda.is_available() else "cpu",
                   "torch_version": torch.__version__}
            if torch.cuda.is_available():
                env.update(device_count=torch.cuda.device_count(),
                           device_kind=torch.cuda.get_device_name(0),
                           cuda_version=torch.version.cuda)
            else:
                env.update(device_count=1, device_kind="cpu")
            return env
        except Exception as e:  # never let env introspection kill a run
            return {"error": f"{type(e).__name__}: {e}"}

    def _write_manifest(self):
        path = os.path.join(self.run_dir, MANIFEST_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(_sanitize(self._manifest), fh, indent=1,
                      allow_nan=False, default=_json_default)
        os.replace(tmp, path)

    # ------------------------------------------------------------------ #
    def event(self, kind: str, **fields):
        """Append one schema-versioned record; flushed immediately so a
        killed process loses nothing already logged."""
        if self._closed:
            raise ValueError(f"RunLogger for {self.run_dir} is closed")
        rec = {"v": SCHEMA_VERSION, "t": round(self._clock(), 6),
               "kind": str(kind)}
        rec.update(fields)
        rec = _sanitize(rec)
        self._fh.write(json.dumps(rec, allow_nan=False,
                                  default=_json_default) + "\n")
        self._fh.flush()
        self.n_events += 1
        if self.rotate_bytes is not None \
                and self._fh.tell() >= self.rotate_bytes:
            self._rotate()
        if _TAPS:  # flight recorders ride every append, best-effort
            for tap in list(_TAPS):
                try:
                    tap(rec)
                except Exception:
                    pass

    def _rotate(self):
        """Seal the live file as the next ``events.jsonl.<n>`` segment
        and open a fresh one.  Suffixes only ever grow (``.1`` is the
        oldest), so sealed segments stay byte-stable for tailing
        readers."""
        self._fh.close()
        nxt = 1
        for p in event_segments(self.run_dir)[:-1]:
            suf = p.rsplit(".", 1)[-1]
            if suf.isdigit():
                nxt = max(nxt, int(suf) + 1)
        os.replace(os.path.join(self.run_dir, EVENTS_FILE),
                   os.path.join(self.run_dir, f"{EVENTS_FILE}.{nxt}"))
        self._fh = open(os.path.join(self.run_dir, EVENTS_FILE), "a")
        self.n_rotations += 1

    def close(self):
        """Finalize: flush the sink and rewrite the manifest with the end
        time, event count, and a metrics snapshot."""
        if self._closed:
            return
        self._closed = True
        self._fh.close()
        self._manifest["ended"] = self._clock()
        self._manifest["n_events"] = self.n_events
        if self.n_rotations:
            self._manifest["n_rotations"] = self.n_rotations
        try:
            self._manifest["metrics"] = self.registry.as_dict()
        except Exception:
            pass
        self._write_manifest()
        with contextlib.suppress(ValueError):
            _ACTIVE.remove(self)

    # ------------------------------------------------------------------ #
    def __enter__(self) -> "RunLogger":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_manifest(run_dir: str) -> dict:
    with open(os.path.join(run_dir, MANIFEST_FILE)) as fh:
        return json.load(fh)


def event_segments(run_dir: str) -> list:
    """The run's event files in append order: rotated segments
    (``events.jsonl.1`` oldest → highest suffix newest), then the live
    ``events.jsonl``.  Every multi-segment reader — :func:`read_events`,
    the collector's tails — iterates this."""
    run_dir = str(run_dir)
    base = os.path.join(run_dir, EVENTS_FILE)
    rotated = []
    try:
        names = os.listdir(run_dir)
    except OSError:
        names = []
    for n in names:
        if n.startswith(EVENTS_FILE + "."):
            suf = n[len(EVENTS_FILE) + 1:]
            if suf.isdigit():
                rotated.append((int(suf), os.path.join(run_dir, n)))
    segs = [p for _, p in sorted(rotated)]
    if os.path.exists(base):
        segs.append(base)
    return segs


def read_events(run_dir: str, kind: Optional[str] = None) -> list:
    """Parse the run's events back into dicts (optionally one ``kind``),
    reading seamlessly across rotated segments.  A truncated final line
    (process killed mid-write) is skipped per segment, not fatal."""
    out = []
    for path in event_segments(run_dir):
        try:
            fh = open(path)
        except OSError:
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if kind is None or rec.get("kind") == kind:
                    out.append(rec)
    return out
