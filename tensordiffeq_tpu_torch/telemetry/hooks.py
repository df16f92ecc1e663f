"""Training instrumentation: the callback protocol ``fit_adam``, the L-BFGS
leg and ``CollocationSolverND.fit`` thread their telemetry through.

Counterpart of the JAX package's ``telemetry/hooks.py``.
:class:`TrainingTelemetry` is the subscriber: pass one (or a bare
:class:`~tensordiffeq_tpu_torch.telemetry.RunLogger`) to
``solver.fit(telemetry=)`` and the run emits structured events — the run
config, per-epoch loss components with the gradient global-norm, SA-λ
summaries, the step-time split (host dispatch against the device wait, at
the one host read of the chunk's history), redraws, checkpoint writes — and
the NaN/Inf sentinel raises a structured :class:`TrainingDiverged`.

Everything here is host-side and runs at chunk boundaries: the captured
Adam step is the un-instrumented one, except for the gradient-norm scalar it
records when a subscriber asks for it (``grad_norm=True``; a different step,
and so a capture of its own).  The JAX package's tracing ties (spans, the
``trace_id`` of a divergence) wait for the port's tracing (ROADMAP queue 1
item 7): until then :attr:`TrainingDiverged.trace_id` is ``None``, what the
JAX package reports when no tracer is active.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..profiling import percentiles
from .costmodel import StepCostModel
from .registry import MetricsRegistry, default_registry
from .runlog import RunLogger


class TrainingDiverged(RuntimeError):
    """The NaN/Inf sentinel tripped: a loss component went non-finite.

    Carries ``phase`` ("adam" / "l-bfgs"), ``epoch`` (run-relative) and
    ``components`` (the loss dict at the trip), so callers can diagnose
    programmatically instead of parsing a message; ``trace_id`` stays
    ``None`` until the port has tracing.
    """

    trace_id: Optional[str] = None

    def __init__(self, phase: str, epoch: int, components: Optional[dict] = None):
        self.phase = phase
        self.epoch = int(epoch)
        self.components = dict(components or {})
        bad = sorted(k for k, v in self.components.items()
                     if isinstance(v, float) and not np.isfinite(v))
        super().__init__(
            f"training diverged: non-finite loss at {phase} epoch "
            f"{epoch} (non-finite: {', '.join(bad) or 'unknown'})")


def lambda_summaries(lambdas: dict) -> dict:
    """min/mean/max/p99 per λ term (``{"residual[0]": {...}, ...}``);
    scalar λ report a single ``value``.  One host copy per term — chunk
    cadence only.  Terms that cannot be read are skipped, not fatal."""
    out = {}
    for group, terms in (lambdas or {}).items():
        for i, lam in enumerate(terms):
            if lam is None:
                continue
            try:
                arr = np.asarray(lam.detach().cpu() if hasattr(lam, "detach")
                                 else lam, dtype=np.float64)
            except Exception:
                continue
            if arr.size == 0:
                continue
            name = f"{group}[{i}]"
            if arr.size == 1:
                out[name] = {"value": float(arr.reshape(-1)[0])}
            else:
                out[name] = {"min": float(arr.min()),
                             "mean": float(arr.mean()),
                             "max": float(arr.max()),
                             # single-sourced percentile semantics
                             # (profiling.py), same as every other p99
                             "p99": percentiles(arr.ravel(),
                                                qs=(99,))["p99"]}
    return out


def _nonfinite(row: dict) -> bool:
    return any(isinstance(v, float) and not np.isfinite(v)
               for v in row.values())


class TrainingTelemetry:
    """Subscriber threaded through the training loops.

    Args:
      logger: a :class:`RunLogger` receiving the structured events, or
        None for metrics-only instrumentation (step-time/divergence
        counters land in ``registry``, no JSONL).
      registry: metrics destination; defaults to the logger's registry,
        else the process default.
      log_every: per-epoch ``epoch`` event cadence (1 = every epoch,
        0 = none; chunk-boundary events are unaffected).
      raise_on_divergence: raise :class:`TrainingDiverged` when the Adam
        sentinel trips (the L-BFGS loop already stops itself on NaN and
        keeps its best iterate, so its trips only emit the event).
      grad_norm: record the gradient global-norm (the network's and the
        λ's gradients together, before any clipping) inside the Adam step,
        as ``"Grad_norm"`` in the history.  ``False`` keeps the captured
        step bit for bit the un-instrumented one — required when the run
        IS the measurement.
      cost_model: price the step through
        :mod:`~tensordiffeq_tpu_torch.telemetry.costmodel` (analytic,
        basis disclosed) — live ``cost.flops_per_step`` /
        ``cost.achieved_flops_per_s`` / ``cost.mfu`` gauges in the
        registry, updated every chunk; it never changes the step.
    """

    def __init__(self, logger: Optional[RunLogger] = None,
                 registry: Optional[MetricsRegistry] = None,
                 log_every: int = 1, raise_on_divergence: bool = True,
                 grad_norm: bool = True, cost_model: bool = True):
        self.logger = logger
        self.registry = registry if registry is not None else (
            logger.registry if logger is not None else default_registry())
        self.log_every = int(log_every)
        self.raise_on_divergence = bool(raise_on_divergence)
        self.grad_norm = bool(grad_norm)
        self.cost_model = bool(cost_model)
        # the solver sets this before fit_adam runs so the floor guard
        # (costmodel.analytic_step_floor) rides into on_step_program
        self.cost_floor: Optional[float] = None
        # optional (flops, basis_label) substituted for the missing measured
        # count — the solver sets the channel-exact "analytic-minimax"
        # count here for minimax-engine steps
        self.cost_fallback = None
        self._cost: Optional[StepCostModel] = None
        # run-relative rebasing across causal-ε stages / resumed legs:
        # the solver sets this so event epochs stay monotonic
        self.epoch_offset = 0

    # ------------------------------------------------------------------ #
    def event(self, kind: str, **fields):
        if self.logger is not None:
            self.logger.event(kind, **fields)

    def on_fit_start(self, config: dict):
        self.event("run_config", **config)

    def on_epoch_rows(self, phase: str, first_epoch: int, rows: list):
        """One chunk's per-epoch loss rows (``first_epoch`` = run-relative
        epoch of ``rows[0]``); emits ``epoch`` events strictly on the
        ``log_every`` cadence (epoch % log_every == 0) with the gradient
        global-norm split out of the loss components."""
        if self.log_every <= 0:
            return
        for i, row in enumerate(rows):
            epoch = first_epoch + i + self.epoch_offset
            if epoch % self.log_every:
                continue
            losses = {k: v for k, v in row.items() if k != "Grad_norm"}
            self.event("epoch", phase=phase, epoch=epoch, losses=losses,
                       grad_norm=row.get("Grad_norm"))

    def on_step_program(self, phase: str):
        """Price the phase's step (the JAX package's hook prices a lowered
        program; the port's steps have none, so the analytic basis set in
        ``cost_floor`` / ``cost_fallback`` prices them) and publish the
        per-step ``cost.flops_per_step`` gauge and a ``step_cost`` event."""
        if not self.cost_model:
            return
        self._cost = StepCostModel(registry=self.registry, phase=phase,
                                   floor=self.cost_floor,
                                   fallback=self.cost_fallback)
        cost = self._cost.observe_program()
        if cost["flops_per_step"] is not None:
            self.event("step_cost", phase=phase, **cost)

    def on_step_time(self, phase: str, n_steps: int, dispatch_s: float,
                     device_s: float, data_s: float = 0.0):
        """Chunk step-time split: host dispatch (issuing the chunk's graph
        replays or eager steps) vs device wait (the chunk's one host read
        of its history, which waits for the card) vs data prep (redraw
        dispatch and swap).  With a cost model primed
        (:meth:`on_step_program`), the live throughput gauges
        (``cost.achieved_flops_per_s``, ``cost.mfu``) update from the
        chunk's wall time."""
        n = max(int(n_steps), 1)
        scope = self.registry.scope(phase=phase)
        scope.histogram("step_time_dispatch_s").observe(dispatch_s / n)
        scope.histogram("step_time_device_s").observe(device_s / n)
        if data_s:
            scope.histogram("step_time_data_s").observe(data_s / n)
        self.event("step_time", phase=phase, n_steps=n_steps,
                   dispatch_s=dispatch_s, device_s=device_s, data_s=data_s)
        if self._cost is not None and self._cost.phase == phase:
            self._cost.observe_steps(n, dispatch_s + device_s)

    def note_resample_flops(self, flops: Optional[float]):
        """Credit a dispatched redraw's score-pass FLOPs to the chunk it
        will execute behind (see :meth:`StepCostModel.note_extra_flops`) —
        called at dispatch time, where the work lands on the device."""
        if self._cost is not None and flops:
            self._cost.note_extra_flops(flops)

    def on_resample(self, phase: str, epoch: int, stall_s: float,
                    stats: Optional[dict] = None, pipelined: bool = False,
                    dispatched_epoch: Optional[int] = None,
                    flops=(None, None)):
        """One adaptive-collocation redraw (chunk boundary).  ``stall_s``
        is the HOST-VISIBLE cost: the full synchronous call on the host
        path, dispatch + swap bookkeeping on the pipelined device path
        (pool scoring itself hides behind the intervening chunk).
        ``stats`` carries the device path's drift diagnostics
        (``kept_fraction`` / ``score_gain`` / ``lambda_drift``, plus
        ``ascent_steps`` on the PACMANN ascent arm);
        ``flops`` is the priced ``(flops, basis)`` of the score pass.
        Emits the ``resample.*`` instruments and a ``resample`` event."""
        epoch = int(epoch) + self.epoch_offset
        if dispatched_epoch is not None:
            # same frame as `epoch`: a consumer reading the dispatch-to-
            # swap gap must not see the restore/stage offset in one field
            # and not the other
            dispatched_epoch = int(dispatched_epoch) + self.epoch_offset
        self.registry.counter("resample.redraws").inc()
        self.registry.histogram("resample.stall_s").observe(float(stall_s))
        stats = dict(stats or {})
        if "kept_fraction" in stats:
            self.registry.gauge("resample.kept_fraction").set(
                stats["kept_fraction"])
        if "score_gain" in stats:
            self.registry.gauge("resample.score_gain").set(
                stats["score_gain"])
        if "lambda_drift" in stats:
            self.registry.gauge("resample.lambda_drift").set(
                stats["lambda_drift"])
        if "ascent_steps" in stats:
            # PACMANN ascent arm: K gradient steps each moved point took
            self.registry.gauge("resample.ascent_steps").set(
                stats["ascent_steps"])
        score_flops, basis = (flops if isinstance(flops, (tuple, list))
                              and len(flops) == 2 else (None, None))
        if score_flops is not None:
            self.registry.gauge("resample.score_flops").set(score_flops)
        self.event("resample", phase=phase, epoch=epoch,
                   stall_s=float(stall_s), pipelined=bool(pipelined),
                   dispatched_epoch=dispatched_epoch,
                   score_flops=score_flops, flops_basis=basis, **stats)

    def on_family_stats(self, epoch: int, losses, alive,
                        newly_frozen: int = 0,
                        converge_loss: Optional[float] = None,
                        pts_per_s: Optional[float] = None):
        """One surrogate-factory chunk's family summary (the JAX package's
        ``factory.SurrogateFactory``; the port's factory is still to come,
        ROADMAP queue 1 item 7, and will call this):
        per-member loss quantiles over the LIVE members, frozen /
        converged member gauges, and the aggregate family throughput —
        the ``factory.*`` instruments (docs/metrics.md).  ``losses`` and
        ``alive`` are the ``[M]`` per-member latest losses and alive
        mask; ``newly_frozen`` counts members the divergence mask froze
        this chunk; ``converge_loss`` arms the converged gauge."""
        losses = np.asarray(losses, np.float64)
        alive = np.asarray(alive, bool)
        m = int(losses.shape[0])
        reg = self.registry
        reg.gauge("factory.members").set(m)
        reg.gauge("factory.members_frozen").set(int((~alive).sum()))
        if newly_frozen:
            reg.counter("factory.divergences").inc(int(newly_frozen))
        live = losses[alive & np.isfinite(losses)]
        qs = {}
        if live.size:
            # single-sourced percentile semantics (profiling.py)
            qs = percentiles(live, qs=(10, 50, 90))
            for q, v in qs.items():
                reg.gauge("factory.loss_quantile", q=q).set(v)
        converged = None
        if converge_loss is not None:
            converged = int((live <= float(converge_loss)).sum())
            reg.gauge("factory.members_converged").set(converged)
        if pts_per_s is not None:
            reg.gauge("factory.pts_per_s").set(float(pts_per_s))
        self.event("family_stats", epoch=int(epoch), members=m,
                   frozen=int((~alive).sum()),
                   newly_frozen=int(newly_frozen), converged=converged,
                   loss_quantiles=qs,
                   pts_per_s=(None if pts_per_s is None
                              else float(pts_per_s)))

    def on_lambda_stats(self, epoch: int, lambdas: dict):
        stats = lambda_summaries(lambdas)
        if stats:
            self.event("lambda_stats", epoch=epoch + self.epoch_offset,
                       stats=stats)

    def on_checkpoint(self, phase: str, epoch: int):
        """``epoch`` is absolute (the solver rebases before calling — its
        checkpoint hooks already carry run-relative epochs)."""
        self.registry.counter("checkpoints").inc()
        self.event("checkpoint", phase=phase, epoch=epoch)

    def check_finite(self, phase: str, epoch: int, row: dict):
        """The NaN/Inf sentinel.  Emits a ``divergence`` event (and bumps
        the ``divergences`` counter) on a non-finite loss component;
        raises :class:`TrainingDiverged` per the constructor policy."""
        if not _nonfinite(row):
            return
        epoch = int(epoch) + self.epoch_offset
        components = {k: v for k, v in row.items()}
        self.registry.counter("divergences", phase=phase).inc()
        self.event("divergence", phase=phase, epoch=epoch,
                   components=components, level="error")
        if self.raise_on_divergence and phase == "adam":
            raise TrainingDiverged(phase, epoch, components)

    def check_rows(self, phase: str, first_epoch: int, rows: list):
        """Run the sentinel over a chunk's per-epoch rows, tripping at the
        FIRST non-finite epoch (the divergence point, not the chunk end)."""
        for j, row in enumerate(rows):
            if _nonfinite(row):
                self.check_finite(phase, first_epoch + j, row)
                return

    def on_lbfgs_history(self, history: list, start_iter: int = 0):
        """Post-phase L-BFGS telemetry: sampled per-iteration ``epoch``
        events plus the divergence event for a NaN stop (the loop already
        stopped and kept its best iterate — event only, no raise)."""
        rows = [{"Total Loss": float(v)} for v in history]
        if rows:
            self.on_epoch_rows("l-bfgs", start_iter, rows)
            if _nonfinite(rows[-1]):
                self.registry.counter("divergences", phase="l-bfgs").inc()
                self.event("divergence", phase="l-bfgs",
                           epoch=start_iter + len(rows) - 1
                           + self.epoch_offset,
                           components=rows[-1], level="error")

    def on_fit_end(self, summary: dict):
        """Close out the fit: wall times, best losses, and the CUDA device's
        memory peak (``profiling.device_memory_peak``) where there is
        one."""
        from ..profiling import device_memory_peak
        peak = device_memory_peak()
        if peak is not None:
            self.registry.gauge("device_memory_peak_bytes").set(peak)
        self.event("fit_end", memory_peak_bytes=peak, **summary)


def as_training_telemetry(telemetry) -> Optional[TrainingTelemetry]:
    """Normalise ``solver.fit(telemetry=)`` input: a
    :class:`TrainingTelemetry` passes through, a :class:`RunLogger` is
    wrapped with defaults, None stays None."""
    if telemetry is None or isinstance(telemetry, TrainingTelemetry):
        return telemetry
    if isinstance(telemetry, RunLogger):
        return TrainingTelemetry(logger=telemetry)
    raise TypeError(
        f"telemetry must be a TrainingTelemetry or RunLogger, got "
        f"{type(telemetry).__name__}")
