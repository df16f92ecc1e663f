"""The closed loop: drift-triggered factory retraining with zero-downtime
hot-swap (train → serve → monitor → retrain, autonomous).

Counterpart of the JAX package's ``fleet/closedloop.py``.  On the card the
retrain is the port's :class:`~tensordiffeq_tpu_torch.factory.
SurrogateFactory`: K3 once per member per family step, K1 once per member
per pool redraw and K3 six times per member per ascent redraw.

Every prior fleet layer composes under a human operator; this module is
the operator.  Three pieces close the loop:

* :class:`DriftMonitor` — shadow-samples a configurable fraction of live
  ``u`` queries through the engine's EXISTING ``residual`` kind (one
  extra batched query on rungs captured at load: no new graphs) and
  writes a
  per-tenant ``fleet.drift.level`` gauge: the windowed probe residual
  over the tenant's own attach-time baseline.  The gauge feeds the
  ``residual_drift`` objective of
  :class:`~tensordiffeq_tpu_torch.telemetry.SLOSet` (``max_residual_drift``
  threshold; burn rate over the window; ``ok=None`` when nothing is
  monitored — absence of traffic is not a breach).  Monitoring is
  residual-as-supervision: the drift signal IS the self-supervision
  quantity the trainers optimize (arXiv:2207.04084), measured on the
  traffic the tenant actually serves.
* :class:`RetrainController` — when the monitor trips, retrains the
  drifting θ neighborhood as one
  :class:`~tensordiffeq_tpu_torch.factory.SurrogateFactory` family
  **warm-started from the live members' served params**
  (``init_params=``) with drift-weighted collocation: the
  :class:`~tensordiffeq_tpu_torch.ops.resampling.FamilyResampler` redraws each
  member's points by residual importance, concentrating the retrain
  exactly where the served residual (the drift) is largest — the
  importance-sampling rationale of arXiv:2104.12325.  The retrain runs
  under a supervisor loop in the
  :class:`~tensordiffeq_tpu_torch.resilience.ClusterSupervisor` mold: a killed
  trainer (chaos ``retrain_kill_at``, or any organic
  :class:`~tensordiffeq_tpu_torch.resilience.ChaosFault`-shaped death) is
  relaunched as a new generation with
  :class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy` backoff between
  launch attempts, resuming from the family's in-memory state exactly
  as the elastic supervisor resumes from the last checkpoint.
* :meth:`FleetRouter.hot_swap <tensordiffeq_tpu_torch.fleet.FleetRouter.hot_swap>`
  — the v2 member artifact is loaded and warm-driven BESIDE the live
  tenant, canary-validated against the monitor's pinned probe set
  (replayed on old vs new engines), and only then does the route flip
  atomically: pending batches flushed, zero request-time captures, zero
  dropped or hung waiters.  A candidate that fails its gate — or fails
  the artifact checksum (chaos ``swap_corrupt_member``) — is rejected
  and the old engine keeps serving, bit-validated (the probe replay
  after rollback is byte-compared against the pre-swap snapshot).

With no chaos active the monitored serve path is bit-identical to a
plain :class:`~tensordiffeq_tpu_torch.fleet.FleetRouter` serve — the shadow
probe is a read-only residual query beside the ``u`` path
(``tests/test_torch_closedloop.py`` pins this).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..resilience.chaos import ChaosFault, active_chaos
from ..resilience.retry import RetryPolicy
from ..telemetry import default_registry, log_event
from ..telemetry.slo import SLOSet
from ..telemetry.tracing import active_tracer, propagate_trace


class DriftMonitor:
    """Shadow-probe live traffic and turn served residual into an SLO.

    Args:
      router: the :class:`~tensordiffeq_tpu_torch.fleet.FleetRouter` whose
        tenants are monitored.
      sample_fraction: fraction of observed ``u`` queries that get a
        shadow residual probe (seeded RNG — deterministic given the
        query sequence).  1.0 probes every query; 0.0 disables sampling
        (explicit :meth:`probe` calls still work).
      window: probes per tenant the drift level averages over (a burn
        window, not a single noisy probe).
      seed: sampling RNG seed.
      slo: the :class:`~tensordiffeq_tpu_torch.telemetry.SLOSet` whose
        ``max_residual_drift`` threshold defines a trip (default: the
        standard set).
      registry: metrics destination (default: the shared process
        registry) — ``fleet.drift.*`` instruments land here, which is
        where :meth:`SLOSet.evaluate` reads the gauge back.
    """

    def __init__(self, router, *, sample_fraction: float = 0.25,
                 window: int = 4, seed: int = 0,
                 slo: Optional[SLOSet] = None, registry=None,
                 verbose: bool = False):
        if not 0.0 <= float(sample_fraction) <= 1.0:
            raise ValueError("sample_fraction must be in [0, 1], got "
                             f"{sample_fraction}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.router = router
        self.sample_fraction = float(sample_fraction)
        self.window = int(window)
        self.slo = slo if slo is not None else SLOSet.default()
        self.verbose = bool(verbose)
        self._registry = (registry if registry is not None
                          else default_registry())
        self._rng = np.random.RandomState(int(seed))
        self._baseline: dict = {}     # tenant -> attach-time mean |residual|
        self._probe_X: dict = {}      # tenant -> pinned probe set
        self._levels: dict = {}       # tenant -> deque of probe ratios
        self._tripped: dict = {}      # tenant -> sticky trip flag

    # ------------------------------------------------------------------ #
    def attach(self, tenant: str, probe_X) -> float:
        """Start monitoring ``tenant``: pin ``probe_X`` (the canary
        replay set) and record the attach-time baseline — one batched
        residual query through the live engine.  Returns the baseline
        mean absolute residual (the denominator of every later drift
        level)."""
        X = np.atleast_2d(np.asarray(probe_X, np.float32))
        lt = self.router.load(tenant)
        baseline = float(np.mean(np.abs(np.asarray(
            lt.engine.residual(X)))))
        if baseline <= 0.0:
            # an exactly-zero residual (untrained-net corner) cannot
            # serve as a ratio denominator; floor it so drift stays
            # finite instead of dividing by zero
            baseline = np.finfo(np.float32).tiny
        self._baseline[tenant] = baseline
        self._probe_X[tenant] = X
        self._levels[tenant] = deque(maxlen=self.window)
        self._tripped[tenant] = False
        self._registry.counter("fleet.drift.probes", tenant=tenant).inc()
        log_event("closedloop", f"monitoring tenant={tenant}: baseline "
                  f"|residual| {baseline:.3e} over {X.shape[0]} pinned "
                  "probe point(s)", verbose=self.verbose, event="attach",
                  tenant=str(tenant), baseline=baseline,
                  probe_points=int(X.shape[0]))
        return baseline

    def tenants(self) -> tuple:
        return tuple(self._baseline)

    def baseline(self, tenant: str) -> float:
        return self._baseline[tenant]

    def probe_set(self, tenant: str):
        """The pinned canary probe set recorded at attach time."""
        return self._probe_X[tenant]

    # ------------------------------------------------------------------ #
    def query(self, tenant: str, X, **kw):
        """Serve-and-observe convenience: the router's blocking
        :meth:`~tensordiffeq_tpu_torch.fleet.FleetRouter.query` plus the
        shadow-sampling hook.  The ``u`` answer is untouched — with no
        chaos active it is bit-identical to the unmonitored call."""
        out = self.router.query(tenant, X, **kw)
        if kw.get("kind", "u") == "u":
            self.on_query(tenant, X)
        return out

    def on_query(self, tenant: str, X) -> Optional[float]:
        """Observe one live ``u`` query: with probability
        ``sample_fraction`` (seeded), shadow-probe the SAME points
        through the residual kind.  Returns the probe's drift level when
        one was taken, else None."""
        if tenant not in self._baseline:
            return None
        chaos = active_chaos()
        if chaos is not None:
            scale = chaos.on_drift_probe(tenant)
            if scale is not None:
                self._perturb_served_params(tenant, scale)
        if self.sample_fraction <= 0.0 \
                or self._rng.uniform() >= self.sample_fraction:
            return None
        return self.probe(tenant, X)

    def probe(self, tenant: str, X=None) -> float:
        """One shadow probe: a single batched residual query (the
        engine's existing captured rung — no new graphs, no host
        hop beyond the result fetch every query already pays).  Updates
        the windowed ``fleet.drift.level`` gauge and the sticky trip
        state."""
        X = self._probe_X[tenant] if X is None else np.atleast_2d(
            np.asarray(X, np.float32))
        lt = self.router.load(tenant)
        mean_abs = float(np.mean(np.abs(np.asarray(lt.engine.residual(X)))))
        level = mean_abs / self._baseline[tenant]
        self._levels[tenant].append(level)
        windowed = float(np.mean(self._levels[tenant]))
        self._registry.counter("fleet.drift.probes", tenant=tenant).inc()
        self._registry.histogram("fleet.drift.residual",
                                 tenant=tenant).observe(mean_abs)
        self._registry.gauge("fleet.drift.level", tenant=tenant).set(
            round(windowed, 6))
        if windowed > self.slo.max_residual_drift \
                and not self._tripped[tenant]:
            self._tripped[tenant] = True
            self._registry.counter("fleet.drift.trips", tenant=tenant).inc()
            log_event("closedloop", f"DRIFT tripped: tenant={tenant} "
                      f"windowed residual {windowed:.2f}x baseline "
                      f"(threshold {self.slo.max_residual_drift:g}x)",
                      level="warning", verbose=self.verbose, event="drift",
                      tenant=str(tenant), drift_level=windowed,
                      threshold=self.slo.max_residual_drift)
        return windowed

    def drift(self, tenant: str) -> Optional[float]:
        """The tenant's current windowed drift level (None before any
        probe — no traffic, no verdict)."""
        levels = self._levels.get(tenant)
        return float(np.mean(levels)) if levels else None

    def tripped(self) -> tuple:
        """Tenants whose drift objective is in sticky breach (cleared by
        :meth:`reset` after a successful swap)."""
        return tuple(t for t, hit in self._tripped.items() if hit)

    def evaluate(self) -> dict:
        """The :class:`SLOSet` verdict over the monitor's registry — the
        ``residual_drift`` objective reads the gauges this monitor
        writes."""
        return self.slo.evaluate(self._registry)

    def reset(self, tenant: str, rebaseline: bool = True) -> None:
        """Clear the tenant's window + trip state after a swap; with
        ``rebaseline`` the NEW engine's probe residual becomes the new
        baseline (the swapped artifact defines fresh health)."""
        self._levels[tenant].clear()
        self._tripped[tenant] = False
        self._registry.gauge("fleet.drift.level", tenant=tenant).set(1.0)
        if rebaseline:
            self.attach(tenant, self._probe_X[tenant])

    # ------------------------------------------------------------------ #
    def _perturb_served_params(self, tenant: str, scale: float) -> None:
        """Apply the chaos ``drift_inject`` fault: deterministically
        scale the tenant's SERVED parameter tensors in place.  The rungs'
        graphs read those tensors' storage, so the very next query (and
        probe) replays on the drifted model — no reload and no capture,
        exactly like silent numeric rot on a live replica.  (The JAX
        package rebinds ``surrogate.params``, which its programs take as
        arguments; here a rebinding would drop every graph, keyed on the
        parameters' storage, and capture again at request time.)"""
        from ..serving.engine import device_lock
        from ..utils import param_leaves
        lt = self.router.load(tenant)
        with device_lock, torch.no_grad():
            for p in param_leaves(lt.surrogate.params):
                p.mul_(1.0 + scale)


class RetrainController:
    """Drive the drift → retrain → hot-swap cycle (module docstring).

    Args:
      router / monitor: the serving fleet and its drift monitor.
      build_factory: ``build_factory(init_params) -> SurrogateFactory``
        — rebuilds the θ-neighborhood family, warm-started from the
        per-member param list the controller harvests from the LIVE
        tenants (``None`` entries fall back to fresh PRNG init).  The
        caller owns the problem definition (f_model, domain, bcs,
        thetas); the controller owns when and from where it retrains.
      members: ``{member_index: tenant}`` — the
        :meth:`~tensordiffeq_tpu_torch.fleet.FleetRouter.register_family`
        return value; keys are ORIGINAL member indices, exactly as the
        family manifest records them.
      retrain_iters / chunk: total retrain epochs and the chunk size
        between supervisor boundaries (the kill/relaunch granularity).
      resample_every: drift-weighted collocation cadence (the
        FamilyResampler's residual-importance redraw).  ``None`` (the
        default) resamples once per chunk; ``0`` disables.
      fit_chunk: the chunk of each ``factory.fit`` call inside a
        supervisor chunk (one host read each; default: the whole
        supervisor chunk, as the JAX controller).  A redraw is
        dispatched at the fit's chunk boundaries that cross
        ``resample_every`` and adopted at the next one, so a redraw that
        trains steps needs a ``fit_chunk`` at most half the supervisor
        chunk.
      retry: :class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy` for
        relaunch backoff between trainer-death generations (default:
        3 attempts, seeded jitter).
      gate_ratio: canary gate as a multiple of the tenant's ATTACH-TIME
        baseline residual — the recorded healthy state, not the drifted
        one (1.5 = "the retrained member must land within 1.5x of the
        residual the tenant shipped with").
      export_kw: forwarded to :meth:`~tensordiffeq_tpu_torch.factory.
        SurrogateFactory.export_family` (bucket ladder, kinds, ...).
      workdir: where v2 family batches land (one subdirectory per
        cycle); default: a temp directory.
      sleep / clock: injectable for tests.
    """

    def __init__(self, router, monitor: DriftMonitor,
                 build_factory: Callable, members: dict, *,
                 retrain_iters: int = 200, chunk: int = 50,
                 resample_every: Optional[int] = None,
                 resample_kw: Optional[dict] = None,
                 fit_chunk: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 gate_ratio: float = 1.5,
                 export_kw: Optional[dict] = None,
                 workdir: Optional[str] = None,
                 registry=None, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 verbose: bool = False):
        if retrain_iters < 1:
            raise ValueError(
                f"retrain_iters must be >= 1, got {retrain_iters}")
        self.router = router
        self.monitor = monitor
        self.build_factory = build_factory
        self.members = {int(m): str(t) for m, t in members.items()}
        self.retrain_iters = int(retrain_iters)
        self.chunk = max(1, int(chunk))
        self.resample_every = (self.chunk if resample_every is None
                               else int(resample_every))
        self.resample_kw = dict(resample_kw or {})
        self.fit_chunk = None if fit_chunk is None else max(1, int(fit_chunk))
        self.retry = retry if retry is not None else RetryPolicy()
        self.gate_ratio = float(gate_ratio)
        self.export_kw = dict(export_kw or {})
        self.workdir = workdir
        self._registry = (registry if registry is not None
                          else default_registry())
        self._clock = clock
        self._sleep = sleep
        self.verbose = bool(verbose)
        self._cycles = 0

    # ------------------------------------------------------------------ #
    def live_params(self) -> list:
        """The warm-start harvest: member-index-ordered list of the LIVE
        tenants' served params (``[(W, b), ...]``; ``None`` where a member
        has no live tenant — that member re-initializes from its seed)."""
        out = []
        for m in sorted(self.members):
            lt = self.router._loaded.get(self.members[m])
            out.append(None if lt is None else lt.surrogate.params)
        return out

    def run_cycle(self, force: bool = False) -> dict:
        """One full closed-loop pass: check the trip wire, retrain the
        neighborhood under the supervisor loop, export the v2 batch,
        canary + hot-swap every member.  Returns the cycle summary
        (``{"triggered": False}`` when nothing tripped and ``force`` is
        off — the idle poll costs one dict)."""
        tripped = self.monitor.tripped()
        if not tripped and not force:
            return {"triggered": False}
        self._cycles += 1
        summary: dict = {"triggered": True, "tripped": list(tripped),
                         "cycle": self._cycles}
        tr = active_tracer()  # one probe on the untraced path
        if tr is None:
            factory = self._retrain(summary)
            v2 = self._export(factory, summary)
            self._swap_all(factory, v2, summary)
            return summary
        with tr.span("closedloop.cycle", cycle=self._cycles,
                     tripped=len(tripped)):
            factory = self._retrain(summary)
            v2 = self._export(factory, summary)
            self._swap_all(factory, v2, summary)
            return summary

    # ------------------------------------------------------------------ #
    def _retrain(self, summary: dict):
        """The supervisor loop: fit the family in chunks; a trainer
        death relaunches a new generation with RetryPolicy backoff,
        resuming from the family's surviving state (the in-process
        analogue of :class:`~tensordiffeq_tpu_torch.resilience.
        ClusterSupervisor`'s generation relaunch)."""
        t0 = self._clock()
        factory = self.build_factory(self.live_params())
        generation, done, kills = 0, 0, 0
        while done < self.retrain_iters:
            generation += 1
            self._registry.counter("fleet.swap.generations").inc()
            log_event("closedloop",
                      f"RETRAIN generation {generation} launched: "
                      f"{factory.n_members} member(s), epochs "
                      f"{done}->{self.retrain_iters}"
                      + (" (relaunch after trainer death)"
                         if generation > 1 else ""),
                      verbose=self.verbose, event="retrain",
                      generation=generation, members=factory.n_members,
                      start_epoch=done, target_epochs=self.retrain_iters,
                      relaunch=generation > 1)
            tr = active_tracer()
            gen_span = (None if tr is None else tr.open_span(
                "closedloop.retrain", generation=generation,
                start_epoch=done))
            try:
                # the retrain job inherits the cycle's trace: anything
                # this generation spawns (a cluster-backed factory, an
                # export subprocess) reads TDQ_TRACE_CONTEXT and its
                # spans join the incident timeline
                with propagate_trace(gen_span):
                    while done < self.retrain_iters:
                        n = min(self.chunk, self.retrain_iters - done)
                        factory.fit(tf_iter=n,
                                    chunk=min(n, self.fit_chunk or n),
                                    resample_every=self.resample_every,
                                    **self.resample_kw)
                        done += n
                        chaos = active_chaos()
                        if chaos is not None and done < self.retrain_iters:
                            chaos.on_retrain_boundary(generation, done)
                if gen_span is not None:
                    tr.close_span(gen_span.set_attrs(end_epoch=done))
            except ChaosFault as e:
                if gen_span is not None:
                    tr.close_span(gen_span, error=e)
                kills += 1
                if kills >= self.retry.max_attempts:
                    raise
                delay = self.retry.delay_s(kills)
                log_event("closedloop",
                          f"retrain generation {generation} died at epoch "
                          f"{done} ({e}); relaunching after {delay:.2f}s "
                          f"backoff (attempt {kills + 1}/"
                          f"{self.retry.max_attempts})", level="warning",
                          verbose=self.verbose, event="retrain_death",
                          generation=generation, epoch=done,
                          backoff_s=delay,
                          error=f"{type(e).__name__}: {e}")
                self._sleep(delay)
        wall = self._clock() - t0
        self._registry.histogram("fleet.swap.retrain_wall_s").observe(wall)
        summary.update(generations=generation, trainer_kills=kills,
                       retrain_epochs=done, retrain_wall_s=wall)
        return factory

    def _export(self, factory, summary: dict) -> str:
        """Export the v2 family batch and run the ``swap_corrupt_member``
        chaos hook over each member artifact (post-promote, like the
        torn-checkpoint fault — the corruption the checksum must
        catch)."""
        if self.workdir is None:
            import tempfile
            self.workdir = tempfile.mkdtemp(prefix="tdq_closedloop_")
        v2 = os.path.join(self.workdir, f"v{self._cycles + 1}")
        manifest = factory.export_family(v2, **self.export_kw)
        chaos = active_chaos()
        if chaos is not None:
            for m, rel in manifest["members"].items():
                chaos.on_member_artifact(int(m), os.path.join(v2, rel))
        summary.update(v2_dir=v2,
                       exported=sorted(int(m) for m in manifest["members"]),
                       frozen=sorted(int(m) for m in manifest["frozen"]))
        return v2

    def _swap_all(self, factory, v2: str, summary: dict) -> None:
        import json as _json

        from ..factory import FAMILY_MANIFEST
        with open(os.path.join(v2, FAMILY_MANIFEST)) as fh:
            manifest = _json.load(fh)
        swapped, rolled_back = [], []
        for m in sorted(self.members):
            tenant = self.members[m]
            rel = manifest["members"].get(str(m))
            if rel is None:
                # frozen mid-family: the manifest excluded it, so the
                # tenant's old engine keeps serving — narrated as a
                # rollback (that is what the route does)
                self._registry.counter("fleet.swap.rollbacks",
                                       tenant=tenant).inc()
                log_event("closedloop",
                          f"ROLLBACK: tenant={tenant} kept its old engine "
                          f"(member {m} frozen mid-family, excluded per "
                          "the manifest)", level="warning",
                          verbose=self.verbose, event="rollback",
                          tenant=tenant, member=int(m),
                          reason="member_frozen")
                rolled_back.append({"tenant": tenant, "member": int(m),
                                    "reason": "member_frozen"})
                continue
            verdict = self.router.hot_swap(
                tenant, os.path.join(v2, rel),
                f_model=factory.member_f_model(m),
                probe_X=self.monitor.probe_set(tenant),
                gate=self.monitor.baseline(tenant) * self.gate_ratio)
            verdict["member"] = int(m)
            if verdict["swapped"]:
                self.monitor.reset(tenant)
                swapped.append(verdict)
            else:
                rolled_back.append(verdict)
        summary.update(swapped=swapped, rolled_back=rolled_back)
