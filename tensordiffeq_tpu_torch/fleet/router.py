"""The multi-tenant fleet router: many surrogates, one front door.

Counterpart of the JAX package's ``fleet/router.py``; its engines run on
the card (``device="cuda"``, the default) and hold one CUDA graph per
(kind, bucket) rung where the JAX engines hold a jitted program.

One trained surrogate per PDE/config is the breadth direction PINNs-TF2
(arXiv:2311.03626) motivates on the training side; a real deployment
hosts MANY of them at once behind one process.  :class:`FleetRouter`
composes the serving, resilience and telemetry pieces into that layer:

* a **bounded LRU artifact cache** — at most ``max_loaded`` tenants hold
  live engines (each engine owns a ladder of captured CUDA graphs and
  their memory pool, the scarce resource); the least-recently-used tenant
  is evicted to make room, its pending batches flushed and its graphs
  dropped (:meth:`~tensordiffeq_tpu_torch.serving.InferenceEngine.release`;
  each engine has its own pool, so a tenant cycled through eviction
  captures again at every reload).  A
  reload goes back through the checksum-validated restore path
  (:mod:`tensordiffeq_tpu_torch.checkpoint`), and the evicted engine's bucket
  quarantine is carried across the reload — a rung that failed to
  capture is NOT resurrected as healthy just because memory pressure
  cycled the tenant.
* **per-tenant serving policy** — each tenant's
  :class:`~tensordiffeq_tpu_torch.serving.RequestBatcher` set (one per query
  kind) runs under its own :class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy`,
  :class:`~tensordiffeq_tpu_torch.resilience.CircuitBreaker` and request
  deadline (:class:`TenantPolicy`): one tenant's dying backend opens one
  tenant's breaker.
* **admission before queue** — every submit passes the
  :class:`~tensordiffeq_tpu_torch.fleet.AdmissionController` BEFORE anything
  is enqueued (or even loaded), so overload sheds with a structured
  :class:`~tensordiffeq_tpu_torch.fleet.AdmissionRejected` at the front door
  instead of collapsing the queues behind it.
* **warm start** — ``load()`` runs the
  :func:`~tensordiffeq_tpu_torch.fleet.warm_start` ladder, so a freshly
  loaded tenant answers its first query without capturing anything at
  request time.
* **autoscaling signals** — per-tenant queue-depth gauges, latency
  histograms and cache hit/miss/eviction counters all land in the
  shared :func:`~tensordiffeq_tpu_torch.telemetry.default_registry` (tenant-
  labeled via registry scopes); :meth:`autoscale_signals` distils the
  scale-up/down inputs an operator loop polls.

With no chaos active, a fleet-served query is bit-identical to the same
query against a direct :class:`~tensordiffeq_tpu_torch.serving.InferenceEngine`
over the same artifact, loaded and warm-started alike
(``tests/test_torch_fleet.py`` pins this).

Threads: the router's bookkeeping and every engine call it makes run
under its own lock, and every device operation of every engine under the
engines' :data:`~tensordiffeq_tpu_torch.serving.engine.device_lock`.
:meth:`FleetRouter.hot_swap` loads and warm-drives the candidate holding
only the device lock, one rung at a time, so the live engine keeps
serving queries of other threads between the candidate's captures; the
flip itself takes the router's lock.  A retired engine (evicted, or
swapped out) drops its graphs under the device lock, never at a garbage
collection that could land inside another thread's capture.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np

from ..resilience.breaker import CircuitBreaker
from ..resilience.chaos import active_chaos
from ..serving.batcher import RequestBatcher
from ..serving.engine import device_lock
from ..serving.surrogate import Surrogate
from ..telemetry import default_registry, log_event
from ..telemetry.slo import SLOSet
from ..telemetry.tracing import active_tracer
from ..utils import resolve_device
from .admission import AdmissionController
from .warmstart import warm_start


class TenantEvicted(RuntimeError):
    """Delivered to waiters whose coalesced batch could not execute
    (circuit breaker open) before their tenant was evicted — a
    structured immediate failure instead of a deadline spin against an
    engine that no longer exists."""

    trace_id = None

    def __init__(self, tenant: str):
        self.tenant = str(tenant)
        super().__init__(
            f"tenant {tenant!r} was evicted before this request's batch "
            "could execute (circuit open at eviction); resubmit to "
            "trigger a reload")


class TenantPolicy:
    """One tenant's serving-policy knobs (engine shape, batching,
    resilience, admission).  Pure configuration — safe to share between
    tenants that want identical policy.

    Args:
      min_bucket / max_bucket / shard: the tenant engine's pad-to-bucket
        ladder (see :class:`~tensordiffeq_tpu_torch.serving.InferenceEngine`).
      max_batch / max_latency_s: the tenant batchers' coalescing policy.
      retry: optional :class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy`
        for this tenant's batchers (shared across its query kinds).
      breaker_failure_threshold / breaker_reset_timeout_s: when the
        threshold is not None, each *load* of this tenant gets its own
        :class:`~tensordiffeq_tpu_torch.resilience.CircuitBreaker` (named
        ``fleet.<tenant>``) shared across its query-kind batchers.
      request_timeout_s: per-request deadline (None disables — serve
        with one).
      rate_qps / burst / max_queue_points / priority: the tenant's
        admission-control contract (see
        :class:`~tensordiffeq_tpu_torch.fleet.AdmissionController`).
      warm_start: prewarm the engine ladder at load time (the fleet
        default).  ``False`` loads cold — first queries pay their rungs'
        captures at request time (what the warm path is priced
        against).
      warm_kinds: query kinds to prewarm when the artifact carries no
        warm-start block (v1 artifacts); an artifact block's own kinds
        win when present.
    """

    def __init__(self, *, min_bucket: int = 256, max_bucket: int = 1 << 20,
                 shard: bool = False, max_batch: int = 4096,
                 max_latency_s: float = 0.01, retry=None,
                 breaker_failure_threshold: Optional[int] = None,
                 breaker_reset_timeout_s: float = 30.0,
                 request_timeout_s: Optional[float] = 30.0,
                 rate_qps: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_queue_points: Optional[int] = None,
                 priority: int = 1, warm_start: bool = True,
                 warm_kinds: Optional[Sequence[str]] = None):
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.shard = bool(shard)
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.retry = retry
        self.breaker_failure_threshold = breaker_failure_threshold
        self.breaker_reset_timeout_s = float(breaker_reset_timeout_s)
        self.request_timeout_s = request_timeout_s
        self.rate_qps = rate_qps
        self.burst = burst
        self.max_queue_points = max_queue_points
        self.priority = int(priority)
        self.warm_start = bool(warm_start)
        self.warm_kinds = None if warm_kinds is None else list(warm_kinds)


class _Registration:
    """What the router remembers about a tenant across load/evict cycles."""

    __slots__ = ("artifact", "f_model", "net", "policy", "quarantine")

    def __init__(self, artifact, f_model, net, policy):
        self.artifact = artifact
        self.f_model = f_model
        self.net = net
        self.policy = policy
        self.quarantine: list = []  # engine.quarantine_snapshot() carryover


class LoadedTenant:
    """A live tenant: surrogate + engine + per-kind batchers + breaker."""

    def __init__(self, tenant: str, surrogate: Surrogate, engine,
                 policy: TenantPolicy, registry, clock, warm: dict):
        self.tenant = tenant
        self.surrogate = surrogate
        self.engine = engine
        self.policy = policy
        self.warm = warm
        self._registry = registry
        self._clock = clock
        self.breaker = None
        if policy.breaker_failure_threshold is not None:
            self.breaker = CircuitBreaker(
                failure_threshold=policy.breaker_failure_threshold,
                reset_timeout_s=policy.breaker_reset_timeout_s,
                name=f"fleet.{tenant}", clock=clock, registry=registry)
        self._batchers: "OrderedDict[str, RequestBatcher]" = OrderedDict()

    def batcher(self, kind: str = "u") -> RequestBatcher:
        """The tenant's coalescing batcher for one query kind (created
        lazily; all kinds share the tenant's breaker + retry policy)."""
        spec = self.engine.spec_for(self.engine.kind_key(kind))
        b = self._batchers.get(spec)
        if b is None:
            b = self._batchers[spec] = RequestBatcher(
                op=self.engine.op_for(spec),
                max_batch=self.policy.max_batch,
                max_latency_s=self.policy.max_latency_s,
                retry=self.policy.retry, breaker=self.breaker,
                request_timeout_s=self.policy.request_timeout_s,
                clock=self._clock,
                registry=self._registry.scope(kind=spec))
        return b

    def pending_points(self) -> int:
        return sum(b.pending_points for b in self._batchers.values())

    def flush(self) -> None:
        """Flush every kind's pending batch (failures are delivered to
        their waiters by the batcher itself)."""
        for b in self._batchers.values():
            try:
                b.flush()
            except Exception:
                pass  # waiters already hold the failure

    def drain(self) -> None:
        """Eviction-time flush: try to execute pending batches, then
        fail-fast whatever could NOT run (an open breaker makes
        ``flush()`` a no-op that keeps the queue) — no waiter may be
        left spinning against an engine that is being dropped."""
        self.flush()
        for b in self._batchers.values():
            if b.pending_points:
                b.fail_pending(TenantEvicted(self.tenant))

    def poll(self) -> bool:
        return any([b.poll() for b in self._batchers.values()])

    def stats(self) -> dict:
        return {spec: b.stats() for spec, b in self._batchers.items()}

    def snapshot(self) -> dict:
        """One CONSISTENT observation of this tenant: per-kind batcher
        stats and the pending-point total captured from the SAME
        per-batcher snapshots (:meth:`RequestBatcher.snapshot`), so a
        flush racing the scrape can never tear the two apart."""
        snaps = {spec: b.snapshot()
                 for spec, b in tuple(self._batchers.items())}
        return {
            "kinds": {spec: s["stats"] for spec, s in snaps.items()},
            "pending_points": sum(s["pending_points"]
                                  for s in snaps.values()),
        }


class FleetRouter:
    """Route multi-tenant surrogate queries; see the module docstring.

    Args:
      max_loaded: LRU bound on concurrently live tenants (engines).
      admission: an :class:`~tensordiffeq_tpu_torch.fleet.AdmissionController`
        (one is built with defaults when omitted; pass your own to tune
        fleet-wide capacity).
      registry: metrics destination (default: the shared process
        registry).  Per-tenant instruments are tenant-labeled scopes of
        it.
      clock: time source, injectable for tests (threads through
        batchers, breakers and the admission controller built here).
      slo: the :class:`~tensordiffeq_tpu_torch.telemetry.SLOSet` whose verdict
        rides in :meth:`autoscale_signals` (default: the standard set),
        so an operator loop scales up on SLO burn, not just on queue
        depth.  Evaluation runs only when signals are polled — the
        default costs nothing between polls.
      device: where the tenants' engines run: the card (``"cuda"``, the
        default; raises :class:`~tensordiffeq_tpu_torch.utils.
        CudaUnavailableError` without one) unless the caller passes
        ``"cpu"``.
    """

    def __init__(self, max_loaded: int = 4,
                 admission: Optional[AdmissionController] = None,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 slo: Optional[SLOSet] = None, device="cuda"):
        if max_loaded < 1:
            raise ValueError(f"max_loaded must be >= 1, got {max_loaded}")
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self.max_loaded = int(max_loaded)
        self._registry = (registry if registry is not None
                          else default_registry())
        self._clock = clock
        self.slo = slo if slo is not None else SLOSet.default()
        self.admission = (admission if admission is not None
                          else AdmissionController(clock=clock,
                                                   registry=self._registry))
        self._registered: dict = {}
        self._loaded: "OrderedDict[str, LoadedTenant]" = OrderedDict()
        self._hits = self._misses = self._evictions = 0
        self.collector = None  # set by serve_metrics

    # ------------------------------------------------------------------ #
    def register(self, tenant: str, artifact: str, *, f_model=None,
                 net=None, policy: Optional[TenantPolicy] = None) -> None:
        """Register a tenant: artifact path + user code (``f_model``,
        custom ``net``) + policy.  Registration is cheap — nothing loads
        until the first query (or an explicit :meth:`load`).
        Re-registering replaces the entry (a live instance is evicted
        first: the old artifact must not keep serving)."""
        with self._lock:
            if tenant in self._loaded:
                self.evict(tenant)
            self._registered[tenant] = _Registration(
                str(artifact), f_model, net, policy or TenantPolicy())
            pol = self._registered[tenant].policy
            self.admission.configure(
                tenant, rate_qps=pol.rate_qps, burst=pol.burst,
                max_queue_points=pol.max_queue_points,
                priority=pol.priority)

    def register_family(self, path: str, *,
                        policy: Optional[TenantPolicy] = None,
                        prefix: Optional[str] = None,
                        f_models: Optional[dict] = None) -> dict:
        """Register every member of a surrogate-factory artifact batch
        (:meth:`~tensordiffeq_tpu_torch.factory.SurrogateFactory.
        export_family`): reads ``family_manifest.json`` under ``path``
        and registers each live member's v2 AOT artifact as a tenant —
        the factory's product loads directly into the fleet.  Frozen
        (diverged) members recorded in the manifest are skipped; member
        artifacts serve residual queries with no ``f_model`` re-attached
        (from the lowered residual tape), but ``f_models`` —
        ``{member_index: f_model}`` with the member's θ already bound —
        re-attaches user code (the engine's own residual program, bit
        for bit a direct engine).  Returns ``{member_index: tenant_name}`` keyed
        by the ORIGINAL member index (mirroring the manifest), never a
        positional sequence: with a frozen member skipped, positions
        would silently shift every later member onto the wrong
        coefficient."""
        import json as _json
        import os as _os

        from ..factory import FAMILY_MANIFEST
        with open(_os.path.join(path, FAMILY_MANIFEST)) as fh:
            manifest = _json.load(fh)
        names = {}
        for m, rel in sorted(manifest["members"].items(),
                             key=lambda kv: int(kv[0])):
            tenant = rel if prefix is None else f"{prefix}{int(m):03d}"
            self.register(
                tenant, _os.path.join(path, rel),
                f_model=(f_models or {}).get(int(m)), policy=policy)
            names[int(m)] = tenant
        return names

    def tenants(self) -> tuple:
        return tuple(self._registered)

    def loaded(self) -> tuple:
        """Live tenants, LRU-first (the leftmost is next to evict)."""
        return tuple(self._loaded)

    def _reg(self, tenant: str) -> _Registration:
        reg = self._registered.get(tenant)
        if reg is None:
            raise KeyError(
                f"tenant {tenant!r} is not registered (known: "
                f"{sorted(self._registered)})")
        return reg

    # ------------------------------------------------------------------ #
    def load(self, tenant: str) -> LoadedTenant:
        """The tenant's live instance: a cache hit refreshes its LRU slot;
        a miss evicts down to ``max_loaded - 1``, restores the artifact
        through the checksum-validated checkpoint path, re-applies the
        tenant's quarantine memory, and warm-starts the engine.  With a
        tracer active the load-or-hit is a ``fleet.load`` span."""
        tr = active_tracer()
        if tr is None:
            return self._load(tenant)
        with tr.span("fleet.load", tenant=str(tenant)) as sp:
            hits0 = self._hits
            lt = self._load(tenant)
            sp.set_attrs(cache=("hit" if self._hits > hits0 else "miss"))
            return lt

    def _load(self, tenant: str) -> LoadedTenant:
        with self._lock:
            return self._load_locked(tenant)

    def _build(self, tenant: str, reg: "_Registration", artifact: str,
               f_model, net, quarantine=()) -> tuple:
        """A tenant's surrogate and engine from ``artifact``, warm-started
        per its policy: ``(surrogate, engine, scope, warm)``.  The restore
        and the engine's pool run under the device lock; the warm drive
        takes it rung by rung.  A failure drops the engine's graphs before
        it propagates."""
        with device_lock:
            sur = Surrogate.load(artifact, f_model=f_model, net=net,
                                 device=self.device)
            scope = self._registry.scope(tenant=tenant)
            engine = sur.engine(min_bucket=reg.policy.min_bucket,
                                max_bucket=reg.policy.max_bucket,
                                shard=reg.policy.shard, registry=scope)
        try:
            if quarantine:
                engine.restore_quarantine(quarantine)
            warm: dict = {}
            if reg.policy.warm_start:
                warm = warm_start(engine, kinds=reg.policy.warm_kinds,
                                  tenant=tenant, registry=self._registry,
                                  max_drive_bucket=reg.policy.max_batch)
        except BaseException:
            engine.release()
            raise
        return sur, engine, scope, warm

    def _load_locked(self, tenant: str) -> LoadedTenant:
        reg = self._reg(tenant)
        chaos = active_chaos()
        if chaos is not None and chaos.on_fleet_access(
                evictable=bool(self._loaded)):
            self.evict()
        lt = self._loaded.get(tenant)
        if lt is not None:
            self._loaded.move_to_end(tenant)
            self._hits += 1
            self._registry.counter("fleet.cache.hits", tenant=tenant).inc()
            return lt
        self._misses += 1
        self._registry.counter("fleet.cache.misses", tenant=tenant).inc()
        while len(self._loaded) >= self.max_loaded:
            self.evict()
        t0 = self._clock()
        sur, engine, scope, warm = self._build(
            tenant, reg, reg.artifact, reg.f_model, reg.net, reg.quarantine)
        lt = LoadedTenant(tenant, sur, engine, reg.policy, scope,
                          self._clock, warm)
        self._loaded[tenant] = lt
        load_s = self._clock() - t0
        self._registry.histogram("fleet.load_s").observe(load_s)
        self._registry.gauge("fleet.loaded_tenants").set(len(self._loaded))
        log_event("fleet",
                  f"loaded tenant={tenant} from {reg.artifact} in "
                  f"{load_s:.3f}s"
                  + (f" (warm start: {warm.get('aot', 0)} AOT + "
                     f"{warm.get('jit', 0)} jit)" if warm else " (cold)"),
                  verbose=False, event="load", tenant=tenant,
                  load_s=load_s, warm=bool(warm))
        return lt

    def evict(self, tenant: Optional[str] = None) -> Optional[str]:
        """Drop a live tenant (default: the LRU one).  Pending batches
        are flushed first, the engine's quarantine is snapshotted into
        the registration (reload carries it), and the engine's graphs
        are dropped.  Returns the evicted tenant (None if nothing was
        loaded)."""
        with self._lock:
            return self._evict(tenant)

    def _evict(self, tenant: Optional[str]) -> Optional[str]:
        if tenant is None:
            if not self._loaded:
                return None
            tenant = next(iter(self._loaded))
        lt = self._loaded.pop(tenant, None)
        if lt is None:
            return None
        lt.drain()
        self._reg(tenant).quarantine = lt.engine.quarantine_snapshot()
        lt.engine.release()
        self._evictions += 1
        self._registry.counter("fleet.cache.evictions",
                               tenant=tenant).inc()
        self._registry.gauge("fleet.loaded_tenants").set(len(self._loaded))
        log_event("fleet",
                  f"evicted tenant={tenant} (LRU, {len(self._loaded)}/"
                  f"{self.max_loaded} loaded); graphs dropped, "
                  f"{len(self._reg(tenant).quarantine)} quarantined "
                  "rung(s) remembered", verbose=False, event="evict",
                  tenant=tenant, loaded=len(self._loaded))
        return tenant

    # ------------------------------------------------------------------ #
    def hot_swap(self, tenant: str, artifact: str, *, f_model=None,
                 net=None, probe_X=None, gate: Optional[float] = None,
                 gate_ratio: float = 1.0) -> dict:
        """Zero-downtime artifact swap with canary validation and
        bit-validated rollback (the closed loop's cutover; see
        :mod:`tensordiffeq_tpu_torch.fleet.closedloop`).

        The candidate artifact is restored through the checksum-validated
        checkpoint path and warm-driven BESIDE the live tenant — the old
        engine keeps serving (queries of other threads run between the
        candidate's captures, module docstring) while the new one loads,
        and it captures nothing at request time.  The canary then replays the pinned
        ``probe_X`` on both engines: the candidate's mean absolute
        residual must come in at or under the gate (``gate`` absolute
        when given, else ``gate_ratio`` × the OLD engine's replayed
        residual).  Only a passing candidate flips the route: the old
        engine's pending batches are flushed (zero dropped or hung
        waiters), the loaded-tenant entry is replaced in place (same LRU
        slot — the flip is one dict assignment), and the registration
        points at the new artifact so later reloads get v2.

        A candidate that fails to restore (torn blob → checksum
        mismatch) or fails its gate is REJECTED: the old engine keeps
        serving, and the probe replay after rejection is byte-compared
        against the pre-swap ``u`` snapshot (``bit_identical`` in the
        verdict) — rollback is proven, not assumed.

        Returns the verdict dict: ``swapped``, ``reason``,
        ``old_residual`` / ``new_residual`` / ``gate``,
        ``cutover_stall_s`` (flip-time flush stall; the only pause any
        waiter can observe), ``bit_identical`` (rejections only) and the
        candidate's warm-start report.

        With a tracer active the whole cutover is a ``fleet.hot_swap``
        span — opened under whatever trace the caller carries, so a
        retrain job's swap joins the retrain trace the
        :class:`~tensordiffeq_tpu_torch.fleet.RetrainController` propagated."""
        tr = active_tracer()  # one probe on the untraced path
        if tr is None:
            return self._hot_swap(tenant, artifact, f_model=f_model,
                                  net=net, probe_X=probe_X, gate=gate,
                                  gate_ratio=gate_ratio)
        with tr.span("fleet.hot_swap", tenant=str(tenant),
                     artifact=str(artifact)) as sp:
            verdict = self._hot_swap(tenant, artifact, f_model=f_model,
                                     net=net, probe_X=probe_X, gate=gate,
                                     gate_ratio=gate_ratio)
            sp.set_attrs(swapped=bool(verdict.get("swapped")),
                         reason=str(verdict.get("reason")))
            if not verdict.get("swapped"):
                sp.status = "error"
            return verdict

    def _hot_swap(self, tenant: str, artifact: str, *, f_model=None,
                  net=None, probe_X=None, gate: Optional[float] = None,
                  gate_ratio: float = 1.0) -> dict:
        with self._lock:
            reg = self._reg(tenant)
            old = self.load(tenant)
            probe = (None if probe_X is None
                     else np.atleast_2d(np.asarray(probe_X, np.float32)))
            u_before = (None if probe is None
                        else np.asarray(old.engine.u(probe)).tobytes())
        verdict: dict = {"tenant": str(tenant), "swapped": False,
                         "artifact": str(artifact)}

        # the candidate, beside the live engine: the router's lock is not
        # held, so queries keep flowing between its captures
        t0 = self._clock()
        try:
            sur, engine, scope, warm = self._build(
                tenant, reg, str(artifact), f_model, net)
        except Exception as e:
            # torn/corrupt candidate: the checkpoint checksum (or the
            # engine build) refused it — the old engine never stopped
            with self._lock:
                self._reject(tenant, old, probe, u_before, verdict,
                             reason="artifact_rejected",
                             detail=f"{type(e).__name__}: {e}")
            return verdict
        verdict["warm"] = warm
        verdict["candidate_load_s"] = self._clock() - t0
        with self._lock:
            if self._loaded.get(tenant) is not old:
                # evicted or swapped by another thread meanwhile: the
                # candidate was built against a route that is gone
                engine.release()
                verdict.update(reason="route_changed")
                return verdict
            return self._canary_and_flip(tenant, reg, old, sur, engine,
                                         scope, warm, probe, u_before,
                                         verdict, artifact, f_model, net,
                                         gate, gate_ratio)

    def _canary_and_flip(self, tenant, reg, old, sur, engine, scope, warm,
                         probe, u_before, verdict, artifact, f_model, net,
                         gate, gate_ratio) -> dict:
        """The canary on the pinned probe, then the flip (under the
        router's lock)."""
        if probe is not None:
            old_res = float(np.mean(np.abs(
                np.asarray(old.engine.residual(probe)))))
            new_res = float(np.mean(np.abs(
                np.asarray(engine.residual(probe)))))
            g = float(gate) if gate is not None else gate_ratio * old_res
            verdict.update(old_residual=old_res, new_residual=new_res,
                           gate=g)
            if not np.isfinite(new_res) or new_res > g:
                self._registry.counter("fleet.canary.rejected",
                                       tenant=tenant).inc()
                log_event("closedloop",
                          f"CANARY rejected tenant={tenant}: candidate "
                          f"|residual| {new_res:.3e} over gate {g:.3e} "
                          f"(old engine replays {old_res:.3e})",
                          level="warning", verbose=False, event="canary",
                          tenant=str(tenant), passed=False,
                          old_residual=old_res, new_residual=new_res,
                          gate=g)
                engine.release()
                self._reject(tenant, old, probe, u_before, verdict,
                             reason="canary_regressed")
                return verdict
            self._registry.counter("fleet.canary.passed",
                                   tenant=tenant).inc()
            log_event("closedloop",
                      f"CANARY passed tenant={tenant}: candidate "
                      f"|residual| {new_res:.3e} within gate {g:.3e} "
                      f"(old engine replays {old_res:.3e})",
                      verbose=False, event="canary", tenant=str(tenant),
                      passed=True, old_residual=old_res,
                      new_residual=new_res, gate=g)

        # the atomic flip: flush what the OLD engine owes its waiters,
        # then replace the loaded entry in place — requests submitted
        # after this line batch against the (already warm) new engine
        t1 = self._clock()
        old.flush()
        self._loaded[tenant] = LoadedTenant(
            tenant, sur, engine, reg.policy, scope, self._clock, warm)
        reg.artifact = str(artifact)
        reg.f_model = f_model
        reg.net = net
        reg.quarantine = []  # old rungs' history does not apply to v2
        old.engine.release()
        stall = self._clock() - t1
        self._registry.counter("fleet.swap.flips", tenant=tenant).inc()
        self._registry.histogram("fleet.swap.cutover_stall_s",
                                 tenant=tenant).observe(stall)
        verdict.update(swapped=True, reason="swapped",
                       cutover_stall_s=stall)
        log_event("closedloop",
                  f"SWAPPED tenant={tenant} to {artifact} "
                  f"(cutover stall {stall * 1e3:.2f}ms, warm start: "
                  f"{warm.get('aot', 0)} AOT + {warm.get('jit', 0)} jit)",
                  verbose=False, event="swap", tenant=str(tenant),
                  artifact=str(artifact), cutover_stall_s=stall)
        return verdict

    def _reject(self, tenant: str, old: LoadedTenant, probe, u_before,
                verdict: dict, *, reason: str,
                detail: Optional[str] = None) -> None:
        """Candidate rejection: record the rollback, and PROVE the old
        engine still serves bit-identically by replaying the probe
        against the pre-swap snapshot."""
        if probe is not None:
            u_after = np.asarray(old.engine.u(probe)).tobytes()
            verdict["bit_identical"] = u_after == u_before
        self._registry.counter("fleet.swap.rollbacks", tenant=tenant).inc()
        verdict.update(reason=reason, **({"detail": detail} if detail
                                         else {}))
        log_event("closedloop",
                  f"ROLLBACK: tenant={tenant} kept its old engine "
                  f"({reason}" + (f": {detail}" if detail else "")
                  + ("; probe replay bit-identical"
                     if verdict.get("bit_identical") else "") + ")",
                  level="warning", verbose=False, event="rollback",
                  tenant=str(tenant), reason=reason,
                  bit_identical=verdict.get("bit_identical"))

    # ------------------------------------------------------------------ #
    def submit(self, tenant: str, X, kind: str = "u",
               priority: Optional[int] = None):
        """Admission-gated submit: the request passes the
        :class:`AdmissionController` BEFORE the tenant is even loaded —
        overload never triggers artifact loads, let alone queue growth —
        then coalesces into the tenant's per-kind batcher.  Returns the
        batcher's :class:`~tensordiffeq_tpu_torch.serving.PendingQuery` handle;
        raises :class:`~tensordiffeq_tpu_torch.fleet.AdmissionRejected` when
        shed.  With a tracer active the admit → load-or-queue path is a
        ``fleet.submit`` span tree (nested under ``fleet.request`` when
        reached through :meth:`query`)."""
        tr = active_tracer()  # one probe on the untraced path
        with self._lock:
            if tr is None:
                return self._submit(tenant, X, kind, priority)
            with tr.span("fleet.submit", tenant=str(tenant),
                         kind=str(kind)):
                return self._submit(tenant, X, kind, priority)

    def _submit(self, tenant: str, X, kind: str, priority: Optional[int]):
        reg = self._reg(tenant)  # unknown tenants fail before admission
        n = int(np.atleast_2d(np.asarray(X)).shape[0])
        lt = self._loaded.get(tenant)
        self.admission.admit(
            tenant, n,
            priority if priority is not None else reg.policy.priority,
            tenant_pending=0 if lt is None else lt.pending_points(),
            fleet_pending=self.pending_points())
        return self.load(tenant).batcher(kind).submit(X)

    def query(self, tenant: str, X, kind: str = "u",
              priority: Optional[int] = None):
        """Blocking convenience: submit, flush, return the rows.  With no
        chaos active the result is bit-identical to the same call on a
        direct engine over the same artifact; with a tracer active the
        whole request is one ``fleet.request`` span tree — admission →
        load → batcher enqueue/flush → engine run → dispatch/device —
        the end-to-end trace the run log keeps per query."""
        tr = active_tracer()
        if tr is None:
            with self._lock:
                handle = self.submit(tenant, X, kind=kind, priority=priority)
                self._loaded[tenant].batcher(kind).flush()
            return handle.result()
        with tr.span("fleet.request", tenant=str(tenant), kind=str(kind)):
            with self._lock:
                handle = self.submit(tenant, X, kind=kind, priority=priority)
                self._loaded[tenant].batcher(kind).flush()
            return handle.result()

    def poll(self) -> bool:
        """Deadline sweep over every live tenant's batchers (hosts call
        this from their event loop).  Returns whether anything flushed."""
        with self._lock:
            return any([lt.poll() for lt in list(self._loaded.values())])

    def flush(self, tenant: Optional[str] = None) -> None:
        """Flush pending batches — one tenant's, or every live tenant's.
        An unknown tenant raises ``KeyError`` like every sibling method
        (a misspelled name must not masquerade as a successful flush);
        a registered-but-unloaded tenant has nothing pending and no-ops."""
        with self._lock:
            if tenant is None:
                targets = list(self._loaded.values())
            else:
                self._reg(tenant)
                lt = self._loaded.get(tenant)
                targets = [lt] if lt is not None else []
            for lt in targets:
                lt.flush()

    def pending_points(self) -> int:
        return sum(lt.pending_points() for lt in self._loaded.values())

    # ------------------------------------------------------------------ #
    def serve_metrics(self, addr: str = "127.0.0.1", port: int = 0, *,
                      slos=None, run_dirs: Sequence[str] = (),
                      host: Optional[str] = None):
        """One-call observability mount: a
        :class:`~tensordiffeq_tpu_torch.telemetry.Collector` exposing this
        router's registry (every ``fleet.*`` / ``serving.*`` instrument,
        per-tenant labels included) plus any ``run_dirs`` to tail,
        served at ``/metrics`` + ``/healthz``.  ``/healthz`` evaluates
        ``slos`` (default: this router's own :class:`SLOSet`) over the
        merged fleet view.  Returns the collector (its ``.url`` is the
        scrape target); caller closes it."""
        import os as _os
        import socket as _socket

        from ..telemetry.collector import Collector
        label = host if host is not None else _socket.gethostname()
        c = Collector(slos=slos if slos is not None else self.slo)
        c.attach_registry(self._registry, host=label,
                          process=f"router:{_os.getpid()}")
        for d in run_dirs:
            c.watch(d, host=label)
        c.serve(addr, port)
        self.collector = c
        return c

    def drain(self) -> int:
        """Planned-shutdown drain: flush every live tenant's pending
        batches, then fail-fast whatever could not execute (open
        breakers) — the zero-dropped-waiter contract :meth:`hot_swap`
        applies to one engine flip, applied to the whole process.  A
        replica worker calls this BEFORE exiting so in-flight
        ``PendingQuery`` handles complete instead of dying with the
        process.  Returns the pending-point count that was outstanding
        when the drain began."""
        with self._lock:
            owed = self.pending_points()
            for lt in list(self._loaded.values()):
                lt.drain()
        log_event("fleet", f"drained {owed} pending point(s) across "
                  f"{len(self._loaded)} live tenant(s)", verbose=False,
                  event="drain", pending_points=owed)
        return owed

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Cache tallies + per-tenant load state and batcher stats.
        Built from ONE capture of the loaded-tenant table and one
        :meth:`LoadedTenant.snapshot` per live tenant, so a flush racing
        the scrape (the replica beat thread, a collector poll) cannot
        tear the per-tenant numbers mid-read."""
        loaded = dict(self._loaded)
        tenants = {}
        for t in self._registered:
            lt = loaded.get(t)
            if lt is None:
                tenants[t] = {"loaded": False}
                continue
            tenants[t] = {
                "loaded": True,
                "kinds": lt.snapshot()["kinds"],
                "quarantined": lt.engine.quarantined_buckets(),
                "warm": lt.warm,
            }
        return {
            "max_loaded": self.max_loaded,
            "hits": self._hits, "misses": self._misses,
            "evictions": self._evictions,
            "tenants": tenants,
        }

    def autoscale_signals(self) -> dict:
        """The scale-up/down inputs an operator loop polls: per-tenant
        queue depth and latency percentiles, fleet-level cache pressure
        (a high eviction rate with a full cache is the 'add a replica /
        raise max_loaded' signal; all-zero queue depths with idle
        tenants is the scale-down one), and the :class:`SLOSet` verdict
        over the router's registry — scale on burn rate before the
        breach, not after.  One :meth:`LoadedTenant.snapshot` per tenant
        feeds BOTH the per-tenant rows and the fleet ``pending_points``
        total, so the total always equals the sum of the reported queue
        depths even while batchers flush concurrently."""
        tenants = {}
        fleet_pending = 0
        for t, lt in tuple(self._loaded.items()):
            snap = lt.snapshot()
            agg = snap["kinds"]
            lat = [s["latency_s"] for s in agg.values()
                   if s.get("latency_s", {}).get("p99") is not None]
            tenants[t] = {
                "queue_depth": snap["pending_points"],
                "qps": sum(s["qps"] or 0.0 for s in agg.values()),
                "latency_p99_s": max((p["p99"] for p in lat),
                                     default=None),
                "breaker": None if lt.breaker is None else lt.breaker.state,
            }
            fleet_pending += snap["pending_points"]
        total = self._hits + self._misses
        return {
            "loaded": len(tenants), "max_loaded": self.max_loaded,
            "cache_hit_rate": (self._hits / total) if total else None,
            "evictions": self._evictions,
            "pending_points": fleet_pending,
            "tenants": tenants,
            "slo": self.slo.evaluate(self._registry),
        }
