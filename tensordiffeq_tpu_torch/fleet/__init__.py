"""Multi-tenant serving fleet: LRU artifact cache, admission control,
warm start, replicated serving and the closed drift → retrain → hot-swap
loop (the JAX package's ``fleet/``).

``serving/`` deploys ONE surrogate; this package deploys MANY.  A
:class:`FleetRouter` hot-loads surrogate artifacts behind a bounded LRU
cache (an evicted engine drops its CUDA graphs; a reload goes through the
checksum-validated checkpoint restore and carries the engine's bucket
quarantine across), gives every tenant its own coalescing batchers with
their own retry/breaker/deadline policy (:class:`TenantPolicy`), sheds
overload at the front door with a structured :class:`AdmissionRejected`
(:class:`AdmissionController`: token-bucket rate limits, queue bounds,
priority-ordered load shedding), and moves a fresh replica's first-touch
costs to ``load()`` (:func:`export_fleet_artifact` / :func:`warm_start`:
the kernel library built once per source digest, every rung's graph
captured at load, and the residual served from the artifact's lowered
tape through K1 when no ``f_model`` is attached).  Autoscaling signals
publish through the shared telemetry registry
(:meth:`FleetRouter.autoscale_signals`).

:mod:`~tensordiffeq_tpu_torch.fleet.replica` replicates the serving
plane: a :class:`ReplicaGroup` of router processes under the
serving-mode :class:`~tensordiffeq_tpu_torch.resilience.ClusterSupervisor`
behind a rendezvous-hashing :class:`FrontRouter`.
:mod:`~tensordiffeq_tpu_torch.fleet.closedloop` closes the loop: a
:class:`DriftMonitor` trips the ``residual_drift`` SLO from shadow
probes, a :class:`RetrainController` retrains the family warm-started
from the served parameters (K3 once per member per family step on the
card) and :meth:`FleetRouter.hot_swap` flips each tenant behind a
canary.

Typical flow::

    # train side, once per tenant:
    from tensordiffeq_tpu_torch import fleet
    fleet.export_fleet_artifact(solver.export_surrogate(), "runs/ac",
                                min_bucket=64, max_bucket=4096)

    # serving replica (fresh process, the card):
    router = fleet.FleetRouter(max_loaded=8)
    router.register("ac", "runs/ac",
                    policy=fleet.TenantPolicy(min_bucket=64,
                                              max_bucket=4096,
                                              rate_qps=500.0))
    router.load("ac")                    # warm start: no capture at
    u = router.query("ac", X)            # request time from here on
"""

from .admission import (PRIORITIES, AdmissionController,  # noqa: F401
                        AdmissionRejected)
from .closedloop import DriftMonitor, RetrainController  # noqa: F401
from .replica import (FrontRouter, ReplicaGroup,  # noqa: F401
                      ReplicaRequestError, ReplicaServer,
                      ReplicaUnavailable, decode_array, encode_array)
from .router import (FleetRouter, LoadedTenant,  # noqa: F401
                     TenantEvicted, TenantPolicy)
from .warmstart import (AOT_SUBDIR, DEFAULT_KINDS,  # noqa: F401
                        export_fleet_artifact, warm_start)
