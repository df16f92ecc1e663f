"""Allen-Cahn closed loop: serve a surrogate family -> inject parameter
drift -> autonomous drift-triggered retrain -> zero-downtime hot-swap,
with one corrupted v2 member survived by bit-validated rollback (the JAX
package's ``examples/ac_closedloop.py``).

The train -> serve -> monitor -> retrain loop with no operator in it.
This script

1. trains a small Allen-Cahn coefficient family
   (:class:`~tensordiffeq_tpu_torch.factory.SurrogateFactory`), exports
   the v1 artifact batch and fleet-serves every member through a
   :class:`~tensordiffeq_tpu_torch.fleet.FleetRouter`, with a
   :class:`~tensordiffeq_tpu_torch.fleet.DriftMonitor` shadow-sampling the
   live ``u`` traffic through the engines' residual rungs, captured at
   load;
2. under a chaos scope, deterministically injects parameter drift into
   one tenant's SERVED tensors, in place (``drift_inject`` — silent
   numeric rot on a live replica: the rungs' graphs replay on the drifted
   values, nothing is captured again) and serves traffic until the
   monitor's ``residual_drift`` SLO objective trips;
3. lets the :class:`~tensordiffeq_tpu_torch.fleet.RetrainController` run
   the whole cycle autonomously: factory retrain warm-started from the
   live members' (drifted) served parameters (K3 once per member per
   family step on the card), v2 export, canary validation of every
   candidate against the pinned probe set, and an atomic per-tenant route
   flip with ZERO request-time captures — while chaos tears one v2
   member's artifact payload (``swap_corrupt_member``), so the swap must
   ship without that member: the checksum rejects the torn blob, the old
   engine keeps serving, and the rollback is proven bit-identical by
   probe replay;
4. prints the narrated telemetry report — the DRIFT / RETRAIN / CANARY /
   SWAPPED / ROLLED BACK trail an operator reads after the fact.
"""

import os
import tempfile

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import (IC, DomainND, SurrogateFactory, fleet,
                                    grad, periodicBC, telemetry)
from tensordiffeq_tpu_torch.resilience import Chaos

MIN_BUCKET, MAX_BUCKET = 64, 512


def f_model(u, x, t, th):
    u_xx = grad(grad(u, "x"), "x")
    u_t = grad(u, "t")
    uv = u(x, t)
    return u_t(x, t) - th * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv


def main():
    args = example_args(
        "Allen-Cahn closed loop: drift-triggered factory retrain + "
        "zero-downtime hot-swap, chaos-proven")
    quick = args.quick

    n_f = scaled(args, 10_000, 512)
    nx, nt = (256, 101) if not quick else (64, 16)
    layers = [2] + ([64] * 3 if not quick else [16] * 2) + [1]
    pre_iters = scaled(args, 600, 40)
    retrain_iters = scaled(args, 600, 40)
    chunk = scaled(args, 100, 20)
    thetas = [0.0008, 0.0010, 0.0012][: 2 if quick else 3]
    corrupt_member = 1

    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=0)

    def func_ic(x):
        return x ** 2 * np.cos(np.pi * x)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    def build_factory(init_params=None):
        bcs = [IC(domain, [func_ic], var=[["x"]]),
               periodicBC(domain, ["x"], [deriv_model])]
        return SurrogateFactory(layers, f_model, domain, bcs, thetas,
                                init_params=init_params, verbose=False,
                                device=args.device)

    # -- v1: train the family, export, fleet-serve, monitor ------------- #
    work = tempfile.mkdtemp(prefix="tdq_closedloop_")
    run_dir = os.path.join(work, "run")
    factory = build_factory()
    factory.fit(tf_iter=pre_iters, chunk=chunk)
    v1 = os.path.join(work, "v1")
    factory.export_family(v1, min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
    print(f"[v1] {factory.n_members}-member family trained "
          f"({pre_iters} epochs) and exported -> {v1}")

    with telemetry.RunLogger(run_dir, config={"example": "ac_closedloop"}):
        router = fleet.FleetRouter(max_loaded=len(thetas) + 1,
                                   device=args.device)
        policy = fleet.TenantPolicy(min_bucket=MIN_BUCKET,
                                    max_bucket=MAX_BUCKET, max_batch=512,
                                    max_latency_s=0.005)
        members = router.register_family(
            v1, policy=policy, prefix="ac",
            f_models={m: factory.member_f_model(m)
                      for m in range(len(thetas))})
        monitor = fleet.DriftMonitor(router, sample_fraction=0.5,
                                     window=2, seed=0)
        rng = np.random.RandomState(0)

        def draw(n):
            return np.stack([rng.uniform(-1, 1, n),
                             rng.uniform(0, 1, n)], -1).astype(np.float32)

        probe = draw(MIN_BUCKET)
        for tenant in members.values():
            router.load(tenant)
            monitor.attach(tenant, probe)
        print(f"[serve] {len(members)} tenants live; monitoring "
              f"(sample 50%, threshold "
              f"{monitor.slo.max_residual_drift:g}x baseline)")

        reg = telemetry.default_registry()

        def compiles():
            return sum(v for k, v in reg.as_dict()["counters"].items()
                       if k.startswith("serving.engine.compiles"))

        # pre-drift snapshot of the member that will be corrupted in v2:
        # its OLD engine must keep serving bit-identically throughout
        victim = members[corrupt_member]
        u_victim_before = router.query(victim, probe)

        # -- the chaotic cycle: drift + a torn v2 member ---------------- #
        chaos = Chaos(drift_inject=0.6, swap_corrupt_member=corrupt_member,
                      seed=0)
        with chaos:
            served = 0
            pre_drift = compiles()
            while not monitor.tripped() and served < 200:
                tenant = list(members.values())[served % len(members)]
                monitor.query(tenant, draw(int(rng.randint(1, 17))))
                served += 1
            assert monitor.tripped(), "drift was injected but never tripped"
            assert compiles() - pre_drift == 0, \
                "the drift injection captured at request time"
            print(f"[drift] injected into {list(monitor.tripped())}; "
                  f"tripped after {served} live queries at "
                  f"{max(monitor.drift(t) or 0 for t in members.values()):.1f}x "
                  "baseline")

            controller = fleet.RetrainController(
                router, monitor, build_factory, members,
                retrain_iters=retrain_iters, chunk=chunk,
                resample_every=0 if quick else chunk, gate_ratio=5.0,
                export_kw=dict(min_bucket=MIN_BUCKET,
                               max_bucket=MAX_BUCKET),
                workdir=work, verbose=False)
            cycle = controller.run_cycle()
        assert chaos.fired["drift_inject"] == 1
        assert chaos.fired["swap_corrupt"] == 1, \
            "the v2 member artifact was never torn"

        # -- verdicts: swap shipped WITHOUT the corrupted member -------- #
        swapped = {v["tenant"] for v in cycle["swapped"]}
        rolled = {v["tenant"]: v for v in cycle["rolled_back"]}
        assert victim in rolled, "the torn member was not rejected"
        assert rolled[victim]["reason"] == "artifact_rejected", rolled
        assert rolled[victim]["bit_identical"], \
            "old engine's probe replay changed across the rollback"
        assert swapped, "no healthy member was swapped"
        # the drift lands on the FIRST tenant probed (ac000), never the
        # victim — so the victim's old engine must answer bit-identically
        # across the whole cycle, torn v2 artifact and all
        pre = compiles()
        u_victim_after = router.query(victim, probe)
        assert np.array_equal(u_victim_before, u_victim_after), \
            "the rolled-back tenant's answers changed"
        for tenant in members.values():
            router.query(tenant, draw(16))
            router.query(tenant, draw(16), kind="residual")
        assert compiles() - pre == 0, \
            "the swapped fleet captured at request time"
        print(f"[swap] {len(swapped)} tenant(s) cut over "
              f"(generations={cycle['generations']}, retrain "
              f"{cycle['retrain_wall_s']:.1f}s); {victim} rolled back to "
              "its old engine (torn artifact -> checksum rejection, "
              "bit-identical replay); 0 request-time captures")

    print(telemetry.report(run_dir))


if __name__ == "__main__":
    main()  # plain call: the example tests run this in-process via runpy
