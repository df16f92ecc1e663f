"""Allen-Cahn surrogate FACTORY: train a coefficient sweep as ONE captured
step -> export the artifact batch -> fleet-serve the members (the JAX
package's ``examples/ac_factory.py``).

The production workload where users ask for *their* diffusion coefficient
and the factory has already trained the neighborhood:

1. trains a family of Allen-Cahn surrogates over a sweep of diffusion
   coefficients θ with :class:`~tensordiffeq_tpu_torch.factory.
   SurrogateFactory` — per-member parameters, SA λ and Adam moments
   stacked along a member axis, one captured family step (K3 once per
   member on the card);
2. solo-trains TWO of the members as matched-seed references
   (``CollocationSolverND(seed = factory seed + m)`` with θ_m baked) and
   asserts each factory member tracks its reference;
3. exports the family as an artifact *batch*
   (:meth:`~tensordiffeq_tpu_torch.factory.SurrogateFactory.
   export_family`) and fleet-serves it in the same process via
   ``FleetRouter.register_family`` — asserting the served answers are
   bit-identical to each member's own direct engine, and that residual
   queries run on the member's lowered residual tape (K1's table, then
   the tape) with no f_model re-attached;
4. prints the factory's narrated telemetry trail.
"""

import os
import tempfile

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import grad

MIN_BUCKET, MAX_BUCKET = 64, 256


def f_model(u, x, t, th):
    """The family residual: Allen-Cahn with the diffusion coefficient θ
    as the family parameter."""
    u_xx = grad(grad(u, "x"), "x")
    u_t = grad(u, "t")
    uv = u(x, t)
    return u_t(x, t) - th * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv


def build_problem(n_f, nx, nt, seed=0):
    from tensordiffeq_tpu_torch import IC, DomainND, periodicBC

    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)

    def func_ic(x):
        return x ** 2 * np.cos(np.pi * x)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [IC(domain, [func_ic], var=[["x"]]),
           periodicBC(domain, ["x"], [deriv_model])]
    return domain, bcs


def main():
    args = example_args("Allen-Cahn surrogate factory: one captured family "
                        "step -> artifact batch -> fleet serving")
    from tensordiffeq_tpu_torch import (CollocationSolverND,
                                        SurrogateFactory, fleet, telemetry)
    from tensordiffeq_tpu_torch.factory.family import _as_theta
    from tensordiffeq_tpu_torch.ops.fused import crosscheck_residuals

    n_members = 4 if args.quick else 8
    n_f = scaled(args, 2048, 256)
    nx, nt = (128, 32) if not args.quick else (64, 16)
    widths = [32, 32] if not args.quick else [16, 16]
    epochs = scaled(args, 1000, 60)
    thetas = [1e-4 * (0.5 + m / (n_members - 1)) for m in range(n_members)]
    lam0 = np.ones((n_f, 1), np.float32)
    sa_kw = dict(Adaptive_type=1,
                 dict_adaptive={"residual": [True], "BCs": [False, False]},
                 init_weights={"residual": [lam0], "BCs": [None, None]})

    run_dir = os.path.join(tempfile.mkdtemp(), "factory_run")
    logger = telemetry.RunLogger(run_dir, config={"example": "ac_factory",
                                                 "members": n_members})
    tele = telemetry.TrainingTelemetry(logger=logger)

    # -- 1. the family, one captured step ---------------------------- #
    domain, bcs = build_problem(n_f, nx, nt)
    fac = SurrogateFactory([2, *widths, 1], f_model, domain, bcs,
                           thetas=thetas, seed=0, verbose=False,
                           device=args.device, **sa_kw)
    print(f"[factory] family of {n_members} members "
          f"({fac.engine} engine), θ ∈ [{thetas[0]:.2e}, {thetas[-1]:.2e}]")
    fac.fit(tf_iter=epochs, chunk=min(100, epochs), telemetry=tele,
            converge_loss=1.0)
    losses = fac.member_losses()
    print(f"[factory] {epochs} epochs: member losses "
          f"{np.array2string(losses, precision=3)}")
    assert np.isfinite(losses).all(), "a member diverged"
    assert not fac.frozen_at

    # -- 2. matched-seed solo references ------------------------------ #
    for m in (0, n_members - 1):
        d_m, bcs_m = build_problem(n_f, nx, nt)
        th = _as_theta(thetas[m], "cpu")
        solo = CollocationSolverND(verbose=False, seed=m, device=args.device)
        solo.compile([2, *widths, 1],
                     lambda u, x, t, _t=th: f_model(u, x, t, _t),
                     d_m, bcs_m, **sa_kw)
        solo.fit(tf_iter=epochs, chunk=min(100, epochs))
        hist_m = np.array([float(r["Total Loss"][m]) for r in fac.losses])
        hist_s = np.array([r["Total Loss"] for r in solo.losses])
        drift = float(np.max(np.abs(hist_m - hist_s)
                             / np.maximum(np.abs(hist_s), 1e-9)))
        print(f"[crosscheck] member {m} vs solo reference: "
              f"max rel loss drift {drift:.2e}")
        assert drift < 5e-2, (m, drift)

    # -- 3. artifact batch -> fleet ----------------------------------- #
    fam_dir = os.path.join(tempfile.mkdtemp(), "family")
    manifest = fac.export_family(fam_dir, min_bucket=MIN_BUCKET,
                                 max_bucket=MAX_BUCKET)
    print(f"[export] {len(manifest['members'])} member artifacts "
          f"-> {fam_dir}")
    router = fleet.FleetRouter(max_loaded=n_members, device=args.device)
    names = router.register_family(
        fam_dir, policy=fleet.TenantPolicy(min_bucket=MIN_BUCKET,
                                           max_bucket=MAX_BUCKET))
    rng = np.random.RandomState(0)
    Xq = np.stack([rng.uniform(-1, 1, 64),
                   rng.uniform(0, 1, 64)], -1).astype(np.float32)
    for m in (0, n_members - 1):
        served = np.asarray(router.query(names[m], Xq))
        direct = fac.member_surrogate(m).engine(min_bucket=MIN_BUCKET,
                                                max_bucket=MAX_BUCKET)
        assert np.array_equal(served, np.asarray(direct.u(Xq))), m
        # residual through the lowered tape — no f_model needed — within
        # the cross-check band of the generic program
        res = np.asarray(router.query(names[m], Xq, kind="residual"))
        assert np.isfinite(res).all()
        ok, why = crosscheck_residuals(direct.residual(Xq), res)
        assert ok, (m, why)
    print(f"[fleet] {len(names)} tenants served; member answers "
          "bit-identical to their direct engines, residual kind from the "
          "lowered tape")

    # -- 4. the narrated trail ---------------------------------------- #
    logger.close()
    print(telemetry.report(run_dir))


if __name__ == "__main__":
    main()
