"""Allen-Cahn fleet serving: train TWO surrogates -> export fleet
artifacts -> serve both, multi-tenant, in a FRESH process (the JAX
package's ``examples/ac_fleet.py``).

A deployment hosts many trained surrogates at once, and a fresh replica
must answer its first query without capturing anything.  This script

1. trains two short SA runs (different seeds — two tenants of the same
   PDE family) and exports each with
   :func:`tensordiffeq_tpu_torch.fleet.export_fleet_artifact`: the
   artifact carries the pad-to-bucket ladder spec plus the residual
   lowered to its pointwise tape;
2. re-invokes itself as a subprocess (``--serve dirA,dirB``) so the fleet
   restore genuinely happens in a fresh process;
3. in that process, a :class:`~tensordiffeq_tpu_torch.fleet.FleetRouter`
   hot-loads both tenants (tenant "b" deliberately gets NO f_model — its
   residual queries run on the artifact's tape: K1's table, then the
   tape, captured as each rung's graph), proves the warm start left ZERO
   captures to request time via the engine's per-bucket counters, serves
   mixed u/residual traffic through per-tenant batchers behind admission
   control, sheds a deliberate burst over tenant "b"'s rate limit as
   structured :class:`~tensordiffeq_tpu_torch.fleet.AdmissionRejected`,
   and checks fleet answers bit-identical against direct
   :class:`~tensordiffeq_tpu_torch.serving.InferenceEngine` s;
4. prints the run's narrated telemetry report — the FLEET / WARM START /
   ADMISSION trail an operator would read after the fact.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import grad

MIN_BUCKET, MAX_BUCKET = 64, 1024


def f_model(u, x, t):
    u_xx = grad(grad(u, "x"), "x")
    u_t = grad(u, "t")
    uv = u(x, t)
    return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv


def serve(artifacts: str, quick: bool, device: str):
    """The fresh-process half: fleet-serve the exported artifacts."""
    from tensordiffeq_tpu_torch import fleet, telemetry
    from tensordiffeq_tpu_torch.ops.fused import crosscheck_residuals
    from tensordiffeq_tpu_torch.serving import Surrogate

    art_a, art_b = artifacts.split(",")
    run_dir = os.path.join(tempfile.mkdtemp(), "fleet_run")
    with telemetry.RunLogger(run_dir, config={"example": "ac_fleet"}), \
            telemetry.Tracer():
        router = fleet.FleetRouter(max_loaded=2, device=device)
        policy = fleet.TenantPolicy(min_bucket=MIN_BUCKET,
                                    max_bucket=MAX_BUCKET,
                                    max_batch=512, max_latency_s=0.005)
        router.register("a", art_a, f_model=f_model, policy=policy)
        # tenant "b" gets NO f_model: its residual queries must run on the
        # artifact's lowered tape
        router.register("b", art_b, policy=fleet.TenantPolicy(
            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, max_batch=512,
            max_latency_s=0.005, rate_qps=5.0, burst=3.0, priority=0))

        # -- warm start: zero captures at request time ----------------- #
        reg = telemetry.default_registry()

        def compiles():
            return sum(v for k, v in reg.as_dict()["counters"].items()
                       if k.startswith("serving.engine.compiles"))

        lt = router.load("a")
        print(f"[fleet] loaded tenant a: {lt.warm['aot']} tape + "
              f"{lt.warm['jit']} own programs captured in "
              f"{lt.warm['wall_s']:.2f}s")
        before = compiles()
        rng = np.random.RandomState(0)

        def draw(n):
            return np.stack([rng.uniform(-1, 1, n),
                             rng.uniform(0, 1, n)], -1).astype(np.float32)

        Xq = draw(200)
        u_a = router.query("a", Xq)
        assert compiles() - before == 0, \
            "warm-started tenant captured at request time"
        print("[fleet] first query served with 0 request-time captures")

        # -- the query left a COMPLETE span tree in events.jsonl -------- #
        spans = telemetry.tracing.read_spans(run_dir)
        trees = telemetry.tracing.span_tree(spans)
        [req] = [r for group in trees.values() for r in group
                 if r["name"] == "fleet.request"]

        def names(node, acc):
            acc.add(node["name"])
            for c in node["children"]:
                names(c, acc)
            return acc

        got = names(req, set())
        for expected in ("fleet.request", "fleet.submit",
                         "fleet.admission", "fleet.load",
                         "serving.batcher.enqueue",
                         "serving.batcher.flush", "serving.engine.run",
                         "serving.engine.dispatch",
                         "serving.engine.device"):
            assert expected in got, \
                f"span {expected!r} missing from the request trace {got}"
        print(f"[fleet] request trace {req['trace']}: "
              f"{len(got)} span kinds, admission -> engine dispatch, "
              f"{req['dur_s'] * 1e3:.1f}ms end to end")

        # -- mixed multi-tenant traffic --------------------------------- #
        lt_b = router.load("b")
        print(f"[fleet] loaded tenant b (no f_model): {lt_b.warm['aot']} "
              f"tape + {lt_b.warm['jit']} own programs captured in "
              f"{lt_b.warm['wall_s']:.2f}s")
        before = compiles()
        n_req = 40 if quick else 400
        rejected = 0
        for i in range(n_req):
            tenant = "ab"[i % 2]
            kind = "residual" if i % 3 == 0 else "u"
            try:
                router.submit(tenant, draw(int(rng.randint(1, 17))),
                              kind=kind)
            except fleet.AdmissionRejected as e:
                rejected += 1
                assert e.tenant == "b" and e.reason == "rate_limit"
            router.poll()
        router.flush()
        assert rejected > 0, "tenant b's rate limit never shed"
        assert compiles() - before == 0, \
            "mixed traffic captured at request time"
        sig = router.autoscale_signals()
        print(f"[fleet] {n_req} submits over 2 tenants, {rejected} shed "
              f"(tenant b rate limit); cache hit rate "
              f"{sig['cache_hit_rate']:.2f}")
        for t, d in sorted(sig["tenants"].items()):
            print(f"[fleet]   tenant {t}: qps={d['qps']:.0f} "
                  f"p99={1e3 * (d['latency_p99_s'] or 0):.1f}ms")

        # -- bit-identity + the tape residual without f_model ----------- #
        direct = Surrogate.load(art_a, f_model=f_model, device=device).engine(
            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
        assert np.array_equal(u_a, direct.u(Xq)), \
            "fleet u differs from the direct engine"
        # tenant b's token bucket may still be drained by the traffic
        # loop — wait out the structured backpressure hint (bounded)
        for _ in range(40):
            try:
                f_b = router.query("b", Xq, kind="residual")  # no f_model
                break
            except fleet.AdmissionRejected as e:
                time.sleep(max(e.retry_after_s, 0.05))
        else:
            raise AssertionError("tenant b's rate budget never refilled")
        # the same artifact, loaded and warm-started alike: bit for bit
        twin = Surrogate.load(art_b, device=device).engine(
            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
        fleet.warm_start(twin)
        assert np.array_equal(f_b, twin.residual(Xq)), \
            "the tape residual differs from the direct engine's"
        # and the generic program (f_model attached) within the band
        generic = Surrogate.load(art_b, f_model=f_model,
                                 device=device).engine(
            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
        ok, why = crosscheck_residuals(generic.residual(Xq), f_b)
        assert ok, why
        print("[fleet] fleet answers bit-identical to direct engines "
              "(tenant b's residual served with NO f_model, from the "
              "tape; within the cross-check band of the generic program)")

    print(telemetry.report(run_dir))


def main():
    args = example_args(
        "Allen-Cahn fleet: two surrogates -> fleet export -> fresh-process "
        "multi-tenant serving",
        serve=("", "internal: fleet-serve these comma-separated artifact "
                   "dirs (the fresh-process half; invoked automatically)"))
    if args.serve:
        return serve(args.serve, args.quick, args.device)

    from ac_baseline import build_sa_solver

    from tensordiffeq_tpu_torch import fleet

    n_f = scaled(args, 20_000, 1_000)
    nx, nt = (256, 101) if not args.quick else (64, 21)
    widths = [64] * 3 if not args.quick else [16] * 2
    root = tempfile.mkdtemp()
    artifacts = []
    for name, seed in (("a", 0), ("b", 1)):
        solver = build_sa_solver(n_f, nx, nt, widths, seed=seed,
                                 device=args.device)
        solver.fit(tf_iter=scaled(args, 1_000, 50))
        art = os.path.join(root, f"ac_{name}")
        fleet.export_fleet_artifact(
            solver.export_surrogate(), art,
            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
        artifacts.append(art)
        print(f"[train] exported fleet artifact {name} -> {art}")

    # the restore must survive a genuinely fresh process: no solvers, no
    # domains, no captured state — only the artifacts (and f_model for "a")
    cmd = [sys.executable, os.path.abspath(__file__),
           "--serve", ",".join(artifacts), "--device", args.device]
    if args.quick:
        cmd.append("--quick")
    return subprocess.run(cmd, check=True, cwd=os.path.dirname(
        os.path.abspath(__file__))).returncode


if __name__ == "__main__":
    main()  # plain call: the example tests run this in-process via runpy
