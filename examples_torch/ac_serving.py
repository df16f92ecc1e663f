"""Allen-Cahn serving: train -> export -> restore in a fresh process ->
batched grid and derivative queries (the JAX package's
``examples/ac_serving.py``).

1. trains a short SA run (``ac_baseline.build_sa_solver``) and exports it:
   ``solver.export_surrogate().save(dir)``;
2. re-invokes itself as a subprocess (``--serve <dir>``), so the restore
   happens in a fresh process with no solver, no domain and no training
   state in scope;
3. there, serves batched queries through the ``InferenceEngine``: ``u``
   over the grid, first and second derivatives, the PDE residual, and
   recombines the derivative queries into the residual by hand, which must
   match ``engine.residual`` to float tolerance;
4. coalesces a burst of small point queries through the
   ``RequestBatcher`` and prints its QPS and latency percentiles.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import grad


def f_model(u, x, t):
    u_xx = grad(grad(u, "x"), "x")
    u_t = grad(u, "t")
    uv = u(x, t)
    return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv


def serve(artifact: str, quick: bool, device: str):
    """The fresh-process half: restore the artifact and query it batched."""
    from tensordiffeq_tpu_torch import find_L2_error
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.serving import RequestBatcher, Surrogate

    sur = Surrogate.load(artifact, f_model=f_model, device=device)
    engine = sur.engine(min_bucket=64, max_bucket=4096 if quick else 1 << 17)
    print(f"[serve] restored {artifact}: vars={sur.varnames}, "
          f"layers={sur.layer_sizes}, buckets={engine.bucket_sizes}")

    x, t, usol = allen_cahn_solution()
    if quick:
        x, t, usol = x[::8], t[::8], usol[::8, ::8]
    Xg = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)

    u = engine.u(Xg)
    print(f"[serve] u over the {usol.shape} grid: rel-L2 = "
          f"{find_L2_error(u, usol.reshape(-1, 1)):.3e} "
          f"(short training run; fit quality is ac_sa.py's job)")

    u_t = engine.derivative(Xg, "t")
    u_xx = engine.derivative(Xg, "x", order=2)
    f = engine.residual(Xg)
    uv = u[:, 0]
    by_hand = u_t - 0.0001 * u_xx + 5.0 * uv ** 3 - 5.0 * uv
    gap = float(np.max(np.abs(by_hand - f)))
    print(f"[serve] residual: mean|f| = {np.abs(f).mean():.3e}; "
          f"recombined from derivative queries to within {gap:.2e}")
    assert gap < 1e-4, "derivative queries disagree with engine.residual"

    rng = np.random.RandomState(0)
    batcher = RequestBatcher(engine, max_batch=512, max_latency_s=0.005)
    handles = [batcher.submit(
        np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n)], -1))
        for n in rng.randint(1, 17, size=100)]
    batcher.flush()
    assert all(h.done for h in handles)
    s = batcher.stats()
    print(f"[serve] batcher: {s['requests']} requests -> {s['batches']} "
          f"device batches, {s['qps']:.0f} QPS, "
          f"p99 = {s['latency_s']['p99'] * 1e3:.1f} ms")
    print(f"[serve] compile cache: {engine.compile_cache_size} programs "
          f"(bound: kinds x {engine.n_buckets} buckets)")


def main():
    args = example_args(
        "Allen-Cahn serving: train -> export -> fresh-process restore",
        serve=("", "internal: restore and serve this artifact dir "
                   "(the fresh-process half; invoked automatically)"))
    if args.serve:
        return serve(args.serve, args.quick, args.device)

    from ac_baseline import build_sa_solver

    n_f = scaled(args, 50_000, 2_000)
    nx, nt = (512, 201) if not args.quick else (64, 21)
    widths = [128] * 4 if not args.quick else [32] * 2
    solver = build_sa_solver(n_f, nx, nt, widths, seed=0, device=args.device)
    solver.fit(tf_iter=scaled(args, 2_000, 100))

    artifact = os.path.join(tempfile.mkdtemp(), "ac_surrogate")
    solver.export_surrogate().save(artifact)
    print(f"[train] exported surrogate -> {artifact}")

    # the restore must survive a fresh process: only the artifact and the
    # f_model source
    cmd = [sys.executable, os.path.abspath(__file__), "--serve", artifact,
           "--device", args.device]
    if args.quick:
        cmd.append("--quick")
    return subprocess.run(cmd, check=True, cwd=os.path.dirname(
        os.path.abspath(__file__))).returncode


if __name__ == "__main__":
    sys.exit(main() or 0)
