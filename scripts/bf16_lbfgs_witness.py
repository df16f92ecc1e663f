"""The bf16 Adam -> L-BFGS run against the f32 one, in either package, from
the same weights and points.

AC-SA (the zoo's ``allen-cahn-sa``: u_t - 1e-4 u_xx + 5u^3 - 5u = 0, IC
x^2 cos(pi x), periodic (u, u_x), SA lambda on the residual and the IC) at
the width of its ``full`` size, 2-128x4-1 on the 512x201 grid, with
``--n-f`` collocation points.  Both packages draw the same points
(``generate_collocation_points``), the same SA lambda (NumPy), and start
from the same Glorot-normal weights drawn with NumPy from ``--seed``.  Each
run compiles ``fused`` (the JAX package: ``fused=True``, its XLA flavor
off the TPU; the port: ``fused="cuda"``, its kernels on the card and
their plain flavor on the CPU) with the minimax step, once in f32 and
once with ``fused_dtype="bfloat16"``, then ``fit(tf_iter)`` and
``fit(newton_iter)``.  Under ``fused_dtype`` the L-BFGS leg starts on the
bf16 loss and may retreat to the f32 one at a chunk boundary (every 100
iterations); whether it did is read from the solver (the port) or the
leg's stop message (the JAX package).

One JSON line per flavor goes to stdout and, with ``--out``, to a file:
the Adam leg's first and last loss, the L-BFGS leg's best, the retreat,
rel-L2 of the best model against the ETDRK4 reference, and the wall
seconds of each leg.

Usage (the JAX package runs on the CPU, the port on the card or the CPU):

    JAX_PLATFORMS=cpu python scripts/bf16_lbfgs_witness.py --impl jax \\
        --n-f 5000
    python scripts/bf16_lbfgs_witness.py --impl torch --device cuda \\
        --n-f 50000
"""
import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

WIDTHS = [2, 128, 128, 128, 128, 1]
GRID = (512, 201)


def ac_sa(pkg, n_f: int, seed: int):
    """The problem, built with ``pkg``'s own API (both packages share it)."""
    nx, nt = GRID
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)
    grad = pkg.grad

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [pkg.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                  var=[["x"]]),
           pkg.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    rng = np.random.RandomState(seed)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(n_f, 1)],
                            "BCs": [100.0 * rng.rand(nx, 1), None]})
    return domain, bcs, f_model, kw


def glorot(seed: int) -> list:
    """``[(W [in, out], b [out]), ...]``: Glorot-normal kernels, zero biases."""
    rng = np.random.RandomState(seed)
    return [(rng.normal(0.0, np.sqrt(2.0 / (fi + fo)), (fi, fo))
             .astype(np.float32), np.zeros(fo, np.float32))
            for fi, fo in zip(WIDTHS[:-1], WIDTHS[1:])]


def run_jax(args, fused_dtype):
    import jax.numpy as jnp

    import tensordiffeq_tpu as tdq
    from tensordiffeq_tpu.exact import allen_cahn_solution

    domain, bcs, f_model, kw = ac_sa(tdq, args.n_f, args.seed)
    s = tdq.CollocationSolverND(verbose=False)
    s.compile(WIDTHS, f_model, domain, bcs, fused=True,
              fused_dtype=fused_dtype, **kw)
    s.params = {"params": {
        f"Dense_{i}": {"kernel": jnp.asarray(W), "bias": jnp.asarray(b)}
        for i, (W, b) in enumerate(glorot(args.seed))}}
    engine = f"minimax-{s._minimax_kind}" if s._minimax_kind else "other"
    t0 = time.perf_counter()
    s.fit(tf_iter=args.tf_iter)
    t_adam = time.perf_counter() - t0
    adam = [float(r["Total Loss"]) for r in s.losses]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        s.fit(newton_iter=args.newton_iter)
    t_lbfgs = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    retreat = None
    for line in err.getvalue().splitlines():
        if "retreating" in line:
            retreat = int(line.split(" at iter ")[1].split(";")[0])
    x, t, usol = allen_cahn_solution()
    X = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u, _ = s.predict(X, best_model=True)
    return dict(engine=engine, adam=adam,
                lbfgs_best=float(s.min_loss["l-bfgs"]), retreat=retreat,
                rel_l2=float(tdq.find_L2_error(np.asarray(u),
                                               usol.reshape(-1, 1))),
                adam_s=t_adam, lbfgs_s=t_lbfgs)


def run_torch(args, fused_dtype):
    import torch

    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution

    domain, bcs, f_model, kw = ac_sa(tdqt, args.n_f, args.seed)
    s = tdqt.CollocationSolverND(verbose=False, device=args.device)
    s.compile(WIDTHS, f_model, domain, bcs, fused="cuda",
              fused_dtype=fused_dtype, **kw)
    s.net.load_layers([(torch.from_numpy(W), torch.from_numpy(b))
                       for W, b in glorot(args.seed)])
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    s.fit(tf_iter=args.tf_iter)
    sync()
    t_adam = time.perf_counter() - t0
    adam = [float(r["Total Loss"]) for r in s.losses]
    t0 = time.perf_counter()
    s.fit(newton_iter=args.newton_iter)
    sync()
    t_lbfgs = time.perf_counter() - t0
    x, t, usol = allen_cahn_solution()
    X = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u, _ = s.predict(X, best_model=True)
    return dict(engine=s.engine, adam=adam,
                lbfgs_best=float(s.min_loss["l-bfgs"]),
                retreat=s.lbfgs_retreat,
                rel_l2=float(tdqt.find_L2_error(u, usol.reshape(-1, 1))),
                adam_s=t_adam, lbfgs_s=t_lbfgs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the port's device (the JAX package: the CPU)")
    ap.add_argument("--n-f", type=int, default=5_000)
    ap.add_argument("--tf-iter", type=int, default=200)
    ap.add_argument("--newton-iter", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flavors", default="f32,bf16")
    ap.add_argument("--out", default=None, help="append the lines here")
    args = ap.parse_args()
    card = None
    if args.impl == "torch" and args.device == "cuda":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    run = run_jax if args.impl == "jax" else run_torch
    for flavor in args.flavors.split(","):
        res = run(args, None if flavor == "f32" else "bfloat16")
        adam = res.pop("adam")
        line = dict(impl=args.impl, device="cpu" if args.impl == "jax"
                    else args.device, card=card, n_f=args.n_f,
                    tf_iter=args.tf_iter, newton_iter=args.newton_iter,
                    seed=args.seed, flavor=flavor, adam_first=adam[0],
                    adam_last=adam[-1], **res)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
