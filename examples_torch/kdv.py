"""Korteweg-de Vries single-soliton forward PINN (the JAX package's
``examples/kdv.py``: the fused engine's unmixed third-order path).

u_t + 6 u u_x + u_xxx = 0 on x in [-10, 10], t in [0, 1], with the exact
travelling soliton u(x, t) = (c/2) sech^2(sqrt(c)/2 (x - c t - x0)): the
initial condition and Dirichlet boundaries come from it, and the run
validates relative L2 against it on a grid.
"""

import numpy as np

from _common import example_args, fit_resumable, scaled

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import (CollocationSolverND, DomainND, IC, d,
                                    FunctionDirichletBC, grad)

C = 4.0     # soliton speed
X0 = -5.0   # initial crest position


def soliton(x, t):
    s = np.sqrt(C) / 2.0 * (x - C * t - X0)
    return C / 2.0 / np.cosh(s) ** 2


def main():
    args = example_args("KdV single-soliton forward PINN (3rd-order fused)",
                        nf=(0, "override N_f (0 = config default)"),
                        adam=(0, "override Adam iters (0 = config default)"),
                        newton=(0, "override L-BFGS iters (0 = config "
                                   "default)"))

    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-10.0, 10.0], 256)
    domain.add("t", [0.0, 1.0], 100)
    domain.generate_collocation_points(
        args.nf or scaled(args, 20_000, 1_500), seed=0)

    bcs = [IC(domain, [lambda x: soliton(x, 0.0)], var=[["x"]]),
           FunctionDirichletBC(domain, [lambda t: soliton(-10.0, t)],
                               var="x", target="lower",
                               func_inputs=[["t"]]),
           FunctionDirichletBC(domain, [lambda t: soliton(10.0, t)],
                               var="x", target="upper",
                               func_inputs=[["t"]])]

    def f_model(u, x, t):
        return (grad(u, "t")(x, t) + 6.0 * u(x, t) * grad(u, "x")(x, t)
                + d(u, "x", 3)(x, t))

    widths = [30] * 4 if not args.quick else [20] * 3
    solver = CollocationSolverND(device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs)
    assert solver._fused_residual is not None, "3rd-order path should fuse"
    fit_resumable(solver, quick=args.quick,
                  tf_iter=args.adam or scaled(args, 10_000, 200),
                  newton_iter=args.newton or scaled(args, 10_000, 100))

    x = domain.linspace("x")
    t = domain.linspace("t")
    Xg = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u_star = soliton(Xg[:, 0:1], Xg[:, 1:2])
    u_pred, _ = solver.predict(Xg, best_model=True)
    err = tdq.find_L2_error(u_pred, u_star)
    print(f"KdV soliton relative L2: {err:.3e}")
    return err


if __name__ == "__main__":
    main()
