"""Steady-state Helmholtz equation (the JAX package's
``examples/steady_state_helmholtz.py``; reference
``examples/steady-state.py``).

u_xx + u_yy + k^2 u = forcing on [-1,1]^2 with homogeneous Dirichlet BCs,
the forcing chosen so that the exact solution is sin(pi x) sin(4 pi y).
No time variable: a pure boundary-value problem.
"""

import numpy as np
import torch

from _common import example_args, scaled

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import (CollocationSolverND, DomainND,
                                    dirichletBC, grad)


def main():
    args = example_args("Helmholtz steady state")
    a1, a2, ksq = 1.0, 4.0, 1.0

    domain = DomainND(["x", "y"])
    fid = 1001 if not args.quick else 64
    domain.add("x", [-1.0, 1.0], fid)
    domain.add("y", [-1.0, 1.0], fid)
    domain.generate_collocation_points(scaled(args, 10_000, 1_000), seed=0)

    bcs = [dirichletBC(domain, val=0.0, var=v, target=tg)
           for v in ("x", "y") for tg in ("upper", "lower")]

    def f_model(u, x, y):
        u_xx = grad(grad(u, "x"), "x")(x, y)
        u_yy = grad(grad(u, "y"), "y")(x, y)
        pi = np.pi
        s = torch.sin(a1 * pi * x) * torch.sin(a2 * pi * y)
        forcing = (-(a1 * pi) ** 2 * s - (a2 * pi) ** 2 * s + ksq * s)
        return u_xx + u_yy + ksq * u(x, y) - forcing

    widths = [50] * 4 if not args.quick else [32] * 2
    solver = CollocationSolverND(device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs)
    solver.fit(tf_iter=scaled(args, 10_000, 200),
               newton_iter=scaled(args, 10_000, 100))

    n = 201
    xv, yv = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    exact = np.sin(a1 * np.pi * xv) * np.sin(a2 * np.pi * yv)
    Xg = np.hstack([xv.reshape(-1, 1), yv.reshape(-1, 1)])
    u_pred, _ = solver.predict(Xg, best_model=True)
    err = tdq.find_L2_error(u_pred, exact.reshape(-1, 1))
    print(f"Error u: {err:e}")
    return err


if __name__ == "__main__":
    main()
