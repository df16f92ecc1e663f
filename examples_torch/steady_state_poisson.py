"""Steady-state Poisson equation with function-valued Dirichlet BCs (the
JAX package's ``examples/steady_state_poisson.py``; reference
``examples/steady-state-poisson.py``).

u_xx + u_yy = -sin(pi x) sin(pi y) on [0,1]^2; exact solution
sin(pi x) sin(pi y) / (2 pi^2).  Exercises ``FunctionDirichletBC`` (the
face values happen to be zero on the unit square's boundary, as in the
reference, but are computed from the user functions).
"""

import numpy as np
import torch

from _common import example_args, scaled

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import (CollocationSolverND, DomainND,
                                    dirichletBC, FunctionDirichletBC, grad)


def main():
    args = example_args("Poisson steady state")

    domain = DomainND(["x", "y"])
    domain.add("x", [0.0, 1.0], 11)
    domain.add("y", [0.0, 1.0], 11)
    domain.generate_collocation_points(scaled(args, 100, 100), seed=0)

    def func_upper_x(y):
        return -np.sin(np.pi * y) * np.sin(np.pi)

    def func_upper_y(x):
        return -np.sin(np.pi * x) * np.sin(np.pi)

    bcs = [FunctionDirichletBC(domain, fun=[func_upper_x], var="x",
                               target="upper", func_inputs=[["y"]],
                               n_values=10),
           dirichletBC(domain, val=0.0, var="x", target="lower"),
           FunctionDirichletBC(domain, fun=[func_upper_y], var="y",
                               target="upper", func_inputs=[["x"]],
                               n_values=10),
           dirichletBC(domain, val=0.0, var="y", target="lower")]

    def f_model(u, x, y):
        u_xx = grad(grad(u, "x"), "x")(x, y)
        u_yy = grad(grad(u, "y"), "y")(x, y)
        forcing = -torch.sin(np.pi * x) * torch.sin(np.pi * y)
        return u_xx + u_yy - forcing

    solver = CollocationSolverND(device=args.device)
    solver.compile([2, 16, 16, 1], f_model, domain, bcs)
    solver.fit(tf_iter=scaled(args, 4_000, 200))

    n = 101
    xv, yv = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    exact = np.sin(np.pi * xv) * np.sin(np.pi * yv) / (2 * np.pi ** 2)
    Xg = np.hstack([xv.reshape(-1, 1), yv.reshape(-1, 1)])
    u_pred, _ = solver.predict(Xg, best_model=True)
    err = tdq.find_L2_error(u_pred, exact.reshape(-1, 1))
    print(f"Error u: {err:e}")
    return err


if __name__ == "__main__":
    main()
