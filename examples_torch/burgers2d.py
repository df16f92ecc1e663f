"""2-D + time Burgers-type equation (the JAX package's
``examples/burgers2d.py``; reference ``examples/testing.py``).

u_t + u u_x = nu u_xx on (x, y) in [-1,1]^2, t in [0,1], with
u(x,y,0) = -sin(pi x) - sin(pi y) and periodic BCs (value, first and
second derivatives) in both spatial variables: the 3-input path, the
multi-variable periodic BC and higher-derivative matching.
"""

import numpy as np

from _common import example_args, fit_resumable, scaled

from tensordiffeq_tpu_torch import (CollocationSolverND, DomainND, IC, grad,
                                    periodicBC)


def main():
    args = example_args(
        "2D+time Burgers-type PDE",
        nf=(0, "override N_f (0 = config default)"),
        adam=(0, "override Adam iters (0 = config default)"),
        newton=(0, "override L-BFGS iters (0 = config default)"),
        width=(0, "override hidden width (0 = config default)"))

    domain = DomainND(["x", "y", "t"], time_var="t")
    fid = 256 if not args.quick else 24
    domain.add("x", [-1.0, 1.0], fid)
    domain.add("y", [-1.0, 1.0], fid)
    domain.add("t", [0.0, 1.0], 100 if not args.quick else 11)
    domain.generate_collocation_points(args.nf or scaled(args, 20_000, 1_500),
                                       seed=0)

    def func_ic_xy(x, y):
        return -np.sin(np.pi * x) - np.sin(np.pi * y)

    def deriv_model(u, x, y, t):
        u_x, u_y = grad(u, "x"), grad(u, "y")
        return (u(x, y, t), u_x(x, y, t), u_y(x, y, t),
                grad(u_x, "x")(x, y, t), grad(u_y, "y")(x, y, t),
                grad(u_x, "y")(x, y, t), grad(u_y, "x")(x, y, t))

    bcs = [IC(domain, [func_ic_xy], var=[["x", "y"]]),
           periodicBC(domain, ["x", "y"], [deriv_model, deriv_model])]

    def f_model(u, x, y, t):
        u_x = grad(u, "x")
        u_xx = grad(u_x, "x")
        u_t = grad(u, "t")
        return (u_t(x, y, t) + u(x, y, t) * u_x(x, y, t)
                - (0.05 / np.pi) * u_xx(x, y, t))

    w = args.width or (128 if not args.quick else 24)
    widths = [w] * (4 if not args.quick else 2)
    solver = CollocationSolverND(device=args.device)
    solver.compile([3, *widths, 1], f_model, domain, bcs)
    fit_resumable(solver, quick=args.quick,
                  tf_iter=args.adam or scaled(args, 1_000, 100),
                  newton_iter=args.newton or scaled(args, 1_000, 50))
    print(f"final loss: {solver.losses[-1]['Total Loss']:.4e}")
    return solver


if __name__ == "__main__":
    main()
