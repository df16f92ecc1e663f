"""Burgers data assimilation (the JAX package's
``examples/burgers_assimilate.py``; reference
``examples/burgers-assimilate.py``).

A forward Burgers solve with a data-fit loss over NS=200 sparse
observations of the solution at t=0.76: ``compile_data`` adds a real
``Data`` loss term.
"""

import numpy as np

from _common import example_args, scaled

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import (CollocationSolverND, DomainND, IC,
                                    dirichletBC, grad)
from tensordiffeq_tpu_torch.exact import burgers_solution


def main():
    args = example_args("Burgers with data assimilation")

    x, t, usol = burgers_solution()

    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 256)
    domain.add("t", [0.0, 1.0], 100)
    domain.generate_collocation_points(scaled(args, 10_000, 1_000), seed=0)

    bcs = [IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]],
              n_values=60),
           dirichletBC(domain, val=0.0, var="x", target="upper"),
           dirichletBC(domain, val=0.0, var="x", target="lower")]

    def f_model(u, x, t):
        u_x, u_t = grad(u, "x"), grad(u, "t")
        u_xx = grad(u_x, "x")
        return u_t(x, t) + u(x, t) * u_x(x, t) - (0.05 / np.pi) * u_xx(x, t)

    # sparse observations: NS points at the single time slice t[75]
    NS = 200 if not args.quick else 40
    rng = np.random.RandomState(0)
    idx_xs = rng.choice(x.shape[0], NS, replace=False)
    it = 75
    x_s = x[idx_xs].reshape(-1, 1)
    t_s = np.full_like(x_s, t[it])
    y_s = usol[idx_xs, it].reshape(-1, 1)

    widths = [128] * 4 if not args.quick else [32] * 2
    solver = CollocationSolverND(assimilate=True, device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs)
    solver.compile_data(x_s, t_s, y_s)
    solver.fit(tf_iter=scaled(args, 10_000, 200),
               newton_iter=scaled(args, 1_000, 50))

    Xg = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u_pred, _ = solver.predict(Xg, best_model=True)
    # nu here is 0.05/pi (the reference's assimilation variant) while the
    # fixture solves nu=0.01/pi: L2 is indicative only; what matters is
    # that the Data loss is active and decreasing
    err = tdq.find_L2_error(u_pred, usol.reshape(-1, 1))
    data_losses = [rec["Data"] for rec in solver.losses if "Data" in rec]
    print(f"Error u (vs nu=0.01/pi fixture): {err:e}; "
          f"Data loss {data_losses[0]:.3e} -> {data_losses[-1]:.3e}")
    return solver


if __name__ == "__main__":
    main()
