"""Forward viscous Burgers PINN (the JAX package's ``examples/burgers.py``;
reference ``examples/burgers-new.py``).

u_t + u u_x = (0.01/pi) u_xx on x in [-1,1], t in [0,1];
u(x,0) = -sin(pi x), u(+-1,t) = 0.  Validates rel-L2 against the
Cole-Hopf solution.  The problem lives in the port's zoo (entry
``burgers``); this script resolves its config from there.

``--resample N``: redraw the N_f points every N Adam epochs toward where
|f| is large (the shock line here).
"""

from _common import example_args, fit_resumable, zoo_spec

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import zoo
from tensordiffeq_tpu_torch.exact import burgers_solution

ENTRY = zoo.get("burgers")


def main():
    args = example_args("Burgers shock forward PINN",
                        resample=(0, "redraw collocation points every N "
                                     "Adam epochs (0 = reference fixed set)"))
    spec = zoo_spec(ENTRY, args.quick)

    solver = zoo.build_solver(ENTRY, spec=spec, device=args.device)
    fit_resumable(solver, quick=args.quick, tf_iter=spec.budget.adam,
                  newton_iter=spec.budget.lbfgs,
                  resample_every=args.resample)

    ref = ENTRY.reference(spec)
    u_pred, _ = solver.predict(ref.X, best_model=True)
    err = tdq.find_L2_error(ref.compare(u_pred), ref.u)
    print(f"Error u: {err:e}")

    if args.plot:
        x, t, usol = burgers_solution()
        tdq.plotting.plot_solution_domain1D(
            solver, [x, t], ub=[1.0, 1.0], lb=[-1.0, 0.0], Exact_u=usol,
            save_path=f"{args.plot}/burgers.png", best_model=True)
    return err


if __name__ == "__main__":
    main()
