"""Nonlinear Schrödinger, the classical 2-output PINN benchmark (the JAX
package's ``examples/schrodinger.py``; Raissi et al. 2019 §3.1.1).

``i h_t + 0.5 h_xx + |h|^2 h = 0`` on x in [-5, 5], t in [0, pi/2], with
``h(x, 0) = 2 sech(x)`` and periodic BCs (value + first derivative) in x.
The network has two outputs, h = u + iv, and the tuple-returning
``f_model`` adopts the fused minimax step as a two-equation system (K3
with E = 2 on the card).  The problem lives in the port's zoo (entry
``schrodinger``); truth is the split-step Fourier solution in
``tensordiffeq_tpu_torch.exact``.
"""

import dataclasses

import numpy as np

from _common import example_args, fit_resumable, zoo_spec

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import zoo
from tensordiffeq_tpu_torch.exact import schrodinger_solution

ENTRY = zoo.get("schrodinger")


def evaluate(solver, args, name):
    x, t, h = schrodinger_solution()
    Xg = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    pred, _ = solver.predict(Xg, best_model=True)
    h_pred = np.sqrt(pred[:, 0] ** 2 + pred[:, 1] ** 2)
    h_true = np.abs(h).reshape(-1)
    err = tdq.find_L2_error(h_pred, h_true)
    print(f"Error u: {err:e}  (rel-L2 of |h|)")
    if args.plot:
        tdq.plotting.plot_solution_domain1D(
            solver, [x, t], ub=[5.0, float(np.pi / 2)], lb=[-5.0, 0.0],
            Exact_u=np.abs(h), save_path=f"{args.plot}/{name}.png",
            component="abs", best_model=True)
    return err


def main():
    args = example_args(
        "Nonlinear Schrödinger 2-output PINN",
        nf=(0, "override N_f (0 = zoo-entry default)"),
        adam=(0, "override Adam iters (0 = zoo-entry default)"),
        newton=(0, "override L-BFGS iters (0 = zoo-entry default)"),
        width=(0, "override hidden width (0 = zoo-entry default)"))
    spec = zoo_spec(ENTRY, args.quick, n_f=args.nf)
    if args.width:
        spec = dataclasses.replace(
            spec, widths=(args.width,) * len(spec.widths))
    if args.adam or args.newton:
        spec = dataclasses.replace(
            spec, budget=zoo.Budget(args.adam or spec.budget.adam,
                                    args.newton or spec.budget.lbfgs))

    solver = zoo.build_solver(ENTRY, spec=spec, device=args.device)
    fit_resumable(solver, quick=args.quick, tf_iter=spec.budget.adam,
                  newton_iter=spec.budget.lbfgs)
    return evaluate(solver, args, "schrodinger")


if __name__ == "__main__":
    main()
