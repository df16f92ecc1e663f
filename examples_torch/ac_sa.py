"""Allen-Cahn Self-Adaptive PINN, the flagship config (the JAX package's
``examples/ac_sa.py``; reference ``examples/AC-SA.py``; SA-PINN, McClenny
et al. arXiv:2009.04544).

The PDE of ``ac_baseline.py`` with per-point minimax loss weights:
λ_residual ~ U[0,1] over the 50k collocation points, λ_IC ~ 100·U[0,1]
over the 512 IC points, trained by gradient ascent while the network
descends.  On the card the training loss is the fused minimax step, K3.
"""

from _common import example_args, fit_resumable, zoo_spec

from ac_baseline import build_sa_solver, evaluate

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import zoo

ENTRY = zoo.get("allen-cahn-sa")


def main():
    args = example_args("Allen-Cahn Self-Adaptive PINN",
                        flags=("periodic-net",))
    spec = zoo_spec(ENTRY, args.quick)
    nx, nt = spec.grid

    # --periodic-net: the exactly periodic embedding ansatz
    # (networks.PeriodicMLP), on the generic residual engine
    solver = build_sa_solver(spec.n_f, nx, nt, list(spec.widths),
                             periodic=args.periodic_net, verbose=True,
                             device=args.device)
    fit_resumable(solver, quick=args.quick, tf_iter=spec.budget.adam,
                  newton_iter=spec.budget.lbfgs)
    err = evaluate(solver, args, "ac_sa")
    if args.plot:
        tdq.plotting.plot_weights(solver,
                                  save_path=f"{args.plot}/ac_sa_weights.png")
    return err


if __name__ == "__main__":
    main()
