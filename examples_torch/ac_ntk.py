"""Allen-Cahn with NTK-balanced loss weighting (``Adaptive_type=3``; the
JAX package's ``examples/ac_ntk.py``).

Per-term weights λ_i = Σ_j tr(K_j) / tr(K_i) are recomputed from the
tangent kernel every training chunk, covering all terms, the periodic BC
included, which the SA path cannot weight.
"""

from _common import example_args, fit_resumable, scaled

from ac_baseline import build_problem, evaluate

from tensordiffeq_tpu_torch import CollocationSolverND


def main():
    args = example_args("Allen-Cahn with NTK weighting")
    n_f = scaled(args, 50_000, 2_000)
    domain, bcs, f_model = build_problem(n_f, nx=512 if not args.quick else 64,
                                         nt=201 if not args.quick else 21)
    widths = [128] * 4 if not args.quick else [32] * 2

    solver = CollocationSolverND(device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs, Adaptive_type=3)
    fit_resumable(solver, quick=args.quick, tf_iter=scaled(args, 10_000, 200),
                  newton_iter=scaled(args, 10_000, 100))
    lam = {k: [float(v) for v in vs] for k, vs in solver.lambdas.items()}
    print(f"final NTK weights: {lam}")
    return evaluate(solver, args, "ac_ntk")


if __name__ == "__main__":
    main()
