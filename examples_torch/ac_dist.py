"""Allen-Cahn distributed data-parallel training, the scale config (the
JAX package's ``examples/ac_dist.py``; reference ``examples/AC-dist-new.py``:
N_f=500,000 collocation points, Adam only, multi-GPU).

``dist=True`` splits the collocation points (and their SA weights, with
``--sa``) into rank blocks; parameters are replicated and the gradients
summed over the ranks at every step.  One process per GPU: run under
``torchrun --nproc_per_node=<n> examples_torch/ac_dist.py`` (each rank
joins the group from torchrun's environment), or alone at world 1 with no
process group.  Unlike the reference, L-BFGS refinement runs distributed
too.
"""

import os

import numpy as np

from _common import example_args, scaled

from ac_baseline import build_problem, evaluate

from tensordiffeq_tpu_torch import CollocationSolverND, parallel


def main():
    args = example_args("Allen-Cahn distributed data-parallel", flags=("sa",))
    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        parallel.initialize_multihost(
            backend="gloo" if args.device == "cpu" else None)

    n_f = scaled(args, 500_000, 4_096)
    nx = 512 if not args.quick else 64
    domain, bcs, f_model = build_problem(n_f, nx=nx,
                                         nt=201 if not args.quick else 21)
    widths = [128] * 4 if not args.quick else [32] * 2

    kwargs = {}
    if args.sa:
        rng = np.random.RandomState(0)
        kwargs = dict(Adaptive_type=1,
                      dict_adaptive={"residual": [True], "BCs": [True, False]},
                      init_weights={"residual": [rng.rand(n_f, 1)],
                                    "BCs": [100.0 * rng.rand(nx, 1), None]})

    solver = CollocationSolverND(device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs, dist=True, **kwargs)
    print(f"group: {solver.mesh}")
    # the reference runs 1001 Adam iterations twice, no L-BFGS; a short
    # L-BFGS tail is added, since the distributed path supports it
    solver.fit(tf_iter=scaled(args, 1_001, 60))
    solver.fit(tf_iter=scaled(args, 1_001, 60),
               newton_iter=scaled(args, 1_000, 30))
    return evaluate(solver, args, "ac_dist")


if __name__ == "__main__":
    main()
