"""Transfer learning with staged learning rates (the JAX package's
``examples/transfer_learn.py``; reference ``examples/transfer-learn.py``).

Train Allen-Cahn SA for a first leg, save, then resume twice with lower
learning rates.  The full training state (parameters, λ and Adam moments)
round-trips through ``tensordiffeq_tpu_torch.checkpoint``.
"""

import os
import tempfile

import numpy as np

from _common import example_args, scaled

from ac_baseline import build_problem, evaluate

from tensordiffeq_tpu_torch import CollocationSolverND


def make_solver(args, n_f, nx, lr):
    domain, bcs, f_model = build_problem(n_f, nx=nx,
                                         nt=201 if not args.quick else 21)
    widths = [128] * 4 if not args.quick else [32] * 2
    rng = np.random.RandomState(0)
    solver = CollocationSolverND(device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs, Adaptive_type=1,
                   dict_adaptive={"residual": [True], "BCs": [True, False]},
                   init_weights={"residual": [rng.rand(n_f, 1)],
                                 "BCs": [100.0 * rng.rand(nx, 1), None]},
                   lr=lr, lr_weights=lr)
    return solver


def main():
    args = example_args("Transfer learning with staged learning rates")
    n_f = scaled(args, 50_000, 2_000)
    nx = 512 if not args.quick else 64
    leg = scaled(args, 5_000, 100)

    ckpt_dir = os.path.join(tempfile.mkdtemp(), "ac_ckpt")

    solver = make_solver(args, n_f, nx, lr=0.005)
    solver.fit(tf_iter=leg)
    solver.save_checkpoint(ckpt_dir)
    print(f"leg 1 done, loss {solver.losses[-1]['Total Loss']:.4e}")

    # resume at a 10x lower rate: a fresh solver, the full state restored
    solver = make_solver(args, n_f, nx, lr=0.0005)
    solver.restore_checkpoint(ckpt_dir)
    solver.fit(tf_iter=leg)
    solver.save_checkpoint(ckpt_dir)
    print(f"leg 2 done, loss {solver.losses[-1]['Total Loss']:.4e}")

    solver = make_solver(args, n_f, nx, lr=0.00005)
    solver.restore_checkpoint(ckpt_dir)
    solver.fit(tf_iter=leg)
    print(f"leg 3 done, loss {solver.losses[-1]['Total Loss']:.4e}")

    return evaluate(solver, args, "transfer_learn")


if __name__ == "__main__":
    main()
