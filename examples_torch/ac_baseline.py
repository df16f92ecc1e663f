"""Allen-Cahn baseline forward PINN (the JAX package's
``examples/ac_baseline.py``; reference ``examples/AC-baseline.py``).

u_t - 0.0001 u_xx + 5u^3 - 5u = 0 on x in [-1,1], t in [0,1];
u(x,0) = x^2 cos(pi x), periodic in x (value + first derivative).
N_f=50k, 2-128x4-1 tanh MLP, 10k Adam + 10k L-BFGS.
"""

import numpy as np

from _common import example_args, fit_resumable, scaled

import tensordiffeq_tpu_torch as tdq
from tensordiffeq_tpu_torch import CollocationSolverND
from tensordiffeq_tpu_torch.exact import allen_cahn_solution


def _sa_spec(n_f: int, nx: int, nt: int, widths):
    """An explicit operating point over the zoo entry's declared ``full``
    size (the registry owns the problem; callers own the scale knobs)."""
    import dataclasses

    from tensordiffeq_tpu_torch import zoo

    return dataclasses.replace(zoo.get("allen-cahn-sa").spec("full"),
                               n_f=n_f, widths=tuple(widths),
                               grid=(nx, nt))


def build_problem(n_f: int, nx: int = 512, nt: int = 201, seed: int = 0):
    """The Allen-Cahn problem from the zoo entry ``allen-cahn-sa``, without
    its SA compile config: the plain baseline."""
    from tensordiffeq_tpu_torch import zoo

    entry = zoo.get("allen-cahn-sa")
    problem = entry.build(_sa_spec(n_f, nx, nt, (32,)), seed=seed)
    return problem.domain, list(problem.bcs), problem.f_model


def build_sa_solver(n_f: int, nx: int, nt: int, widths, periodic=False,
                    seed: int = 0, verbose: bool = False, device="cuda"):
    """The flagship SA config from the zoo entry ``allen-cahn-sa``: λ_res ~
    U[0,1] per collocation point, λ_IC ~ 100·U[0,1] per IC point,
    Adaptive_type=1.  ``periodic=True`` swaps in the exactly periodic
    ansatz (``periodic_net``, the generic engine).  ``seed`` drives the
    collocation draw, the network init and the λ init."""
    from tensordiffeq_tpu_torch import zoo

    network_factory = None
    if periodic:
        def network_factory(layers, domain):
            return tdq.periodic_net(layers, domain, ["x"], device=device)
    return zoo.build_solver(zoo.get("allen-cahn-sa"),
                            spec=_sa_spec(n_f, nx, nt, widths), seed=seed,
                            network_factory=network_factory,
                            verbose=verbose, device=device)


def evaluate(solver, args, name):
    x, t, usol = allen_cahn_solution()
    Xg = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u_pred, _ = solver.predict(Xg, best_model=True)
    err = tdq.find_L2_error(u_pred, usol.reshape(-1, 1))
    print(f"Error u: {err:e}")
    if args.plot:
        tdq.plotting.plot_solution_domain1D(
            solver, [x, t], ub=[1.0, 1.0], lb=[-1.0, 0.0], Exact_u=usol,
            save_path=f"{args.plot}/{name}.png", best_model=True)
    return err


def main():
    args = example_args(
        "Allen-Cahn baseline forward PINN",
        telemetry=("", "write a JSONL telemetry run log under this "
                       "directory and print telemetry.report() at the end"))
    n_f = scaled(args, 50_000, 2_000)
    domain, bcs, f_model = build_problem(n_f, nx=512 if not args.quick else 64,
                                         nt=201 if not args.quick else 21)
    widths = [128] * 4 if not args.quick else [32] * 2
    solver = CollocationSolverND(device=args.device)
    solver.compile([2, *widths, 1], f_model, domain, bcs)
    tf_iter = scaled(args, 10_000, 200)
    newton_iter = scaled(args, 10_000, 100)
    if args.telemetry:
        with tdq.telemetry.RunLogger(
                args.telemetry,
                config={"example": "ac_baseline", "n_f": n_f,
                        "tf_iter": tf_iter, "newton_iter": newton_iter,
                        "widths": widths}) as run:
            fit_resumable(solver, quick=args.quick, tf_iter=tf_iter,
                          newton_iter=newton_iter, telemetry=run)
        print(tdq.telemetry.report(args.telemetry))
    else:
        fit_resumable(solver, quick=args.quick, tf_iter=tf_iter,
                      newton_iter=newton_iter)
    return evaluate(solver, args, "ac_baseline")


if __name__ == "__main__":
    main()
