"""Allen-Cahn discovery-model inference: load and evaluate (the JAX
package's ``examples/ac_inference.py``; reference
``examples/AC-inference.py:18-26``).

A model discovered and checkpointed earlier is restored into a fresh model
and interrogated: the recovered coefficients (c1, c2), the residual of the
learned PDE over the grid (``predict_f``), the solution fit (rel-L2 against
the spectral solution) and the trained SA collocation-weight field
(``plot_weights``).  Run after ``ac_discovery.py`` with ``--ckpt <dir>`` to
load its checkpoint, or alone: it trains a short discovery run first,
saves it and restores it.
"""

import os
import tempfile

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import (DiscoveryModel, find_L2_error, grad,
                                    plotting)
from tensordiffeq_tpu_torch.exact import allen_cahn_solution


def f_model(u, var, x, t):
    c1, c2 = var
    u_xx = grad(grad(u, "x"), "x")
    uv = u(x, t)
    return grad(u, "t")(x, t) - c1 * u_xx(x, t) + c2 * uv ** 3 - c2 * uv


def build(X, u_star, widths, col_weights, device):
    model = DiscoveryModel(device=device)
    model.compile([2, *widths, 1], f_model,
                  [X[:, 0:1], X[:, 1:2]], u_star, var=[0.0, 0.0],
                  col_weights=col_weights, varnames=["x", "t"],
                  lr_weights=0.005, verbose=False)
    return model


def main():
    args = example_args("Allen-Cahn discovery inference", flags=("no-sa",),
                        ckpt=("", "checkpoint dir from ac_discovery.py: "
                              "pass the SAME --quick/--no-sa flags as the "
                              "training run so the model shapes match"))

    x, t, usol = allen_cahn_solution()
    if args.quick:
        x, t, usol = x[::8], t[::8], usol[::8, ::8]
    X = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u_star = usol.reshape(-1, 1)
    widths = [128] * 4 if not args.quick else [32] * 2
    rng = np.random.RandomState(0)
    col_weights = None if args.no_sa else rng.rand(X.shape[0], 1)

    ckpt = args.ckpt
    if not ckpt:
        print("[inference] no --ckpt; training a short discovery run first")
        trainer = build(X, u_star, widths, col_weights, args.device)
        trainer.fit(tf_iter=scaled(args, 2_000, 100))
        ckpt = os.path.join(tempfile.mkdtemp(), "ac_inference_ckpt")
        trainer.save_checkpoint(ckpt)
        del trainer

    model = build(X, u_star, widths, col_weights, args.device)
    try:
        model.restore_checkpoint(ckpt)
    except Exception as e:
        raise SystemExit(
            f"failed to restore {ckpt}: {type(e).__name__}: {e}\n"
            "The inference model must be built exactly like the training "
            "run: re-run with the same --quick and --no-sa flags.") from e

    c1, c2 = (float(v) for v in model.vars)
    print(f"discovered: c1 = {c1:.6f} (true 0.0001), "
          f"c2 = {c2:.4f} (true 5.0)")

    f_pred = model.predict_f(X)
    print(f"learned-PDE residual over the grid: mean|f| = "
          f"{np.abs(f_pred).mean():.3e}, max|f| = {np.abs(f_pred).max():.3e}")

    u_pred = model.predict(X)
    print(f"solution fit: rel-L2 = {find_L2_error(u_pred, u_star):.3e}")

    if args.plot and not args.no_sa:
        os.makedirs(args.plot, exist_ok=True)
        plotting.plot_weights(
            model, scale=10.0,
            save_path=os.path.join(args.plot, "ac_inference_weights.png"))
        print(f"[inference] weight plot -> {args.plot}")
    return model


if __name__ == "__main__":
    main()
