"""Allen-Cahn coefficient discovery, the inverse problem (the JAX
package's ``examples/ac_discovery.py``; reference ``examples/AC-discovery.py``
and ``examples/AC-inference.py``).

Learns c1 (diffusion) and c2 (reaction) in
``u_t - c1 u_xx + c2 u^3 - c2 u = 0`` from the full 512x201 solution grid,
optionally with SA collocation weights (``--no-sa`` for the plain variant).
True values: c1 = 0.0001, c2 = 5.0.  The run checkpoints mid-run and
resumes from the checkpoint into a fresh model: coefficients, SA weights
and Adam moments round-trip exactly.
"""

import os
import tempfile

import numpy as np

from _common import example_args, scaled

from tensordiffeq_tpu_torch import DiscoveryModel, grad
from tensordiffeq_tpu_torch.exact import allen_cahn_solution


def main():
    args = example_args(
        "Allen-Cahn coefficient discovery", flags=("no-sa",),
        iters=(0, "override total Adam iters (0 = config default)"),
        lr_vars=("", "coefficient learning rate: one float or a "
                     "comma-separated per-coefficient list (empty = library "
                     "default); '2e-5,0.01' matches the c1/c2 scale split"),
        out=("", "write a JSON summary + coefficient trajectory here"))
    use_sa = not args.no_sa

    x, t, usol = allen_cahn_solution()
    if args.quick:
        x, t, usol = x[::8], t[::8], usol[::8, ::8]
    X = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u_star = usol.reshape(-1, 1)

    def f_model(u, var, x, t):
        c1, c2 = var
        u_xx = grad(grad(u, "x"), "x")
        uv = u(x, t)
        return grad(u, "t")(x, t) - c1 * u_xx(x, t) + c2 * uv ** 3 - c2 * uv

    rng = np.random.RandomState(0)
    col_weights = rng.rand(X.shape[0], 1) if use_sa else None
    widths = [128] * 4 if not args.quick else [32] * 2

    lr_vars_kw = {}
    if args.lr_vars:
        vals = [float(s) for s in args.lr_vars.split(",")]
        if len(vals) > 1:
            lr_vars_kw = {"lr_vars": vals}
        elif vals[0] != 0.0:  # a bare '0' means the default
            lr_vars_kw = {"lr_vars": vals[0]}

    def build():
        model = DiscoveryModel(device=args.device)
        model.compile([2, *widths, 1], f_model,
                      [X[:, 0:1], X[:, 1:2]], u_star, var=[0.0, 0.0],
                      col_weights=col_weights, varnames=["x", "t"],
                      **lr_vars_kw)
        return model

    total = args.iters or scaled(args, 10_000, 300)
    leg = total // 2

    model = build()
    if model._fused_residual is not None:
        print("[discovery] fused Taylor residual engine active")
    model.fit(tf_iter=leg)

    # checkpoint mid-run and resume into a fresh model (full-state restore)
    ckpt = os.path.join(tempfile.mkdtemp(), "ac_discovery_ckpt")
    model.save_checkpoint(ckpt)
    model = build()
    model.restore_checkpoint(ckpt)
    model.fit(tf_iter=total - leg)

    c1, c2 = (float(v) for v in model.vars)
    print(f"c1 = {c1:.6f} (true 0.0001), c2 = {c2:.4f} (true 5.0)")
    if args.out:
        import json
        summary = {"grid": f"{len(x)}x{len(t)}",
                   "net": f"2-{widths[0]}x{len(widths)}-1",
                   "adam": total, "lr_vars": args.lr_vars or None,
                   "sa": use_sa, "c1": c1, "c1_true": 0.0001,
                   "c1_abs_err": abs(c1 - 0.0001), "c2": c2, "c2_true": 5.0,
                   "c2_rel_err": abs(c2 - 5.0) / 5.0,
                   "final_loss": float(model.losses[-1]),
                   "trajectory_every10": [list(map(float, v)) for v in
                                          model.var_history[::10]]}
        with open(args.out, "w") as fh:
            json.dump(summary, fh)
    return model


if __name__ == "__main__":
    main()
