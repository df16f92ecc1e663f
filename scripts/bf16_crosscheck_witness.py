"""The compile-time cross-check of the bf16 fused residual, leaf by leaf, in
the port and in the JAX package, on the same points and weights.

``compile(fused_dtype="bfloat16")`` holds the fused residual and the
gradient of its sum of squares to the generic f32 engine on the first 32
collocation points, in the JAX solver's bf16 bands (5e-2 values, 1.5e-1
gradients, each leaf's max error over its max plus 1e-3).  This script
draws AC-SA's points as ``generate_collocation_points(--n-f, --seed)``
draws them (2-128x4-1, the 512x201 grid, as ``bf16_lbfgs_witness.py``),
keeps the first 32, builds the port's solver on them (``fused="cuda"``:
K1-bf16 and K2-bf16 on the card, their plain flavor on the CPU) with the
solver's own initial weights (``seed=0``), and prints per leaf the
relative error the check reads (on the card also the plain flavor's, and
the kernels' against the plain flavor).  With ``--jax`` it carries the same
weights into the JAX solver (its XLA flavor, on the CPU) and prints its
per-leaf errors beside them.  ``--save`` writes the points and weights
and ``--load`` takes them back, so that a run on the CPU sees the inputs
of a run on the card (another PyTorch version may draw other initial
weights from the same seed).  Nothing here trains; the solvers
hold 32 points.

    JAX_PLATFORMS=cpu python scripts/bf16_crosscheck_witness.py \\
        --n-f 50000 --seed 1 --device cpu --jax
    python scripts/bf16_crosscheck_witness.py --n-f 50000 --seed 1 \\
        --device cuda --save chiprun_out/crosscheck_inputs.npz
    JAX_PLATFORMS=cpu python scripts/bf16_crosscheck_witness.py \\
        --load chiprun_out/crosscheck_inputs.npz --device cpu --jax
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bf16_lbfgs_witness import GRID, WIDTHS, ac_sa  # noqa: E402

N_CHECK = 32
ATOL = 1e-3  # the cross-check's floor on a leaf's scale under fused_dtype


def leaf_errors(g_gen, g_fus) -> list:
    return [float(np.max(np.abs(f - g)) / (np.max(np.abs(g)) + ATOL))
            for g, f in zip(g_gen, g_fus)]


def first_points(pkg, n_f: int, seed: int, X=None):
    """The problem at ``N_CHECK`` points: the first of the ``n_f`` drawn,
    or ``X`` (the points of another run)."""
    domain, bcs, f_model, kw = ac_sa(pkg, n_f, seed)
    domain.X_f = np.asarray(domain.X_f)[:N_CHECK] if X is None else X
    kw["init_weights"]["residual"] = [kw["init_weights"]["residual"][0]
                                      [:N_CHECK]]
    return domain, bcs, f_model, kw


def port(args):
    """The port's per-leaf errors, f32 and bf16 fused residual against the
    generic engine, at the f32 solver's initial weights."""
    import torch

    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.ops.cuda_taylor import build_cuda_table_fn
    from tensordiffeq_tpu_torch.ops.fused import (analyze_f_model,
                                                   make_fused_residual)
    from tensordiffeq_tpu_torch.weights import params_to_numpy

    saved = np.load(args.load) if args.load else None
    domain, bcs, f_model, kw = first_points(
        tdqt, args.n_f, args.seed, None if saved is None else saved["X"])
    s = tdqt.CollocationSolverND(verbose=False, device=args.device, seed=0)
    s.compile(WIDTHS, f_model, domain, bcs, fused="cuda", minimax=False,
              **kw)
    if saved is not None:
        s.net.load_layers([(torch.from_numpy(saved[f"W{i}"]),
                            torch.from_numpy(saved[f"b{i}"]))
                           for i in range(len(WIDTHS) - 1)])
    params = s.net.layers()
    if args.save:
        np.savez(args.save, X=s.X_f.cpu().numpy(), **{
            f"{k}{i}": t.detach().cpu().numpy()
            for i, (W, b) in enumerate(params) for k, t in (("W", W),
                                                            ("b", b))})
    flat = [t for pair in params for t in pair]
    reqs = analyze_f_model(f_model, s.domain.vars, 1)

    def grads(fn):
        r = fn(params, s.X_f)
        r = r if isinstance(r, tuple) else (r,)
        loss = sum(torch.sum(c ** 2) for c in r)
        return [g.detach().cpu().numpy() for g in torch.autograd.grad(
            loss, flat, materialize_grads=True)]

    g_gen = grads(s._generic_residual)
    out = {"generic_max": [float(np.max(np.abs(g))) for g in g_gen]}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        table = build_cuda_table_fn(reqs, [tuple(W.shape) for W, _ in params],
                                    device=args.device, compute_dtype=dtype)
        g_k = grads(make_fused_residual(f_model, s.domain.vars, 1, reqs,
                                        table_producer=table,
                                        compute_dtype=dtype))
        out[tag] = leaf_errors(g_gen, g_k)
        if args.device == "cuda":
            # the plain flavor on the same device, and the kernels held to it
            g_p = grads(make_fused_residual(f_model, s.domain.vars, 1, reqs,
                                            compute_dtype=dtype))
            out[f"{tag}_plain"] = leaf_errors(g_gen, g_p)
            out[f"{tag}_kernel_vs_plain"] = leaf_errors(g_p, g_k)
    return params_to_numpy(params), s.X_f.cpu().numpy(), out


def jax_side(tree, X, args):
    """The JAX package's per-leaf errors (its XLA flavor) at the same
    weights and points."""
    import jax
    import jax.numpy as jnp

    import tensordiffeq_tpu as tdq
    from tensordiffeq_tpu.ops.derivatives import make_ufn, vmap_residual
    from tensordiffeq_tpu.ops.fused import (analyze_f_model,
                                            make_fused_residual)

    domain, bcs, f_model, kw = first_points(tdq, args.n_f, args.seed, X)
    s = tdq.CollocationSolverND(verbose=False)
    s.compile(WIDTHS, f_model, domain, bcs, fused=True, minimax=False, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    reqs = analyze_f_model(f_model, s.domain.vars, 1)

    def gen_loss(p):
        u = make_ufn(s.apply_fn, p, s.domain.vars, s.n_out)
        return jnp.sum(vmap_residual(f_model, u, s.domain.ndim)(s.X_f) ** 2)

    def leaves(g):
        return [np.asarray(g["params"][f"Dense_{i}"][k])
                for i in range(len(WIDTHS) - 1) for k in ("kernel", "bias")]

    g_gen = leaves(jax.grad(gen_loss)(params))
    out = {}
    for tag, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        fused = make_fused_residual(f_model, s.domain.vars, 1, reqs,
                                    compute_dtype=dtype)
        g = jax.grad(lambda p: jnp.sum(fused(p, s.X_f) ** 2))(params)
        out[tag] = leaf_errors(g_gen, leaves(g))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-f", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--save", default=None,
                    help="write the points and weights here (.npz)")
    ap.add_argument("--load", default=None,
                    help="take the points and weights from a --save file")
    args = ap.parse_args()
    tree, X, mine = port(args)
    line = dict(n_f=args.n_f, seed=args.seed, device=args.device,
                n_check=N_CHECK, grid=GRID, loaded=args.load,
                x_sum=float(X.astype(np.float64).sum()), port=mine)
    if args.jax:
        line["jax_cpu"] = jax_side(tree, X, args)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
