"""Digests of the single K3 launch's outputs in each flavor, for one
checkout; run it on two checkouts to show that a change left K3's
arithmetic as it was (equal digests: the same bits).

    python3 scripts/torch_k3_bits.py --tree _compare/parent
    python3 scripts/torch_k3_bits.py --tree .

Two shapes: the surrogate factory's member (2-64-64-1, N = 2,048) and the
Allen-Cahn slice (2-128x4-1, N = 50,000), the AC residual with θ = 1.5e-4;
weights, points and per-point weights from ``numpy.random.RandomState(7)``.
One line per shape and flavor (f32, TF32, bf16): the sha256 prefix of the
value, dW/db, gw and gX as the card returned them.
"""
import argparse
import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (([2, 64, 64, 1], 2048), ([2, 128, 128, 128, 128, 1], 50_000))
FLAVORS = (("f32", {}), ("tf32", dict(precision="default")),
           ("bf16", dict(compute_dtype="bfloat16")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose kernels are run")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAILED: no CUDA device")
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    if not os.path.abspath(tdqt.__file__).startswith(tree):
        sys.exit(f"FAILED: imported {tdqt.__file__}, not the package in "
                 f"{tree}")

    def f(u, x, t):
        g = tdqt.grad
        uv = u(x, t)
        return (g(u, "t")(x, t) - 1.5e-4 * g(g(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    dev = torch.device("cuda")
    for widths, n in SHAPES:
        shapes = list(zip(widths[:-1], widths[1:]))
        rng = np.random.RandomState(7)
        flat = []
        for a, b in shapes:
            flat += [torch.tensor(rng.randn(a, b) / a ** 0.5,
                                  dtype=torch.float32, device=dev),
                     torch.tensor(0.1 * rng.randn(1, b), dtype=torch.float32,
                                  device=dev)]
        X = torch.tensor(np.stack([rng.uniform(-1, 1, n),
                                   rng.uniform(0, 1, n)], 1),
                         dtype=torch.float32, device=dev)
        w = torch.tensor(rng.rand(n, 1), dtype=torch.float32, device=dev)
        for name, kw in FLAVORS:
            sq = build_minimax_sq_fn(f, ("x", "t"), 1,
                                     {(), (1,), (0, 0)}, shapes, **kw)
            out = cm.FLAVORS[sq.flavor](sq.plan, X, w, sq.plan.pack(flat))
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                t.detach().cpu().numpy().tobytes() for t in out)).hexdigest()
            print(f"[k3 bits] {tree}: {widths} N={n:,} {name} "
                  f"{digest[:16]}", flush=True)


if __name__ == "__main__":
    main()
