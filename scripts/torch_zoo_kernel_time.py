"""K3 and K2 (f32 flavor) at each zoo entry's full shape, for one checkout
of the repo, on one NVIDIA GPU: run it on two checkouts in turns in one
call to compare them.

    python3 scripts/torch_zoo_kernel_time.py --tree DIR [--entries a,b]

For each entry of ``tensordiffeq_tpu_torch.zoo`` (all nine by default),
the solver ``zoo.build_solver(entry, "full")`` builds on the card (its own
widths, d, n_out, E and N_f), then K3 (its lowered step, w = λ² from
``numpy.random.RandomState(2)``) and K2 (its requests, table cotangents
from the same generator) are timed by CUDA events over 20 launches, as
``chip_smoke.py`` phase 15 times them.  Prints one line per entry: the
card, the checkout, N, the widths, each kernel's ms and the route it took
(a checkout that records no route for the f32 flavor had one route, the
mma.sync kernels).
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose kernels are timed")
    ap.add_argument("--entries", default=None,
                    help="comma-separated zoo ids (default: all)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        sys.exit("FAILED: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from tensordiffeq_tpu_torch import zoo
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    if not os.path.abspath(ct.__file__).startswith(tree):
        sys.exit(f"FAILED: imported {ct.__file__}, not the package in {tree}")
    ct.build()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    ids = args.entries.split(",") if args.entries else list(zoo.ids())
    for eid in ids:
        s = zoo.build_solver(zoo.get(eid), "full", device="cuda")
        rng = np.random.RandomState(2)
        X = s.X_f.contiguous()
        n = int(X.shape[0])
        layers = [(W.detach(), b.detach()) for W, b in s.net.layers()]
        widths = [layers[0][0].shape[0]] + [W.shape[1] for W, _ in layers]
        fl = [a if a.ndim == 2 else a.reshape(1, -1) for p in layers
              for a in p]
        sq = s._minimax_sq
        w = torch.as_tensor(rng.rand(n, sq.plan.E) ** 2, dtype=torch.float32,
                            device=dev)
        flat3 = sq.plan.pack(fl)
        k3 = cs.cuda_ms(lambda: cm.k3_minimax(sq.plan, X, w, flat3))
        plan = ct.build_cuda_table_fn(
            s._fuse_requests, [tuple(W.shape) for W, _ in layers]).plan
        flat = plan.pack([t for p in layers for t in p])
        g = torch.as_tensor(rng.randn(plan.C, n, plan.n_out),
                            dtype=torch.float32, device=dev)
        k2 = cs.cuda_ms(lambda: ct.k2_backward(plan, X, flat, g))
        print(f"[zoo time] {card}; {tree}: {eid} N={n} widths {widths} "
              f"C={plan.C} E={sq.plan.E}: K3 {k3:.3f} ms "
              f"({sq.plan.k3_routes.get(None, 'mma')} route), K2 {k2:.3f} "
              f"ms ({plan.k2_routes.get(None, 'mma')} route)", flush=True)


if __name__ == "__main__":
    main()
