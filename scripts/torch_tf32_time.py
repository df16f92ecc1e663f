"""K2 and K3 in the TF32 (or f32, or bf16) flavor at the Allen-Cahn slice
of one checkout, on one NVIDIA GPU: the ms of each by CUDA events over 20
launches, three times.

    python3 scripts/torch_tf32_time.py --tree DIR [--flavor tf32|f32|bf16]
        [--widths 2,256,256,256,256,1]

Run from the root of a checkout; ``--tree`` (default: this script's
checkout) names the checkout whose ``tensordiffeq_tpu_torch`` package and
``chip_smoke.py`` are timed, so one call can time several checkouts (or
copies of one with a kernel constant edited) in turns.  The inputs are
``chip_smoke.py`` phase 16(a)'s: N = 50,000 points, the net 2-128x4-1 from
seed 0, the Allen-Cahn residual, per-point weights and table cotangents
from ``numpy.random.RandomState(2)``.  ``--flavor f32`` times the 3xTF32
flavor (``k2_backward``, ``k3_minimax``) instead of the single-pass one,
``--flavor bf16`` the bf16-operand flavor (``k2_backward_bf16``,
``k3_minimax_bf16``).  ``--widths`` times another net from seed 0 (default:
the slice's 2-128x4-1), such as ``chip_smoke.py``'s WIDE_WIDTHS.
Prints one line: the card, the checkout, the flavor, the routes the
kernels took and the three ms of each.
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
    ap.add_argument("--flavor", choices=("tf32", "f32", "bf16"),
                    default="tf32",
                    help="the kernels' flavor (default: the TF32 one)")
    ap.add_argument("--widths", default=None,
                    help="the net's widths, comma-separated (default: "
                    "chip_smoke.WIDTHS)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        sys.exit("FAILED: no CUDA device")
    import chip_smoke as cs
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    if not os.path.abspath(ct.__file__).startswith(tree):
        sys.exit(f"FAILED: imported {ct.__file__}, not the package in {tree}")
    ct.build()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2)
    n = cs.N_POINTS
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, n),
                                  rng.uniform(0, 1, n)], 1),
                        dtype=torch.float32, device=dev)
    reqs = analyze_f_model(cs._ac_residual, ("x", "t"), 1)
    widths = (cs.WIDTHS if args.widths is None
              else [int(v) for v in args.widths.split(",")])
    layers, flat_layers, _, _ = cs._slice_net(widths, dev)
    shapes = [tuple(W.shape) for W, _ in layers]
    plan = ct.build_cuda_table_fn(reqs, shapes, precision=None).plan
    flat = plan.pack(flat_layers)
    g = torch.as_tensor(rng.randn(plan.C, n, 1), dtype=torch.float32,
                        device=dev)
    sq = build_minimax_sq_fn(cs._ac_residual, ("x", "t"), 1, reqs, shapes,
                             device=dev, precision=None)
    w = torch.as_tensor(rng.rand(n, 1) ** 2, dtype=torch.float32, device=dev)
    fl = [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
          for pair in layers for a in pair]
    kflat = sq.plan.pack(fl)
    k2_fn, k3_fn, key, tag = {
        "tf32": (ct.k2_backward_tf32, cm.k3_minimax_tf32, ct.TF32, "-TF32"),
        "f32": (ct.k2_backward, cm.k3_minimax, None, ""),
        "bf16": (ct.k2_backward_bf16, cm.k3_minimax_bf16, torch.bfloat16,
                 "-bf16")}[args.flavor]
    k2 = [cs.cuda_ms(lambda: k2_fn(plan, X, flat, g)) for _ in range(3)]
    k3 = [cs.cuda_ms(lambda: k3_fn(sq.plan, X, w, kflat)) for _ in range(3)]
    # an older checkout records no route for a flavor it had one route for
    routes = [r.get(key, "mma") for r in (sq.plan.k3_routes, plan.k2_routes)]
    fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)  # noqa: E731
    print(f"[{args.flavor} time] {cs.card_line()}; {tree} at "
          f"{'-'.join(map(str, widths))}: K3{tag} "
          f"({routes[0]} route) {fmt(k3)} ms; K2{tag} ({routes[1]} route) "
          f"{fmt(k2)} ms", flush=True)


if __name__ == "__main__":
    main()
