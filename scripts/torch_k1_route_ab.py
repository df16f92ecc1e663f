"""K1's two routes side by side on one NVIDIA GPU: the persistent wgmma
route (``csrc/taylor_fwd_wg.cuh``) and the first kernel
(``csrc/taylor_table.cu::taylor_fwd_kernel``, which the host otherwise
takes only for wider shapes), on the same inputs in one process.

    python3 scripts/torch_k1_route_ab.py [--tree DIR]

``--tree`` (default: this script's checkout) names the checkout whose
package and ``chip_smoke.py`` are used.  At the slice's net (2-128x4-1,
weights from seed 0), for the Allen-Cahn request set at N = 50,000
(``ac``), the mixed set (``mixed``), the 200,000-point pool (``pool``),
b = 256 (``b256``), and the served ``u`` (C = 1) and ``d:x:1`` (C = 2)
kinds at 131,072 points; and at N = 50,000 on nets whose hidden widths pad
to 64 (the route's NP = 64 instances): 2-64x3-1 with the Allen-Cahn set
(``np64``) and 2-37-53-1 with {u, u_t, u_tt} (``odd``); each flavor: the route the host chose, its
scale-relative error against the plain flavor of its precision (and
against the plain f32 flavor), the two routes' distance, whether a second
launch is bit-identical, and the ms of each route over 20 launches
(``chip_smoke.cuda_ms``; the wgmma route before and after the other).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
    dev = torch.device("cuda")
    ct.build()
    print(cs.card_line(), flush=True)
    rng = np.random.RandomState(0)
    route = ct._Plan.k1_route
    slice_net = cs.WIDTHS

    def scaled(a, ref, plan):
        return max(float((a[c] - ref[mi]).abs().max() / ref[mi].abs().max())
                   for c, mi in enumerate(plan.channels))

    for label, reqs, n, widths in (
            ("ac", cs.AC_REQUESTS, 50_000, slice_net),
            ("mixed", cs.MIXED_REQUESTS, 50_000, slice_net),
            ("pool", cs.AC_REQUESTS, 200_000, slice_net),
            ("b256", cs.AC_REQUESTS, 256, slice_net),
            ("u131k", {()}, 131_072, slice_net),
            ("dx131k", {(), (0,)}, 131_072, slice_net),
            ("np64", cs.AC_REQUESTS, 50_000, [2, 64, 64, 64, 1]),
            ("odd", {(), (1,), (1, 1)}, 50_000, [2, 37, 53, 1])):
        X = torch.as_tensor(np.stack([rng.uniform(-1, 1, n),
                                      rng.uniform(0, 1, n)], 1),
                            dtype=torch.float32, device=dev)
        layers = neural_net(widths, device=dev, seed=0).layers()
        flat_layers = [t.detach() for pair in layers for t in pair]
        plan = ct.build_cuda_table_fn(
            reqs, [tuple(W.shape) for W, _ in layers]).plan
        flat = plan.pack(flat_layers)
        with torch.no_grad():
            ref32 = taylor_derivatives(layers, X, set(plan.channels),
                                       flat_matmul=True)
            ref16 = taylor_derivatives(layers, X, set(plan.channels),
                                       flat_matmul=True,
                                       compute_dtype=torch.bfloat16)
        for name, k1, ref, dtype in (
                ("K1", ct.k1_forward, ref32, None),
                ("K1-bf16", ct.k1_forward_bf16, ref16, torch.bfloat16)):
            out = k1(plan, X, flat)
            same = torch.equal(out, k1(plan, X, flat))
            taken = plan.k1_routes[dtype]
            ms = [cs.cuda_ms(lambda: k1(plan, X, flat))]
            ct._Plan.k1_route = lambda self, d, f, N: None
            try:
                first = k1(plan, X, flat)
                ms_first = cs.cuda_ms(lambda: k1(plan, X, flat))
            finally:
                ct._Plan.k1_route = route
            ms.append(cs.cuda_ms(lambda: k1(plan, X, flat)))
            apart = float((out - first).abs().max() / first.abs().max())
            torch.cuda.synchronize()
            print(f"[{name} {label}] route {taken}: scale_rel_err "
                  f"{scaled(out, ref, plan):.3e} (to the plain f32 flavor "
                  f"{scaled(out, ref32, plan):.3e}), against the first "
                  f"kernel {apart:.3e}, run to run "
                  f"{'bit-identical' if same else 'DIFFERENT'}; ms "
                  f"{ms[0]:.3f} / {ms[1]:.3f}, first kernel {ms_first:.3f}",
                  flush=True)


if __name__ == "__main__":
    main()
