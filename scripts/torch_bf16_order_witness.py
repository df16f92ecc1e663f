"""How far the bf16 kernels lie from the plain bf16 flavor, beside how far
the plain bf16 flavor lies from itself when only the order of its f32 sums
changes: several seeds, one checkout of the repo.

    python3 scripts/torch_bf16_order_witness.py --tree . --tag change \\
        --seeds 0 1 2 3 4 --out witness/order.jsonl

``--tree`` names the checkout whose ``tensordiffeq_tpu_torch`` and
``chip_smoke.py`` are used, so one call can run an older checkout's
kernels beside this one's.  At the Allen-Cahn slice of ``chip_smoke.py``
phase 14 (N = 50,000 points, net 2-128x4-1): K1-bf16 and K2-bf16 on the
AC request set (C = 4), K3-bf16 on the AC residual (E = 1) and on the
coupled system (E = 2), each seed drawing its own points, weights, table
cotangent and residual weights.  The plain bf16 flavor (``ops/taylor.py``,
``ops/minimax.py``) rounds at the same places whatever it runs on, so two
runs of it that differ only in the order of their f32 sums are

* ``cpu``: the same inputs on the CPU (another BLAS's order), and
* ``perm``: the points permuted on the card (another order of every sum
  over points; per-point outputs permuted back).

Per seed and kernel the line holds the RMS over every output leaf
together (as ``chip_smoke.py``'s ``_flavor_check``) of the kernel against
the plain bf16 flavor on the card (``kernel``), of ``cpu`` and ``perm``
against it, and of the kernel against the plain f32 flavor (``f32``).  A
rounding point moved in the kernel would put ``kernel`` far above
``cpu`` and ``perm`` on every seed; sums in another order put it among
them.
"""
import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose kernels are compared")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default=None, help="append the lines here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    import tensordiffeq_tpu_torch as tdqt
    if not os.path.abspath(tdqt.__file__).startswith(tree):
        sys.exit(f"imported {tdqt.__file__}, not the package in {tree}")
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
    ct.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev, cpu, bf16 = torch.device("cuda", 0), torch.device("cpu"), \
        torch.bfloat16
    N = cs.N_POINTS

    def rms(a, b):
        a = torch.cat([t.reshape(-1).double().cpu() for t in a])
        b = torch.cat([t.reshape(-1).double().cpu() for t in b])
        return float(torch.sqrt(torch.mean((a - b) ** 2)))

    def row(kernel, plain, f32):
        """kernel: leaves; plain(device, perm) -> leaves; f32: leaves."""
        ref = plain(dev, None)
        perm = torch.randperm(N, generator=torch.Generator().manual_seed(7))
        return dict(kernel=rms(kernel, ref), cpu=rms(plain(cpu, None), ref),
                    perm=rms(plain(dev, perm), ref), f32=rms(kernel, f32))

    def unperm(t, perm, axis):
        if perm is None:
            return t
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.numel())
        return t.index_select(axis, inv.to(t.device))

    for seed in args.seeds:
        rng = np.random.RandomState(seed)
        Xn = np.stack([rng.uniform(-1, 1, N), rng.uniform(0, 1, N)],
                      1).astype(np.float32)
        X = torch.as_tensor(Xn, device=dev)
        line = dict(tag=args.tag, tree=tree, card=card, seed=seed)

        # K1-bf16 and K2-bf16 on the AC request set
        layers = neural_net(cs.WIDTHS, device=dev, seed=seed).layers()
        shapes = [tuple(W.shape) for W, _ in layers]
        flat_layers = [t.detach() for pair in layers for t in pair]
        plan = ct.build_cuda_table_fn(cs.AC_REQUESTS, shapes).plan
        flat = plan.pack(flat_layers)
        g = torch.as_tensor(rng.randn(plan.C, N, 1).astype(np.float32),
                            device=dev)

        def plain_table(device, perm, dtype=bf16):
            params = [t.to(device).clone().requires_grad_(True)
                      for t in flat_layers]
            pairs = list(zip(params[0::2], params[1::2]))
            Xs, gs = X.to(device), g.to(device)
            if perm is not None:
                Xs, gs = Xs[perm.to(device)], gs[:, perm.to(device)]
            Xg = Xs.clone().requires_grad_(True)
            t = taylor_derivatives(pairs, Xg, set(plan.channels),
                                   flat_matmul=True, compute_dtype=dtype)
            loss = sum((t[mi] * gs[c]).sum()
                       for c, mi in enumerate(plan.channels))
            grads = torch.autograd.grad(loss, params + [Xg])
            table = torch.stack([t[mi] for mi in plan.channels]).detach()
            return (unperm(table, perm, 1),
                    list(grads[:-1]) + [unperm(grads[-1], perm, 0)])

        table = ct.k1_forward_bf16(plan, X, flat)
        dX, dflat = ct.k2_backward_bf16(plan, X, flat, g)
        torch.cuda.synchronize()
        t32, g32 = plain_table(dev, None, None)
        line["k1_bf16"] = row([table], lambda d, p: [plain_table(d, p)[0]],
                              [t32])
        line["k2_bf16"] = row(plan.unpack(dflat) + [dX],
                              lambda d, p: plain_table(d, p)[1], g32)

        # K3-bf16 on the AC residual (E = 1) and the coupled system (E = 2)
        for label, f_model, widths in (
                ("k3_bf16_ac", cs._ac_residual, cs.WIDTHS),
                ("k3_bf16_system", cs._coupled_residual,
                 cs.WIDTHS[:-1] + [2])):
            layers = neural_net(widths, device=dev, seed=seed).layers()
            reqs = analyze_f_model(f_model, ("x", "t"), widths[-1])
            shapes = [tuple(W.shape) for W, _ in layers]
            sq = {(device, dtype): build_minimax_sq_fn(
                f_model, ("x", "t"), widths[-1], reqs, shapes,
                compute_dtype=dtype, device=device)
                for device in (dev, cpu) for dtype in (bf16, None)}
            kplan = sq[(dev, bf16)].plan
            w = torch.as_tensor((rng.rand(N, kplan.E) ** 2).astype(
                np.float32), device=dev)
            fl = [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
                  for pair in layers for a in pair]

            def leaves(res, perm=None):
                v, d, gw, gX = res
                return [v.reshape(1)] + [t.reshape(-1) for t in d] + \
                    [unperm(gw, perm, 0), unperm(gX, perm, 0)]

            def plain_k3(device, perm, dtype=bf16):
                Xs, ws = X.to(device), w.to(device)
                if perm is not None:
                    Xs, ws = Xs[perm.to(device)], ws[perm.to(device)]
                res = sq[(device, dtype)].plain([t.to(device) for t in fl],
                                                ws, Xs)
                return leaves([r.detach() if torch.is_tensor(r) else
                               [t.detach() for t in r] for r in res], perm)

            got = cm.k3_minimax_bf16(kplan, X, w, kplan.pack(fl))
            torch.cuda.synchronize()
            line[label] = row(
                leaves((got[0], kplan.unpack(got[1]), got[2], got[3])),
                plain_k3, plain_k3(dev, None, None))
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
