"""K3 and K2 in the f32 flavor at a zoo entry's shape over many seeds of
their random inputs, on one NVIDIA GPU: the worst scale-relative distance
of each leaf to the IEEE plain flavor.

    python3 scripts/torch_zoo_k3_seeds.py [--entry allen-cahn-sa] \\
        [--seeds 16] [--n-f 4096]

The inputs are ``tests/test_torch_cuda.py::
test_zoo_shapes_kernels_match_plain_flavors_on_card``'s: the entry's
solver at its full widths, d, n_out and E built by ``zoo.build_solver`` at
``--n-f`` collocation points, and for each seed a ``torch.Generator`` on
the card seeded with it, from which ``w`` (then squared) and the table
cotangents ``g`` are drawn, in that order.  Prints, per seed, K3's and
K2's worst leaf and the route each took; then, per leaf, its worst over
the seeds against the band (1e-4).  Where a seed breaks the band, that
leaf is also held against a float64 referee (the plain flavor on the same
inputs in float64), beside the plain f32 flavor's own distance to it.
Exit code 1 if any seed breaks the band.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BAND = 1e-4


def scaled(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entry", default="allen-cahn-sa")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--n-f", type=int, default=4096)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("FAILED: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensordiffeq_tpu_torch import zoo
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
    card = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)

    entry = zoo.get(args.entry)
    spec = dataclasses.replace(entry.spec("full"), n_f=args.n_f)
    s = zoo.build_solver(entry, spec=spec, device="cuda")
    X = s.X_f.contiguous()
    layers = [(W.detach(), b.detach()) for W, b in s.net.layers()]
    fl = [a if a.ndim == 2 else a.reshape(1, -1) for p in layers for a in p]
    sq = s._minimax_sq
    plan = ct.build_cuda_table_fn(
        s._fuse_requests, [tuple(W.shape) for W, _ in layers]).plan
    flat_layers = [t for p in layers for t in p]
    flat = plan.pack(flat_layers)

    def k3_leaves(v, d, gw, gX):
        return [v.reshape(1)] + [t.reshape(-1) for t in d] + [gw, gX]

    def k2_plain(g, dtype):
        params = [t.to(dtype).clone().requires_grad_(True)
                  for t in flat_layers]
        Xg = X.to(dtype).clone().requires_grad_(True)
        t = taylor_derivatives(list(zip(params[0::2], params[1::2])), Xg,
                               set(plan.channels), flat_matmul=True)
        loss = sum((t[mi] * g[c].to(dtype)).sum()
                   for c, mi in enumerate(plan.channels))
        return list(torch.autograd.grad(loss, params + [Xg],
                                        materialize_grads=True))

    worst = {"k3": {}, "k2": {}}
    broke = []
    for seed in range(args.seeds):
        gen = torch.Generator(device=card).manual_seed(seed)
        w = torch.rand(X.shape[0], sq.plan.E, generator=gen,
                       device=card) ** 2
        got = cm.k3_minimax(sq.plan, X, w, sq.plan.pack(fl))
        k3 = k3_leaves(got[0], sq.plan.unpack(got[1]), got[2], got[3])
        want3 = k3_leaves(*sq.plain(fl, w, X))
        g = torch.randn(plan.C, X.shape[0], plan.n_out, generator=gen,
                        device=card)
        dX, dflat = ct.k2_backward(plan, X, flat, g)
        k2 = plan.unpack(dflat) + [dX]
        want2 = k2_plain(g, torch.float32)
        row = {}
        for key, got_, want in (("k3", k3, want3), ("k2", k2, want2)):
            errs = [scaled(a, b) for a, b in zip(got_, want)]
            row[key] = max(errs)
            for i, e in enumerate(errs):
                worst[key][i] = max(worst[key].get(i, 0.0), e)
                if e > BAND:
                    broke.append((seed, key, i))
        print(f"[seeds {args.entry}] seed {seed}: K3 worst leaf "
              f"{row['k3']:.3e} ({sq.plan.k3_routes[None]} route), K2 worst "
              f"leaf {row['k2']:.3e} ({plan.k2_routes[None]} route)",
              flush=True)
        for seed_, key, i in [b for b in broke if b[0] == seed]:
            if key == "k3":
                ref = k3_leaves(*sq.plain([t.double() for t in fl],
                                          w.double(), X.double()))
                got_, plain = k3[i], want3[i]
            else:
                ref = k2_plain(g, torch.float64)
                got_, plain = k2[i], want2[i]
            print(f"[seeds {args.entry}] seed {seed} {key.upper()} leaf {i}: "
                  f"to the float64 referee {scaled(got_.double(), ref[i]):.3e}"
                  f", the plain f32 flavor's own distance to it "
                  f"{scaled(plain.double(), ref[i]):.3e}", flush=True)
    for key in ("k3", "k2"):
        print(f"[seeds {args.entry}] {key.upper()} per leaf, worst over "
              f"{args.seeds} seeds: "
              + ", ".join(f"{i}: {e:.3e}" for i, e in sorted(
                  worst[key].items()))
              + f" (band {BAND:g})", flush=True)
    print(f"[seeds {args.entry}] {len(broke)} (seed, leaf) pairs over the "
          f"band", flush=True)
    sys.exit(1 if broke else 0)


if __name__ == "__main__":
    main()
