"""Replay-only ms per family step of the surrogate factory, for one
checkout of the repo; run it on two checkouts in turns (A, B, B, A) in one
session on one card to compare them.

Two families, both from ``chip_smoke.py``: the JAX package's factory
benchmark (phase 19: 64 Allen-Cahn members, N_f = 2,048 each, 2-64-64-1,
SA λ on the residual, ``fused="cuda"``; ``factory``) and the closed loop's
(phase 21(b): 4 members at the same widths and N_f; ``closedloop``).  Each
family first takes ``--steps`` Adam steps that hold the graph's warm-ups
and capture (not timed); then ``--turns`` turns of ``--steps`` more, the
families in turns, each turn one ``fit(tf_iter=steps, chunk=steps)``
between two ``torch.cuda.synchronize()`` on the host clock: replays and
the chunk's one history read, as phase 19 times its family step.  Then
the minimax step's kernels at the factory's live tensors, by CUDA events
over ``--reps`` launches: the 64 members' own K3 launches one after
another, and, where the checkout has it, the one K3 launch over the member
axis (``ops/cuda_minimax.py::k3_minimax_family``).

    python scripts/torch_family_ab.py --tree . --tag change \\
        --out chiprun_out/family_ab.jsonl

One JSON line per run: the tag, the card's name and power limit, the
checkout's path, per family the ms/step of each turn and their mean, and
the kernels' ms.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose package and smoke are timed")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="append the line here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import tensordiffeq_tpu_torch as tdqt
    if not os.path.abspath(tdqt.__file__).startswith(tree):
        sys.exit(f"imported {tdqt.__file__}, not the package in {tree}")
    from tensordiffeq_tpu_torch.factory import SurrogateFactory
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    ct.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    domain, bcs = cs._cl_problem()
    families = {
        "factory": cs._fac_build(),
        "closedloop": SurrogateFactory(
            cs.CL_WIDTHS, cs._fac_f_model, domain, bcs,
            [0.0009 + 0.0002 * m for m in range(cs.CL_M)], fused="cuda",
            verbose=False)}
    for fac in families.values():
        fac.fit(tf_iter=args.steps, chunk=args.steps)
    turns = {tag: [] for tag in families}
    order = list(families) + list(families)[::-1]
    for _ in range(args.turns // 2):
        for tag in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            families[tag].fit(tf_iter=args.steps, chunk=args.steps)
            torch.cuda.synchronize()
            turns[tag].append(1e3 * (time.perf_counter() - t0) / args.steps)

    # the minimax step's kernels at the factory's live tensors, w = λ²
    fac = families["factory"]
    M = fac.n_members
    lam = fac.lambdas["residual"][0].detach()
    w = (lam * lam).contiguous()
    X = fac.X_f.contiguous()
    leaves = [p.detach() if p.ndim == 3 else p.detach().reshape(M, 1, -1)
              for p in fac.params]
    packed = [fac._member_sq[m].plan.pack([t[m] for t in leaves])
              for m in range(M)]
    Xs = [X[m].contiguous() for m in range(M)]
    ws = [w[m].contiguous() for m in range(M)]

    def singles():
        for m in range(M):
            cm.k3_minimax(fac._member_sq[m].plan, Xs[m], ws[m], packed[m])

    kernels = {"singles_ms": cs.cuda_ms(singles, reps=args.reps)}
    if hasattr(cm, "k3_minimax_family"):
        fam = fac._family_res.family
        flat = torch.cat([t.reshape(M, -1) for t in leaves], 1)
        table = fam.constants[0].to(X.device)
        kernels["family_ms"] = cs.cuda_ms(
            lambda: cm.k3_minimax_family(fam.members[0].plan, X, w, flat,
                                         table), reps=args.reps)
    line = dict(tag=args.tag, card=card, tree=tree, steps=args.steps,
                ms_per_step=turns,
                mean={k: float(np.mean(v)) for k, v in turns.items()},
                kernels=kernels)
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
