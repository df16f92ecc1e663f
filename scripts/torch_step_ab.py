"""Replay-only ms per Adam step of the port's training paths, for one
checkout of the repo; run it on two checkouts in turns (A, B, B, A) in
one session on one card to compare them.

AC-SA at its ``full`` size (N_f = 50,000, 2-128x4-1, the 512x201 grid,
``chip_smoke.ac_sa_problem``) on ``compile(fused="cuda")``: the minimax
path (K3 per step) and ``minimax=False`` (K1 + K2 per step), and, where
the checkout has it, each again under ``fused_dtype="bfloat16"``.  Each
solver first takes ``--steps`` Adam steps that hold the graph's warm-ups
and capture (not timed); then ``--turns`` turns of ``--steps`` more,
the paths in the order given and back, each turn one ``fit(tf_iter=steps,
chunk=steps)`` between two ``torch.cuda.synchronize()`` on the host clock:
replays and the chunk's one history read, as ``chip_smoke.py --profile``
times its paths.

    python scripts/torch_step_ab.py --tree . --tag change \\
        --out chiprun_out/step_ab.jsonl

One JSON line per run: the tag, the card's name and power limit, the
checkout's path and, per path, the ms/step of each turn.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

PATHS = (("minimax", None, None), ("unfused", False, None),
         ("minimax-bf16", None, "bfloat16"),
         ("unfused-bf16", False, "bfloat16"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose package and smoke are timed")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", default=None, help="append the line here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    import tensordiffeq_tpu_torch as tdqt
    if not os.path.abspath(tdqt.__file__).startswith(tree):
        sys.exit(f"imported {tdqt.__file__}, not the package in {tree}")
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    ct.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    solvers = {}
    for tag, minimax, dtype in PATHS:
        domain, bcs, f_model, kw = chip_smoke.ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        extra = {} if dtype is None else dict(fused_dtype=dtype)
        try:
            s.compile(chip_smoke.WIDTHS, f_model, domain, bcs, fused="cuda",
                      minimax=minimax, **extra, **kw)
        except tdqt.NotPortedError:
            continue  # a checkout without the bf16 flavor
        s.fit(tf_iter=args.steps, chunk=args.steps)
        solvers[tag] = s
    turns = {tag: [] for tag in solvers}
    order = list(solvers) + list(solvers)[::-1]
    for _ in range(args.turns // 2):
        for tag in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solvers[tag].fit(tf_iter=args.steps, chunk=args.steps)
            torch.cuda.synchronize()
            turns[tag].append(1e3 * (time.perf_counter() - t0) / args.steps)
    line = dict(tag=args.tag, card=card, tree=tree, steps=args.steps,
                ms_per_step=turns,
                mean={k: float(np.mean(v)) for k, v in turns.items()})
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
