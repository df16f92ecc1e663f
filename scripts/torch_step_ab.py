"""Replay-only ms per Adam step of the port's training paths, for one
checkout of the repo; run it on two checkouts in turns (A, B, B, A) in
one session on one card to compare them.

AC-SA at its ``full`` size (N_f = 50,000, 2-128x4-1, the 512x201 grid,
``chip_smoke.ac_sa_problem``) on ``compile(fused="cuda")``: the minimax
path (K3 per step) and ``minimax=False`` (K1 + K2 per step), and, where
the checkout has it, each again under ``fused_dtype="bfloat16"`` and the
minimax path with ``neural_net(..., precision=None)`` (K3-TF32 per step;
``minimax-tf32``) and its unfused path (K1-TF32 + K2-TF32 per step;
``unfused-tf32``); ``--paths`` picks some of them, and ``--widths``
another net for them (``--widths 2,256,256,256,256,1``: the wide paths of
``chip_smoke.py``, where the f32 and TF32 K3 and K2 take their NP = 256
design; default the slice's 2-128x4-1).  Each
solver first takes ``--steps`` Adam steps that hold the graph's warm-ups
and capture (not timed); then ``--turns`` turns of ``--steps`` more,
the paths in the order given and back, each turn one ``fit(tf_iter=steps,
chunk=steps)`` between two ``torch.cuda.synchronize()`` on the host clock:
replays and the chunk's one history read, as ``chip_smoke.py --profile``
times its paths.

    python scripts/torch_step_ab.py --tree . --tag change \\
        --out chiprun_out/step_ab.jsonl

One JSON line per run: the tag, the card's name and power limit, the
checkout's path, the widths and, per path, the ms/step of each turn.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# (tag, minimax, fused_dtype, the network's precision)
PATHS = (("minimax", None, None, "highest"),
         ("unfused", False, None, "highest"),
         ("minimax-bf16", None, "bfloat16", "highest"),
         ("unfused-bf16", False, "bfloat16", "highest"),
         ("minimax-tf32", None, None, None),
         ("unfused-tf32", False, None, None))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose package and smoke are timed")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", default=None, help="append the line here")
    ap.add_argument("--paths", default=",".join(p[0] for p in PATHS),
                    help="the paths to time, comma-separated")
    ap.add_argument("--widths", default=None,
                    help="the net's widths, comma-separated (default: "
                    "chip_smoke.WIDTHS)")
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

    widths = (chip_smoke.WIDTHS if args.widths is None
              else [int(v) for v in args.widths.split(",")])
    solvers = {}
    wanted = args.paths.split(",")
    for tag, minimax, dtype, precision in PATHS:
        if tag not in wanted:
            continue
        domain, bcs, f_model, kw = chip_smoke.ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        extra = {} if dtype is None else dict(fused_dtype=dtype)
        if precision is None:
            extra["network"] = tdqt.neural_net(widths, seed=0,
                                               precision=None)
        try:
            s.compile(widths, f_model, domain, bcs, fused="cuda",
                      minimax=minimax, **extra, **kw)
        except (tdqt.NotPortedError, TypeError):
            continue  # a checkout without the bf16 flavor or the option
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
    line = dict(tag=args.tag, card=card, tree=tree, widths=widths,
                steps=args.steps, ms_per_step=turns,
                mean={k: float(np.mean(v)) for k, v in turns.items()})
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
