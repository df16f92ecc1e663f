"""Replay ms of the served rungs of one checkout of the repo; run it on two
checkouts in turns (A, B, B, A) on one card to compare their serving
programs (the bf16 engine's one K1-bf16 launch per replay).

    python3 scripts/torch_serve_ab.py --tree . --tag change \\
        --out ab/serve_ab.jsonl

The AC-SA solver of ``chip_smoke.py`` (2-128x4-1, weights from seed 0,
not trained: serving time does not depend on the values) is exported,
saved, loaded with no solver and served by ``InferenceEngine`` on
``chip_smoke.SERVE_LADDER``, in bf16 (``compute_dtype="bfloat16"``) and
in f32.  For each kind of ``chip_smoke.SERVE_BF16_KINDS`` and each rung
of ``chip_smoke.SERVE_BF16_BUCKETS`` one query of that many points
captures the rung's graph; then CUDA events over 20 replays of it
(``chip_smoke.cuda_ms``).  One JSON line: the tag, the card's name and
power limit, the checkout, and per precision, kind and rung the ms per
replay.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose package and smoke are timed")
    ap.add_argument("--tag", required=True)
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
    from tensordiffeq_tpu_torch.serving import Surrogate
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    domain, bcs, f_model, kw = cs.ac_sa_problem()
    solver = tdqt.CollocationSolverND(verbose=False, seed=0)
    solver.compile(cs.WIDTHS, f_model, domain, bcs, fused="cuda", **kw)
    rng = np.random.RandomState(0)
    line = dict(tag=args.tag, card=card, tree=tree, ms={})
    with tempfile.TemporaryDirectory() as tmp:
        solver.export_surrogate().save(f"{tmp}/ac")
        sur = Surrogate.load(f"{tmp}/ac", f_model=cs._ac_residual)
        for label, extra in (("bf16", dict(compute_dtype="bfloat16")),
                             ("f32", {})):
            eng = sur.engine(**extra, **cs.SERVE_LADDER)
            for spec in cs.SERVE_BF16_KINDS:
                for b in cs.SERVE_BF16_BUCKETS:
                    X = np.stack([rng.uniform(-1, 1, b),
                                  rng.uniform(0, 1, b)], 1)
                    eng.op_for(spec)(X.astype(np.float32))
                    rung = eng._rungs[(eng.kind_key(spec), b)]
                    line["ms"][f"{label} {spec} b={b}"] = cs.cuda_ms(
                        rung.graph.graph.replay)
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
