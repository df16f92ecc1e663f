"""How far a served bf16 answer lies from the f32 one, by the checkout's
K1-bf16 and by the plain bf16 flavor, on saved surrogate artifacts.

    python3 chip_smoke.py --keep-nets witness/nets
    python3 scripts/torch_serve_bf16_witness.py --tree . --tag change \\
        --nets witness/nets --out witness/serve.jsonl

``--nets`` holds the artifacts ``chip_smoke.py --keep-nets`` keeps: ``f32``
(phase 10's f32-trained net) and ``bf16`` (phase 14's bf16-trained one).
``--tree`` names the checkout whose ``tensordiffeq_tpu_torch`` serves them,
so one call can serve the same artifacts with an older checkout's kernels.
On the Allen-Cahn grid (512 x 201 points, ``allen_cahn_solution``) each
artifact is served through ``InferenceEngine`` on the card in bf16 (one
K1-bf16 launch per replay) and in f32, and, unless ``--no-plain``, by the
plain bf16 flavor (an engine on the CPU); per served kind the line holds
the scale-relative distance (max |a - b| / max |b|) of the card's bf16 and
of the plain bf16 answer to the card's f32 one, and of the card's bf16
answer to the plain bf16 one.  One JSON line per artifact, with the tag,
the checkout and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the checkout whose package serves the artifacts")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--nets", required=True,
                    help="the directory chip_smoke.py --keep-nets wrote")
    ap.add_argument("--no-plain", action="store_true",
                    help="skip the plain bf16 flavor on the CPU")
    ap.add_argument("--out", default=None, help="append the lines here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    import tensordiffeq_tpu_torch as tdqt
    if not os.path.abspath(tdqt.__file__).startswith(tree):
        sys.exit(f"imported {tdqt.__file__}, not the package in {tree}")
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.serving import Surrogate
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    x, t, _ = allen_cahn_solution()
    X = np.ascontiguousarray(np.stack(np.meshgrid(x, t, indexing="ij"),
                                      -1).reshape(-1, 2), np.float32)
    ladder = chip_smoke.SERVE_LADDER

    def dist(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    for name in ("f32", "bf16"):
        path = os.path.join(args.nets, name)
        sur = Surrogate.load(path, f_model=chip_smoke._ac_residual)
        eng16 = sur.engine(compute_dtype="bfloat16", **ladder)
        eng32 = sur.engine(**ladder)
        plain = None if args.no_plain else Surrogate.load(
            path, f_model=chip_smoke._ac_residual, device="cpu").engine(
            compute_dtype="bfloat16", **ladder)
        before = ct.k1_forward_bf16.launches
        kinds = {}
        for spec in chip_smoke.SERVE_BF16_KINDS:
            a16 = np.asarray(eng16.op_for(spec)(X))
            a32 = np.asarray(eng32.op_for(spec)(X))
            row = dict(bf16_vs_f32=dist(a16, a32))
            if plain is not None:
                p16 = np.asarray(plain.op_for(spec)(X))
                row.update(plain_bf16_vs_f32=dist(p16, a32),
                           bf16_vs_plain_bf16=dist(a16, p16))
            kinds[spec] = row
        line = dict(tag=args.tag, tree=tree, card=card, net=name,
                    points=int(X.shape[0]), kinds=kinds,
                    k1_bf16_launches=ct.k1_forward_bf16.launches - before)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
