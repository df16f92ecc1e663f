"""Why K1-bf16 sits further from the plain bf16 flavor than the earlier
TF32-pass route did (PERF.md §7): the same K1-bf16 with each k16 product
summed on the CUDA cores, beside the kernel as it is, on one NVIDIA GPU.

    python3 scripts/torch_k1_bf16_fresh_acc.py --seeds 0 1 2 3 4 \\
        --out witness/fresh_acc.jsonl

The kernel (``csrc/wgmma.cuh::wg_chunk``) adds every k16 step's bf16
product into one accumulator inside the tensor core.  The variant, built
from a copy of this checkout's ``csrc/`` under the git-ignored ``_build/``
(the package is not touched), runs each k16 step into a fresh accumulator
and adds it to the running sum in IEEE f32 on the CUDA cores, as the
TF32-pass route added each k8 step's sum.  Everything else (operands,
rounding points, the chain) is the same.  At the Allen-Cahn slice of
``chip_smoke.py`` phase 14 (N = 50,000, 2-128x4-1, C = 4), per seed: the
RMS over the whole table of the kernel and of the variant against the
plain bf16 flavor on the card, beside the plain flavor rerun on the CPU
(another BLAS's order of its f32 sums) and with the points permuted, and
the kernel against the plain f32 flavor (as
``scripts/torch_bf16_order_witness.py``'s ``k1_bf16`` row).  If the
variant sits where the TF32-pass route did (about 1.6 times nearer), the
tensor core's own accumulation is the cause; if it sits where the kernel
does, it is not.
One JSON line per seed.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# wg_chunk's bf16 products: one accumulator through every k16 step, and the
# variant's fresh accumulator per step, added on the CUDA cores
NATIVE = """#pragma unroll
    for (int s = 0; s < S16; ++s)
      WgMma<true, NP>::run(d, a[s], wg_desc(base + 256 * s, 128, sbo),
                           (first && s == 0) ? 0 : 1);
    wg_commit();
    wg_wait_all();"""
FRESH = """#pragma unroll
    for (int s = 0; s < S16; ++s) {
      float st[NP / 2];
      WgMma<true, NP>::run(st, a[s], wg_desc(base + 256 * s, 128, sbo), 0);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) {
        wg_keep(st[i]);
        d[i] = (first && s == 0) ? st[i] : d[i] + st[i];
      }
    }"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default=None, help="append the lines here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    native = ct.build()
    work = os.path.join(ct.BUILD_DIR, "fresh_acc")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ct.CSRC, os.path.join(work, "csrc"))
    path = os.path.join(work, "csrc", "wgmma.cuh")
    with open(path) as fh:
        src = fh.read()
    if NATIVE not in src:
        sys.exit("FAILED: wg_chunk's bf16 products are not where this "
                 "script expects them")
    with open(path, "w") as fh:
        fh.write(src.replace(NATIVE, FRESH))
    saved = ct.CSRC, ct.BUILD_DIR
    ct.CSRC, ct.BUILD_DIR, ct._lib = (os.path.join(work, "csrc"),
                                      os.path.join(work, "build"), None)
    fresh = ct.build()
    ct.CSRC, ct.BUILD_DIR, ct._lib = saved[0], saved[1], native
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev, cpu, N = torch.device("cuda", 0), torch.device("cpu"), cs.N_POINTS

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a.double().cpu()
                                            - b.double().cpu()) ** 2)))

    for seed in args.seeds:
        rng = np.random.RandomState(seed)
        X = torch.as_tensor(np.stack([rng.uniform(-1, 1, N),
                                      rng.uniform(0, 1, N)], 1)
                            .astype(np.float32), device=dev)
        layers = neural_net(cs.WIDTHS, device=dev, seed=seed).layers()
        flat_layers = [t.detach() for pair in layers for t in pair]
        plan = ct.build_cuda_table_fn(
            cs.AC_REQUESTS, [tuple(W.shape) for W, _ in layers]).plan
        flat = plan.pack(flat_layers)
        tables = {}
        for name, lib in (("kernel", native), ("fresh_acc", fresh)):
            ct._lib = lib
            tables[name] = ct.k1_forward_bf16(plan, X, flat)
        ct._lib = native
        torch.cuda.synchronize()

        def plain(device, perm=None, dtype=torch.bfloat16):
            pairs = [(W.to(device), b.to(device)) for W, b in layers]
            Xs = X.to(device) if perm is None else X[perm].to(device)
            with torch.no_grad():
                t = taylor_derivatives(pairs, Xs, set(plan.channels),
                                       flat_matmul=True, compute_dtype=dtype)
            table = torch.stack([t[mi] for mi in plan.channels]).to(dev)
            if perm is None:
                return table
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(N, device=perm.device)
            return table[:, inv]

        ref = plain(dev)
        perm = torch.randperm(N, generator=torch.Generator().manual_seed(7))
        line = dict(card=card, seed=seed,
                    kernel=rms(tables["kernel"], ref),
                    fresh_acc=rms(tables["fresh_acc"], ref),
                    cpu=rms(plain(cpu), ref),
                    perm=rms(plain(dev, perm.to(dev)), ref),
                    f32=rms(tables["kernel"], plain(dev, None, None)))
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
