"""What the f32 wgmma route's register spill costs, on one NVIDIA GPU: the
route rebuilt under lower register caps (so it spills more), its registers
and spill bytes beside its time, the caps timed in turns in one call.

    python3 scripts/torch_spill_cost.py [--caps 255,240,224]

For each cap, a copy of this checkout's ``tensordiffeq_tpu_torch`` package,
``chip_smoke.py`` and ``scripts/`` under the git-ignored
``tensordiffeq_tpu_torch/_build/spill/<cap>/``, whose
``csrc/wg_backward.cuh`` caps the route's two kernels by
``__maxnreg__(cap)`` in place of ``__launch_bounds__(WB_THREADS, 1)`` (the
code is otherwise the same; 255 is the route as it ships, by the other
qualifier).  In each copy: ``scripts/torch_ptxas_report.py`` on the f32
instances at NP = 128 (K3's and K2's registers and spill bytes at CP = 4),
then the f32 K3 and K2 at the Allen-Cahn slice by
``scripts/torch_tf32_time.py --flavor f32`` (each copy builds its own
library at its first run), the caps in the order given and back.  The
ms against the spill bytes across the caps price a spilled byte; the
cap of 255 is the spill the route has.
"""
import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = "__global__ void __launch_bounds__(WB_THREADS, 1)"


def copy_tree(dst: str, cap: int):
    """The package, the smoke and the scripts into ``dst``, the route's
    kernels capped at ``cap`` registers."""
    shutil.rmtree(dst, ignore_errors=True)
    pkg = os.path.join(ROOT, "tensordiffeq_tpu_torch")
    shutil.copytree(pkg, os.path.join(dst, "tensordiffeq_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "scripts"),
                    os.path.join(dst, "scripts"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    cuh = os.path.join(dst, "tensordiffeq_tpu_torch", "csrc",
                       "wg_backward.cuh")
    with open(cuh) as fh:
        src = fh.read()
    if src.count(BOUND) != 2:
        sys.exit(f"FAILED: {cuh} does not declare the route's two kernels "
                 f"with {BOUND!r}")
    if cap != 255:
        src = src.replace(BOUND, f"__global__ void __maxnreg__({cap})")
    with open(cuh, "w") as fh:
        fh.write(src)


def run(cmd: list, cwd: str) -> str:
    out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAILED: {' '.join(cmd)} in {cwd} ({out.returncode}):\n"
                 f"{out.stdout[-2000:]}{out.stderr[-3000:]}")
    return out.stdout


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--caps", default="255,240,224",
                    help="register caps, comma-separated")
    args = ap.parse_args()
    caps = [int(c) for c in args.caps.split(",")]
    base = os.path.join(ROOT, "tensordiffeq_tpu_torch", "_build", "spill")
    trees = {}
    for cap in caps:
        trees[cap] = os.path.join(base, str(cap))
        copy_tree(trees[cap], cap)
        report = run([sys.executable, "scripts/torch_ptxas_report.py",
                      "minimax_wg_f32_128.cu", "taylor_bwd_wg_f32_128.cu",
                      "--match", "ILi0ELi128ELi4E"], trees[cap])
        for line in report.splitlines():
            print(f"[spill cost] cap {cap}: {line}", flush=True)
    for cap in caps + caps[::-1]:
        line = run([sys.executable, "scripts/torch_tf32_time.py", "--flavor",
                    "f32", "--tree", trees[cap]], trees[cap])
        print(f"[spill cost] cap {cap}: {line.strip().splitlines()[-1]}",
              flush=True)


if __name__ == "__main__":
    main()
