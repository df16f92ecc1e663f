"""Compare the SASS of the port's kernels between two checkouts,
instruction for instruction, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_diff.py --a _compare/parent --b . \\
        taylor_bwd_kernel minimax_step_kernel reduce_partials

Each checkout's kernels are built by its own ``ops/cuda_taylor.py::build``
(in a subprocess, into its git-ignored ``_build/``); ``cuobjdump -sass``
lists each library's functions.  For every function whose mangled name
holds one of the given names, the instructions (addresses and encodings
dropped) of the two builds are compared.  One line per function:
``identical``, or ``DIFFERS`` with both instruction counts; exit code 1
if any differs or is missing from one build.
"""
import argparse
import os
import re
import subprocess
import sys

BUILD = ("import sys; sys.path.insert(0, {tree!r}); "
         "from tensordiffeq_tpu_torch.ops import cuda_taylor as ct; "
         "ct.build(); print(ct.BUILD_DIR); print(ct.source_digest())")


def library(tree: str) -> str:
    out = subprocess.run([sys.executable, "-c", BUILD.format(tree=tree)],
                         capture_output=True, text=True, check=True)
    build_dir, digest = out.stdout.split()[-2:]
    return os.path.join(build_dir, f"libtdq_kernels_{digest}.so")


def functions(so: str, cuobjdump: str) -> dict:
    """Mangled name -> its instructions, as text."""
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        funcs[name.strip()] = [
            m.group(1).strip() for m in
            re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", body)]
    return funcs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="a checkout (the parent)")
    ap.add_argument("--b", required=True, help="another (the change)")
    ap.add_argument("--cuobjdump", default="/usr/local/cuda/bin/cuobjdump")
    ap.add_argument("names", nargs="+", help="kernel names to compare")
    args = ap.parse_args()
    a = functions(library(os.path.abspath(args.a)), args.cuobjdump)
    b = functions(library(os.path.abspath(args.b)), args.cuobjdump)
    bad = 0
    for fn in sorted(set(a) | set(b)):
        if not any(n in fn for n in args.names):
            continue
        if fn not in a or fn not in b:
            print(f"[sass] {fn}: only in {'b' if fn in b else 'a'}")
            bad += 1
        elif a[fn] == b[fn]:
            print(f"[sass] {fn}: identical ({len(a[fn])} instructions)")
        else:
            print(f"[sass] {fn}: DIFFERS ({len(a[fn])} against "
                  f"{len(b[fn])} instructions)")
            bad += 1
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
