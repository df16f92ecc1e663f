"""Registers, spills and stack of the port's kernels as ``ptxas`` reports
them, on a machine with the CUDA toolkit.

    python3 scripts/torch_ptxas_report.py minimax_wg_f32_128.cu \\
        taylor_bwd_wg_f32_64.cu [--match minimax_wg_kernel ...]

Compiles each named translation unit of ``tensordiffeq_tpu_torch/csrc``
(all at once, one ``nvcc`` each, with the library build's flags and
``-Xptxas -v``) into a scratch directory under the git-ignored
``_build/``, and prints one line per kernel entry whose mangled name holds
one of ``--match`` (default: every entry): its name with its template
arguments, registers, spill stores and loads, and stack frame.  Exit code
1 if a unit does not compile.
"""
import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readable(mangled: str) -> str:
    """``_Z17minimax_wg_kernelILi0ELi128ELi4EEv...`` ->
    ``minimax_wg_kernel<0,128,4>``."""
    m = re.match(r"_ZL?\d+(\w+?)I((?:Li-?\d+E|Lb[01]E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](-?\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def parse(log: str) -> list:
    """(entry, registers, spill stores, spill loads, stack bytes) of each
    entry function in ``ptxas -v``'s output."""
    rows, entry, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = (int(m.group(1)), int(m.group(2)), int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1)), frame[1], frame[2],
                         frame[0]))
            entry = None
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("units", nargs="+", help=".cu files under csrc/")
    ap.add_argument("--match", nargs="*", default=[],
                    help="report only entries whose names hold one of these")
    args = ap.parse_args()
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    nvcc = ct.find_nvcc()
    os.makedirs(ct.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=ct.BUILD_DIR)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    try:
        procs = [(u, subprocess.Popen(
            [nvcc] + flags + ["-c", os.path.join(ct.CSRC, u), "-o",
                              os.path.join(work, u + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for u in args.units]
        bad = 0
        for unit, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                print(f"[ptxas] {unit}: nvcc failed ({proc.returncode}):\n"
                      f"{err[-4000:]}", flush=True)
                bad += 1
                continue
            for entry, regs, st, ld, stack in parse(out + err):
                if args.match and not any(n in entry for n in args.match):
                    continue
                print(f"[ptxas] {unit}: {readable(entry)} {regs} registers, "
                      f"spill stores {st} B, spill loads {ld} B, stack "
                      f"{stack} B", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
