"""Where K1, K2 and K3 spend their time, phase by phase, on one NVIDIA GPU.

    python3 scripts/torch_phase_split.py [--reps 5] [--tree DIR] \
        [--flavor all|f32|tf32|bf16] [--widths 2,256,256,256,256,1]

Run from the root of a checkout; ``--tree`` (default: this script's
checkout) names the checkout whose ``tensordiffeq_tpu_torch`` package and
``chip_smoke.py`` are split, so one call can split an older checkout
beside this one.  It copies the kernel sources into a scratch directory
under the git-ignored ``_build/``, instruments the copy (the checkout's
sources are not touched and carry no switch for it), builds the copy, and
runs K1 and K1-bf16 at the Allen-Cahn slice (N = 50,000 points, net
2-128x4-1, C = 4 channels) and on the mixed request set (C = 8), then K2
and K3 at the AC slice (K3 also on the coupled system and the ``1/x``
residual at N = 50,001), then their bf16 flavors (K2-bf16, K3-bf16 on the
AC set and the coupled system) and K2-TF32, K3-TF32 at the AC slice, each
on the route its shape takes in the checkout (the wgmma route of
``wg_backward.cuh``, or in an older checkout the mma.sync kernels: run
``--tree`` on one for the split before it).  ``--only k1`` splits K1's
flavors alone; ``--flavor f32`` (``tf32``, ``bf16``) splits K2 and K3 at
the AC slice in that flavor alone.  ``--widths`` splits K2 and K3 on
another net (default: the slice's 2-128x4-1), such as WIDE_WIDTHS, whose
f32 and TF32 flavors run ``wg_backward_wide.cuh``'s NP = 256 design (its
phases are thread 0's, warpgroup 0's: ``wbw_products`` and ``wbw_dh``
hold the waits for the other warpgroup's half of the exchange).

The instrumentation: every device function named in ``PHASES`` gets a
``clock64()`` stamp at its entry and at each exit, and thread 0 of each
block adds the cycles to that block's counter of the function's phase;
the kernels themselves add their whole run to ``total``.  Each of those
functions ends in a ``__syncthreads()``, so thread 0's span is the block's.
``rest`` is ``total`` less the named phases (inline code in the kernels'
bodies: K2's cotangent load, layer 0's backward, loop overhead, and K1's
f32 table store).  In K1's persistent wgmma route (``taylor_fwd_wg.cuh``)
thread 0 is a thread of the first consumer warpgroup, and its phases are
that warpgroup's: ``k1w_products`` holds its waits for the weight stages
and for its products, while the other warpgroup may run its own pass.
The same holds in K2-TF32's and K3-TF32's wgmma route, whose phases
(``wb_*``) end in no block-wide barrier either.

Printed per kernel and case: the kernel's ms by CUDA events over ``--reps``
launches of the instrumented build, and per phase its share of the
blocks' mean cycles and that share of the kernel's ms.  The stamps cost a
few instructions per phase on one thread; compare the instrumented
kernel's ms with ``chip_smoke.py``'s to see it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# device function -> its phase (an index into LABELS)
LABELS = ["forward products", "head product", "K3 epilogue (tape)",
          "act_fwd", "act_vjp", "workspace copies", "dW (+ partials)",
          "dH", "bias sums", "layer 0 forward", "layer 0 backward",
          "cotangent split", "table store", "dW slot adds",
          "K-major operand writes", "head cotangents",
          "dW lo planes (in place)", "total"]
P = {name: i for i, name in enumerate(LABELS)}
PHASES = {
    "mma_w_rows": str(P["forward products"]),
    "mma_w_cols": str(P["dH"]),
    "mma_dw": str(P["dW (+ partials)"]),
    "narrow_fwd": str(P["head product"]),
    "narrow_dh": str(P["dH"]),
    "narrow_dw": str(P["dW (+ partials)"]),
    "ws_wait": str(P["workspace copies"]),
    "layer0_bwd": str(P["layer 0 backward"]),
    "layer0_fwd": str(P["layer 0 forward"]),
    "act_fwd": str(P["act_fwd"]),
    "act_vjp": str(P["act_vjp"]),
    "bias_accum": str(P["bias sums"]),
    "epilogue": str(P["K3 epilogue (tape)"]),
    # the bf16 flavor's own products and its cotangent split
    "bmma_w_rows": str(P["forward products"]),
    "bmma_w_cols": str(P["dH"]),
    "bmma_dw": str(P["dW (+ partials)"]),
    "split_pieces": str(P["cotangent split"]),
    "table_rows": str(P["table store"]),
    # K1's persistent wgmma route: the head's products and the table store
    # are one pass there
    "k1w_layer0": str(P["layer 0 forward"]),
    "k1w_act": str(P["act_fwd"]),
    "k1w_products": str(P["forward products"]),
    "k1w_head": str(P["head product"]),
    # K2-TF32's and K3-TF32's persistent wgmma route (wg_backward.cuh):
    # its forward is K1's route's (k1w_*: the recomputed layer inputs of
    # the reverse sweep are counted with the forward's passes)
    "wb_products": str(P["forward products"]),
    "wb_act": str(P["act_fwd"]),
    "wb_layer0": str(P["layer 0 forward"]),
    "wb_act_vjp": str(P["act_vjp"]),
    "wb_dh": str(P["dH"]),
    "wb_dw_product": str(P["dW (+ partials)"]),
    "wb_dw_update": str(P["dW slot adds"]),
    "wb_put_kmajor": str(P["K-major operand writes"]),
    "wb_load_p": str(P["workspace copies"]),
    "wb_bias_partial": str(P["bias sums"]),
    "wb_bias": str(P["bias sums"]),
    "wb_head": str(P["head product"]),
    "wb_head_bwd": str(P["head cotangents"]),
    "wb_epilogue": str(P["K3 epilogue (tape)"]),
    "wb_layer0_bwd": str(P["layer 0 backward"]),
    # the f32 flavor's dW: its operands' lo parts made in place between
    # passes (wb_dw3's products and rewrite count as above)
    "wb_lo_in_place": str(P["dW lo planes (in place)"]),
    # the bf16 flavor's dW: H and the cotangent's three pieces as bf16
    # planes (the pieces' writes count as the cotangent split)
    "wb_dw_pieces": str(P["dW (+ partials)"]),
    "wb_put_pieces": str(P["cotangent split"]),
    # the f32 and TF32 flavors' NP = 256 design (wg_backward_wide.cuh): its
    # products with the exchange of the other warpgroup's half inside, dW
    # in its passes (their A loads inside) and its staged slot adds
    "wbw_products": str(P["forward products"]),
    "wbw_dh": str(P["dH"]),
    "wbw_dw_passes": str(P["dW (+ partials)"]),
    "wbw_dw_pass1": str(P["dW (+ partials)"]),
    "wbw_dw_stage": str(P["dW slot adds"]),
    "wbw_put_ht": str(P["K-major operand writes"]),
    "wbw_put_pt": str(P["K-major operand writes"]),
    "wbw_layer0": str(P["layer 0 forward"]),
    "wbw_head": str(P["head product"]),
    "wbw_head_bwd": str(P["head cotangents"]),
    "wbw_bias": str(P["bias sums"]),
    "wbw_layer0_bwd": str(P["layer 0 backward"]),
}
# functions a checkout from before the bf16 flavor's own route, or from
# before K1's wgmma route, lacks
OPTIONAL = {"bmma_w_rows", "bmma_w_cols", "bmma_dw", "split_pieces",
            "k1w_layer0", "k1w_act", "k1w_products", "k1w_head",
            "taylor_fwd_wg_kernel", "taylor_bwd_wg_kernel",
            "minimax_wg_kernel", "taylor_bwd_wbw_kernel",
            "minimax_wbw_kernel"} | {fn for fn in PHASES
                                     if fn.startswith(("wb_", "wbw_"))}
KERNELS = ("taylor_fwd_kernel", "taylor_fwd_wg_kernel", "taylor_bwd_kernel",
           "minimax_step_kernel", "taylor_bwd_wg_kernel", "minimax_wg_kernel",
           "taylor_bwd_wbw_kernel", "minimax_wbw_kernel")
MAXBLK = 1024
NPH = len(LABELS)

HEADER = f"""
#define PS_MAXBLK {MAXBLK}
#define PS_NPH {NPH}
static __device__ unsigned long long ps_cycles[PS_MAXBLK * PS_NPH];
static __device__ __forceinline__ void ps_add(int ph, long long t0) {{
  if (threadIdx.x == 0 && blockIdx.x < PS_MAXBLK)
    ps_cycles[blockIdx.x * PS_NPH + ph] += clock64() - t0;
}}
"""


def _body_span(src: str, start: int) -> tuple[int, int]:
    """(index of the body's ``{``, index of its matching ``}``) for the
    function whose signature starts at ``start``."""
    depth, i = 0, src.index("(", start)
    while True:  # the parameter list
        depth += {"(": 1, ")": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            break
    open_ = src.index("{", i)
    depth, j = 0, open_
    while True:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return open_, j
        j += 1


def _instrument_fn(src: str, pattern: str, phase: str) -> tuple[str, bool]:
    m = re.search(pattern, src)
    if m is None:
        return src, False
    open_, close = _body_span(src, m.start())
    body = src[open_ + 1:close]
    if m.groupdict().get("ret", "void") == "void":
        body = re.sub(r"\breturn;", f"{{ ps_add({phase}, ps_t0); return; }}",
                      body)
    else:
        body = re.sub(r"\breturn\s+([^;]+);",
                      lambda r: f"{{ const {m.group('ret')} ps_r = ({r.group(1)});"
                                f" ps_add({phase}, ps_t0); return ps_r; }}",
                      body)
    new = ("{ const long long ps_t0 = clock64();" + body
           + f"  ps_add({phase}, ps_t0);\n}}")
    return src[:open_] + new + src[close + 1:], True


def instrument(src_dir: str, dst_dir: str) -> list:
    """Copy ``src_dir`` into ``dst_dir`` with the stamps in; returns the
    names of the functions it instrumented, and raises if one of
    ``PHASES`` (but ``OPTIONAL``) or ``KERNELS`` is no longer in the
    sources."""
    os.makedirs(dst_dir, exist_ok=True)
    done = []
    for name in sorted(os.listdir(src_dir)):
        if not name.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(src_dir, name)) as fh:
            src = fh.read()
        if name.endswith(".cuh"):
            src = src.replace("#include <cuda_runtime.h>",
                              "#include <cuda_runtime.h>\n" + HEADER, 1)
        for fn, phase in PHASES.items():
            pat = (r"static\s+__device__\s+(?:__forceinline__\s+|"
                   r"__noinline__\s+)?(?P<ret>void|int)\s+" + fn + r"\s*\(")
            src, hit = _instrument_fn(src, pat, phase)
            if hit:
                done.append(fn)
        for k in KERNELS:
            pat = (r"__global__\s+void\s+(?:__launch_bounds__\("
                   r"(?:[^()]|\([^()]*\))*\)\s*)?" + k + r"\s*\(")
            src, hit = _instrument_fn(src, pat, str(P["total"]))
            if hit:
                done.append(k)
        if name.endswith(".cu"):
            stem = name[:-3]
            src += f"""
extern "C" int tdq_ps_read_{stem}(unsigned long long* out, int reset) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, ps_cycles, sizeof(ps_cycles));
  if (e != cudaSuccess || !reset) return (int)e;
  static unsigned long long zero[PS_MAXBLK * PS_NPH];
  return (int)cudaMemcpyToSymbol(ps_cycles, zero, sizeof(zero));
}}
"""
        with open(os.path.join(dst_dir, name), "w") as fh:
            fh.write(src)
    missing = sorted((set(PHASES) | set(KERNELS)) - set(done) - OPTIONAL)
    if missing:
        raise SystemExit(f"FAILED: not found in {src_dir}: "
                         f"{', '.join(missing)}")
    return done


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose kernels are split")
    ap.add_argument("--only", choices=("k1",), default=None,
                    help="split K1's flavors alone")
    ap.add_argument("--flavor", choices=("all", "f32", "tf32", "bf16"),
                    default="all",
                    help="split K2 and K3 at the AC slice in this flavor "
                    "alone (default: every kernel and flavor)")
    ap.add_argument("--widths", default=None,
                    help="K2's and K3's net, comma-separated (default: "
                    "chip_smoke.WIDTHS)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        sys.exit("FAILED: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    if not os.path.abspath(ct.__file__).startswith(tree):
        sys.exit(f"FAILED: imported {ct.__file__}, not the package in {tree}")

    scratch = os.path.join(ct.BUILD_DIR, "phase_split")
    shutil.rmtree(scratch, ignore_errors=True)
    done = instrument(ct.CSRC, os.path.join(scratch, "csrc"))
    ct.CSRC = os.path.join(scratch, "csrc")
    ct.BUILD_DIR = os.path.join(scratch, "build")
    lib = ct.build()
    print(card_line(), flush=True)
    print(f"[phase-split] {tree}: instrumented {', '.join(done)}", flush=True)

    buf = (ctypes.c_ulonglong * (MAXBLK * NPH))()

    def read(stems):
        """The stamps of the translation units ``stems`` (those the build
        has), summed, and reset."""
        total = np.zeros((MAXBLK, NPH), dtype=np.uint64)
        torch.cuda.synchronize()
        for stem in stems:
            try:
                fn = getattr(lib, f"tdq_ps_read_{stem}")
            except AttributeError:  # a checkout without this unit
                continue
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            ct._check(fn(buf, 1), "reading the stamps")
            total += np.ctypeslib.as_array(buf).reshape(MAXBLK, NPH)
        return total

    def split(label, stem, launch):
        stem = (stem,) if isinstance(stem, str) else stem
        for _ in range(2):
            launch()
        read(stem)  # reset
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        cyc = read(stem)
        blocks = cyc[:, P["total"]] > 0
        mean = cyc[blocks].mean(0)
        total = mean[P["total"]]
        named = mean[:P["total"]]
        rest = total - named.sum()
        print(f"[split {label}] {ms:.3f} ms per launch (instrumented, mean "
              f"of {args.reps}), {int(blocks.sum())} blocks, "
              f"{total / args.reps:.0f} cycles per block per launch",
              flush=True)
        rows = [(LABELS[i], named[i]) for i in range(len(named))
                if named[i] > 0] + [("rest (inline code)", rest)]
        for name, c in sorted(rows, key=lambda kv: -kv[1]):
            print(f"[split {label}]   {100 * c / total:5.1f} %  "
                  f"{ms * c / total:.3f} ms  {name}", flush=True)

    # the same inputs as chip_smoke.py's phases 3-5
    import chip_smoke as cs
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    n = cs.N_POINTS
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, n),
                                  rng.uniform(0, 1, n)], 1),
                        dtype=torch.float32, device=dev)
    widths0 = (cs.WIDTHS if args.widths is None
               else [int(v) for v in args.widths.split(",")])
    layers = neural_net(widths0, device=dev, seed=0).layers()
    flat_layers = [t.detach() for pair in layers for t in pair]
    plan = ct.build_cuda_table_fn(cs.AC_REQUESTS,
                                  [tuple(W.shape) for W, _ in layers]).plan
    flat = plan.pack(flat_layers)
    for label, reqs in ((("ac", cs.AC_REQUESTS), ("mixed", cs.MIXED_REQUESTS))
                        if args.flavor == "all" else ()):
        p1 = ct.build_cuda_table_fn(reqs, [tuple(W.shape)
                                           for W, _ in layers]).plan
        f1 = p1.pack(flat_layers)
        # K1's routes: the wgmma one (its flavors' units) where the
        # checkout has it, else the kernel beside K2
        units = ("taylor_table",) + tuple(
            f"taylor_fwd_wg_{f}_{n}" for f in ("f32", "bf16") for n in (64, 128))
        split(f"K1 {label}", units, lambda: ct.k1_forward(p1, X, f1))
        split(f"K1-bf16 {label}", units,
              lambda: ct.k1_forward_bf16(p1, X, f1))
    if args.only == "k1":
        print(card_line(), flush=True)
        return
    g = torch.as_tensor(rng.randn(plan.C, n, 1), dtype=torch.float32,
                        device=dev)
    # every flavor on the route its shape takes: the wgmma route
    # (wg_backward.cuh's instances) where the checkout has it, else the
    # mma.sync kernels
    k2_units = ("taylor_table", "taylor_bwd_wg_f32_256",
                "taylor_bwd_wg_tf32_256") + tuple(
        f"taylor_bwd_wg_{f}_{n}" for f in ("f32", "tf32", "bf16")
        for n in (64, 128))
    k3_units = ("minimax_step", "minimax_wg_f32_256",
                "minimax_wg_tf32_256") + tuple(
        f"minimax_wg_{f}_{n}" for f in ("f32", "tf32", "bf16")
        for n in (64, 128))
    f32, tf32 = args.flavor in ("all", "f32"), args.flavor in ("all", "tf32")
    bf16 = args.flavor in ("all", "bf16")
    if f32:
        split("K2 ac", k2_units, lambda: ct.k2_backward(plan, X, flat, g))
    if bf16:
        split("K2-bf16 ac", k2_units,
              lambda: ct.k2_backward_bf16(plan, X, flat, g))
    if tf32:
        split("K2-TF32 ac", k2_units,
              lambda: ct.k2_backward_tf32(plan, X, flat, g))

    for label, f_model, widths, nk, (lo, hi) in (
            ("ac", cs._ac_residual, widths0, n, (-1.0, 1.0)),
            ("system", cs._coupled_residual, widths0[:-1] + [2], n,
             (-1.0, 1.0)),
            ("singular", cs._singular_residual, widths0, n + 1,
             (0.5, 1.5)))[:3 if args.flavor == "all" else 1]:
        lay = neural_net(widths, device=dev, seed=0).layers()
        sq = build_minimax_sq_fn(f_model, ("x", "t"), widths[-1],
                                 analyze_f_model(f_model, ("x", "t"),
                                                 widths[-1]),
                                 [tuple(W.shape) for W, _ in lay])
        Xk = torch.as_tensor(np.stack([rng.uniform(lo, hi, nk),
                                       rng.uniform(0, 1, nk)], 1),
                             dtype=torch.float32, device=dev)
        w = torch.as_tensor(rng.rand(nk, sq.plan.E) ** 2,
                            dtype=torch.float32, device=dev)
        fl = sq.plan.pack([a.detach() if a.ndim == 2 else
                           a.detach().reshape(1, -1)
                           for pair in lay for a in pair])
        if f32:
            split(f"K3 {label}", k3_units,
                  lambda: cm.k3_minimax(sq.plan, Xk, w, fl))
        if label == "ac" and tf32:
            split("K3-TF32 ac", k3_units,
                  lambda: cm.k3_minimax_tf32(sq.plan, Xk, w, fl))
        if label != "singular" and bf16:
            split(f"K3-bf16 {label}", k3_units,
                  lambda: cm.k3_minimax_bf16(sq.plan, Xk, w, fl))
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
