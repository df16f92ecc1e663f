"""Where a fleet tenant's first load spends its time, in a fresh process on
one NVIDIA GPU: the one-time costs of the process against the load of a
second tenant of the same shape.

    python3 scripts/torch_fleet_coldstart.py [--out coldstart.json]

Two AC-SA surrogates at full width (2-128x4-1, random weights from seeds
0 and 1) are exported as fleet artifacts on the ladder 256-4,096.  Then,
in this process, for the first and for the second artifact (a tenant
with its ``f_model``): ``Surrogate.load``, the engine, and each kind's
first touch of each rung (its three eager warm-ups, its capture and its
first replay), every span ending in ``torch.cuda.synchronize()``; the
seconds of each capture alone (``training/graphs.py::captures``); and a
tenant with no ``f_model`` (the lowered tape) loaded after them.  Before
any of it: the import of ``torch.fx``'s tracer (the residual tape's
lowering imports it), and one eager run of the generic residual program
at 256 rows on the card and a second one (``torch.func.vmap``'s first
use in the process), so the process's one-time costs stand apart from a
tenant's own.  Prints one ``[coldstart ...]`` line per step and writes
the same as JSON with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WIDTHS = [2, 128, 128, 128, 128, 1]
LADDER = dict(min_bucket=256, max_bucket=4096)


def f_model(u, x, t):
    from tensordiffeq_tpu_torch import grad
    u_xx = grad(grad(u, "x"), "x")
    u_t = grad(u, "t")
    uv = u(x, t)
    return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    torch.cuda.init()
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import fleet
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.serving import Surrogate
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.utils import ieee_f32

    rows = {"imports_and_cuda_init_s": time.perf_counter() - t_start}
    card = torch.cuda.get_device_name(0)

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rows[label] = time.perf_counter() - t0
        print(f"[coldstart] {label} {rows[label]:.4f} s", flush=True)
        return out

    timed("kernel_library_s", ct.build)

    # the process's one-time costs, before any tenant: the generic
    # residual program's first eager runs, then the tracer's import
    net = tdqt.neural_net(WIDTHS, seed=0)
    probe = Surrogate(net, net.params(), ("x", "t"), f_model=f_model)
    prog = probe.engine(**LADDER).make_batched("residual")()
    X = torch.zeros(LADDER["min_bucket"], 2, device="cuda")

    def run():
        with ieee_f32(), torch.no_grad():
            return prog(probe.params, X)

    timed("residual_first_eager_s", run)
    timed("residual_second_eager_s", run)
    timed("import_fx_tracer_s", lambda: __import__(
        "torch.fx.experimental.proxy_tensor"))

    work = tempfile.mkdtemp(prefix="tdq_coldstart_")
    arts = []
    for seed in (0, 1):
        net = tdqt.neural_net(WIDTHS, seed=seed)
        sur = Surrogate(net, net.params(), ("x", "t"), f_model=f_model)
        art = os.path.join(work, f"s{seed}")
        timed(f"export{seed}_s", lambda: fleet.export_fleet_artifact(
            sur, art, **LADDER))
        arts.append(art)

    for i, (art, fm) in enumerate(((arts[0], f_model), (arts[1], f_model),
                                   (arts[1], None))):
        tag = f"tenant{i}" + ("" if fm else "_tape")
        sur = timed(f"{tag}_load_s", lambda: Surrogate.load(art, f_model=fm))
        eng = timed(f"{tag}_engine_s", lambda: sur.engine(**LADDER))
        if fm is None:
            timed(f"{tag}_warm_start_s", lambda: fleet.warm_start(eng))
            continue
        for kind in ("u", "residual"):
            for b in eng.bucket_sizes:
                n0 = len(graphs.captures)
                timed(f"{tag}_{kind}_{b}_first_touch_s",
                      lambda: eng.op_for(kind)(np.zeros((b, 2), np.float32)))
                rows[f"{tag}_{kind}_{b}_capture_s"] = sum(
                    c["seconds"] for c in graphs.captures[n0:])
    rows["card"] = card
    print(f"[coldstart] {json.dumps(rows)}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
