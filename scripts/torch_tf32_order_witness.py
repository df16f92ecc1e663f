"""How far two sum orders of the same single-pass TF32 semantics fall apart.

The kernels' TF32 flavor (precision ``None``) rounds both operands of every
product to TF32 (``cvt.rna``) and sums in float32.  Rounding a layer's
input to TF32 is discontinuous, so two implementations that differ only in
the order of their float32 sums round the few operands that sit on a TF32
rounding boundary to neighbouring values, a TF32 unit apart, and their
tables differ by far more than float32 rounding.  This script measures it
on the CPU with no kernel: the Taylor table of the plain flavor's
TF32-emulating mode (``taylor_derivatives(emulate_tf32=True)``, float32
sums) against the same products summed in float64
(``emulate_tf32="float64"``), beside the distance of either to the IEEE
float32 table, for the card tests' shapes and the Allen-Cahn slice's::

    python scripts/torch_tf32_order_witness.py [--n-slice 50000]

One line per case: the scale-relative max (max |a - b| / max |b| over the
channels) and RMS-relative distances.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives  # noqa: E402

AC = {(), (1,), (0, 0)}


def net(widths, seed=0):
    g = torch.Generator().manual_seed(seed)
    layers = [((torch.randn(a, b, generator=g) / a ** 0.5),
               (0.1 * torch.randn(b, generator=g)))
              for a, b in zip(widths[:-1], widths[1:])]
    return layers, g


def dist(a, b):
    keys = sorted(b)
    A = torch.cat([a[k].reshape(-1) for k in keys]).double()
    B = torch.cat([b[k].reshape(-1) for k in keys]).double()
    mx = max(float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in keys)
    return mx, float((A - B).pow(2).mean().sqrt() / B.pow(2).mean().sqrt())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-slice", type=int, default=50_000)
    n = ap.parse_args().n_slice
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    cases = [("ac", [2, 64, 64, 1], 1000), ("deep", [2] + [32] * 5 + [1], 517),
             ("slice", [2, 128, 128, 128, 128, 1], n)]
    for name, widths, N in cases:
        layers, g = net(widths)
        X = 2 * torch.rand(N, widths[0], generator=g) - 1
        with torch.no_grad():
            f32 = taylor_derivatives(layers, X, AC, flat_matmul=True,
                                     emulate_tf32=True)
            f64 = taylor_derivatives(layers, X, AC, flat_matmul=True,
                                     emulate_tf32="float64")
            ieee = taylor_derivatives(layers, X, AC, flat_matmul=True)
        s_max, s_rms = dist(f32, f64)
        i_max, i_rms = dist(f32, ieee)
        print(f"[{name}] widths {widths} N={N}: float32 vs float64 sums of "
              f"the TF32 products {s_max:.3e} max, {s_rms:.3e} RMS; TF32 vs "
              f"IEEE {i_max:.3e} max, {i_rms:.3e} RMS", flush=True)


if __name__ == "__main__":
    main()
