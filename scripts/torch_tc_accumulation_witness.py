"""Why the f32 wgmma route sums each weight chunk's products in an
accumulator of its own: the forward's three TF32 passes under the tensor
cores' truncating accumulation, emulated on the CPU.

    python scripts/torch_tc_accumulation_witness.py [--n 20000]

The Allen-Cahn slice's net (2-128x4-1 from seed 0, the residual u_t -
1e-4 u_xx + 5u^3 - 5u) at ``--n`` points drawn as ``chip_smoke.py``'s phase
5 draws them (``numpy.random.RandomState(1)``).  Each hidden product is
taken as the route takes it (A and W split as split_tf32 splits them, each
lo read by the tensor cores with its low 13 bits dropped), under one of
these accumulation models, every pass's sum added into an f32 accumulator
rounded toward zero, as the tensor cores round it:

* ``rn``: three passes, the sums rounded to nearest (no truncation);
* ``one``: the 48 passes of a 128-deep product into one accumulator, each
  k step's three passes in a row (K1's route, and this route before);
* ``chunk``: each chunk of 32 k rows (12 passes) into an accumulator of
  its own, the chunks' sums added rounded to nearest;
* ``chunk-small``: the same, the chunk's 8 small passes (A_lo B_hi, A_hi
  B_lo) before its 4 A_hi B_hi passes (this route's forward, wb_chunk3);
* ``kstep``: each k step's three passes into an accumulator of its own
  (the mma.sync kernels' order);
* ``ieee``: the plain flavor's float32 products.

Printed per model: the distance to the float64 table's of the value sum_p
w f^2 and of the head bias's gradient sum_p 2 w f df/du (a sum over
points that cancels, so a drift of every hidden activation toward zero
shows in it). The tape (``ops/residual_tape.py``) gives f and its
cotangent.  Takes about a minute at the default size.
"""
import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODELS = ("ieee", "rn", "one", "chunk", "chunk-small", "kstep")
WIDTHS = [2, 128, 128, 128, 128, 1]


def tc_read(t):
    """An f32 operand as the tensor cores read it: the low 13 bits
    dropped."""
    return (t.view(torch.int32) & -8192).view(torch.float32)


def rz32(v):
    """float64 ``v`` to float32, rounded toward zero."""
    x = v.float()
    over = x.double().abs() > v.abs()
    x[over] = torch.nextafter(x[over], torch.zeros_like(x[over]))
    return x


def product(A, B, model):
    """A B ([R, K] x [K, N], float32) as the model takes it."""
    from tensordiffeq_tpu_torch.ops.taylor import rna_tf32
    if model == "ieee":
        return A @ B
    ah, bh = rna_tf32(A), rna_tf32(B)
    al, bl = tc_read(A - ah), tc_read(B - bh)
    if model == "rn":
        return al @ bh + ah @ bl + ah @ bh
    steps = A.shape[1] // 8
    per = {"one": steps, "kstep": 1}.get(model, 4)  # k steps a sum
    out = torch.zeros(A.shape[0], B.shape[1])
    for c0 in range(0, steps, per):
        ks = range(c0, c0 + per)
        if model == "chunk-small":
            order = [(s, a, b) for s in ks for a, b in ((al, bh), (ah, bl))]
            order += [(s, ah, bh) for s in ks]
        else:
            order = [(s, a, b) for s in ks
                     for a, b in ((al, bh), (ah, bl), (ah, bh))]
        acc = torch.zeros_like(out)
        for s, a, b in order:
            k = slice(8 * s, 8 * s + 8)
            acc = rz32(acc.double() + a[:, k].double() @ b[k].double())
        out = out + acc
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn

    def f_model(u, x, t):
        g, uv = tdqt.grad, u(x, t)
        return (g(u, "t")(x, t) - 0.0001 * g(g(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    n = args.n
    layers = neural_net(WIDTHS, device="cpu", seed=0).layers()
    Ws = [W.detach().float() for W, _ in layers]
    bs = [b.detach().float() for _, b in layers]
    rng = np.random.RandomState(1)
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, n),
                                  rng.uniform(0, 1, n)], 1),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.rand(n) ** 2, dtype=torch.float32)
    reqs = analyze_f_model(f_model, ("x", "t"), 1)
    plan = build_minimax_sq_fn(f_model, ("x", "t"), 1, reqs,
                               [tuple(W.shape) for W in Ws],
                               device="cpu").plan
    _, rows = ct.channel_schedule(set(plan.mis))

    def act(P):
        # the activation pass: tanh's chain and each channel's line
        z = torch.tanh(P[:, 0])
        d1 = 1 - z * z
        d2 = -2 * z * d1
        H = torch.zeros_like(P)
        for c, (o, ix) in enumerate(rows):
            if o == 1:
                H[:, c] = d1 * P[:, c]
            elif o == 2:
                H[:, c] = d1 * P[:, c] + d2 * P[:, ix[0]] * P[:, ix[1]]
            elif o != 0:
                raise ValueError("the slice's channels are of order <= 2")
        H[:, 0] = z
        return H

    def table(model, dt):
        H = torch.zeros(n, len(rows), Ws[0].shape[1], dtype=dt)
        H[:, 0] = X.to(dt) @ Ws[0].to(dt) + bs[0].to(dt)
        for c, (o, ix) in enumerate(rows):
            if o == 1:
                H[:, c] = Ws[0][ix[0]].to(dt)
        H = act(H)
        for l in range(1, len(Ws) - 1):
            flatH = H.reshape(-1, H.shape[2])
            P = (flatH @ Ws[l].double() if dt == torch.float64
                 else product(flatH, Ws[l], model)).reshape(H.shape)
            P[:, 0] += bs[l].to(dt)
            H = act(P)
        T = H @ Ws[-1].to(dt)
        T[:, 0] += bs[-1].to(dt)
        return T

    def value_and_db(T):
        cols = [T[:, c, o] for c in range(plan.C) for o in range(plan.n_out)]
        regs = plan.tape.forward(cols, [X[:, k].to(T.dtype)
                                        for k in range(plan.d)])
        f = regs[plan.tape.outputs[0]]
        ww = w.to(T.dtype)
        g_tab, _ = plan.tape.reverse(regs, [2 * ww * f])
        return float((ww * f * f).sum()), float(g_tab[0].sum())

    ref = value_and_db(table(None, torch.float64))
    print(f"[tc accumulation] N={n}: float64 value {ref[0]:.9e}, head bias "
          f"gradient {ref[1]:.9e}", flush=True)
    for model in MODELS:
        v, db = value_and_db(table(model, torch.float32))
        print(f"[tc accumulation] {model:12s} value {abs(v - ref[0]) / abs(ref[0]):.3e}"
              f", head bias gradient {abs(db - ref[1]) / abs(ref[1]):.3e} "
              f"(relative to float64)", flush=True)


if __name__ == "__main__":
    main()
