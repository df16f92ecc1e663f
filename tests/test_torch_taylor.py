"""The Taylor table of the PyTorch port against the JAX package's.

* the plain flavor (``tensordiffeq_tpu_torch.ops.taylor``) against JAX
  ``taylor_derivatives`` and against the Pallas table kernel run in
  interpret mode (``tensordiffeq_tpu.ops.pallas_taylor``), values and the
  gradients of a scalar loss over the table w.r.t. every layer and X;
* the CUDA kernels' channel schedule and hand-written transposed recurrence,
  mirrored line by line in PyTorch (float64), against autograd of the plain
  flavor — the derivation the kernels interpret, checked on the CPU;
* the kernel wrapper's dispatch: CPU tensors take the plain flavor and count
  no launch; a CUDA build needs a card.  The kernels themselves run only on
  the card: ``tests/test_torch_cuda.py``.

Tolerance rtol 1e-5 / atol 1e-6, the ``tests/test_pallas.py`` band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensordiffeq_tpu.networks import neural_net as jax_net
from tensordiffeq_tpu.ops.pallas_taylor import build_pallas_table_fn
from tensordiffeq_tpu.ops.taylor import extract_mlp_layers
from tensordiffeq_tpu.ops.taylor import taylor_derivatives as jax_table
from tensordiffeq_tpu_torch.ops import cuda_taylor
from tensordiffeq_tpu_torch.ops.taylor import channel_order, taylor_derivatives
from tensordiffeq_tpu_torch.utils import CudaUnavailableError
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

# mixed 3rd order and unmixed 4th order
REQS = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    net = jax_net([2, 16, 16, 1])
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    X = (np.random.RandomState(0).randn(70, 2) * 0.5).astype(np.float32)
    jl = extract_mlp_layers(params)
    tl = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    shapes = [tuple(W.shape) for W, _ in jl]
    return jl, tl, X, shapes


def _loss_jax(t):
    return (jnp.mean(t[(0, 0)] ** 2) + jnp.mean(t[()] ** 3)
            + jnp.mean(t[(0, 1)] * t[(1,)])
            + jnp.mean(t[(0, 0, 0, 0)] * t[(0, 0, 1)]))


def _loss_torch(t):
    return (torch.mean(t[(0, 0)] ** 2) + torch.mean(t[()] ** 3)
            + torch.mean(t[(0, 1)] * t[(1,)])
            + torch.mean(t[(0, 0, 0, 0)] * t[(0, 0, 1)]))


def _torch_grads(tl, X, table_fn):
    layers = [(W.clone().requires_grad_(True), b.clone().requires_grad_(True))
              for W, b in tl]
    Xt = torch.from_numpy(X).requires_grad_(True)
    loss = _loss_torch(table_fn(layers, Xt))
    flat = [t for p in layers for t in p]
    grads = torch.autograd.grad(loss, flat + [Xt])
    return [g.numpy() for g in grads]


def _jax_grads(jl, X, table_fn):
    gl, gx = jax.jit(jax.grad(lambda l, x: _loss_jax(table_fn(l, x)),
                              argnums=(0, 1)))(jl, jnp.asarray(X))
    return [np.asarray(a) for p in gl for a in p] + [np.asarray(gx)]


@pytest.mark.parametrize("flat_matmul", [False, True])
def test_plain_table_matches_jax(setup, flat_matmul):
    jl, tl, X, _ = setup
    want = jax_table(jl, jnp.asarray(X), REQS)
    got = taylor_derivatives(tl, torch.from_numpy(X), REQS,
                             flat_matmul=flat_matmul)
    assert set(got) == set(want)
    for mi in want:
        np.testing.assert_allclose(got[mi].numpy(), np.asarray(want[mi]),
                                   **TOL, err_msg=str(mi))


def test_plain_table_grads_match_jax(setup):
    jl, tl, X, _ = setup
    want = _jax_grads(jl, X, lambda l, x: jax_table(l, x, REQS))
    got = _torch_grads(tl, X, lambda l, x: taylor_derivatives(l, x, REQS))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_plain_table_matches_interpret_pallas(setup):
    """N = 70 is not a multiple of the tile (32): the Pallas pad path."""
    jl, tl, X, shapes = setup
    pallas = build_pallas_table_fn(REQS, shapes, tile=32, interpret=True)
    want = pallas(jl, jnp.asarray(X))
    producer = cuda_taylor.build_cuda_table_fn(REQS, shapes, device="cpu")
    got = producer(tl, torch.from_numpy(X))
    assert set(got) == set(want)
    for mi in want:
        np.testing.assert_allclose(got[mi].numpy(), np.asarray(want[mi]),
                                   **TOL, err_msg=str(mi))
    g_want = _jax_grads(jl, X, pallas)
    g_got = _torch_grads(tl, X, producer)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a, b, **TOL)


# ------------------------------------------------------------------ #
# the kernels' schedule and transposed recurrence, mirrored in PyTorch
# (csrc/taylor_table.cu: layer0_fwd, act_fwd, act_vjp, the reverse sweep)
# ------------------------------------------------------------------ #
def _chain(u):
    z = torch.tanh(u)
    d1 = 1 - z * z
    d2 = -2 * z * d1
    d3 = -2 * d1 * (1 - 3 * z * z)
    d4 = -2 * d2 * (1 - 3 * z * z) + 12 * z * d1 * d1
    return z, d1, d2, d3, d4


def _act_fwd(P, rows):
    z, d1, d2, d3, d4 = _chain(P[:, 0])
    H = P.clone()
    for c in range(len(rows) - 1, 0, -1):
        o, ix = rows[c]
        Pc = P[:, c]
        if o == 1:
            h = d1 * Pc
        elif o == 2:
            h = d1 * Pc + d2 * P[:, ix[0]] * P[:, ix[1]]
        elif o == 3:
            qi, qj, qk, rij, rik, rjk = (P[:, i] for i in ix)
            h = (d3 * qi * qj * qk + d2 * (rij * qk + rik * qj + rjk * qi)
                 + d1 * Pc)
        else:
            q, r, v = (P[:, i] for i in ix)
            h = (d1 * Pc + 4 * d2 * v * q + 3 * d2 * r * r
                 + 6 * d3 * r * q * q + d4 * q ** 4)
        H[:, c] = h
    H[:, 0] = z
    return H


def _act_vjp(P, dH, rows):
    z, d1, d2, d3, d4 = _chain(P[:, 0])
    G = torch.zeros_like(P)
    gz, gd1, gd2, gd3, gd4 = dH[:, 0], 0, 0, 0, 0
    for c in range(1, len(rows)):
        o, ix = rows[c]
        g, Pc = dH[:, c], P[:, c]
        gd1 = gd1 + g * Pc
        G[:, c] += g * d1
        if o == 2:
            a, b = P[:, ix[0]], P[:, ix[1]]
            gd2 = gd2 + g * a * b
            G[:, ix[0]] += g * d2 * b
            G[:, ix[1]] += g * d2 * a
        elif o == 3:
            qi, qj, qk, rij, rik, rjk = (P[:, i] for i in ix)
            gd3 = gd3 + g * qi * qj * qk
            gd2 = gd2 + g * (rij * qk + rik * qj + rjk * qi)
            G[:, ix[0]] += g * (d3 * qj * qk + d2 * rjk)
            G[:, ix[1]] += g * (d3 * qi * qk + d2 * rik)
            G[:, ix[2]] += g * (d3 * qi * qj + d2 * rij)
            G[:, ix[3]] += g * d2 * qk
            G[:, ix[4]] += g * d2 * qj
            G[:, ix[5]] += g * d2 * qi
        elif o == 4:
            q, r, v = (P[:, i] for i in ix)
            gd2 = gd2 + g * (4 * v * q + 3 * r * r)
            gd3 = gd3 + g * 6 * r * q * q
            gd4 = gd4 + g * q ** 4
            G[:, ix[0]] += g * (4 * d2 * v + 12 * d3 * r * q + 4 * d4 * q ** 3)
            G[:, ix[1]] += g * (6 * d2 * r + 6 * d3 * q * q)
            G[:, ix[2]] += g * 4 * d2 * q
    z2 = z * z
    d5 = d1 * (16 - z2 * (120 - 120 * z2))
    G[:, 0] += gz * d1 + gd1 * d2 + gd2 * d3 + gd3 * d4 + gd4 * d5
    return G


def _mirror_forward(layers, X, rows):
    """Pre-activation channels per hidden layer, and the head's output."""
    W0, b0 = layers[0]
    P = torch.zeros(X.shape[0], len(rows), W0.shape[1], dtype=X.dtype)
    P[:, 0] = X @ W0 + b0
    for c, (o, ix) in enumerate(rows):
        if o == 1:
            P[:, c] = W0[ix[0]]
    Ps = [P]
    H = _act_fwd(P, rows)
    for li, (W, b) in enumerate(layers[1:], 1):
        P = H @ W
        P[:, 0] += b
        if li < len(layers) - 1:
            Ps.append(P)
            H = _act_fwd(P, rows)
    return Ps, P


def _mirror_backward(layers, X, rows, g):
    Ps, _ = _mirror_forward(layers, X, rows)
    grads = [None] * len(layers)
    dP = g
    grads[-1] = (torch.einsum("nci,nco->io", _act_fwd(Ps[-1], rows), dP),
                 dP[:, 0].sum(0))
    dH = dP @ layers[-1][0].T
    for li in range(len(layers) - 2, -1, -1):
        dP = _act_vjp(Ps[li], dH, rows)
        W = layers[li][0]
        if li > 0:
            H = _act_fwd(Ps[li - 1], rows)
            grads[li] = (torch.einsum("nci,nco->io", H, dP), dP[:, 0].sum(0))
            dH = dP @ W.T
        else:
            gW = X.T @ dP[:, 0]
            for c, (o, ix) in enumerate(rows):
                if o == 1:  # constant one-hot seed along ix[0]
                    gW[ix[0]] += dP[:, c].sum(0)
            grads[0] = (gW, dP[:, 0].sum(0))
            dX = dP[:, 0] @ W.T
    return [t for p in grads for t in p] + [dX]


@pytest.mark.parametrize("reqs", [
    {(), (1,), (0, 0)},                                   # Allen-Cahn
    REQS,                                                 # mixed 3rd + 4th
    {(), (0, 1, 1), (1, 1, 1, 1), (0, 0, 0)},             # other directions
], ids=["ac", "mixed", "reversed"])
def test_kernel_schedule_and_vjp_match_autograd(reqs):
    g = torch.Generator().manual_seed(0)
    widths = [2, 7, 5, 6, 1]
    layers = [(0.7 * torch.randn(a, b, generator=g, dtype=torch.float64),
               0.3 * torch.randn(b, generator=g, dtype=torch.float64))
              for a, b in zip(widths[:-1], widths[1:])]
    X = 0.5 * torch.randn(13, 2, generator=g, dtype=torch.float64)
    channels, rows = cuda_taylor.channel_schedule(reqs)
    assert channels == channel_order(reqs)
    _, head = _mirror_forward(layers, X, rows)
    params = [t.clone().requires_grad_(True) for p in layers for t in p]
    Xg = X.clone().requires_grad_(True)
    ref = taylor_derivatives(list(zip(params[0::2], params[1::2])), Xg, reqs)
    for c, mi in enumerate(channels):
        torch.testing.assert_close(head[:, c], ref[mi].detach(),
                                   rtol=1e-12, atol=1e-12)
    cot = torch.randn(13, len(channels), 1, generator=g, dtype=torch.float64)
    loss = sum((ref[mi] * cot[:, c]).sum() for c, mi in enumerate(channels))
    want = torch.autograd.grad(loss, params + [Xg])
    got = _mirror_backward(layers, X, rows, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_schedule_rows():
    channels, rows = cuda_taylor.channel_schedule({(), (1,), (0, 0)})
    assert channels == [(), (0,), (1,), (0, 0)]
    assert rows == [(0, ()), (1, (0,)), (1, (1,)), (2, (1, 1))]
    plan = cuda_taylor.build_cuda_table_fn(
        REQS, [(2, 16), (16, 16), (16, 1)], device="cpu").plan
    assert plan.C == 8 and plan.P_total == 2 * 16 + 16 + 16 * 16 + 16 + 16 + 1
    flat = torch.arange(plan.P_total, dtype=torch.float32)
    assert torch.equal(plan.pack([t.reshape(t.shape) for t in
                                  plan.unpack(flat)]), flat)
    with pytest.raises(ValueError, match="channels"):
        cuda_taylor.build_cuda_table_fn(
            {(), (0, 1, 2), (0, 0, 0, 0), (1, 1, 1, 1), (2, 2, 2, 2),
             (0, 0, 1), (1, 1, 2)}, [(3, 8), (8, 1)], device="cpu")


def test_flop_count_counts_what_the_function_needs():
    """The bound's operation count, by hand for the Allen-Cahn request set
    on a 2-16-16-1 net: C = 4 channels of orders (1, 1, 2), so the chain
    runs to d2 in K1 and one order further in K2's transpose."""
    plan = cuda_taylor.build_cuda_table_fn(
        {(), (1,), (0, 0)}, [(2, 16), (16, 16), (16, 1)], device="cpu").plan
    mm = 2 * 2 * 16 + 2 * 4 * 16 * 16 + 2 * 4 * 16
    act = 32 * ((1 + 2 + 2) + (1 + 1 + 4))   # z, d1, d2; the three lines
    vjp = 32 * (4 + 2 * 3 + (4 + 4 + 13))    # d3; the closing sum; lines
    sums = (16 + 16 + 1) + 16 * 2            # db; the seeds' share of dW_0
    got = cuda_taylor.flop_count(plan, 10)
    # 16 wide is narrow: every product stays on the CUDA cores
    assert got == {"k1": {"tensor": 0, "simt": 10 * (mm + act)},
                   "k2": {"tensor": 0, "simt": 10 * ((mm - 2 * 4 * 16) + act
                                                     + 2 * mm + vjp + sums)}}
    # a fourth-order channel takes the chain to d4 (and d5 in K2)
    deep = cuda_taylor.build_cuda_table_fn(
        {(), (1,), (0, 0), (0, 0, 0, 0)}, [(2, 16), (16, 16), (16, 1)],
        device="cpu").plan
    orders = [len(mi) for mi in deep.channels if mi]
    assert max(orders) == 4
    lines = sum(cuda_taylor._ACT_FLOPS[o] for o in orders)
    mm4 = 2 * 2 * 16 + 2 * deep.C * 16 * 16 + 2 * deep.C * 16
    assert sum(cuda_taylor.flop_count(deep, 1)["k1"].values()) \
        == mm4 + 32 * (15 + lines)


def test_flop_count_splits_tensor_core_products_at_the_slice():
    """At the slice (N = 50,000, 2-128x4-1, the Allen-Cahn requests, C = 4)
    the split counts add up to the totals the FP32 bound was taken from
    (K1 20.02, K2 60.28 GFLOP), and the tensor-core share is exactly the
    128-wide hidden products: 3 forward in K1, 3 forward + 3 dW + 3 dH in
    K2, 2·C·128·128 flops per point each."""
    shapes = [(2, 128)] + [(128, 128)] * 3 + [(128, 1)]
    plan = cuda_taylor.build_cuda_table_fn({(), (1,), (0, 0)}, shapes,
                                           device="cpu").plan
    assert plan.C == 4
    got = cuda_taylor.flop_count(plan, 50_000)
    prod = 50_000 * 2 * 4 * 128 * 128
    assert got["k1"]["tensor"] == 3 * prod
    assert got["k2"]["tensor"] == 9 * prod
    assert round(sum(got["k1"].values()) / 1e9, 2) == 20.02
    assert round(sum(got["k2"].values()) / 1e9, 2) == 60.28
    # the totals are the pre-split formula's, to the flop
    mm = [2 * 2 * 128] + [2 * 4 * fi * fo for fi, fo in shapes[1:]]
    act = 512 * ((1 + 2 + 2) + (1 + 1 + 4))
    vjp = 512 * (4 + 2 * 3 + (4 + 4 + 13))
    sums = (4 * 128 + 1) + 128 * 2
    assert sum(got["k1"].values()) == 50_000 * (sum(mm) + act)
    assert sum(got["k2"].values()) == 50_000 * (sum(mm[:-1]) + act
                                                + 2 * sum(mm) + vjp + sums)


def test_cpu_tensors_take_plain_flavor_and_count_no_launch(setup):
    _, tl, X, shapes = setup
    cuda_taylor.reset_launch_counts()
    producer = cuda_taylor.build_cuda_table_fn(REQS, shapes, device="cpu")
    got = producer(tl, torch.from_numpy(X))
    want = taylor_derivatives(tl, torch.from_numpy(X), REQS, flat_matmul=True)
    for mi in got:
        assert torch.equal(got[mi], want[mi])
    assert cuda_taylor.k1_forward.launches == 0
    assert cuda_taylor.k2_backward.launches == 0


def test_cuda_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        cuda_taylor.build_cuda_table_fn(REQS, [(2, 4), (4, 1)])



def test_build_digest_covers_every_source(tmp_path, monkeypatch):
    """The library is built from every file under ``csrc/`` and named by a
    digest over all of them: an edited shared header must not load a stale
    build."""
    import shutil
    for path in cuda_taylor.sources():
        shutil.copy(path, tmp_path)
    monkeypatch.setattr(cuda_taylor, "CSRC", str(tmp_path))
    names = {p.rsplit("/", 1)[-1] for p in cuda_taylor.sources()}
    assert {"taylor_table.cu", "minimax_step.cu",
            "taylor_common.cuh"} <= names
    before = cuda_taylor.source_digest()
    with open(tmp_path / "taylor_common.cuh", "a") as fh:
        fh.write("// edited\n")
    assert cuda_taylor.source_digest() != before
