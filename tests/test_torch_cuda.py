"""The port's CUDA kernels on the card (marker ``cuda``).

The kernels have no CPU mode, so every test here skips without a card.
The module imports nothing of JAX, so it runs where only PyTorch is
installed::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which sets up JAX, out.)

* K1 values and K2 gradients (dW, db, dX) against the plain flavor at shapes
  the ``chip_smoke.py`` run does not reach: a ragged tail, several output
  columns, three coordinates, a width above one register super-tile (128),
  a deep net, a single point.  Scale-relative tolerance 1e-4 (both sides
  are IEEE f32 and differ only in summation order; ``chip_smoke.py`` states
  the measured error).
* K2 is bit-identical run to run (per-block partials, no atomics).
* the wrapper raises on what the kernels do not take.
* the solver trained through ``fused="cuda"`` tracks the same solver
  trained through the plain flavor on the card (``fused=True``).
* ``fit`` does not synchronise the host with the card inside a chunk.
* K3 (the fused minimax step) against its plain flavor: the value, every
  dW/db leaf, gw and gX, for E = 1, E = 2 and a ``1/x`` residual at a
  ragged N (finite), at the same scale-relative 1e-4; bit-identical run to
  run; the wrapper raises on what it does not take; the solver's minimax
  step on the card tracks the CPU solver's plain flavor over 20 steps; a
  K3 launch the runtime refuses raises out of ``compile``; a minimax fit
  does not synchronise inside a chunk either.
"""

import warnings

import numpy as np
import pytest
import torch

import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor
from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

pytestmark = pytest.mark.cuda

AC = {(), (1,), (0, 0)}
MIXED = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}
TOL = 1e-4

CASES = {
    # name: (requests, widths, N)
    "ac": (AC, [2, 64, 64, 1], 1000),
    "mixed": (MIXED, [2, 64, 64, 1], 1000),
    "two-outputs": ({(), (0,), (1,), (0, 0)}, [2, 48, 48, 2], 777),
    "three-coords-wide": ({(), (0,), (2,), (1, 1), (0, 1, 2)},
                          [3, 200, 40, 1], 301),
    "deep": (AC, [2, 32, 32, 32, 32, 32, 1], 517),
    "one-point": (MIXED, [2, 16, 1], 1),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _net(widths, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    layers = [((torch.randn(a, b, generator=g) / a ** 0.5).to(dev),
               (0.1 * torch.randn(b, generator=g)).to(dev))
              for a, b in zip(widths[:-1], widths[1:])]
    X = (2 * torch.rand(1, widths[0], generator=g) - 1).to(dev)
    return layers, X, g


def _scaled(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_flavor_on_card(card, case):
    reqs, widths, N = CASES[case]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, widths[0], generator=g) - 1).to(card)
    shapes = [tuple(W.shape) for W, _ in layers]
    producer = cuda_taylor.build_cuda_table_fn(reqs, shapes)
    params = [t.clone().requires_grad_(True) for p in layers for t in p]
    pairs = list(zip(params[0::2], params[1::2]))
    Xg = X.clone().requires_grad_(True)
    before = cuda_taylor.k1_forward.launches, cuda_taylor.k2_backward.launches
    got = producer(pairs, Xg)
    want = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True)
    assert set(got) <= set(want)
    cot = {mi: torch.randn(got[mi].shape, generator=g).to(card) for mi in got}
    g_got = torch.autograd.grad(sum((got[m] * cot[m]).sum() for m in got),
                                params + [Xg])
    g_want = torch.autograd.grad(sum((want[m] * cot[m]).sum() for m in got),
                                 params + [Xg])
    torch.cuda.synchronize()
    assert (cuda_taylor.k1_forward.launches, cuda_taylor.k2_backward.launches) \
        == (before[0] + 1, before[1] + 1)
    for mi in got:
        assert got[mi].shape == (N, widths[-1])
        assert _scaled(got[mi], want[mi]) <= TOL, mi
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert _scaled(a, b) <= TOL, i


def test_k2_is_bit_identical_run_to_run(card):
    layers, _, g = _net([2, 64, 64, 1], card)
    X = (2 * torch.rand(5000, 2, generator=g) - 1).to(card)
    plan = cuda_taylor.build_cuda_table_fn(MIXED, [(2, 64), (64, 64),
                                                   (64, 1)]).plan
    flat = plan.pack([t for p in layers for t in p])
    cot = torch.randn(plan.C, 5000, 1, generator=g).to(card)
    dX_a, dflat_a = cuda_taylor.k2_backward(plan, X, flat, cot)
    dX_b, dflat_b = cuda_taylor.k2_backward(plan, X, flat, cot)
    assert torch.equal(dX_a, dX_b) and torch.equal(dflat_a, dflat_b)


def test_wrapper_rejects_what_the_kernels_do_not_take(card):
    layers, X, _ = _net([2, 16, 1], card)
    plan = cuda_taylor.build_cuda_table_fn(AC, [(2, 16), (16, 1)]).plan
    flat = plan.pack([t for p in layers for t in p])
    with pytest.raises(TypeError, match="float32"):
        cuda_taylor.k1_forward(plan, X.double(), flat.double())
    with pytest.raises(ValueError, match=r"\[N>0, 2\]"):
        cuda_taylor.k1_forward(plan, X[:, :1].contiguous(), flat)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_taylor.k1_forward(plan, X.cpu(), flat)
    with pytest.raises(ValueError, match="plan expects"):
        cuda_taylor.k1_forward(plan, X, flat[:-1])
    with pytest.raises(ValueError, match="cotangent"):
        cuda_taylor.k2_backward(plan, X, flat,
                                torch.zeros(plan.C, 2, 1, device=card))


def _ac_solver(fused, n_f=2048, grid=(128, 51), seed=0, minimax=False,
               device="cuda"):
    nx, nt = grid
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)
    grad = tdqt.grad

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [tdqt.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                   var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    rng = np.random.RandomState(seed)
    solver = tdqt.CollocationSolverND(verbose=False, seed=seed,
                                      device=device)
    solver.compile([2, 64, 64, 64, 1], f_model, domain, bcs, fused=fused,
                   minimax=minimax, Adaptive_type=1,
                   dict_adaptive={"residual": [True], "BCs": [True, False]},
                   init_weights={"residual": [rng.rand(n_f, 1)],
                                 "BCs": [100.0 * rng.rand(nx, 1), None]})
    return solver


def test_solver_through_kernels_tracks_plain_flavor_on_card(card):
    epochs = 30
    cuda_taylor.reset_launch_counts()
    kern = _ac_solver("cuda")
    assert kern.engine == "fused-cuda"
    kern.fit(tf_iter=epochs)
    launches = (cuda_taylor.k1_forward.launches,
                cuda_taylor.k2_backward.launches)
    plain = _ac_solver(True)
    assert plain.engine == "fused"
    plain.fit(tf_iter=epochs)
    assert (cuda_taylor.k1_forward.launches,
            cuda_taylor.k2_backward.launches) == launches
    # compile's cross-check, then one forward and one backward per epoch
    assert launches == (epochs + 1, epochs + 1)
    lk = np.array([r["Total Loss"] for r in kern.losses])
    lp = np.array([r["Total Loss"] for r in plain.losses])
    np.testing.assert_allclose(lk, lp, rtol=5e-3)
    assert lk[-1] < lk[0]
    Xq = np.random.RandomState(1).rand(3000, 2) * [2.0, 1.0] - [1.0, 0.0]
    (uk, fk), (up, fp) = kern.predict(Xq), plain.predict(Xq)
    assert np.max(np.abs(uk - up)) <= 5e-3 * np.max(np.abs(up))
    assert np.max(np.abs(fk - fp)) <= 5e-3 * np.max(np.abs(fp))


def _n_syncs(solver, epochs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver.fit(tf_iter=epochs, chunk=epochs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def test_fit_does_not_sync_inside_a_chunk(card):
    """The synchronising calls of one ``fit`` (chunk = the whole fit) do not
    grow with the number of epochs: none happens per step."""
    solver = _ac_solver("cuda", n_f=512)
    _n_syncs(solver, 2)  # optimizer state
    few, many = _n_syncs(solver, 3), _n_syncs(solver, 12)
    assert few == many, (few, many)


# ------------------------------------------------------------------ #
# K3, the fused minimax step
# ------------------------------------------------------------------ #
def _res_ac(u, x, t):
    g = tdqt.grad
    uv = u(x, t)
    return (g(u, "t")(x, t) - 0.0001 * g(g(u, "x"), "x")(x, t)
            + 5.0 * uv ** 3 - 5.0 * uv)


def _res_system(u, x, t):
    g = tdqt.grad
    uv, vv = u[0](x, t), u[1](x, t)
    sq = uv ** 2 + vv ** 2
    return (g(u[0], "t")(x, t) + 0.5 * g(g(u[1], "x"), "x")(x, t) + sq * vv,
            g(u[1], "t")(x, t) - 0.5 * g(g(u[0], "x"), "x")(x, t) - sq * uv)


def _res_singular(u, x, t):
    g = tdqt.grad
    return g(u, "t")(x, t) + g(u, "x")(x, t) / x


K3_CASES = {
    # name: (residual, widths, N, x range)
    "ac": (_res_ac, [2, 64, 64, 1], 1000, (-1.0, 1.0)),
    "system-E2": (_res_system, [2, 48, 48, 2], 777, (-1.0, 1.0)),
    "singular-ragged": (_res_singular, [2, 200, 40, 1], 1001, (0.5, 1.5)),
    "one-point": (_res_ac, [2, 16, 1], 1, (-1.0, 1.0)),
}


def _k3_setup(case, dev, seed=0):
    f, widths, n, (lo, hi) = K3_CASES[case]
    layers, _, g = _net(widths, dev, seed)
    sq = build_minimax_sq_fn(f, ("x", "t"), widths[-1],
                             analyze_f_model(f, ("x", "t"), widths[-1]),
                             [tuple(W.shape) for W, _ in layers])
    u = torch.rand(n, 2, generator=g)
    X = torch.stack([lo + (hi - lo) * u[:, 0], u[:, 1]], 1).to(dev)
    w = torch.rand(n, sq.plan.E, generator=g).to(dev)
    flat = [a if a.ndim == 2 else a.reshape(1, -1)
            for pair in layers for a in pair]
    return sq, X, w, flat


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_matches_plain_flavor_on_card(card, case):
    sq, X, w, flat = _k3_setup(case, card)
    plan = sq.plan
    before = cuda_minimax.k3_minimax.launches
    val, dflat, gw, gX = cuda_minimax.k3_minimax(plan, X, w, plan.pack(flat))
    torch.cuda.synchronize()
    assert cuda_minimax.k3_minimax.launches == before + 1
    p_val, p_flat, p_gw, p_gX = sq.plain(flat, w, X)
    got = [val.reshape(1)] + [t.reshape(-1) for t in plan.unpack(dflat)] \
        + [gw, gX]
    want = [p_val.reshape(1)] + [t.reshape(-1) for t in p_flat] + [p_gw, p_gX]
    assert gw.shape == (X.shape[0], plan.E) and gX.shape == X.shape
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), i
        assert _scaled(a, b) <= TOL, i
    # through the autograd.Function: the backward scales the saved
    # cotangents by the incoming scalar
    leaves = [t.clone().requires_grad_(True) for t in flat]
    Xg, wg = X.clone().requires_grad_(True), w.clone().requires_grad_(True)
    v = sq(list(zip(leaves[0::2], leaves[1::2])), wg, Xg)
    grads = torch.autograd.grad(3.0 * v, leaves + [wg, Xg])
    for a, b in zip(grads, list(p_flat) + [p_gw, p_gX]):
        assert _scaled(a.reshape(-1), 3.0 * b.reshape(-1)) <= TOL


def test_k3_is_bit_identical_run_to_run(card):
    sq, X, w, flat = _k3_setup("ac", card)
    X = X.repeat(5, 1).contiguous()
    w = w.repeat(5, 1).contiguous()
    packed = sq.plan.pack(flat)
    a = cuda_minimax.k3_minimax(sq.plan, X, w, packed)
    b = cuda_minimax.k3_minimax(sq.plan, X, w, packed)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k3_wrapper_rejects_what_it_does_not_take(card):
    sq, X, w, flat = _k3_setup("ac", card)
    plan, packed = sq.plan, sq.plan.pack(flat)
    k3 = cuda_minimax.k3_minimax
    with pytest.raises(ValueError, match="one CUDA device"):
        k3(plan, X.cpu(), w, packed)
    with pytest.raises(TypeError, match="float32"):
        k3(plan, X.double(), w, packed.double())
    with pytest.raises(TypeError, match="float32"):
        k3(plan, X, w.double(), packed)
    with pytest.raises(ValueError, match="contiguous"):
        k3(plan, X.t().contiguous().t(), w, packed)
    with pytest.raises(ValueError, match="contiguous"):
        k3(plan, X, torch.cat([w, w], 1)[:, :1], packed)
    with pytest.raises(ValueError, match=r"\[1000, 1\]"):
        k3(plan, X, w[:-1].contiguous(), packed)
    with pytest.raises(ValueError, match="X's CUDA device"):
        k3(plan, X, w.cpu(), packed)


def test_minimax_solver_on_card_tracks_cpu_plain_flavor(card):
    epochs = 20
    cuda_taylor.reset_launch_counts()
    kern = _ac_solver("cuda", n_f=1024, minimax=None)
    assert kern._minimax_kind == "cuda"
    assert kern.engine == "fused-minimax-cuda"
    kern.fit(tf_iter=epochs)
    # compile's minimax cross-check, then one launch per step
    assert cuda_minimax.k3_minimax.launches == epochs + 1
    plain = _ac_solver("cuda", n_f=1024, minimax=None, device="cpu")
    assert plain._minimax_kind == "plain"
    plain.fit(tf_iter=epochs)
    assert cuda_minimax.k3_minimax.launches == epochs + 1
    lk = np.array([r["Total Loss"] for r in kern.losses])
    lp = np.array([r["Total Loss"] for r in plain.losses])
    np.testing.assert_allclose(lk, lp, rtol=5e-3)
    assert lk[-1] < lk[0]
    lam_k = kern.lambdas["residual"][0].detach().cpu().numpy()
    lam_p = plain.lambdas["residual"][0].detach().numpy()
    np.testing.assert_allclose(lam_k, lam_p, rtol=5e-3, atol=1e-4)


def test_k3_launch_failure_raises_out_of_compile(card, monkeypatch):
    """A K3 the runtime refuses fails ``compile(minimax=None)``; the solver
    does not train on the unfused loss instead.  The tile here asks for
    more shared memory than a block may have."""
    fits = cuda_minimax.MinimaxPlan.tile_sizes

    def oversized(self, device):
        tp_fwd, tp_bwd, n_sm = fits(self, device)
        return tp_fwd, 64 * tp_bwd, n_sm

    monkeypatch.setattr(cuda_minimax.MinimaxPlan, "tile_sizes", oversized)
    before = cuda_minimax.k3_minimax.launches
    with pytest.raises(cuda_taylor.KernelLaunchError, match="K3 launch"):
        _ac_solver("cuda", n_f=512, minimax=None)
    assert cuda_minimax.k3_minimax.launches == before


def test_minimax_fit_does_not_sync_inside_a_chunk(card):
    solver = _ac_solver("cuda", n_f=512, minimax=None)
    assert solver._minimax_kind == "cuda"
    _n_syncs(solver, 2)  # optimizer state
    few, many = _n_syncs(solver, 3), _n_syncs(solver, 12)
    assert few == many, (few, many)
