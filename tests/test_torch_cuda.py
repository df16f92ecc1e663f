"""The port's CUDA kernels on the card (marker ``cuda``).

The kernels have no CPU mode, so every test here skips without a card.
The module imports nothing of JAX, so it runs where only PyTorch is
installed::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which sets up JAX, out.)

* K1 values and K2 gradients (dW, db, dX) against the plain flavor at shapes
  the ``chip_smoke.py`` run does not reach: a ragged tail, several output
  columns, three coordinates, a width above one block tile (128), a deep
  net, a single point, widths that are not multiples of 8 with a tile of
  R = 126 rows.  Scale-relative tolerance 1e-4 (the plain side is IEEE f32;
  the kernels take the hidden products as 3xTF32, at worst about 2^-20 per
  product, and sum in another order; ``chip_smoke.py`` states the measured
  error).
* K2 is bit-identical run to run (per-block partials, no atomics).
* the wrapper raises on what the kernels do not take.
* the solver trained through ``fused="cuda"`` tracks the same solver
  trained through the plain flavor on the card (``fused=True``).
* ``fit`` does not synchronise the host with the card inside a chunk.
* K3 (the fused minimax step) against its plain flavor: the value, every
  dW/db leaf, gw and gX, for E = 1, E = 2 and a ``1/x`` residual at a
  ragged N (finite) and at odd widths, at the same scale-relative 1e-4;
  bit-identical run to
  run; the wrapper raises on what it does not take; the solver's minimax
  step on the card tracks the CPU solver's plain flavor over 20 steps; a
  K3 launch the runtime refuses raises out of ``compile``; a minimax fit
  does not synchronise inside a chunk either.
* the L-BFGS leg on the card: every evaluation is one K3 launch (no K1/K2),
  5 line-search iterations track the CPU solver's plain flavor within rtol
  5e-3; the fixed-step rule launches K3 once per iteration and does not
  synchronise inside a chunk.
* a checkpoint restored on the card lands on the card, and the restored
  solver's loss and 5 further Adam steps are bit-identical to the saved
  solver's.
* the CUDA graphs (``training/graphs.py``): 50 graphed Adam steps on both
  paths, and 10 graphed L-BFGS iterations of each rule, equal the same
  steps run eagerly (``fit(_graphs=False)``) bit for bit, or within 1e-6
  scale-relative; the launch counters count every replay exactly; a
  restored checkpoint re-captures and its 10 graphed steps equal the saved
  solver's; a capture that fails raises and the step does not carry on
  eagerly.
* serving (``tensordiffeq_tpu_torch.serving``): every (kind, bucket) rung's
  graph equals its program run eagerly at the same padded shape bit for
  bit; a restored checkpoint's parameters assigned to the surrogate drop
  the graphs and capture them again; graphs in the engine's shared pool
  answer as in private pools; a 10-rung ladder serves every kind with no
  rung quarantined; a capture that fails quarantines its rungs and nothing
  is served eagerly; the batcher's answers equal the engine's on the same
  batches.
* adaptive collocation (``fit(resample_every=...)``): a swap writes into
  the Adam step's buffers, so the graph is not captured again, and a
  graphed fit equals an eager one bit for bit with redraws in both modes
  (K1 once per pool redraw, K3 six times per ascent redraw); a redraw on
  its side stream reads the parameters of its dispatch boundary though the
  main stream updates them in place right after; dispatching a redraw
  does not wait for the device; a discarded redraw has finished before
  the main stream goes on (its memory is not reused early).
* ``DiscoveryModel``: 50 graphed steps equal 50 eager ones bit for bit.
* the training options (``chip_smoke.py`` phase 13, at small size):
  ``fused="autotune"`` races the K1/K2 candidate behind its cross-check,
  adopts the argmin and launches what the protocol says, and a K1 the
  runtime refuses raises out of its ``compile``; lr schedules,
  NTK weighting, the causal ε ladder and ``remat`` each keep one capture of
  the Adam step and equal the eager steps bit for bit (K3 once per step
  under schedules and NTK; K1 and K2 once per step under causal weighting,
  K1 twice under ``remat``, whose first step equals the plain one's); the
  embedding families train graphed on the generic engine with no kernel
  launch, equal to eager, and serve ``u`` as ``predict`` does.
* mixed precision (``chip_smoke.py`` phase 14, at small size): K1-bf16,
  K2-bf16 and K3-bf16 against their plain bf16 flavors on every shape
  above, within the reference's bf16 bands (5e-2 values, 1.5e-1 gradients,
  scale-relative) and nearer (RMS) the plain bf16 flavor than the f32 one;
  the bf16 launch differs from the f32 one; the same for the bf16 route's
  edges (widths off the multiples of 16 at a ragged N, narrow hidden
  layers, 256-wide layers, several tiles per block at width 128; K3-bf16
  on E = 2 and the ``1/x`` residual);
  K2-bf16 and K3-bf16 bit for bit run to run, at small widths and at the
  slice's 128 with several tiles per block; ``compile(fused_dtype="bfloat16")`` trains graphed equal
  to eager on both paths with only the bf16 kernels launched; the L-BFGS
  retreat moves from K3-bf16 to the f32 K3; a bf16 serving rung equals its
  eager program and launches K1-bf16 once per replay; a K1-bf16 the
  runtime refuses raises out of ``compile``; the workspace the wrappers
  allocate is the size the kernels index, in both flavors.
* K1's two routes (the persistent wgmma route of ``csrc/taylor_fwd_wg.cuh``
  and the first kernel for wider shapes): both flavors against their plain
  flavors on every shape above and on the route's edges (one and two
  channels, N below one tile, one point past a tile multiple, fewer tiles
  than SMs, a 256-wide layer), each asserting the route the host chose;
  the wrapper's route plan equal to the kernels' for several N; K1 and
  K1-bf16 bit for bit run to run and whatever N or a point's place in X.
* the PDE zoo (``chip_smoke.py`` phase 15, at N = 4,096): K3 (each entry's
  lowered step), K1 and K2 (its requests) against their plain flavors at
  each of the nine entries' widths, d, n_out and E; a ``fit`` with
  telemetry and an eval hook at every chunk boundary does not synchronise
  inside a chunk and captures its (instrumented) step once; the step's
  ``Grad_norm`` equals the norm of the eager gradients at the same
  parameters.
"""

import ctypes
import warnings

import numpy as np
import pytest
import torch

import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor
from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
from tensordiffeq_tpu_torch.training.fit import step_count
from tensordiffeq_tpu_torch.training.graphs import GraphCaptureError
from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize

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
    # widths off the tensor cores' multiples of 8 and C = 3 channels, so a
    # tile's R = 126 rows are not a multiple of the fragments' 16
    "odd-widths": ({(), (1,), (1, 1)}, [2, 37, 53, 1], 1003),
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
               device="cuda", sa=True, widths=(64, 64, 64), **extra):
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
    if sa:
        extra.update(Adaptive_type=1,
                     dict_adaptive={"residual": [True],
                                    "BCs": [True, False]},
                     init_weights={"residual": [rng.rand(n_f, 1)],
                                   "BCs": [100.0 * rng.rand(nx, 1), None]})
    if callable(extra.get("network")):  # built on the problem's domain
        extra["network"] = extra["network"](domain)
    solver = tdqt.CollocationSolverND(verbose=False, seed=seed,
                                      device=device)
    solver.compile([2, *widths, 1], f_model, domain, bcs, fused=fused,
                   minimax=minimax, **extra)
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


# what PyTorch's sync debug mode says at each synchronising call; the notice
# it gives once per process when the mode is first set ("... does not yet
# detect all synchronizing operations") is no synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"


def _n_syncs(solver, epochs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver.fit(tf_iter=epochs, chunk=epochs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def test_fit_does_not_sync_inside_a_chunk(card):
    """The synchronising calls of one ``fit`` (chunk = the whole fit) do not
    grow with the number of epochs: none happens per step."""
    solver = _ac_solver("cuda", n_f=512)
    _n_syncs(solver, 5)  # optimizer state, the graph's warm-up and capture
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
    # C = 3 (R = 126 rows), widths off the multiples of 8, a ragged tail
    "odd-widths": (_res_singular, [2, 37, 53, 1], 1001, (0.5, 1.5)),
}


def _k3_setup(case, dev, seed=0, cases=K3_CASES):
    f, widths, n, (lo, hi) = cases[case]
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

    def oversized(self, device, compute_dtype=None):
        tp_fwd, tp_bwd, n_sm = fits(self, device, compute_dtype)
        return tp_fwd, 64 * tp_bwd, n_sm

    monkeypatch.setattr(cuda_minimax.MinimaxPlan, "tile_sizes", oversized)
    before = cuda_minimax.k3_minimax.launches
    with pytest.raises(cuda_taylor.KernelLaunchError, match="K3 launch"):
        _ac_solver("cuda", n_f=512, minimax=None)
    assert cuda_minimax.k3_minimax.launches == before


def test_minimax_fit_does_not_sync_inside_a_chunk(card):
    solver = _ac_solver("cuda", n_f=512, minimax=None)
    assert solver._minimax_kind == "cuda"
    _n_syncs(solver, 5)  # optimizer state, the graph's warm-up and capture
    few, many = _n_syncs(solver, 3), _n_syncs(solver, 12)
    assert few == many, (few, many)


# ------------------------------------------------------------------ #
# L-BFGS refinement and checkpoints on the card
# ------------------------------------------------------------------ #
def test_lbfgs_leg_through_k3_tracks_cpu_plain_flavor(card):
    kern = _ac_solver("cuda", n_f=1024, minimax=None)
    plain = _ac_solver("cuda", n_f=1024, minimax=None, device="cpu")
    assert kern._minimax_kind == "cuda" and plain._minimax_kind == "plain"
    for s in (kern, plain):
        s.fit(tf_iter=20)
    cuda_taylor.reset_launch_counts()
    e0 = lbfgs_minimize.evaluations
    kern.fit(newton_iter=5)
    evals = lbfgs_minimize.evaluations - e0
    assert cuda_minimax.k3_minimax.launches == evals >= 6
    assert cuda_taylor.k1_forward.launches == \
        cuda_taylor.k2_backward.launches == 0
    plain.fit(newton_iter=5)
    assert cuda_minimax.k3_minimax.launches == evals  # the CPU launches none
    lk = np.array([r["Total Loss"] for r in kern.losses])
    lp = np.array([r["Total Loss"] for r in plain.losses])
    assert len(lk) == len(lp) == 25 and kern.newton_done == 5
    np.testing.assert_allclose(lk, lp, rtol=5e-3)
    assert kern.min_loss["l-bfgs"] < kern.min_loss["adam"]


def _n_lbfgs_syncs(solver, iters):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver.fit(newton_iter=iters, newton_eager=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def test_fixed_step_lbfgs_launches_k3_per_iteration_without_syncs(card):
    solver = _ac_solver("cuda", n_f=512, minimax=None)
    cuda_taylor.reset_launch_counts()
    solver.fit(newton_iter=7, newton_eager=True)
    assert cuda_minimax.k3_minimax.launches == 7
    few, many = _n_lbfgs_syncs(solver, 3), _n_lbfgs_syncs(solver, 12)
    assert few == many, (few, many)


def test_checkpoint_resume_on_card_is_bit_identical(card, tmp_path):
    a = _ac_solver("cuda", n_f=1024, minimax=None)
    a.fit(tf_iter=10)
    a.save_checkpoint(str(tmp_path / "ck"))
    b = _ac_solver("cuda", n_f=1024, minimax=None, seed=0)
    b.restore_checkpoint(str(tmp_path / "ck"))
    assert b.X_f.device.type == "cuda"
    assert all(t.device.type == "cuda" for pair in b.net.layers()
               for t in pair)
    assert b._opt[0].state[b.net.layers()[0][0]]["exp_avg"].is_cuda
    assert float(a.update_loss()[0].detach()) == \
        float(b.update_loss()[0].detach())
    a.fit(tf_iter=5)
    b.fit(tf_iter=5)
    assert [r["Total Loss"] for r in a.losses] == \
        [r["Total Loss"] for r in b.losses]


# ------------------------------------------------------------------ #
# the training steps as CUDA graphs
# ------------------------------------------------------------------ #
GRAPH_BAND = 1e-6  # scale-relative, were a replayed op to round otherwise


def _diff(a, b):
    """The largest scale-relative difference between two solvers' loss
    histories, parameters and λ (0.0: all bit-identical)."""
    ha = np.array([r[k] for r in a.losses for k in sorted(r)])
    hb = np.array([r[k] for r in b.losses for k in sorted(r)])
    assert ha.shape == hb.shape
    pairs = [(ha, hb)] + [
        (p.detach().cpu().numpy(), q.detach().cpu().numpy())
        for p, q in zip([t for pair in a.net.layers() for t in pair]
                        + [lam for lam in a.lambdas["residual"]
                           + a.lambdas["BCs"] if lam is not None],
                        [t for pair in b.net.layers() for t in pair]
                        + [lam for lam in b.lambdas["residual"]
                           + b.lambdas["BCs"] if lam is not None])]
    return max(0.0 if np.array_equal(x, y) else
               float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in pairs)


@pytest.mark.parametrize("minimax", [None, False],
                         ids=["minimax", "unfused"])
def test_graph_adam_steps_equal_eager_steps(card, minimax):
    graph = _ac_solver("cuda", n_f=1024, minimax=minimax)
    eager = _ac_solver("cuda", n_f=1024, minimax=minimax)
    graph.fit(tf_iter=50, chunk=20)
    eager.fit(tf_iter=50, chunk=20, _graphs=False)
    assert graph._adam.graph.captures == 1
    assert eager._adam.graph.captures == 0
    assert _diff(graph, eager) <= GRAPH_BAND


@pytest.mark.parametrize("newton_eager", [None, True],
                         ids=["line-search", "fixed-step"])
def test_graph_lbfgs_iterations_equal_eager_ones(card, newton_eager):
    graph = _ac_solver("cuda", n_f=1024, minimax=None)
    eager = _ac_solver("cuda", n_f=1024, minimax=None)
    for s, graphs in ((graph, True), (eager, False)):
        s.fit(tf_iter=5, newton_iter=10, newton_eager=newton_eager,
              _graphs=graphs)
    assert graph.newton_done == eager.newton_done == 10
    assert _diff(graph, eager) <= GRAPH_BAND
    assert graph.min_loss == eager.min_loss


def test_launch_counts_are_exact_under_replay(card):
    cuda_taylor.reset_launch_counts()
    mm = _ac_solver("cuda", n_f=512, minimax=None)
    k = cuda_minimax.k3_minimax
    assert k.launches == 1  # compile's cross-check
    mm.fit(tf_iter=25, chunk=10)
    assert k.launches == 26
    mm.fit(tf_iter=7, chunk=10)  # the graph is kept: replays only
    assert k.launches == 33 and mm._adam.graph.captures == 1
    mm.fit(newton_iter=12, newton_eager=True)
    assert k.launches == 45
    e0 = lbfgs_minimize.evaluations
    mm.fit(newton_iter=8)
    assert k.launches == 45 + lbfgs_minimize.evaluations - e0
    cuda_taylor.reset_launch_counts()
    unfused = _ac_solver("cuda", n_f=512)
    unfused.fit(tf_iter=9)
    assert (cuda_taylor.k1_forward.launches,
            cuda_taylor.k2_backward.launches, k.launches) == (10, 10, 0)


def test_restore_recaptures_and_resumes_bit_identically(card, tmp_path):
    a = _ac_solver("cuda", n_f=1024, minimax=None)
    a.fit(tf_iter=10)
    ck = str(tmp_path / "ck")
    a.save_checkpoint(ck)
    b = _ac_solver("cuda", n_f=1024, minimax=None, seed=1)
    b.restore_checkpoint(ck)
    a.fit(tf_iter=10)
    b.fit(tf_iter=10)
    assert b._adam.graph.captures == 1
    assert _diff(a, b) == 0.0
    # restoring into a solver that has a graph captures a new one
    old = a._adam
    a.restore_checkpoint(ck)
    a.fit(tf_iter=10)
    assert a._adam is not old and a._adam.graph.captures == 1
    assert _diff(a, b) == 0.0


def test_failed_capture_raises_and_does_not_run_eagerly(card):
    solver = _ac_solver("cuda", n_f=512, minimax=None)
    loss_fn = solver.loss_fn

    def reads_the_loss(*args, **kw):
        total, comps = loss_fn(*args, **kw)
        float(total)  # a host read: refused inside a capture
        return total, comps

    solver.loss_fn = reads_the_loss
    before = cuda_minimax.k3_minimax.launches
    with pytest.raises(GraphCaptureError, match="Adam step"):
        solver.fit(tf_iter=10)
    # the three warm-up steps ran, then nothing: no eager step in its place
    assert cuda_minimax.k3_minimax.launches == before + 3
    assert solver.losses == []
    torch.cuda.synchronize()
    assert float((torch.ones(2, device=card) * 2).sum()) == 4.0


# --------------------------------------------------------------------------- #
# serving: one CUDA graph per (kind, bucket) rung
# --------------------------------------------------------------------------- #
SERVE_KINDS = ("u", "d:x:1", "d:x:2", "d:t:1", "residual")


def _serve_points(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-1, 1, n),
                     rng.uniform(0, 1, n)], 1).astype(np.float32)


def _serve_leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _serve_eager(eng, spec, X, bucket):
    """The kind's program run eagerly on ``X`` padded to ``bucket``."""
    from tensordiffeq_tpu_torch.utils import ieee_f32
    Xp = torch.zeros(bucket, 2, device=eng.surrogate.device)
    Xp[:len(X)] = torch.from_numpy(X)
    with ieee_f32(), torch.no_grad():
        out = eng.make_batched(spec)()(eng.surrogate.params, Xp)
    return [o[:len(X)].cpu().numpy() for o in _serve_leaves(out)]


def _serve_equal(a, b):
    return all(np.array_equal(x, y)
               for x, y in zip(_serve_leaves(a), _serve_leaves(b)))


@pytest.fixture
def served(card):
    solver = _ac_solver("cuda", n_f=1024, minimax=None)
    solver.fit(tf_iter=5)
    return solver


@pytest.mark.parametrize("spec", SERVE_KINDS)
def test_serving_rung_graphs_equal_eager_bit_for_bit(served, spec):
    eng = served.export_surrogate().engine(min_bucket=64, max_bucket=4096)
    for n in (1, 64, 100, 1000, 4096, 5000):
        X = _serve_points(n, seed=n)
        got = eng.op_for(spec)(X)
        for i in range(0, n, 4096):  # chunk by chunk
            part = X[i:i + 4096]
            want = _serve_eager(eng, spec, part, eng.bucket_for(len(part)))
            assert _serve_equal([g[i:i + 4096] for g in _serve_leaves(got)],
                                want), (spec, n)
    # one capture per touched rung, each replayed since
    assert all(r.graph.captures == 1 and r.graph.graph is not None
               for r in eng._rungs.values())
    assert eng.compile_cache_size == len(eng._rungs) == 4  # 64, 128, 1024, 4096


def test_serving_restore_drops_and_recaptures(served, tmp_path):
    ck = str(tmp_path / "ck")
    served.save_checkpoint(ck)
    served.fit(tf_iter=5)
    eng = served.export_surrogate().engine(min_bucket=64, max_bucket=1024)
    X = _serve_points(300)
    before = eng.residual(X)
    rung = eng._rungs[("residual", 512)]
    assert rung.graph.captures == 1
    served.restore_checkpoint(ck)
    eng.surrogate.params = served.export_surrogate().params
    after = eng.residual(X)
    assert rung.graph.captures == 2
    assert not np.array_equal(before, after)
    fresh = served.export_surrogate().engine(min_bucket=64, max_bucket=1024)
    assert np.array_equal(after, fresh.residual(X))
    u, _ = served.predict(X)
    assert float(np.abs(eng.u(X) - u).max() / np.abs(u).max()) <= 1e-6


def test_serving_shared_pool_matches_private_pools(served):
    from tensordiffeq_tpu_torch.training.graphs import CudaGraph
    sur = served.export_surrogate()
    shared = sur.engine(min_bucket=64, max_bucket=2048)
    private = sur.engine(min_bucket=64, max_bucket=2048)
    private._make_graph = CudaGraph  # a pool per graph
    for n in (10, 100, 500, 2048):
        X = _serve_points(n, seed=n)
        for spec in SERVE_KINDS:
            assert _serve_equal(shared.op_for(spec)(X),
                                private.op_for(spec)(X)), (spec, n)


def test_serving_no_rung_quarantined_across_the_ladder(served):
    eng = served.export_surrogate().engine(min_bucket=64, max_bucket=32768)
    assert eng.n_buckets == 10
    for bucket in eng.bucket_sizes:
        X = _serve_points(bucket - 3 if bucket > 64 else 1, seed=bucket)
        for spec in SERVE_KINDS:
            out = _serve_leaves(eng.op_for(spec)(X))
            assert all(np.isfinite(o).all() for o in out)
    assert eng.quarantined_buckets() == {}
    assert eng.compile_cache_size == len(SERVE_KINDS) * eng.n_buckets
    assert all(r.graph.captures == 1 for r in eng._rungs.values())


def test_serving_capture_failure_quarantines_and_never_runs_eagerly(served):
    from tensordiffeq_tpu_torch.serving import EngineDegraded
    eng = served.export_surrogate().engine(min_bucket=64, max_bucket=128)
    make_fn = eng._make_fn
    runs = []

    def syncing(key):  # a host read: refused inside a capture
        make = make_fn(key)

        def make_syncing():
            program = make()

            def batched(params, Xb):
                runs.append(float(Xb.sum()))
                return program(params, Xb)
            return batched
        return make_syncing

    eng._make_fn = lambda key: syncing(key) if key == "u" else make_fn(key)
    with pytest.raises(EngineDegraded):
        eng.u(_serve_points(10))
    assert eng.quarantined_buckets() == {"u": [64, 128]}
    # the warm-ups ran (3 per rung), then nothing was served eagerly
    assert len(runs) == 6 and not eng._rungs
    torch.cuda.synchronize()
    assert float((torch.ones(2, device="cuda") * 2).sum()) == 4.0
    # the engine's pool outlived the failed captures: other kinds capture
    X = _serve_points(100)
    assert np.array_equal(eng.derivative(X, "x"),
                          _serve_eager(eng, "d:x:1", X, 128)[0])
    assert eng._rungs[(("d", 0, 1, 0), 128)].graph.captures == 1


def test_serving_batcher_through_the_engine_on_card(served):
    from tensordiffeq_tpu_torch.serving import RequestBatcher
    from tensordiffeq_tpu_torch.telemetry import MetricsRegistry
    eng = served.export_surrogate().engine(min_bucket=64, max_bucket=4096)
    sizes = []

    def op(X):
        sizes.append(len(X))
        return eng.residual(X)

    b = RequestBatcher(eng, op=op, max_batch=256, max_latency_s=60.0,
                       registry=MetricsRegistry())
    rng = np.random.RandomState(0)
    reqs = [_serve_points(int(n), seed=i)
            for i, n in enumerate(rng.randint(1, 40, 100))]
    handles = [b.submit(X) for X in reqs]
    got = np.concatenate([h.result() for h in handles])
    # the same batches through the engine directly: the same rungs
    ends = np.cumsum(sizes)
    allX = np.concatenate(reqs)
    want = np.concatenate([eng.residual(allX[a:z]) for a, z in
                           zip(np.concatenate([[0], ends[:-1]]), ends)])
    assert np.array_equal(got, want)
    assert b.stats()["requests"] == 100 and eng.quarantined_buckets() == {}


# ------------------------------------------------------------------ #
# adaptive collocation and the inverse problem
# ------------------------------------------------------------------ #
def _x_f_equal(a, b):
    return torch.equal(a.X_f, b.X_f)


@pytest.mark.parametrize("mode", ["pool", "ascent"])
def test_resample_swap_keeps_the_graph_and_equals_eager(card, mode):
    graph = _ac_solver("cuda", n_f=1024, minimax=None)
    eager = _ac_solver("cuda", n_f=1024, minimax=None)
    X_f = graph.X_f
    kw = dict(tf_iter=40, chunk=10, resample_every=10, resample_mode=mode)
    cuda_taylor.reset_launch_counts()
    graph.fit(**kw)
    k1, k3 = (cuda_taylor.k1_forward.launches,
              cuda_minimax.k3_minimax.launches)
    eager.fit(_graphs=False, **kw)
    assert graph.X_f is X_f and graph._adam.graph.captures == 1
    assert [(r["epoch"], r["adopted"]) for r in graph.redraws] == \
        [(10, 20), (20, 30), (30, None)]
    assert all(r["device_ms"] > 0 for r in graph.redraws)
    if mode == "pool":  # K1 scores each pool; K3 takes each Adam step
        assert (k1, k3) == (3, 40)
    else:  # 5 ascent steps and a last scoring, each one K3 at w = 1
        assert (k1, k3) == (0, 40 + 6 * 3)
    assert _diff(graph, eager) == 0.0 and _x_f_equal(graph, eager)


def test_side_stream_redraw_reads_its_boundary_parameters(card):
    from tensordiffeq_tpu_torch.ops.resampling import DeviceResampler
    from tensordiffeq_tpu_torch.training.fit import dispatch_redraw
    s = _ac_solver("cuda", n_f=4096, minimax=None)
    params = [t for pair in s.net.layers() for t in pair]
    sampler = DeviceResampler(s._residual, s.domain.xlimits, 4096)
    want = sampler.redraw([(W.detach().clone(), b.detach().clone())
                           for W, b in s.net.layers()], s.X_f, 7)
    pending = dispatch_redraw(sampler.redraw, params, s.X_f, 7)
    with torch.no_grad():  # the next chunk's updates, in place, at once
        for p in params:
            p.mul_(-3.0).add_(1.0)
    pending.join(s.X_f.device)
    assert torch.equal(pending.swap.idx, want.idx)
    assert torch.equal(pending.swap.X_new, want.X_new)


@pytest.mark.parametrize("mode", ["pool", "ascent"])
def test_redraw_dispatch_does_not_wait_for_the_device(card, mode):
    """The host issues a redraw and returns while the card is still busy:
    nothing in the redraw synchronises (a host-to-device copy from
    pageable memory would wait for the redraw stream)."""
    import time

    from tensordiffeq_tpu_torch.training.fit import dispatch_redraw
    s = _ac_solver("cuda", n_f=8192, minimax=None)
    params = [t for pair in s.net.layers() for t in pair]
    hook = s._resample_hook(4, 1.0, 0.1, 0, None, mode, 5)
    # a first redraw loads its kernels' modules and fills the redraw
    # stream's share of the caching allocator
    dispatch_redraw(hook.redraw, params, s.X_f, 1).join(s.X_f.device)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # the main stream busy for ~1 s
    t0 = time.perf_counter()
    pending = dispatch_redraw(hook.redraw, params, s.X_f, 2)
    issued = time.perf_counter() - t0
    assert not pending.done.query() and issued < 0.5
    pending.join(s.X_f.device)
    torch.cuda.synchronize()
    assert pending.done.query() and pending.device_ms() > 0


def test_discarded_redraw_finishes_before_its_memory_is_reused(card):
    from tensordiffeq_tpu_torch.ops.resampling import DeviceResampler
    from tensordiffeq_tpu_torch.training.fit import dispatch_redraw
    s = _ac_solver("cuda", n_f=65536, minimax=None)
    params = [t for pair in s.net.layers() for t in pair]
    sampler = DeviceResampler(s._residual, s.domain.xlimits, 65536,
                              pool_factor=8)
    pending = dispatch_redraw(sampler.redraw, params, s.X_f, 3)
    n = pending.swap.X_new.numel()
    pending.join(s.X_f.device)  # what fit_adam does before discarding
    done = pending.done
    del pending
    fills = [torch.full((n,), 7.0, device=card) for _ in range(8)]
    torch.cuda.current_stream(card).synchronize()
    assert done.query()  # the main stream waited for the redraw
    assert all(bool((f == 7.0).all()) for f in fills)


def test_discovery_graph_steps_equal_eager_steps(card):
    rng = np.random.RandomState(0)
    n = 2048
    x, t = rng.uniform(-1, 1, (n, 1)), rng.uniform(0, 1, (n, 1))
    u = np.sin(np.pi * x) * np.exp(-t)
    grad = tdqt.grad

    def f_model(u_, var, x_, t_):
        c1, c2 = var
        uv = u_(x_, t_)
        return (grad(u_, "t")(x_, t_) - c1 * grad(grad(u_, "x"), "x")(x_, t_)
                + c2 * uv ** 3 - c2 * uv)

    models = []
    for graphs in (True, False):
        m = tdqt.DiscoveryModel()
        m.compile([2, 64, 64, 1], f_model, [x, t], u, var=[0.0, 0.0],
                  col_weights=np.random.RandomState(1).rand(n, 1),
                  lr_vars=[2e-5, 0.01], varnames=["x", "t"], verbose=False)
        m.fit(tf_iter=50, chunk=20, batch_sz=512, _graphs=graphs)
        models.append(m)
    a, b = models
    assert a.engine == "fused" and a._step_obj.graph.captures == 1
    assert b._step_obj.graph.captures == 0
    assert a.losses == b.losses and a.var_history == b.var_history
    assert np.array_equal(a.col_weights, b.col_weights)
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)


# --------------------------------------------------------------------- #
# the training options of phase 13, at small size
# --------------------------------------------------------------------- #
def _fit_counted(solver, **kw):
    cuda_taylor.reset_launch_counts()
    solver.fit(**kw)
    torch.cuda.synchronize()
    return {"k1": cuda_taylor.k1_forward.launches,
            "k2": cuda_taylor.k2_backward.launches,
            "k3": cuda_minimax.k3_minimax.launches}


def test_autotune_races_the_kernel_candidate_on_card(card):
    from tensordiffeq_tpu_torch.training.graphs import WARMUP_RUNS
    cuda_taylor.reset_launch_counts()
    s = _ac_solver("autotune", n_f=1024, minimax=None)
    launches = {"k1": cuda_taylor.k1_forward.launches,
                "k2": cuda_taylor.k2_backward.launches,
                "k3": cuda_minimax.k3_minimax.launches}
    rep = s.autotune_report
    assert set(rep["timings_ms"]) == {"generic", "fused", "cuda"}
    assert rep["choice"] == min(rep["timings_ms"], key=rep["timings_ms"].get)
    per = WARMUP_RUNS + 3
    k3 = 0 if rep["choice"] == "generic" else 1 + per
    k12 = 1 + per + (per if rep["choice"] == "cuda" else 0)
    assert launches == {"k1": k12, "k2": k12, "k3": k3}
    race = rep["minimax"]
    if race is not None:
        assert (s.engine == "fused-minimax-cuda") == race["adopted"]
    s.fit(tf_iter=5)
    assert np.isfinite(s.losses[-1]["Total Loss"])


def _refuse_k1_launches(monkeypatch):
    """Make every K1 launch ask for more shared memory than a block may
    have, on either route: the tile of the kernel beside K2, and the
    wgmma route's plan."""
    fits = cuda_taylor._Plan.tile_sizes
    route = cuda_taylor._Plan.k1_route

    def oversized(self, device, compute_dtype=None):
        tp_fwd, tp_bwd, n_sm = fits(self, device, compute_dtype)
        return 64 * tp_fwd, tp_bwd, n_sm

    def oversized_route(self, device, compute_dtype, N):
        wp = route(self, device, compute_dtype, N)
        return None if wp is None else wp._replace(smem=wp.smem + (1 << 20))

    monkeypatch.setattr(cuda_taylor._Plan, "tile_sizes", oversized)
    monkeypatch.setattr(cuda_taylor._Plan, "k1_route", oversized_route)


def test_autotune_raises_when_k1_does_not_launch_on_card(card, monkeypatch):
    """A K1 the runtime refuses fails ``compile(fused="autotune")``: the
    race does not drop the kernel candidate and train on another engine.
    The tile here asks for more shared memory than a block may have."""
    _refuse_k1_launches(monkeypatch)
    before = cuda_taylor.k1_forward.launches
    with pytest.raises(cuda_taylor.KernelLaunchError, match="K1 launch"):
        _ac_solver("autotune", n_f=512, minimax=None)
    assert cuda_taylor.k1_forward.launches == before


def test_scheduled_steps_graph_equals_eager_on_card(card):
    from tensordiffeq_tpu_torch.training import schedules as S

    def make():
        return _ac_solver("cuda", n_f=1024, minimax=None,
                          lr=S.exponential_decay(5e-3, 10, 0.5),
                          lr_weights=S.cosine_decay_schedule(5e-3, 40))

    graph, eager = make(), make()
    launches = _fit_counted(graph, tf_iter=40, chunk=10)
    eager.fit(tf_iter=40, chunk=10, _graphs=False)
    assert launches == {"k1": 0, "k2": 0, "k3": 40}
    assert graph._adam.graph.captures == 1
    assert _diff(graph, eager) == 0.0
    opt = graph._opt[0]
    sched = opt.tdq_schedules[0]
    assert int(step_count(opt, opt.param_groups[0])) == 40
    assert float(sched.lr) == float(
        S.exponential_decay(5e-3, 10, 0.5)(
            torch.tensor(39, dtype=torch.int32, device="cuda")))


def test_ntk_updates_keep_one_capture_and_equal_eager_on_card(card):
    def make():
        return _ac_solver("cuda", n_f=1024, minimax=None, sa=False,
                          Adaptive_type=3)

    graph, eager = make(), make()
    assert graph.engine == "fused-minimax-cuda"
    launches = _fit_counted(graph, tf_iter=40, chunk=10)
    eager.fit(tf_iter=40, chunk=10, _graphs=False)
    assert launches == {"k1": 0, "k2": 0, "k3": 40}
    assert len(graph.ntk_updates) == 4
    assert all(u["device_ms"] > 0 for u in graph.ntk_updates)
    assert graph._adam.graph.captures == 1
    assert _diff(graph, eager) == 0.0


@pytest.mark.parametrize("remat", [False, True], ids=["causal", "remat"])
def test_causal_ladder_keeps_one_capture_and_equals_eager_on_card(card,
                                                                  remat):
    def make():
        return _ac_solver("cuda", n_f=1024, causal_eps=[1e-6, 1e-5, 10.0],
                          causal_delta=0.5, causal_bins=8, remat=remat,
                          minimax=None)

    graph, eager = make(), make()
    assert graph.engine == "fused-cuda"  # the minimax step declines
    launches = _fit_counted(graph, tf_iter=40, chunk=10)
    eager.fit(tf_iter=40, chunk=10, _graphs=False)
    assert graph.causal_eps == 10.0  # both earlier stages opened
    assert launches == {"k1": 40 * (2 if remat else 1), "k2": 40, "k3": 0}
    assert graph._adam.graph.captures == 1
    assert all("Causal_w_last_0" in r for r in graph.losses)
    assert _diff(graph, eager) == 0.0


def test_remat_first_step_equals_the_plain_step_on_card(card):
    a = _ac_solver("cuda", n_f=1024, causal_eps=1.0)
    b = _ac_solver("cuda", n_f=1024, causal_eps=1.0, remat=True)

    def value_grad(s):
        layers = s.net.layers()
        total, _ = s.loss_fn(layers, s.lambdas["BCs"],
                             s.lambdas["residual"], s.X_f)
        return [total.detach()] + list(torch.autograd.grad(
            total, [p for pair in layers for p in pair]))

    for x, y in zip(value_grad(a), value_grad(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("family", ["periodic", "fourier"])
def test_family_graphs_equal_eager_and_serve_on_card(card, family,
                                                     tmp_path):
    from tensordiffeq_tpu_torch import networks
    from tensordiffeq_tpu_torch.serving import Surrogate

    def net(domain):  # one seed: the two solvers start from one network
        gen = networks.init_generator(0)
        return (networks.periodic_net([2, 32, 32, 1], domain, ["x"],
                                      n_harmonics=4, generator=gen)
                if family == "periodic" else
                networks.fourier_net([2, 32, 32, 1], n_frequencies=16,
                                     generator=gen))

    def make():
        return _ac_solver(None, n_f=1024, minimax=None, widths=(32, 32),
                          network=net)

    graph, eager = make(), make()
    assert graph.engine == "generic"
    launches = _fit_counted(graph, tf_iter=20, chunk=10)
    eager.fit(tf_iter=20, chunk=10, _graphs=False)
    assert launches == {"k1": 0, "k2": 0, "k3": 0}
    assert graph._adam.graph.captures == 1
    assert _diff(graph, eager) == 0.0
    graph.export_surrogate().save(str(tmp_path / "art"))
    sur = Surrogate.load(str(tmp_path / "art"), f_model=graph.f_model)
    X = np.random.RandomState(0).uniform([-1, 0], [1, 1], (500, 2))
    u = graph.predict(X)[0]
    got = sur.engine().u(X)
    assert float(np.abs(got - u).max()) <= 1e-6 * max(1.0, np.abs(u).max())


def test_fit_captures_with_an_update_loss_result_alive(card):
    """``update_loss`` returns values: a result the caller keeps holds no
    autograd graph, whose gradient accumulators of the default stream
    would make the Adam step's capture fail."""
    s = _ac_solver("cuda", n_f=1024, minimax=None)
    total, comps = s.update_loss()
    assert not total.requires_grad
    s.fit(tf_iter=5)
    assert s._adam.graph.captures == 1
    assert np.isfinite(float(total))
    assert np.isfinite(s.losses[-1]["Total Loss"])


# --------------------------------------------------------------------------- #
# mixed precision: the bf16-operand flavor of K1, K2 and K3
# --------------------------------------------------------------------------- #
# the reference's bf16 bands (the JAX solver's cross-check under
# fused_dtype): scale-relative, values and gradients
BF16_VALUES, BF16_GRADS = 5e-2, 1.5e-1


def _rms(a, b):
    return float(torch.sqrt(torch.mean((a - b).double() ** 2)))


def _nearer_bf16(got, want_bf, want_f32):
    """The kernel's RMS distance to the plain bf16 flavor is below its
    distance to the plain f32 flavor, over every leaf together: it rounds
    where the reference rounds."""
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
    return _rms(cat(got), cat(want_bf)) < _rms(cat(got), cat(want_f32))


# the bf16 route's edges: widths that are multiples of 8 but not of 16 (the
# k16 pad of the forward's stack and of the cotangent's pieces) at a ragged
# N, hidden layers narrow enough for the SIMT loops, 256-wide layers (two
# stage windows per product, a ragged tail of the 128-row tile), and
# several tiles per block at the slice's width (dW's bulk adds into the
# slot past each block's first tile)
BF16_EDGES = {
    "k16-pad": (AC, [2, 40, 24, 1], 1001),
    "narrow-hidden": (MIXED, [2, 16, 16, 1], 777),
    "wide-256": (AC, [2, 256, 256, 1], 517),
    "tiles-per-block": (AC, [2, 128, 128, 1], 20_001),
}
BF16_K3_EDGES = {
    "k16-pad-E2": (_res_system, [2, 40, 24, 2], 1001, (-1.0, 1.0)),
    "singular-k16-pad": (_res_singular, [2, 24, 40, 1], 1001, (0.5, 1.5)),
    "wide-256": (_res_ac, [2, 256, 256, 1], 517, (-1.0, 1.0)),
    "tiles-per-block": (_res_ac, [2, 128, 128, 1], 20_001, (-1.0, 1.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_kernels_match_plain_bf16_flavor_on_card(card, case):
    _bf16_table_case(card, *CASES[case])


@pytest.mark.parametrize("case", list(BF16_EDGES))
def test_bf16_kernels_at_the_bf16_routes_edges_on_card(card, case):
    _bf16_table_case(card, *BF16_EDGES[case])


def _bf16_table_case(card, reqs, widths, N):
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, widths[0], generator=g) - 1).to(card)
    shapes = [tuple(W.shape) for W, _ in layers]
    producer = cuda_taylor.build_cuda_table_fn(reqs, shapes,
                                               compute_dtype="bfloat16")
    params = [t.clone().requires_grad_(True) for p in layers for t in p]
    pairs = list(zip(params[0::2], params[1::2]))
    Xg = X.clone().requires_grad_(True)
    k1, k2 = cuda_taylor.k1_forward_bf16, cuda_taylor.k2_backward_bf16
    before = (k1.launches, k2.launches, cuda_taylor.k1_forward.launches,
              cuda_taylor.k2_backward.launches)
    got = producer(pairs, Xg)
    want = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True,
                              compute_dtype=torch.bfloat16)
    want32 = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True)
    cot = {mi: torch.randn(got[mi].shape, generator=g).to(card) for mi in got}

    def grads(tab):
        return torch.autograd.grad(sum((tab[m] * cot[m]).sum() for m in got),
                                   params + [Xg], retain_graph=True)

    g_got, g_want, g_32 = grads(got), grads(want), grads(want32)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches, cuda_taylor.k1_forward.launches,
            cuda_taylor.k2_backward.launches) \
        == (before[0] + 1, before[1] + 1, before[2], before[3])
    for mi in got:
        assert _scaled(got[mi], want[mi]) <= BF16_VALUES, mi
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert _scaled(a, b) <= BF16_GRADS, i
    mis = sorted(got)
    assert _nearer_bf16([got[m] for m in mis], [want[m] for m in mis],
                        [want32[m] for m in mis])
    assert _nearer_bf16(g_got, g_want, g_32)


def test_bf16_flavor_differs_from_f32_flavor_on_card(card):
    """The bf16 launch is not the f32 kernel: on the same inputs the two
    tables differ, by about bf16's rounding."""
    layers, _, g = _net([2, 64, 64, 1], card)
    X = (2 * torch.rand(1000, 2, generator=g) - 1).to(card)
    plan = cuda_taylor.build_cuda_table_fn(AC, [(2, 64), (64, 64),
                                                (64, 1)]).plan
    flat = plan.pack([t for p in layers for t in p])
    t32 = cuda_taylor.k1_forward(plan, X, flat)
    t16 = cuda_taylor.k1_forward_bf16(plan, X, flat)
    err = _scaled(t16, t32)
    assert 1e-4 < err <= BF16_VALUES, err


def test_bf16_k2_is_bit_identical_run_to_run(card):
    layers, _, g = _net([2, 64, 64, 1], card)
    X = (2 * torch.rand(5000, 2, generator=g) - 1).to(card)
    plan = cuda_taylor.build_cuda_table_fn(MIXED, [(2, 64), (64, 64),
                                                   (64, 1)]).plan
    flat = plan.pack([t for p in layers for t in p])
    cot = torch.randn(plan.C, 5000, 1, generator=g).to(card)
    a = cuda_taylor.k2_backward_bf16(plan, X, flat, cot)
    b = cuda_taylor.k2_backward_bf16(plan, X, flat, cot)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("flavor", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["ac", "deep", "one-point", "odd-widths",
                                  "three-coords-wide"])
def test_workspace_floats_match_the_kernels(card, case, flavor):
    """The wrapper's workspace size (``workspace_floats``) is the kernels'
    (``tdq_workspace_floats``) at several tile heights and grids."""
    reqs, widths, _ = CASES[case]
    plan = cuda_taylor.build_cuda_table_fn(
        reqs, list(zip(widths[:-1], widths[1:]))).plan
    lib = cuda_taylor.build()
    for R in (1, 17, 126, 128):
        for G in (1, 3, 132):
            want = cuda_taylor.workspace_floats(plan.layer_shapes, R, plan.ld,
                                                G, flavor)
            got = lib.tdq_workspace_floats(plan.net_h, R, G,
                                           int(flavor is not None))
            assert got == want, (R, G, got, want)


@pytest.mark.parametrize("case", list(K3_CASES))
def test_bf16_k3_matches_plain_bf16_flavor_on_card(card, case):
    _bf16_k3_case(card, case, K3_CASES)


@pytest.mark.parametrize("case", list(BF16_K3_EDGES))
def test_bf16_k3_at_the_bf16_routes_edges_on_card(card, case):
    _bf16_k3_case(card, case, BF16_K3_EDGES)


def _bf16_k3_case(card, case, cases):
    f, widths, _, _ = cases[case]
    sq32, X, w, flat = _k3_setup(case, card, cases=cases)
    sq = build_minimax_sq_fn(f, ("x", "t"), widths[-1],
                             analyze_f_model(f, ("x", "t"), widths[-1]),
                             sq32.plan.layer_shapes,
                             compute_dtype=torch.bfloat16)
    plan = sq.plan
    k3 = cuda_minimax.k3_minimax_bf16
    before = k3.launches, cuda_minimax.k3_minimax.launches
    val, dflat, gw, gX = k3(plan, X, w, plan.pack(flat))
    torch.cuda.synchronize()
    assert (k3.launches, cuda_minimax.k3_minimax.launches) \
        == (before[0] + 1, before[1])
    got = [val.reshape(1)] + [t.reshape(-1) for t in plan.unpack(dflat)] \
        + [gw, gX]

    def leaves(out):
        v, fl, w_, x_ = out
        return [v.reshape(1)] + [t.reshape(-1) for t in fl] + [w_, x_]

    want, want32 = leaves(sq.plain(flat, w, X)), leaves(sq32.plain(flat, w, X))
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), i
        # the value and gw = f² are values, the rest gradients
        band = BF16_VALUES if i in (0, len(got) - 2) else BF16_GRADS
        assert _scaled(a, b) <= band, i
    assert _nearer_bf16(got, want, want32)
    # the autograd.Function routes a CUDA call to the bf16 launch
    v = sq(list(zip(flat[0::2], flat[1::2])), w, X)
    assert k3.launches == before[0] + 2
    assert float(v) == float(val)


def test_bf16_k3_is_bit_identical_run_to_run(card):
    f, widths, _, _ = K3_CASES["ac"]
    sq32, X, w, flat = _k3_setup("ac", card)
    sq = build_minimax_sq_fn(f, ("x", "t"), widths[-1],
                             analyze_f_model(f, ("x", "t"), widths[-1]),
                             sq32.plan.layer_shapes,
                             compute_dtype=torch.bfloat16)
    X, w = X.repeat(5, 1).contiguous(), w.repeat(5, 1).contiguous()
    packed = sq.plan.pack(flat)
    a = cuda_minimax.k3_minimax_bf16(sq.plan, X, w, packed)
    b = cuda_minimax.k3_minimax_bf16(sq.plan, X, w, packed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bf16_k2_k3_bit_identical_at_full_width_on_card(card):
    """At the slice's width (128, tiles of 128 rows) with several tiles per
    block: two launches of K2-bf16 and of K3-bf16 give the same bits (a
    block adds each tile's dW into its own slot in the tiles' order, by
    bulk reduce-adds past its first tile, each waited for before the next;
    the slots summed in slot order)."""
    widths = [2, 128, 128, 128, 1]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(20_000, 2, generator=g) - 1).to(card)
    shapes = [tuple(W.shape) for W, _ in layers]
    plan = cuda_taylor.build_cuda_table_fn(AC, shapes).plan
    assert plan.tile_sizes(card, torch.bfloat16)[1] == 32
    flat = plan.pack([t for p in layers for t in p])
    cot = torch.randn(plan.C, 20_000, 1, generator=g).to(card)
    a = cuda_taylor.k2_backward_bf16(plan, X, flat, cot)
    b = cuda_taylor.k2_backward_bf16(plan, X, flat, cot)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sq = build_minimax_sq_fn(_res_ac, ("x", "t"), 1,
                             analyze_f_model(_res_ac, ("x", "t"), 1), shapes,
                             compute_dtype=torch.bfloat16)
    w = torch.rand(20_000, 1, generator=g).to(card)
    packed = sq.plan.pack([a if a.ndim == 2 else a.reshape(1, -1)
                           for pair in layers for a in pair])
    a = cuda_minimax.k3_minimax_bf16(sq.plan, X, w, packed)
    b = cuda_minimax.k3_minimax_bf16(sq.plan, X, w, packed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(bool(torch.isfinite(x).all()) for x in a)


# the solver and the serving engine under mixed precision
@pytest.mark.parametrize("minimax", [None, False],
                         ids=["minimax", "unfused"])
def test_bf16_graph_adam_steps_equal_eager_steps(card, minimax):
    kw = dict(n_f=1024, minimax=minimax, fused_dtype="bfloat16")
    graph, eager = _ac_solver("cuda", **kw), _ac_solver("cuda", **kw)
    assert graph.fused_dtype is torch.bfloat16
    cuda_taylor.reset_launch_counts()
    graph.fit(tf_iter=30, chunk=10)
    counts = {fn.__name__: fn.launches for fn in cuda_taylor.COUNTED}
    want = ({"k3_minimax_bf16": 30} if minimax is None else
            {"k1_forward_bf16": 30, "k2_backward_bf16": 30})
    assert counts == dict({k: 0 for k in counts}, **want)
    eager.fit(tf_iter=30, chunk=10, _graphs=False)
    assert graph._adam.graph.captures == 1
    assert eager._adam.graph.captures == 0
    assert _diff(graph, eager) == 0.0


def test_bf16_lbfgs_retreats_from_k3_bf16_to_k3_on_card(card):
    """The retreat, forced by a tol_fun no step beats: evaluations on the
    bf16 objective launch K3-bf16, those after the retreat the f32 K3."""
    from tensordiffeq_tpu_torch.training import lbfgs as tl
    s = _ac_solver("cuda", n_f=1024, minimax=None, fused_dtype="bfloat16")
    s.fit(tf_iter=5)
    shapes = tl.layer_shapes(s.net.layers())
    fun = tl.lbfgs_objective(s.loss_fn, s.lambdas, s.X_f, shapes)
    fun32 = tl.lbfgs_objective(s.loss_fn_refine, s.lambdas, s.X_f, shapes)
    x0 = tl.flatten_layers(s.net.layers())
    k16, k32 = cuda_minimax.k3_minimax_bf16, cuda_minimax.k3_minimax
    cuda_taylor.reset_launch_counts()
    e0 = tl.lbfgs_minimize.evaluations
    retreats = []
    with tl.ieee_f32():
        # two chunks of 2 on bf16, stagnation, then 2 on f32
        tl.lbfgs_minimize(fun, x0, maxiter=6, chunk=2, tol_fun=1e300,
                          fun_fallback=fun32, on_retreat=retreats.append)
    torch.cuda.synchronize()
    assert retreats == [4]
    evals = tl.lbfgs_minimize.evaluations - e0
    assert k16.launches > 0 and k32.launches > 0
    assert k16.launches + k32.launches == evals
    # and through fit: the leg starts on K3-bf16
    cuda_taylor.reset_launch_counts()
    s.fit(newton_iter=5)
    assert k16.launches > 0
    assert (k32.launches == 0) == (s.lbfgs_retreat is None)


def test_bf16_serving_rungs_launch_k1_bf16_per_replay(card):
    solver = _ac_solver("cuda", n_f=1024, minimax=None, fused_dtype="bfloat16")
    solver.fit(tf_iter=5)
    sur = solver.export_surrogate()
    eng = sur.engine(min_bucket=64, max_bucket=1024, compute_dtype="bfloat16")
    f32 = sur.engine(min_bucket=64, max_bucket=1024)
    X = _serve_points(700, seed=3)
    for spec in ("u", "d:x:2", "residual"):
        got = eng.op_for(spec)(X)
        assert _serve_equal(got, _serve_eager(eng, spec, X, 1024)), spec
        ref = f32.op_for(spec)(X)
        err = _scaled(torch.from_numpy(np.asarray(got)),
                      torch.from_numpy(np.asarray(ref)))
        assert 0 < err <= BF16_VALUES, (spec, err)
        cuda_taylor.reset_launch_counts()
        for _ in range(3):
            eng.op_for(spec)(X)
        counts = {fn.__name__: fn.launches for fn in cuda_taylor.COUNTED}
        assert counts == dict({k: 0 for k in counts}, k1_forward_bf16=3)
    # an order past the propagation's reach is the f32 program
    np.testing.assert_array_equal(eng.derivative(X, "x", 5),
                                  f32.derivative(X, "x", 5))
    assert all(r.graph.captures == 1 for r in eng._rungs.values())


@pytest.mark.parametrize("fused", ["cuda", "autotune"])
def test_bf16_k1_launch_failure_raises_out_of_compile(card, monkeypatch,
                                                      fused):
    """A K1-bf16 the runtime refuses fails ``compile(fused_dtype=...)``
    (``fused="cuda"``: the cross-check's error, caused by the launch's;
    ``"autotune"``: the launch's own): the solver does not take the plain
    flavor or the f32 kernel instead."""
    _refuse_k1_launches(monkeypatch)
    before = (cuda_taylor.k1_forward_bf16.launches,
              cuda_taylor.k1_forward.launches)
    with pytest.raises((cuda_taylor.KernelLaunchError, ValueError)) as info:
        _ac_solver(fused, n_f=512, minimax=False, fused_dtype="bfloat16")
    err = info.value
    if not isinstance(err, cuda_taylor.KernelLaunchError):
        err = err.__cause__
    assert isinstance(err, cuda_taylor.KernelLaunchError)
    assert "K1 launch" in str(err)
    assert (cuda_taylor.k1_forward_bf16.launches,
            cuda_taylor.k1_forward.launches) == before


# --------------------------------------------------------------------------- #
# K1's two routes: the persistent wgmma one (csrc/taylor_fwd_wg.cuh) for
# hidden widths up to 128 and up to 8 channels, the kernel beside K2 for
# the rest
# --------------------------------------------------------------------------- #
# the wgmma route's one- and two-channel instances, its tile edges (128
# rows in the f32 flavor: 32 points at C = 4) and a layer too wide for it
K1_EDGES = {
    "one-channel": ({()}, [2, 128, 128, 1], 1001),
    "two-channels": ({(), (0,)}, [2, 128, 64, 1], 1001),
    "below-one-tile": (AC, [2, 128, 128, 1], 5),
    "one-row-past-tiles": (AC, [2, 128, 128, 1], 32 * 40 + 1),
    "fewer-tiles-than-sms": (MIXED, [2, 128, 128, 128, 1], 16 * 100 - 3),
    "width-256": (AC, [2, 256, 256, 1], 517),
}
K1_ROUTE = {"three-coords-wide": "wide", "width-256": "wide"}


def _k1_case(card, reqs, widths, N, flavor):
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, widths[0], generator=g) - 1).to(card)
    plan = cuda_taylor.build_cuda_table_fn(
        reqs, [tuple(W.shape) for W, _ in layers]).plan
    flat = plan.pack([t for p in layers for t in p])
    k1 = cuda_taylor.FLAVORS[flavor][0]
    before = k1.launches
    table = k1(plan, X, flat)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    with torch.no_grad():
        want = taylor_derivatives(layers, X, set(plan.channels),
                                  flat_matmul=True, compute_dtype=flavor)
        want32 = taylor_derivatives(layers, X, set(plan.channels),
                                    flat_matmul=True)
    return plan, table, [want[mi] for mi in plan.channels], \
        [want32[mi] for mi in plan.channels]


@pytest.mark.parametrize("flavor", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES) + list(K1_EDGES))
def test_k1_routes_match_plain_flavor_on_card(card, case, flavor):
    """Each flavor of K1 against its plain flavor on every shape, and the
    route the host chose by shape: f32 within 1e-4 scale-relative; bf16
    within the reference's band and nearer it by RMS than the f32 plain
    flavor."""
    reqs, widths, N = {**CASES, **K1_EDGES}[case]
    plan, table, want, want32 = _k1_case(card, reqs, widths, N, flavor)
    assert plan.k1_routes[flavor] == K1_ROUTE.get(case, "wgmma")
    for c in range(plan.C):
        assert table[c].shape == (N, widths[-1])
        assert _scaled(table[c], want[c]) <= (
            TOL if flavor is None else BF16_VALUES), plan.channels[c]
    if flavor is not None:
        assert _nearer_bf16(list(table), want, want32)


@pytest.mark.parametrize("flavor", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", [[2, 128, 128, 128, 128, 1],
                                    [2, 37, 53, 1]], ids=["ac", "odd"])
def test_k1_rows_bit_identical_whatever_n_and_position(card, widths, flavor):
    """K1 is the same bit for bit run to run, and a point's table row is
    the same whatever N is and wherever the point sits in X (one route):
    remat's bit equality and the served rungs rely on it."""
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        MIXED, [tuple(W.shape) for W, _ in layers]).plan
    flat = plan.pack([t for p in layers for t in p])
    k1 = cuda_taylor.FLAVORS[flavor][0]
    X = (2 * torch.rand(5000, 2, generator=g) - 1).to(card)
    a, b = k1(plan, X, flat), k1(plan, X, flat)
    assert torch.equal(a, b)
    perm = torch.randperm(5000, generator=g).to(card)
    assert torch.equal(k1(plan, X[perm].contiguous(), flat), a[:, perm])
    for n in (1, 37, 129, 4097):
        assert torch.equal(k1(plan, X[-n:].contiguous(), flat), a[:, -n:])
    assert plan.k1_routes[flavor] == "wgmma"


@pytest.mark.parametrize("flavor", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES) + list(K1_EDGES))
def test_k1_route_plan_matches_the_kernels(card, case, flavor):
    """The wrapper's plan of the wgmma route (``wg_plan``: shared memory,
    grid, stages, ...) is the kernels' (``tdq_k1wg_plan``) for several N,
    and both refuse the same shapes."""
    reqs, widths, _ = {**CASES, **K1_EDGES}[case]
    plan = cuda_taylor.build_cuda_table_fn(
        reqs, list(zip(widths[:-1], widths[1:]))).plan
    lib = cuda_taylor.build()
    smem, n_sm = plan.card(card)
    for N in (1, 31, 32, 33, 4223, 50_000, 200_000):
        want = cuda_taylor.wg_plan(plan.layer_shapes, plan.orders,
                                   flavor is not None, smem, n_sm, N)
        out = (ctypes.c_int * len(cuda_taylor.WgPlan._fields))()
        took = lib.tdq_k1wg_plan(plan.net_h, plan.sched_h,
                                 int(flavor is not None), smem, n_sm, N, out)
        got = cuda_taylor.WgPlan(*out) if took else None
        assert got == want, (N, got, want)
        assert (want is None) == (K1_ROUTE.get(case) == "wide")
        if want is not None:
            assert want.smem <= smem and want.grid <= n_sm


@pytest.mark.parametrize("flavor", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [c for c in list(CASES) + list(K1_EDGES)
                                  if K1_ROUTE.get(c) != "wide"])
def test_k1_weight_chunks_match_the_plain_mirror(card, case, flavor):
    """The chunks the wgmma route's launch prepares on the card
    (``prep_wg_weights``) are, byte for byte, those of the plain mirror
    ``wg_prepare`` that the CPU tests hold to the layout: W^T in core
    matrices and the k-slot order, split into TF32 hi and lo planes (f32)
    or rounded to bf16."""
    reqs, widths, N = {**CASES, **K1_EDGES}[case]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, widths[0], generator=g) - 1).to(card)
    plan = cuda_taylor.build_cuda_table_fn(
        reqs, [tuple(W.shape) for W, _ in layers]).plan
    flat_layers = [t for p in layers for t in p]
    flat = plan.pack(flat_layers)
    bf16 = int(flavor is not None)
    wp = plan.k1_route(card, flavor, N)
    assert wp is not None
    n_bytes = wp.P * wp.stage_bytes
    chunks = torch.full((max(n_bytes // 4, 1),), float("nan"), device=card)
    table = torch.empty((plan.C, N, plan.n_out), device=card)
    err = cuda_taylor.build().tdq_taylor_fwd_wg(
        X.data_ptr(), flat.data_ptr(), chunks.data_ptr(), table.data_ptr(), N,
        plan.net_h, plan.sched_h, bf16,
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream(card).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    got = chunks.cpu().view(torch.uint8)[:n_bytes]
    want = cuda_taylor.wg_prepare(flat_layers, wp, bool(bf16))
    assert want.numel() == n_bytes
    assert torch.equal(got, want)
    assert torch.equal(table, cuda_taylor.FLAVORS[flavor][0](plan, X, flat))


# ------------------------------------------------------------------ #
# the PDE zoo's shapes, and fit's telemetry and evaluation hooks
# ------------------------------------------------------------------ #
ZOO_N = 4096


def _zoo_solver(entry_id, n_f=ZOO_N, device="cuda"):
    """The zoo entry at its full widths, d, n_out and E, at ``n_f``
    collocation points."""
    import dataclasses
    from tensordiffeq_tpu_torch import zoo
    entry = zoo.get(entry_id)
    spec = dataclasses.replace(entry.spec("full"), n_f=n_f)
    return zoo.build_solver(entry, spec=spec, device=device)


def _zoo_ids():
    from tensordiffeq_tpu_torch import zoo
    return list(zoo.ids())


def _close(got, want):
    """Every leaf finite and within ``TOL`` scale-relative."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.reshape(-1), b.reshape(-1)
        assert bool(torch.isfinite(a).all()), i
        assert _scaled(a, b) <= TOL, (i, _scaled(a, b))


@pytest.mark.parametrize("entry_id", _zoo_ids())
def test_zoo_shapes_kernels_match_plain_flavors_on_card(card, entry_id):
    """K3 (the entry's lowered step), K1 and K2 (its requests) against
    their plain flavors at the entry's full widths, d, n_out and E, at N =
    4,096; the solver adopts K3 with E = n_components."""
    from tensordiffeq_tpu_torch import zoo
    s = _zoo_solver(entry_id)
    assert zoo.engine_label(s) == "fused-minimax-cuda"
    assert s._minimax_n_eq == zoo.get(entry_id).n_components
    X = s.X_f.contiguous()
    layers = [(W.detach(), b.detach()) for W, b in s.net.layers()]
    fl = [a if a.ndim == 2 else a.reshape(1, -1) for p in layers for a in p]
    sq = s._minimax_sq
    w = torch.rand(X.shape[0], sq.plan.E, device=card) ** 2
    got = cuda_minimax.k3_minimax(sq.plan, X, w, sq.plan.pack(fl))
    want = sq.plain(fl, w, X)
    _close([got[0].reshape(1)] + sq.plan.unpack(got[1]) + [got[2], got[3]],
           [want[0].reshape(1)] + list(want[1]) + [want[2], want[3]])
    plan = cuda_taylor.build_cuda_table_fn(
        s._fuse_requests, [tuple(W.shape) for W, _ in layers]).plan
    flat_layers = [t for p in layers for t in p]
    flat = plan.pack(flat_layers)
    table = cuda_taylor.k1_forward(plan, X, flat)
    params = [t.clone().requires_grad_(True) for t in flat_layers]
    pairs = list(zip(params[0::2], params[1::2]))
    Xg = X.clone().requires_grad_(True)
    ref = taylor_derivatives(pairs, Xg, set(plan.channels), flat_matmul=True)
    _close(list(table), [ref[mi].detach() for mi in plan.channels])
    g = torch.randn(plan.C, X.shape[0], plan.n_out, device=card)
    dX, dflat = cuda_taylor.k2_backward(plan, X, flat, g)
    loss = sum((ref[mi] * g[c]).sum() for c, mi in enumerate(plan.channels))
    _close(plan.unpack(dflat) + [dX],
           torch.autograd.grad(loss, params + [Xg], materialize_grads=True))


def _n_syncs_with(solver, epochs, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver.fit(tf_iter=epochs, chunk=epochs, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def test_fit_with_telemetry_and_eval_does_not_sync_inside_a_chunk(card):
    """With a telemetry subscriber and an eval hook at every chunk
    boundary, the synchronising calls of one ``fit`` (chunk = the whole
    fit) do not grow with its epochs, and the instrumented step is
    captured once."""
    from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry,
                                                  TrainingTelemetry)
    solver = _ac_solver("cuda", n_f=512, minimax=None)
    tele = TrainingTelemetry(registry=MetricsRegistry())
    seen = []

    def eval_fn(phase, step, params):
        seen.append((phase, step))
        solver._apply_eval(params, np.zeros((4, 2), np.float32))

    kw = dict(telemetry=tele, eval_fn=eval_fn, eval_every=1)
    # the capture of the instrumented step, with room for 12 history rows
    # (a longer chunk takes a new buffer, and so a new capture)
    _n_syncs_with(solver, 12, **kw)
    few, many = _n_syncs_with(solver, 3, **kw), _n_syncs_with(solver, 12,
                                                             **kw)
    assert few == many, (few, many)
    assert solver._adam.graph.captures == 1 and solver._adam.grad_norm
    assert seen[-1] == ("adam", 12) and len(seen) == 3
    assert all("Grad_norm" in r for r in solver.losses[-12:])


def test_grad_norm_equals_the_eager_steps_gradient_norm(card):
    """``Grad_norm`` is the global norm of the gradients (network and λ):
    the first step's equals the norm autograd gives at the initial
    parameters, and the graphed steps' equal the eager steps' bit for
    bit."""
    from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry,
                                                  TrainingTelemetry)
    s = _ac_solver("cuda", n_f=1024, minimax=None)
    params = [t.detach().clone().requires_grad_(True)
              for p in s.net.layers() for t in p]
    lams = {k: [None if v is None else v.detach().clone().requires_grad_(
        v.requires_grad) for v in vs] for k, vs in s.lambdas.items()}
    total, _ = s.loss_fn(list(zip(params[0::2], params[1::2])), lams["BCs"],
                         lams["residual"], s.X_f)
    trained = params + [v for vs in lams.values() for v in vs
                        if v is not None and v.requires_grad]
    grads = torch.autograd.grad(total, trained, materialize_grads=True)
    want = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    eager = _ac_solver("cuda", n_f=1024, minimax=None)
    for solver, graphs in ((s, True), (eager, False)):
        solver.fit(tf_iter=10, chunk=10, _graphs=graphs,
                   telemetry=TrainingTelemetry(registry=MetricsRegistry()))
    assert s._adam.graph.captures == 1 and eager._adam.graph.captures == 0
    got = s.losses[0]["Grad_norm"]
    assert abs(got - want) <= 1e-5 * want, (got, want)
    assert [r["Grad_norm"] for r in s.losses] \
        == [r["Grad_norm"] for r in eager.losses]


# --------------------------------------------------------------------------- #
# the single-pass TF32 flavor of K1, K2 and K3 (precision "default")
# --------------------------------------------------------------------------- #
# the route's edges beside CASES: the slice's width on the wgmma route
# (hi plane alone, resident chunks) with several tiles per SM, and a
# 256-wide layer on the first kernel
TF32_EDGES = {
    "ac-128": (AC, [2, 128, 128, 128, 128, 1], 50_001),
    "wide-256": (AC, [2, 256, 256, 1], 517),
}


def _nearer(got, want_a, want_b):
    """``got``'s RMS distance to ``want_a`` is below its distance to
    ``want_b``, over every leaf together."""
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
    return _rms(cat(got), cat(want_a)) < _rms(cat(got), cat(want_b))


# The TF32 flavor's band.  Rounding each layer's input to TF32 is
# discontinuous: two sum orders of the same single-pass semantics round the
# few operands that sit on a TF32 rounding boundary to neighbouring values,
# a TF32 unit apart, so no referee with another order holds a kernel to a
# fixed 1e-4 everywhere (ops/taylor.py; scripts/torch_tf32_order_witness.py
# measures it on the CPU).  Two referees of the same semantics stand beside
# the kernel: the emulation (float32 sums) and its float64-summed twin.
# Each leaf's RMS scale-relative distance to the nearer of them is held
# within TF32_SPREAD times the largest RMS distance between the two
# referees on any leaf (the order spread on these inputs), at least TOL;
# the whole is nearer (RMS) the emulation than the IEEE flavor.  A leaf's
# max distance, where one flipped operand decides it, is held within the
# larger of that band in the max metric and TF32_FLIP of the emulation's
# own max distance to the IEEE flavor (a flip moves one operand by one
# TF32 unit; rounding every operand moves the table that far).
TF32_SPREAD, TF32_FLIP = 3.0, 0.5


def _rms_rel(a, b):
    return _rms(a, b) / max(float(torch.sqrt(torch.mean(b.double() ** 2))),
                            1e-30)


def _within_tf32_spread(got, emu, twin, ieee):
    flip = TF32_FLIP * max(_scaled(e, i) for e, i in zip(emu, ieee))
    for metric, extra in ((_rms_rel, 0.0), (_scaled, flip)):
        spread = max(metric(t, e) for t, e in zip(twin, emu))
        band = max(TOL, TF32_SPREAD * spread, extra)
        for i, (a, e, t) in enumerate(zip(got, emu, twin)):
            assert bool(torch.isfinite(a).all()), i
            d = min(metric(a, e), metric(a, t))
            assert d <= band, (metric.__name__, i, d, band)
    assert _nearer(got, emu, ieee)


@pytest.mark.parametrize("case", list(CASES) + list(TF32_EDGES))
def test_tf32_kernels_match_tf32_emulation_on_card(card, case):
    """K1-TF32 and K2-TF32 against the plain flavor's TF32-emulating mode
    (every product on cvt.rna-rounded operands, f32 sums) within 1e-4
    scale-relative, nearer to it than to the IEEE flavor, and launched
    alone."""
    reqs, widths, N = {**CASES, **TF32_EDGES}[case]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, widths[0], generator=g) - 1).to(card)
    shapes = [tuple(W.shape) for W, _ in layers]
    producer = cuda_taylor.build_cuda_table_fn(reqs, shapes, precision=None)
    assert producer.flavor == cuda_taylor.TF32
    params = [t.clone().requires_grad_(True) for p in layers for t in p]
    pairs = list(zip(params[0::2], params[1::2]))
    Xg = X.clone().requires_grad_(True)
    k1, k2 = cuda_taylor.k1_forward_tf32, cuda_taylor.k2_backward_tf32
    before = (k1.launches, k2.launches, cuda_taylor.k1_forward.launches,
              cuda_taylor.k2_backward.launches)
    got = producer(pairs, Xg)
    want = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True,
                              emulate_tf32=True)
    twin = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True,
                              emulate_tf32="float64")
    want32 = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True)
    cot = {mi: torch.randn(got[mi].shape, generator=g).to(card) for mi in got}

    def grads(tab):
        return torch.autograd.grad(sum((tab[m] * cot[m]).sum() for m in got),
                                   params + [Xg], retain_graph=True)

    g_got, g_want, g_twin, g_32 = (grads(got), grads(want), grads(twin),
                                   grads(want32))
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches, cuda_taylor.k1_forward.launches,
            cuda_taylor.k2_backward.launches) \
        == (before[0] + 1, before[1] + 1, before[2], before[3])
    mis = sorted(got)
    _within_tf32_spread([got[m] for m in mis], [want[m] for m in mis],
                        [twin[m] for m in mis], [want32[m] for m in mis])
    _within_tf32_spread(list(g_got), list(g_want), list(g_twin), list(g_32))


@pytest.mark.parametrize("case", list(K3_CASES))
def test_tf32_k3_matches_tf32_emulation_on_card(card, case):
    f, widths, _, _ = K3_CASES[case]
    sq32, X, w, flat = _k3_setup(case, card)
    sq = build_minimax_sq_fn(f, ("x", "t"), widths[-1],
                             analyze_f_model(f, ("x", "t"), widths[-1]),
                             sq32.plan.layer_shapes, precision=None)
    assert sq.flavor == cuda_taylor.TF32
    plan = sq.plan
    k3 = cuda_minimax.k3_minimax_tf32
    before = k3.launches, cuda_minimax.k3_minimax.launches
    val, dflat, gw, gX = k3(plan, X, w, plan.pack(flat))
    torch.cuda.synchronize()
    assert (k3.launches, cuda_minimax.k3_minimax.launches) \
        == (before[0] + 1, before[1])
    got = [val.reshape(1)] + [t.reshape(-1) for t in plan.unpack(dflat)] \
        + [gw, gX]

    def leaves(out):
        v, fl, w_, x_ = out
        return [v.reshape(1)] + [t.reshape(-1) for t in fl] + [w_, x_]

    want = leaves(sq.plain(flat, w, X, emulate_tf32=True))
    twin = leaves(sq.plain(flat, w, X, emulate_tf32="float64"))
    want32 = leaves(sq32.plain(flat, w, X))
    _within_tf32_spread(got, want, twin, want32)
    # the autograd.Function routes a CUDA call to the TF32 launch
    v = sq(list(zip(flat[0::2], flat[1::2])), w, X)
    assert k3.launches == before[0] + 2
    assert float(v) == float(val)


def test_tf32_kernels_are_bit_identical_run_to_run(card):
    widths = [2, 128, 128, 128, 1]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(20_000, 2, generator=g) - 1).to(card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers]).plan
    flat = plan.pack([t for p in layers for t in p])
    a = cuda_taylor.k1_forward_tf32(plan, X, flat)
    assert plan.k1_routes[cuda_taylor.TF32] == "wgmma"
    assert torch.equal(a, cuda_taylor.k1_forward_tf32(plan, X, flat))
    cot = torch.randn(plan.C, 20_000, 1, generator=g).to(card)
    a = cuda_taylor.k2_backward_tf32(plan, X, flat, cot)
    b = cuda_taylor.k2_backward_tf32(plan, X, flat, cot)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sq, Xk, w, kflat = _k3_setup("ac", card)
    Xk, w = Xk.repeat(5, 1).contiguous(), w.repeat(5, 1).contiguous()
    packed = sq.plan.pack(kflat)
    a = cuda_minimax.k3_minimax_tf32(sq.plan, Xk, w, packed)
    b = cuda_minimax.k3_minimax_tf32(sq.plan, Xk, w, packed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_tf32_wgmma_chunks_are_the_hi_plane(card):
    """K1-TF32's wgmma route prepares the hi plane of the f32 route's
    chunks, byte for byte with ``wg_prepare``, half the f32 bytes."""
    widths = [2, 128, 128, 128, 1]
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers]).plan
    flat_layers = [t for p in layers for t in p]
    smem, n_sm = plan.card(card)
    wp = cuda_taylor.wg_plan(plan.layer_shapes, plan.orders, 2, smem, n_sm,
                             1000)
    wp32 = cuda_taylor.wg_plan(plan.layer_shapes, plan.orders, 0, smem, n_sm,
                               1000)
    assert wp.stage_bytes * 2 == wp32.stage_bytes and wp.resident
    chunks = torch.zeros(wp.P * wp.stage_bytes // 4, device=card)
    table = torch.empty(plan.C, 1000, 1, device=card)
    X = (2 * torch.rand(1000, 2, generator=g) - 1).to(card)
    lib = cuda_taylor.build()
    err = lib.tdq_taylor_fwd_wg(
        X.data_ptr(), plan.pack(flat_layers).data_ptr(), chunks.data_ptr(),
        table.data_ptr(), 1000, plan.net_h, plan.sched_h, 2,
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = cuda_taylor.wg_prepare(flat_layers, wp, cuda_taylor.TF32)
    assert torch.equal(chunks.cpu().view(torch.uint8), want)


def test_tf32_graph_capture_keeps_each_solvers_precision(card):
    """A ``precision=None`` solver's step is captured under TF32 and a
    ``"highest"`` one's under IEEE float32, side by side: each solver's
    replays (before and after the other's capture) equal its eager steps
    bit for bit, and the two trajectories differ (TF32 against IEEE)."""
    def make(precision):
        net = tdqt.neural_net([2, 32, 32, 1], seed=0, precision=precision)
        return _ac_solver(False, n_f=1024, minimax=False, widths=(32, 32),
                          network=lambda domain: net)

    tf_g, tf_e, hi_g, hi_e = (make(None), make(None), make("highest"),
                              make("highest"))
    assert tf_g.precision == "default" and hi_g.precision == "highest"
    for graphs in (True, False):
        tf, hi = (tf_g, hi_g) if graphs else (tf_e, hi_e)
        tf.fit(tf_iter=10, chunk=10, _graphs=graphs)
        hi.fit(tf_iter=10, chunk=10, _graphs=graphs)
        tf.fit(tf_iter=10, chunk=10, _graphs=graphs)
        hi.fit(tf_iter=10, chunk=10, _graphs=graphs)
    assert tf_g._adam.graph.captures == hi_g._adam.graph.captures == 1
    assert _diff(tf_g, tf_e) == 0.0 and _diff(hi_g, hi_e) == 0.0
    assert [r["Total Loss"] for r in tf_g.losses] != \
        [r["Total Loss"] for r in hi_g.losses]


def test_tf32_serving_derivative_rungs_launch_k1_tf32_per_replay(card):
    """A served ``precision=None`` MLP answers its derivative kinds from
    K1-TF32, one launch per replay of each rung's graph, within the TF32
    flavor's distance of the same net served at ``"highest"``; ``u`` is
    the forward at TF32 matmuls, with no launch."""
    from tensordiffeq_tpu_torch.serving import Surrogate
    net = tdqt.neural_net([2, 32, 32, 1], seed=0, precision=None)
    solver = _ac_solver("cuda", n_f=1024, minimax=None, widths=(32, 32),
                        network=lambda domain: net)
    assert solver._minimax_sq.flavor == cuda_taylor.TF32
    solver.fit(tf_iter=5)
    sur = solver.export_surrogate()
    eng = sur.engine(min_bucket=64, max_bucket=1024)
    assert eng._tf32
    hi = Surrogate(tdqt.neural_net([2, 32, 32, 1], seed=0),
                   sur.params, sur.varnames, f_model=sur.f_model)
    ref = hi.engine(min_bucket=64, max_bucket=1024)
    X = _serve_points(700, seed=3)
    for spec, launches in (("u", 0), ("d:x:1", 3), ("d:x:2", 3)):
        got = eng.op_for(spec)(X)
        assert _serve_equal(got, _serve_eager(eng, spec, X, 1024)), spec
        err = _scaled(torch.from_numpy(np.asarray(got)),
                      torch.from_numpy(np.asarray(ref.op_for(spec)(X))))
        assert err <= 2e-2, (spec, err)
        cuda_taylor.reset_launch_counts()
        for _ in range(3):
            eng.op_for(spec)(X)
        counts = {fn.__name__: fn.launches for fn in cuda_taylor.COUNTED}
        assert counts == dict({k: 0 for k in counts},
                              **({"k1_forward_tf32": 3} if launches
                                 else {})), spec
    assert all(r.graph.captures == 1 for r in eng._rungs.values())
