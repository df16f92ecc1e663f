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
* data parallelism (``chip_smoke.py`` phase 17, at small size), in a
  process of its own with a one-rank NCCL group: 20 steps of the
  ``dist=True`` solver (the all-reduce inside the captured step) and 5
  L-BFGS iterations are bit for bit the non-dist solver's, with one
  capture of each step; an NCCL all-reduce captured in a CUDA graph
  (``StepGraph``, ``"thread_local"`` capture under a process group)
  replays equal to the same step run eagerly.
* the operational planes (``chip_smoke.py`` phase 18, at small size): in
  a two-rank gloo process (on the card, both ranks on one device) whose
  data-parallel steps moved CUDA tensors, a non-dist solver's ``fit``
  captures its Adam graph and equals its eager run bit for bit; chaos's
  NaN fault, written into the live parameters, is read by the next
  replay and the sentinel trips; a preemption request is flushed at the
  chunk boundary and adds no host synchronisation, with a tracer and a
  flight recorder on; a supervised fit with chaos off is bit for bit a
  plain one through the graphs; a rollback restores into the live buffers
  and keeps the captured step.
* static analysis (``chip_smoke.py`` phase 22, at small size): the
  minimax Adam step's captured graph, dumped in debug mode and read,
  holds no host-boundary memcpy node and no host node, and its K3 kernel
  nodes equal its launches per replay; a 20-step chunk synchronises once
  (its history read); a device-to-host copy into pinned memory planted in
  a captured toy step is flagged.
* the serving fleet (``chip_smoke.py`` phase 21, at small size): a
  surrogate loaded with no f_model serves its residual from the
  artifact's lowered tape, each rung a captured graph that launches K1
  once per replay, equal to its program run eagerly bit for bit and
  within the cross-check band of the generic program; two hot swaps while
  another thread queries drop no waiter and answer with one of the two
  artifacts' own bits; a tenant cycled through eviction and reload three
  times captures again each time and keeps its quarantined rung.
"""

import contextlib
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
    does not train on the unfused loss instead.  The tile (the mma.sync
    route) or the plan (the wgmma route) here asks for more shared memory
    than a block may have."""
    fits = cuda_minimax.MinimaxPlan.tile_sizes
    route = cuda_minimax.MinimaxPlan.wb_route

    def oversized(self, device, compute_dtype=None):
        tp_fwd, tp_bwd, n_sm = fits(self, device, compute_dtype)
        return tp_fwd, 64 * tp_bwd, n_sm

    def oversized_route(self, device, flavor, N, kernel):
        wp = route(self, device, flavor, N, kernel)
        return None if wp is None else wp._replace(smem=wp.smem + (1 << 20))

    monkeypatch.setattr(cuda_minimax.MinimaxPlan, "tile_sizes", oversized)
    monkeypatch.setattr(cuda_minimax.MinimaxPlan, "wb_route", oversized_route)
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
    # restoring into a solver that has a graph writes the live buffers:
    # its step and graph replay on the restored state, no new capture
    old = a._adam
    a.restore_checkpoint(ck)
    a.fit(tf_iter=10)
    assert a._adam is old and a._adam.graph.captures == 1
    b.restore_checkpoint(ck)
    b.fit(tf_iter=10)
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
# the route K2-bf16 and K3-bf16 take at each edge: the persistent wgmma
# route of csrc/wg_backward.cuh up to 128 wide (cuda_taylor.wb_plan), the
# mma.sync kernels past it
BF16_EDGE_ROUTES = {"k16-pad": "wgmma", "narrow-hidden": "wgmma",
                    "wide-256": "mma", "tiles-per-block": "wgmma"}
BF16_K3_EDGE_ROUTES = {"k16-pad-E2": "wgmma", "singular-k16-pad": "wgmma",
                       "wide-256": "mma", "tiles-per-block": "wgmma"}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_kernels_match_plain_bf16_flavor_on_card(card, case):
    _bf16_table_case(card, *CASES[case])


@pytest.mark.parametrize("case", list(BF16_EDGES))
def test_bf16_kernels_at_the_bf16_routes_edges_on_card(card, case):
    plan = _bf16_table_case(card, *BF16_EDGES[case])
    assert plan.k2_routes[torch.bfloat16] == BF16_EDGE_ROUTES[case]


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
    return producer.plan


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
    plan = _bf16_k3_case(card, case, BF16_K3_EDGES)
    assert plan.k3_routes[torch.bfloat16] == BF16_K3_EDGE_ROUTES[case]


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
    return plan


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
    4,096; the solver adopts K3 with E = n_components.  ``w`` and the
    table cotangents come from a seeded generator on the card."""
    from tensordiffeq_tpu_torch import zoo
    s = _zoo_solver(entry_id)
    assert zoo.engine_label(s) == "fused-minimax-cuda"
    assert s._minimax_n_eq == zoo.get(entry_id).n_components
    X = s.X_f.contiguous()
    layers = [(W.detach(), b.detach()) for W, b in s.net.layers()]
    fl = [a if a.ndim == 2 else a.reshape(1, -1) for p in layers for a in p]
    sq = s._minimax_sq
    gen = torch.Generator(device=card).manual_seed(0)
    w = torch.rand(X.shape[0], sq.plan.E, generator=gen, device=card) ** 2
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
    g = torch.randn(plan.C, X.shape[0], plan.n_out, generator=gen,
                    device=card)
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
# 256-wide layer (K1-TF32 on its first kernel, K2-TF32 on the NP = 256
# design of csrc/wg_backward_wide.cuh)
TF32_EDGES = {
    "ac-128": (AC, [2, 128, 128, 128, 128, 1], 50_001),
    "wide-256": (AC, [2, 256, 256, 1], 517),
}
# the route K2-TF32 takes at each edge
TF32_EDGE_ROUTES = {"ac-128": "wgmma", "wide-256": "wgmma"}


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
    if case in TF32_EDGE_ROUTES:
        assert producer.plan.k2_routes[cuda_taylor.TF32] \
            == TF32_EDGE_ROUTES[case]
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
    return plan


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


# K2-TF32's and K3-TF32's routes by shape: the persistent wgmma route
# where cuda_taylor.wb_plan takes the shape (csrc/wg_backward.cuh at the
# slice's, burgers', and widths whose slot rows are not 16-byte pieces,
# which add dW from the SMs; csrc/wg_backward_wide.cuh at 256 wide), the
# mma.sync kernels past it
TF32_ROUTE_CASES = {
    # name: (K2's requests, widths, N, route)
    "ac-128": (AC, [2, 128, 128, 128, 128, 1], 20_011, "wgmma"),
    "burgers": (AC, [2] + [20] * 8 + [1], 3_001, "wgmma"),
    "odd-widths": ({(), (1,), (1, 1)}, [2, 37, 53, 1], 1003, "wgmma"),
    "wide-256": (AC, [2, 256, 256, 256, 256, 1], 2_000, "wgmma"),
}


@pytest.mark.parametrize("case", list(TF32_ROUTE_CASES))
def test_tf32_backward_routes_by_shape_on_card(card, case):
    """K2-TF32 and K3-TF32 take the route their shape names, stay within
    the TF32 flavor's band of the TF32 referees there, and are bit for bit
    run to run."""
    reqs, widths, N, route = TF32_ROUTE_CASES[case]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    shapes = [tuple(W.shape) for W, _ in layers]
    plan = cuda_taylor.build_cuda_table_fn(reqs, shapes, precision=None).plan
    flat = plan.pack([t for p in layers for t in p])
    cot = torch.randn(plan.C, N, widths[-1], generator=g).to(card)
    dX, dflat = cuda_taylor.k2_backward_tf32(plan, X, flat, cot)
    assert plan.k2_routes[cuda_taylor.TF32] == route
    again = cuda_taylor.k2_backward_tf32(plan, X, flat, cot)
    assert torch.equal(again[0], dX) and torch.equal(again[1], dflat)
    params = [t.clone().requires_grad_(True) for p in layers for t in p]
    pairs = list(zip(params[0::2], params[1::2]))
    Xg = X.clone().requires_grad_(True)

    def grads(**kw):
        t = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True, **kw)
        loss = sum((t[mi] * cot[c]).sum()
                   for c, mi in enumerate(plan.channels))
        return list(torch.autograd.grad(loss, params + [Xg]))

    _within_tf32_spread(plan.unpack(dflat) + [dX], grads(emulate_tf32=True),
                        grads(emulate_tf32="float64"), grads())
    sq32 = build_minimax_sq_fn(_res_ac, ("x", "t"), 1,
                               analyze_f_model(_res_ac, ("x", "t"), 1),
                               shapes)
    sq = build_minimax_sq_fn(_res_ac, ("x", "t"), 1,
                             analyze_f_model(_res_ac, ("x", "t"), 1), shapes,
                             precision=None)
    w = torch.rand(N, 1, generator=g).to(card)
    fl = [a if a.ndim == 2 else a.reshape(1, -1) for p in layers for a in p]
    got = cuda_minimax.k3_minimax_tf32(sq.plan, X, w, sq.plan.pack(fl))
    assert sq.plan.k3_routes[cuda_taylor.TF32] == route
    again = cuda_minimax.k3_minimax_tf32(sq.plan, X, w, sq.plan.pack(fl))
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    def leaves(out):
        v, d, gw_, gx_ = out
        return [v.reshape(1)] + [t.reshape(-1) for t in d] + [gw_, gx_]

    _within_tf32_spread(leaves((got[0], sq.plan.unpack(got[1]), got[2],
                                got[3])),
                        leaves(sq.plain(fl, w, X, emulate_tf32=True)),
                        leaves(sq.plain(fl, w, X, emulate_tf32="float64")),
                        leaves(sq32.plain(fl, w, X)))


def test_tf32_backward_planes_match_the_plain_mirror(card):
    """The wgmma route's weight prep writes its planes (the forward W^T,
    then the backward W in the sweep's order, TF32) byte for byte as
    ``wb_prepare`` lays them out, after the blocks' workspace slices."""
    widths = [2, 128, 128, 128, 1]
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers], precision=None).plan
    flat_layers = [t for p in layers for t in p]
    N = 1000
    wp = plan.wb_route(card, cuda_taylor.TF32, N, "k2")
    assert wp is not None and wp.P == 8
    ws = torch.zeros(wp.ws_floats, device=card)
    part = torch.empty(wp.grid, cuda_taylor.slot_stride(plan.P_total),
                       device=card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    cot = torch.randn(plan.C, N, 1, generator=g).to(card)
    dX = torch.empty(N, 2, device=card)
    grad = torch.empty(plan.P_total, device=card)
    err = cuda_taylor.build().tdq_taylor_bwd_wg(
        X.data_ptr(), plan.pack(flat_layers).data_ptr(), cot.data_ptr(),
        dX.data_ptr(), part.data_ptr(), ws.data_ptr(), grad.data_ptr(), N,
        plan.net_h, plan.sched_h, cuda_taylor.FLAVOR_CODE[cuda_taylor.TF32],
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    slices = wp.grid * (len(widths) - 2) * cuda_taylor.WB_ROWS * wp.NP
    want = cuda_taylor.wb_prepare(flat_layers, wp, cuda_taylor.TF32)
    assert torch.equal(ws[slices:].cpu().view(torch.uint8), want)


def test_tf32_backward_planes_match_the_plain_mirror_at_256(card):
    """At NP = 256 (csrc/wg_backward_wide.cuh) the TF32 weight prep writes
    its chunks of 32 k rows (the hi plane, cvt.rna, 256 n rows) byte for
    byte as ``wb_prepare`` lays them out, after the blocks' 64-row
    slices."""
    widths = [2, 256, 200, 1]
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers], precision=None).plan
    flat_layers = [t for p in layers for t in p]
    N = 1000
    wp = plan.wb_route(card, cuda_taylor.TF32, N, "k2")
    assert wp is not None and (wp.NP, wp.P, wp.KC) == (256, 16, 32)
    ws = torch.zeros(wp.ws_floats, device=card)
    part = torch.empty(wp.grid, cuda_taylor.slot_stride(plan.P_total),
                       device=card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    cot = torch.randn(plan.C, N, 1, generator=g).to(card)
    dX = torch.empty(N, 2, device=card)
    grad = torch.empty(plan.P_total, device=card)
    err = cuda_taylor.build().tdq_taylor_bwd_wg(
        X.data_ptr(), plan.pack(flat_layers).data_ptr(), cot.data_ptr(),
        dX.data_ptr(), part.data_ptr(), ws.data_ptr(), grad.data_ptr(), N,
        plan.net_h, plan.sched_h, cuda_taylor.FLAVOR_CODE[cuda_taylor.TF32],
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    slices = wp.grid * (len(widths) - 2) * cuda_taylor.wb_tile_rows(wp.NP) \
        * wp.NP
    want = cuda_taylor.wb_prepare(flat_layers, wp, cuda_taylor.TF32)
    assert torch.equal(ws[slices:].cpu().view(torch.uint8), want)


# K2's and K3's routes by shape in the f32 flavor: TF32_ROUTE_CASES'
# shapes, where the wgmma route also takes hidden widths up to 256
# (csrc/wg_backward_wide.cuh: NP = 256, tiles of 64 rows), at one tile a
# block (wide-256), several (wide-256-tiles), a ragged width whose last
# dW block is partial (ragged-200) and slot rows that are not 16-byte
# pieces (ragged-201, dW added from the SMs)
F32_ROUTE_CASES = {
    **{k: v[:3] + ("wgmma",) for k, v in TF32_ROUTE_CASES.items()},
    "wide-256-tiles": (AC, [2, 256, 256, 256, 256, 1], 20_011, "wgmma"),
    "ragged-200": (AC, [2, 200, 256, 1], 3_001, "wgmma"),
    "ragged-201": ({(), (1,), (1, 1)}, [2, 150, 201, 1], 3_001, "wgmma"),
}


@pytest.mark.parametrize("case", list(F32_ROUTE_CASES))
def test_f32_backward_routes_by_shape_on_card(card, case):
    """K2 and K3 in the f32 flavor (3xTF32) take the route their shape
    names (the wgmma route of ``csrc/wg_backward.cuh`` where ``wb_plan``
    takes the shape, up to 256 wide; the mma.sync kernels past it), are
    within TOL scale-relative of the IEEE plain flavor there, and are bit
    for bit run to run."""
    reqs, widths, N, route = F32_ROUTE_CASES[case]
    layers, _, g = _net(widths, card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    shapes = [tuple(W.shape) for W, _ in layers]
    plan = cuda_taylor.build_cuda_table_fn(reqs, shapes).plan
    flat = plan.pack([t for p in layers for t in p])
    cot = torch.randn(plan.C, N, widths[-1], generator=g).to(card)
    dX, dflat = cuda_taylor.k2_backward(plan, X, flat, cot)
    assert plan.k2_routes[None] == route
    again = cuda_taylor.k2_backward(plan, X, flat, cot)
    assert torch.equal(again[0], dX) and torch.equal(again[1], dflat)
    params = [t.clone().requires_grad_(True) for p in layers for t in p]
    pairs = list(zip(params[0::2], params[1::2]))
    Xg = X.clone().requires_grad_(True)
    t = taylor_derivatives(pairs, Xg, reqs, flat_matmul=True)
    loss = sum((t[mi] * cot[c]).sum() for c, mi in enumerate(plan.channels))
    _close(plan.unpack(dflat) + [dX],
           torch.autograd.grad(loss, params + [Xg]))
    sq = build_minimax_sq_fn(_res_ac, ("x", "t"), 1,
                             analyze_f_model(_res_ac, ("x", "t"), 1), shapes)
    w = torch.rand(N, 1, generator=g).to(card)
    fl = [a if a.ndim == 2 else a.reshape(1, -1) for p in layers for a in p]
    got = cuda_minimax.k3_minimax(sq.plan, X, w, sq.plan.pack(fl))
    assert sq.plan.k3_routes[None] == route
    again = cuda_minimax.k3_minimax(sq.plan, X, w, sq.plan.pack(fl))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = sq.plain(fl, w, X)
    _close([got[0].reshape(1)] + sq.plan.unpack(got[1]) + [got[2], got[3]],
           [want[0].reshape(1)] + list(want[1]) + [want[2], want[3]])


def test_f32_backward_planes_match_the_plain_mirror(card):
    """The f32 flavor's weight prep writes each chunk's hi and lo planes
    (split_tf32; chunks of 32 k rows) byte for byte as ``wb_prepare``
    lays them out, after the blocks' workspace slices."""
    widths = [2, 128, 128, 128, 1]
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers]).plan
    flat_layers = [t for p in layers for t in p]
    N = 1000
    wp = plan.wb_route(card, None, N, "k2")
    assert wp is not None and (wp.P, wp.KC) == (16, 32)
    ws = torch.zeros(wp.ws_floats, device=card)
    part = torch.empty(wp.grid, cuda_taylor.slot_stride(plan.P_total),
                       device=card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    cot = torch.randn(plan.C, N, 1, generator=g).to(card)
    dX = torch.empty(N, 2, device=card)
    grad = torch.empty(plan.P_total, device=card)
    err = cuda_taylor.build().tdq_taylor_bwd_wg(
        X.data_ptr(), plan.pack(flat_layers).data_ptr(), cot.data_ptr(),
        dX.data_ptr(), part.data_ptr(), ws.data_ptr(), grad.data_ptr(), N,
        plan.net_h, plan.sched_h, cuda_taylor.FLAVOR_CODE[None],
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    slices = wp.grid * (len(widths) - 2) * cuda_taylor.WB_ROWS * wp.NP
    want = cuda_taylor.wb_prepare(flat_layers, wp, None)
    assert torch.equal(ws[slices:].cpu().view(torch.uint8), want)


def test_f32_backward_planes_match_the_plain_mirror_at_256(card):
    """At NP = 256 (csrc/wg_backward_wide.cuh) the f32 weight prep writes
    its chunks of 16 k rows (hi and lo planes, 256 n rows) byte for byte
    as ``wb_prepare`` lays them out, after the blocks' 64-row slices."""
    widths = [2, 256, 200, 1]
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers]).plan
    flat_layers = [t for p in layers for t in p]
    N = 1000
    wp = plan.wb_route(card, None, N, "k2")
    assert wp is not None and (wp.NP, wp.P, wp.KC) == (256, 32, 16)
    ws = torch.zeros(wp.ws_floats, device=card)
    part = torch.empty(wp.grid, cuda_taylor.slot_stride(plan.P_total),
                       device=card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    cot = torch.randn(plan.C, N, 1, generator=g).to(card)
    dX = torch.empty(N, 2, device=card)
    grad = torch.empty(plan.P_total, device=card)
    err = cuda_taylor.build().tdq_taylor_bwd_wg(
        X.data_ptr(), plan.pack(flat_layers).data_ptr(), cot.data_ptr(),
        dX.data_ptr(), part.data_ptr(), ws.data_ptr(), grad.data_ptr(), N,
        plan.net_h, plan.sched_h, cuda_taylor.FLAVOR_CODE[None],
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    slices = wp.grid * (len(widths) - 2) * cuda_taylor.wb_tile_rows(wp.NP) \
        * wp.NP
    want = cuda_taylor.wb_prepare(flat_layers, wp, None)
    assert torch.equal(ws[slices:].cpu().view(torch.uint8), want)


def test_bf16_backward_planes_match_the_plain_mirror(card):
    """The bf16 flavor's weight prep writes its chunks (W rounded to bf16,
    64 k rows in their natural order) byte for byte as ``wb_prepare`` lays
    them out, after the blocks' workspace slices."""
    widths = [2, 128, 128, 128, 1]
    layers, _, g = _net(widths, card)
    plan = cuda_taylor.build_cuda_table_fn(
        AC, [tuple(W.shape) for W, _ in layers],
        compute_dtype="bfloat16").plan
    flat_layers = [t for p in layers for t in p]
    N = 1000
    wp = plan.wb_route(card, torch.bfloat16, N, "k2")
    assert wp is not None and (wp.P, wp.KC, wp.stage_bytes) == (8, 64, 16384)
    ws = torch.zeros(wp.ws_floats, device=card)
    part = torch.empty(wp.grid, cuda_taylor.slot_stride(plan.P_total),
                       device=card)
    X = (2 * torch.rand(N, 2, generator=g) - 1).to(card)
    cot = torch.randn(plan.C, N, 1, generator=g).to(card)
    dX = torch.empty(N, 2, device=card)
    grad = torch.empty(plan.P_total, device=card)
    err = cuda_taylor.build().tdq_taylor_bwd_wg(
        X.data_ptr(), plan.pack(flat_layers).data_ptr(), cot.data_ptr(),
        dX.data_ptr(), part.data_ptr(), ws.data_ptr(), grad.data_ptr(), N,
        plan.net_h, plan.sched_h, cuda_taylor.FLAVOR_CODE[torch.bfloat16],
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    slices = wp.grid * (len(widths) - 2) * cuda_taylor.WB_ROWS * wp.NP
    want = cuda_taylor.wb_prepare(flat_layers, wp, torch.bfloat16)
    assert torch.equal(ws[slices:].cpu().view(torch.uint8), want)


def test_tf32_minimax_step_on_the_wgmma_route_graph_equals_eager(card):
    """A ``precision=None`` minimax solver steps through K3-TF32 on its
    wgmma route, once per Adam step and nothing else, one capture, and its
    replays equal the same steps run eagerly bit for bit."""
    def make():
        net = tdqt.neural_net([2, 32, 32, 1], seed=0, precision=None)
        return _ac_solver("cuda", n_f=1024, minimax=None, widths=(32, 32),
                          network=lambda domain: net)

    graph, eager = make(), make()
    assert graph._minimax_sq.flavor == cuda_taylor.TF32
    before = {fn.__name__: fn.launches for fn in cuda_taylor.COUNTED}
    graph.fit(tf_iter=30, chunk=10)
    after = {fn.__name__: fn.launches for fn in cuda_taylor.COUNTED}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"k3_minimax_tf32": 30}
    assert graph._minimax_sq.plan.k3_routes[cuda_taylor.TF32] == "wgmma"
    eager.fit(tf_iter=30, chunk=10, _graphs=False)
    assert graph._adam.graph.captures == 1
    assert _diff(graph, eager) == 0.0
    rows = [r["Total Loss"] for r in graph.losses]
    assert rows[-1] < rows[0]


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


# --------------------------------------------------------------------------- #
# data parallelism: a one-rank NCCL group, in a process of its own
# --------------------------------------------------------------------------- #
NCCL_PRELUDE = '''
parallel.initialize_multihost("file://" + STORE, 1, 0, backend="nccl",
                              timeout_s=60)
'''


def _nccl_run(tmp_path, code: str) -> dict:
    from torch_dist_harness import spawn
    return spawn(NCCL_PRELUDE + code, str(tmp_path), world=1,
                 timeout_s=240)[0]


def test_dist_world_1_nccl_is_bit_for_bit_the_non_dist_solver(card,
                                                              tmp_path):
    got = _nccl_run(tmp_path, '''
import hashlib
from tensordiffeq_tpu_torch import grad


def solver(dist):
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 64)
    domain.add("t", [0.0, 1.0], 21)
    domain.generate_collocation_points(4096, seed=0)
    bcs = [tdqt.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                   var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [lambda u, x, t: (
               u(x, t), grad(u, "x")(x, t))])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 1e-4 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    rng = np.random.RandomState(0)
    s = tdqt.CollocationSolverND(verbose=False)
    s.compile([2, 32, 32, 1], f_model, domain, bcs, fused="cuda", dist=dist,
              Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(4096, 1)],
                            "BCs": [100.0 * rng.rand(64, 1), None]})
    s.fit(tf_iter=20, chunk=10)
    s.fit(newton_iter=5)
    h = hashlib.sha256()
    for t in s.net.params():
        h.update(t.detach().cpu().numpy().tobytes())
    return dict(hist=[r["Total Loss"] for r in s.losses],
                params=h.hexdigest(), engine=s.engine,
                captures=s._adam.graph.captures,
                backend=None if s.mesh is None else s.mesh.backend)


RESULT["dist"] = solver(True)
RESULT["plain"] = solver(False)
''')
    assert got["dist"]["backend"] == "nccl"
    assert got["dist"]["engine"] == "fused-minimax-cuda"
    assert got["dist"]["captures"] == 1
    assert got["dist"]["hist"] == got["plain"]["hist"]
    assert got["dist"]["params"] == got["plain"]["params"]


def test_nccl_all_reduce_captured_in_a_graph_equals_eager(card, tmp_path):
    got = _nccl_run(tmp_path, '''
from tensordiffeq_tpu_torch.training.graphs import StepGraph
mesh = parallel.make_mesh()
dev = mesh.device
x = torch.randn(1000, device=dev)
y = torch.zeros(1000, device=dev)
s = torch.zeros(1, device=dev)


def step():
    v = torch.sin(x) * 3.0
    w = v.sum().reshape(1)
    parallel.all_reduce_([v, w], mesh)
    y.copy_(v + 1.0)
    s.copy_(w)


graph = StepGraph(step, lambda: [x, y, s], dev, "nccl step")
outs = []
for _ in range(5):  # three warm-ups, the capture, a replay
    graph()
    torch.cuda.synchronize()
    outs.append((y.cpu().numpy().copy(), s.cpu().numpy().copy()))
step()
torch.cuda.synchronize()
RESULT.update(captures=graph.captures,
              same=all(np.array_equal(a, y.cpu().numpy())
                       and np.array_equal(b, s.cpu().numpy())
                       for a, b in outs))
''')
    assert got["captures"] == 1
    assert got["same"]


# --------------------------------------------------------------------------- #
# the operational planes: gloo and capture, chaos, preemption, recovery
# --------------------------------------------------------------------------- #
GLOO_CAPTURE = '''
import hashlib
from tensordiffeq_tpu_torch import grad


def solver(dist, seed=0):
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 64)
    domain.add("t", [0.0, 1.0], 21)
    domain.generate_collocation_points(4096, seed=0)
    bcs = [tdqt.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                   var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [lambda u, x, t: (
               u(x, t), grad(u, "x")(x, t))])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 1e-4 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    rng = np.random.RandomState(0)
    s = tdqt.CollocationSolverND(verbose=False, seed=seed)
    s.compile([2, 32, 32, 1], f_model, domain, bcs, fused="cuda", dist=dist,
              Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(4096, 1)],
                            "BCs": [100.0 * rng.rand(64, 1), None]})
    return s


def digest(s):
    h = hashlib.sha256()
    for t in s.net.params():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


d = solver(True)
d.fit(tf_iter=10, chunk=5)  # eager steps: gloo all-reduces of CUDA tensors
g = solver(False)
g.fit(tf_iter=20, chunk=10)
e = solver(False)
e.fit(tf_iter=20, chunk=10, _graphs=False)
RESULT.update(backend=d.mesh.backend, dist_eager=d._adam.graph_eager,
              captures=g._adam.graph.captures,
              graph_hist=[r["Total Loss"] for r in g.losses],
              eager_hist=[r["Total Loss"] for r in e.losses],
              graph_params=digest(g), eager_params=digest(e))
'''


def test_gloo_process_captures_a_non_dist_step_equal_to_eager(card,
                                                              tmp_path):
    from torch_dist_harness import spawn
    got = spawn(GLOO_CAPTURE, str(tmp_path), world=2, timeout_s=240)
    for r in got:
        assert r["backend"] == "gloo" and r["dist_eager"]
        assert r["captures"] == 1
        assert r["graph_hist"] == r["eager_hist"]
        assert r["graph_params"] == r["eager_params"]


def test_chaos_nan_fault_is_read_by_the_next_replay(card):
    from tensordiffeq_tpu_torch.resilience import Chaos
    from tensordiffeq_tpu_torch.telemetry import (TrainingDiverged,
                                                  TrainingTelemetry)
    s = _ac_solver("cuda", n_f=1024, minimax=None)
    tele = TrainingTelemetry(logger=None, grad_norm=False)
    with Chaos(nan_epoch=10) as c, pytest.raises(TrainingDiverged) as ei:
        s.fit(tf_iter=30, chunk=10, telemetry=tele)
    assert c.fired["nan"] == 1 and ei.value.epoch == 10
    assert s._adam.graph.captures == 1  # the replay read the poison
    assert all(np.isfinite(r["Total Loss"]) for r in s.losses[:10])
    assert not np.isfinite(s.losses[10]["Total Loss"])


def _n_syncs_with(solver, epochs, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver.fit(tf_iter=epochs, chunk=epochs, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def test_preemption_flush_and_tracing_add_no_host_sync(card, tmp_path):
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.resilience import (Preempted,
                                                   PreemptionHandler,
                                                   clear_preemption,
                                                   request_preemption)
    counts = {}
    d = str(tmp_path / "run")
    for traced in (False, True):
        s = _ac_solver("cuda", n_f=512, minimax=None)
        with telemetry.RunLogger(d) as run, PreemptionHandler():
            tele = telemetry.TrainingTelemetry(logger=run, grad_norm=False)
            tr = telemetry.Tracer() if traced else contextlib.nullcontext()
            with tr, telemetry.FlightRecorder(d):
                _n_syncs_with(s, 5, telemetry=tele)  # warm-up and capture
                counts[traced] = (_n_syncs_with(s, 3, telemetry=tele),
                                  _n_syncs_with(s, 12, telemetry=tele))
                if traced:
                    # a pending request is flushed at the next boundary
                    request_preemption()
                    try:
                        with pytest.raises(Preempted) as ei:
                            s.fit(tf_iter=20, chunk=10, telemetry=tele,
                                  checkpoint_dir=str(tmp_path / "ck"),
                                  checkpoint_every=1000)
                    finally:
                        clear_preemption()
    # per fit, not per step; and the tracer (CUDA events around the
    # replays) and the preemption check add none
    assert counts[True][0] == counts[True][1] == counts[False][0] \
        == counts[False][1], counts
    assert ei.value.epoch == 20 + 10 and ei.value.flush_s is not None
    r = _ac_solver("cuda", n_f=512, minimax=None, seed=1)
    r.restore_checkpoint(str(tmp_path / "ck"))
    assert len(r.losses) == 30
    dev = [x for x in telemetry.tracing.read_spans(d)
           if x["name"] == "train.device"]
    assert dev and all(x["attrs"].get("clock") == "cuda_events"
                       for x in dev)


def test_chaos_off_supervised_fit_is_a_plain_fit_through_graphs(card,
                                                                tmp_path):
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.resilience import Chaos, ResilientFit
    plain = _ac_solver("cuda", n_f=1024, minimax=None)
    plain.fit(tf_iter=30, chunk=10)
    sup = _ac_solver("cuda", n_f=1024, minimax=None)
    d = str(tmp_path / "run")
    with telemetry.RunLogger(d) as run, telemetry.Tracer(), \
            telemetry.FlightRecorder(d), Chaos():
        tele = telemetry.TrainingTelemetry(logger=run, grad_norm=False)
        ResilientFit(sup, str(tmp_path / "ck"), checkpoint_every=10,
                     telemetry=tele).fit(tf_iter=30, chunk=10)
    assert sup._adam.graph.captures == plain._adam.graph.captures == 1
    assert _diff(plain, sup) == 0.0


def test_rollback_restores_into_the_captured_step(card, tmp_path):
    from tensordiffeq_tpu_torch.resilience import Chaos, ResilientFit
    from tensordiffeq_tpu_torch.training import graphs
    s = _ac_solver("cuda", n_f=1024, minimax=None)
    before = len(graphs.captures)
    with Chaos(nan_epoch=20, nan_repeats=2) as c:
        rf = ResilientFit(s, str(tmp_path / "ck"), checkpoint_every=10,
                          max_retries=3,
                          remedies=("lambda_reset", "lr_backoff"))
        rf.fit(tf_iter=40, chunk=10)
    assert c.fired["nan"] == 2 and rf.recoveries == 2
    assert len(s.losses) == 40
    assert all(np.isfinite(r["Total Loss"]) for r in s.losses)
    # the rollbacks and lambda_reset kept the step; lr_backoff made one
    # new capture
    adam = [c for c in graphs.captures[before:] if c["name"] == "Adam step"]
    assert len(adam) == 2 and s._adam.graph.captures == 1


# --------------------------------------------------------------------------- #
# causal and NTK weighting under dist; the surrogate factory
# --------------------------------------------------------------------------- #
def test_dist_world_1_nccl_causal_and_ntk_are_the_non_dist_solver(card,
                                                                 tmp_path):
    """The options whose statistic spans the ranks (the causal bins'
    all-reduce inside the captured step, NTK's summed traces between
    chunks) at world 1 over NCCL: 20 steps bit for bit the non-dist
    solver, one capture, K1/K2 per step (causal) or K3 per step (NTK)."""
    got = _nccl_run(tmp_path, '''
import hashlib
from tensordiffeq_tpu_torch import grad
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor


def solver(dist, **kw):
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 64)
    domain.add("t", [0.0, 1.0], 21)
    domain.generate_collocation_points(4096, seed=0)
    bcs = [tdqt.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                   var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [lambda u, x, t: (
               u(x, t), grad(u, "x")(x, t))])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 1e-4 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    s = tdqt.CollocationSolverND(verbose=False)
    s.compile([2, 32, 32, 1], f_model, domain, bcs, fused="cuda", dist=dist,
              **kw)
    cuda_taylor.reset_launch_counts()
    s.fit(tf_iter=20, chunk=10)
    h = hashlib.sha256()
    for t in s.net.params():
        h.update(t.detach().cpu().numpy().tobytes())
    return dict(hist=[r["Total Loss"] for r in s.losses],
                params=h.hexdigest(), captures=s._adam.graph.captures,
                launches=[cuda_taylor.k1_forward.launches,
                          cuda_taylor.k2_backward.launches,
                          cuda_minimax.k3_minimax.launches])


for tag, kw in (("causal", dict(causal_eps=1e-2)),
                ("ntk", dict(Adaptive_type=3, ntk_max_points=64))):
    RESULT[tag] = [solver(True, **kw), solver(False, **kw)]
''')
    for tag, launches in (("causal", [20, 20, 0]), ("ntk", [0, 0, 20])):
        dist, plain = got[tag]
        assert dist["hist"] == plain["hist"], tag
        assert dist["params"] == plain["params"], tag
        assert dist["captures"] == 1 and dist["launches"] == launches, tag


def _fac_problem(n_f=1024):
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 64)
    domain.add("t", [0.0, 1.0], 21)
    domain.generate_collocation_points(n_f, seed=0)
    grad = tdqt.grad
    bcs = [tdqt.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                   var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [lambda u, x, t: (
               u(x, t), grad(u, "x")(x, t))])]

    def f_model(u, x, t, th):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - th * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [False, False]},
              init_weights={"residual": [np.ones((n_f, 1))],
                            "BCs": [None, None]})
    return domain, bcs, f_model, kw


def _factory(thetas, **extra):
    from tensordiffeq_tpu_torch.factory import SurrogateFactory
    domain, bcs, f_model, kw = _fac_problem()
    return SurrogateFactory([2, 32, 32, 1], f_model, domain, bcs,
                            thetas=thetas, fused="cuda", verbose=False,
                            **dict(kw, **extra))


def _bits(tensors):
    return [t.detach().cpu().numpy().tobytes() for t in tensors]


def test_one_member_family_is_its_solo_solver_on_card(card):
    fac = _factory([1e-4])
    cuda_minimax.k3_minimax.launches = 0
    fac.fit(tf_iter=40, chunk=20)
    assert cuda_minimax.k3_minimax.launches == 40
    domain, bcs, f_model, kw = _fac_problem()
    solo = tdqt.CollocationSolverND(verbose=False, seed=0)
    th = float(np.float32(1e-4))
    solo.compile([2, 32, 32, 1], lambda u, x, t: f_model(u, x, t, th),
                 domain, bcs, fused="cuda", **kw)
    solo.fit(tf_iter=40, chunk=20)
    assert fac._template.engine == solo.engine == "fused-minimax-cuda"
    assert [float(r["Total Loss"][0]) for r in fac.losses] == \
        [r["Total Loss"] for r in solo.losses]
    assert _bits(fac._template.net.params()) == _bits(solo.net.params())
    assert fac._template._adam.graph.captures == 1


def test_family_step_launches_k3_per_member_and_equals_eager(card):
    """The family step launches K3 over the member axis once per step (the
    AC sweep is one tape group) and no member's own K3."""
    thetas = [1e-4 * (0.5 + m / 7) for m in range(8)]
    fac = _factory(thetas)
    cuda_taylor.reset_launch_counts()
    fac.fit(tf_iter=20, chunk=10)
    assert (cuda_taylor.k1_forward.launches, cuda_taylor.k2_backward.launches,
            cuda_minimax.k3_minimax.launches,
            cuda_minimax.k3_minimax_family.launches) == (0, 0, 0, 20)
    assert fac._family_res.family.k3_routes == {None: "wgmma"}
    assert fac._step.graph.captures == 1
    eager = _factory(thetas)
    eager.fit(tf_iter=20, chunk=10, _graphs=False)
    assert _bits(fac.params) == _bits(eager.params)
    assert [r["Total Loss"].tolist() for r in fac.losses] == \
        [r["Total Loss"].tolist() for r in eager.losses]


# K3 over the member axis: the factory's shape (2-64-64-1, N_f = 2,048,
# 8 members), AC-SA full (2-128x4-1, N_f = 50,000, 2 members) and a
# 256-wide factory (2-256-256-1, N_f = 2,048, 2 members: the f32 and TF32
# flavors' NP = 256 design; the bf16 flavor takes the mma.sync route there)
FAMILY_K3_CASES = {"factory": ([2, 64, 64, 1], 2048, 8),
                   "ac-full": ([2, 128, 128, 128, 128, 1], 50_000, 2),
                   "wide-256": ([2, 256, 256, 1], 2048, 2)}
FAMILY_K3_FLAVORS = {"f32": {}, "tf32": dict(precision="default"),
                     "bf16": dict(compute_dtype="bfloat16")}


def _family_k3_setup(card, case, flavor, seed=0):
    """Each member's K3 function (AC with θ_m), the member-axis unit over
    them, and seeded stacked X [M, N, 2], w [M, N, 1] and 2-D layers."""
    from tensordiffeq_tpu_torch.ops.minimax import build_family_sq_fn
    widths, N, M = FAMILY_K3_CASES[case]
    shapes = list(zip(widths[:-1], widths[1:]))
    sqs = []
    for m in range(M):
        th = float(np.float32(1e-4 * (0.5 + m / max(M - 1, 1))))

        def f(u, x, t, _th=th):
            g = tdqt.grad
            uv = u(x, t)
            return (g(u, "t")(x, t) - _th * g(g(u, "x"), "x")(x, t)
                    + 5.0 * uv ** 3 - 5.0 * uv)
        sqs.append(build_minimax_sq_fn(f, ("x", "t"), 1, AC, shapes,
                                       **FAMILY_K3_FLAVORS[flavor]))
    fam = build_family_sq_fn(sqs, device=card)
    g = torch.Generator().manual_seed(seed)
    nets = [_net(widths, "cpu", seed + m)[0] for m in range(M)]
    flat = [torch.stack([(a if a.ndim == 2 else a.reshape(1, -1))
                         for a in leaves]).to(card)
            for leaves in zip(*[[a for pair in net for a in pair]
                                for net in nets])]
    X = torch.stack([2 * torch.rand(M, N, generator=g) - 1,
                     torch.rand(M, N, generator=g)], 2).to(card)
    w = torch.rand(M, N, 1, generator=g).to(card)
    return sqs, fam, X, w, flat


def _family_launch(fam, X, w, flat):
    launch = cuda_minimax.FAMILY_FLAVORS[fam.flavor]
    M = X.shape[0]
    packed = torch.cat([t.reshape(M, -1) for t in flat], 1)
    out = launch(fam.members[0].plan, X, w, packed,
                 fam.constants[0].to(X.device))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("flavor", list(FAMILY_K3_FLAVORS))
@pytest.mark.parametrize("case", list(FAMILY_K3_CASES))
def test_family_k3_is_each_members_single_launch_on_card(card, case, flavor):
    """One launch over the member axis: each member's value, dW/db, gw and
    gX bit for bit its own single launch of the same flavor, bit for bit
    run to run; members 0 and M-1 within the flavor's band of the plain
    flavor (the f32 one at TOL, the bf16 one at the bf16 bands; the TF32
    flavor's referee is its single launch, held to the emulation in phase
    16 and by its own tests)."""
    sqs, fam, X, w, flat = _family_k3_setup(card, case, flavor)
    assert fam.groups == [list(range(len(sqs)))]
    if case == "wide-256" and flavor == "bf16":
        # no member-axis launch off the wgmma route: each member's K3 on
        # the mma.sync kernels
        plan = sqs[0].plan
        assert plan.wb_route(card, fam.flavor, X.shape[1], "k3") is None
        assert plan.k3_routes[fam.flavor] == "mma"
        with pytest.raises(cuda_taylor.KernelLaunchError):
            _family_launch(fam, X, w, flat)
        return
    single = cuda_minimax.FLAVORS[fam.flavor]
    key = cuda_minimax.FAMILY_FLAVORS[fam.flavor]
    before = key.launches, single.launches
    got = _family_launch(fam, X, w, flat)
    assert (key.launches, single.launches) == (before[0] + 1, before[1])
    again = _family_launch(fam, X, w, flat)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    M = X.shape[0]
    for m, sq in enumerate(sqs):
        fl = [t[m] for t in flat]
        want = single(sq.plan, X[m].contiguous(), w[m].contiguous(),
                      sq.plan.pack(fl))
        for a, b in zip((got[0][m], got[1][m], got[2][m], got[3][m]), want):
            assert torch.equal(a, b), m
    if flavor == "tf32":
        return
    for m in (0, M - 1):
        fl = [t[m] for t in flat]
        p_val, p_flat, p_gw, p_gX = sqs[m].plain(fl, w[m], X[m])
        leaves = [got[0][m].reshape(1)] + [
            t.reshape(-1) for t in sqs[m].plan.unpack(got[1][m])] + [
            got[2][m], got[3][m]]
        want = [p_val.reshape(1)] + [t.reshape(-1) for t in p_flat] + [
            p_gw, p_gX]
        for i, (a, b) in enumerate(zip(leaves, want)):
            assert bool(torch.isfinite(a).all()), (m, i)
            band = (TOL if flavor == "f32" else
                    BF16_VALUES if i in (0, len(want) - 2) else BF16_GRADS)
            assert _scaled(a.reshape(-1), b.reshape(-1)) <= band, (m, i)


def test_family_k3_nan_member_leaves_the_others_bit_for_bit_on_card(card):
    """A member whose weights are all NaN: the other members' outputs of
    the member-axis launch are bit for bit those of the clean family."""
    sqs, fam, X, w, flat = _family_k3_setup(card, "factory", "f32")
    clean = _family_launch(fam, X, w, flat)
    poisoned = [t.clone() for t in flat]
    for t in poisoned:
        t[3].fill_(float("nan"))
    got = _family_launch(fam, X, w, poisoned)
    keep = [m for m in range(X.shape[0]) if m != 3]
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])
    assert not bool(torch.isfinite(got[0][3]))


def test_family_unit_through_autograd_and_tape_groups_on_card(card):
    """The member-axis unit through autograd scales each member's saved
    cotangents by its entry of the incoming [M]; a member whose θ equals a
    constant of its residual (5.0) takes a launch of its own group, and
    every member's outputs still equal its single launch bit for bit."""
    from tensordiffeq_tpu_torch.ops.minimax import build_family_sq_fn
    sqs, _, X, w, flat = _family_k3_setup(card, "factory", "f32")

    def f5(u, x, t):
        g = tdqt.grad
        uv = u(x, t)
        return (g(u, "t")(x, t) - 5.0 * g(g(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)
    sqs[2] = build_minimax_sq_fn(f5, ("x", "t"), 1, AC,
                                 sqs[0].plan.layer_shapes)
    fam = build_family_sq_fn(sqs, device=card)
    M = X.shape[0]
    assert fam.groups == [[m for m in range(M) if m != 2], [2]]
    cuda_minimax.k3_minimax_family.launches = 0
    val, gflat, gw, gX = fam.value_and_grads(flat, w, X)
    torch.cuda.synchronize()
    assert cuda_minimax.k3_minimax_family.launches == 2
    for m, sq in enumerate(sqs):
        fl = [t[m] for t in flat]
        v, dfl, gwm, gXm = cuda_minimax.k3_minimax(
            sq.plan, X[m].contiguous(), w[m].contiguous(), sq.plan.pack(fl))
        assert torch.equal(val[m], v) and torch.equal(gw[m], gwm)
        assert torch.equal(gX[m], gXm)
        for a, b in zip(gflat, sq.plan.unpack(dfl)):
            assert torch.equal(a[m].reshape(-1), b.reshape(-1))
    leaves = [t.clone().requires_grad_(True) for t in flat]
    scale = torch.arange(1, M + 1, dtype=torch.float32, device=card)
    v = fam(list(zip(leaves[0::2], leaves[1::2])), w, X)
    grads = torch.autograd.grad(torch.sum(scale * v), leaves)
    for a, b in zip(grads, gflat):
        assert torch.equal(a, b * scale.reshape((-1,) + (1,) * (b.ndim - 1)))


def test_family_members_k3_match_plain_flavor_on_card(card):
    """Each member's K3, through its own lowered tape, against the plain
    flavor on the member's live rows, parameters and w = λ² after a few
    family steps."""
    thetas = [1e-4 * (0.5 + m / 3) for m in range(4)]
    fac = _factory(thetas)
    fac.fit(tf_iter=10, chunk=10)
    for m in range(len(thetas)):
        sq = fac._member_sq[m]
        X = fac.X_f[m].contiguous()
        lam = fac.lambdas["residual"][0][m].detach()
        w = (lam * lam).reshape(-1, 1)
        fl = [p[m].detach() if p.ndim == 3 else p[m].detach().reshape(1, -1)
              for p in fac.params]
        got = cuda_minimax.k3_minimax(sq.plan, X, w, sq.plan.pack(fl))
        want = sq.plain(fl, w, X)
        _close([got[0].reshape(1)] + sq.plan.unpack(got[1])
               + [got[2], got[3]],
               [want[0].reshape(1)] + list(want[1]) + [want[2], want[3]])


def test_family_nan_member_leaves_the_others_bit_for_bit_on_card(card):
    thetas = [1e-4 * (0.5 + m / 3) for m in range(4)]
    a, b = _factory(thetas), _factory(thetas)
    with torch.no_grad():
        for p in b.params:
            p[2].fill_(float("nan"))
    for f in (a, b):
        f.fit(tf_iter=20, chunk=10)
    assert b.frozen_at == {2: 0} and b.alive.tolist() == [True, True,
                                                           False, True]
    keep = [0, 1, 3]
    for p, q in zip(a.params, b.params):
        assert torch.equal(p[keep], q[keep])
    ha = np.stack([r["Total Loss"] for r in a.losses])
    hb = np.stack([r["Total Loss"] for r in b.losses])
    assert np.array_equal(ha[:, keep], hb[:, keep])


def test_family_checkpoint_resumes_bit_for_bit_on_card(card, tmp_path):
    thetas = [1e-4 * (0.5 + m / 3) for m in range(4)]
    a = _factory(thetas)
    a.fit(tf_iter=20, chunk=10)
    a.save_checkpoint(str(tmp_path / "ck"))
    b = _factory(thetas)
    b.restore_checkpoint(str(tmp_path / "ck"))
    assert _bits(a.params) == _bits(b.params)
    for f in (a, b):
        f.fit(tf_iter=10, chunk=10)
    assert _bits(a.params) == _bits(b.params)
    assert b._step.graph.captures == 1


# --------------------------------------------------------------------------- #
# the serving fleet: the tape rung, swaps beside live traffic, evict-reload
# --------------------------------------------------------------------------- #
def _fleet_artifacts(served, tmp_path):
    """Two fleet artifacts of the served solver's problem: its weights, and
    the same net 5 steps further."""
    from tensordiffeq_tpu_torch import fleet
    arts = {}
    for name in ("a", "b"):
        if name == "b":
            served.fit(tf_iter=5)
        arts[name] = str(tmp_path / name)
        fleet.export_fleet_artifact(served.export_surrogate(), arts[name],
                                    min_bucket=64, max_bucket=1024)
    return arts


def _fleet_policy():
    from tensordiffeq_tpu_torch.fleet import TenantPolicy
    return TenantPolicy(min_bucket=64, max_bucket=1024, max_batch=1024,
                        max_latency_s=0.005)


def test_fleet_tape_rung_is_captured_launches_k1_per_replay_equals_eager(
        served, tmp_path):
    """A surrogate loaded with no f_model serves its residual from the
    artifact's lowered tape: each residual rung is a captured graph that
    launches K1 (f32) once per replay and nothing else, equals its program
    run eagerly at the padded shape bit for bit, and sits within the
    cross-check band of the generic program (f_model attached)."""
    from tensordiffeq_tpu_torch import fleet
    from tensordiffeq_tpu_torch.ops.fused import crosscheck_residuals
    from tensordiffeq_tpu_torch.serving import Surrogate
    from tensordiffeq_tpu_torch.utils import ieee_f32
    art = str(tmp_path / "tape")
    fleet.export_fleet_artifact(served.export_surrogate(), art,
                                min_bucket=64, max_bucket=1024)
    eng = Surrogate.load(art).engine(min_bucket=64, max_bucket=1024)
    warm = fleet.warm_start(eng)
    assert warm["aot"] == 5 and warm["jit"] == 5 and not warm["failed"]
    gen = Surrogate.load(art, f_model=served.f_model).engine(
        min_bucket=64, max_bucket=1024)
    for n in (1, 64, 100, 700, 1024):
        X = _serve_points(n, seed=n)
        b = eng.bucket_for(n)
        cuda_taylor.reset_launch_counts()
        got = eng.residual(X)
        counts = {fn.__name__: fn.launches for fn in cuda_taylor.COUNTED}
        assert counts == dict({k: 0 for k in counts}, k1_forward=1), n
        Xp = torch.zeros(b, 2, device=card_device())
        Xp[:n] = torch.from_numpy(X)
        with ieee_f32(), torch.no_grad():
            want = eng._programs[("residual", b)]()(eng.surrogate.params, Xp)
        assert np.array_equal(got, want[:n].cpu().numpy()), n
        ok, why = crosscheck_residuals(gen.residual(X), got)
        assert ok, (n, why)
    assert all(r.graph.captures == 1 and r.graph.graph is not None
               for r in eng._rungs.values())
    assert len(eng._rungs) == 10


def card_device():
    return torch.device("cuda", torch.cuda.current_device())


def test_fleet_hot_swap_beside_a_querying_thread_on_card(served, tmp_path):
    """Two hot swaps while another thread queries the same tenant: the
    candidates capture beside the live engine (the engines' device lock
    serialises captures and replays), no query fails, no waiter is left,
    every answer is one of the two artifacts' own bit for bit, and the
    swapped-out engines dropped their graphs."""
    import threading
    from tensordiffeq_tpu_torch import fleet
    from tensordiffeq_tpu_torch.serving import Surrogate
    arts = _fleet_artifacts(served, tmp_path)
    f = served.f_model
    router = fleet.FleetRouter(max_loaded=2)
    router.register("t", arts["a"], f_model=f, policy=_fleet_policy())
    router.load("t")
    X = _serve_points(500, seed=1)
    want = set()
    for a in arts.values():
        eng = Surrogate.load(a, f_model=f).engine(min_bucket=64,
                                                  max_bucket=1024)
        want |= {np.asarray(eng.u(X)).tobytes(),
                 np.asarray(eng.residual(X)).tobytes()}
    stop, errs, seen = threading.Event(), [], []

    def hammer():
        i = 0
        try:
            while not stop.is_set():
                kind = ("u", "residual")[i % 2]
                seen.append(np.asarray(router.query("t", X,
                                                    kind=kind)).tobytes())
                i += 1
        except Exception as e:  # surfaced below
            errs.append(e)

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    olds = []
    try:
        for a in (arts["b"], arts["a"]):
            olds.append(router._loaded["t"])
            v = router.hot_swap("t", a, f_model=f,
                                probe_X=_serve_points(64, seed=2),
                                gate=float("inf"))
            assert v["swapped"], v
    finally:
        stop.set()
        th.join(timeout=120.0)
    assert not th.is_alive() and not errs, errs
    assert seen and set(seen) <= want
    assert router.pending_points() == 0
    assert all(o.engine._released and not o.engine._rungs for o in olds)


def test_fleet_evict_reload_captures_again_three_times(served, tmp_path):
    """A tenant cycled through eviction and reload three times on the card:
    each reload captures every live rung again in a pool of its own, the
    quarantined rung stays quarantined, the evicted engine dropped its
    graphs, and the answers stay bit for bit."""
    from tensordiffeq_tpu_torch import fleet
    from tensordiffeq_tpu_torch.resilience import Chaos
    arts = _fleet_artifacts(served, tmp_path)
    router = fleet.FleetRouter(max_loaded=1)
    for t in ("a", "b"):
        router.register(t, arts[t], f_model=served.f_model,
                        policy=_fleet_policy())
    with Chaos(compile_fail_buckets=(128,)):
        lt = router.load("a")
    dead = {"u": [128], "residual": [128]}
    assert lt.engine.quarantined_buckets() == dead
    X = _serve_points(100, seed=5)  # routes past the dead 128 rung
    first = (router.query("a", X), router.query("a", X, kind="residual"))
    for _ in range(3):
        old = lt
        router.load("b")  # evicts "a"
        assert old.engine._released and not old.engine._rungs
        lt = router.load("a")
        assert lt is not old and lt.engine.quarantined_buckets() == dead
        assert len(lt.engine._rungs) == 8 and all(
            r.graph.captures == 1 and r.graph.graph is not None
            for r in lt.engine._rungs.values())
        again = (router.query("a", X), router.query("a", X, kind="residual"))
        assert all(np.array_equal(x, y) for x, y in zip(first, again))


# ------------------------------------------------------------------ #
# static analysis: what a captured graph holds
# ------------------------------------------------------------------ #
def test_audit_of_the_minimax_steps_graph(card):
    """The minimax Adam step's graph holds K3 once, no copy across the
    host boundary and no host node; its chunk syncs once."""
    from tensordiffeq_tpu_torch.analysis import dispatch_audit as da
    solver = _ac_solver("cuda", n_f=1024, minimax=None)
    solver.fit(tf_iter=20, chunk=20)
    assert solver._adam.graph.captures == 1
    assert da.chunk_syncs(solver._adam, 20) == 1
    rep = da.audit_graph(solver._adam.graph)
    assert rep.launches == rep.captured == {"k3": 1}
    assert rep.kernel_nodes("k3") == 1
    assert rep.kernel_nodes("k1") == rep.kernel_nodes("k2") == 0
    assert set(rep.memcpy) <= {"DtoD"} and rep.host == 0
    assert rep.ok and rep.nodes > rep.kinds.get("MEMCPY", 0)
    # the audited graph is dropped: the next fit captures it anew
    assert solver._adam.graph.graph is None
    solver.fit(tf_iter=5, chunk=5)
    assert solver._adam.graph.captures == 2
    assert np.isfinite(solver.losses[-1]["Total Loss"])


def test_audit_flags_a_planted_device_to_host_copy(card):
    from tensordiffeq_tpu_torch.analysis import dispatch_audit as da
    from tensordiffeq_tpu_torch.training.graphs import StepGraph
    a = torch.ones(256, device=card)
    b = torch.empty_like(a)
    pinned = torch.empty(256, pin_memory=True)

    def planted():
        b.copy_(a * 3.0)
        pinned.copy_(b, non_blocking=True)

    graph = StepGraph(planted, lambda: [a, b, pinned], card, "planted")
    graph.prime()
    rep = da.audit_graph(graph)
    assert rep.memcpy.get("DtoH") == 1 and not rep.ok
    assert graph.graph is None
    graph()  # the step runs again after its audit
    torch.cuda.synchronize()
    assert torch.equal(pinned, torch.full((256,), 3.0))
