"""The slice as a whole on the CPU: the PyTorch port's ``CollocationSolverND``
trained through ``compile(fused="cuda", minimax=False)`` (whose kernel
producer takes the plain flavor for CPU tensors) against the JAX solver
through ``compile(fused=True, minimax=False)`` — the XLA flavor that
``tests/test_pallas.py`` pins equal to the Pallas kernel — on the
Allen-Cahn SA micro problem, from shared parameters and λ.  20 Adam epochs:
the per-epoch ``Total Loss`` and ``predict`` agree within rtol 5e-3 (the
engines' cross-check band).  Also the device rule and the typed errors for
what is not ported."""

import jax
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.ops import cuda_taylor
from tensordiffeq_tpu_torch.utils import CudaUnavailableError
from tensordiffeq_tpu_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)
N_F, LAYERS, GRID, EPOCHS = 256, [2, 32, 32, 1], (64, 21), 20
RTOL = 5e-3


def ac_problem(pkg, seed=0):
    nx, nt = GRID
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(N_F, seed=seed)
    grad = pkg.grad

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [pkg.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)], var=[["x"]]),
           pkg.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        u_xx = grad(grad(u, "x"), "x")
        uv = u(x, t)
        return grad(u, "t")(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv

    rng = np.random.RandomState(seed)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(N_F, 1)],
                            "BCs": [100.0 * rng.rand(nx, 1), None]})
    return domain, bcs, f_model, kw


@pytest.fixture(scope="module")
def solvers():
    d, b, f, kw = ac_problem(tdq)
    js = tdq.CollocationSolverND(verbose=False)
    js.compile(LAYERS, f, d, b, fused=True, minimax=False, **kw)
    d2, b2, f2, kw2 = ac_problem(tdqt)
    cuda_taylor.reset_launch_counts()
    ts = tdqt.CollocationSolverND(verbose=False, device="cpu")
    ts.compile(LAYERS, f2, d2, b2, fused="cuda", minimax=False, **kw2)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    lam0 = [lam.detach().clone() for lam in (ts.lambdas["residual"][0],
                                             ts.lambdas["BCs"][0])]
    js.fit(tf_iter=EPOCHS)
    ts.fit(tf_iter=EPOCHS)
    Xq = np.random.RandomState(1).rand(300, 2) * [2.0, 1.0] - [1.0, 0.0]
    return js, ts, lam0, Xq


def test_trajectory_matches_jax(solvers):
    js, ts, _, _ = solvers
    assert ts.engine == "fused-cuda"
    jl = np.array([r["Total Loss"] for r in js.losses])
    tl = np.array([r["Total Loss"] for r in ts.losses])
    assert len(tl) == len(jl) == EPOCHS
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for k in ("BC_0", "BC_1", "Residual_0"):
        np.testing.assert_allclose([r[k] for r in ts.losses],
                                   [r[k] for r in js.losses], rtol=RTOL,
                                   err_msg=k)
    assert tl[-1] < tl[0]
    # the CPU solver never launched a kernel
    assert cuda_taylor.k1_forward.launches == 0
    assert cuda_taylor.k2_backward.launches == 0


def test_predict_and_lambdas_match_jax(solvers):
    js, ts, lam0, Xq = solvers
    uj, fj = js.predict(Xq)
    ut, ft = ts.predict(Xq)
    assert ut.shape == uj.shape == (300, 1) and ft.shape == fj.shape
    for got, want in ((ut, uj), (ft, fj)):
        assert np.max(np.abs(got - want)) <= RTOL * np.max(np.abs(want))
    # SA ascent moved both λ, as the JAX solver's did
    lam_t = ts.lambdas["residual"][0].detach()
    assert float((lam_t - lam0[0]).abs().max()) > 0
    assert float((ts.lambdas["BCs"][0].detach() - lam0[1]).abs().max()) > 0
    np.testing.assert_allclose(lam_t.numpy(),
                               np.asarray(js.lambdas["residual"][0]),
                               rtol=RTOL, atol=1e-4)
    # params round-trip to the flax layout
    tree = params_to_numpy(ts.net)
    assert tree["params"]["Dense_0"]["kernel"].shape == (2, 32)


def test_best_model_is_a_true_copy(solvers):
    _, ts, _, Xq = solvers
    best = ts.best_model["overall"]
    assert best is not None and 0 <= ts.best_epoch["overall"] < EPOCHS
    assert all(b.data_ptr() != p.data_ptr() for (b, _), (p, _) in
               zip(best, ts.net.layers()))
    u_best, _ = ts.predict(Xq, best_model=True)
    assert np.all(np.isfinite(u_best))


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        tdqt.CollocationSolverND()
    with pytest.raises(CudaUnavailableError):
        params_from_jax({"params": {"Dense_0": {"kernel": np.ones((2, 1)),
                                                "bias": np.ones(1)}}})
    with pytest.raises(CudaUnavailableError):
        tdqt.neural_net([2, 4, 1])


def test_unported_options_raise_typed_errors():
    d, b, f, _ = ac_problem(tdqt)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    # fused="autotune", causal_eps, remat, Adaptive_type=3, fused_dtype and
    # dist are ported: tests/test_torch_autotune.py, test_torch_causal.py,
    # test_torch_ntk.py, test_torch_mixed_precision.py,
    # test_torch_parallel.py; under dist causal weighting too
    # (test_torch_dist_options.py)
    for kw in (dict(dist=True, causal_eps=1.0),):
        s_dist = tdqt.CollocationSolverND(verbose=False, device="cpu")
        s_dist.compile([2, 8, 1], f, d, b, **kw)
        assert s_dist.mesh.size == 1 and s_dist._causal_kw
    with pytest.raises(ValueError, match="cuda"):
        s.compile([2, 8, 1], f, d, b, fused="pallas")
    with pytest.raises(tdqt.NotCompiledError):
        s.fit(tf_iter=1)
    s.compile([2, 8, 1], f, d, b, fused=True, minimax=False)
    assert s.engine == "fused"
    # fit's telemetry, eval_fn/eval_every and profile_dir are ported
    # (tests/test_torch_telemetry.py): a telemetry of the wrong type is the
    # JAX solver's TypeError
    with pytest.raises(TypeError, match="TrainingTelemetry or RunLogger"):
        s.fit(tf_iter=1, telemetry=object())
    with pytest.raises(TypeError, match="unexpected"):
        s.fit(tf_iter=1, newton_iters=3)
    s.fit(tf_iter=2, newton_iter=0)
    assert len(s.losses) == 2


def test_fit_ranges_show_only_under_the_profiler(solvers, monkeypatch):
    """``fit_adam`` marks the parts of a step as profiler ranges, and
    enters none while no profiler records."""
    from torch.profiler import ProfilerActivity, profile
    _, ts, _, _ = solvers
    names = ("fit_adam.loss", "loss.residual", "fit_adam.backward",
             "fit_adam.adam", "fit_adam.record")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts.fit(tf_iter=2)
    seen = [e.name for e in prof.events() if e.name in names]
    assert sorted(set(seen)) == sorted(names)
    assert all(seen.count(n) == 2 for n in names)
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    ts.fit(tf_iter=1)
    assert entered == []
