"""NTK weighting (``ops/ntk.py``, ``compile(Adaptive_type=3)``,
``fit_adam(lambda_update_fn=)``) against the JAX package's
(``tests/test_ntk.py``).

* ``trace_K`` equals the trace of the explicit kernel (rtol 1e-5), and the
  weight formula on terms with known traces (rtol 1e-6);
* on the Allen-Cahn problem of ``tests/test_ntk.py:58-77`` (IC, periodic
  u and u_x, 256 points, 2-8-8-1) from the same parameters: each term's
  trace and the weights, unbounded, at the default ``max_ratio`` and at a
  cap half the unbounded range, against the JAX ``make_ntk_weight_fn``
  at rtol 1e-4 (the Jacobians' float32 sums run in another order);
  λ_i·tr_i equal across terms (unbounded), and the cap's contract
  (range bounded, uncapped terms exact, order kept);
* the data term under ``assimilate``: weighted, balanced and scaling the
  ``Data`` component, against JAX at rtol 1e-4;
* ``fit(tf_iter=30, chunk=10)`` against the JAX solver: the minimax step
  adopted on both sides, the losses within rtol 5e-3 (the band of
  ``tests/test_torch_chunk.py``), the weights recomputed before step 0 and
  at each boundary with steps left (3 updates) and equal to the JAX
  solver's final weights at rtol 5e-3; one capture of the Adam step across
  the updates (a stand-in graph on the CPU); under resampling the update
  reads the live collocation set's subsample;
* explicit ``dict_adaptive``/``init_weights`` are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.ops import ntk as jntk
from tensordiffeq_tpu_torch.ops import ntk
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_causal import _stand_in_adam

torch.set_num_threads(1)
RTOL = 5e-3
RTOL_NTK = 1e-4


def sc(a):
    return float(np.asarray(a.detach() if isinstance(a, torch.Tensor)
                            else a).reshape(()))


def test_trace_identity_matches_explicit_kernel():
    W = torch.tensor([[0.3, -1.2], [0.7, 0.4]])
    b = torch.tensor([0.1, -0.5])
    pts = torch.linspace(-1, 1, 7).reshape(-1, 1)

    def e_fn(layers):
        (W_, b_), = layers
        return torch.tanh(pts @ W_[0:1] + b_).reshape(-1)

    tr = float(ntk.trace_K(e_fn, [(W, b)]))
    J = torch.func.jacrev(lambda W_, b_: e_fn([(W_, b_)]),
                          argnums=(0, 1))(W, b)
    Jf = torch.cat([j.reshape(14, -1) for j in J], 1)
    np.testing.assert_allclose(tr, float(torch.trace(Jf @ Jf.T)), rtol=1e-5)


def test_weight_formula():
    w = torch.tensor([2.0])
    c1, c2 = torch.tensor([1.0, 2.0]), torch.tensor([3.0])
    fn = ntk.make_ntk_weight_fn(
        [lambda L: L[0][0] * c1], lambda L: (L[0][0] * c2).reshape(1, -1),
        n_residuals=1)
    lam = fn([(w, torch.zeros(1))])
    np.testing.assert_allclose(sc(lam["BCs"][0]), 14.0 / 5.0, rtol=1e-6)
    np.testing.assert_allclose(sc(lam["residual"][0]), 14.0 / 9.0,
                               rtol=1e-6)


def make_ac(pkg, n_f=256, **kw):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    dom.add("x", [-1.0, 1.0], 32)
    dom.add("t", [0.0, 1.0], 8)
    dom.generate_collocation_points(n_f, seed=0)
    grad = pkg.grad

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [pkg.IC(dom, [lambda x: x ** 2 * np.cos(np.pi * x)], var=[["x"]]),
           pkg.periodicBC(dom, ["x"], [deriv_model])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    s = (pkg.CollocationSolverND(verbose=False) if pkg is tdq else
         pkg.CollocationSolverND(verbose=False, device="cpu"))
    s.compile([2, 8, 8, 1], f_model, dom, bcs, Adaptive_type=3, **kw)
    return s


def pair(**kw):
    js, ts = make_ac(tdq, **kw), make_ac(tdqt, **kw)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    return js, ts


def _weights(lam):
    return [sc(v) for v in lam["BCs"] + lam["residual"]
            + lam.get("data", [])]


def test_traces_match_jax():
    js, ts = pair()
    jb, jr, _ = jntk.build_error_fns(js.apply_fn, js.domain.vars, 1,
                                     js.f_model, js.bcs, js.X_f,
                                     n_residuals=1)
    tb, tr, _ = ntk.build_error_fns(ts.apply_fn, ts.domain.vars, 1,
                                    ts.f_model, ts.bcs, ts.X_f,
                                    n_residuals=1)
    for jf, tf in zip(jb + [jr], tb + [tr]):
        np.testing.assert_allclose(float(ntk.trace_K(tf, ts.net.layers())),
                                   float(jntk.trace_K(jf, js.params)),
                                   rtol=RTOL_NTK)


@pytest.mark.parametrize("ratio", [None, 100.0, "half"])
def test_ntk_weights_match_jax(ratio):
    if ratio == "half":
        js, _ = pair(ntk_max_ratio=None)
        v = _weights(js._ntk_fn(js.params))
        assert max(v) / min(v) > 4  # the cap is tripped by construction
        ratio = max(v) / min(v) / 2
    js, ts = pair(ntk_max_ratio=ratio)
    want = _weights(js._ntk_fn(js.params))
    got = _weights(ts._ntk_fn(ts.net.layers()))
    np.testing.assert_allclose(got, want, rtol=RTOL_NTK)
    assert len(got) == 3  # the periodic BC is weighted too


def test_ntk_weights_balance_traces():
    _, ts = pair(ntk_max_ratio=None)
    bc_fns, res_all_fn, _ = ntk.build_error_fns(
        ts.apply_fn, ts.domain.vars, 1, ts.f_model, ts.bcs, ts.X_f,
        n_residuals=1)
    layers = ts.net.layers()
    traces = [float(ntk.trace_K(f, layers)) for f in bc_fns + [res_all_fn]]
    lams = _weights(ts._ntk_fn(layers))
    np.testing.assert_allclose([a * b for a, b in zip(lams, traces)],
                               sum(traces), rtol=1e-4)


def test_ntk_max_ratio_bounds_dynamic_range():
    _, s_unb = pair(ntk_max_ratio=None)
    vals_u = _weights(s_unb._ntk_fn(s_unb.net.layers()))
    cap = max(vals_u) / min(vals_u) / 2
    _, s_cap = pair(ntk_max_ratio=cap)
    vals_c = _weights(s_cap._ntk_fn(s_cap.net.layers()))
    assert max(vals_c) / min(vals_c) <= cap * (1 + 1e-6)
    m = min(vals_c)
    unc = [(u, c) for u, c in zip(vals_u, vals_c) if c < cap * m * (1 - 1e-6)]
    assert unc
    for u, c in unc:
        np.testing.assert_allclose(c, u, rtol=1e-6)
    assert np.argsort([u for u, _ in unc]).tolist() == \
        np.argsort([c for _, c in unc]).tolist()


def _heat_data(pkg):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    dom.add("x", [-1.0, 1.0], 16)
    dom.add("t", [0.0, 1.0], 8)
    dom.generate_collocation_points(128, seed=0)
    bcs = [pkg.IC(dom, [lambda x: np.sin(np.pi * x)], var=[["x"]])]
    grad = pkg.grad

    def f_model(u, x, t):
        return grad(u, "t")(x, t) - 0.1 * grad(grad(u, "x"), "x")(x, t)

    s = (pkg.CollocationSolverND(assimilate=True, verbose=False)
         if pkg is tdq else pkg.CollocationSolverND(
             assimilate=True, verbose=False, device="cpu"))
    s.compile([2, 8, 1], f_model, dom, bcs, Adaptive_type=3)
    rng = np.random.RandomState(0)
    xd, td = rng.uniform(-1, 1, 32), rng.uniform(0, 1, 32)
    s.compile_data(xd, td, np.sin(np.pi * xd) * np.exp(-td))
    return s


def test_ntk_data_term_matches_jax():
    js, ts = _heat_data(tdq), _heat_data(tdqt)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    assert "data" in ts.lambdas and len(ts.lambdas["data"]) == 1
    lam_j = js._ntk_fn(js.params)
    lam_t = ts._ntk_fn(ts.net.layers())
    np.testing.assert_allclose(_weights(lam_t), _weights(lam_j),
                               rtol=RTOL_NTK)
    with torch.no_grad():
        for key, vals in lam_t.items():
            for lam, v in zip(ts.lambdas[key], vals):
                lam.copy_(v)
    _, comps1 = ts.update_loss()
    with torch.no_grad():
        ts.lambdas["data"][0].mul_(2.0)
    _, comps2 = ts.update_loss()
    np.testing.assert_allclose(2.0 * float(comps1["Data"]),
                               float(comps2["Data"]), rtol=1e-6)
    ts.fit(tf_iter=20, newton_iter=5, chunk=10)
    assert np.isfinite(ts.min_loss["overall"])
    assert sc(ts.lambdas["data"][0]) != 2.0 * _weights(lam_t)[-1]


def test_ntk_fit_matches_jax():
    js, ts = pair()
    assert ts.engine == "fused-minimax" and js._minimax_loss is not None
    assert _weights(ts.lambdas) == [1.0, 1.0, 1.0]
    step = _stand_in_adam(ts)
    assert ts._opt[1] is None  # λ are frozen in the step
    js.fit(tf_iter=30, newton_iter=0, chunk=10)
    ts.fit(tf_iter=30, newton_iter=0, chunk=10)
    np.testing.assert_allclose([r["Total Loss"] for r in ts.losses],
                               [float(r["Total Loss"]) for r in js.losses],
                               rtol=RTOL)
    assert len(ts.ntk_updates) == 3
    np.testing.assert_allclose(_weights(ts.lambdas), _weights(js.lambdas),
                               rtol=RTOL)
    assert _weights(ts.lambdas) != [1.0, 1.0, 1.0]
    # the λ were written in place: one capture across the updates
    assert ts._adam is step and step.graph.captures == 1
    assert all(u["device_ms"] is None and u["host_s"] > 0
               for u in ts.ntk_updates)


def test_ntk_update_follows_a_redraw(monkeypatch):
    _, ts = pair()
    seen = []
    real = ts._ntk_fn

    def spy(layers, X_sub=None):
        seen.append(None if X_sub is None else X_sub.clone())
        return real(layers, X_sub)

    ts._ntk_fn = spy
    ts.fit(tf_iter=30, chunk=10, resample_every=10)
    assert len(seen) == 3 and all(x is not None for x in seen)
    # the last update read the set that trained the last chunk
    assert torch.equal(seen[-1], ntk.residual_subsample(ts.X_f, 256))
    assert not torch.equal(seen[0], seen[-1])


def test_ntk_rejects_explicit_weights():
    with pytest.raises(ValueError, match="tangent kernel"):
        make_ac(tdqt, dict_adaptive={"residual": [True], "BCs": [False,
                                                                 False]},
                init_weights={"residual": [np.ones((256, 1))],
                              "BCs": [None, None]})


def test_subsample_strides():
    X = torch.arange(1000.0).reshape(-1, 1)
    sub = ntk.residual_subsample(X, 256)
    want = np.asarray(jnp.linspace(0, 999, 256).astype(jnp.int32))
    np.testing.assert_array_equal(sub[:, 0].numpy().astype(int), want)
    assert ntk.residual_subsample(X[:100], 256).shape == (100, 1)
