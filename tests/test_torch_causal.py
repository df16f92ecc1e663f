"""Causal weighting (``ops/losses.py::causal_residual_loss``,
``build_loss_fn(causal_eps=...)``, ``compile(causal_eps=, causal_bins=,
causal_delta=)`` with its ε ladder) and ``remat`` against the JAX package.

* ``causal_residual_loss`` on the hand-computed cases of
  ``tests/test_losses.py:59-100``: loss and ``w_last`` against the JAX
  function's at rtol 1e-6, and the gradient with respect to the squared
  errors (no gradient through the weights) at rtol 1e-6 (``w_last`` also
  within the smallest normal float32: XLA flushes subnormals to zero); two
  calls are bit for bit equal (the bin sums use no atomics);
* the assembled causal loss with per-point SA λ, with a type-2 λ and ``g``,
  on the same parameters as the JAX ``build_loss_fn``: every component at
  rtol 1e-5 (both sides run the generic engine in float32);
* the solver on the heat problem of ``tests/test_solver.py:298-440``: a
  fixed ε with SA λ, and the ladder ``[1e-4, 5]``: the epoch at which each
  ε opens equals the JAX solver's, the loss history within rtol 5e-3 (the
  band of ``tests/test_torch_chunk.py``; a component that falls far below
  its first value also within 1e-3 of its largest), checkpoint/resume
  through the
  ladder as in the JAX solver; the resample hook gets run-relative epochs
  across the stages; the ladder keeps one capture of the Adam step (a
  stand-in graph on the CPU);
* the minimax step declines causal weighting and ``remat`` with the JAX
  reasons; ``remat`` gives the same loss and gradients as the plain loss on
  the generic and the fused engine (``tests/test_solver.py:475-510``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.models.assembly import build_loss_fn as jax_build
from tensordiffeq_tpu.ops.losses import causal_residual_loss as jax_causal
from tensordiffeq_tpu_torch.models.assembly import build_loss_fn
from tensordiffeq_tpu_torch.ops.losses import causal_residual_loss, default_g
from tensordiffeq_tpu_torch.training import fit as tfit
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_chunk import StandInGraph

torch.set_num_threads(1)
RTOL = 5e-3

rng0 = np.random.RandomState(0)
LOSS_CASES = {
    "hand": ([1.0, 1.0, 4.0, 4.0], [0.1, 0.2, 0.7, 0.8], 0.5, 2),
    "eps0": (rng0.rand(64), rng0.rand(64), 0.0, 8),
    "early-bad": ([100.0, 100.0, 1.0, 1.0], [0.05, 0.1, 0.9, 0.95], 1.0, 2),
    "empty-bins": ([1.0, 1.0], [0.01, 0.99], 1.0, 8),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_causal_residual_loss_matches_jax(case):
    sq, t, eps, bins = (np.asarray(v, np.float32) if isinstance(
        v, (list, np.ndarray)) else v for v in LOSS_CASES[case])
    j_loss, j_w = jax_causal(jnp.asarray(sq), jnp.asarray(t), (0.0, 1.0),
                             eps, bins)
    j_grad = jax.grad(lambda s: jax_causal(s, jnp.asarray(t), (0.0, 1.0),
                                           eps, bins)[0])(jnp.asarray(sq))
    sq_t = torch.tensor(sq, requires_grad=True)
    loss, w = causal_residual_loss(sq_t, torch.tensor(t), (0.0, 1.0),
                                   torch.tensor(eps), bins)
    (grad,) = torch.autograd.grad(loss, sq_t)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    # XLA flushes float32 subnormals to zero; PyTorch keeps them
    np.testing.assert_allclose(float(w), float(j_w), rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-6,
                               atol=1e-12)
    again = causal_residual_loss(sq_t, torch.tensor(t), (0.0, 1.0), eps,
                                 bins)
    assert torch.equal(again[0], loss) and torch.equal(again[1], w)
    if case == "hand":
        assert float(loss) == pytest.approx((1 + np.exp(-0.5) * 4) / 2,
                                            rel=1e-6)


def heat(pkg, n_f=256):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    dom.add("x", [-1.0, 1.0], 32)
    dom.add("t", [0.0, 1.0], 8)
    dom.generate_collocation_points(n_f, seed=0)
    init = pkg.IC(dom, [lambda x: np.sin(np.pi * x)], var=[["x"]])
    grad = pkg.grad

    def f_model(u, x, t):
        return grad(u, "t")(x, t) - 0.1 * grad(grad(u, "x"), "x")(x, t)

    return dom, init, f_model


def _sa(kind, n_f=256):
    rng = np.random.RandomState(0)
    if kind == "sa1":
        return dict(Adaptive_type=1,
                    dict_adaptive={"residual": [True], "BCs": [False]},
                    init_weights={"residual": [rng.rand(n_f, 1)],
                                  "BCs": [None]})
    if kind == "sa2-g":
        return dict(Adaptive_type=2,
                    dict_adaptive={"residual": [True], "BCs": [False]},
                    init_weights={"residual": [np.full((1, 1), 0.7)],
                                  "BCs": [None]})
    return {}


def pair(layers=(2, 16, 16, 1), sa=None, **kw):
    out = []
    for pkg in (tdq, tdqt):
        dom, init, f = heat(pkg)
        extra = dict(_sa(sa), **kw)
        if sa == "sa2-g":
            extra["g"] = (tdq.ops.losses.default_g if pkg is tdq
                          else default_g)
        s = (pkg.CollocationSolverND(verbose=False) if pkg is tdq else
             pkg.CollocationSolverND(verbose=False, device="cpu"))
        s.compile(list(layers), f, dom, [init], **extra)
        out.append(s)
    js, ts = out
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    return js, ts


@pytest.mark.parametrize("sa", ["sa1", "sa2-g", None])
def test_causal_build_loss_fn_matches_jax(sa):
    js, ts = pair(sa=sa, causal_eps=1.0, causal_bins=8)
    jt, jc = js.loss_fn(js.params, js.lambdas["BCs"],
                        js.lambdas["residual"], js.X_f)
    tt, tc = ts.loss_fn(ts.net.layers(), ts.lambdas["BCs"],
                        ts.lambdas["residual"], ts.X_f)
    assert set(tc) == set(jc) and "Causal_w_last_0" in tc
    for k in jc:
        np.testing.assert_allclose(float(tc[k]), float(jc[k]), rtol=1e-5,
                                   err_msg=k)
    # the same function, built directly
    dom, init, f = heat(tdqt)
    direct = build_loss_fn(ts.apply_fn, dom.vars, 1, f, [init],
                           weight_outside_sum=ts.weight_outside_sum,
                           g=ts.g, causal_eps=1.0, causal_bins=8,
                           time_index=1, time_bounds=(0.0, 1.0),
                           device="cpu")
    dt, _ = direct(ts.net.layers(), ts.lambdas["BCs"],
                   ts.lambdas["residual"], ts.X_f)
    assert torch.equal(dt, tt)
    jax_direct = jax_build(js.apply_fn, dom.vars, 1, heat(tdq)[2],
                           [heat(tdq)[1]],
                           weight_outside_sum=js.weight_outside_sum,
                           g=js.g, causal_eps=1.0, causal_bins=8,
                           time_index=1, time_bounds=(0.0, 1.0))
    np.testing.assert_allclose(
        float(jax_direct(js.params, js.lambdas["BCs"],
                         js.lambdas["residual"], js.X_f)[0]),
        float(tt), rtol=1e-5)


def test_causal_solver_with_sa_matches_jax():
    js, ts = pair(sa="sa1", causal_eps=1.0, causal_bins=8)
    assert ts.engine == "fused" and js._minimax_loss is None
    js.fit(tf_iter=20, chunk=5)
    ts.fit(tf_iter=20, chunk=5)
    for k in ("Total Loss", "Residual_0", "Causal_w_last_0"):
        want = np.array([float(r[k]) for r in js.losses])
        np.testing.assert_allclose([r[k] for r in ts.losses], want,
                                   rtol=RTOL, atol=1e-3 * np.abs(want).max(),
                                   err_msg=k)
    w = ts.losses[-1]["Causal_w_last_0"]
    assert 0.0 < w <= 1.0
    dom = tdqt.DomainND(["x", "y"])
    dom.add("x", [0.0, 1.0], 8)
    dom.add("y", [0.0, 1.0], 8)
    dom.generate_collocation_points(64, seed=0)
    with pytest.raises(ValueError, match="time_var"):
        tdqt.CollocationSolverND(verbose=False, device="cpu").compile(
            [2, 8, 1], heat(tdqt)[2], dom, [], causal_eps=1.0)


def _spy_eps(monkeypatch, cls, log):
    real = cls._set_causal_eps

    def spy(self, eps):
        log.append((len(self.losses), float(eps)))
        return real(self, eps)

    monkeypatch.setattr(cls, "_set_causal_eps", spy)


def _stand_in_adam(ts):
    """The solver's Adam step on a stand-in graph object (the CPU capture
    and replay of ``tests/test_torch_chunk.py``), so its captures count."""
    params = [p for pair_ in ts.net.layers() for p in pair_]
    ts._opt = tfit.make_optimizer(params, ts.lambdas, ts.lr, ts.lr_weights,
                                  freeze_lambdas=ts.use_ntk)
    box = {}
    ts._adam = box["s"] = tfit.AdamStep(
        ts.loss_fn, params, ts.lambdas, ts.X_f, ts._opt, verbose=False,
        make_graph=lambda stream: StandInGraph(box["s"]._keyed))
    return ts._adam


def test_causal_ladder_matches_jax(monkeypatch):
    jlog, tlog = [], []
    _spy_eps(monkeypatch, tdq.CollocationSolverND, jlog)
    _spy_eps(monkeypatch, tdqt.CollocationSolverND, tlog)
    js, ts = pair(causal_eps=[5.0, 1e-4], causal_bins=8, causal_delta=0.9)
    assert ts.causal_ladder == [1e-4, 5.0] and ts.causal_eps == 1e-4
    step = _stand_in_adam(ts)
    js.fit(tf_iter=20, chunk=5)
    ts.fit(tf_iter=20, chunk=5)
    # the ε of each stage opens at the same epoch on both sides
    assert tlog == jlog and tlog and tlog[-1][1] == 5.0
    assert ts.causal_eps == js.causal_eps == 5.0
    assert float(ts._causal_kw["causal_eps"]) == 5.0
    assert len(ts.losses) == 20
    for k in ("Total Loss", "Causal_w_last_0"):
        np.testing.assert_allclose([r[k] for r in ts.losses],
                                   [float(r[k]) for r in js.losses],
                                   rtol=RTOL, err_msg=k)
    assert ts.best_epoch["adam"] == js.best_epoch["adam"]
    # one step and one capture served both stages
    assert ts._adam is step and step.graph.captures == 1


def test_causal_ladder_rebases_resample_epochs(monkeypatch):
    """Across the ladder's stages the resample hook is handed run-relative
    epochs, as the JAX solver re-bases them: one draw at every chunk
    boundary but the last, at epochs 5, 10, 15 whichever boundary the gate
    opens at."""
    _, ts = pair(causal_eps=[5.0, 1e-4], causal_bins=8, causal_delta=0.9)
    seen = []

    def hook(self, *args):
        def resample(layers, epoch):
            seen.append(epoch)
            return self.X_f.clone()
        return resample

    monkeypatch.setattr(tdqt.CollocationSolverND, "_resample_hook", hook)
    opened = []
    _spy_eps(monkeypatch, tdqt.CollocationSolverND, opened)
    ts.fit(tf_iter=20, chunk=5, resample_every=5, resample_device=False)
    assert ts.causal_eps == 5.0 and len(ts.losses) == 20
    # the second stage opened early enough to draw on its own count
    assert opened[-1][0] < 15
    assert seen == [5, 10, 15]
    assert [r["epoch"] for r in ts.redraws] == [5, 10, 15]


def test_causal_ladder_checkpoint_resume_matches_jax(tmp_path):
    runs = []
    for side in (0, 1):
        js, ts = pair(causal_eps=[1e-4, 5.0], causal_bins=8,
                      causal_delta=0.9)
        s = (js, ts)[side]
        ck = str(tmp_path / f"ck{side}")
        s.fit(tf_iter=20, chunk=5, checkpoint_dir=ck, checkpoint_every=5)
        assert s.causal_eps == 5.0 and len(s.losses) == 20
        r = pair(causal_eps=[1e-4, 5.0], causal_bins=8,
                 causal_delta=0.9)[side]
        r.restore_checkpoint(ck)
        assert r.best_model["overall"] is not None and len(r.losses) == 20
        # the ladder restarts at the smallest ε and fast-forwards
        r.fit(tf_iter=10, chunk=5)
        assert r.causal_eps == 5.0 and len(r.losses) == 30
        runs.append(r)
    jr, tr = runs
    np.testing.assert_allclose([x["Total Loss"] for x in tr.losses],
                               [float(x["Total Loss"]) for x in jr.losses],
                               rtol=RTOL)


def test_minimax_declines_causal_and_remat_with_the_jax_reasons():
    for kw in (dict(causal_eps=1.0), dict(remat=True)):
        js, ts = pair(**kw)
        assert ts._minimax_loss is None and js._minimax_loss is None
        assert str(ts._minimax_fail_reason) == str(js._minimax_fail_reason)
        dom, init, f = heat(tdqt)
        with pytest.raises(ValueError, match="minimax=True"):
            tdqt.CollocationSolverND(verbose=False, device="cpu").compile(
                [2, 8, 1], f, dom, [init], minimax=True, **kw)


@pytest.mark.parametrize("fused", [False, None], ids=["generic", "fused"])
def test_remat_identical_loss_and_grads(fused):
    def build(remat):
        dom, init, f = heat(tdqt)
        s = tdqt.CollocationSolverND(verbose=False, device="cpu")
        s.compile([2, 12, 12, 1], f, dom, [init], remat=remat, fused=fused,
                  minimax=False, **_sa("sa1"))
        return s

    a, b = build(False), build(True)
    assert a.engine == b.engine == ("generic" if fused is False else "fused")
    b.net.load_layers(a.net.layers())

    def value_grad(s):
        params = [p for pair_ in s.net.layers() for p in pair_]
        lam = s.lambdas["residual"][0]
        total = s.loss_fn(s.net.layers(), s.lambdas["BCs"],
                          s.lambdas["residual"], s.X_f)[0]
        return total, torch.autograd.grad(total, params + [lam])

    (la, ga), (lb, gb) = value_grad(a), value_grad(b)
    assert torch.equal(la, lb)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)
    b.fit(tf_iter=30)
    assert b.losses[-1]["Total Loss"] < b.losses[0]["Total Loss"]
