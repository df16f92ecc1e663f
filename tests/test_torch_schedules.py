"""Learning-rate schedules on the device (``training/schedules.py``,
``training/fit.py::adam``) against optax and the JAX package.

* each schedule's values against optax's for counts 0-1000, to float32
  rounding: at most 4 ulp of the schedule's initial value (the two sides
  evaluate ``pow`` and ``cos`` with different libraries);
* ``compile(lr=exponential_decay)`` for 20 + 10 Adam steps of the heat
  problem of ``tests/test_solver.py:298-310``, and ``lr_weights=
  cosine_decay_schedule`` on the SA λ, against the JAX solver with optax's
  schedules from the same parameters: the loss history, parameters and λ
  within rtol 5e-3 (the band of ``tests/test_torch_chunk.py``), the count
  30 after both legs (``tests/test_solver.py:368-405``);
* a float rate keeps the float path; the count survives a checkpoint, and
  a resumed run equals the uninterrupted one bit for bit;
* ``DiscoveryModel.compile(lr=, lr_vars=, lr_weights=)`` with schedules
  against the JAX model with optax's, rtol 5e-3, and its surrogate serves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.training import fit as tfit
from tensordiffeq_tpu_torch.training import schedules as S
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_chunk import _assert_same_run
from test_torch_discovery import heat_data, make_f

torch.set_num_threads(1)
RTOL = 5e-3
ULP = 2.0 ** -23

CASES = {
    "exp": (lambda m: m.exponential_decay(5e-3, 100, 0.5)),
    "exp-staircase": (lambda m: m.exponential_decay(
        5e-3, 100, 0.5, transition_begin=50, staircase=True,
        end_value=1e-3)),
    "exp-growth": (lambda m: m.exponential_decay(1e-3, 37, 1.3,
                                                  end_value=2e-3)),
    "cosine": (lambda m: m.cosine_decay_schedule(5e-3, 200)),
    "cosine-alpha": (lambda m: m.cosine_decay_schedule(
        5e-3, 300, alpha=0.1, exponent=2.0)),
    "constant": (lambda m: m.constant_schedule(3e-3)),
}
INIT = {"exp": 5e-3, "exp-staircase": 5e-3, "exp-growth": 2e-3,
        "cosine": 5e-3, "cosine-alpha": 5e-3, "constant": 3e-3}


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_values_match_optax(name):
    j, t = CASES[name](optax), CASES[name](S)
    counts = np.arange(1001)
    want = np.array([np.float32(j(jnp.asarray(c, jnp.int32)))
                     for c in counts])
    got = np.array([t(torch.tensor(c, dtype=torch.int32)).item()
                    for c in counts], np.float32)
    assert t(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ULP * INIT[name])


def heat(pkg):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    dom.add("x", [-1.0, 1.0], 32)
    dom.add("t", [0.0, 1.0], 8)
    dom.generate_collocation_points(256, seed=0)
    init = pkg.IC(dom, [lambda x: np.sin(np.pi * x)], var=[["x"]])
    grad = pkg.grad

    def f_model(u, x, t):
        return grad(u, "t")(x, t) - 0.1 * grad(grad(u, "x"), "x")(x, t)

    return dom, init, f_model


def heat_pair(sa: bool, lr: str = "exp", lr_weights: str = "cosine",
              layers=(2, 16, 1)):
    out = []
    for pkg, mod in ((tdq, optax), (tdqt, S)):
        dom, init, f = heat(pkg)
        kw = dict(lr=CASES[lr](mod))
        if sa:
            rng = np.random.RandomState(0)
            kw.update(Adaptive_type=1,
                      dict_adaptive={"residual": [True], "BCs": [False]},
                      init_weights={"residual": [rng.rand(256, 1)],
                                    "BCs": [None]},
                      lr_weights=CASES[lr_weights](mod))
        s = (pkg.CollocationSolverND(verbose=False) if pkg is tdq else
             pkg.CollocationSolverND(verbose=False, device="cpu"))
        s.compile(list(layers), f, dom, [init], **kw)
        out.append(s)
    js, ts = out
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    return js, ts


def _jax_counts(opt_state):
    return [int(leaf) for leaf in jax.tree_util.tree_leaves(opt_state)
            if getattr(leaf, "ndim", None) == 0
            and np.issubdtype(np.asarray(leaf).dtype, np.integer)]


@pytest.mark.parametrize("sa", [False, True], ids=["lr", "lr+lr_weights"])
def test_solver_schedules_match_jax(sa):
    js, ts = heat_pair(sa)
    assert ts.engine == "fused-minimax"
    for n in (20, 10):
        js.fit(tf_iter=n, chunk=5)
        ts.fit(tf_iter=n, chunk=5)
    assert len(ts.losses) == len(js.losses) == 30
    _assert_same_run(js, ts)
    # the schedules continued across the warm fit: count 30 on both sides
    assert max(_jax_counts(js.opt_state)) == 30
    for opt in ts._opt:
        if opt is None:
            continue
        (sched,) = opt.tdq_schedules.values()
        assert int(tfit.step_count(opt, opt.param_groups[0])) == 30
        assert opt.param_groups[0]["lr"] is sched.lr
    # the device's rate is the schedule at the last update's count
    want = float(optax.exponential_decay(5e-3, 100, 0.5)(29))
    assert float(ts._opt[0].param_groups[0]["lr"]) == pytest.approx(
        want, rel=1e-6)


def test_float_rates_keep_the_float_path():
    p = [torch.zeros(3, requires_grad=True)]
    lam = {"residual": [torch.ones(3, 1, requires_grad=True)], "BCs": []}
    opt_net, opt_lam = tfit.make_optimizer(p, lam, 0.005, 0.005)
    for opt in (opt_net, opt_lam):
        assert isinstance(opt.param_groups[0]["lr"], float)
        assert opt.tdq_schedules == {}
    opt_net, opt_lam = tfit.make_optimizer(p, lam, S.constant_schedule(1e-3),
                                           freeze_lambdas=True)
    assert opt_lam is None
    assert isinstance(opt_net.param_groups[0]["lr"], torch.Tensor)
    # a user callable that returns a number is a constant schedule
    opt = tfit.adam([(p, lambda count: 2e-3)], torch.device("cpu"))
    tfit.optimizer_step(opt)
    assert float(opt.param_groups[0]["lr"]) == pytest.approx(2e-3)


def test_schedule_count_survives_a_checkpoint(tmp_path):
    _, ref = heat_pair(True)
    ref.fit(tf_iter=20, chunk=5)
    _, a = heat_pair(True)
    a.fit(tf_iter=12, chunk=6)
    a.save_checkpoint(str(tmp_path / "ck"))
    _, b = heat_pair(True)
    b.restore_checkpoint(str(tmp_path / "ck"))
    for opt in b._opt:
        (sched,) = opt.tdq_schedules.values()
        assert int(tfit.step_count(opt, opt.param_groups[0])) == 12
        assert opt.param_groups[0]["lr"] is sched.lr
    b.fit(tf_iter=8, chunk=4)
    np.testing.assert_array_equal(
        [r["Total Loss"] for r in b.losses],
        [r["Total Loss"] for r in ref.losses])
    for (Wr, br), (Wb, bb) in zip(ref.net.layers(), b.net.layers()):
        assert torch.equal(Wr, Wb) and torch.equal(br, bb)


def disc_pair(**rates):
    x, t, u = heat_data(200)
    cw = np.random.RandomState(1).rand(200, 1)
    out = []
    for pkg, mod in ((tdq, optax), (tdqt, S)):
        kw = dict(var=[0.1, 0.5], col_weights=cw, varnames=["x", "t"],
                  verbose=False, lr_vars=[0.01, 0.02])
        for name, spec in rates.items():
            kw[name] = ([CASES[s](mod) if s in CASES else s for s in spec]
                        if isinstance(spec, list) else CASES[spec](mod))
        m = tdq.DiscoveryModel() if pkg is tdq else \
            tdqt.DiscoveryModel(device="cpu")
        m.compile([2, 16, 16, 1], make_f(pkg), [x, t], u, **kw)
        out.append(m)
    jm, tm = out
    tm.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.trainables["params"]),
        device="cpu"))
    return jm, tm


@pytest.mark.parametrize("rates", [
    dict(lr="exp"), dict(lr_vars=["cosine", 0.02]),
    dict(lr_vars="exp-growth"), dict(lr_weights="cosine-alpha")],
    ids=["lr", "lr_vars-per-coefficient", "lr_vars-shared", "lr_weights"])
def test_discovery_schedules_match_jax(rates):
    jm, tm = disc_pair(**rates)
    jm.fit(tf_iter=30, chunk=10)
    tm.fit(tf_iter=30, chunk=10)
    np.testing.assert_allclose(tm.losses, jm.losses, rtol=RTOL)
    np.testing.assert_allclose(tm.var_history, jm.var_history, rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(tm.col_weights, jm.col_weights, rtol=RTOL,
                               atol=1e-5)


def test_scheduled_discovery_exports_and_resumes(tmp_path):
    _, ref = disc_pair(lr="exp", lr_vars=["cosine", "exp"])
    ref.fit(tf_iter=20, chunk=10)
    _, a = disc_pair(lr="exp", lr_vars=["cosine", "exp"])
    a.fit(tf_iter=10, chunk=10)
    a.save_checkpoint(str(tmp_path / "ck"))
    _, b = disc_pair(lr="exp", lr_vars=["cosine", "exp"])
    b.restore_checkpoint(str(tmp_path / "ck"))
    b.fit(tf_iter=10, chunk=10)
    np.testing.assert_array_equal(b.losses, ref.losses)
    sur = b.export_surrogate()
    sur.save(str(tmp_path / "art"))
    back = tdqt.serving.Surrogate.load(str(tmp_path / "art"),
                                       f_model=make_f(tdqt), device="cpu")
    X = np.random.RandomState(2).uniform(0, 1, (32, 2)).astype(np.float32)
    np.testing.assert_allclose(back.engine().u(X), b.predict(X), rtol=1e-6,
                               atol=1e-6)
