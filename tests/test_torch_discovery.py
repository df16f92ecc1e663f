"""The port's inverse problem (``tensordiffeq_tpu_torch/models/
discovery.py::DiscoveryModel``) and its surrogate (``Surrogate.
from_discovery``, the ``"discovery"`` contract) held to the JAX package's.

* 50 epochs from the JAX model's parameters, on the generic and on the
  fused engine, with SA ``col_weights``, per-coefficient ``lr_vars`` and
  full-batch or permuted minibatches (``batch_sz``, the tail wrapping):
  the loss and coefficient histories and the final SA weights within rtol
  5e-3 (the engines' cross-check band);
* ``make_batches(permute=True)``: the JAX package's batches, row for row;
* a checkpoint taken mid-run restores into a fresh model and resumes bit
  for bit;
* ``Surrogate.from_discovery`` → ``save`` → ``load(f_model=...)`` keeps the
  learned coefficients, and the engine's residual matches the JAX
  engine's within 1e-5 scale-relative and the model's ``predict_f``;
* ``predict``/``predict_f`` against the JAX model's; options left out
  raise :class:`NotPortedError` naming their ROADMAP item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.training.fit import make_batches as jax_make_batches
from tensordiffeq_tpu_torch.serving import Surrogate
from tensordiffeq_tpu_torch.training.fit import make_batches
from tensordiffeq_tpu_torch.utils import NotPortedError
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
RTOL = 5e-3
N = 200


def heat_data(n=N, seed=0):
    """u = sin(πx)·e^(-t): u_t = c1·u_xx - c2·u at c1 = 1/π², c2 = 0."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 1))
    t = rng.uniform(0, 1, (n, 1))
    return x, t, np.sin(np.pi * x) * np.exp(-t)


def make_f(pkg):
    grad = pkg.grad

    def f_model(u, var, x, t):
        c1, c2 = var
        return (grad(u, "t")(x, t) - c1 * grad(grad(u, "x"), "x")(x, t)
                + c2 * u(x, t))

    return f_model


def _pair(fused=None, g=None, n=N, widths=(16, 16)):
    x, t, u = heat_data(n)
    cw = np.random.RandomState(1).rand(n, 1)
    kw = dict(var=[0.1, 0.5], col_weights=cw, lr_vars=[0.01, 0.02],
              varnames=["x", "t"], verbose=False, fused=fused)
    jm = tdq.DiscoveryModel()
    jm.compile([2, *widths, 1], make_f(tdq), [x, t], u,
               g=None if g is None else g[0], **kw)
    tm = tdqt.DiscoveryModel(device="cpu")
    tm.compile([2, *widths, 1], make_f(tdqt), [x, t], u,
               g=None if g is None else g[1], **kw)
    tm.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.trainables["params"]),
        device="cpu"))
    return jm, tm


@pytest.mark.parametrize("batch_sz", [None, 64], ids=["full", "batched"])
@pytest.mark.parametrize("fused", [False, None], ids=["generic", "fused"])
def test_discovery_matches_jax(fused, batch_sz):
    jm, tm = _pair(fused=fused)
    assert tm.engine == ("generic" if fused is False else "fused")
    assert (jm._fused_residual is not None) == (tm.engine == "fused")
    jm.fit(tf_iter=50, chunk=20, batch_sz=batch_sz)
    tm.fit(tf_iter=50, chunk=20, batch_sz=batch_sz)
    assert len(tm.losses) == len(tm.var_history) == 50
    np.testing.assert_allclose(tm.losses, jm.losses, rtol=RTOL)
    np.testing.assert_allclose(tm.var_history, jm.var_history, rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(tm.col_weights, jm.col_weights, rtol=RTOL,
                               atol=1e-5)
    assert not np.allclose(tm.col_weights,
                           np.random.RandomState(1).rand(N, 1))
    # both coefficients moved, each at its own rate
    assert all(abs(v - v0) > 1e-3
               for v, v0 in zip(tm.var_history[-1], (0.1, 0.5)))


def test_discovery_g_transform_matches_jax():
    jm, tm = _pair(g=(lambda lam: jnp.tanh(lam) ** 2,
                      lambda lam: torch.tanh(lam) ** 2))
    jm.fit(tf_iter=20, chunk=20)
    tm.fit(tf_iter=20, chunk=20)
    np.testing.assert_allclose(tm.losses, jm.losses, rtol=RTOL)
    np.testing.assert_allclose(tm.var_history, jm.var_history, rtol=RTOL,
                               atol=1e-4)


@pytest.mark.parametrize("n,bsz", [(200, 64), (256, 64), (10, 3)])
def test_make_batches_permute_matches_jax(n, bsz):
    X = np.random.RandomState(0).rand(n, 2).astype(np.float32)
    jX, jidx, jn = jax_make_batches(jnp.asarray(X), bsz, verbose=False,
                                    permute=True)
    tX, tidx, tn = make_batches(torch.as_tensor(X), bsz, verbose=False,
                                permute=True)
    assert tn == jn
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))


@pytest.mark.parametrize("batch_sz", [None, 64], ids=["full", "batched"])
def test_discovery_resume_is_bit_identical(tmp_path, batch_sz):
    _, a = _pair()
    a.fit(tf_iter=7, chunk=3, batch_sz=batch_sz)
    a.save_checkpoint(str(tmp_path / "ck"))
    _, b = _pair()
    b.restore_checkpoint(str(tmp_path / "ck"))
    assert b.losses == a.losses and b.var_history == a.var_history
    for m in (a, b):
        m.fit(tf_iter=5, chunk=2, batch_sz=batch_sz)
    assert a.losses == b.losses and a.var_history == b.var_history
    assert np.array_equal(a.col_weights, b.col_weights)
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)


def test_from_discovery_engine_matches_jax(tmp_path):
    jm, tm = _pair()
    jm.fit(tf_iter=10, chunk=10)
    # the port's model at the JAX model's trained state
    tm.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.trainables["params"]),
        device="cpu"))
    with torch.no_grad():
        for v, jv in zip(tm._vars, jm.vars):
            v.fill_(float(jv))
    sur = tm.export_surrogate()
    assert sur.contract == "discovery"
    sur.save(str(tmp_path / "art"))
    back = Surrogate.load(str(tmp_path / "art"), f_model=make_f(tdqt),
                          device="cpu")
    assert back.contract == "discovery"
    np.testing.assert_array_equal(np.asarray(back.coefficients).ravel(),
                                  np.asarray(jm.vars, np.float32).ravel())
    X = np.hstack(heat_data(100, seed=3)[:2]).astype(np.float32)
    got = np.asarray(back.engine(min_bucket=64, max_bucket=256).residual(X))
    want = np.asarray(tdq.serving.Surrogate.from_discovery(jm).engine(
        min_bucket=64, max_bucket=256).residual(X))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    np.testing.assert_allclose(got.reshape(-1, 1), tm.predict_f(X),
                               rtol=0, atol=1e-5 * scale)
    # the coefficients are frozen: later training does not reach them
    tm.fit(tf_iter=3, chunk=3)
    assert sur.coefficients[0] == np.float32(jm.vars[0])


def test_discovery_predict_and_predict_f_match_jax():
    jm, tm = _pair(fused=False)
    X = np.hstack(heat_data(50, seed=4)[:2])
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-5,
                               atol=1e-6)
    want = jm.predict_f(X)
    got = tm.predict_f(X)
    assert got.shape == (50, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_discovery_fused_needs_a_pointwise_residual():
    x, t, u = heat_data(64)

    def bad_f(u, var, x, t):
        return tdqt.grad(u, "t")(x, t) - var[0] * torch.mean(
            tdqt.grad(u, "x")(x, t))

    m = tdqt.DiscoveryModel(device="cpu")
    m.compile([2, 8, 1], bad_f, [x, t], u, var=[0.1], varnames=["x", "t"],
              verbose=False)
    assert m.engine == "generic"
    with pytest.raises(ValueError):
        tdqt.DiscoveryModel(device="cpu").compile(
            [2, 8, 1], bad_f, [x, t], u, var=[0.1], varnames=["x", "t"],
            verbose=False, fused=True)


@pytest.mark.parametrize("kw,err", [
    (dict(dist=True), NotPortedError),
    (dict(network=torch.nn.Linear(2, 1)), NotPortedError),
    (dict(lr_vars=[0.1, 0.1]), ValueError),
    (dict(fused="cuda"), ValueError),
    (dict(varnames=["x"]), ValueError)])
def test_discovery_options_left_out_raise(kw, err):
    x, t, u = heat_data(16)
    kw = {"varnames": ["x", "t"], **kw}
    with pytest.raises(err, match="ROADMAP" if err is NotPortedError
                       else None):
        tdqt.DiscoveryModel(device="cpu").compile(
            [2, 8, 1], make_f(tdqt), [x, t], u, var=[0.0], verbose=False,
            **kw)


def test_discovery_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(tdqt.CudaUnavailableError):
        tdqt.DiscoveryModel()
