"""The embedding network families (``networks.py``: ``FourierMLP``,
``PeriodicMLP``, ``fourier_net``, ``periodic_net``, their metadata) against
the JAX package's.

* each family on the same parameters (and, for ``FourierMLP``, the JAX
  package's own frequency matrix ``B``, carried by
  ``weights.fourier_net_from_jax``): ``u`` and the ``grad`` derivatives
  u_x, u_t, u_xx through the generic engine within 1e-6 scale-relative
  (max |port - jax| over max |jax|, per quantity) at the JAX default
  ``sigma = 1`` (the float32 rounding of ``2π·xB`` grows with σ);
* ``PeriodicMLP`` is periodic to every order (u and three x-derivatives at
  the two x-edges, as ``tests/test_networks.py:76-95``: within 1e-5 of
  each order's scale, or 1e-5 absolute below 1);
  ``periodic_net`` reads the declaration order, not the ``add()`` order;
* ``net_metadata`` carries the JAX keys and ``net_from_metadata`` rebuilds
  both families;
* the solver trains each family on the generic engine, against the JAX
  solver with the same network from the same parameters (rtol 5e-3, the
  engines' band), and refuses the fused engines for them;
* ``save``/``load_model``, the solver's and ``DiscoveryModel``'s
  checkpoints and surrogate artifacts carry ``FourierMLP``'s ``B``; ``DiscoveryModel.compile(network=)`` trains a
  family against the JAX model (rtol 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.networks import init_params
from tensordiffeq_tpu_torch import networks
from tensordiffeq_tpu_torch.ops.derivatives import make_ufn
from tensordiffeq_tpu_torch.weights import fourier_net_from_jax, \
    params_from_jax
from test_torch_discovery import heat_data, make_f

torch.set_num_threads(1)
SIZES = [2, 16, 16, 1]
RTOL = 5e-3


def scaled_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def domain(pkg, order=("x", "t")):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    for var in order:
        dom.add(var, [-1.0, 1.0] if var == "x" else [0.0, 1.0],
                32 if var == "x" else 8)
    dom.generate_collocation_points(256, seed=0)
    return dom


def jax_B(n_in, m, sigma, seed):
    return np.asarray(sigma * jax.random.normal(
        jax.random.PRNGKey(seed), (n_in, m), dtype=jnp.float32))


def family_pair(kind):
    """(jax net, jax params, port net) with the same function."""
    if kind == "fourier":
        jnet = tdq.networks.fourier_net(SIZES, n_frequencies=8, sigma=1.0,
                                        seed=3)
        params = init_params(jnet, 2, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        tnet = fourier_net_from_jax(tree, jax_B(2, 8, 1.0, 3), SIZES,
                                    sigma=1.0, feature_seed=3, device="cpu")
        return jnet, params, tnet
    jnet = tdq.networks.periodic_net(SIZES, domain(tdq), ["x"],
                                     n_harmonics=3)
    params = init_params(jnet, 2, jax.random.PRNGKey(0))
    tnet = networks.periodic_net(SIZES, domain(tdqt), ["x"], n_harmonics=3,
                                 device="cpu")
    tnet.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return jnet, params, tnet


def _quantities(pkg, u):
    grad = pkg.grad
    return {"u": lambda x, t: u(x, t),
            "u_x": grad(u, "x"), "u_t": grad(u, "t"),
            "u_xx": grad(grad(u, "x"), "x")}


@pytest.mark.parametrize("kind", ["fourier", "periodic"])
def test_family_matches_jax_through_the_generic_engine(kind):
    jnet, params, tnet = family_pair(kind)
    X = np.random.RandomState(1).uniform(
        [-1, 0], [1, 1], (64, 2)).astype(np.float32)
    ju = tdq.ops.derivatives.make_ufn(jnet.apply, params, ["x", "t"], 1)
    tu = make_ufn(tnet.apply, tnet.layers(), ["x", "t"], 1)
    jq, tq = _quantities(tdq, ju), _quantities(tdqt, tu)
    Xt = torch.from_numpy(X)
    for name in jq:
        want = jax.vmap(lambda p: jq[name](p[0], p[1]))(jnp.asarray(X))
        got = torch.func.vmap(lambda p: tq[name](p[0], p[1]))(Xt)
        assert scaled_err(got.detach().numpy(), want) <= 1e-6, name
    # the batched forward agrees with the per-point one
    np.testing.assert_allclose(
        tnet(Xt).detach().numpy(), np.asarray(jnet.apply(params, X)),
        rtol=1e-6, atol=1e-6 * float(np.abs(jnet.apply(params, X)).max()))


def test_periodic_mlp_is_periodic_to_every_order():
    net = networks.PeriodicMLP((2, 16, 16, 1), periodic=((0, -1.0, 2.0),),
                               n_harmonics=3, device="cpu")
    u = make_ufn(net.apply, net.layers(), ["x", "t"], 1)
    ts = torch.linspace(0.0, 1.0, 5)
    f = lambda x, t: u(x, t)  # noqa: E731
    for order in range(4):
        lo = torch.func.vmap(lambda t: f(torch.tensor(-1.0), t))(ts)
        hi = torch.func.vmap(lambda t: f(torch.tensor(1.0), t))(ts)
        hi = hi.detach().numpy()
        np.testing.assert_allclose(lo.detach().numpy(), hi, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(hi).max()),
                                   err_msg=str(order))
        f = torch.func.grad(f, argnums=0)
    assert net.layers()[0][0].shape == (1 + 2 * 3, 16)


def test_periodic_net_reads_the_declaration_order():
    dom = tdqt.DomainND(["x", "t"], time_var="t")
    dom.add("t", [0.0, 1.0], 8)
    dom.add("x", [-1.0, 1.0], 32)
    net = networks.periodic_net([2, 8, 1], dom, ["x"], n_harmonics=1,
                                device="cpu")
    assert net.periodic == ((0, -1.0, 2.0),)
    with pytest.raises(ValueError, match="not in domain"):
        networks.periodic_net([2, 8, 1], dom, ["y"], device="cpu")


@pytest.mark.parametrize("kind", ["fourier", "periodic"])
def test_metadata_round_trip(kind):
    jnet, _, tnet = family_pair(kind)
    want = tdq.networks.net_metadata(jnet, SIZES, 1)
    got = networks.net_metadata(tnet, SIZES, 1)
    assert got["network_type"] == want["network_type"]
    assert got["net_config"] == want["net_config"]
    assert got["layer_sizes"] == want["layer_sizes"]
    back = networks.net_from_metadata(got, device="cpu")
    assert type(back) is type(tnet)
    assert networks.net_metadata(back, SIZES, 1) == got
    assert [W.shape for W, _ in back.layers()] == \
        [W.shape for W, _ in tnet.layers()]
    if kind == "fourier":
        # the port's own draw for the seed: not the JAX stream's, which
        # is why checkpoints and artifacts carry B
        assert back.B.shape == tnet.B.shape
        assert torch.equal(back.B, networks.fourier_net(
            SIZES, 8, 1.0, seed=3, device="cpu").B)


def heat_f(pkg):
    grad = pkg.grad

    def f_model(u, x, t):
        return grad(u, "t")(x, t) - 0.1 * grad(grad(u, "x"), "x")(x, t)

    return f_model


def solver_pair(kind):
    jnet, params, tnet = family_pair(kind)
    out = []
    for pkg, net in ((tdq, jnet), (tdqt, tnet)):
        dom = domain(pkg)
        bcs = [pkg.IC(dom, [lambda x: np.sin(np.pi * x)], var=[["x"]]),
               pkg.periodicBC(dom, ["x"], [lambda u, x, t: (u(x, t),)])]
        s = (pkg.CollocationSolverND(verbose=False) if pkg is tdq else
             pkg.CollocationSolverND(verbose=False, device="cpu"))
        s.compile(SIZES, heat_f(pkg), dom, bcs, network=net)
        out.append(s)
    js, ts = out
    js.params = params
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return js, ts


@pytest.mark.parametrize("kind", ["fourier", "periodic"])
def test_solver_trains_family_on_the_generic_engine(kind):
    js, ts = solver_pair(kind)
    assert ts.engine == "generic" and js._fused_residual is None
    js.fit(tf_iter=15, chunk=5)
    ts.fit(tf_iter=15, chunk=5)
    for k in ("Total Loss", "BC_0", "BC_1", "Residual_0"):
        np.testing.assert_allclose([r[k] for r in ts.losses],
                                   [float(r[k]) for r in js.losses],
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    if kind == "periodic":  # the periodic BC holds by construction
        assert abs(ts.losses[-1]["BC_1"]) < 1e-8
    X = np.random.RandomState(3).uniform([-1, 0], [1, 1], (32, 2))
    np.testing.assert_allclose(ts.predict(X)[0],
                               np.asarray(js.predict(X)[0]), rtol=RTOL,
                               atol=1e-5)
    dom = domain(tdqt)
    for fused in (True, "cuda"):
        with pytest.raises(ValueError, match="cannot be fused"):
            tdqt.CollocationSolverND(verbose=False, device="cpu").compile(
                SIZES, heat_f(tdqt), dom, [], fused=fused,
                network=networks.fourier_net(SIZES, 4, device="cpu"))


def test_fourier_B_rides_save_checkpoint_and_artifact(tmp_path):
    _, ts = solver_pair("fourier")
    ts.fit(tf_iter=5, chunk=5)
    X = np.random.RandomState(4).uniform([-1, 0], [1, 1], (40, 2))
    u_want = ts.predict(X)[0]
    # save -> load_model on an uncompiled solver rebuilds the net and B
    ts.save(str(tmp_path / "m.tdqm"))
    fresh = tdqt.CollocationSolverND(verbose=False, device="cpu")
    fresh.load_model(str(tmp_path / "m.tdqm"))
    assert type(fresh.net) is networks.FourierMLP
    assert torch.equal(fresh.net.B, ts.net.B)
    np.testing.assert_array_equal(fresh.predict(X)[0], u_want)
    # a checkpoint restores B into a solver whose seed drew another
    ts.save_checkpoint(str(tmp_path / "ck"))
    other = tdqt.CollocationSolverND(verbose=False, device="cpu")
    other.compile(SIZES, heat_f(tdqt), domain(tdqt), [],
                  network=networks.fourier_net(SIZES, 8, 1.0, seed=3,
                                               device="cpu"))
    assert not torch.equal(other.net.B, ts.net.B)
    other.restore_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(other.net.B, ts.net.B)
    np.testing.assert_array_equal(other.predict(X)[0], u_want)
    # a compiled solver refuses a model of another embedding
    per = tdqt.CollocationSolverND(verbose=False, device="cpu")
    per.compile(SIZES, heat_f(tdqt), domain(tdqt), [],
                network=networks.periodic_net(SIZES, domain(tdqt), ["x"],
                                              device="cpu"))
    with pytest.raises(ValueError, match="network_type"):
        per.load_model(str(tmp_path / "m.tdqm"))


@pytest.mark.parametrize("kind", ["fourier", "periodic"])
def test_family_surrogate_round_trip(kind, tmp_path):
    """A family's artifact loads with no solver and no net handed in."""
    _, ts = solver_pair(kind)
    ts.fit(tf_iter=5, chunk=5)
    ts.export_surrogate().save(str(tmp_path / "art"))
    back = tdqt.serving.Surrogate.load(str(tmp_path / "art"),
                                       f_model=heat_f(tdqt), device="cpu")
    assert type(back.net) is type(ts.net)
    X = np.random.RandomState(5).uniform([-1, 0], [1, 1], (300, 2))
    u, f = ts.predict(X)
    eng = back.engine()
    assert scaled_err(eng.u(X), u) <= 1e-6
    assert scaled_err(eng.residual(X).reshape(f.shape), f) <= 1e-5


def test_discovery_trains_a_family_network():
    x, t, u = heat_data(200)
    jnet, params, tnet = family_pair("periodic")
    kw = dict(var=[0.1, 0.5], varnames=["x", "t"], verbose=False,
              lr_vars=[0.01, 0.02])
    jm = tdq.DiscoveryModel()
    jm.compile(SIZES, make_f(tdq), [x, t], u, network=jnet, **kw)
    jm.trainables["params"] = params
    tm = tdqt.DiscoveryModel(device="cpu")
    tm.compile(SIZES, make_f(tdqt), [x, t], u, network=tnet, **kw)
    assert tm.engine == "generic"
    jm.fit(tf_iter=20, chunk=10)
    tm.fit(tf_iter=20, chunk=10)
    np.testing.assert_allclose(tm.losses, jm.losses, rtol=RTOL)
    np.testing.assert_allclose(tm.var_history, jm.var_history, rtol=RTOL,
                               atol=1e-4)


def test_discovery_checkpoint_carries_fourier_B(tmp_path):
    """A ``DiscoveryModel`` checkpoint restores a ``FourierMLP``'s ``B`` into
    a model whose seed drew another: ``predict`` is the saved model's."""
    x, t, u = heat_data(64)
    kw = dict(var=[0.1, 0.5], varnames=["x", "t"], verbose=False,
              lr_vars=[0.01, 0.02])

    def model(seed):
        m = tdqt.DiscoveryModel(device="cpu")
        m.compile(SIZES, make_f(tdqt), [x, t], u, **kw,
                  network=networks.fourier_net(SIZES, 8, 1.0, seed=seed,
                                               device="cpu"))
        return m

    a = model(0)
    a.fit(tf_iter=5, chunk=5)
    a.save_checkpoint(str(tmp_path / "ck"))
    X = np.random.RandomState(6).uniform([-1, 0], [1, 1], (40, 2))
    b = model(3)
    assert not torch.equal(b.net.B, a.net.B)
    b.restore_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(b.net.B, a.net.B)
    np.testing.assert_array_equal(b.predict(X), a.predict(X))
