"""The solver's network options in the port against the JAX package's, on
the CPU: the MLP's knobs, custom network modules, and the precision rule.

* ``MLP``/``neural_net`` with ``activation`` (gelu, sin), ``dtype=bfloat16``
  and each ``precision``: the forward and the generic engine's residual
  against the JAX net on the same parameters and inputs, within 1e-5
  scale-relative for float32 nets and 5e-2 for the bf16 one (bf16 keeps
  about three significant digits; its derivatives run through bf16
  products on both sides);
* the fused gate (``ops/fused.py::mlp_qualifies``) decides as JAX's does
  for every knob, the embedding families and a custom module;
* a Flax and a torch residual MLP with skip connections, the Flax tree
  carried by ``weights.params_from_jax(module=, name_map=)``: the solver's
  step-0 loss and gradients within 1e-5 and 5 Adam steps within 1e-4 of
  the JAX solver's; ``save``/``load_model(network=)`` and
  ``Surrogate.load(net=)`` round trips; ``DiscoveryModel(network=)``
  against the JAX model (5e-3, the engines' band);
* the TF32-emulating plain flavor (``ops/taylor.py``) against a float64
  product of TF32-rounded operands, forward and backward;
* on the CPU every precision computes IEEE float32: a ``precision=None``
  solver trains bit for bit as a ``"highest"`` one, and takes the kernels'
  TF32 flavor only by name;
* a checkpoint and a saved model written by the port before the network
  protocol (``tests/fixtures/torch_ckpt_slice12``, written by
  ``scripts/torch_ckpt_fixture.py`` from that code) restore bit for bit:
  parameters, loss, and the next 5 Adam epochs and 3 L-BFGS iterations.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.networks import init_params
from tensordiffeq_tpu.ops.fused import mlp_qualifies as jax_qualifies
from tensordiffeq_tpu_torch import networks
from tensordiffeq_tpu_torch.ops.derivatives import make_ufn, vmap_residual
from tensordiffeq_tpu_torch.ops.fused import mlp_qualifies
from tensordiffeq_tpu_torch.ops.taylor import (rna_tf32, taylor_derivatives,
                                               tf32_matmul)
from tensordiffeq_tpu_torch.serving import Surrogate
from tensordiffeq_tpu_torch.utils import TF32
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_checkpoint import make_solver
from test_torch_discovery import heat_data, make_f
from test_torch_networks_families import domain, heat_f

torch.set_num_threads(1)
SIZES = [2, 16, 16, 1]
F32_BAND, BF16_BAND = 1e-5, 5e-2
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_ckpt_slice12")


def scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def gelu_tanh(x):
    """GELU's tanh form, jax.nn.gelu's default."""
    return F.gelu(x, approximate="tanh")


gelu_tanh.__name__ = "gelu"
KNOBS = {  # name: (jax neural_net kwargs, port neural_net kwargs, band)
    "gelu": (dict(activation=jax.nn.gelu), dict(activation=gelu_tanh),
             F32_BAND),
    "sin": (dict(activation=jnp.sin), dict(activation=torch.sin), F32_BAND),
    "bf16": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16),
             BF16_BAND),
    "precision-default": (dict(precision=None), dict(precision=None),
                          F32_BAND),
    "precision-high": (dict(precision=jax.lax.Precision.HIGH),
                       dict(precision="high"), F32_BAND),
    "precision-highest": (dict(precision=jax.lax.Precision.HIGHEST),
                          dict(precision="Precision.HIGHEST"), F32_BAND),
}


def knob_pair(name):
    jkw, tkw, band = KNOBS[name]
    jnet = tdq.networks.neural_net(SIZES, **jkw)
    params = init_params(jnet, 2, jax.random.PRNGKey(0))
    tnet = tdqt.neural_net(SIZES, device="cpu", **tkw)
    tnet.load_layers(params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
        device="cpu"))
    return jnet, params, tnet, band


@pytest.mark.parametrize("name", list(KNOBS))
def test_knob_forward_and_residual_match_jax(name):
    jnet, params, tnet, band = knob_pair(name)
    X = np.random.RandomState(1).uniform(
        [-1, 0], [1, 1], (64, 2)).astype(np.float32)
    want_u = np.asarray(jnet.apply(params, X), np.float32)
    got_u = tnet.apply(tnet.params(), torch.from_numpy(X)).detach()
    assert got_u.dtype == torch.float32
    assert scaled_err(got_u.numpy(), want_u) <= band
    ju = tdq.ops.derivatives.make_ufn(jnet.apply, params, ["x", "t"], 1)
    want_f = tdq.ops.derivatives.vmap_residual(heat_f(tdq), ju, 2)(
        jnp.asarray(X))
    tu = make_ufn(tnet.apply, tnet.params(), ["x", "t"], 1)
    got_f = vmap_residual(heat_f(tdqt), tu, 2)(torch.from_numpy(X))
    assert scaled_err(got_f.detach().float().numpy(),
                      np.asarray(want_f, np.float32)) <= band
    meta = networks.net_metadata(tnet, SIZES, 1)
    assert meta["activation"] == tdq.networks.net_metadata(
        jnet, SIZES, 1)["activation"]


class JaxResMLP(fnn.Module):
    """A residual MLP with skip connections: h <- h + tanh(Dense(h))."""
    width: int = 16
    n_blocks: int = 2

    @fnn.compact
    def __call__(self, x):
        hi = jax.lax.Precision.HIGHEST
        h = jnp.tanh(fnn.Dense(self.width, precision=hi, name="inp")(x))
        for i in range(self.n_blocks):
            h = h + jnp.tanh(fnn.Dense(self.width, precision=hi,
                                       name=f"blk{i}")(h))
        return fnn.Dense(1, precision=hi, name="out")(h)


class TorchResMLP(torch.nn.Module):
    """The same residual MLP on ``nn.Linear`` layers."""

    def __init__(self, width: int = 16, n_blocks: int = 2, seed: int = 0):
        super().__init__()
        torch.manual_seed(seed)
        self.inp = torch.nn.Linear(2, width)
        self.blocks = torch.nn.ModuleList(torch.nn.Linear(width, width)
                                          for _ in range(n_blocks))
        self.out = torch.nn.Linear(width, 1)

    def forward(self, x):
        h = torch.tanh(self.inp(x))
        for blk in self.blocks:
            h = h + torch.tanh(blk(h))
        return self.out(h)


# {flax path: torch name}; ".T": an nn.Linear weight is the kernel's
# transpose
RES_MAP = {"inp/kernel": "inp.weight.T", "inp/bias": "inp.bias",
           "blk0/kernel": "blocks.0.weight.T", "blk0/bias": "blocks.0.bias",
           "blk1/kernel": "blocks.1.weight.T", "blk1/bias": "blocks.1.bias",
           "out/kernel": "out.weight.T", "out/bias": "out.bias"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def fused_cases():
    """(name, JAX net, JAX params, port net) for the gate's decisions."""
    out = []
    for name in KNOBS:
        jnet, params, tnet, _ = knob_pair(name)
        out.append((name, jnet, params, tnet))
    jnet = tdq.networks.MLP(layer_sizes=tuple(SIZES),
                            param_dtype=jnp.bfloat16)
    tnet = networks.MLP(SIZES, device="cpu", param_dtype=torch.bfloat16)
    out.append(("param-bf16", jnet, init_params(jnet, 2,
                                                jax.random.PRNGKey(0)), tnet))
    jnet = tdq.networks.neural_net(SIZES)
    out.append(("tanh", jnet, init_params(jnet, 2, jax.random.PRNGKey(0)),
                tdqt.neural_net(SIZES, device="cpu")))
    jnet = tdq.networks.fourier_net(SIZES, n_frequencies=4)
    out.append(("fourier", jnet, init_params(jnet, 2, jax.random.PRNGKey(0)),
                networks.fourier_net(SIZES, 4, device="cpu")))
    jnet = JaxResMLP()
    out.append(("custom", jnet, init_params(jnet, 2, jax.random.PRNGKey(0)),
                networks.ModuleNet(TorchResMLP())))
    return out


def test_fused_gate_decides_as_jax():
    decided = {}
    for name, jnet, params, tnet in fused_cases():
        want = jax_qualifies(jnet, params) is not None
        assert (mlp_qualifies(tnet) is not None) == want, name
        decided[name] = want
    # the float32 tanh MLP qualifies at every precision, nothing else does
    assert decided == {"gelu": False, "sin": False, "bf16": False,
                       "precision-default": True, "precision-high": True,
                       "precision-highest": True, "param-bf16": False,
                       "tanh": True, "fourier": False, "custom": False}


def res_pair(adaptive=False):
    """The JAX and port solvers on the heat problem with the residual MLP,
    on one set of parameters."""
    jnet = JaxResMLP()
    params = init_params(jnet, 2, jax.random.PRNGKey(0))
    out = []
    for pkg, net in ((tdq, jnet), (tdqt, TorchResMLP())):
        dom = domain(pkg)
        # an IC off the odd sin, so that no gradient sits at float32's
        # noise floor (Adam's first step normalises every gradient entry)
        bcs = [pkg.IC(dom, [lambda x: np.sin(np.pi * x) + 0.5],
                      var=[["x"]])]
        kw = {}
        if adaptive:
            kw = dict(Adaptive_type=1,
                      dict_adaptive={"residual": [True], "BCs": [False]},
                      init_weights={"residual": [np.random.RandomState(0)
                                                 .rand(256, 1)],
                                    "BCs": [None]})
        s = (pkg.CollocationSolverND(verbose=False) if pkg is tdq else
             pkg.CollocationSolverND(verbose=False, device="cpu"))
        s.compile(SIZES, heat_f(pkg), dom, bcs, network=net, **kw)
        out.append(s)
    js, ts = out
    js.params = params
    ts.net.load_params(params_from_jax(_np_tree(params), device="cpu",
                                       module=ts.net, name_map=RES_MAP))
    return js, ts


def test_custom_module_loss_gradients_and_steps_match_jax():
    js, ts = res_pair(adaptive=True)
    assert ts.engine == "generic" and isinstance(ts.net, networks.ModuleNet)
    assert ts.params[0] is ts.net.module.inp.weight  # trained in place

    def jloss(p):
        return js.loss_fn(p, js.lambdas["BCs"], js.lambdas["residual"],
                          js.X_f)[0]

    j_total, j_grads = jax.value_and_grad(jloss)(js.params)
    params = [t.detach().clone().requires_grad_(True) for t in ts.params]
    t_total, _ = ts.loss_fn(params, ts.lambdas["BCs"], ts.lambdas["residual"],
                            ts.X_f)
    t_grads = torch.autograd.grad(t_total, params)
    assert abs(float(t_total.detach()) - float(j_total)) <= F32_BAND * abs(
        float(j_total))
    want = params_from_jax(_np_tree(j_grads), device="cpu",
                           module=ts.net, name_map=RES_MAP)
    # scale-relative over every leaf together
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(t_grads, want):
        assert float((g - w).abs().max()) <= F32_BAND * scale
    js.fit(tf_iter=5, chunk=5)
    ts.fit(tf_iter=5, chunk=5)
    np.testing.assert_allclose([r["Total Loss"] for r in ts.losses],
                               [float(r["Total Loss"]) for r in js.losses],
                               rtol=1e-4)
    with pytest.raises(ValueError, match="cannot be fused"):
        tdqt.CollocationSolverND(verbose=False, device="cpu").compile(
            SIZES, heat_f(tdqt), domain(tdqt), [], fused=True,
            network=TorchResMLP())


def test_custom_module_save_load_and_surrogate_round_trips(tmp_path):
    _, ts = res_pair()
    ts.fit(tf_iter=3, chunk=3)
    X = np.random.RandomState(2).uniform([-1, 0], [1, 1], (50, 2))
    u, f = ts.predict(X)
    ts.save(str(tmp_path / "m.tdqm"))
    with pytest.raises(ValueError, match="network="):
        tdqt.CollocationSolverND(verbose=False, device="cpu").load_model(
            str(tmp_path / "m.tdqm"))
    back = tdqt.CollocationSolverND(verbose=False, device="cpu")
    back.load_model(str(tmp_path / "m.tdqm"), network=TorchResMLP(seed=5))
    np.testing.assert_array_equal(back.predict(X)[0], u)
    # the checkpoint keeps the flat list, and restores into another init
    ts.save_checkpoint(str(tmp_path / "ck"))
    other = res_pair()[1]
    other.net.load_params([torch.zeros_like(p) for p in other.params])
    other.restore_checkpoint(str(tmp_path / "ck"))
    np.testing.assert_array_equal(other.predict(X)[0], u)
    assert other.losses == ts.losses
    ts.export_surrogate().save(str(tmp_path / "art"))
    with pytest.raises(ValueError, match="net="):
        Surrogate.load(str(tmp_path / "art"), device="cpu")
    sur = Surrogate.load(str(tmp_path / "art"), f_model=heat_f(tdqt),
                         net=TorchResMLP(seed=9), device="cpu")
    eng = sur.engine(min_bucket=16, max_bucket=64)
    assert scaled_err(eng.u(X), u) <= 1e-6
    assert scaled_err(eng.residual(X).reshape(f.shape), f) <= 1e-5
    with pytest.raises(ValueError, match="compute_dtype"):
        sur.engine(compute_dtype="bfloat16")


def test_discovery_trains_a_custom_module_as_jax_does():
    x, t, u = heat_data(200)
    jnet = JaxResMLP()
    params = init_params(jnet, 2, jax.random.PRNGKey(0))
    kw = dict(var=[0.1, 0.5], varnames=["x", "t"], verbose=False,
              lr_vars=[0.01, 0.02])
    jm = tdq.DiscoveryModel()
    jm.compile(SIZES, make_f(tdq), [x, t], u, network=jnet, **kw)
    jm.trainables["params"] = params
    tm = tdqt.DiscoveryModel(device="cpu")
    tm.compile(SIZES, make_f(tdqt), [x, t], u, network=TorchResMLP(), **kw)
    tm.net.load_params(params_from_jax(_np_tree(params), device="cpu",
                                       module=tm.net, name_map=RES_MAP))
    assert tm.engine == "generic"
    jm.fit(tf_iter=10, chunk=5)
    tm.fit(tf_iter=10, chunk=5)
    np.testing.assert_allclose(tm.losses, jm.losses, rtol=5e-3)
    np.testing.assert_allclose(tm.var_history, jm.var_history, rtol=5e-3,
                               atol=1e-4)


def test_params_from_jax_name_map_errors():
    params = _np_tree(init_params(JaxResMLP(), 2, jax.random.PRNGKey(0)))
    m = TorchResMLP()
    with pytest.raises(ValueError, match="names no flax array"):
        params_from_jax(params, device="cpu", module=m,
                        name_map={"inp/kernel": "inp.weight.T"})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, device="cpu", module=m,
                        name_map=dict(RES_MAP, **{"inp/kernel":
                                                  "inp.weight"}))


def test_tf32_emulation_is_a_float64_product_of_rounded_operands():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(37, 128, generator=g, requires_grad=True)
    b = (torch.randn(128, 24, generator=g) / 11).requires_grad_(True)
    cot = torch.randn(37, 24, generator=g)
    out = tf32_matmul(a, b)
    da, db = torch.autograd.grad((out * cot).sum(), [a, b])
    ar, br, cr = (rna_tf32(t.detach()).double() for t in (a, b, cot))
    for got, want in ((out, ar @ br), (da, cr @ br.t()), (db, ar.t() @ cr)):
        np.testing.assert_allclose(got.detach().double().numpy(),
                                   want.numpy(), rtol=2e-6,
                                   atol=2e-6 * float(want.abs().max()))
    # a TF32 unit (2^-10) apart from the IEEE product, on the slice's depth
    ieee = (a @ b).detach()
    err = scaled_err(out.detach().numpy(), ieee.numpy())
    assert 1e-5 < err < 1e-2
    # the Taylor table's mode: every product through it
    layers = [(torch.randn(2, 16, generator=g), torch.zeros(16)),
              (torch.randn(16, 1, generator=g) / 4, torch.zeros(1))]
    X = torch.rand(9, 2, generator=g)
    emu = taylor_derivatives(layers, X, {(0, 0)}, emulate_tf32=True)
    z = torch.tanh(tf32_matmul(X, layers[0][0]))
    np.testing.assert_array_equal(
        emu[()].numpy(), tf32_matmul(z, layers[1][0]).numpy())


def test_precision_on_the_cpu_is_ieee_and_names_the_tf32_flavor():
    out = []
    for precision in (None, "highest"):
        s = make_solver()  # SA Burgers on the CPU, the fused minimax step
        net = tdqt.neural_net([2, 8, 8, 1], device="cpu", seed=0,
                              precision=precision)
        s2 = tdqt.CollocationSolverND(verbose=False, seed=0, device="cpu")
        s2.compile([2, 8, 8, 1], s.f_model, s.domain, s.bcs,
                   network=net, Adaptive_type=1,
                   dict_adaptive={"residual": [True],
                                  "BCs": [True, False, False]},
                   init_weights={"residual": [np.random.RandomState(0)
                                              .rand(128, 1)],
                                 "BCs": [np.random.RandomState(1)
                                         .rand(16, 1), None, None]})
        s2.fit(tf_iter=5, chunk=5, newton_iter=2)
        out.append(s2)
    tf32, ieee = out
    assert tf32.precision == "default" and ieee.precision == "highest"
    assert tf32.engine == ieee.engine == "fused-minimax"
    assert tf32._minimax_sq.flavor == TF32 and ieee._minimax_sq.flavor is None
    assert tf32.losses == ieee.losses
    assert all(torch.equal(a, b) for a, b in zip(tf32.net.params(),
                                                  ieee.net.params()))


def test_non_tanh_mlp_saves_and_needs_its_network_to_load(tmp_path):
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(SIZES, heat_f(tdqt), domain(tdqt), [],
              network=tdqt.neural_net(SIZES, activation=torch.sin,
                                      device="cpu"))
    s.save(str(tmp_path / "sin.tdqm"))
    with pytest.raises(ValueError, match="only tanh networks"):
        tdqt.CollocationSolverND(device="cpu").load_model(
            str(tmp_path / "sin.tdqm"))
    back = tdqt.CollocationSolverND(device="cpu").load_model(
        str(tmp_path / "sin.tdqm"),
        network=tdqt.neural_net(SIZES, activation=torch.sin, device="cpu",
                                seed=4))
    X = np.random.RandomState(3).uniform([-1, 0], [1, 1], (20, 2))
    np.testing.assert_array_equal(back.predict(X)[0], s.predict(X)[0])


def test_checkpoint_written_before_the_protocol_restores_bit_for_bit():
    want = np.load(os.path.join(FIXTURE, "expected.npz"))
    s = make_solver(seed=1)  # another init, overwritten by the restore
    s.restore_checkpoint(os.path.join(FIXTURE, "ck"))
    for i, p in enumerate(s.net.params()):
        np.testing.assert_array_equal(p.detach().numpy(), want[f"p{i}"])
    assert float(s.update_loss()[0]) == float(want["total"])
    s.fit(tf_iter=5, chunk=5, newton_iter=3)
    assert [r["Total Loss"] for r in s.losses[10:]] == list(want["after"])
    m = tdqt.CollocationSolverND(verbose=False, device="cpu")
    m.load_model(os.path.join(FIXTURE, "model.tdq"))
    for i, p in enumerate(m.net.params()):
        np.testing.assert_array_equal(p.detach().numpy(), want[f"p{i}"])


def test_precision_none_engine_serves_derivatives_from_the_table(tmp_path):
    """A served ``precision=None`` MLP takes its derivative kinds from the
    Taylor table (K1-TF32 on the card; on the CPU the plain flavor, IEEE
    float32): within float32 rounding of the generic programs of the
    same artifact served at ``"highest"``; ``u`` stays the forward."""
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(SIZES, heat_f(tdqt), domain(tdqt), [],
              network=tdqt.neural_net(SIZES, device="cpu", precision=None))
    sur = s.export_surrogate()  # the solver's net, at "default"
    sur.save(str(tmp_path / "art"))
    # rebuilt from the artifact's record: the JAX package's records carry
    # no precision, and its rebuilt nets run at HIGHEST; so here
    hi = Surrogate.load(str(tmp_path / "art"), f_model=heat_f(tdqt),
                        device="cpu")
    assert sur.net.precision == "default" and hi.net.precision == "highest"
    eng, ref = sur.engine(min_bucket=64, max_bucket=64), \
        hi.engine(min_bucket=64, max_bucket=64)
    assert eng._tf32 and not ref._tf32
    X = np.random.RandomState(7).uniform([-1, 0], [1, 1], (50, 2))
    for var, order in (("x", 1), ("x", 2), ("t", 1)):
        got, want = eng.derivative(X, var, order), ref.derivative(X, var,
                                                                 order)
        assert scaled_err(got, want) <= 1e-5, (var, order)
    np.testing.assert_array_equal(eng.u(X), ref.u(X))
