"""The PyTorch port's composite loss against the JAX package's
``build_loss_fn`` on the Allen-Cahn SA micro problem (the zoo entry
``allen-cahn-sa``, micro size with n_f cut 2048 -> 256): IC with per-point
λ_IC, periodic (u, u_x) BC, per-point λ_res, Adaptive_type=1.  The total,
every component, and the gradients w.r.t. the parameters, λ_res and λ_IC
agree at rtol 1e-5, for the generic and the fused (plain) residual engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.models.assembly import build_loss_fn as jax_build
from tensordiffeq_tpu.ops.fused import analyze_f_model as jax_analyze
from tensordiffeq_tpu.ops.fused import make_fused_residual as jax_fused
from tensordiffeq_tpu_torch.models.assembly import build_loss_fn
from tensordiffeq_tpu_torch.networks import mlp_forward
from tensordiffeq_tpu_torch.ops.fused import analyze_f_model, make_fused_residual
from tensordiffeq_tpu_torch.utils import CudaUnavailableError, initialize_lambdas
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
N_F, WIDTHS, GRID = 256, (32, 32), (64, 21)
RTOL = 1e-5


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
    lam = {"residual": [rng.rand(N_F, 1)], "BCs": [100.0 * rng.rand(nx, 1), None]}
    return domain, bcs, f_model, lam


@pytest.fixture(scope="module")
def shared():
    net = tdq.neural_net([2, *WIDTHS, 1])
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    return net, params


@pytest.mark.parametrize("engine", ["generic", "fused"])
def test_ac_sa_loss_and_grads_match_jax(shared, engine):
    net, params = shared
    jd, jb, jf, jlam = ac_problem(tdq)
    td, tb, tf, tlam = ac_problem(tdqt)
    assert np.array_equal(jd.X_f, td.X_f)

    j_res = t_res = None
    if engine == "fused":
        j_res = jax_fused(jf, jd.vars, 1, jax_analyze(jf, jd.vars, 1))
        t_res = make_fused_residual(tf, td.vars, 1, analyze_f_model(tf, td.vars, 1))
    jloss = jax_build(net.apply, jd.vars, 1, jf, jb, residual_fn=j_res)
    tloss = build_loss_fn(mlp_forward, td.vars, 1, tf, tb, residual_fn=t_res,
                          device="cpu")

    X = jd.X_f.astype(np.float32)
    j_lam = [jnp.asarray(jlam["residual"][0], jnp.float32)]
    j_lbc = [jnp.asarray(jlam["BCs"][0], jnp.float32), None]

    def jtotal(p, lr, lb):
        return jloss(p, [lb, None], [lr], jnp.asarray(X))

    (j_tot, j_comps), j_grads = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1, 2), has_aux=True))(params, j_lam[0], j_lbc[0])

    layers = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in
              params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")]
    lams = initialize_lambdas(tlam, {"residual": [True], "BCs": [True, False]},
                              device="cpu")
    t_tot, t_comps = tloss(layers, lams["BCs"], lams["residual"],
                           torch.from_numpy(np.ascontiguousarray(X)))
    flat = [t for p in layers for t in p]
    t_grads = torch.autograd.grad(t_tot, flat + [lams["residual"][0],
                                                 lams["BCs"][0]])

    assert set(t_comps) == set(j_comps) == {"BC_0", "BC_1", "Residual_0",
                                            "Total Loss"}
    for k in j_comps:
        np.testing.assert_allclose(float(t_comps[k].detach()),
                                   float(j_comps[k]),
                                   rtol=RTOL, err_msg=k)
    jp = j_grads[0]["params"]
    want = [np.asarray(a) for i in range(len(jp))
            for a in (jp[f"Dense_{i}"]["kernel"], jp[f"Dense_{i}"]["bias"])]
    want += [np.asarray(j_grads[1]), np.asarray(j_grads[2])]
    for name, a, b in zip(["W0", "b0", "W1", "b1", "W2", "b2", "lam_res",
                           "lam_IC"], t_grads, want):
        # elementwise rtol; atol at rtol of the leaf's scale, for entries
        # that cancel to ~0
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(b)), err_msg=name)


def test_lambda_containers():
    lams = initialize_lambdas({"residual": [np.ones(5)], "BCs": [None, 2.0]},
                              {"residual": [True], "BCs": [False, True]},
                              device="cpu")
    assert lams["residual"][0].shape == (5, 1)
    assert lams["residual"][0].requires_grad
    assert lams["BCs"][0] is None and float(lams["BCs"][1]) == 2.0
    with pytest.raises(ValueError, match="same length"):
        initialize_lambdas({"residual": [1.0, 2.0]}, {"residual": [True]},
                           device="cpu")


def test_build_loss_fn_defaults_to_the_card():
    """``build_loss_fn`` runs on the card unless the caller asks for the
    CPU, as every other entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    td, tb, tf, _ = ac_problem(tdqt)
    with pytest.raises(CudaUnavailableError):
        build_loss_fn(mlp_forward, td.vars, 1, tf, tb)
