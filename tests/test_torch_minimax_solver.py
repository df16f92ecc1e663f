"""The port's solver adopts the fused minimax step as the JAX solver does.

* ``compile(minimax=None)`` on a CPU solver adopts the plain flavor
  (``_minimax_kind == "plain"``) for the Allen-Cahn, Burgers and coupled
  2-equation problems, and its loss equals the unfused one's;
* over 20 SA steps from shared parameters and λ its trajectory matches the
  JAX solver's adopted ``"xla"`` step within rtol 5e-3 (the engines'
  cross-check band), and λ move (``tests/test_solver.py:517-552``);
* a 1-tuple ``f_model`` is bit-identical to the array form
  (``tests/test_solver.py:720-740``);
* an ``f_model`` that does not lower to K3's residual tape keeps the
  unfused loss under ``minimax=None``, with the reason recorded, and raises
  under ``minimax=True``;
* a fault while the step runs (a kernel that does not build or launch)
  raises out of ``compile`` instead of keeping the unfused loss;
* a torch function of a raw coordinate (``torch.sin(x)``) fuses and adopts.
"""

import jax
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor, minimax
from tensordiffeq_tpu_torch.ops.residual_tape import MinimaxLoweringError
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
N_F = 256
RTOL = 5e-3


def burgers(pkg, n_f=N_F, nx=32, nt=11, seed=0):
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)
    bcs = [pkg.IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]]),
           pkg.dirichletBC(domain, val=0.0, var="x", target="upper"),
           pkg.dirichletBC(domain, val=0.0, var="x", target="lower")]
    grad = pkg.grad

    def f_model(u, x, t):
        u_x, u_t = grad(u, "x"), grad(u, "t")
        return (u_t(x, t) + u(x, t) * u_x(x, t)
                - (0.01 / np.pi) * grad(u_x, "x")(x, t))

    rng = np.random.RandomState(0)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False, False]},
              init_weights={"residual": [rng.rand(n_f, 1)],
                            "BCs": [100 * rng.rand(nx, 1), None, None]})
    return domain, bcs, f_model, kw, [2, 10, 10, 1]


def coupled_system(pkg, n_f=N_F, nx=32, nt=9, seed=0):
    """The Schrödinger-type pair of ``tests/test_solver.py::
    make_coupled_system``, per-point SA λ on both equations."""
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)
    grad = pkg.grad
    ics = pkg.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x),
                          lambda x: 0.0 * x], var=[["x"], ["x"]])

    def deriv_model(u, x, t):
        return (u[0](x, t), u[1](x, t),
                grad(u[0], "x")(x, t), grad(u[1], "x")(x, t))

    bcs = [ics, pkg.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        f_u = grad(u[0], "t")(x, t) \
            + 0.5 * grad(grad(u[1], "x"), "x")(x, t) + sq * vv
        f_v = grad(u[1], "t")(x, t) \
            - 0.5 * grad(grad(u[0], "x"), "x")(x, t) - sq * uv
        return f_u, f_v

    rng = np.random.RandomState(0)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True, True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(n_f, 1), rng.rand(n_f, 1)],
                            "BCs": [100 * rng.rand(nx, 1), None]})
    return domain, bcs, f_model, kw, [2, 10, 10, 2]


def allen_cahn(pkg, n_f=N_F, nx=64, nt=21, seed=0):
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)
    grad = pkg.grad

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [pkg.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                  var=[["x"]]),
           pkg.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    rng = np.random.RandomState(0)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(n_f, 1)],
                            "BCs": [100.0 * rng.rand(nx, 1), None]})
    return domain, bcs, f_model, kw, [2, 16, 16, 1]


PROBLEMS = {"ac": allen_cahn, "burgers": burgers, "system": coupled_system}


def _port_solver(problem, minimax, **extra):
    domain, bcs, f_model, kw, layers = PROBLEMS[problem](tdqt)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(layers, f_model, domain, bcs, minimax=minimax, **kw, **extra)
    return s


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_minimax_none_adopts_plain_flavor(problem):
    cuda_minimax.k3_minimax.launches = 0
    mm = _port_solver(problem, None)
    un = _port_solver(problem, False)
    assert mm._minimax_kind == "plain" and mm.engine == "fused-minimax"
    assert mm._minimax_fail_reason is None
    assert mm._minimax_n_eq == mm._minimax_sq.n_equations \
        == (2 if problem == "system" else 1)
    assert un._minimax_kind is None and un.engine == "fused"
    t_mm, c_mm = mm.update_loss()
    t_un, _ = un.update_loss()
    t_mm, t_un = float(t_mm.detach()), float(t_un.detach())
    assert abs(t_mm - t_un) <= 1e-4 * abs(t_un)
    assert "Residual_0" in c_mm
    assert cuda_minimax.k3_minimax.launches == 0  # a CPU solver: no kernel


@pytest.mark.parametrize("problem", ["burgers", "system"])
def test_minimax_trajectory_matches_jax(problem):
    jd, jb, jf, jkw, layers = PROBLEMS[problem](tdq)
    js = tdq.CollocationSolverND(verbose=False)
    js.compile(layers, jf, jd, jb, **jkw)
    assert js._minimax_kind == "xla"
    ts = _port_solver(problem, None)
    assert ts._minimax_kind == "plain"
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    lam0 = [lam.detach().clone() for lam in ts.lambdas["residual"]]
    js.fit(tf_iter=20, newton_iter=0, chunk=10)
    ts.fit(tf_iter=20, chunk=10)
    jl = np.array([r["Total Loss"] for r in js.losses])
    tl = np.array([r["Total Loss"] for r in ts.losses])
    assert len(tl) == len(jl) == 20
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose([r["Residual_0"] for r in ts.losses],
                               [r["Residual_0"] for r in js.losses],
                               rtol=RTOL)
    assert tl[-1] < tl[0]
    # the SA ascent ran through the fused ∂/∂w cotangent, for every equation
    for lam, before, jlam in zip(ts.lambdas["residual"], lam0,
                                 js.lambdas["residual"]):
        assert float((lam.detach() - before).abs().max()) > 0
        np.testing.assert_allclose(lam.detach().numpy(), np.asarray(jlam),
                                   rtol=RTOL, atol=1e-4)


def test_one_equation_tuple_is_bit_identical_to_array_form():
    domain, bcs, f_model, _, layers = burgers(tdqt)

    def f_tuple(u, x, t):
        return (f_model(u, x, t),)

    def build(fm):
        s = tdqt.CollocationSolverND(verbose=False, device="cpu")
        s.compile(layers, fm, domain, bcs, minimax=True)
        return s

    a, b = build(f_model), build(f_tuple)
    assert a._minimax_kind == b._minimax_kind == "plain"
    assert a._minimax_sq.n_equations == b._minimax_sq.n_equations == 1
    assert float(a.update_loss()[0].detach()) == \
        float(b.update_loss()[0].detach())
    a.fit(tf_iter=5)
    b.fit(tf_iter=5)
    assert [r["Total Loss"] for r in a.losses] == \
        [r["Total Loss"] for r in b.losses]


def test_unlowerable_f_model_keeps_unfused_loss_or_raises():
    domain, bcs, f_model, _, layers = burgers(tdqt)

    def f_abs(u, x, t):  # pointwise, fusable, but abs is not on the tape
        return torch.abs(f_model(u, x, t))

    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(layers, f_abs, domain, bcs)
    assert s.engine == "fused" and s._minimax_kind is None
    assert isinstance(s._minimax_fail_reason, MinimaxLoweringError)
    s.fit(tf_iter=2)
    assert np.isfinite(s.losses[-1]["Total Loss"])
    with pytest.raises(ValueError, match="minimax=True") as info:
        s.compile(layers, f_abs, domain, bcs, minimax=True)
    assert isinstance(info.value.__cause__, MinimaxLoweringError)
    # without a fused residual there is nothing to adopt
    s.compile(layers, f_model, domain, bcs, fused=False)
    assert s.engine == "generic" and s._minimax_fail_reason is not None
    with pytest.raises(ValueError, match="minimax=True"):
        s.compile(layers, f_model, domain, bcs, fused=False, minimax=True)


@pytest.mark.parametrize("fault", [cuda_taylor.KernelBuildError,
                                   cuda_taylor.KernelLaunchError,
                                   tdqt.CudaUnavailableError])
def test_a_fault_running_the_step_raises_out_of_compile(monkeypatch, fault):
    """Only the residual disqualifies the minimax step.  A fault while the
    step runs (on a CUDA solver: K3 does not build or launch) leaves
    ``compile(minimax=None)`` as it is, instead of training on the unfused
    loss."""
    def faulty_loss(sq, **kw):
        def residual_loss(params, lam_res, X):
            raise fault("minimax_step K3 launch: CUDA error 1")
        return residual_loss

    monkeypatch.setattr(minimax, "make_minimax_residual_loss", faulty_loss)
    with pytest.raises(fault, match="K3 launch"):
        _port_solver("burgers", None)


def test_torch_function_of_a_coordinate_fuses_and_adopts():
    """``torch.sin(x)`` on a raw coordinate: the analysis takes it (its
    coordinate tokens are tensors), so the solver fuses the residual and
    adopts the minimax step, as the JAX solver does for ``jnp.sin(x)``."""
    domain, bcs, f_model, _, layers = burgers(tdqt)

    def forced(u, x, t):
        return f_model(u, x, t) - torch.sin(np.pi * x) * torch.exp(-t)

    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(layers, forced, domain, bcs)
    assert s.engine == "fused-minimax" and s._minimax_kind == "plain"
    ops = {code for code, _, _ in s._minimax_sq.plan.tape.ops}
    from tensordiffeq_tpu_torch.ops.residual_tape import OP
    assert {OP["sin"], OP["exp"]} <= ops
    un = tdqt.CollocationSolverND(verbose=False, device="cpu")
    un.compile(layers, forced, domain, bcs, fused=False)
    t_mm, t_un = float(s.update_loss()[0].detach()), \
        float(un.update_loss()[0].detach())
    assert abs(t_mm - t_un) <= 1e-4 * abs(t_un)
