"""Mixed precision (bf16 operands, f32 sums) of the PyTorch port against the
JAX package's ``compute_dtype=jnp.bfloat16`` / ``fused_dtype="bfloat16"``,
on the CPU.

* the plain flavor's Taylor table and its gradients (``ops/taylor.py``)
  against JAX ``taylor_derivatives(compute_dtype=jnp.bfloat16)`` on the
  request sets of the Allen-Cahn, Burgers and 4th-order (beam) cases; the
  rounding lands where the jaxpr's casts put it (dW and the stack's
  cotangent, gX included, are bf16 values; db and the table are not);
* the minimax unit's value, dW/db, gw and gX against JAX's
  ``build_minimax_sq_fn(use_pallas=False, compute_dtype=jnp.bfloat16)``
  for E = 1 and the coupled E = 2 system;
* the kernel wrappers' bf16 table and step functions take the plain bf16
  flavor for CPU tensors and count no launch;
* the solver: ``compile(fused_dtype="bfloat16")`` with the JAX semantics
  (the warnings, the bands, the f32 refinement flavor, the L-BFGS retreat,
  autotune's candidates) and its trajectory against the JAX solver's on
  the same carried weights and points;
* serving: ``InferenceEngine(compute_dtype="bfloat16")`` per kind against
  the f32 engine and against the JAX bf16 engine on carried weights.

Bands: the JAX solver's bf16 cross-check bands, 5e-2 on values and 1.5e-1
on gradients, scale-relative (max |error| over max |reference|).  Both
sides round at the same places, so the port sits far inside them (the
errors are printed); each comparison also checks that the port is nearer
(RMS) to JAX's bf16 flavor than to its f32 flavor, which a port computing
in f32 would fail.  Trajectories: the port's solver parity band, rtol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.networks import neural_net as jax_net
from tensordiffeq_tpu.ops import pallas_minimax as jmm
from tensordiffeq_tpu.ops.fused import analyze_f_model as jax_analyze
from tensordiffeq_tpu.ops.taylor import extract_mlp_layers
from tensordiffeq_tpu.ops.taylor import taylor_derivatives as jax_table
from tensordiffeq_tpu.serving import Surrogate as JSurrogate
from tensordiffeq_tpu_torch.models import collocation
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor, minimax
from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
from tensordiffeq_tpu_torch.serving import Surrogate
from tensordiffeq_tpu_torch.training import lbfgs
from tensordiffeq_tpu_torch.utils import resolve_compute_dtype
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
BF16 = torch.bfloat16
VALUES, GRADS = 5e-2, 1.5e-1  # the reference's bf16 bands
RTOL = 5e-3  # the port's solver parity band
VARS = ("x", "t")

REQUESTS = {
    "ac": {(), (1,), (0, 0)},
    "burgers": {(), (0,), (1,), (0, 0)},
    # u_t + u_xxxx + u_xxt: unmixed 4th order and a mixed 3rd
    "fourth": {(), (1,), (0, 0, 1), (0, 0, 0, 0)},
}


def scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def nearer_bf16(got, want_bf, want_f32) -> bool:
    """RMS over all leaves together: nearer JAX's bf16 flavor than its f32
    flavor."""
    cat = lambda ts: np.concatenate([np.ravel(t) for t in ts])  # noqa: E731
    return rms(cat(got), cat(want_bf)) < rms(cat(got), cat(want_f32))


def is_bf16(a) -> bool:
    t = torch.as_tensor(np.asarray(a, np.float32))
    return bool(torch.equal(t.to(BF16).float(), t))


@pytest.fixture(scope="module")
def net16():
    params = jax_net([2, 16, 16, 1]).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 2)))
    X = (np.random.RandomState(0).randn(300, 2) * 0.5).astype(np.float32)
    jl = extract_mlp_layers(params)
    tl = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    return jl, tl, X


def _cotangents(reqs, n, seed=1):
    rng = np.random.RandomState(seed)
    return {mi: rng.randn(n, 1).astype(np.float32) for mi in reqs}


def _jax_table_grads(jl, X, reqs, cot, dtype):
    def loss(layers, x):
        t = jax_table(layers, x, reqs, compute_dtype=dtype)
        return sum(jnp.sum(t[mi] * cot[mi]) for mi in reqs)

    t = jax_table(jl, jnp.asarray(X), reqs, compute_dtype=dtype)
    gl, gx = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(X))
    return ({mi: np.asarray(t[mi]) for mi in reqs},
            [np.asarray(a) for p in gl for a in p] + [np.asarray(gx)])


def _torch_table_grads(tl, X, reqs, cot, dtype=BF16):
    leaves = [t.clone().requires_grad_(True) for p in tl for t in p]
    Xt = torch.from_numpy(X).requires_grad_(True)
    t = taylor_derivatives(list(zip(leaves[0::2], leaves[1::2])), Xt, reqs,
                           compute_dtype=dtype)
    loss = sum(torch.sum(t[mi] * torch.from_numpy(cot[mi])) for mi in reqs)
    grads = torch.autograd.grad(loss, leaves + [Xt])
    return ({mi: t[mi].detach().numpy() for mi in reqs},
            [g.numpy() for g in grads])


# --------------------------------------------------------------------------- #
# 1. the plain flavor
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(REQUESTS))
def test_plain_bf16_table_matches_jax(net16, case):
    jl, tl, X = net16
    reqs = REQUESTS[case]
    cot = _cotangents(reqs, X.shape[0])
    jt, jg = _jax_table_grads(jl, X, reqs, cot, jnp.bfloat16)
    jt32, jg32 = _jax_table_grads(jl, X, reqs, cot, None)
    tt, tg = _torch_table_grads(tl, X, reqs, cot)
    v_err = max(scaled(tt[mi], jt[mi]) for mi in reqs)
    g_err = max(scaled(a.reshape(b.shape), b) for a, b in zip(tg, jg))
    print(f"[{case}] table {v_err:.3e} (band {VALUES}), gradients "
          f"{g_err:.3e} (band {GRADS}); bf16 vs f32 in JAX: "
          f"{max(scaled(jt[mi], jt32[mi]) for mi in reqs):.3e}")
    assert v_err <= VALUES and g_err <= GRADS
    mis = sorted(reqs)
    assert nearer_bf16([tt[m] for m in mis], [jt[m] for m in mis],
                       [jt32[m] for m in mis])
    assert nearer_bf16(tg, jg, jg32)


def test_plain_bf16_rounds_where_the_jaxpr_rounds(net16):
    """dW and the X cotangent leave the transposed casts as bf16 values, in
    the port as in JAX; db and the table are f32 values (the bias add and
    the pointwise chain are not rounded)."""
    jl, tl, X = net16
    reqs = REQUESTS["fourth"]
    cot = _cotangents(reqs, X.shape[0])
    jt, jg = _jax_table_grads(jl, X, reqs, cot, jnp.bfloat16)
    tt, tg = _torch_table_grads(tl, X, reqs, cot)
    for grads in (tg, jg):
        dW, db, gX = grads[0:-1:2], grads[1:-1:2], grads[-1]
        assert all(is_bf16(w) for w in dW)
        assert is_bf16(gX)
        assert not all(is_bf16(b) for b in db)
    assert not any(is_bf16(tt[mi]) for mi in reqs if mi)
    # and the f32 flavor rounds nowhere
    _, g32 = _torch_table_grads(tl, X, reqs, cot, dtype=None)
    assert not is_bf16(g32[0]) and not is_bf16(g32[-1])


def test_compute_dtype_names():
    assert resolve_compute_dtype(None) is None
    assert resolve_compute_dtype("bfloat16") is BF16
    assert resolve_compute_dtype(BF16) is BF16
    for bad in ("float16", torch.float16, "bf16"):
        with pytest.raises(ValueError, match="bfloat16"):
            resolve_compute_dtype(bad)
    with pytest.raises(ValueError, match="bfloat16"):
        taylor_derivatives([(torch.ones(2, 1), torch.ones(1))],
                           torch.ones(3, 2), set(),
                           compute_dtype=torch.float16)


# --------------------------------------------------------------------------- #
# 2. the minimax unit
# --------------------------------------------------------------------------- #
def _residuals(g):
    def ac(u, x, t):
        return (g(u, "t")(x, t) - 0.05 * g(g(u, "x"), "x")(x, t)
                + u(x, t) ** 3 - u(x, t))

    def system(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        return (g(u[0], "t")(x, t) + 0.5 * g(g(u[1], "x"), "x")(x, t)
                + sq * vv,
                g(u[1], "t")(x, t) - 0.5 * g(g(u[0], "x"), "x")(x, t)
                - sq * uv)

    return dict(ac=ac, system=system)


T_RES, J_RES = _residuals(tdqt.grad), _residuals(tdq.grad)
N_OUT = dict(ac=1, system=2)


def _minimax_setup(case, n=200, seed=0):
    params = jax_net([2, 16, 16, N_OUT[case]]).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2)))
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, 2) * 0.5).astype(np.float32)
    w = rng.rand(n, 2 if case == "system" else 1).astype(np.float32)
    return (extract_mlp_layers(params),
            params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            device="cpu"), X, w)


def _jax_sq(case, jl, X, w, dtype):
    f = J_RES[case]
    sq = jmm.build_minimax_sq_fn(f, VARS, N_OUT[case],
                                 jax_analyze(f, VARS, N_OUT[case]),
                                 [tuple(W.shape) for W, _ in jl],
                                 use_pallas=False, compute_dtype=dtype)
    val, vjp = jax.vjp(sq, jl, jnp.asarray(w), jnp.asarray(X))
    gl, gw, gx = vjp(jnp.ones((), val.dtype))
    return ([np.asarray(val).reshape(1)]
            + [np.asarray(a).ravel() for p in gl for a in p]
            + [np.asarray(gw), np.asarray(gx)])


def _torch_sq(case, tl, X, w, dtype="bfloat16"):
    f = T_RES[case]
    sq = minimax.build_minimax_sq_fn(f, VARS, N_OUT[case],
                                     analyze_f_model(f, VARS, N_OUT[case]),
                                     [tuple(W.shape) for W, _ in tl],
                                     device="cpu", compute_dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for p in tl for t in p]
    wt = torch.from_numpy(w).requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    val = sq(list(zip(leaves[0::2], leaves[1::2])), wt, Xt)
    grads = torch.autograd.grad(val, leaves + [wt, Xt])
    return sq, ([val.detach().numpy().reshape(1)]
                + [g.numpy().ravel() for g in grads[:-2]]
                + [grads[-2].numpy(), grads[-1].numpy()])


@pytest.mark.parametrize("case", ["ac", "system"])
def test_minimax_bf16_matches_jax(case):
    jl, tl, X, w = _minimax_setup(case)
    sq, got = _torch_sq(case, tl, X, w)
    assert sq.compute_dtype is BF16 and sq.n_equations == N_OUT[case]
    want = _jax_sq(case, jl, X, w, jnp.bfloat16)
    want32 = _jax_sq(case, jl, X, w, None)
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        band = VALUES if i in (0, len(got) - 2) else GRADS  # value, gw
        errs.append(scaled(a.reshape(b.shape), b))
        assert errs[-1] <= band, (i, errs[-1])
    print(f"[minimax {case}] value {errs[0]:.3e}, gw {errs[-2]:.3e}, "
          f"dW/db/gX max {max(errs[1:-2] + errs[-1:]):.3e}")
    assert nearer_bf16(got, want, want32)


# --------------------------------------------------------------------------- #
# 3. the kernel wrappers on CPU tensors
# --------------------------------------------------------------------------- #
def test_bf16_wrappers_take_the_plain_bf16_flavor_on_cpu(net16):
    _, tl, X = net16
    reqs = REQUESTS["burgers"]
    cuda_taylor.reset_launch_counts()
    fn = cuda_taylor.build_cuda_table_fn(reqs, [tuple(W.shape) for W, _ in tl],
                                         device="cpu",
                                         compute_dtype="bfloat16")
    assert fn.compute_dtype is BF16
    Xt = torch.from_numpy(X)
    got = fn(tl, Xt)
    want = taylor_derivatives(tl, Xt, reqs, flat_matmul=True,
                              compute_dtype=BF16)
    for mi in got:
        assert torch.equal(got[mi], want[mi])
    _, t_ac, X_ac, w_ac = _minimax_setup("ac")
    sq, _ = _torch_sq("ac", t_ac, X_ac, w_ac)
    assert all(fn_.launches == 0 for fn_ in cuda_taylor.COUNTED)
    assert cuda_minimax.k3_minimax_bf16 in cuda_taylor.COUNTED
    assert cuda_taylor.k1_forward_bf16 in cuda_taylor.COUNTED
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_taylor.build_cuda_table_fn(reqs, [(2, 4), (4, 1)],
                                        device="cpu", compute_dtype="half")


def test_route_passes_at_the_slice():
    """The tensor-core passes per product the kernels' route takes: 3 TF32
    passes in the f32 flavor; in the bf16 flavor bf16 passes, 1 for K1
    and (3 forward + 3x6 backward) / 9 for K2 and K3 at the AC slice (the
    head, 1 wide, stays SIMT)."""
    shapes = [(2, 128)] + [(128, 128)] * 3 + [(128, 1)]
    plan = cuda_taylor.build_cuda_table_fn(REQUESTS["ac"], shapes,
                                           device="cpu").plan
    assert cuda_taylor.tensor_passes(plan) == {"k1": 3.0, "k2": 3.0}
    got = cuda_taylor.tensor_passes(plan, "bfloat16")
    assert got["k1"] == 1.0 and got["k2"] == pytest.approx(21 / 9)
    sq = minimax.build_minimax_sq_fn(
        T_RES["ac"], VARS, 1, analyze_f_model(T_RES["ac"], VARS, 1), shapes,
        device="cpu")
    assert cuda_minimax.tensor_passes(sq.plan) == 3.0
    assert cuda_minimax.tensor_passes(sq.plan, BF16) == pytest.approx(21 / 9)


def test_bf16_bound_passes_at_the_slice():
    """The bf16 flavor's bound prices its work on the card's fastest route,
    at the dense bf16 peak: 1 pass per forward product, 3 per cotangent
    product, so (3 + 3x6) / 9 for K2 and K3 at the AC slice.  The kernels
    take that route, so it is their route's bound too, and it lies below
    the TF32-pass route the flavor took before (1 TF32 pass per forward
    product, 2 per cotangent product)."""
    shapes = [(2, 128)] + [(128, 128)] * 3 + [(128, 1)]
    plan = cuda_taylor.build_cuda_table_fn(REQUESTS["ac"], shapes,
                                           device="cpu").plan
    got = cuda_taylor.tensor_passes(plan, BF16)
    assert got["k1"] == 1.0 and got["k2"] == pytest.approx(21 / 9)
    tf32_route = {"k1": 1.0, "k2": 15 / 9}
    for k in ("k1", "k2"):
        assert got[k] / 989e12 < tf32_route[k] / 495e12


# --------------------------------------------------------------------------- #
# 4. the solver
# --------------------------------------------------------------------------- #
def burgers_problem(pkg, n_f=256, seed=0):
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 16)
    domain.add("t", [0.0, 1.0], 8)
    domain.generate_collocation_points(n_f, seed=seed)
    bcs = [pkg.IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]]),
           pkg.dirichletBC(domain, val=0.0, var="x", target="upper")]
    grad = pkg.grad

    def f_model(u, x, t):
        u_x = grad(u, "x")
        return grad(u, "t")(x, t) + u(x, t) * u_x(x, t) \
            - 0.01 * grad(u_x, "x")(x, t)

    return domain, bcs, f_model


def _solver(fused="cuda", fused_dtype="bfloat16", minimax_=None, n_f=256,
            layers=(2, 10, 10, 1), **kw):
    domain, bcs, f_model = burgers_problem(tdqt, n_f=n_f)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(list(layers), f_model, domain, bcs, fused=fused,
              fused_dtype=fused_dtype, minimax=minimax_, **kw)
    return s


@pytest.mark.parametrize("minimax_", [None, False],
                         ids=["minimax", "unfused"])
@pytest.mark.parametrize("fused", [True, "cuda"])
def test_fused_dtype_trains_and_stays_in_band(fused, minimax_):
    s = _solver(fused=fused, minimax_=minimax_)
    assert s.fused_dtype is BF16 and s._fused_residual is not None
    assert s.engine == ("fused-minimax" if minimax_ is None
                        else "fused-cuda" if fused == "cuda" else "fused")
    if minimax_ is None:
        assert s._minimax_sq.compute_dtype is BF16
    params = s.net.layers()
    with torch.no_grad():
        generic = s._generic_residual(params, s.X_f).numpy()
        fused_r = s._fused_residual(params, s.X_f).numpy()
        f32 = s._refine_residual(params, s.X_f).numpy()
    err = np.abs(fused_r - generic).max() / (np.abs(generic).max() + 1e-3)
    assert 0 < err < VALUES
    # the refinement flavor is the f32 engine: f32 agreement, not bf16's
    assert np.abs(f32 - generic).max() < 0.1 * np.abs(fused_r - generic).max()
    s.fit(tf_iter=6, chunk=3)
    assert np.isfinite(s.losses[-1]["Total Loss"])
    assert s.losses[-1]["Total Loss"] < s.losses[0]["Total Loss"]


def test_fused_dtype_ignored_with_generic_engine():
    with pytest.warns(UserWarning, match="fused_dtype is ignored"):
        s = _solver(fused=False)
    assert s.fused_dtype is None and s.engine == "generic"
    assert s.loss_fn_refine is s.loss_fn


def test_fused_dtype_warns_without_a_fused_engine():
    """fused=None whose engine does not qualify (u at transformed
    coordinates): the option is named in a warning and training runs f32."""
    domain, bcs, _ = burgers_problem(tdqt)

    def f_model(u, x, t):
        return tdqt.grad(u, "t")(x, t) + u(2.0 * x, t)

    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    with pytest.warns(UserWarning, match="no fused engine is active"):
        s.compile([2, 8, 1], f_model, domain, bcs, fused_dtype="bfloat16")
    assert s.engine == "generic" and s.loss_fn_refine is s.loss_fn


@pytest.mark.parametrize("minimax_", [None, False],
                         ids=["minimax", "unfused"])
def test_lbfgs_refine_loss_is_the_f32_engine(minimax_, monkeypatch):
    s = _solver(minimax_=minimax_)
    assert s.loss_fn_refine is not s.loss_fn
    if minimax_ is None:
        assert s._minimax_loss_refine is not s._minimax_loss
    lam = s.lambdas
    with torch.no_grad():
        t16 = float(s.loss_fn(s.net.layers(), lam["BCs"], lam["residual"],
                              s.X_f)[0])
        t32 = float(s.loss_fn_refine(s.net.layers(), lam["BCs"],
                                     lam["residual"], s.X_f)[0])
    assert np.isfinite(t16) and np.isfinite(t32) and t16 != t32
    # fit starts the leg on the bf16 loss, the f32 one its fallback
    seen = {}
    real = collocation.fit_lbfgs

    def spy(loss_fn, *a, **kw):
        seen.update(loss_fn=loss_fn, fallback=kw.get("loss_fn_fallback"))
        return real(loss_fn, *a, **kw)

    monkeypatch.setattr(collocation, "fit_lbfgs", spy)
    s.fit(tf_iter=4, newton_iter=4, chunk=2)
    assert seen["loss_fn"] is s.loss_fn
    assert seen["fallback"] is s.loss_fn_refine
    assert np.isfinite(s.losses[-1]["Total Loss"])


def test_refine_loss_aliases_without_fused_dtype():
    s = _solver(fused_dtype=None)
    assert s.loss_fn_refine is s.loss_fn
    assert s._refine_residual is s._fused_residual


def test_lbfgs_retreats_from_the_bf16_to_the_f32_objective():
    """A stagnation stop with budget left restarts once on the f32 loss, from
    the best iterate: forced here by a tol_fun no step can beat, so the
    retreat comes after the second chunk (the first has no previous
    value)."""
    s = _solver(minimax_=None)
    s.fit(tf_iter=5)
    shapes = lbfgs.layer_shapes(s.net.layers())
    calls = {"bf16": 0, "f32": 0}

    def counted(loss_fn, name):
        def fn(*a, **kw):
            calls[name] += 1
            return loss_fn(*a, **kw)
        return fn

    fun = lbfgs.lbfgs_objective(counted(s.loss_fn, "bf16"), s.lambdas,
                                s.X_f, shapes)
    fun32 = lbfgs.lbfgs_objective(counted(s.loss_fn_refine, "f32"),
                                  s.lambdas, s.X_f, shapes)
    retreats = []
    x, _, f_best, _, hist = lbfgs.lbfgs_minimize(
        fun, lbfgs.flatten_layers(s.net.layers()), maxiter=6, chunk=2,
        tol_fun=1e300, fun_fallback=fun32, iter0=10,
        on_retreat=retreats.append)
    assert retreats == [14]
    assert len(hist) == 6 and calls["bf16"] > 0 and calls["f32"] > 0
    assert np.isfinite(float(f_best))
    # without a fallback the same stop ends the leg
    retreats = []
    lbfgs.lbfgs_minimize(fun, lbfgs.flatten_layers(s.net.layers()),
                         maxiter=6, chunk=2, tol_fun=1e300,
                         on_retreat=retreats.append)
    assert retreats == []


def test_bf16_lbfgs_refinement_converges_to_f32_gate():
    """The JAX solver's acceptance (tests/test_solver.py): the bf16 Adam ->
    L-BFGS run lands at the f32 run's gate."""
    def run(fd):
        s = _solver(fused=True, fused_dtype=fd, minimax_=None)
        s.fit(tf_iter=40, newton_iter=60, chunk=20)
        return float(s.min_loss["overall"])

    f32, bf16 = run(None), run("bfloat16")
    assert np.isfinite(bf16)
    assert bf16 <= 2.0 * f32 + 1e-3, (bf16, f32)


def test_autotune_builds_every_candidate_in_bf16():
    s = _solver(fused="autotune", n_f=128)
    report = s.autotune_report
    assert set(report["timings_ms"]) == {"generic", "fused"}
    if report["choice"] == "fused":
        assert s._fused_residual is not None
        assert s.loss_fn_refine is not s.loss_fn
    with torch.no_grad():
        X = s.X_f[:32]
        fused = s._fused_flavor("plain")(s.net.layers(), X)
        f32 = s._fused_flavor("plain", f32=True)(s.net.layers(), X)
    assert 0 < float((fused - f32).abs().max())


def ac_problem(pkg, n_f=256, seed=0):
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 64)
    domain.add("t", [0.0, 1.0], 21)
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

    rng = np.random.RandomState(seed)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False]},
              init_weights={"residual": [rng.rand(n_f, 1)],
                            "BCs": [100.0 * rng.rand(64, 1), None]})
    return domain, bcs, f_model, kw


@pytest.mark.parametrize("minimax_", [None, False],
                         ids=["minimax", "unfused"])
def test_bf16_trajectory_matches_jax_solver(minimax_):
    """AC-SA, 20 Adam epochs under fused_dtype="bfloat16" on the carried
    weights and points: the port's plain bf16 flavors against the JAX
    solver's XLA bf16 flavors, per-epoch losses within rtol 5e-3."""
    d, b, f, kw = ac_problem(tdq)
    js = tdq.CollocationSolverND(verbose=False)
    js.compile([2, 32, 32, 1], f, d, b, fused=True, minimax=minimax_,
               fused_dtype="bfloat16", **kw)
    d2, b2, f2, kw2 = ac_problem(tdqt)
    ts = tdqt.CollocationSolverND(verbose=False, device="cpu")
    ts.compile([2, 32, 32, 1], f2, d2, b2, fused="cuda", minimax=minimax_,
               fused_dtype="bfloat16", **kw2)
    assert (js._minimax_kind is None) == (ts._minimax_kind is None)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    js.fit(tf_iter=20)
    ts.fit(tf_iter=20)
    jl = np.array([r["Total Loss"] for r in js.losses])
    tl = np.array([r["Total Loss"] for r in ts.losses])
    print(f"[trajectory {minimax_}] max rel {np.max(np.abs(tl / jl - 1)):.3e}")
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]


# --------------------------------------------------------------------------- #
# 5. serving
# --------------------------------------------------------------------------- #
LADDER = dict(min_bucket=64, max_bucket=256)
SERVE_KINDS = ("u", "d:x:1", "d:x:2", "d:t:1", "residual")


def _surrogates(seed=0):
    rng = np.random.RandomState(seed)
    sizes = [2, 16, 16, 1]
    tree = {"params": {
        f"Dense_{i}": {"kernel": (rng.randn(a, b) * np.sqrt(2.0 / (a + b))
                                  ).astype(np.float32),
                       "bias": (0.1 * rng.randn(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}}
    jf = burgers_problem(tdq, n_f=8)[2]
    tf_ = burgers_problem(tdqt, n_f=8)[2]
    jsur = JSurrogate(tdq.networks.neural_net(sizes),
                      jax.tree_util.tree_map(jnp.asarray, tree), VARS,
                      f_model=jf)
    psur = Surrogate(tdqt.neural_net(sizes, device="cpu"),
                     params_from_jax(tree, device="cpu"), VARS, f_model=tf_)
    return jsur, psur


def _points(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n)],
                    -1).astype(np.float32)


@pytest.fixture(scope="module")
def serve_engines():
    jsur, psur = _surrogates()
    return (jsur.engine(**LADDER),
            jsur.engine(compute_dtype="bfloat16", **LADDER),
            psur.engine(**LADDER),
            psur.engine(compute_dtype="bfloat16", **LADDER))


@pytest.mark.parametrize("spec", SERVE_KINDS)
def test_bf16_engine_tracks_the_f32_engine(serve_engines, spec):
    _, _, p32, p16 = serve_engines
    X = _points(300, seed=3)
    a, b = p16.op_for(spec)(X), p32.op_for(spec)(X)
    err = scaled(a, b)
    assert 0 < err <= VALUES, err  # really the bf16 program, in band


@pytest.mark.parametrize("spec", SERVE_KINDS)
def test_bf16_engine_matches_jax_bf16_engine(serve_engines, spec):
    j32, j16, _, p16 = serve_engines
    X = _points(100, seed=4)
    got, want, want32 = (p16.op_for(spec)(X), j16.op_for(spec)(X),
                         j32.op_for(spec)(X))
    assert scaled(got, want) <= VALUES
    assert nearer_bf16([got], [want], [want32])


def test_bf16_engine_out_of_reach_order_is_the_f32_program(serve_engines):
    _, _, p32, p16 = serve_engines
    X = _points(70, seed=5)
    np.testing.assert_array_equal(p16.derivative(X, "x", 5),
                                  p32.derivative(X, "x", 5))
    # the program cache stays bounded by kinds x rungs
    assert p16.compile_cache_size <= (len(SERVE_KINDS) + 1) * p16.n_buckets


def test_bf16_engine_takes_torch_dtype_and_rejects_others():
    _, psur = _surrogates()
    eng = psur.engine(compute_dtype=BF16, **LADDER)
    assert eng.u(_points(10)).shape == (10, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        psur.engine(compute_dtype="float16")


def test_bf16_engine_refuses_a_non_mlp():
    sizes = [2, 16, 1]
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 8)
    domain.add("t", [0.0, 1.0], 4)
    net = tdqt.networks.FourierMLP(sizes, n_frequencies=4, device="cpu")
    sur = Surrogate(net, net.layers(), VARS)
    sur.engine(**LADDER)  # the f32 engine serves it
    with pytest.raises(ValueError, match="standard float32 tanh MLP"):
        sur.engine(compute_dtype="bfloat16", **LADDER)
