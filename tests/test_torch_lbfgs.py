"""The port's L-BFGS (``tensordiffeq_tpu_torch/training/lbfgs.py``).

* the four cases of ``tests/test_lbfgs.py`` on the port: a quadratic,
  Rosenbrock, the tolerance stop and the precision retreat (with a NaN
  first chunk, and a retreat that happens only once);
* algorithm parity with the JAX package's ``lbfgs_minimize`` in float64 on
  both sides (the JAX side under ``jax.enable_x64``): Rosenbrock from
  (-1.2, 1) and an ill-conditioned 20-dimensional convex quadratic, both
  step rules, the per-iteration history and the final iterate over 40
  iterations at rtol 1e-9;
* the zoom line search against optax's own ``scale_by_zoom_linesearch``
  in float64, on cases that reach each of its branches (a first guess that
  overshoots, one that must expand, a search that fails and takes the safe
  step, a trial outside the domain): the step size at rtol 1e-9 and the
  same number of evaluations;
* the evaluation and host-synchronisation counters, and the loop's
  profiler ranges (entered only while a profiler records).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensordiffeq_tpu.training.lbfgs import lbfgs_minimize as jax_lbfgs
from tensordiffeq_tpu_torch.training import lbfgs as tl
from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize

RTOL = 1e-9


def test_quadratic_converges():
    A = torch.tensor([[3.0, 1.0], [1.0, 2.0]])
    b = torch.tensor([1.0, -1.0])

    def fun(x):
        return 0.5 * x @ A @ x - b @ x

    x_star = torch.linalg.solve(A, b)
    x, x_best, f_best, _, hist = lbfgs_minimize(fun, torch.zeros(2),
                                                maxiter=50)
    np.testing.assert_allclose(x_best.numpy(), x_star.numpy(), atol=1e-3)
    assert hist[-1] <= hist[0]


def test_rosenbrock():
    def fun(x):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    _, best, f_best, _, _ = lbfgs_minimize(fun, torch.tensor([-1.2, 1.0]),
                                           maxiter=300)
    assert float(f_best) < 1e-8
    assert np.isclose(float(best[0]), 1.0, atol=1e-3)


def test_early_stop_on_tolerance():
    def fun(x):
        return torch.sum(x ** 2)

    _, _, f_best, _, hist = lbfgs_minimize(fun, torch.ones(3), maxiter=1000,
                                           chunk=10)
    assert len(hist) < 1000  # converged and stopped early
    assert float(f_best) < 1e-10


def test_precision_retreat_on_stagnation():
    """``fun_fallback``: a reduced-precision objective (the iterate rounded
    through bf16) stalls on its quantization floor; with the retreat the
    run finishes on the f32 objective, once, also from a NaN first chunk."""
    target = torch.tensor([1.2345671, 2.3456782, 3.4567893, 4.5678914])

    def fun_f32(x):
        return torch.sum((x - target) ** 2)

    def fun_bf16(x):
        xb = x.to(torch.bfloat16).to(torch.float32)
        return torch.sum((xb - target) ** 2)

    x0 = torch.zeros(4)
    _, _, f_bf, _, _ = lbfgs_minimize(fun_bf16, x0, maxiter=120, chunk=10)
    _, _, f_ret, _, _ = lbfgs_minimize(fun_bf16, x0, maxiter=120, chunk=10,
                                       fun_fallback=fun_f32)
    assert float(f_ret) < 1e-8, float(f_ret)
    assert float(f_ret) < float(f_bf) * 1e-2

    # non-finite from the first chunk: the retreat restarts from x0 (the
    # best iterate's initial copy), not the poisoned last iterate
    def fun_nan(x):
        return torch.sum((x - target) ** 2) * float("nan")

    _, _, f_nan, _, _ = lbfgs_minimize(fun_nan, x0, maxiter=120, chunk=10,
                                       fun_fallback=fun_f32)
    assert float(f_nan) < 1e-8, float(f_nan)

    # at most one retreat: a converged objective re-stagnates and stops
    _, _, f_ok, _, hist = lbfgs_minimize(fun_f32, x0, maxiter=1000,
                                         chunk=10, fun_fallback=fun_f32)
    assert float(f_ok) < 1e-10 and len(hist) < 1000


# --------------------------------------------------------------------------- #
# parity with the JAX package, float64 on both sides
# --------------------------------------------------------------------------- #
def _quadratic(asarray):
    """0.5 xᵀAx − bᵀx with eigenvalues 1 .. 1e4 (log-spaced), a rotation
    and b from a seed; its minimum is not 0, so the history keeps a scale
    the relative tolerance can hold."""
    rng = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rng.randn(20, 20))
    A = Q @ np.diag(np.logspace(0, 4, 20)) @ Q.T
    b = rng.randn(20)
    A, b = asarray(A), asarray(b)

    def fun(x):
        return 0.5 * x @ A @ x - b @ x
    return fun, np.ones(20)


def _rosenbrock(asarray):
    def fun(x):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
    return fun, np.array([-1.2, 1.0])


@pytest.mark.parametrize("eager", [False, True], ids=["zoom", "fixed-step"])
@pytest.mark.parametrize("problem", [_rosenbrock, _quadratic],
                         ids=["rosenbrock", "quadratic20"])
def test_matches_jax_lbfgs_in_float64(problem, eager):
    with jax.enable_x64(True):
        jfun, x0 = problem(jnp.asarray)
        jx, jbest, jf, ji, jhist = jax_lbfgs(
            jfun, jnp.asarray(x0, jnp.float64), maxiter=40, eager=eager)
        jx, jbest = np.asarray(jx), np.asarray(jbest)
        jf, ji = float(jf), int(ji)
    tfun, _ = problem(lambda a: torch.as_tensor(a, dtype=torch.float64))
    x, best, f, i, hist = lbfgs_minimize(
        tfun, torch.as_tensor(x0, dtype=torch.float64), maxiter=40,
        eager=eager)
    assert len(hist) == len(jhist) == 40
    np.testing.assert_allclose(hist, jhist, rtol=RTOL)
    np.testing.assert_allclose(x.numpy(), jx, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(best.numpy(), jbest, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(float(f), jf, rtol=RTOL)
    assert int(i) == ji


def test_jax_rosenbrock_history_starts_as_recorded():
    """The JAX package's own float64 Rosenbrock histories, as checked when
    the port was written: the port reproduces them."""
    tfun, x0 = _rosenbrock(None)
    x0 = torch.tensor(x0, dtype=torch.float64)
    hist = lbfgs_minimize(tfun, x0, maxiter=4)[4]
    np.testing.assert_allclose(hist, [11.2981, 8.2770, 5.8878, 4.8955],
                               rtol=2e-5)
    hist = lbfgs_minimize(tfun, x0, maxiter=3, eager=True)[4]
    np.testing.assert_allclose(hist, [24.2, 121.23, 36.619], rtol=2e-5)


# --------------------------------------------------------------------------- #
# the zoom line search against optax's, float64
# --------------------------------------------------------------------------- #
def _ls_cases():
    A = np.diag([1.0, 10.0, 100.0])
    x0 = np.array([1.0, 1.0, 1.0])

    def quad(lib):
        A_ = lib.asarray(A)
        return lambda x: 0.5 * x @ A_ @ x

    def linear(lib):
        c = lib.asarray(np.array([1.0, 2.0, 3.0]))
        return lambda x: -(c @ x)

    def walled(lib):  # NaN past x[0] = 1.5 (sqrt of a negative number)
        return lambda x: ((x[0] - 1.4) ** 2 + x[1:] @ x[1:]
                          + 0.0 * lib.sqrt(1.5 - x[0]))

    def bowl(lib):
        return lambda x: x @ x + lib.sqrt(1.5 - x[0])

    grad_q = A @ x0
    e0 = np.array([1.0, 0.0, 0.0])
    return {
        # step 1 along -g overshoots the quadratic's minimum: zoom
        "overshoot": (quad, x0, -grad_q, 1.0),
        # a tiny first guess along -g: the interval search doubles it
        "expand": (quad, x0, -grad_q / np.linalg.norm(grad_q), 1e-4),
        # a linear descent never meets the curvature condition: the search
        # runs out of steps and takes the safe step (sufficient decrease)
        "safe-step": (linear, x0, np.array([1.0, 2.0, 3.0]), 1.0),
        # the first trial lands outside the domain (NaN): zoom back in
        "outside-domain": (walled, np.zeros(3), e0, 2.0),
        # not a descent direction: no trial decreases, the search fails and
        # the last trial is taken
        "ascent": (bowl, e0, e0, 1.0),
    }


@pytest.mark.parametrize("case", list(_ls_cases()))
def test_zoom_linesearch_matches_optax(case):
    make, x0, d, guess = _ls_cases()[case]
    with jax.enable_x64(True):
        f = make(jnp)
        x = jnp.asarray(x0, jnp.float64)
        value, grad = jax.value_and_grad(f)(x)
        ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=30)
        state = ls.init(x)._replace(learning_rate=jnp.asarray(guess))
        _, state = ls.update(jnp.asarray(d), state, x, value=value,
                             grad=grad, value_fn=f)
        want_step = float(state.learning_rate)
        want_count = int(state.info.num_linesearch_steps)
        want_value = float(state.value)
    tf = make(torch)
    xt = torch.as_tensor(x0, dtype=torch.float64)
    dt_ = torch.as_tensor(d, dtype=torch.float64)
    ev = tl._Evaluator(tf, xt)
    ev.aim(xt)
    v, g, _ = ev()
    before = tl.lbfgs_minimize.evaluations
    got = tl._ZoomLinesearch(
        ev, xt, dt_, v, g, np.float64(guess), np.float64,
        [torch.dot(dt_, g), torch.linalg.vector_norm(g), v]).run()
    assert tl.lbfgs_minimize.evaluations - before == got.count == want_count
    np.testing.assert_allclose(float(got.stepsize), want_step, rtol=RTOL)
    np.testing.assert_allclose(float(got.value), want_value, rtol=RTOL)
    # each case reaches its branch
    if case in ("safe-step", "ascent"):
        assert want_count == tl.MAX_LINESEARCH_STEPS and got.failed
        assert (float(got.safe_stepsize) > 0) == (case == "safe-step")
    else:
        assert got.done and got.interval_found and want_count >= 2
    if case == "expand":
        assert want_step > 2 * guess
    assert np.isfinite(float(got.value))


def test_counts_evaluations_and_host_syncs():
    """The line-search rule: one host synchronisation per evaluation but the
    first iteration's extra one; the fixed-step rule: one evaluation per
    iteration and one synchronisation per chunk."""
    tfun, x0 = _rosenbrock(None)
    x0 = torch.tensor(x0, dtype=torch.float64)
    e0, s0 = lbfgs_minimize.evaluations, lbfgs_minimize.host_syncs
    hist = lbfgs_minimize(tfun, x0, maxiter=20, chunk=5)[4]
    evals = lbfgs_minimize.evaluations - e0
    syncs = lbfgs_minimize.host_syncs - s0
    assert len(hist) == 20 and evals >= 21 and syncs == evals - 1
    e0, s0 = lbfgs_minimize.evaluations, lbfgs_minimize.host_syncs
    lbfgs_minimize(tfun, x0, maxiter=20, chunk=5, eager=True)
    assert lbfgs_minimize.evaluations - e0 == 20
    assert lbfgs_minimize.host_syncs - s0 == 4


def test_ranges_show_only_under_the_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    tfun, x0 = _rosenbrock(None)
    x0 = torch.tensor(x0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lbfgs_minimize(tfun, x0, maxiter=3)
    e0 = lbfgs_minimize.evaluations
    seen = [e.name for e in prof.events() if e.name.startswith("lbfgs.")]
    assert sorted(set(seen)) == ["lbfgs.direction", "lbfgs.evaluate",
                                 "lbfgs.read"]
    assert seen.count("lbfgs.direction") == 3
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    lbfgs_minimize(tfun, x0, maxiter=3)
    assert entered == [] and lbfgs_minimize.evaluations > e0
