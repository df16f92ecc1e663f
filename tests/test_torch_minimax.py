"""The fused minimax step of the PyTorch port against the JAX package's.

* the port's ``sq`` (plain flavor, ``ops/minimax.py``) against JAX
  ``build_minimax_sq_fn`` in both its XLA flavor and its Pallas kernel run
  in interpret mode (tile 32, N = 70, so the pad path runs): the value,
  every dW/db leaf, gw = ∂/∂w and gX = ∂/∂X, for an Allen-Cahn-type
  residual (E = 1) and the coupled 2-equation system (E = 2);
* a ``1/x`` residual stays finite (the JAX package's pad-row regression);
* ``residual_columns`` against the JAX one;
* the residual tape K3 interprets (``ops/residual_tape.py``): its Python
  interpreter, forward and reverse, in float64 against autograd of the
  ``f_model``; what it refuses to lower; and K3's algorithm (the table, the
  tape forward, the seeds 2·w·f, the tape reverse, the table's VJP through
  the network) mirrored in float64 against the plain flavor;
* every λ mode of ``make_minimax_residual_loss`` against the port's
  unfused ``build_loss_fn``, in value and in grads w.r.t. params and λ.

Tolerance against JAX: rtol 1e-5 with atol 1e-6 on the value and gw and
1e-5 on dW/db and gX, the band of ``tests/test_pallas.py``; both sides are
float32 and differ only in summation order.  Inside the port (λ modes):
rtol 1e-5, the same two float32 computations in another order.  The
float64 mirrors: 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
from tensordiffeq_tpu.networks import neural_net as jax_net
from tensordiffeq_tpu.ops import pallas_minimax as jmm
from tensordiffeq_tpu.ops.fused import analyze_f_model as jax_analyze
from tensordiffeq_tpu.ops.taylor import extract_mlp_layers
from tensordiffeq_tpu_torch import grad
from tensordiffeq_tpu_torch.models.assembly import build_loss_fn
from tensordiffeq_tpu_torch.networks import mlp_forward
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor, minimax
from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
from tensordiffeq_tpu_torch.ops.residual_tape import (MinimaxLoweringError,
                                                      lower_residual)
from tensordiffeq_tpu_torch.ops.taylor import channel_order, taylor_derivatives
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
VARS = ("x", "t")
N = 70  # 2 tiles of 32 + 6: the Pallas pad path runs
TOL_VALUE = dict(rtol=1e-5, atol=1e-6)  # value and gw
TOL_GRAD = dict(rtol=1e-5, atol=1e-5)   # dW/db and gX


def _residuals(g):
    """The residuals of the tests, written once for either package's
    ``grad`` (``g``)."""

    def ac(u, x, t):
        return (g(u, "t")(x, t) - 0.05 * g(g(u, "x"), "x")(x, t)
                + u(x, t) ** 3 - u(x, t))

    def system(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        f_u = g(u[0], "t")(x, t) + 0.5 * g(g(u[1], "x"), "x")(x, t) + sq * vv
        f_v = g(u[1], "t")(x, t) - 0.5 * g(g(u[0], "x"), "x")(x, t) - sq * uv
        return f_u, f_v

    def singular(u, x, t):
        return g(u, "t")(x, t) + g(u, "x")(x, t) / x

    def burgers(u, x, t):
        return (g(u, "t")(x, t) + u(x, t) * g(u, "x")(x, t)
                - (0.01 / np.pi) * g(g(u, "x"), "x")(x, t))

    return dict(ac=ac, system=system, singular=singular, burgers=burgers)


T_RES = _residuals(grad)
J_RES = _residuals(tdq.grad)
N_OUT = dict(ac=1, system=2, singular=1, burgers=1)


def _setup(case, n=N, seed=0, x_range=None):
    n_out = N_OUT[case]
    net = jax_net([2, 16, 16, n_out])
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2)))
    rng = np.random.RandomState(seed)
    if x_range is None:
        X = (rng.randn(n, 2) * 0.5).astype(np.float32)
    else:
        X = np.stack([rng.uniform(*x_range, n), rng.uniform(-1, 1, n)],
                     1).astype(np.float32)
    E = 2 if case == "system" else 1
    w = rng.rand(n, E).astype(np.float32)
    jl = extract_mlp_layers(params)
    tl = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    return jl, tl, X, w


def _jax_sq(case, jl, X, w, **kw):
    f = J_RES[case]
    shapes = [tuple(W.shape) for W, _ in jl]
    sq = jmm.build_minimax_sq_fn(f, VARS, N_OUT[case],
                                 jax_analyze(f, VARS, N_OUT[case]), shapes,
                                 **kw)
    val, vjp = jax.vjp(sq, jl, jnp.asarray(w), jnp.asarray(X))
    gl, gw, gx = vjp(jnp.ones((), val.dtype))
    return (np.asarray(val), [np.asarray(a) for p in gl for a in p],
            np.asarray(gw), np.asarray(gx))


def _torch_sq(case, tl, X, w):
    f = T_RES[case]
    shapes = [tuple(W.shape) for W, _ in tl]
    sq = minimax.build_minimax_sq_fn(f, VARS, N_OUT[case],
                                     analyze_f_model(f, VARS, N_OUT[case]),
                                     shapes, device="cpu")
    leaves = [t.clone().requires_grad_(True) for p in tl for t in p]
    wt = torch.from_numpy(w).requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    val = sq(list(zip(leaves[0::2], leaves[1::2])), wt, Xt)
    grads = torch.autograd.grad(val, leaves + [wt, Xt])
    return (val.detach().numpy(), [g.numpy() for g in grads[:-2]],
            grads[-2].numpy(), grads[-1].numpy())


@pytest.mark.parametrize("flavor", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("case", ["ac", "system"])
def test_sq_matches_jax(case, flavor):
    jl, tl, X, w = _setup(case)
    kw = {} if flavor == "xla" else dict(use_pallas=True, interpret=True,
                                         tile=32)
    jv, jg, jgw, jgx = _jax_sq(case, jl, X, w, **kw)
    tv, tg, tgw, tgx = _torch_sq(case, tl, X, w)
    np.testing.assert_allclose(tv, jv, **TOL_VALUE)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.reshape(b.shape), b, **TOL_GRAD)
    assert tgw.shape == jgw.shape == (N, 2 if case == "system" else 1)
    np.testing.assert_allclose(tgw, jgw, **TOL_VALUE)
    np.testing.assert_allclose(tgx, jgx, **TOL_GRAD)


def test_singular_residual_stays_finite():
    jl, tl, X, w = _setup("singular", n=40, seed=5, x_range=(0.5, 1.5))
    jv, _, _, _ = _jax_sq("singular", jl, X, w, use_pallas=True,
                          interpret=True, tile=32)
    tv, tg, tgw, tgx = _torch_sq("singular", tl, X, w)
    assert np.isfinite(tv) and all(np.all(np.isfinite(g)) for g in tg)
    assert np.all(np.isfinite(tgw)) and np.all(np.isfinite(tgx))
    np.testing.assert_allclose(tv, jv, **TOL_VALUE)
    # the head's bias never reaches a residual without the primal: its
    # cotangent is zero, not missing
    assert np.all(tg[-1] == 0)


@pytest.mark.parametrize("form", ["array", "1-tuple", "2-tuple"])
def test_residual_columns_matches_jax(form):
    def wrap(f):
        if form == "array":
            return f
        if form == "1-tuple":
            return lambda u, x, t: (f(u, x, t),)
        return lambda u, x, t: (f(u, x, t), 2.0 * f(u, x, t))

    jf, tf = wrap(J_RES["ac"]), wrap(T_RES["ac"])
    reqs = analyze_f_model(tf, VARS, 1)
    want = jmm.residual_columns(jf, VARS, 1, jax_analyze(jf, VARS, 1))
    assert minimax.residual_columns(tf, VARS, 1, reqs) == want
    assert want == (2 if form == "2-tuple" else 1)


def test_residual_columns_rejects_multi_column():
    def jf(u, x, t):
        return (tdq.grad(u[0], "t")(x, t), u(x, t))

    def tf(u, x, t):
        return (grad(u[0], "t")(x, t), u(x, t))

    # the two-output network's whole u is a [N, 2] component
    reqs = {(), (1,)}
    with pytest.raises(ValueError, match="columns"):
        jmm.residual_columns(jf, VARS, 2, reqs)
    with pytest.raises(ValueError, match="columns"):
        minimax.residual_columns(tf, VARS, 2, reqs)


# ------------------------------------------------------------------ #
# the residual tape
# ------------------------------------------------------------------ #
def _sin_forcing(u, x, t):
    uv = u(x, t)
    return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
            + 5.0 * uv ** 3 - 5.0 * uv + torch.sin(3.14 * x) * t)


TAPE_CASES = dict(T_RES, sin=_sin_forcing)


def _requests(name):
    reqs = analyze_f_model(TAPE_CASES[name], VARS,
                           2 if name == "system" else 1)
    assert reqs is not None
    return reqs


@pytest.mark.parametrize("name", ["ac", "burgers", "system", "sin",
                                  "singular"])
def test_tape_interpreter_matches_autograd(name):
    from tensordiffeq_tpu_torch.ops.fused import SymbolicUFn, _TableEngine

    f = TAPE_CASES[name]
    n_out = 2 if name == "system" else 1
    channels = channel_order(_requests(name))
    tape = lower_residual(f, VARS, n_out, channels)
    rng = np.random.RandomState(3)
    n = 11
    cols = [torch.tensor(rng.randn(n), dtype=torch.float64,
                         requires_grad=True)
            for _ in range(len(channels) * n_out)]
    coords = [torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float64,
                           requires_grad=True) for _ in VARS]
    # f_model on a table built from the same columns
    table = {mi: torch.stack(cols[c * n_out:(c + 1) * n_out], 1)
             for c, mi in enumerate(channels)}
    u = SymbolicUFn(_TableEngine(tuple(coords), table), VARS, n_out)
    out = f(u, *coords)
    want = out if isinstance(out, tuple) else (out,)
    regs = tape.forward([c.detach() for c in cols],
                        [c.detach() for c in coords])
    got = [regs[r] for r in tape.outputs]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-10,
                                   atol=1e-10)
    seeds = [torch.tensor(rng.randn(n), dtype=torch.float64) for _ in want]
    g_want = torch.autograd.grad(sum((s * v).sum() for s, v in
                                     zip(seeds, want)), cols + coords,
                                 materialize_grads=True)
    g_tab, g_coord = tape.reverse(regs, seeds)
    for i in range(len(cols)):
        got_i = g_tab.get(i, torch.zeros(n, dtype=torch.float64))
        np.testing.assert_allclose(got_i.numpy(), g_want[i].numpy(),
                                   rtol=1e-10, atol=1e-10)
    for k in range(len(VARS)):
        got_k = g_coord.get(k, torch.zeros(n, dtype=torch.float64))
        np.testing.assert_allclose(got_k.numpy(),
                                   g_want[len(cols) + k].numpy(),
                                   rtol=1e-10, atol=1e-10)


def test_tape_rejects_what_it_cannot_lower():
    def mean_res(u, x, t):
        return u(x, t) - torch.mean(u(x, t))

    def abs_res(u, x, t):
        return torch.abs(grad(u, "t")(x, t))

    channels = channel_order({(), (1,)})
    with pytest.raises(MinimaxLoweringError, match="across points"):
        lower_residual(mean_res, VARS, 1, channels)
    with pytest.raises(MinimaxLoweringError, match="abs"):
        lower_residual(abs_res, VARS, 1, channels)
    # a derivative the table lacks
    with pytest.raises(MinimaxLoweringError, match="lacks"):
        lower_residual(T_RES["ac"], VARS, 1, channels)


def test_tape_counts_and_limits():
    tape = lower_residual(T_RES["singular"], VARS, 1,
                          channel_order({(), (0,), (1,)}))
    # u_x / x (div: 1 forward, 5 reverse), then + u_t (1, 2)
    assert tape.flops() == (2, 7)
    ints, floats = tape.encode()
    assert len(ints) == 3 + cuda_taylor.MAX_TAPE_INPUTS \
        + 3 * cuda_taylor.MAX_TAPE_OPS + cuda_taylor.MAX_EQUATIONS
    assert len(floats) == cuda_taylor.MAX_TAPE_CONSTS

    def long_res(u, x, t):
        v = u(x, t)
        for _ in range(cuda_taylor.MAX_TAPE_OPS):
            v = v * 1.0001 + 0.5
        return v

    with pytest.raises(MinimaxLoweringError, match="at most"):
        lower_residual(long_res, VARS, 1, channel_order({()}))


def _k3_mirror(plan, layers, X, w):
    """K3's algorithm in PyTorch: the plain table, the tape forward, the
    value and gw, the tape reverse from the seeds 2·w·f, then the table
    cotangent back through the network (autograd of the plain table) plus
    the coordinates' direct adjoints."""
    leaves = [t.detach().clone().requires_grad_(True)
              for p in layers for t in p]
    Xl = X.detach().clone().requires_grad_(True)
    table = taylor_derivatives(list(zip(leaves[0::2], leaves[1::2])), Xl,
                               set(plan.channels), flat_matmul=True)
    cols = [table[mi][:, o] for mi in plan.channels
            for o in range(plan.n_out)]
    regs = plan.tape.forward([c.detach() for c in cols],
                             [X[:, k] for k in range(plan.d)])
    f = [regs[r] for r in plan.tape.outputs]
    val = sum((w[:, e] * f[e] ** 2).sum() for e in range(plan.E))
    gw = torch.stack([fe ** 2 for fe in f], 1)
    g_tab, g_coord = plan.tape.reverse(regs, [2 * w[:, e] * f[e]
                                              for e in range(plan.E)])
    grads = torch.autograd.grad(sum((cols[s] * g).sum()
                                    for s, g in g_tab.items()),
                                leaves + [Xl], materialize_grads=True)
    gX = grads[-1].clone()
    for k, g in g_coord.items():
        gX[:, k] += g
    return val, list(grads[:-1]), gw, gX


@pytest.mark.parametrize("name", ["ac", "system", "singular"])
def test_k3_algorithm_matches_plain_flavor(name):
    jl, tl, X, w = _setup(name, x_range=(0.5, 1.5)
                          if name == "singular" else None)
    layers = [(W.double(), b.double()) for W, b in tl]
    Xd, wd = torch.from_numpy(X).double(), torch.from_numpy(w).double()
    f = T_RES[name]
    sq = minimax.build_minimax_sq_fn(f, VARS, N_OUT[name],
                                     analyze_f_model(f, VARS, N_OUT[name]),
                                     [tuple(W.shape) for W, _ in tl],
                                     device="cpu")
    got = _k3_mirror(sq.plan, layers, Xd, wd)
    want = sq.plain([t for p in layers for t in p], wd, Xd)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-10)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a.numpy().ravel(), b.numpy().ravel(),
                                   rtol=1e-10, atol=1e-10)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_cpu_tensors_count_no_launch_and_counts_reset():
    _, tl, X, w = _setup("ac")
    cuda_taylor.reset_launch_counts()
    _torch_sq("ac", tl, X, w)
    assert cuda_minimax.k3_minimax.launches == 0
    cuda_minimax.k3_minimax.launches = 5
    cuda_taylor.reset_launch_counts()
    assert cuda_minimax.k3_minimax.launches == 0


def test_k3_work_counts():
    f = T_RES["singular"]
    reqs = analyze_f_model(f, VARS, 1)
    sq = minimax.build_minimax_sq_fn(f, VARS, 1, reqs,
                                     [(2, 16), (16, 16), (16, 1)],
                                     device="cpu")
    plan = sq.plan
    assert minimax.n_channels(reqs) == plan.C == 3
    k2 = cuda_taylor.flop_count(plan, 10)["k2"]
    # + the head's product 2·C·16·1, the tape (2 + 7) and 5 per equation,
    # all on the CUDA cores (16 wide is narrow)
    assert cuda_minimax.flop_count(plan, 10) == {"k3": {
        "tensor": k2["tensor"],
        "simt": k2["simt"] + 10 * (2 * 3 * 16 + 9 + 5)}}
    # X, w and params in; value, params, gw and gX out
    P = plan.P_total
    assert cuda_minimax.byte_count(plan, 10) == {
        "k3": 4 * (2 * (10 * 2 + 10 * 1 + P) + 1)}


def test_k3_work_counts_at_the_slice():
    """The Allen-Cahn residual at the slice (N = 50,000, 2-128x4-1, C = 4):
    60.33 GFLOP in all, the nine 128-wide hidden products (58.98 GFLOP) on
    the tensor cores, the rest as K2's plus the narrow head and the tape."""
    f = T_RES["ac"]
    shapes = [(2, 128)] + [(128, 128)] * 3 + [(128, 1)]
    sq = minimax.build_minimax_sq_fn(f, VARS, 1, analyze_f_model(f, VARS, 1),
                                     shapes, device="cpu")
    got = cuda_minimax.flop_count(sq.plan, 50_000)["k3"]
    k2 = cuda_taylor.flop_count(sq.plan, 50_000)["k2"]
    assert got["tensor"] == k2["tensor"] == 9 * 50_000 * 2 * 4 * 128 * 128
    assert round(got["tensor"] / 1e9, 2) == 58.98
    assert round((got["tensor"] + got["simt"]) / 1e9, 2) == 60.33
    fwd, rev = sq.plan.tape.flops()
    assert got["simt"] - k2["simt"] == 50_000 * (2 * 4 * 128 + fwd + rev + 5)


# ------------------------------------------------------------------ #
# λ modes against the unfused loss
# ------------------------------------------------------------------ #
MODES = {
    # name: (case, adaptive type, λ shapes, g)
    "no-lambda": ("ac", 0, None, None),
    "type1-per-point": ("ac", 1, [(N, 1)], None),
    "g-transform": ("ac", 1, [(N, 1)], lambda lam: lam ** 2 + 0.5),
    "type2-E1": ("ac", 2, [(1,)], None),
    "type1-E2": ("system", 1, [(N, 1), (N, 1)], None),
    "type2-E2": ("system", 2, [(1,), (1,)], None),
    "type1-E2-one-adaptive": ("system", 1, [(N, 1), None], None),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_lambda_modes_match_unfused_loss(mode):
    case, adaptive, shapes, g = MODES[mode]
    _, tl, X, _ = _setup(case)
    f = T_RES[case]
    n_out = N_OUT[case]
    reqs = analyze_f_model(f, VARS, n_out)
    sq = minimax.build_minimax_sq_fn(f, VARS, n_out, reqs,
                                     [tuple(W.shape) for W, _ in tl],
                                     device="cpu")
    outside = adaptive == 2
    mm = minimax.make_minimax_residual_loss(sq, weight_outside_sum=outside,
                                            g=g)
    kw = dict(weight_outside_sum=outside, g=g, device="cpu")
    unfused = build_loss_fn(mlp_forward, VARS, n_out, f, [], **kw)
    fused = build_loss_fn(mlp_forward, VARS, n_out, f, [],
                          residual_loss_fn=mm, **kw)
    rng = np.random.RandomState(7)
    lam0 = [None if s is None else rng.rand(*s).astype(np.float32) + 0.1
            for s in (shapes or [])]

    def run(loss_fn):
        leaves = [t.clone().requires_grad_(True) for p in tl for t in p]
        lams = [None if lv is None else torch.from_numpy(lv.copy())
                .requires_grad_(True) for lv in lam0]
        total, comps = loss_fn(list(zip(leaves[0::2], leaves[1::2])), [],
                               lams, torch.from_numpy(X))
        ins = leaves + [lam for lam in lams if lam is not None]
        return (float(total.detach()), [gr.numpy() for gr in
                               torch.autograd.grad(total, ins)], comps)

    v_f, g_f, comps = run(fused)
    v_u, g_u, _ = run(unfused)
    assert set(comps) == {"Residual_0", "Total Loss"}
    np.testing.assert_allclose(v_f, v_u, rtol=1e-5)
    assert len(g_f) == len(g_u)
    for a, b in zip(g_f, g_u):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
