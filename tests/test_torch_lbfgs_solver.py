"""The solver's L-BFGS leg, ``fit(tf_iter, newton_iter, newton_eager)``,
against the JAX solver's.

The small Allen-Cahn SA problem of ``tests/test_torch_minimax_solver.py``
(N_f = 256, 2-16-16-1), compiled on both sides with the default minimax
step (the JAX solver's ``"xla"`` flavor, the port's plain flavor on the
CPU), from the same parameters (``params_from_jax``).  Both run ``fit(
tf_iter=20, newton_iter=15, chunk=5)``: the L-BFGS history and its best loss
stay within rtol 5e-3 (the engines' cross-check band), for the line search
and for the fixed step; the overall best, ``best_epoch`` and
``newton_done`` match; the λ do not move in the L-BFGS leg.
"""

import jax
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.networks import mlp_forward
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_minimax_solver import allen_cahn

torch.set_num_threads(1)
RTOL = 5e-3
TF_ITER, NEWTON_ITER = 20, 15


def _pair():
    jd, jb, jf, jkw, layers = allen_cahn(tdq)
    js = tdq.CollocationSolverND(verbose=False)
    js.compile(layers, jf, jd, jb, **jkw)
    assert js._minimax_kind == "xla"
    td, tb, tf, tkw, _ = allen_cahn(tdqt)
    ts = tdqt.CollocationSolverND(verbose=False, device="cpu")
    ts.compile(layers, tf, td, tb, **tkw)
    assert ts._minimax_kind == "plain"
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    return js, ts


def _lams(s):
    return [lam for lam in s.lambdas["residual"] + s.lambdas["BCs"]
            if lam is not None]


@pytest.mark.parametrize("eager", [None, True], ids=["zoom", "fixed-step"])
def test_lbfgs_leg_matches_jax_solver(eager):
    js, ts = _pair()
    _, twin = _pair()  # the same Adam leg alone: λ at the leg's end
    kw = dict(tf_iter=TF_ITER, newton_iter=NEWTON_ITER, chunk=5)
    js.fit(newton_eager=eager, **kw)
    ts.fit(newton_eager=eager, **kw)
    lam0 = [lam.detach().clone() for lam in _lams(twin)]
    twin.fit(tf_iter=TF_ITER, chunk=5)
    # the λ ascend in the Adam leg and are frozen in the L-BFGS leg: after
    # it they are bit-identical to the Adam leg's end
    assert not all(torch.equal(a, b.detach())
                   for a, b in zip(lam0, _lams(twin)))
    for a, b in zip(_lams(twin), _lams(ts)):
        assert torch.equal(a.detach(), b.detach())
    jl = np.array([r["Total Loss"] for r in js.losses])
    tl = np.array([r["Total Loss"] for r in ts.losses])
    assert len(tl) == len(jl) == TF_ITER + NEWTON_ITER
    np.testing.assert_allclose(tl[:TF_ITER], jl[:TF_ITER], rtol=RTOL)
    # the whole refinement leg agrees (the line search takes the same
    # branches on both sides here)
    np.testing.assert_allclose(tl[TF_ITER:], jl[TF_ITER:], rtol=RTOL)
    assert ts.newton_done == js.newton_done == NEWTON_ITER
    np.testing.assert_allclose(ts.min_loss["l-bfgs"], js.min_loss["l-bfgs"],
                               rtol=RTOL)
    np.testing.assert_allclose(ts.min_loss["overall"],
                               js.min_loss["overall"], rtol=RTOL)
    assert ts.best_epoch == js.best_epoch
    if eager is None:  # the line search only takes steps that decrease
        assert tl[-1] < tl[TF_ITER - 1]
        assert ts.min_loss["l-bfgs"] < ts.min_loss["adam"]
    # predict(best_model=True) serves the overall best
    X = np.random.RandomState(0).rand(9, 2).astype(np.float32)
    u_best, _ = ts.predict(X, best_model=True)
    with torch.no_grad():
        want = mlp_forward(ts.best_model["overall"], torch.from_numpy(X))
    np.testing.assert_array_equal(u_best, want.numpy())


def test_lbfgs_runs_k3_or_its_plain_flavor_only():
    """On the CPU the minimax step's plain flavor serves every evaluation;
    no kernel launches, and each evaluation is counted."""
    from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor
    from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize
    _, ts = _pair()
    cuda_taylor.reset_launch_counts()
    e0 = lbfgs_minimize.evaluations
    ts.fit(newton_iter=5)
    assert lbfgs_minimize.evaluations - e0 >= 6  # the first iteration: +1
    assert cuda_minimax.k3_minimax.launches == 0
    assert cuda_taylor.k1_forward.launches == cuda_taylor.k2_backward.launches \
        == 0
    assert ts.newton_done == 5 and len(ts.losses) == 5
    assert ts.best_epoch["overall"] == ts.best_epoch["l-bfgs"]
