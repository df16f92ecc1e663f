"""The port's adaptive collocation (``tensordiffeq_tpu_torch/ops/
resampling.py`` and the resampling hooks of ``training/fit.py`` and
``models/collocation.py``) held to the JAX package's.

The port's device redraws draw from a ``torch.Generator``; JAX's stream
cannot be reproduced in torch, so the draws are injected: the same numpy
inputs and JAX's own draws go through both packages' functions.

* ``importance_select`` (host, NumPy): identical indices;
* ``_stratified_pool`` given JAX's permutations and uniforms: rtol 1e-6
  (one f32 product and sum per entry);
* the Gumbel top-k and ``_score_and_select`` given JAX's noise: identical
  indices and points, stats at rtol 1e-6;
* ``carry_rows``: kept rows bit-identical, fresh rows at rtol 1e-6 (f32
  means summed in another order), the drift diagnostic at atol 1e-6;
* the host path: the identical LHS pool, identical indices given JAX's
  scores, and the scores themselves at rtol 5e-3 (the engines'
  cross-check band);
* ``_ascent_move`` with no fresh rows: X at rtol 1e-5 and the scores at
  5e-3 against JAX's, through the minimax hook and through autograd; the
  two hooks agree within 5e-3;
* solver ``fit`` in ascent mode (``resample_uniform=0``) and on the host
  path at ``Adaptive_type=0``: the loss history within 5e-3 of the JAX
  solver's;
* pool-mode invariants: the pending redraw is discarded at the phase's
  end, two solvers from one seed end on one set, a checkpoint taken after
  a swap resumes on the swapped set bit for bit, the λ rows and their
  moments ride the swap, and a swap keeps the Adam step's graph (a
  stand-in graph on the CPU) and equals the eager step bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.ops import resampling as jrs
from tensordiffeq_tpu_torch.ops import resampling as trs
from tensordiffeq_tpu_torch.training import fit as tfit
from tensordiffeq_tpu_torch.utils import NotPortedError
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_chunk import StandInGraph
from test_torch_minimax_solver import burgers

torch.set_num_threads(1)
RTOL = 5e-3
N_F = 200
XL = np.array([[-1.0, 1.0], [0.0, 2.0]])


def _pair(adaptive=True, n_f=N_F, minimax=None):
    """The JAX and the port's Burgers solvers from one set of parameters."""
    jd, jb, jf, jkw, layers = burgers(tdq, n_f=n_f)
    td, tb, tf, tkw, _ = burgers(tdqt, n_f=n_f)
    if not adaptive:
        jkw, tkw = {}, {}
    js = tdq.CollocationSolverND(verbose=False)
    js.compile(layers, jf, jd, jb, minimax=minimax, **jkw)
    ts = tdqt.CollocationSolverND(verbose=False, device="cpu")
    ts.compile(layers, tf, td, tb, minimax=minimax, **tkw)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    return js, ts


def _port(adaptive=True, n_f=N_F, seed=0, **compile_kw):
    d, b, f, kw, layers = burgers(tdqt, n_f=n_f)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu", seed=seed)
    s.compile(layers, f, d, b, **(kw if adaptive else {}), **compile_kw)
    return s


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------------- #
# the selection
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("temp,uniform", [(1.0, 0.1), (2.0, 0.0), (0.5, 1.0)])
def test_importance_select_matches_jax(temp, uniform):
    scores = np.random.RandomState(0).standard_cauchy(500)
    scores[:50] = 0.0
    want = jrs.importance_select(scores, 120, temp=temp, uniform_frac=uniform,
                                 rng=np.random.default_rng(4))
    got = trs.importance_select(scores, 120, temp=temp, uniform_frac=uniform,
                                rng=np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 120
    np.testing.assert_array_equal(trs.importance_select(scores, 600),
                                  np.arange(500))


def _jax_pool_draws(key, n, d):
    ks = jax.random.split(key, 2 * d)
    perms = [np.asarray(jax.random.permutation(ks[2 * j], n))
             for j in range(d)]
    unis = [np.asarray(jax.random.uniform(ks[2 * j + 1], (n,), jnp.float32))
            for j in range(d)]
    return perms, unis


def test_stratified_pool_matches_jax_given_its_draws():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jrs._stratified_pool(key, 64, jnp.asarray(XL)))
    perms, unis = _jax_pool_draws(key, 64, 2)
    got = trs._stratified_pool(None, 64, XL, device="cpu", perms=perms,
                               uniforms=unis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the port's own draws keep the LHS marginals: one sample per stratum
    own = trs._stratified_pool(trs.redraw_generator(0, 5, "cpu"), 64,
                               XL).numpy()
    for j, (lo, hi) in enumerate(XL):
        assert own[:, j].min() >= lo and own[:, j].max() <= hi
        strata = np.floor((own[:, j] - lo) / (hi - lo) * 64).astype(int)
        assert len(np.unique(np.clip(strata, 0, 63))) == 64


def _scores(case):
    rng = np.random.RandomState(1)
    s = rng.rand(400).astype(np.float32)
    if case == "hot":
        s[:40] = 50.0
    elif case == "zeros":  # zero rows stay reachable at uniform_frac=0
        s[100:] = 0.0
    elif case == "degenerate":
        s[:] = 0.0
    elif case == "overflow":
        s[:3] = 3e38
    return s


@pytest.mark.parametrize("case,temp,uniform", [
    ("hot", 1.0, 0.1), ("zeros", 1.0, 0.0), ("degenerate", 1.0, 0.1),
    ("overflow", 2.0, 0.1)])
def test_gumbel_topk_matches_jax_given_its_noise(case, temp, uniform):
    s = _scores(case)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jrs._gumbel_topk_device(jnp.asarray(s), 150, temp,
                                              uniform, key))
    noise = jax.random.gumbel(key, (s.size,), jnp.float32)
    got = trs._gumbel_topk_device(_t(s), 150, temp, uniform,
                                  gumbel=_t(noise)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 150


def test_score_and_select_matches_jax_given_its_noise():
    rng = np.random.RandomState(2)
    n_f, n_pool = 100, 400
    pool = rng.uniform(-1, 1, (n_pool, 2)).astype(np.float32)
    f = (rng.randn(n_pool).astype(np.float32),  # a 2-equation system
         rng.randn(n_pool, 1).astype(np.float32))
    key = jax.random.PRNGKey(11)
    want = jrs._score_and_select(jnp.asarray(pool),
                                 tuple(jnp.asarray(p) for p in f), n_f, 1.0,
                                 0.1, key, None)
    got = trs._score_and_select(
        _t(pool), tuple(_t(p) for p in f), n_f, 1.0, 0.1,
        gumbel=_t(jax.random.gumbel(key, (n_pool,), jnp.float32)))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.kept.numpy(), np.asarray(want.kept))
    np.testing.assert_array_equal(got.X_new.numpy(), np.asarray(want.X_new))
    for k in ("kept_fraction", "score_gain"):
        np.testing.assert_allclose(float(got.stats[k]),
                                   float(want.stats[k]), rtol=1e-6)


# --------------------------------------------------------------------------- #
# the λ carry
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fresh_zero", [False, True])
@pytest.mark.parametrize("case", ["mixed", "all_fresh"])
def test_carry_rows_matches_jax(case, fresh_zero):
    rng = np.random.RandomState(3)
    n_f = 128
    rows = rng.rand(n_f, 1).astype(np.float32)
    idx = (np.sort(rng.choice(4 * n_f, n_f, replace=False)) if case == "mixed"
           else np.arange(n_f, 2 * n_f))
    kept = idx < n_f
    want, want_d = jrs.carry_rows(jnp.asarray(rows), jnp.asarray(idx),
                                  jnp.asarray(kept), fresh_zero=fresh_zero)
    got, got_d = trs.carry_rows(_t(rows), _t(idx), _t(kept),
                                fresh_zero=fresh_zero)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[kept], want[kept])  # bit for bit
    np.testing.assert_allclose(got[~kept], want[~kept], rtol=1e-6)
    # the drift is a difference of two means over their size: each mean's
    # f32 summation order moves it by ~1e-7 absolute, not relative
    np.testing.assert_allclose(float(got_d), float(want_d), rtol=0,
                               atol=1e-6)


def test_carry_rows_small_example():
    rows = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    idx = torch.tensor([0, 2, 5, 7])
    new, drift = trs.carry_rows(rows, idx, idx < 4)
    np.testing.assert_allclose(new.numpy(), [[1.0], [3.0], [2.0], [2.0]])
    np.testing.assert_allclose(float(drift), 0.5 / 2.5, rtol=1e-6)
    new0, _ = trs.carry_rows(rows, idx, idx < 4, fresh_zero=True)
    np.testing.assert_allclose(new0.numpy(), [[1.0], [3.0], [0.0], [0.0]])


# --------------------------------------------------------------------------- #
# the host path
# --------------------------------------------------------------------------- #
def test_host_resampler_matches_jax():
    js, ts = _pair(adaptive=False)
    xl, n_pool, seed, epoch = ts.domain.xlimits, 4 * N_F, 3, 20
    pool_ss, sel_ss = np.random.SeedSequence([seed, epoch]).spawn(2)
    want_pool = tdq.utils.LatinHypercubeSample(
        n_pool, xl, criterion="c", seed=int(pool_ss.generate_state(1)[0]))
    pool, _ = trs._host_pool(n_pool, xl, seed, epoch)
    np.testing.assert_array_equal(pool, want_pool)
    pool32 = np.asarray(pool, np.float32)
    want_s = jrs.residual_scores(js._residual_jit, js.params,
                                 jnp.asarray(pool32))
    got_s = trs.residual_scores(ts._residual, ts.params, _t(pool32))
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL,
                               atol=1e-5 * np.abs(want_s).max())
    want_idx = jrs.importance_select(want_s, N_F,
                                     rng=np.random.default_rng(sel_ss))
    _, rng = trs._host_pool(n_pool, xl, seed, epoch)
    got_idx = trs.importance_select(want_s, N_F, rng=rng)
    np.testing.assert_array_equal(got_idx, want_idx)
    # JAX's resampler kept exactly those pool rows
    X_jax = jrs.make_residual_resampler(js._residual_jit, xl, N_F,
                                        seed=seed)(js.params, epoch)
    np.testing.assert_array_equal(np.asarray(X_jax),
                                  pool32[np.sort(want_idx)])
    X_port = trs.make_residual_resampler(ts._residual, xl, N_F,
                                         seed=seed)(ts.params, epoch)
    assert X_port.shape == (N_F, 2) and X_port.dtype == torch.float32


# --------------------------------------------------------------------------- #
# the ascent mover
# --------------------------------------------------------------------------- #
def _score_grads(js, ts, hook):
    if hook == "minimax":
        jfn, tfn = js._minimax_score_grad_fn(), ts._minimax_score_grad_fn()
        assert jfn is not None and tfn is not None
        return (lambda X: jfn(js.params, X)), (lambda X: tfn(ts.params, X))
    jr = jrs.AscentResampler(js._residual_jit, ts.domain.xlimits, N_F)
    tr = trs.AscentResampler(ts._residual, ts.domain.xlimits, N_F)
    return ((lambda X: jr._score_grad(js.params, X)),
            (lambda X: tr._score_grad(ts.params, X)))


@pytest.mark.parametrize("hook", ["minimax", "autograd"])
def test_ascent_move_matches_jax(hook):
    js, ts = _pair(minimax=True)
    assert js._minimax_kind == "xla" and ts._minimax_kind == "plain"
    jsg, tsg = _score_grads(js, ts, hook)
    X = np.ascontiguousarray(ts.X_f.numpy()[:128])
    jX, js0, js1 = jrs._ascent_move(jsg, jnp.asarray(X), ts.domain.xlimits,
                                    3, 0.005)
    tX, ts0, ts1 = trs._ascent_move(tsg, _t(X), ts.domain.xlimits, 3, 0.005)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-5,
                               atol=1e-6)
    for got, want in ((ts0, js0), (ts1, js1)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=1e-5 * np.abs(want).max())
    assert not np.array_equal(tX.numpy(), X)


def test_ascent_minimax_hook_matches_autograd_path():
    """One evaluation of the minimax step at w ≡ 1 gives what autograd
    over the residual gives: the scores ``Σ f²`` and their point
    gradient."""
    ts = _port(minimax=True)
    X = ts.X_f[:128].clone()
    s_h, g_h = ts._minimax_score_grad_fn()(ts.params, X)
    s_a, g_a = trs.AscentResampler(ts._residual, ts.domain.xlimits,
                                   128)._score_grad(ts.params, X)
    np.testing.assert_allclose(s_h.numpy(), s_a.numpy(), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(g_h.numpy(), g_a.numpy(), rtol=RTOL,
                               atol=1e-5 * float(g_a.abs().max()))


def test_ascent_resampler_moves_points_uphill():
    """The mover on a known landscape (peak at (0, 1)): kept rows climb,
    stay in the box and keep their row (``idx = row``); fresh rows index
    past n_f in row order; the same (seed, epoch) redraws the same."""
    def residual_fn(params, X):
        r2 = X[:, 0] ** 2 + (X[:, 1] - 1.0) ** 2
        return torch.exp(-0.5 * r2)[:, None]

    r = trs.AscentResampler(residual_fn, XL, 64, n_steps=4, step_frac=0.02,
                            fresh_frac=0.25, seed=0)
    X0 = torch.as_tensor(np.random.default_rng(0).uniform(
        [-1, 0], [1, 2], (64, 2)), dtype=torch.float32)
    swap = r.redraw(None, X0, epoch=7)
    X1, kept, idx = swap.X_new.numpy(), swap.kept.numpy(), swap.idx.numpy()
    assert X1.shape == (64, 2) and r.n_fresh == 16
    assert X1[:, 0].min() >= -1 and X1[:, 0].max() <= 1
    assert X1[:, 1].min() >= 0 and X1[:, 1].max() <= 2
    assert kept.sum() == 48
    np.testing.assert_array_equal(idx[kept], np.arange(64)[kept])
    assert sorted(idx[~kept]) == list(range(64, 80))
    d0 = np.linalg.norm(X0.numpy()[kept] - [0, 1], axis=1)
    d1 = np.linalg.norm(X1[kept] - [0, 1], axis=1)
    assert (d1 <= d0 + 1e-6).all() and (d1 < d0 - 1e-4).mean() > 0.9
    assert float(swap.stats["score_gain"]) > 1.0
    again = r.redraw(None, X0, epoch=7)
    assert torch.equal(again.X_new, swap.X_new)
    r0 = trs.AscentResampler(residual_fn, XL, 64, n_steps=0,
                             fresh_frac=0.25, seed=0)
    s0 = r0.redraw(None, X0, epoch=7)
    assert torch.equal(s0.X_new[s0.kept], X0[s0.kept])


# --------------------------------------------------------------------------- #
# the solver
# --------------------------------------------------------------------------- #
def _history(s):
    return np.array([r["Total Loss"] for r in s.losses])


def test_fit_ascent_matches_jax_solver():
    js, ts = _pair()
    kw = dict(tf_iter=30, chunk=10, resample_every=10, resample_mode="ascent",
              resample_uniform=0.0, resample_ascent_steps=3)
    X0 = ts.X_f.clone()
    js.fit(**kw)
    ts.fit(**kw)
    np.testing.assert_allclose(_history(ts), _history(js), rtol=RTOL)
    np.testing.assert_allclose(ts.X_f.numpy(), np.asarray(js.X_f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.lambdas["residual"][0].detach().numpy(),
                               np.asarray(js.lambdas["residual"][0]),
                               rtol=RTOL, atol=1e-4)
    assert not torch.equal(ts.X_f, X0)
    assert [(r["epoch"], r["adopted"]) for r in ts.redraws] == \
        [(10, 20), (20, None)]


def test_fit_host_path_matches_jax_solver():
    js, ts = _pair(adaptive=False)
    kw = dict(tf_iter=30, chunk=10, resample_every=10, resample_seed=3,
              resample_device=False)
    js.fit(**kw)
    ts.fit(**kw)
    np.testing.assert_allclose(_history(ts), _history(js), rtol=RTOL)
    np.testing.assert_array_equal(ts.X_f.numpy(), np.asarray(js.X_f))
    assert [r["adopted"] for r in ts.redraws] == [10, 20]


def test_pending_redraw_is_discarded_at_the_phase_end():
    s = _port()
    X0 = s.X_f.clone()
    s.fit(tf_iter=40, chunk=10, resample_every=30)
    assert torch.equal(s.X_f, X0)
    assert len(s.redraws) == 1 and s.redraws[0]["adopted"] is None
    assert s.redraws[0]["epoch"] == 30


def test_pool_redraws_are_deterministic_and_swap_in_place():
    a, b = _port(), _port()
    X_a = a.X_f
    for s in (a, b):
        s.fit(tf_iter=30, chunk=10, resample_every=10, resample_seed=5)
    assert a.X_f is X_a  # written in place, never replaced
    assert torch.equal(a.X_f, b.X_f) and not torch.equal(
        a.X_f, _port().X_f)
    np.testing.assert_array_equal(_history(a), _history(b))
    assert torch.equal(a.lambdas["residual"][0], b.lambdas["residual"][0])
    assert a.redraws[0]["stats"] == b.redraws[0]["stats"]
    assert 0.0 < a.redraws[0]["stats"]["kept_fraction"] < 1.0
    # a warm restart draws from the epochs already trained: new pools
    X_before = a.X_f.clone()
    a.fit(tf_iter=30, chunk=10, resample_every=10, resample_seed=5)
    assert not torch.equal(a.X_f, X_before)


def test_resume_after_a_swap_is_bit_identical(tmp_path):
    a = _port()
    a.fit(tf_iter=30, chunk=10, resample_every=10)
    assert a.redraws[0]["adopted"] == 20
    a.save_checkpoint(str(tmp_path / "ck"))
    b = _port()
    b.restore_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(b.X_f, a.X_f)
    for s in (a, b):
        s.fit(tf_iter=30, chunk=10, resample_every=10)
    np.testing.assert_array_equal(_history(a), _history(b))
    assert torch.equal(a.X_f, b.X_f)
    assert torch.equal(a.lambdas["residual"][0], b.lambdas["residual"][0])


def test_swap_carries_lambda_rows_and_their_moments():
    s = _port()
    s.fit(tf_iter=3)
    step, lam = s._adam, s.lambdas["residual"][0]
    state = s._opt[1].state[lam]
    old = lam.detach().clone()
    m_old = {k: state[k].clone() for k in ("exp_avg", "exp_avg_sq")}
    swap = trs.DeviceResampler(s._residual, s.domain.xlimits,
                               N_F).redraw(s.params, s.X_f, 1)
    kept = swap.kept
    assert 0 < int(kept.sum()) < N_F
    drift = step.adopt(swap.X_new, swap)
    assert torch.equal(lam.detach()[kept], old[swap.idx[kept]])
    mean_kept = old[swap.idx[kept]].mean(0)
    np.testing.assert_allclose(lam.detach()[~kept].numpy(),
                               np.broadcast_to(mean_kept.numpy(),
                                               (int((~kept).sum()), 1)),
                               rtol=1e-6)
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(state[k][kept], m_old[k][swap.idx[kept]])
        assert not state[k][~kept].any()
    assert torch.equal(s.X_f, swap.X_new) and float(step.best_loss) == \
        float("inf") and float(drift) >= 0.0
    with pytest.raises(ValueError, match="keep N_f"):
        step.adopt(swap.X_new[:-1])


def test_swap_keeps_the_graph_and_matches_eager():
    """A stand-in graph on the CPU: swaps write into the keyed buffers, so
    one capture serves every redraw, and the replays equal the eager
    steps bit for bit."""
    a, b = _port(), _port()
    holder = {}

    def make(stream):
        return StandInGraph(holder["step"]._keyed)

    def step_for(s, make_graph):
        params = [p for pair in s.net.layers() for p in pair]
        s._opt = tfit.make_optimizer(params, s.lambdas)
        return tfit.AdamStep(s.loss_fn, params, s.lambdas, s.X_f, s._opt,
                             verbose=False, make_graph=make_graph)

    eager = step_for(a, None)
    graphed = holder["step"] = step_for(b, make)
    for s, step in ((a, eager), (b, graphed)):
        hook = s._resample_hook(4, 1.0, 0.1, 0, None, "pool", 5)
        r = tfit.fit_adam(step, 40, chunk=5, verbose=False,
                          resample_fn=hook, resample_every=10)
    assert graphed.graph.captures == 1
    assert sum(rec["adopted"] is not None for rec in r.redraws) == 3
    assert torch.equal(a.X_f, b.X_f)
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(a.lambdas["residual"][0], b.lambdas["residual"][0])


def test_resample_validation():
    s = _port()
    with pytest.raises(ValueError, match="resample_mode"):
        s.fit(tf_iter=10, resample_every=5, resample_mode="hillclimb")
    with pytest.raises(ValueError, match="device"):
        s.fit(tf_iter=10, resample_every=5, resample_mode="ascent",
              resample_device=False)
    with pytest.raises(ValueError, match="per-point"):
        s.fit(tf_iter=10, resample_every=5, resample_device=False)


@pytest.mark.parametrize("name", ["FamilyResampler", "FamilyAscentResampler",
                                  "carry_rows_family", "gather_rows_multihost",
                                  "_scores_multihost", "_allgather_by_row"])
def test_unported_resamplers_raise(name):
    with pytest.raises(NotPortedError, match="ROADMAP"):
        getattr(trs, name)(None)
