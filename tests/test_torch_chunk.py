"""The port's device-resident chunk on the CPU: minibatching, gradient
clipping, the L-BFGS memory over a device counter, and the CUDA-graph
bookkeeping (``tensordiffeq_tpu_torch/training/{fit,lbfgs,graphs}.py``).

* ``fit(tf_iter, batch_sz)`` against the JAX solver's, with per-point SA λ
  and a ``batch_sz`` that does not divide N_f (the wraparound tail) over
  chunks that restart the batch index: the whole loss history, the final
  parameters and λ within rtol 5e-3 (the engines' cross-check band), and the
  same ``best_epoch``; on the default minimax step and on the unfused loss;
* ``fit(grad_clip)`` against the JAX solver's ``make_optimizer(grad_clip=)``
  at a bound below every step's gradient norm (so every step clips), rtol
  5e-3; and :func:`clip_by_global_norm` against ``optax.clip_by_global_norm``
  on one gradient tree at rtol 1e-6 (f32: one division and one product
  per entry, the norm summed in another order);
* the two-loop sweep over all m slots in the order a device counter gives,
  bit for bit against the skip-unfilled sweep it replaced, over 60
  iterations so the ring of 50 wraps;
* :class:`StepGraph` with a stand-in graph object on the CPU: replays add the
  launches the capture recorded, the stand-in replay of the Adam step
  equals the eager step bit for bit, and a replaced parameter, λ or
  optimizer state drops the graph and captures again.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.ops import cuda_minimax, cuda_taylor
from tensordiffeq_tpu_torch.training import fit as tfit
from tensordiffeq_tpu_torch.training import graphs
from tensordiffeq_tpu_torch.training import lbfgs as tl
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_minimax_solver import allen_cahn

torch.set_num_threads(1)
RTOL = 5e-3
N_F, BATCH = 300, 128  # 3 batches, the last wraps 84 rows to the front


def _pair(minimax=None, n_f=N_F):
    jd, jb, jf, jkw, layers = allen_cahn(tdq, n_f=n_f)
    js = tdq.CollocationSolverND(verbose=False)
    js.compile(layers, jf, jd, jb, minimax=minimax, **jkw)
    td, tb, tf, tkw, _ = allen_cahn(tdqt, n_f=n_f)
    ts = tdqt.CollocationSolverND(verbose=False, device="cpu")
    ts.compile(layers, tf, td, tb, minimax=minimax, **tkw)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    return js, ts


def _history(s):
    return {k: np.array([r[k] for r in s.losses]) for k in s.losses[0]}


def _assert_same_run(js, ts):
    jh, th = _history(js), _history(ts)
    assert set(jh) == set(th)
    for k in jh:
        np.testing.assert_allclose(th[k], jh[k], rtol=RTOL, err_msg=k)
    jp = jax.tree_util.tree_leaves(js.params)
    tp = [t.detach().numpy() for pair in ts.net.layers() for t in pair]
    # flax orders a layer's leaves bias, kernel
    for (jb_, jk), (tk, tb_) in zip(zip(jp[0::2], jp[1::2]),
                                    zip(tp[0::2], tp[1::2])):
        for got, want in ((tk, jk), (tb_, jb_)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=1e-4 * np.abs(want).max())
    for key in ("residual", "BCs"):
        for lt, lj in zip(ts.lambdas[key], js.lambdas[key]):
            if lt is None:
                continue
            np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                                       rtol=RTOL, atol=1e-4)
    assert ts.best_epoch == js.best_epoch


@pytest.mark.parametrize("minimax", [None, False], ids=["minimax", "unfused"])
def test_batched_fit_matches_jax_solver(minimax):
    js, ts = _pair(minimax)
    lam0 = ts.lambdas["residual"][0].detach().clone()
    # 7 epochs in chunks of 3: the batch index restarts at epochs 3 and 6
    kw = dict(tf_iter=7, batch_sz=BATCH, chunk=3)
    js.fit(**kw)
    ts.fit(**kw)
    assert ts._adam.n_batches == 3 and ts._adam.X_batched.shape == (3, BATCH,
                                                                     2)
    assert len(ts.losses) == len(js.losses) == 7
    _assert_same_run(js, ts)
    # every row trained, the wrapped ones too
    assert bool((ts.lambdas["residual"][0].detach() != lam0).all())


def test_make_batches_wraps_the_tail():
    X = torch.arange(10.0).reshape(5, 2)
    Xb, idx, n_b = tfit.make_batches(X, 2, verbose=False)
    assert n_b == 3 and Xb.shape == (3, 2, 2)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [2, 3], [4, 0]])
    np.testing.assert_array_equal(Xb[2].numpy(), X[[4, 0]].numpy())
    Xb, idx, n_b = tfit.make_batches(X, 5, verbose=False)
    assert n_b == 1 and Xb.shape == (1, 5, 2)


def test_grad_clip_matches_jax_solver(monkeypatch):
    bound = 0.05
    norms = []
    clip = tfit.clip_by_global_norm

    def spy(tensors, max_norm):
        grads = [t.grad for t in tensors if t.grad is not None]
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))))
        clip(tensors, max_norm)

    monkeypatch.setattr(tfit, "clip_by_global_norm", spy)
    js, ts = _pair()
    js.fit(tf_iter=12, chunk=5, grad_clip=bound)
    ts.fit(tf_iter=12, chunk=5, grad_clip=bound)
    # the network's and the λ gradients, each step: every one clipped
    assert len(norms) == 24 and min(norms) > bound
    _assert_same_run(js, ts)
    # clipping changed the run
    _, plain = _pair()
    plain.fit(tf_iter=12, chunk=5)
    assert plain.losses[-1]["Total Loss"] != ts.losses[-1]["Total Loss"]


@pytest.mark.parametrize("scale", [0.1, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.RandomState(3)
    grads = [rng.randn(4, 3).astype(np.float32) * scale,
             rng.randn(3).astype(np.float32) * scale]
    max_norm = 1.0
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [np.asarray(g) for g in grads], optax.EmptyState())
    ts = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for t, g in zip(ts, grads):
        t.grad = torch.from_numpy(g.copy())
    tfit.clip_by_global_norm(ts, max_norm)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_grad_clip_toggle_restarts_moments_and_is_checkpointed(tmp_path):
    _, ts = _pair()
    ts.fit(tf_iter=3)
    opt = ts._opt
    ts.fit(tf_iter=2, grad_clip=1.0)
    assert ts._opt is not opt  # clipping on: fresh moments, as in JAX
    opt = ts._opt
    ts.fit(tf_iter=2, grad_clip=2.0)
    assert ts._opt is opt  # another bound keeps them
    ts.save_checkpoint(str(tmp_path / "ck"))
    _, other = _pair()
    other.restore_checkpoint(str(tmp_path / "ck"))
    assert other._opt_grad_clip == 2.0


class _SkipUnfilledMemory:
    """The two-loop sweep as the port ran it before the device counter:
    host-side slots, only the filled ones swept."""

    def __init__(self, x, m):
        self.m, self.count = m, 0
        self.S = torch.zeros((m,) + x.shape, dtype=x.dtype)
        self.Y = torch.zeros_like(self.S)
        self.rho = torch.zeros(m, dtype=x.dtype)
        self.prev_x = self.prev_g = None

    def precondition(self, x, g):
        m, count = self.m, self.count
        if count > 0:
            s, y = x - self.prev_x, g - self.prev_g
            ys = torch.dot(y, s)
            slot = (count - 1) % m
            self.S[slot], self.Y[slot] = s, y
            self.rho[slot] = torch.where(ys == 0, torch.zeros_like(ys),
                                         1.0 / ys)
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0, ys / yy, torch.ones_like(yy))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        self.prev_x, self.prev_g = x, g
        self.count += 1
        start = count % m
        order = [(start + k) % m for k in range(m)][m - min(count, m):]
        v = g.clone()
        alphas = []
        for i in reversed(order):
            a = self.rho[i] * torch.dot(self.S[i], v)
            v.addcmul_(self.Y[i], a, value=-1.0)
            alphas.append(a)
        v = gamma * v
        for i, a in zip(order, reversed(alphas)):
            b = self.rho[i] * torch.dot(self.Y[i], v)
            v.addcmul_(self.S[i], a - b)
        return v


def test_full_sweep_is_bit_identical_to_the_skip_unfilled_sweep():
    g = torch.Generator().manual_seed(0)
    n, m = 37, 50
    x = torch.randn(n, generator=g)
    new, old = tl._Memory(x, m), _SkipUnfilledMemory(x, m)
    for it in range(60):  # the ring wraps after 50 pairs
        x = x + 0.1 * torch.randn(n, generator=g)
        grad = torch.randn(n, generator=g)
        want = old.precondition(x, grad)
        got = new.precondition(x, grad)
        assert torch.equal(got, want), it
    assert int(new.n) == 60 and torch.equal(new.S, old.S)


class StandInGraph:
    """Stands in for a CUDA graph on the CPU.  A capture records the step
    and leaves every tensor it keys as it found them (a capture runs
    nothing on the device); a replay runs the step with the launch counters
    held (a replay runs no Python)."""

    def __init__(self, keyed):
        self.keyed = keyed

    def capture(self, fn):
        saved = [t.detach().clone() for t in self.keyed()]
        fn()
        with torch.no_grad():
            for t, v in zip(self.keyed(), saved):
                t.copy_(v)
        self.fn = fn

    def replay(self):
        held = [(c, c.launches) for c in cuda_taylor.COUNTED]
        self.fn()
        for c, n in held:
            c.launches = n


def test_replays_add_the_captured_launches():
    cuda_taylor.reset_launch_counts()
    t = torch.zeros(())

    def fn():  # a step that launches K3 twice and K1 once
        cuda_minimax.k3_minimax.launches += 2
        cuda_taylor.k1_forward.launches += 1
        t.add_(1)

    sg = graphs.StepGraph(fn, lambda: [t], torch.device("cpu"), "toy",
                          make_graph=lambda stream: StandInGraph(lambda: [t]))
    n0 = len(graphs.captures)
    for _ in range(10):
        sg()
    assert sg.captures == 1 and len(graphs.captures) == n0 + 1
    assert cuda_minimax.k3_minimax.launches == 2 * 10
    assert cuda_taylor.k1_forward.launches == 10
    assert float(t) == 10
    # an eager StepGraph never captures
    eager = graphs.StepGraph(fn, lambda: [t], torch.device("cpu"), "toy",
                             eager=True, make_graph=StandInGraph)
    eager()
    assert eager.captures == 0 and float(t) == 11


def _adam_step(ts, make_graph):
    params = [p for pair in ts.net.layers() for p in pair]
    ts._opt = tfit.make_optimizer(params, ts.lambdas)
    step = tfit.AdamStep(ts.loss_fn, params, ts.lambdas, ts.X_f, ts._opt,
                         verbose=False, make_graph=make_graph)
    return step


def test_stand_in_replay_matches_eager_and_replacement_recaptures():
    _, a = _pair(n_f=128)
    _, b = _pair(n_f=128)
    eager = _adam_step(a, None)
    sb = {}

    def make(stream):
        return StandInGraph(sb["step"]._keyed)

    graphed = sb["step"] = _adam_step(b, make)
    ra = tfit.fit_adam(eager, 8, chunk=4, verbose=False)
    rb = tfit.fit_adam(graphed, 8, chunk=4, verbose=False)
    assert graphed.graph.captures == 1 and eager.graph.captures == 0
    assert [r["Total Loss"] for r in ra.losses] == \
        [r["Total Loss"] for r in rb.losses]
    assert ra.best_epoch == rb.best_epoch
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)

    def replace(t):
        with torch.no_grad():
            t.data = t.data.clone()

    W0 = b.net.layers()[0][0]
    lam = b.lambdas["residual"][0]
    for n, swap in enumerate((
            lambda: replace(W0),
            lambda: replace(lam),
            lambda: b._opt[0].state[W0].update(
                exp_avg=b._opt[0].state[W0]["exp_avg"].clone()))):
        tfit.fit_adam(graphed, 5, chunk=4, verbose=False)
        assert graphed.graph.captures == n + 1  # kept across fits
        swap()
        tfit.fit_adam(graphed, 5, chunk=4, verbose=False)
        assert graphed.graph.captures == n + 2, n
