"""Causal and NTK weighting under data parallelism (``compile(dist=...,
causal_eps=...)``, ``compile(dist=..., Adaptive_type=3)``) on the CPU.

Both options need a statistic over the whole collocation set, which the
ranks split:

* causal weighting's per-bin residual sums and counts are summed over the
  ranks by one all-reduce inside the step (``ops/losses.py::
  causal_residual_loss``), and each rank's term is its share of the global
  loss (``models/assembly.py``);
* NTK weighting's residual trace runs over the stride subsample of the
  GLOBAL set, each rank over its rows of it, and the ranks' traces are
  summed (``ops/ntk.py``); the BC traces are replicated.

Two gloo processes (``tests/torch_dist_harness.py``, one spawn for the
module) train each option from the JAX solver's initial parameters; each
history is held to the JAX solver at ``dist=2`` within the parity band
(rtol 5e-3; the JAX solver on its generic engine, the port on the
engine it adopts) and the ranks' parameters are bit-identical.  World 1
(``dist=True`` with no process group) is bit for bit the non-dist solver.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.weights import params_from_jax

from torch_dist_harness import start

torch.set_num_threads(1)
RTOL = 5e-3
EPOCHS = 20
N_F = 256

# the heat problem of tests/test_torch_causal.py (per-point SA λ) and the
# Allen-Cahn problem of tests/test_torch_ntk.py, for both packages and the
# ranks (which import nothing of JAX or of the test files)
PROBLEMS = '''
import numpy as np


def heat(pkg, n_f=256):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    dom.add("x", [-1.0, 1.0], 32)
    dom.add("t", [0.0, 1.0], 8)
    dom.generate_collocation_points(n_f, seed=0)
    init = pkg.IC(dom, [lambda x: np.sin(np.pi * x)], var=[["x"]])
    grad = pkg.grad

    def f_model(u, x, t):
        return grad(u, "t")(x, t) - 0.1 * grad(grad(u, "x"), "x")(x, t)

    rng = np.random.RandomState(0)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [False]},
              init_weights={"residual": [rng.rand(n_f, 1)], "BCs": [None]},
              causal_eps=1.0, causal_bins=8)
    return [2, 16, 16, 1], f_model, dom, [init], kw


def ac(pkg, n_f=256):
    dom = pkg.DomainND(["x", "t"], time_var="t")
    dom.add("x", [-1.0, 1.0], 32)
    dom.add("t", [0.0, 1.0], 8)
    dom.generate_collocation_points(n_f, seed=0)
    grad = pkg.grad

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [pkg.IC(dom, [lambda x: x ** 2 * np.cos(np.pi * x)], var=[["x"]]),
           pkg.periodicBC(dom, ["x"], [deriv_model])]

    def f_model(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)

    # a trace subsample of 64 of the 256 rows: its stride crosses the ranks
    return [2, 8, 8, 1], f_model, dom, bcs, dict(Adaptive_type=3,
                                                  ntk_max_points=64)


PROBLEMS = {"causal": heat, "ntk": ac}
'''

WORKER = '''
import hashlib
sys.path.insert(0, os.path.dirname(OUT))
from problems import PROBLEMS
for tag, build in PROBLEMS.items():
    init = np.load(os.path.join(os.path.dirname(OUT), tag + ".npz"))
    layers, f, d, b, kw = build(tdqt)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(layers, f, d, b, dist=True, **kw)
    s.net.load_layers([(torch.from_numpy(init["W%d" % i]),
                        torch.from_numpy(init["b%d" % i]))
                       for i in range(len(layers) - 1)])
    s.fit(tf_iter=EPOCHS, chunk=5)
    h = hashlib.sha256()
    for t in s.net.params():
        h.update(t.detach().numpy().tobytes())
    RESULT[tag] = dict(
        hist=[r["Total Loss"] for r in s.losses],
        w_last=[r.get("Causal_w_last_0") for r in s.losses],
        weights=[float(v) for v in s.lambdas["BCs"] + s.lambdas["residual"]]
        if tag == "ntk" else None,
        params=h.hexdigest(), engine=s.engine,
        n_local=int(s.X_f.shape[0]))
'''.replace("EPOCHS", str(EPOCHS))


def _namespace() -> dict:
    ns = {}
    exec(PROBLEMS, ns)
    return ns["PROBLEMS"]


def _port(tag, dist=False):
    layers, f, d, b, kw = _namespace()[tag](tdqt)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(layers, f, d, b, dist=dist, **kw)
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks, and the JAX solver at dist=2 from the same initial
    parameters, for each option."""
    work = tmp_path_factory.mktemp("dist_options")
    with open(str(work / "problems.py"), "w") as fh:
        fh.write(PROBLEMS)
    jax_solvers = {}
    for tag, build in _namespace().items():
        layers, f, d, b, kw = build(tdq)
        js = tdq.CollocationSolverND(verbose=False)
        # the JAX referee on its generic engine: its fused engines'
        # compile-time cross-checks are the slow part of this file, and
        # the generic engine is their referee (within about 1e-4)
        js.compile(layers, f, d, b, dist=2, fused=False, **kw)
        pairs = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params),
                                device="cpu")
        np.savez(str(work / f"{tag}.npz"),
                 **{f"{k}{i}": t.numpy() for i, (W, b_) in enumerate(pairs)
                    for k, t in (("W", W), ("b", b_))})
        jax_solvers[tag] = js
    pending = start(WORKER, str(work), world=2, timeout_s=90.0)
    jax_out = {}
    for tag, js in jax_solvers.items():
        js.fit(tf_iter=EPOCHS, chunk=5)
        jax_out[tag] = dict(
            hist=np.array([float(r["Total Loss"]) for r in js.losses]),
            w_last=[float(r["Causal_w_last_0"]) for r in js.losses]
            if tag == "causal" else None,
            weights=[float(np.asarray(v).reshape(())) for v in
                     js.lambdas["BCs"] + js.lambdas["residual"]]
            if tag == "ntk" else None)
    return pending.wait(), jax_out


@pytest.mark.parametrize("tag", ["causal", "ntk"])
def test_world_2_matches_jax_at_dist_2(runs, tag):
    ranks, jax_out = runs
    want = jax_out[tag]
    for r in ranks:
        got = r[tag]
        assert got["n_local"] == N_F // 2
        np.testing.assert_allclose(got["hist"], want["hist"], rtol=RTOL)
        if tag == "causal":
            # the ladder's gate reads the global w_last, the same on each rank
            np.testing.assert_allclose(got["w_last"], want["w_last"],
                                       rtol=RTOL)
            assert got["engine"] == "fused"
        else:
            np.testing.assert_allclose(got["weights"], want["weights"],
                                       rtol=RTOL)
            assert got["engine"] == "fused-minimax"
    assert ranks[0][tag]["params"] == ranks[1][tag]["params"]
    assert ranks[0][tag]["hist"] == ranks[1][tag]["hist"]


@pytest.mark.parametrize("tag", ["causal", "ntk"])
def test_world_1_is_bit_for_bit_the_non_dist_solver(tag):
    out = []
    for dist in (False, True):
        s = _port(tag, dist=dist)
        s.fit(tf_iter=6, chunk=3)
        h = hashlib.sha256()
        for t in s.net.params():
            h.update(t.detach().numpy().tobytes())
        lam = [v.detach().numpy().tobytes()
               for v in s.lambdas["BCs"] + s.lambdas["residual"]
               if v is not None]
        out.append(([r["Total Loss"] for r in s.losses], h.hexdigest(), lam))
    assert out[0] == out[1]
