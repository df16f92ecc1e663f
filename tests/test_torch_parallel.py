"""Data parallelism of the forward solver (``compile(dist=...)``,
:mod:`tensordiffeq_tpu_torch.parallel`) on the CPU.

* the layout (``shard_data_inputs``: rank blocks, the trim and its log, a
  BC λ never split) and the per-rank batching (``make_batches`` with a
  group against the JAX package's ``make_batches(mesh=)`` index map, row
  for row), as pure functions;
* two gloo processes (``tests/torch_dist_harness.py``) train the
  Allen-Cahn SA micro problem of ``tests/test_torch_solver.py`` from the
  JAX solver's initial parameters: one ``update_loss`` (rtol 1e-6, the JAX
  package's ``tests/test_parallel.py`` band, against the JAX solver's first
  epoch record, the loss at the same parameters), 10 Adam epochs with
  per-point λ, 5 L-BFGS iterations, ``batch_sz`` and ``remat``, each held
  to the JAX solver at ``dist=2`` and to the port at world 1 within the
  parity band (rtol 5e-3, as ``tests/test_torch_solver.py``), and the
  fused minimax step (K3's plain flavor) and ``grad_clip`` (the λ group
  clipped by its norm over both ranks' per-point λ) held to the port at
  world 1; the two ranks' parameters are bit-identical after every fit;
  ``Grad_norm`` is the world-1 norm, and of two ranks' run loggers on one
  directory only the coordinator's writes (each epoch once, the global
  loss), also for a group without rank 0;
* world 1 (``dist=True`` with no process group) is bit for bit the
  non-dist solver;
* the options that need a global statistic (causal bins, NTK traces)
  compile and train under ``dist``.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.parallel import make_mesh as jax_mesh
from tensordiffeq_tpu.training.fit import make_batches as jax_make_batches
from tensordiffeq_tpu_torch import parallel
from tensordiffeq_tpu_torch.telemetry import (RunLogger, TrainingTelemetry,
                                              read_events)
from tensordiffeq_tpu_torch.training.fit import (batch_index_map,
                                                 make_batches)
from tensordiffeq_tpu_torch.weights import params_from_jax

from test_torch_solver import LAYERS, N_F, RTOL, ac_problem
from torch_dist_harness import start

torch.set_num_threads(1)
EPOCHS, NEWTON, BATCH = 10, 5, 64


def fake_mesh(size: int, rank: int) -> parallel.DataMesh:
    """A :class:`DataMesh` of ``size`` ranks seen from ``rank``, with no
    process group (the layout functions read only its shape)."""
    mesh = object.__new__(parallel.DataMesh)
    mesh.group, mesh.ranks, mesh.size, mesh.rank = None, tuple(
        range(size)), size, rank
    mesh.backend, mesh.device = None, torch.device("cpu")
    return mesh


# --------------------------------------------------------------------------- #
# the layout, pure
# --------------------------------------------------------------------------- #
def test_shard_data_inputs_blocks_trim_and_bc_lambda(tmp_path):
    n = 11
    X = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)
    lam_res = torch.arange(n, dtype=torch.float32).reshape(n, 1) \
        .requires_grad_(True)
    lam_bc = torch.ones(n, 1).requires_grad_(True)  # same length as N
    got = []
    with RunLogger(str(tmp_path / "run")):
        for r in range(2):
            Xl, lams = parallel.shard_data_inputs(
                X, {"residual": [lam_res, None], "BCs": [lam_bc]},
                mesh=fake_mesh(2, r))
            got.append((Xl, lams))
    for r, (Xl, lams) in enumerate(got):
        rows = slice(5 * r, 5 * r + 5)  # 11 -> 10 rows, 5 per rank
        assert torch.equal(Xl, X[rows])
        assert torch.equal(lams["residual"][0].detach(), lam_res[rows].detach())
        assert lams["residual"][0].requires_grad
        assert lams["residual"][0].is_leaf
        assert lams["residual"][1] is None
        assert lams["BCs"][0] is lam_bc  # never split, even at length N
    trims = read_events(str(tmp_path / "run"), kind="parallel")
    assert [(e["n_before"], e["n_after"], e["devices"]) for e in trims] \
        == [(11, 10, 2)] * 2


@pytest.mark.parametrize("n_f,batch_sz,permute", [
    (256, 64, False), (256, 64, True), (250, 48, True), (256, 63, False)])
def test_make_batches_rank_map_is_jax_row_for_row(n_f, batch_sz, permute):
    X = np.random.RandomState(0).rand(n_f, 2).astype(np.float32)
    _, idx_j, nb_j = jax_make_batches(jax.numpy.asarray(X), batch_sz,
                                      mesh=jax_mesh(jax.devices()[:2]),
                                      verbose=False, permute=permute)
    idx_j = np.asarray(idx_j)
    glob = batch_index_map(n_f, batch_sz, 2, permute=permute, verbose=False)
    np.testing.assert_array_equal(glob, idx_j)
    k, n_l = idx_j.shape[1] // 2, n_f // 2
    for r in range(2):
        Xb, idx, nb = make_batches(torch.from_numpy(X[r * n_l:(r + 1) * n_l]),
                                   batch_sz, verbose=False, permute=permute,
                                   mesh=fake_mesh(2, r))
        assert nb == nb_j
        np.testing.assert_array_equal(idx.numpy() + r * n_l,
                                      idx_j[:, r * k:(r + 1) * k])
        np.testing.assert_array_equal(Xb.numpy(), X[idx_j[:, r * k:(r + 1) * k]])


# --------------------------------------------------------------------------- #
# two gloo ranks against JAX dist=2 and the port at world 1
# --------------------------------------------------------------------------- #
WORKER = '''
import hashlib
sys.path.insert(0, os.path.dirname(OUT))
from problem import ac_problem, LAYERS
init = np.load(os.path.join(os.path.dirname(OUT), "init.npz"))
layers = [(torch.from_numpy(init["W" + str(i)]),
           torch.from_numpy(init["b" + str(i)]))
          for i in range(len(LAYERS) - 1)]


def solver(**kw):
    d, b, f, ckw = ac_problem(tdqt)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(LAYERS, f, d, b, fused="cuda",
              **dict(dict(minimax=False, dist=True), **kw), **ckw)
    s.net.load_layers([(W.clone(), b_.clone()) for W, b_ in layers])
    return s


def record(tag, s, extra=None):
    h = hashlib.sha256()
    for t in s.net.params():
        h.update(t.detach().numpy().tobytes())
    RESULT[tag] = dict(hist=[r["Total Loss"] for r in s.losses],
                       params=h.hexdigest(), engine=s.engine,
                       n_local=int(s.X_f.shape[0]), **(extra or {}))


s = solver()
total, comps = s.update_loss()
RESULT["update_loss"] = dict(total=float(total),
                             comps={k: float(v) for k, v in comps.items()})
s.fit(tf_iter=EPOCHS, chunk=5)
record("adam", s)
s.fit(newton_iter=NEWTON)
record("lbfgs", s)
s = solver()
s.fit(tf_iter=3, batch_sz=BATCH, chunk=3)
record("batch", s, dict(n_batches=s._adam.n_batches))
s = solver(remat=True)
s.fit(tf_iter=EPOCHS, chunk=5)
record("remat", s)
s = solver(minimax=True)
s.fit(tf_iter=EPOCHS, chunk=5)
record("minimax", s)
# the global norm: clipping the λ group, and the recorded Grad_norm, with
# both ranks' run loggers on one directory
from tensordiffeq_tpu_torch.telemetry import RunLogger
s = solver()
run = RunLogger(os.path.join(os.path.dirname(OUT), "run"))
s.fit(tf_iter=4, chunk=2, grad_clip=0.5, telemetry=run)
run.close()
record("clip", s, dict(grad_norm=[r["Grad_norm"] for r in s.losses]))
# a group without rank 0: its coordinator (rank 1) writes the run log;
# creating the group is collective, so rank 0 takes part and is refused
try:
    s = solver(dist=[1])
except ValueError:
    s = None
if s is not None:
    run = RunLogger(os.path.join(os.path.dirname(OUT), "run_sub"))
    s.fit(tf_iter=2, chunk=2, telemetry=run)
    run.close()
    record("sub", s, dict(coordinator=s.mesh.coordinator))
'''.replace("EPOCHS", str(EPOCHS)).replace("NEWTON", str(NEWTON)).replace(
    "BATCH", str(BATCH))

PROBLEM = '''
import numpy as np
N_F, LAYERS, GRID = %d, %r, (64, 21)
''' % (N_F, LAYERS)


def _problem_source() -> str:
    """``ac_problem`` of ``tests/test_torch_solver.py`` for the workers
    (which import nothing of JAX or of the test files)."""
    import inspect
    return PROBLEM + inspect.getsource(ac_problem)


def _history(s):
    return np.array([r["Total Loss"] for r in s.losses])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX solver at dist=2, the port at world 1 and the two ranks, one
    scenario each from the same initial parameters."""
    work = tmp_path_factory.mktemp("dist")
    d, b, f, kw = ac_problem(tdq)

    def jax_solver(**ckw):
        js = tdq.CollocationSolverND(verbose=False)
        js.compile(LAYERS, f, d, b, fused=True, dist=2,
                   **dict(dict(minimax=False), **ckw), **kw)
        return js

    js = jax_solver()
    init = jax.tree_util.tree_map(np.asarray, js.params)
    pairs = params_from_jax(init, device="cpu")
    np.savez(str(work / "init.npz"),
             **{f"{k}{i}": t.numpy() for i, (W, b_) in enumerate(pairs)
                for k, t in (("W", W), ("b", b_))})
    with open(str(work / "problem.py"), "w") as fh:
        fh.write(_problem_source())
    # the ranks train while the JAX solver does
    pending = start(WORKER, str(work), world=2)
    jax_out = {}
    js.fit(tf_iter=EPOCHS, chunk=5)
    # the first epoch's record is the loss at the initial parameters
    jax_out["update_loss"] = js.losses[0]
    jax_out["adam"] = _history(js)
    js.fit(newton_iter=NEWTON)
    jax_out["lbfgs"] = _history(js)
    jb = jax_solver()
    jb.params = jax.tree_util.tree_map(jax.numpy.asarray, init)
    jb.fit(tf_iter=3, batch_sz=BATCH, chunk=3)
    jax_out["batch"] = _history(jb)

    def port(**ckw):
        d2, b2, f2, kw2 = ac_problem(tdqt)
        s = tdqt.CollocationSolverND(verbose=False, device="cpu")
        s.compile(LAYERS, f2, d2, b2, fused="cuda",
                  **dict(dict(minimax=False), **ckw), **kw2)
        s.net.load_layers(params_from_jax(init, device="cpu"))
        return s

    w1 = {}
    s = port()
    w1["update_loss"] = float(s.update_loss()[0])
    s.fit(tf_iter=EPOCHS, chunk=5)
    w1["adam"] = _history(s)
    s.fit(newton_iter=NEWTON)
    w1["lbfgs"] = _history(s)
    s = port()
    s.fit(tf_iter=3, batch_sz=BATCH, chunk=3)
    w1["batch"] = _history(s)
    s = port(minimax=True)
    s.fit(tf_iter=EPOCHS, chunk=5)
    w1["minimax"] = _history(s)
    s = port()
    s.fit(tf_iter=4, chunk=2, grad_clip=0.5,
          telemetry=TrainingTelemetry())
    w1["clip"] = _history(s)
    w1["grad_norm"] = np.array([r["Grad_norm"] for r in s.losses])
    return pending.wait(), jax_out, w1, work


def test_update_loss_matches_jax_and_world_1(runs):
    ranks, jax_out, w1, _ = runs
    jc = jax_out["update_loss"]
    for r in ranks:
        got = r["update_loss"]
        np.testing.assert_allclose(got["total"], w1["update_loss"], rtol=1e-6)
        for k in ("Total Loss", "BC_0", "BC_1", "Residual_0"):
            np.testing.assert_allclose(got["comps"][k], float(jc[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("tag", ["adam", "lbfgs", "batch", "remat",
                                 "minimax", "clip"])
def test_world_2_trajectory_matches_jax_and_world_1(runs, tag):
    ranks, jax_out, w1, _ = runs
    # remat recomputes the same residual: it is held to the plain Adam run;
    # the minimax step is held to the port's own at world 1 (the JAX
    # solver's minimax parity is tests/test_torch_minimax_solver.py's)
    want = "adam" if tag == "remat" else tag
    for r in ranks:
        got = np.array(r[tag]["hist"])
        assert got.shape == w1[want].shape
        if want in jax_out:
            np.testing.assert_allclose(got, jax_out[want], rtol=RTOL)
        np.testing.assert_allclose(got, w1[want], rtol=RTOL)
    assert ranks[0][tag]["n_local"] == N_F // 2
    if tag == "minimax":
        assert ranks[0][tag]["engine"] == "fused-minimax"
    if tag == "batch":
        # 128 rows per rank, 32 per batch: 4 batches
        assert ranks[0][tag]["n_batches"] == N_F // BATCH


@pytest.mark.parametrize("tag", ["adam", "lbfgs", "batch", "remat",
                                 "minimax", "clip"])
def test_ranks_hold_bit_identical_parameters(runs, tag):
    ranks, _, _, _ = runs
    assert ranks[0][tag]["params"] == ranks[1][tag]["params"]
    assert ranks[0][tag]["hist"] == ranks[1][tag]["hist"]


def test_global_grad_norm_and_coordinator_only_run_log(runs):
    ranks, _, w1, work = runs
    for r in ranks:
        # per-point λ of both ranks in the norm: the world-1 norm
        np.testing.assert_allclose(r["clip"]["grad_norm"], w1["grad_norm"],
                                   rtol=1e-4)
    epochs = read_events(str(work / "run"), kind="epoch")
    # rank 0 alone wrote, each epoch once, the global loss
    assert [e["epoch"] for e in epochs] == [0, 1, 2, 3]
    np.testing.assert_array_equal(
        [e["losses"]["Total Loss"] for e in epochs], ranks[0]["clip"]["hist"])
    stats = read_events(str(work / "run"), kind="lambda_stats")
    # the λ summaries cover the group's rows: the same mean on both ranks
    assert len(stats) == 2
    assert stats[-1]["stats"]["residual[0]"]["mean"] > 0


def test_subgroup_without_rank_0_writes_its_run_log(runs):
    ranks, _, _, work = runs
    assert "sub" not in ranks[0]  # not a member of dist=[1]
    sub = ranks[1]["sub"]
    assert sub["coordinator"] and sub["n_local"] == N_F
    epochs = read_events(str(work / "run_sub"), kind="epoch")
    # the group's coordinator, global rank 1, wrote each epoch once
    assert [e["epoch"] for e in epochs] == [0, 1]
    np.testing.assert_array_equal(
        [e["losses"]["Total Loss"] for e in epochs], sub["hist"])


# --------------------------------------------------------------------------- #
# world 1, and what dist refuses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("minimax", [False, None])
def test_world_1_is_bit_for_bit_the_non_dist_solver(minimax):
    out = []
    for dist in (False, True):
        d, b, f, kw = ac_problem(tdqt)
        s = tdqt.CollocationSolverND(verbose=False, device="cpu")
        s.compile(LAYERS, f, d, b, fused="cuda", minimax=minimax, dist=dist,
                  **kw)
        s.fit(tf_iter=6, chunk=3, grad_clip=1.0)
        s.fit(newton_iter=3)
        h = hashlib.sha256()
        for t in s.net.params():
            h.update(t.detach().numpy().tobytes())
        out.append((_history(s).tobytes(), h.hexdigest(),
                    s.lambdas["residual"][0].detach().numpy().tobytes()))
    assert out[0] == out[1]


@pytest.mark.parametrize("kw", [dict(causal_eps=1.0),
                                dict(Adaptive_type=3)])
def test_options_without_a_global_reduction_raise_under_dist(kw):
    """The options whose statistic spans the whole collocation set (the
    causal bins, the NTK traces) reduce it over the group: they compile
    and train under ``dist`` (two ranks against JAX:
    ``tests/test_torch_dist_options.py``)."""
    d, b, f, skw = ac_problem(tdqt)
    if kw.get("Adaptive_type") == 3:
        skw = {}
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile(LAYERS, f, d, b, dist=True, **dict(skw, **kw))
    assert s.mesh is not None and s.mesh.size == 1
    s.fit(tf_iter=2, chunk=2)
    assert np.isfinite(_history(s)).all()
    if "causal_eps" in kw:
        assert 0.0 < s.losses[-1]["Causal_w_last_0"] <= 1.0
    else:
        assert len(s.ntk_updates) == 1


def test_mesh_and_resampler_default_to_the_card():
    """``make_mesh``, ``resolve_mesh`` and ``make_residual_resampler``
    resolve their device as every entry point does: the card unless the
    caller passes ``device="cpu"`` (they defaulted to the CPU before)."""
    from tensordiffeq_tpu_torch.ops.resampling import make_residual_resampler
    from tensordiffeq_tpu_torch.utils import CudaUnavailableError

    def resampler(**kw):
        return make_residual_resampler(lambda p, X: X[:, :1], np.array(
            [[-1.0, 1.0], [0.0, 1.0]]), 16, **kw)

    if torch.cuda.is_available():
        assert parallel.make_mesh().device.type == "cuda"
        assert parallel.resolve_mesh(True).device.type == "cuda"
    else:
        for call in (parallel.make_mesh, lambda: parallel.resolve_mesh(True),
                     resampler):
            with pytest.raises(CudaUnavailableError):
                call()
    assert parallel.make_mesh(device="cpu").device == torch.device("cpu")
    assert parallel.resolve_mesh(1, device="cpu").size == 1
    X = resampler(device="cpu")([], 0)
    assert X.shape == (16, 2) and X.device.type == "cpu"
