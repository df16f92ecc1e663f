"""The port's serving path on the CPU (``tensordiffeq_tpu_torch.serving``).

* Parity with the JAX package's engine: the same numpy parameters (carried
  across with ``params_from_jax``) and the same points through
  ``tensordiffeq_tpu.serving.Surrogate(...).engine`` and the port's, both
  on the CPU, at n in {17, 64, 100, 300} (padding, an exact bucket, and a
  chunked query) on a 64-256 ladder: ``u`` within 1e-6 scale-relative
  (max |port - JAX| over max |JAX|), ``d:x:1``, ``d:x:2``, ``d:t:1`` and a
  Burgers residual within 1e-5, and a 2-output system's residual tuple
  within 1e-5.  Both sides are float32; the port runs TF32-free IEEE
  matmuls, JAX ``precision=HIGHEST``, and the two libraries sum in other
  orders, so the derivative chains differ in their last bits.
* The port's own contracts: the ladder, the bounded program cache, padding
  and row stability within a rung bit for bit, quarantine and reroute (on
  the eager path and through a stand-in graph), installed programs, the
  artifact (params-only, version gate, roundtrip bit-identical), the
  device rule and the options that are not ported.
* The batcher with an injected clock, retry, breaker and deadlines; the
  ported registry, ``RetryPolicy`` and ``CircuitBreaker`` held to the JAX
  modules on the same inputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.resilience import breaker as jbreaker
from tensordiffeq_tpu.resilience import retry as jretry
from tensordiffeq_tpu.serving import Surrogate as JSurrogate
from tensordiffeq_tpu.telemetry import registry as jregistry
from tensordiffeq_tpu_torch import networks, profiling
from tensordiffeq_tpu_torch.checkpoint import (CheckpointCorrupted,
                                               resolve_checkpoint_dir,
                                               restore_checkpoint,
                                               save_checkpoint)
from tensordiffeq_tpu_torch.resilience import (CircuitBreaker,
                                               CircuitOpenError,
                                               RetryPolicy, retry_call)
from tensordiffeq_tpu_torch.serving import (ArtifactVersionMismatch,
                                            EngineDegraded, RequestBatcher,
                                            RequestTimeout, Surrogate)
from tensordiffeq_tpu_torch.telemetry import MetricsRegistry
from tensordiffeq_tpu_torch.training import graphs
from tensordiffeq_tpu_torch.utils import CudaUnavailableError, NotPortedError
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
SIZES = [2, 16, 16, 1]
SYSTEM_SIZES = [2, 16, 16, 2]
LADDER = dict(min_bucket=64, max_bucket=256)
U_TOL = 1e-6   # u: the forward alone
D_TOL = 1e-5   # derivative chains and residuals
QUERY_NS = (17, 64, 100, 300)
KINDS = ("d:x:1", "d:x:2", "d:t:1", "residual")


# --------------------------------------------------------------------------- #
# shared problems
# --------------------------------------------------------------------------- #
def burgers(pkg):
    grad = pkg.grad

    def f_model(u, x, t):
        u_x, u_t = grad(u, "x"), grad(u, "t")
        return u_t(x, t) + u(x, t) * u_x(x, t) - 0.01 * grad(u_x, "x")(x, t)

    return f_model


def coupled(pkg):
    grad = pkg.grad

    def f_model(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        f_u = (grad(u[0], "t")(x, t)
               + 0.5 * grad(grad(u[1], "x"), "x")(x, t) + sq * vv)
        f_v = (grad(u[1], "t")(x, t)
               - 0.5 * grad(grad(u[0], "x"), "x")(x, t) - sq * uv)
        return f_u, f_v

    return f_model


def flax_tree(sizes, seed=0):
    """A flax MLP parameter tree of numpy arrays, glorot-scaled kernels and
    non-zero biases."""
    rng = np.random.RandomState(seed)
    return {"params": {
        f"Dense_{i}": {
            "kernel": (rng.randn(a, b) * np.sqrt(2.0 / (a + b))
                       ).astype(np.float32),
            "bias": (0.1 * rng.randn(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}}


def points(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-1, 1, n),
                     rng.uniform(0, 1, n)], -1).astype(np.float32)


def surrogates(sizes, f_pair, seed=0):
    tree = flax_tree(sizes, seed)
    jsur = JSurrogate(tdq.networks.neural_net(sizes),
                      jax.tree_util.tree_map(jnp.asarray, tree), ("x", "t"),
                      n_out=sizes[-1], f_model=f_pair[0])
    psur = Surrogate(tdqt.neural_net(sizes, device="cpu"),
                     params_from_jax(tree, device="cpu"), ("x", "t"),
                     n_out=sizes[-1], f_model=f_pair[1])
    return jsur, psur


def scaled(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def engines():
    jsur, psur = surrogates(SIZES, (burgers(tdq), burgers(tdqt)))
    return jsur.engine(**LADDER), psur.engine(**LADDER)


@pytest.fixture
def engine():
    return surrogates(SIZES, (burgers(tdq), burgers(tdqt)))[1].engine(
        **LADDER)


def query(eng, spec, X):
    return eng.op_for(spec)(X)


# --------------------------------------------------------------------------- #
# parity with the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", QUERY_NS)
def test_u_matches_jax_engine(engines, n):
    jeng, peng = engines
    X = points(n, seed=n)
    assert scaled(peng.u(X), jeng.u(X)) <= U_TOL


@pytest.mark.parametrize("n", QUERY_NS)
@pytest.mark.parametrize("spec", KINDS)
def test_kinds_match_jax_engine(engines, spec, n):
    jeng, peng = engines
    X = points(n, seed=n)
    assert scaled(query(peng, spec, X), query(jeng, spec, X)) <= D_TOL


def test_system_residual_tuple_matches_jax_engine():
    jsur, psur = surrogates(SYSTEM_SIZES, (coupled(tdq), coupled(tdqt)),
                            seed=3)
    jeng, peng = jsur.engine(**LADDER), psur.engine(**LADDER)
    X = points(100, seed=5)
    jf, pf = jeng.residual(X), peng.residual(X)
    assert isinstance(pf, tuple) and len(pf) == len(jf) == 2
    for a, b in zip(pf, jf):
        assert scaled(a, b) <= D_TOL
    # a component's derivative, and predict's pair
    assert scaled(peng.derivative(X, "x", 2, component=1),
                  jeng.derivative(X, "x", 2, component=1)) <= D_TOL
    u, f = peng.predict(X)
    assert u.shape == (100, 2) and isinstance(f, tuple)


def test_counters_match_jax_engine(engines):
    jeng, peng = engines
    for eng in (jeng, peng):
        eng.u(points(300, seed=1))
    assert peng.compile_cache_size == jeng.compile_cache_size
    assert peng.quarantined_buckets() == jeng.quarantined_buckets() == {}


# --------------------------------------------------------------------------- #
# the ladder
# --------------------------------------------------------------------------- #
def test_bucket_ladder_and_mapping(engine):
    eng = engine.surrogate.engine(min_bucket=64, max_bucket=512)
    assert eng.bucket_sizes == (64, 128, 256, 512) and eng.n_buckets == 4
    for n, want in ((1, 64), (64, 64), (65, 128), (128, 128),
                    (129, 256), (512, 512), (10_000, 512)):
        assert eng.bucket_for(n) == want, f"bucket_for({n})"


def test_non_pow2_buckets_rejected(engine):
    sur = engine.surrogate
    with pytest.raises(ValueError, match="powers of two"):
        sur.engine(min_bucket=100)
    with pytest.raises(ValueError, match="powers of two"):
        sur.engine(max_bucket=1000)
    with pytest.raises(ValueError, match="min_bucket"):
        sur.engine(min_bucket=512, max_bucket=256)


def test_compile_cache_bounded_under_randomized_shapes(engine):
    rng = np.random.RandomState(7)
    for n in rng.randint(1, 700, size=50):  # every bucket, and chunking
        engine.u(points(int(n), seed=int(n)))
    assert engine.compile_cache_size == engine.n_buckets
    engine.residual(points(10))
    engine.derivative(points(10), "x")
    assert engine.compile_cache_size <= 3 * engine.n_buckets
    counts = engine._metrics.as_dict()["counters"]
    assert counts["serving.engine.compiles{bucket=64,kind=u}"] >= 1


def test_padding_is_deterministic_and_row_stable(engine):
    X = points(100)
    for spec in ("u",) + KINDS:
        a, b = query(engine, spec, X), query(engine, spec, X)
        assert np.array_equal(a, b), spec
        # rows 10..40 alone, and inside 50 rows: the same rung (64), other
        # neighbours and other padding
        alone = query(engine, spec, X[10:40])
        inside = query(engine, spec, X[:50])[10:40]
        assert np.array_equal(alone, inside), spec


def test_engine_rejects_wrong_coordinate_width(engine):
    with pytest.raises(ValueError, match="3 coordinate columns"):
        engine.u(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="coordinate columns"):
        engine.u(np.zeros(4, np.float32))
    assert engine.u(np.zeros(2, np.float32)).shape == (1, 1)


def test_kind_specs_round_trip(engine):
    assert engine.kind_key("d:x:2:0") == ("d", 0, 2, 0)
    assert engine.kind_key("d:t") == ("d", 1, 1, 0)
    assert engine.spec_for(engine.kind_key("d:1:3")) == "d:1:3:0"
    with pytest.raises(ValueError, match="unknown query-kind"):
        engine.kind_key("laplacian")
    with pytest.raises(ValueError, match="component 1 out of range"):
        engine.derivative(points(4), "x", component=1)
    X = points(20)
    assert np.array_equal(engine.op_for("d:x:2")(X),
                          engine.derivative(X, "x", order=2))


# --------------------------------------------------------------------------- #
# quarantine and installed programs
# --------------------------------------------------------------------------- #
def test_first_touch_failure_quarantines_and_reroutes(engine):
    make_fn = engine._make_fn

    def failing_at_64(key):
        make = make_fn(key)

        def make_failing():
            program = make()

            def batched(params, Xb):
                if Xb.shape[0] == 64:
                    raise RuntimeError("rung 64 does not build")
                return program(params, Xb)
            return batched
        return make_failing

    engine._make_fn = failing_at_64
    X = points(30)
    got = engine.u(X)
    assert engine.quarantined_buckets() == {"u": [64]}
    # served by rung 128: the same rows alone on a healthy engine's 128
    ref = engine.surrogate.engine(min_bucket=128, max_bucket=256)
    assert np.array_equal(got, ref.u(X))
    counts = engine._metrics.as_dict()["counters"]
    assert counts["serving.engine.quarantined{bucket=64,kind=u}"] >= 1
    # a quarantined rung stays quarantined in an engine rebuilt from the
    # snapshot
    snap = engine.quarantine_snapshot()
    assert snap == [("u", 64)]
    other = engine.surrogate.engine(**LADDER)
    other.restore_quarantine(json.loads(json.dumps(snap)))
    assert other.quarantined_buckets() == {"u": [64]}
    # a failure on a proven rung is a runtime fault and propagates
    engine._rungs[("u", 128)].program = None
    with pytest.raises(TypeError):
        engine.u(X)


class StandInGraph:
    """Stands in for a CUDA graph on the CPU: a capture records the step, a
    replay runs it; ``fail`` makes the capture raise."""

    fail = False

    def __init__(self, stream):
        pass

    def capture(self, fn):
        if StandInGraph.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        fn()
        self.fn = fn

    def replay(self):
        self.fn()


def test_graph_capture_failure_quarantines_then_degrades(engine,
                                                         monkeypatch):
    engine._make_graph = StandInGraph
    monkeypatch.setattr(StandInGraph, "fail", True)
    X = points(30)
    with pytest.raises(EngineDegraded) as exc:
        engine.u(X)
    assert exc.value.buckets == (64, 128, 256)
    assert engine.quarantined_buckets() == {"u": [64, 128, 256]}
    assert engine.compile_cache_size == 0 and not engine._rungs
    # other kinds keep serving
    monkeypatch.setattr(StandInGraph, "fail", False)
    assert engine.derivative(X, "x").shape == (30,)


def test_stand_in_graphs_match_eager_and_recapture_on_new_params(engine):
    eager = engine.surrogate.engine(**LADDER)
    engine._make_graph = StandInGraph
    n0 = len(graphs.captures)
    X = points(100, seed=2)
    for spec in ("u", "d:x:2", "residual"):
        assert np.array_equal(query(engine, spec, X), query(eager, spec, X))
    rung = engine._rungs[("residual", 128)]
    assert rung.graph.captures == 1
    assert [c["name"] for c in graphs.captures[n0:]] == [
        "serve u b=128", "serve d:0:2:0 b=128", "serve residual b=128"]
    before = query(engine, "residual", X)
    assert rung.graph.captures == 1  # replays only
    # new parameter tensors (both engines serve this surrogate): the graph
    # is dropped and captured again
    sur = engine.surrogate
    sur.params = [(W * 1.5, b) for W, b in sur.params]
    got = query(engine, "residual", X)
    assert rung.graph.captures == 2
    assert np.array_equal(got, query(eager, "residual", X))
    assert not np.array_equal(got, before)


def test_install_aot_and_drop_on_failed_first_use(engine):
    X = points(40)
    calls = []

    def good(params, Xb):
        calls.append(Xb.shape[0])
        return torch.full((Xb.shape[0], 1), 7.0)

    engine.install_aot("u", 64, good)
    assert engine.has_aot("u", 64)
    assert np.array_equal(engine.u(X), np.full((40, 1), 7.0, np.float32))
    assert calls == [64]
    counts = engine._metrics.as_dict()["counters"]
    assert counts["serving.engine.aot_loads{bucket=64,kind=u}"] >= 1

    def bad(params, Xb):
        raise RuntimeError("stale program")

    engine.install_aot("d:x", 64, bad)
    ref = engine.surrogate.engine(**LADDER).derivative(X, "x")
    assert np.array_equal(engine.derivative(X, "x"), ref)
    assert not engine.has_aot("d:x", 64)
    assert engine.quarantined_buckets() == {}
    with pytest.raises(ValueError, match="not on this engine's ladder"):
        engine.install_aot("u", 100, good)


def test_residual_from_installed_programs_without_f_model(engine):
    sur = engine.surrogate
    bare = Surrogate(sur.net, sur.params, sur.varnames)
    eng = bare.engine(**LADDER)
    with pytest.raises(ValueError, match="f_model"):
        eng.residual(points(4))
    eng.install_aot("residual", 64,
                    lambda params, Xb: torch.zeros(Xb.shape[0]))
    assert np.array_equal(eng.residual(points(4)), np.zeros(4, np.float32))
    # rung 128 has no program: quarantined, and 256 the same -> degraded
    with pytest.raises(EngineDegraded):
        eng.residual(points(100))
    assert eng.quarantined_buckets() == {"residual": [128, 256]}


# --------------------------------------------------------------------------- #
# the artifact
# --------------------------------------------------------------------------- #
def make_solver(seed=0):
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 16)
    domain.add("t", [0.0, 1.0], 8)
    domain.generate_collocation_points(128, seed=0)
    bcs = [tdqt.IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]]),
           tdqt.dirichletBC(domain, val=0.0, var="x", target="upper"),
           tdqt.dirichletBC(domain, val=0.0, var="x", target="lower")]
    f_model = burgers(tdqt)
    s = tdqt.CollocationSolverND(verbose=False, seed=seed, device="cpu")
    s.compile([2, 8, 8, 1], f_model, domain, bcs, fused=False)
    return s, f_model


@pytest.fixture(scope="module")
def trained():
    s, f_model = make_solver()
    s.fit(tf_iter=10, chunk=5)
    return s, f_model


def test_export_matches_predict(trained):
    s, _ = trained
    eng = s.export_surrogate().engine(**LADDER)
    X = points(90)
    u_ref, f_ref = s.predict(X)
    u, f = eng.predict(X)
    assert scaled(u, u_ref) <= U_TOL and scaled(f, f_ref) <= D_TOL
    # an exported surrogate is a copy: it does not follow the solver
    assert all(W.data_ptr() != P.data_ptr() for (W, _), (P, _) in
               zip(eng.surrogate.params, s.params))


def test_best_model_export_matches_predict_best(trained):
    s, _ = trained
    X = points(40)
    u_best, _ = s.predict(X, best_model=True)
    eng = s.export_surrogate(best_model=True).engine(min_bucket=64)
    assert scaled(eng.u(X), u_best) <= U_TOL


def test_save_load_roundtrip_bit_identical(trained, tmp_path):
    s, f_model = trained
    sur = s.export_surrogate()
    sur.save(str(tmp_path / "art"), extra_meta={"note": "x"},
             extra_files={"aot/u_64.bin": b"\x01\x02"})
    back = Surrogate.load(str(tmp_path / "art"), f_model=f_model,
                          device="cpu")
    assert back.varnames == ("x", "t") and back.n_out == 1
    assert back.artifact_meta["note"] == "x"
    with open(os.path.join(back.artifact_dir, "aot", "u_64.bin"), "rb") as fh:
        assert fh.read() == b"\x01\x02"
    X = points(90)
    a, b = sur.engine(**LADDER), back.engine(**LADDER)
    assert np.array_equal(a.u(X), b.u(X))
    assert np.array_equal(a.residual(X), b.residual(X))
    assert np.array_equal(a.derivative(X, "t"), b.derivative(X, "t"))


def test_artifact_state_is_params_only(trained, tmp_path):
    s, _ = trained
    s.export_surrogate().save(str(tmp_path / "art"))
    d = resolve_checkpoint_dir(str(tmp_path / "art"))
    with open(os.path.join(d, "tdq_meta.json")) as fh:
        info = json.load(fh)
    meta = info["meta"]
    assert meta["surrogate_format"] == 1 and meta["artifact_version"] == 2
    assert meta["network_type"] == "MLP" and meta["layer_sizes"] == [2, 8,
                                                                     8, 1]
    assert meta["contract"] == "forward" and meta["varnames"] == ["x", "t"]
    # the state tree holds the params and nothing else
    template = {"params": [list(p) for p in s.params]}
    state, _ = restore_checkpoint(str(tmp_path / "art"), template)
    assert list(state) == ["params"] and len(info["leaf_shapes"]) == 6
    sur = Surrogate.load(str(tmp_path / "art"), device="cpu")
    assert sur.f_model is None and sur.coefficients is None


def test_load_without_f_model_serves_u_but_not_residual(trained, tmp_path):
    s, _ = trained
    s.export_surrogate().save(str(tmp_path / "art"))
    eng = Surrogate.load(str(tmp_path / "art"), device="cpu").engine(
        min_bucket=64)
    assert eng.u(points(8)).shape == (8, 1)
    assert eng.derivative(points(8), "x", 2).shape == (8,)
    with pytest.raises(ValueError, match="f_model"):
        eng.residual(points(8))
    u, f = eng.predict(points(8))
    assert f is None


def test_full_training_checkpoint_rejected(trained, tmp_path):
    s, _ = trained
    s.save_checkpoint(str(tmp_path / "full_ck"))
    with pytest.raises(ValueError, match="not a surrogate artifact"):
        Surrogate.load(str(tmp_path / "full_ck"), device="cpu")


def test_artifact_version_mismatch(trained, tmp_path):
    s, _ = trained
    s.export_surrogate().save(str(tmp_path / "art"),
                              extra_meta={"artifact_version": 99,
                                          "network_type": "Unknown"})
    # the gate comes before the network is read
    with pytest.raises(ArtifactVersionMismatch, match="v99") as exc:
        Surrogate.load(str(tmp_path / "art"), device="cpu")
    assert (exc.value.found, exc.value.supported) == (99, 2)


def test_load_model_only_solver_exports_u(trained, tmp_path):
    s, _ = trained
    s.save(str(tmp_path / "net.tdq"))
    other = tdqt.CollocationSolverND(device="cpu")
    other.load_model(str(tmp_path / "net.tdq"))
    sur = other.export_surrogate()
    assert sur.varnames == ("x0", "x1") and sur.f_model is None
    X = points(20)
    assert scaled(sur.engine(**LADDER).u(X), s.predict(X)[0]) <= U_TOL
    with pytest.raises(tdqt.NotCompiledError):
        tdqt.CollocationSolverND(device="cpu").export_surrogate()


def test_extra_files_are_checksummed(tmp_path):
    path = str(tmp_path / "ck")
    state = {"params": [[np.ones((2, 2), np.float32)]]}
    save_checkpoint(path, state, {"k": 1}, extra_files={"a/b.bin": b"abc"})
    save_checkpoint(path, state, {"k": 2}, extra_files={"a/b.bin": b"abd"})
    # tear the newest generation's extra file: restore falls back
    with open(os.path.join(path, "a", "b.bin"), "wb") as fh:
        fh.write(b"xyz")
    _, meta = restore_checkpoint(path, state)
    assert meta == {"k": 1}
    with open(os.path.join(path + ".old", "a", "b.bin"), "wb") as fh:
        fh.write(b"xyz")
    with pytest.raises(CheckpointCorrupted):
        restore_checkpoint(path, state)
    for bad in ("../escape.bin", "tdq_meta.json", "state.npz"):
        with pytest.raises(ValueError):
            save_checkpoint(str(tmp_path / "other"), state,
                            extra_files={bad: b""})


# --------------------------------------------------------------------------- #
# architecture records, the device rule, what is not ported
# --------------------------------------------------------------------------- #
def test_net_metadata_matches_jax_and_rebuilds():
    want = tdq.networks.net_metadata(tdq.networks.neural_net(SIZES),
                                     SIZES, 1)
    got = networks.net_metadata(tdqt.neural_net(SIZES, device="cpu"),
                                SIZES, 1)
    assert got == want
    s, _ = make_solver()
    assert s._arch_meta() == tdq.networks.net_metadata(
        tdq.networks.neural_net([2, 8, 8, 1]), [2, 8, 8, 1], 1)
    net = networks.net_from_metadata(got, device="cpu")
    assert type(net) is networks.MLP and net.layer_sizes == tuple(SIZES)


@pytest.mark.parametrize("ntype,err", [("ResNet", ValueError)])
def test_net_from_metadata_rejects(ntype, err):
    meta = {"network_type": ntype, "activation": "tanh",
            "layer_sizes": SIZES, "n_out": 1}
    with pytest.raises(err):
        networks.net_from_metadata(meta, device="cpu")


def test_default_device_is_the_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    s, f_model = trained
    s.export_surrogate().save(str(tmp_path / "art"))
    with pytest.raises(CudaUnavailableError):
        Surrogate.load(str(tmp_path / "art"), f_model=f_model)
    with pytest.raises(CudaUnavailableError):
        networks.net_from_metadata(s._arch_meta())


@pytest.mark.parametrize("what", ["shard", "from_discovery"])
def test_unported_options_raise(engine, what):
    """Serving options still left out, and the ``DiscoveryModel`` option
    its surrogates need that is still left out: the data-parallel layout
    (``"from_discovery"``).  The discovery contract itself is ported
    (``tests/test_torch_discovery.py``), and so are its lr schedules
    (``tests/test_torch_schedules.py``) and the engine's ``compute_dtype``
    (``tests/test_torch_mixed_precision.py``)."""
    sur = engine.surrogate
    X = np.zeros((8, 2))
    with pytest.raises(NotPortedError, match="ROADMAP"):
        if what == "shard":
            sur.engine(shard=True)
        else:
            tdqt.DiscoveryModel(device="cpu").compile(
                SIZES, lambda u, var, x, t: u(x, t), X, X[:, :1], var=[0.0],
                dist=True, varnames=["x", "t"], verbose=False)


# --------------------------------------------------------------------------- #
# the batcher
# --------------------------------------------------------------------------- #
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make_batcher(max_batch=8, max_latency_s=0.5, **kw):
    calls = []

    def op(X):
        calls.append(X.shape[0])
        return X[:, :1] * 2.0

    clock = FakeClock()
    b = RequestBatcher(op=op, max_batch=max_batch,
                       max_latency_s=max_latency_s, clock=clock,
                       registry=MetricsRegistry(), **kw)
    return b, calls, clock


def test_batcher_flushes_on_max_batch():
    b, calls, _ = make_batcher(max_batch=8)
    h1 = b.submit(points(3))
    h2 = b.submit(points(4))
    assert not calls and not h1.done and b.pending_points == 7
    h3 = b.submit(points(2))
    assert calls == [9]
    assert h1.done and h2.done and h3.done
    assert h1.result().shape == (3, 1) and h3.result().shape == (2, 1)


def test_batcher_flushes_on_deadline():
    b, calls, clock = make_batcher(max_latency_s=0.5)
    b.submit(points(1))
    clock.t = 0.4
    assert not b.poll() and not calls
    clock.t = 0.51
    assert b.poll()
    assert calls == [1]
    assert not b.poll()


def test_batcher_result_forces_flush_and_slices_correctly():
    b, calls, _ = make_batcher(max_batch=100)
    X1, X2 = points(3, seed=1), points(5, seed=2)
    h1, h2 = b.submit(X1), b.submit(X2)
    out2 = h2.result()
    assert calls == [8]
    np.testing.assert_allclose(out2, X2[:, :1] * 2.0)
    np.testing.assert_allclose(h1.result(), X1[:, :1] * 2.0)


def test_batcher_stats_report_qps_and_percentiles():
    b, _, clock = make_batcher(max_batch=4)
    for _ in range(6):
        b.submit(points(1))
        clock.t += 0.01
    b.flush()
    s = b.stats()
    assert s["requests"] == 6 and s["batches"] == 2 and s["points"] == 6
    assert s["qps"] is not None and s["qps"] > 0
    assert set(s["latency_s"]) == {"p50", "p90", "p99"}
    assert all(v is not None for v in s["latency_s"].values())
    snap = b.snapshot()
    assert snap["pending_points"] == 0
    assert snap["stats"]["requests"] == 6


def test_batcher_tuple_results_for_systems():
    b = RequestBatcher(op=lambda X: (X[:, 0], X[:, 1]), max_batch=100,
                       registry=MetricsRegistry())
    h = b.submit(points(4))
    b.flush()
    f1, f2 = h.result()
    assert f1.shape == (4,) and f2.shape == (4,)


def test_batcher_requires_engine_or_op():
    with pytest.raises(ValueError, match="engine or an explicit op"):
        RequestBatcher()


def test_batcher_op_failure_reaches_every_waiter():
    def op(X):
        raise RuntimeError("device fell over")

    b = RequestBatcher(op=op, max_batch=100, registry=MetricsRegistry())
    h1, h2 = b.submit(points(2)), b.submit(points(3))
    with pytest.raises(RuntimeError, match="device fell over"):
        b.flush()
    assert h1.done and h2.done
    for h in (h1, h2):
        with pytest.raises(RuntimeError, match="device fell over"):
            h.result()
    s = b.stats()
    assert s["requests"] == 0 and s["failed"] == 2


def test_batcher_retry_heals_a_transient_failure():
    fails = [2]
    sleeps = []

    def op(X):
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError("transient")
        return X[:, :1]

    b = RequestBatcher(op=op, max_batch=100,
                       retry=RetryPolicy(max_attempts=3, seed=0),
                       sleep=sleeps.append, registry=MetricsRegistry())
    h = b.submit(points(3))
    assert h.result().shape == (3, 1)
    assert len(sleeps) == 2 and b.stats()["retried_ok"] == 1
    # the sleeps are the policy's own jittered schedule
    ref = RetryPolicy(max_attempts=3, seed=0)
    assert sleeps == [ref.delay_s(1), ref.delay_s(2)]


def test_batcher_open_breaker_fast_fails_submits():
    clock = FakeClock()
    reg = MetricsRegistry()
    br = CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                        clock=clock, registry=reg)

    def op(X):
        raise RuntimeError("down")

    b = RequestBatcher(op=op, max_batch=1, breaker=br, clock=clock,
                       registry=reg)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="down"):
            b.submit(points(1))
    assert br.state == "open"
    h = b.submit(points(1))
    assert h.done
    with pytest.raises(CircuitOpenError):
        h.result()
    assert b.stats()["rejected"] == 1


def test_batcher_request_timeout():
    clock = FakeClock()
    reg = MetricsRegistry()
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=100.0,
                        clock=clock, registry=reg)
    br.record_failure()  # open, 100 s of cool-down
    b = RequestBatcher(op=lambda X: X, max_batch=10, breaker=br,
                       request_timeout_s=5.0, clock=clock,
                       sleep=lambda s: setattr(clock, "t", clock.t + s),
                       registry=reg)
    clock.t = 100.0  # the cool-down is over: the submit is admitted
    h = b.submit(points(2))
    br._opened_at = clock.t  # down again before the flush: 100 s more
    with pytest.raises(RequestTimeout) as exc:
        h.result()
    assert exc.value.waited_s >= 5.0
    assert b.stats()["timed_out"] == 1


def test_batcher_through_the_engine(engine):
    X = points(200, seed=9)
    b = RequestBatcher(engine, op=engine.residual, max_batch=64,
                       registry=MetricsRegistry())
    handles = [b.submit(X[i:i + 10]) for i in range(0, 200, 10)]
    got = np.concatenate([h.result() for h in handles])
    # flushes of 70 (at 70 >= 64 pending), 70 and the last 60 points: the
    # same batches through the engine directly, on the same rungs
    ref = np.concatenate([engine.residual(X[a:b])
                          for a, b in ((0, 70), (70, 140), (140, 200))])
    assert b.stats()["batches"] == 3
    assert np.array_equal(got, ref)
    default = RequestBatcher(engine, registry=MetricsRegistry())
    assert np.array_equal(default.submit(X[:5]).result(), engine.u(X[:5]))


# --------------------------------------------------------------------------- #
# the host modules, held to the JAX package's
# --------------------------------------------------------------------------- #
def test_registry_matches_jax_registry():
    rng = np.random.RandomState(0)
    xs = rng.exponential(size=5000)
    regs = (MetricsRegistry(), jregistry.MetricsRegistry())
    for reg in regs:
        h = reg.histogram("latency_s", reservoir=256, kind="u")
        for x in xs:
            h.observe(x)
        reg.counter("points").inc(7)
        reg.scope(phase="adam").gauge("lr").set(5e-3)
        reg.scope(phase="adam").histogram("d").observe_many([1, 2, 3])
    assert regs[0].as_dict() == regs[1].as_dict()
    with pytest.raises(ValueError):
        regs[0].counter("points").inc(-1)
    regs[0].reset()
    assert regs[0].as_dict() == {"counters": {}, "gauges": {},
                                 "histograms": {}}


def test_percentiles_and_stopwatch_match_jax():
    from tensordiffeq_tpu import profiling as jprofiling
    xs = np.random.RandomState(1).rand(37)
    assert profiling.percentiles(xs) == jprofiling.percentiles(xs)
    assert profiling.percentiles([]) == jprofiling.percentiles([])
    with profiling.stopwatch(sync="cpu", verbose=False) as sw:
        pass
    assert sw["elapsed_s"] >= 0.0


def test_retry_policy_matches_jax():
    for kw in ({}, {"jitter": 0.0}, {"seed": 5, "multiplier": 3.0,
                                     "max_delay_s": 0.3}):
        a, b = RetryPolicy(**kw), jretry.RetryPolicy(**kw)
        assert [a.delay_s(k) for k in range(1, 9)] == \
            [b.delay_s(k) for k in range(1, 9)]
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    assert not RetryPolicy(retry_on=(OSError,)).retryable(ValueError())
    # retry_call: two failures, then a value; the counters and sleeps
    for mod_call, mod_policy, reg in (
            (retry_call, RetryPolicy, MetricsRegistry()),
            (jretry.retry_call, jretry.RetryPolicy,
             jregistry.MetricsRegistry())):
        left, sleeps = [2], []

        def fn():
            if left[0]:
                left[0] -= 1
                raise OSError("flaky")
            return 42

        assert mod_call(fn, mod_policy(seed=1), name="op",
                        sleep=sleeps.append, registry=reg) == 42
        assert reg.as_dict()["counters"] == {
            "resilience.retry.attempts{op=op}": 2,
            "resilience.retry.recovered{op=op}": 1}
        def down():
            raise OSError("down")

        with pytest.raises(OSError):
            mod_call(down, mod_policy(max_attempts=2, jitter=0.0),
                     sleep=sleeps.append, registry=reg)


def test_circuit_breaker_matches_jax():
    def drive(mod, regmod):
        clock = FakeClock()
        reg = regmod.MetricsRegistry()
        br = mod.CircuitBreaker(failure_threshold=3, reset_timeout_s=5.0,
                                half_open_max=1, clock=clock, registry=reg)
        trail = []
        for step in ("f", "f", "s", "f", "f", "f", "a", "t3", "a", "t3",
                     "a", "a", "f", "t6", "a", "s", "a"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "a":
                trail.append(br.allow())
            else:
                clock.t += float(step[1:])
            trail.append((br.state, round(br.retry_after_s(), 9)))
        with pytest.raises(mod.CircuitOpenError):
            br.record_failure()
            br.record_failure()
            br.record_failure()
            br.call(lambda: None)
        return trail, reg.as_dict()

    assert drive(tdqt.resilience.breaker, tdqt.telemetry.registry) == \
        drive(jbreaker, jregistry)
