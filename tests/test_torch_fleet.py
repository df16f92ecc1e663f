"""The port's serving fleet (``tensordiffeq_tpu_torch.fleet``: router,
admission, warm start) held to the JAX package's (``tests/test_fleet.py``'s
cases, one by one) on the CPU.

* Parity with the JAX package, the same numpy parameters on both sides
  (a flax tree carried across by ``weights.params_from_jax``): the same
  ``admit`` sequence on one injected clock gives the same decisions,
  reasons and ``retry_after_s``; fleet-served ``u`` and ``residual`` match
  the JAX ``FleetRouter`` over a JAX AOT artifact within rtol 5e-3 (the
  reference's cross-check band); the port's residual served from the
  lowered tape with no ``f_model`` matches JAX's AOT residual served with
  none, in the same band.
* The port's own contracts: the warm-start block carries the tape
  (``aot/residual_tape.json``) and its op-table digest; a tenant with its
  ``f_model`` is bit for bit a direct engine, one without serves from the
  tape; a blob of another op table is a backend mismatch, never misread;
  an ``f_model`` that does not lower ships no tape; eviction drops an
  engine's graphs; a hot swap under a querying thread drops no waiter; the
  device rule.

The JAX cases' ``aot``/``jit`` counts change meaning here: ``aot`` counts
rungs that run the artifact's tape (the residual rungs of a tenant loaded
with no ``f_model``), ``jit`` rungs that run the engine's own program;
both are captured at load.
"""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu import fleet as jfleet
from tensordiffeq_tpu.serving import Surrogate as JSurrogate
from tensordiffeq_tpu_torch import fleet, telemetry
from tensordiffeq_tpu_torch.checkpoint import (CheckpointCorrupted,
                                               resolve_checkpoint_dir)
from tensordiffeq_tpu_torch.fleet import (AdmissionController,
                                          AdmissionRejected, FleetRouter,
                                          TenantEvicted, TenantPolicy)
from tensordiffeq_tpu_torch.fleet.warmstart import TAPE_FILE, tape_backend
from tensordiffeq_tpu_torch.ops.fused import crosscheck_residuals
from tensordiffeq_tpu_torch.resilience import Chaos, CircuitOpenError
from tensordiffeq_tpu_torch.serving import ArtifactVersionMismatch, Surrogate
from tensordiffeq_tpu_torch.utils import CudaUnavailableError
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
MIN_B, MAX_B = 64, 128  # two-rung ladder: fast captures, real routing
SIZES = [2, 8, 8, 1]
RTOL = 5e-3  # the reference's f32 cross-check band


def burgers(pkg):
    grad = pkg.grad

    def f_model(u, x, t):
        u_x, u_t = grad(u, "x"), grad(u, "t")
        return u_t(x, t) + u(x, t) * u_x(x, t) - 0.01 * grad(u_x, "x")(x, t)

    return f_model


F_MODEL = burgers(tdqt)


def flax_tree(seed):
    rng = np.random.RandomState(seed)
    return {"params": {
        f"Dense_{i}": {
            "kernel": (rng.randn(a, b) * np.sqrt(2.0 / (a + b))
                       ).astype(np.float32),
            "bias": (0.1 * rng.randn(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(SIZES[:-1], SIZES[1:]))}}


def port_surrogate(seed, f_model=F_MODEL):
    return Surrogate(tdqt.neural_net(SIZES, device="cpu"),
                     params_from_jax(flax_tree(seed), device="cpu"),
                     ("x", "t"), n_out=1, f_model=f_model)


def query_points(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-1, 1, n),
                     rng.uniform(0, 1, n)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two port fleet artifacts (tenants of one PDE family, different
    weights), each carrying the residual tape, and the JAX AOT artifact of
    tenant b's weights."""
    root = tmp_path_factory.mktemp("torch_fleet_artifacts")
    out = {"f_model": F_MODEL}
    for name, seed in (("a", 0), ("b", 1)):
        art = str(root / name)
        out["block"] = fleet.export_fleet_artifact(
            port_surrogate(seed), art, min_bucket=MIN_B, max_bucket=MAX_B)
        out[name] = art
    jsur = JSurrogate(tdq.networks.neural_net(SIZES),
                      jax.tree_util.tree_map(jnp.asarray, flax_tree(1)),
                      ("x", "t"), n_out=1, f_model=burgers(tdq))
    out["jax_b"] = str(root / "jax_b")
    jfleet.export_fleet_artifact(jsur, out["jax_b"], min_bucket=MIN_B,
                                 max_bucket=MAX_B)
    return out


def small_policy(**kw):
    return TenantPolicy(min_bucket=MIN_B, max_bucket=MAX_B, max_batch=256,
                        max_latency_s=0.005, **kw)


def router(max_loaded, **kw):
    return FleetRouter(max_loaded=max_loaded, device="cpu", **kw)


def direct_engine(art, f_model=F_MODEL):
    return Surrogate.load(art, f_model=f_model, device="cpu").engine(
        min_bucket=MIN_B, max_bucket=MAX_B)


def engine_compiles():
    """Process-wide first-touch tally (delta-assert against it: the shared
    registry accumulates across tests)."""
    return sum(v for k, v in
               telemetry.default_registry().as_dict()["counters"].items()
               if k.startswith("serving.engine.compiles"))


# --------------------------------------------------------------------------- #
# artifact schema version and the warm-start block
# --------------------------------------------------------------------------- #
def _meta_path(art):
    return os.path.join(resolve_checkpoint_dir(art), "tdq_meta.json")


def test_artifact_carries_schema_version_and_warmstart_block(artifacts):
    with open(_meta_path(artifacts["a"])) as fh:
        meta = json.load(fh)["meta"]
    assert meta["artifact_version"] == 2
    ws = meta["warmstart"]
    assert ws["kinds"] == ["u", "residual"]
    assert ws["min_bucket"] == MIN_B and ws["max_bucket"] == MAX_B
    assert ws["backend"] == tape_backend()
    # every residual rung names the lowered tape, on disk, checksummed
    d = os.path.dirname(_meta_path(artifacts["a"]))
    assert sorted(ws["aot"]) == ["residual"]
    per_bucket = ws["aot"]["residual"]
    assert sorted(per_bucket, key=int) == [str(MIN_B), str(MAX_B)]
    for rel in per_bucket.values():
        assert rel == TAPE_FILE
        with open(os.path.join(d, rel)) as fh:
            blob = json.load(fh)
        assert blob["backend"] == tape_backend()
        assert blob["varnames"] == ["x", "t"] and blob["n_out"] == 1
        assert blob["channels"][0] == []  # the primal first
        assert len(blob["tape"]["outputs"]) == 1


def _copy_with_meta(src, dest, mutate):
    """Clone an artifact and rewrite its meta dict (the meta file is
    outside the checksum domain, so edits do not trip validation)."""
    shutil.copytree(src, dest)
    p = _meta_path(dest)
    with open(p) as fh:
        info = json.load(fh)
    mutate(info["meta"])
    with open(p, "w") as fh:
        json.dump(info, fh)
    return dest


def test_newer_artifact_version_fails_loudly(artifacts, tmp_path):
    art = _copy_with_meta(
        artifacts["a"], str(tmp_path / "future"),
        lambda m: m.update(artifact_version=99))
    with pytest.raises(ArtifactVersionMismatch, match="v99"):
        Surrogate.load(art, device="cpu")


def test_version_absent_backfills_to_v1_and_loads(artifacts, tmp_path):
    def strip(m):  # a pre-fleet artifact
        del m["artifact_version"]
        del m["warmstart"]

    art = _copy_with_meta(artifacts["a"], str(tmp_path / "v1era"), strip)
    sur = Surrogate.load(art, f_model=artifacts["f_model"], device="cpu")
    assert sur.artifact_meta.get("warmstart") is None
    assert sur.engine(min_bucket=MIN_B).u(query_points(8)).shape == (8, 1)


def test_corrupt_aot_blob_fails_artifact_checksum(artifacts, tmp_path):
    """The tape rides the checkpoint payload: a torn blob fails the whole
    generation's checksum instead of silently serving a corrupt
    program."""
    art = str(tmp_path / "torn")
    shutil.copytree(artifacts["a"], art)
    d = os.path.dirname(_meta_path(art))
    victim = os.path.join(d, TAPE_FILE)
    with open(victim, "r+b") as fh:
        fh.write(b"\xde\xad\xbe\xef")
    with pytest.raises(CheckpointCorrupted):
        Surrogate.load(art, device="cpu")


def test_export_refuses_residual_without_f_model_and_unlowerable(tmp_path):
    with pytest.raises(ValueError, match="no f_model"):
        fleet.export_fleet_artifact(port_surrogate(0, f_model=None),
                                    str(tmp_path / "nof"))
    # u alone exports from a surrogate with no f_model
    block = fleet.export_fleet_artifact(port_surrogate(0, f_model=None),
                                        str(tmp_path / "u_only"),
                                        kinds=("u",), min_bucket=MIN_B,
                                        max_bucket=MAX_B)
    assert block["aot"] == {}

    # an f_model outside the tape's whitelist ships no tape: the residual
    # rungs prewarm through the engine's own program (f_model attached)
    def f_abs(u, x, t):
        return torch.abs(tdqt.grad(u, "t")(x, t))

    art = str(tmp_path / "abs")
    block = fleet.export_fleet_artifact(port_surrogate(0, f_model=f_abs),
                                        art, min_bucket=MIN_B,
                                        max_bucket=MAX_B)
    assert block["aot"] == {} and block["kinds"] == ["u", "residual"]
    r = router(1)
    r.register("abs", art, f_model=f_abs, policy=small_policy())
    lt = r.load("abs")
    assert lt.warm["aot"] == 0 and lt.warm["jit"] == 4
    X = query_points(20, seed=4)
    assert np.array_equal(r.query("abs", X, kind="residual"),
                          direct_engine(art, f_abs).residual(X))


def test_tape_of_another_op_table_is_a_backend_mismatch(artifacts,
                                                        tmp_path):
    """A replica whose op table differs from the exporter's must not
    misread the op codes: the block's backend names the table's digest,
    and a mismatch installs no tape (the no-f_model residual then has
    nothing to run)."""
    art = _copy_with_meta(
        artifacts["b"], str(tmp_path / "other_ops"),
        lambda m: m["warmstart"].update(backend="torch-tape/0000"))
    r = router(1)
    r.register("b", art, policy=small_policy())
    lt = r.load("b")
    assert lt.warm["aot"] == 0 and lt.warm["skipped"] == ["residual"]
    assert not lt.engine.has_program("residual", MIN_B)
    with pytest.raises(ValueError, match="no f_model"):
        r.query("b", query_points(4), kind="residual")


# --------------------------------------------------------------------------- #
# LRU artifact cache
# --------------------------------------------------------------------------- #
def test_lru_load_hit_evict(artifacts):
    r = router(2)
    for t in ("a", "b", "c"):
        # cold policy: this test pins LRU mechanics, not warmth
        r.register(t, artifacts[t if t in artifacts else "a"],
                   f_model=artifacts["f_model"],
                   policy=small_policy(warm_start=False))
    r.load("a")
    r.load("b")
    assert r.loaded() == ("a", "b")
    r.load("a")  # refresh: "b" becomes LRU
    assert r.loaded() == ("b", "a")
    lt_b = r._loaded["b"]
    r.load("c")  # evicts "b", not the freshly-touched "a"
    assert r.loaded() == ("a", "c")
    s = r.stats()
    assert s["hits"] == 1 and s["misses"] == 3 and s["evictions"] == 1
    assert not s["tenants"]["b"]["loaded"]
    # the evicted engine dropped its graphs and serves nothing
    assert lt_b.engine._released and lt_b.engine._rungs == {}
    with pytest.raises(RuntimeError, match="released"):
        lt_b.engine.u(query_points(2))


def test_unknown_tenant_and_bad_config():
    r = router(1)
    with pytest.raises(KeyError, match="not registered"):
        r.load("ghost")
    with pytest.raises(ValueError, match="max_loaded"):
        FleetRouter(max_loaded=0, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert FleetRouter().device.type == "cuda"
        return
    with pytest.raises(CudaUnavailableError):
        FleetRouter()
    with pytest.raises(CudaUnavailableError):
        fleet.ReplicaGroup("m:f", nproc=1)


# --------------------------------------------------------------------------- #
# warm start: zero request-time captures, bit-identity
# --------------------------------------------------------------------------- #
def test_warm_start_zero_request_time_compiles(artifacts):
    r = router(2)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy())
    lt = r.load("a")
    # every rung of both kinds first-touched at load: the engine's own
    # programs (the f_model is attached)
    assert lt.warm["aot"] == 0 and lt.warm["jit"] == 4
    before = engine_compiles()
    X = query_points(100, seed=3)
    u = r.query("a", X)
    f = r.query("a", X, kind="residual")
    assert engine_compiles() == before, \
        "warm-started tenant captured at request time"
    assert u.shape == (100, 1) and f.shape == (100,)


def test_fleet_queries_bit_identical_to_direct_engine(artifacts):
    """The chaos-off contract: a fleet-served answer (batcher coalescing,
    admission in front) is bit-identical to the same query on a direct
    engine over the same artifact."""
    r = router(2)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy())
    direct = direct_engine(artifacts["a"])
    for n in (17, 64, 100):  # pad, exact-bucket, and chunk-crossing sizes
        X = query_points(n, seed=n)
        assert np.array_equal(r.query("a", X), direct.u(X))
        assert np.array_equal(r.query("a", X, kind="residual"),
                              direct.residual(X))


def test_aot_residual_serves_without_f_model(artifacts):
    """The tape's payoff: a replica needs NO f_model source.  The policy's
    warm_kinds names only "u": the artifact block's own kinds must win.
    The tape-served residual is the fused arithmetic (K1's table, then the
    tape), within the cross-check band of the generic program, and bit
    for bit a direct engine warm-started alike."""
    r = router(1)
    r.register("b", artifacts["b"],  # no f_model
               policy=small_policy(warm_kinds=["u"]))
    lt = r.load("b")
    assert lt.warm["aot"] == 2 and lt.warm["jit"] == 2
    assert lt.engine.has_program("residual", MIN_B)
    X = query_points(50, seed=5)
    f = r.query("b", X, kind="residual")
    generic = direct_engine(artifacts["b"]).residual(X)
    ok, why = crosscheck_residuals(generic, f, rtol=RTOL)
    assert ok, why
    twin = Surrogate.load(artifacts["b"], device="cpu").engine(
        min_bucket=MIN_B, max_bucket=MAX_B)
    fleet.warm_start(twin)
    assert np.array_equal(f, twin.residual(X))


def test_v1_artifact_warm_starts_via_jit_prewarm(tmp_path, artifacts):
    """A pre-fleet artifact (no warm-start block) still loads and prewarms
    through the engine's own programs, and answers its first query with
    no request-time capture."""
    def strip(m):
        del m["artifact_version"]
        del m["warmstart"]

    art = _copy_with_meta(artifacts["a"], str(tmp_path / "plain"), strip)
    r = router(1)
    r.register("p", art, f_model=artifacts["f_model"],
               policy=small_policy())
    lt = r.load("p")
    assert lt.warm["aot"] == 0 and lt.warm["jit"] == 4
    before = engine_compiles()
    r.query("p", query_points(20))
    assert engine_compiles() == before


# --------------------------------------------------------------------------- #
# quarantine x eviction: no resurrection on reload
# --------------------------------------------------------------------------- #
def test_quarantined_bucket_survives_evict_and_reload(artifacts):
    r = router(1)
    r.register("q", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy())
    with Chaos(compile_fail_buckets=[MIN_B]):
        lt = r.load("q")  # warm drive first-touches every rung
    assert lt.engine.quarantined_buckets() == {
        "u": [MIN_B], "residual": [MIN_B]}
    X = query_points(10, seed=7)
    u_before = r.query("q", X)

    r.evict("q")
    assert r.loaded() == ()
    lt2 = r.load("q")  # NO chaos active now
    assert lt2.engine.quarantined_buckets() == {
        "u": [MIN_B], "residual": [MIN_B]}
    assert lt2.engine.bucket_sizes[0] == MIN_B  # ladder unchanged
    assert np.array_equal(r.query("q", X), u_before)
    # warm start did not drive (or count) the quarantined rungs
    assert lt2.warm["aot"] + lt2.warm["jit"] == 2


# --------------------------------------------------------------------------- #
# admission control (front door)
# --------------------------------------------------------------------------- #
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_admission_rate_limit_token_bucket():
    clock = FakeClock()
    ac = AdmissionController(clock=clock)
    ac.configure("t", rate_qps=2.0, burst=2.0)
    ac.admit("t", 1)
    ac.admit("t", 1)  # burst exhausted
    with pytest.raises(AdmissionRejected) as ei:
        ac.admit("t", 1)
    assert ei.value.reason == "rate_limit" and ei.value.retry_after_s > 0
    clock.t += 0.5  # one token refills at 2/s
    ac.admit("t", 1)
    with pytest.raises(ValueError, match="burst"):
        ac.configure("x", rate_qps=5.0, burst=0.5)
    with pytest.raises(ValueError, match="rate_qps"):
        ac.configure("x", rate_qps=0.0)


def test_admission_tenant_queue_bound():
    ac = AdmissionController()
    ac.configure("t", max_queue_points=100)
    ac.admit("t", 50, tenant_pending=40)
    with pytest.raises(AdmissionRejected) as ei:
        ac.admit("t", 50, tenant_pending=60)
    assert ei.value.reason == "tenant_queue_full"


def test_admission_priority_ordered_shedding():
    ac = AdmissionController(max_pending_points=1000, shed_watermark=0.5)
    with pytest.raises(AdmissionRejected) as ei:
        ac.admit("t", 1, priority=0, fleet_pending=600)
    assert ei.value.reason == "load_shed"
    ac.admit("t", 1, priority=1, fleet_pending=600)
    for p in (0, 1):
        with pytest.raises(AdmissionRejected) as ei:
            ac.admit("t", 1, priority=p, fleet_pending=1000)
        assert ei.value.reason == "fleet_saturated"
    ac.admit("t", 1, priority=2, fleet_pending=1000)
    with pytest.raises(ValueError, match="priority"):
        ac.admit("t", 1, priority=7)


def _admission_trace(pkg_fleet, registry, seed: int) -> list:
    """One seeded sequence of configure/admit/degrade/restore calls on an
    injected clock: every decision as ``(reason or "ok", retry_after_s,
    max_pending_points)``."""
    rng = np.random.RandomState(seed)
    clock = FakeClock()
    ac = pkg_fleet.AdmissionController(max_pending_points=1000,
                                       shed_watermark=0.6, clock=clock,
                                       registry=registry)
    ac.configure("a", rate_qps=5.0, burst=3.0, max_queue_points=300)
    ac.configure("b", rate_qps=50.0, priority=0)
    ac.configure("c", max_queue_points=100, priority=2)
    out = []
    for i in range(300):
        clock.t += float(rng.exponential(0.05))
        if i == 120:
            ac.degrade(0.5)
        if i == 200:
            ac.restore()
        tenant = "abc"[rng.randint(3)]
        pr = rng.choice([None, 0, 1, 2])
        try:
            ac.admit(tenant, int(rng.randint(1, 200)),
                     None if pr is None else int(pr),
                     tenant_pending=int(rng.randint(0, 250)),
                     fleet_pending=int(rng.randint(0, 1100)))
            out.append(("ok", 0.0, ac.max_pending_points))
        except pkg_fleet.AdmissionRejected as e:
            out.append((e.reason, e.retry_after_s, ac.max_pending_points))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_match_jax_on_one_clock(seed):
    """The same admit sequence on one injected clock: the same decisions,
    reasons and retry_after_s (float for float) in both packages."""
    got = _admission_trace(fleet, telemetry.MetricsRegistry(), seed)
    want = _admission_trace(jfleet, tdq.telemetry.MetricsRegistry(), seed)
    assert got == want
    assert {r for r, _, _ in got} >= {"ok", "rate_limit",
                                      "tenant_queue_full"}


def test_router_admission_before_queue_and_load(artifacts):
    """A shed request must not load the tenant, let alone queue points."""
    r = router(1)
    r.register("z", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy(max_queue_points=0))
    with pytest.raises(AdmissionRejected) as ei:
        r.submit("z", query_points(4))
    assert ei.value.reason == "tenant_queue_full"
    assert r.loaded() == ()


# --------------------------------------------------------------------------- #
# per-tenant resilience isolation + fleet chaos faults
# --------------------------------------------------------------------------- #
def test_per_tenant_breaker_isolation(artifacts):
    r = router(2)
    pol = small_policy(breaker_failure_threshold=1)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"], policy=pol)
    r.register("b", artifacts["b"], f_model=artifacts["f_model"], policy=pol)
    lt_a, lt_b = r.load("a"), r.load("b")
    with Chaos(serving_fail_n=1):
        h = r.submit("a", query_points(4))
        with pytest.raises(Exception):
            lt_a.batcher("u").flush()  # injected fault -> breaker opens
        assert h.done and lt_a.breaker.state == "open"
        assert r.query("b", query_points(4)).shape == (4, 1)
        assert lt_b.breaker.state == "closed"
    h2 = r.submit("a", query_points(2))
    assert h2.done
    with pytest.raises(CircuitOpenError):
        h2.result()


def test_eviction_fails_fast_waiters_behind_open_breaker(artifacts):
    r = router(1)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy(breaker_failure_threshold=1,
                                   breaker_reset_timeout_s=3600.0))
    lt = r.load("a")
    h_r = r.submit("a", query_points(2), kind="residual")
    with Chaos(serving_fail_n=1):
        h_u = r.submit("a", query_points(3))
        with pytest.raises(Exception):
            lt.batcher("u").flush()
    assert lt.breaker.state == "open"
    assert h_u.done and not h_r.done
    r.evict("a")
    assert h_r.done
    with pytest.raises(TenantEvicted, match="evicted"):
        h_r.result()
    assert r.loaded() == ()


def test_admission_rate_token_not_burned_by_other_rejections():
    clock = FakeClock()
    ac = AdmissionController(clock=clock)
    ac.configure("t", rate_qps=100.0, burst=2.0, max_queue_points=10)
    for _ in range(5):
        with pytest.raises(AdmissionRejected) as ei:
            ac.admit("t", 5, tenant_pending=10)
        assert ei.value.reason == "tenant_queue_full"
    ac.admit("t", 5, tenant_pending=0)
    ac.admit("t", 5, tenant_pending=0)


def test_warm_drive_capped_at_artifact_ladder(artifacts):
    """The warm promise is the ARTIFACT's ladder: a policy engine with a
    taller ladder does not capture rungs the artifact never named."""
    r = router(1)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"],
               policy=TenantPolicy(min_bucket=MIN_B, max_bucket=1024,
                                   max_batch=256, max_latency_s=0.005))
    lt = r.load("a")
    assert lt.warm["aot"] + lt.warm["jit"] == 4
    assert lt.engine.compile_cache_size == 4


def test_router_flush_unknown_tenant_raises(artifacts):
    r = router(1)
    r.register("a", artifacts["a"], policy=small_policy())
    with pytest.raises(KeyError, match="not registered"):
        r.flush("tennant-typo")
    r.flush("a")
    r.flush()


def test_chaos_fleet_eviction_fault(artifacts):
    r = router(2)
    r.register("a", artifacts["a"], policy=small_policy(warm_start=False))
    r.register("b", artifacts["b"], policy=small_policy(warm_start=False))
    with Chaos(fleet_evict_nth=1) as chaos:
        r.load("a")  # the cache is empty: the one-shot fault must WAIT
        assert chaos.fired["fleet_evict"] == 0
        r.load("b")  # first EVICTABLE access: fires, evicts "a"
        assert chaos.fired["fleet_evict"] == 1
    assert r.loaded() == ("b",)
    assert r.stats()["evictions"] == 1


def test_chaos_warmstart_corruption_degrades_to_jit(artifacts):
    """A corrupt tape blob costs its rung the tape, never the load: with
    no f_model the rung fails its first touch at LOAD time and is
    quarantined (its queries reroute upward); with the f_model attached
    the tape is never read and every rung runs the engine's own program.
    Either way nothing is captured at request time."""
    r = router(1)
    r.register("b", artifacts["b"], policy=small_policy())
    with Chaos(warmstart_fail_n=1) as chaos:
        lt = r.load("b")
    assert chaos.fired["warmstart"] == 1
    assert lt.warm["aot"] == 1 and lt.warm["jit"] == 2
    assert lt.warm["failed"] == 2  # the corrupt blob, then its dead rung
    assert lt.engine.quarantined_buckets() == {"residual": [MIN_B]}
    before = engine_compiles()
    f = r.query("b", query_points(30), kind="residual")
    r.query("b", query_points(30))
    assert engine_compiles() == before  # still zero at request time
    assert f.shape == (30,)

    r2 = router(1)
    r2.register("b", artifacts["b"], f_model=artifacts["f_model"],
                policy=small_policy())
    with Chaos(warmstart_fail_n=1) as chaos:
        lt2 = r2.load("b")
    assert chaos.fired["warmstart"] == 0
    assert lt2.warm["jit"] == 4 and lt2.warm["failed"] == 0


def test_chaos_spec_roundtrip_fleet_keys():
    c = Chaos.from_spec("fleet_evict_nth=2,warmstart_fail_n=3,seed=5")
    assert c.fleet_evict_nth == 2 and c.warmstart_fail_n == 3
    assert Chaos.from_spec(c.spec()).spec() == c.spec()


# --------------------------------------------------------------------------- #
# parity with the JAX fleet
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_router(artifacts):
    jr = jfleet.FleetRouter(max_loaded=2)
    jpol = jfleet.TenantPolicy(min_bucket=MIN_B, max_bucket=MAX_B,
                               max_batch=256, max_latency_s=0.005)
    jr.register("with_f", artifacts["jax_b"], f_model=burgers(tdq),
                policy=jpol)
    jr.register("no_f", artifacts["jax_b"], policy=jpol)
    return jr


@pytest.mark.parametrize("n", [17, 64, 100])
def test_fleet_serve_matches_jax_fleet(artifacts, jax_router, n):
    """The same weights behind both packages' fleets: ``u`` and the
    residual (the generic program, f_model attached) within the band."""
    r = router(2)
    r.register("b", artifacts["b"], f_model=artifacts["f_model"],
               policy=small_policy())
    X = query_points(n, seed=20 + n)
    for kind in ("u", "residual"):
        ok, why = crosscheck_residuals(
            np.asarray(jax_router.query("with_f", X, kind=kind)),
            r.query("b", X, kind=kind), rtol=RTOL)
        assert ok, (kind, why)


@pytest.mark.parametrize("n", [17, 100])
def test_tape_residual_matches_jax_aot_residual(artifacts, jax_router, n):
    """Served with no f_model on either side: the port from its lowered
    tape, JAX from its exported program."""
    r = router(1)
    r.register("b", artifacts["b"], policy=small_policy())
    X = query_points(n, seed=40 + n)
    ok, why = crosscheck_residuals(
        np.asarray(jax_router.query("no_f", X, kind="residual")),
        r.query("b", X, kind="residual"), rtol=RTOL)
    assert ok, why


# --------------------------------------------------------------------------- #
# threads: a swap beside live traffic
# --------------------------------------------------------------------------- #
def test_hot_swap_under_concurrent_queries_drops_no_waiter(artifacts):
    """One thread queries tenant a (both kinds) while another swaps it to
    b's artifact and back: every query answers (no error, no waiter left
    pending), each answer is one of the two artifacts' own, and the
    swapped-out engines dropped their graphs."""
    r = router(2)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy())
    r.load("a")
    X = query_points(40, seed=9)
    want = {direct_engine(artifacts[k]).u(X).tobytes() for k in "ab"}
    stop, errs, seen = threading.Event(), [], []

    def hammer():
        try:
            while not stop.is_set():
                seen.append(r.query("a", X).tobytes())
                r.query("a", X, kind="residual")
        except Exception as e:  # surfaced below
            errs.append(e)

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    olds = []
    try:
        for art in (artifacts["b"], artifacts["a"]):
            olds.append(r._loaded["a"])
            v = r.hot_swap("a", art, f_model=artifacts["f_model"],
                           probe_X=query_points(MIN_B), gate=1e30)
            assert v["swapped"], v
    finally:
        stop.set()
        th.join(timeout=60.0)
    assert not th.is_alive() and not errs, errs
    assert seen and set(seen) <= want
    assert all(o.engine._released for o in olds)
    assert r.pending_points() == 0


# --------------------------------------------------------------------------- #
# telemetry: autoscaling signals + report narration
# --------------------------------------------------------------------------- #
def test_autoscale_signals_and_stats(artifacts):
    r = router(2)
    r.register("a", artifacts["a"], f_model=artifacts["f_model"],
               policy=small_policy())
    r.query("a", query_points(12))
    sig = r.autoscale_signals()
    assert sig["loaded"] == 1 and sig["max_loaded"] == 2
    assert sig["tenants"]["a"]["queue_depth"] == 0
    assert sig["tenants"]["a"]["qps"] is not None
    assert 0.0 <= sig["cache_hit_rate"] <= 1.0
    s = r.stats()["tenants"]["a"]
    assert s["loaded"] and s["kinds"]["u"]["requests"] == 1
    assert s["warm"]["jit"] == 4


def test_report_narrates_fleet_trail(artifacts, tmp_path):
    run_dir = str(tmp_path / "run")
    with telemetry.RunLogger(run_dir, config={}):
        r = router(1)
        r.register("a", artifacts["a"], policy=small_policy(
            rate_qps=1.0, burst=1.0))
        r.register("b", artifacts["b"], policy=small_policy())
        r.query("a", query_points(4))
        r.load("b")  # evicts a
        with pytest.raises(AdmissionRejected):
            r.submit("a", query_points(2))  # rate limit: shed
    text = telemetry.report(run_dir)
    assert "FLEET: 2 tenant load(s), 1 eviction(s)" in text
    assert "WARM START" in text and "AOT" in text
    assert "ADMISSION: 1 request(s) shed" in text and "a/rate_limit" in text
    s = telemetry.summarize(run_dir)
    assert len(s["fleet_events"]) >= 3
    assert len(s["warmstarts"]) == 2
