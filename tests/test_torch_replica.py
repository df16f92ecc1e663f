"""The port's replicated serving plane (``tensordiffeq_tpu_torch.fleet.
replica``) held to the JAX package's (``tests/test_replica.py``'s cases) on
the CPU.

* Parity with the JAX package, bit for bit: the wire codec encodes and
  decodes the same bytes in both packages (either package's encoding
  decodes in the other's), and ``FrontRouter.candidates`` gives the same
  order for 50 tenant names over 2-5 replicas, so a JAX client and a port
  replica agree on the wire and on placement.
* The JAX cases: chaos-off replicated serving bit for bit a direct router,
  the rendezvous remap bound, tenant breakers relayed without burning the
  replica's breaker, hedged requests, consistent scrapes under concurrent
  flushes, the availability SLO, quorum degradation, and the end-to-end
  drill: two real replica processes (each imports torch and warm-starts
  both tenants; ``--device cpu`` on their argv) under live mixed
  ``u``/``residual`` traffic lose one to ``host_loss_at``, every query is
  still answered bit for bit (zero lost, zero request-time captures on the
  survivor), the slot respawns warm at the same endpoint, and one stitched
  trace and one scrape prove the incident.

The group is started by a module fixture as early as possible and only
joined by the last test, so the workers' imports and warm starts overlap
the in-process tests.  No wall-clock latency is asserted.
"""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tensordiffeq_tpu import fleet as jfleet
from tensordiffeq_tpu.fleet import replica as jreplica
from tensordiffeq_tpu.telemetry import MetricsRegistry as JRegistry
from tensordiffeq_tpu_torch import fleet
from tensordiffeq_tpu_torch.fleet import (AdmissionController, FleetRouter,
                                          FrontRouter, ReplicaGroup,
                                          ReplicaRequestError, ReplicaServer,
                                          decode_array, encode_array)
from tensordiffeq_tpu_torch.fleet.replica import (_decode_result,
                                                  _encode_result,
                                                  _rendezvous_weight)
from tensordiffeq_tpu_torch.resilience import Chaos, CircuitOpenError
from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry, RunLogger,
                                              SLOSet)
from tensordiffeq_tpu_torch.telemetry import tracing
from tensordiffeq_tpu_torch.telemetry.collector import SNAPSHOT_FILE
from tensordiffeq_tpu_torch.telemetry.tracing import Tracer

from test_slo import parse_exposition
from test_torch_fleet import (F_MODEL, MAX_B, MIN_B, port_surrogate,
                              query_points, small_policy)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# replica1 is tenant "a"'s rendezvous primary (asserted in the E2E), so
# killing rank 1 mid-traffic forces a deterministic reroute of "a" while
# "b" (primary replica0) must not notice
CHAOS_SPEC = "host_loss_at=6,host_loss_rank=1"

BOOTSTRAP = '''\
"""Replica bootstrap for tests/test_torch_replica.py (imported by each
replica worker via --bootstrap; PYTHONPATH carries this dir + the repo)."""
import torch

from tensordiffeq_tpu_torch import grad
from tensordiffeq_tpu_torch.fleet import FleetRouter, TenantPolicy

torch.set_num_threads(1)
ART = {arts!r}


def f_model(u, x, t):
    u_x, u_t = grad(u, "x"), grad(u, "t")
    return u_t(x, t) + u(x, t) * u_x(x, t) - 0.01 * grad(u_x, "x")(x, t)


def make_router(device="cuda"):
    router = FleetRouter(max_loaded=4, device=device)
    for name, art in sorted(ART.items()):
        router.register(
            name, art,
            policy=TenantPolicy(min_bucket={min_b}, max_bucket={max_b},
                                max_batch=256, max_latency_s=0.005),
            f_model=f_model)
    return router
'''


# --------------------------------------------------------------------------- #
# fixtures
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two fleet artifacts (the Burgers family of test_torch_fleet, its
    f_model) shared by the in-process routers AND the replica workers."""
    root = tmp_path_factory.mktemp("torch_replica_artifacts")
    out = {"f_model": F_MODEL}
    for name, seed in (("a", 0), ("b", 1)):
        art = str(root / name)
        fleet.export_fleet_artifact(port_surrogate(seed), art,
                                    min_bucket=MIN_B, max_bucket=MAX_B)
        out[name] = art
    return out


@pytest.fixture(scope="module")
def group(artifacts, tmp_path_factory):
    """The REAL 2-replica group: worker processes under a serving-mode
    ClusterSupervisor, armed with the host-loss chaos spec.  Started as
    early in the module as the artifacts allow and awaited only by the
    E2E test at the end of the file."""
    root = tmp_path_factory.mktemp("torch_replica_group")
    boot_dir = root / "boot"
    boot_dir.mkdir()
    (boot_dir / "tdqt_replica_boot.py").write_text(BOOTSTRAP.format(
        arts={"a": artifacts["a"], "b": artifacts["b"]},
        min_b=MIN_B, max_b=MAX_B))
    front_dir = str(root / "front_run")
    logger = RunLogger(front_dir, config={"role": "front"})
    sup_tracer = Tracer(logger=logger)
    g = ReplicaGroup(
        "tdqt_replica_boot:make_router", nproc=2,
        workdir=str(root / "replicas"),
        heartbeat_timeout_s=180.0, max_relaunches=2,
        env={"PYTHONPATH": f"{boot_dir}{os.pathsep}{REPO}",
             "TDQ_CHAOS": CHAOS_SPEC, "OMP_NUM_THREADS": "1"},
        tracer=sup_tracer, registry=MetricsRegistry(), device="cpu")
    g.start(timeout_s=600.0)
    coll = g.serve_metrics(host="rep-host")
    yield {"group": g, "tracer": sup_tracer, "logger": logger,
           "front_dir": front_dir, "collector": coll}
    try:
        coll.close()
    finally:
        try:
            g.shutdown(timeout_s=120.0)  # no-op if the E2E already did
        finally:
            logger.close()


def test_group_launches(group):
    """First test in the file: touching the fixture starts the worker
    boot NOW; assert only what is synchronously true."""
    eps = group["group"].endpoints()
    assert sorted(eps) == ["replica0", "replica1"]
    assert all(u.startswith("http://127.0.0.1:") for u in eps.values())
    assert len(group["group"].run_dirs()) == 6  # 2 slots x 3 incarnations


def build_router(artifacts, registry=None):
    r = FleetRouter(max_loaded=2, registry=registry or MetricsRegistry(),
                    device="cpu")
    for t in ("a", "b"):
        r.register(t, artifacts[t], f_model=artifacts["f_model"],
                   policy=small_policy())
    return r


# --------------------------------------------------------------------------- #
# wire codec and placement: the JAX package's, bit for bit
# --------------------------------------------------------------------------- #
CODEC_ARRAYS = (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.random.RandomState(0).randn(7, 2).astype(np.float64),
                np.array([[1, -2], [3, 4]], dtype=np.int32),
                np.float32([[np.pi]]))


def test_array_codec_bit_exact_roundtrip():
    for arr in CODEC_ARRAYS:
        back = decode_array(encode_array(arr))
        assert back.dtype == arr.dtype and back.shape == arr.shape
        assert back.tobytes() == arr.tobytes()
    t = (np.float32([[1.5]]), np.arange(3, dtype=np.float64))
    back = _decode_result(_encode_result(t))
    assert isinstance(back, tuple) and len(back) == 2
    for a, b in zip(t, back):
        assert b.tobytes() == a.tobytes() and b.dtype == a.dtype


def test_array_codec_matches_jax_byte_for_byte():
    """Either package's encoding is the other's, and decodes in it."""
    t = (np.float32([[1.5]]), np.arange(3, dtype=np.float64))
    for arr in CODEC_ARRAYS + (t,):
        enc = _encode_result(arr)
        assert json.dumps(enc) == json.dumps(jreplica._encode_result(arr))
        for back in (_decode_result(jreplica._encode_result(arr)),
                     jreplica._decode_result(enc)):
            for a, b in zip(arr if isinstance(arr, tuple) else (arr,),
                            back if isinstance(back, tuple) else (back,)):
                assert b.dtype == a.dtype and b.tobytes() == a.tobytes()


@pytest.mark.parametrize("n_replicas", [2, 3, 4, 5])
def test_rendezvous_placement_matches_jax(n_replicas):
    urls = {f"replica{i}": f"http://127.0.0.1:{41000 + i}"
            for i in range(n_replicas)}
    mine = FrontRouter(urls, registry=MetricsRegistry())
    theirs = jfleet.FrontRouter(urls, registry=JRegistry())
    for i in range(50):
        tenant = f"tenant-{i:02d}"
        assert mine.candidates(tenant) == theirs.candidates(tenant)
        for name in urls:
            assert _rendezvous_weight(tenant, name) \
                == jreplica._rendezvous_weight(tenant, name)


def test_rendezvous_remap_bound():
    urls = {f"r{i}": f"http://127.0.0.1:{40000 + i}" for i in range(5)}
    front5 = FrontRouter(urls, registry=MetricsRegistry())
    tenants = [f"tenant{i}" for i in range(200)]
    before = {t: front5.candidates(t) for t in tenants}
    primaries = {before[t][0] for t in tenants}
    assert primaries == set(urls)
    removed = "r2"
    front4 = FrontRouter({k: v for k, v in urls.items() if k != removed},
                         registry=MetricsRegistry())
    moved = 0
    for t in tenants:
        after = front4.candidates(t)
        if before[t][0] == removed:
            moved += 1
            assert after[0] == before[t][1]
        else:
            assert after[0] == before[t][0]
            assert after == [n for n in before[t] if n != removed]
    assert 0 < moved < len(tenants)
    assert _rendezvous_weight("a", "replica0") \
        == _rendezvous_weight("a", "replica0")


# --------------------------------------------------------------------------- #
# chaos-off bit identity + tenant-breaker relay (in-process replica)
# --------------------------------------------------------------------------- #
def test_replicated_serve_bit_identical_to_direct_router(artifacts):
    direct = build_router(artifacts)
    srv = ReplicaServer(build_router(artifacts), rank=0,
                        registry=MetricsRegistry())
    try:
        url = srv.serve()
        front = FrontRouter({"replica0": url}, registry=MetricsRegistry())
        for i, (tenant, kind) in enumerate(
                [("a", "u"), ("b", "u"), ("a", "residual"),
                 ("b", "residual"), ("a", "u")]):
            X = query_points(8, seed=10 + i)
            got = np.asarray(front.query(tenant, X, kind=kind))
            want = np.asarray(direct.query(tenant, X, kind=kind))
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (tenant, kind)
        ready = srv.readiness()
        assert ready["ready"] and ready["requests"] == 5
        front.close()
    finally:
        srv.close()


def test_tenant_breaker_relays_without_burning_replica_breaker(artifacts):
    router = FleetRouter(max_loaded=2, registry=MetricsRegistry(),
                         device="cpu")
    pol = small_policy(breaker_failure_threshold=1,
                       breaker_reset_timeout_s=3600.0)
    for t in ("a", "b"):
        router.register(t, artifacts[t], f_model=artifacts["f_model"],
                        policy=pol)
    srv = ReplicaServer(router, rank=0, registry=MetricsRegistry())
    try:
        url = srv.serve()
        front = FrontRouter({"replica0": url}, registry=MetricsRegistry())
        with Chaos(serving_fail_n=1):
            with pytest.raises(ReplicaRequestError) as ei:
                front.query("a", query_points(4))
        assert ei.value.status == 500
        with pytest.raises(CircuitOpenError):
            front.query("a", query_points(4))
        assert front.autoscale_signals()["replicas"]["replica0"] == "closed"
        assert front.availability() == 1.0
        assert np.asarray(front.query("b", query_points(4))).shape == (4, 1)
        with pytest.raises(KeyError):
            front.query("nobody", query_points(2))
        assert front.autoscale_signals()["replicas"]["replica0"] == "closed"
        front.close()
    finally:
        srv.close()


def test_hedged_query_fires_on_slow_primary(artifacts):
    router = FleetRouter(max_loaded=2, registry=MetricsRegistry(),
                         device="cpu")
    srv = ReplicaServer(router, rank=0, registry=MetricsRegistry())
    tarpit = socket.socket()
    try:
        url = srv.serve()
        tarpit.bind(("127.0.0.1", 0))
        tarpit.listen(1)  # connections land in the backlog, never served
        slow_url = "http://127.0.0.1:%d" % tarpit.getsockname()[1]
        reg = MetricsRegistry()
        front = FrontRouter({"slow": slow_url, "fast": url},
                            registry=reg, hedge_after_s=0.15,
                            call_timeout_s=20.0, deadline_s=30.0)
        tenant = next(t for t in (f"h{i}" for i in range(64))
                      if front.candidates(t)[0] == "slow")
        router.register(tenant, artifacts["a"],
                        f_model=artifacts["f_model"],
                        policy=small_policy())
        out = front.query(tenant, query_points(4))
        assert np.asarray(out).shape == (4, 1)
        hedges = [v for k, v in reg.as_dict()["counters"].items()
                  if k.startswith("fleet.failover.hedges")]
        assert sum(hedges) == 1  # the hedge answered, not the tarpit
        front.close()
    finally:
        tarpit.close()
        srv.close()


# --------------------------------------------------------------------------- #
# atomic scrape snapshots under concurrent flushes
# --------------------------------------------------------------------------- #
def test_scrape_snapshots_consistent_under_concurrent_flush(artifacts):
    router = FleetRouter(max_loaded=2, registry=MetricsRegistry(),
                         device="cpu")
    router.register("a", artifacts["a"], f_model=artifacts["f_model"],
                    policy=small_policy())
    router.load("a")
    stop = threading.Event()
    errs = []

    def hammer():
        i = 0
        try:
            while not stop.is_set():
                router.query("a", query_points(4, seed=i % 17))
                i += 1
        except Exception as e:
            errs.append(e)

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    try:
        scrapes = 0
        while scrapes < 60:
            sig = router.autoscale_signals()
            assert sig["pending_points"] == sum(
                t["queue_depth"] for t in sig["tenants"].values()), \
                "torn scrape: fleet total != sum of per-tenant depths"
            snap = router.stats()["tenants"]["a"]
            if snap["loaded"]:
                for kind, s in snap["kinds"].items():
                    assert s["requests"] >= 0, (kind, s)
                    assert s["batches"] >= 0 and s["points"] >= 0
            scrapes += 1
            time.sleep(0.005)
    finally:
        stop.set()
        th.join(timeout=10.0)
    assert not errs, errs


# --------------------------------------------------------------------------- #
# availability SLO + quorum degradation units
# --------------------------------------------------------------------------- #
def test_replica_availability_slo_objective():
    reg = MetricsRegistry()
    slos = SLOSet(min_replica_availability=0.75)
    verdict = slos.evaluate(reg)
    assert verdict["objectives"]["replica_availability"]["ok"] is None
    reg.gauge("fleet.replica.availability").set(0.5)
    verdict = slos.evaluate(reg)
    obj = verdict["objectives"]["replica_availability"]
    assert obj["ok"] is False
    assert "replica_availability" in verdict["breaches"]
    assert obj["burn_rate"] == pytest.approx(2.0)
    reg.gauge("fleet.replica.availability").set(1.0)
    obj = slos.evaluate(reg)["objectives"]["replica_availability"]
    assert obj["ok"] is True and obj["burn_rate"] == 0.0
    with pytest.raises(ValueError):
        SLOSet(min_replica_availability=0.0)


def test_quorum_loss_degrades_admission_and_restores():
    class Clk:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clk()
    reg = MetricsRegistry()
    adm = AdmissionController(max_pending_points=1024, registry=reg)
    front = FrontRouter({"r0": "http://127.0.0.1:1",
                         "r1": "http://127.0.0.1:2"},
                        admission=adm, registry=reg, clock=clk,
                        breaker_failure_threshold=1,
                        breaker_reset_timeout_s=5.0)
    assert front.quorum == 2
    nominal = adm.max_pending_points
    sig = front.autoscale_signals()
    assert not sig["below_quorum"] and not sig["degraded"]

    front._breakers["r0"].record_failure()
    front._update_availability()
    sig = front.autoscale_signals()
    assert sig["replicas"]["r0"] == "open"
    assert sig["availability"] == 0.5
    assert sig["below_quorum"] and sig["degraded"]
    assert adm.max_pending_points < nominal
    assert reg.gauge("fleet.admission.degraded").value == 1
    assert reg.gauge("fleet.replica.availability").value == 0.5
    front._update_availability()
    tightened = adm.max_pending_points
    front._update_availability()
    assert adm.max_pending_points == tightened

    clk.t += 10.0
    assert front._breakers["r0"].allow()
    front._breakers["r0"].record_success()
    front._update_availability()
    sig = front.autoscale_signals()
    assert not sig["below_quorum"] and not sig["degraded"]
    assert adm.max_pending_points == nominal
    assert reg.gauge("fleet.admission.degraded").value == 0
    assert reg.gauge("fleet.replica.availability").value == 1.0


# --------------------------------------------------------------------------- #
# the E2E drill (must stay LAST in this file: it joins the module group)
# --------------------------------------------------------------------------- #
def _live_compiles(run_dir, timeout_s=60.0):
    """Request-time capture tally from the replica's live metrics
    snapshot (written by its beat thread; wait for the first one)."""
    path = os.path.join(run_dir, SNAPSHOT_FILE)
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with open(path) as fh:
                snap = json.load(fh)
            break
        except (OSError, ValueError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    return sum(v for k, v in snap["metrics"]["counters"].items()
               if k.startswith("serving.engine.compiles"))


def test_e2e_replica_host_loss_failover(artifacts, group):
    g = group["group"]
    ready = g.wait_ready(timeout_s=420.0)
    assert sorted(ready) == ["replica0", "replica1"]
    for body in ready.values():
        assert sorted(body["tenants"]) == ["a", "b"]  # warm BEFORE ready

    survivor_dir = os.path.join(g.workdir, "replica0.gen0")
    base_compiles = _live_compiles(survivor_dir)

    ref = build_router(artifacts)
    front_reg = MetricsRegistry()
    front = FrontRouter(g.endpoints(), deadline_s=60.0,
                        breaker_reset_timeout_s=1.0, registry=front_reg)
    assert front.candidates("a")[0] == "replica1"
    assert front.candidates("b")[0] == "replica0"

    front_tracer = Tracer(logger=group["logger"],
                          context=group["tracer"].context())
    avail_min, answered = 1.0, 0
    with front_tracer:
        for i in range(24):
            tenant = "ab"[i % 2]
            kind = "u" if i % 3 else "residual"
            X = query_points(8, seed=100 + i)
            got = np.asarray(front.query(tenant, X, kind=kind))
            want = np.asarray(ref.query(tenant, X, kind=kind))
            assert got.tobytes() == want.tobytes(), (i, tenant, kind)
            answered += 1
            avail_min = min(avail_min, front.availability())
    assert answered == 24  # zero lost queries through the host loss

    counters = front_reg.as_dict()["counters"]

    def csum(prefix):
        return sum(v for k, v in counters.items() if k.startswith(prefix))

    assert csum("fleet.failover.attempts") >= 1
    assert csum("fleet.failover.reroutes") >= 1
    assert csum("fleet.failover.unavailable") == 0
    assert csum("fleet.front.requests") == 24
    assert avail_min == 0.5  # the breaker DID open mid-incident
    # the survivor absorbed the rerouted tenant with no request-time
    # capture (its warm start covers both tenants)
    assert _live_compiles(survivor_dir) - base_compiles == 0

    # recovery: the respawned slot comes back warm at the SAME endpoint
    g.wait_ready(timeout_s=300.0)
    time.sleep(1.1)  # past breaker_reset_timeout_s
    front.query("a", query_points(8, seed=999))
    sig = front.autoscale_signals()
    assert sig["replicas"]["replica1"] == "closed"
    assert sig["availability"] == 1.0 and not sig["below_quorum"]

    coll = group["collector"]
    coll.attach_registry(front_reg, host="rep-host", process="front")
    time.sleep(0.7)
    body = urllib.request.urlopen(f"{coll.url}/metrics",
                                  timeout=10).read().decode()
    samples, types = parse_exposition(body)

    def sample(name, **labels):
        key = (name, tuple(sorted(labels.items())))
        assert key in samples, (name, labels, sorted(samples)[:40])
        return samples[key]

    sup_proc = f"supervisor:{os.getpid()}"
    assert sample("cluster_host_lost_total", host="rep-host",
                  process=sup_proc, reason="exit") == 1
    assert sample("cluster_relaunches_total", host="rep-host",
                  process=sup_proc) == 1
    assert sample("fleet_failover_reroutes_total", host="rep-host",
                  process="front") >= 1
    assert types["fleet_replica_availability"] == "gauge"
    assert sample("fleet_replica_availability", host="rep-host",
                  process="front") == 1.0
    replica_reqs = sum(v for (name, _), v in samples.items()
                       if name == "fleet_replica_requests_total")
    assert replica_reqs >= 10

    result = g.shutdown(timeout_s=180.0)
    assert result is not None and result.ok, result
    assert result.hosts_lost == 1 and result.relaunches == 1
    assert len(result.recovery_wall_s) == 1 and result.recovery_wall_s[0] > 0

    all_dirs = [group["front_dir"]] + [d for d in g.run_dirs()
                                       if os.path.isdir(d)]
    assert len(all_dirs) == 4  # front + r0.gen0 + r1.gen0 + r1.gen1
    stitched = tracing.to_perfetto(all_dirs)
    slices = [ev for ev in stitched["traceEvents"] if ev["ph"] == "X"]
    names = {ev["name"] for ev in slices}
    assert "cluster.launch" in names and "host.lost" in names
    assert "host.join" in names
    assert "fleet.front.request" in names
    assert "fleet.front.reroute" in names or \
        "fleet.front.breaker_open" in names
    assert "fleet.request" in names
    assert len({ev["args"]["trace_id"] for ev in slices}) == 1, \
        "failover incident did not stitch into a single trace"
