"""The port's closed loop (``tensordiffeq_tpu_torch.fleet.closedloop``):
drift-triggered factory retraining with zero-downtime hot-swap, held to
the JAX package's (``tests/test_closedloop.py``'s cases) on the CPU.

* Parity with the JAX package on the same numpy weights (flax trees
  carried across by ``weights.params_from_jax``): on the same drift
  injection and probe set, ``DriftMonitor``'s windowed drift levels are
  within rtol 5e-3 of JAX's and the trip decisions are the same; the
  retrain warm-started from the served parameters (each package's
  ``RetrainController.live_params``) gives its first 20 family-step
  losses within rtol 5e-3 of the JAX factory's (its generic engine; the
  port's template adopts the minimax step).
* The JAX cases: one chaotic cycle under ``drift_inject``,
  ``retrain_kill_at`` and ``swap_corrupt_member`` at once with a member
  frozen mid-family, and a clean cycle (every member swapped, zero
  request-time captures, no dropped waiter, a canary rollback proven bit
  for bit).  Drift here scales the served tensors in place (the rungs'
  graphs are keyed on their storage), so the injection itself captures
  nothing either.
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
from tensordiffeq_tpu import fleet as jfleet
from tensordiffeq_tpu.resilience import Chaos as JChaos
from tensordiffeq_tpu.serving import Surrogate as JSurrogate
from tensordiffeq_tpu_torch import fleet, telemetry
from tensordiffeq_tpu_torch.factory import FAMILY_MANIFEST, SurrogateFactory
from tensordiffeq_tpu_torch.fleet import (DriftMonitor, FleetRouter,
                                          RetrainController, TenantPolicy)
from tensordiffeq_tpu_torch.resilience import Chaos, RetryPolicy
from tensordiffeq_tpu_torch.serving import Surrogate
from tensordiffeq_tpu_torch.telemetry import SLOSet, report
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
N_F = 256
LAYERS = [2, 12, 12, 1]
MIN_B, MAX_B = 64, 128
THETAS = [0.001, 0.002, 0.003]
RTOL = 5e-3


def make_domain(pkg=tdqt):
    d = pkg.DomainND(["x", "t"], time_var="t")
    d.add("x", [-1.0, 1.0], 32)
    d.add("t", [0.0, 1.0], 8)
    d.generate_collocation_points(N_F, seed=0)
    return d


def make_bcs(d, pkg=tdqt):
    return [pkg.IC(d, [lambda x: x ** 2 * np.cos(np.pi * x)], var=[["x"]]),
            pkg.dirichletBC(d, val=0.0, var="x", target="upper"),
            pkg.dirichletBC(d, val=0.0, var="x", target="lower")]


def f_model_for(pkg):
    grad = pkg.grad

    def f_model_fam(u, x, t, th):
        return grad(u, "t")(x, t) - th * grad(grad(u, "x"), "x")(x, t) \
            + 5.0 * u(x, t) ** 3 - 5.0 * u(x, t)

    return f_model_fam


def build_factory(init_params=None, poison_member=None):
    """The controller's ``build_factory`` hook.  ``poison_member`` fills
    that member's parameters with NaN once the family is built (its build
    cross-checks every member's lowering on its own parameters), so it
    freezes at the first retrain chunk: the deterministic stand-in for a
    member diverging mid-family."""
    d = make_domain()
    fac = SurrogateFactory(LAYERS, f_model_for(tdqt), d, make_bcs(d),
                           thetas=THETAS, init_params=init_params,
                           verbose=False, device="cpu")
    if poison_member is not None:
        with torch.no_grad():
            for p in fac.params:
                p[poison_member].fill_(float("nan"))
    return fac


def query_points(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-1, 1, n),
                     rng.uniform(0, 1, n)], -1).astype(np.float32)


def small_policy():
    return TenantPolicy(min_bucket=MIN_B, max_bucket=MAX_B, max_batch=256,
                        max_latency_s=0.005)


def engine_compiles():
    return sum(v for k, v in
               telemetry.default_registry().as_dict()["counters"].items()
               if k.startswith("serving.engine.compiles"))


def leaves_equal(a, b):
    la = [t for pair in a for t in pair]
    lb = [t for pair in b for t in pair]
    return len(la) == len(lb) and all(
        x.detach().numpy().tobytes() == y.detach().numpy().tobytes()
        for x, y in zip(la, lb))


def u_bytes(router, tenant, X):
    return np.asarray(router.query(tenant, X)).tobytes()


@pytest.fixture(scope="module")
def family_v1(tmp_path_factory):
    """One trained M=3 family + its exported v1 artifact batch, shared by
    every serving test in this module."""
    fac = build_factory()
    fac.fit(tf_iter=20, chunk=10)
    v1 = str(tmp_path_factory.mktemp("torch_closedloop") / "v1")
    fac.export_family(v1, min_bucket=MIN_B, max_bucket=MAX_B)
    return {"factory": fac, "v1": v1}


@pytest.fixture(scope="module")
def chaotic(family_v1, tmp_path_factory):
    """THE acceptance cycle: one closed-loop run under all three chaos
    faults at once, inside a RunLogger so the narration tests read the
    same trail an operator would."""
    fac = family_v1["factory"]
    run_dir = str(tmp_path_factory.mktemp("torch_chaotic") / "run")
    workdir = str(tmp_path_factory.mktemp("torch_chaotic_v2"))
    router = FleetRouter(max_loaded=4, device="cpu")
    probe = query_points(MIN_B)
    sleeps = []
    out = {"router": router, "probe": probe, "run_dir": run_dir,
           "sleeps": sleeps}
    with telemetry.RunLogger(run_dir, config={"test": "closedloop"}):
        members = router.register_family(
            family_v1["v1"], policy=small_policy(), prefix="t",
            f_models={m: fac.member_f_model(m) for m in range(3)})
        out["members"] = members
        monitor = DriftMonitor(router, sample_fraction=1.0, window=2,
                               seed=0)
        for t in members.values():
            router.load(t)
            monitor.attach(t, probe)
        out["monitor"] = monitor
        out["u_before"] = {m: u_bytes(router, members[m], probe)
                           for m in (1, 2)}
        chaos = Chaos(drift_inject=2.0, retrain_kill_at=10,
                      swap_corrupt_member=1, seed=0)
        out["chaos"] = chaos
        with chaos:
            served = 0
            pre_drift = engine_compiles()
            while not monitor.tripped() and served < 60:
                t = members[served % 3]
                monitor.query(t, query_points(8, seed=served + 1))
                served += 1
            out["drift_compiles"] = engine_compiles() - pre_drift
            out["served_to_trip"] = served
            out["slo_at_trip"] = monitor.evaluate()
            controller = RetrainController(
                router, monitor,
                lambda ip: build_factory(ip, poison_member=2),
                members, retrain_iters=40, chunk=10, resample_every=0,
                retry=RetryPolicy(max_attempts=3, base_delay_s=0.01,
                                  jitter=0.0),
                gate_ratio=50.0,
                export_kw=dict(min_bucket=MIN_B, max_bucket=MAX_B),
                workdir=workdir, sleep=sleeps.append, verbose=False)
            out["cycle"] = controller.run_cycle()
        pre = engine_compiles()
        out["u_after"] = {m: u_bytes(router, t, probe)
                          for m, t in members.items()}
        out["post_swap_compiles"] = engine_compiles() - pre
    return out


# --------------------------------------------------------------------------- #
# the chaotic acceptance cycle
# --------------------------------------------------------------------------- #
def test_drift_injection_trips_the_monitor(chaotic):
    assert chaotic["chaos"].fired["drift_inject"] == 1
    cycle = chaotic["cycle"]
    assert cycle["triggered"] and cycle["tripped"] == ["t000"]
    assert 1 <= chaotic["served_to_trip"] <= 6
    o = chaotic["slo_at_trip"]["objectives"]["residual_drift"]
    assert o["ok"] is False and o["value"] > 3.0 and o["burn_rate"] > 1.0
    # the injection scaled the served tensors in place: the rungs' graphs
    # still hold, nothing captured at request time
    assert chaotic["drift_compiles"] == 0


def test_trainer_death_relaunches_with_backoff(chaotic):
    assert chaotic["chaos"].fired["retrain_kill"] == 1
    cycle = chaotic["cycle"]
    assert cycle["generations"] == 2 and cycle["trainer_kills"] == 1
    assert cycle["retrain_epochs"] == 40
    assert chaotic["sleeps"] == [pytest.approx(0.01)]


def test_corrupted_member_rejected_swap_ships_without_it(chaotic):
    assert chaotic["chaos"].fired["swap_corrupt"] == 1
    cycle = chaotic["cycle"]
    rolled = {v["tenant"]: v for v in cycle["rolled_back"]}
    assert rolled["t001"]["reason"] == "artifact_rejected"
    assert rolled["t001"]["bit_identical"] is True
    assert rolled["t001"]["member"] == 1
    swapped = {v["tenant"] for v in cycle["swapped"]}
    assert swapped == {"t000"}


def test_frozen_member_excluded_per_manifest(chaotic):
    cycle = chaotic["cycle"]
    assert cycle["frozen"] == [2] and cycle["exported"] == [0, 1]
    rolled = {v["tenant"]: v for v in cycle["rolled_back"]}
    assert rolled["t002"]["reason"] == "member_frozen"
    with open(os.path.join(cycle["v2_dir"], FAMILY_MANIFEST)) as fh:
        manifest = json.load(fh)
    assert "2" not in manifest["members"] and "2" in manifest["frozen"]


def test_unswapped_tenants_serve_bit_identically_throughout(chaotic):
    assert chaotic["u_after"][1] == chaotic["u_before"][1]
    assert chaotic["u_after"][2] == chaotic["u_before"][2]


def test_zero_request_time_compiles_after_chaotic_swap(chaotic):
    assert chaotic["post_swap_compiles"] == 0


def test_swap_resets_the_drift_objective(chaotic):
    v = chaotic["monitor"].evaluate()
    assert v["objectives"]["residual_drift"]["ok"] is True
    assert "t000" not in chaotic["monitor"].tripped()


def test_report_narrates_the_full_closed_loop(chaotic):
    text = report(chaotic["run_dir"])
    assert "DRIFT detected: tenant t000" in text
    assert "RETRAIN launched: generation 1" in text
    assert "RETRAIN launched: generation 2" in text
    assert "relaunch after trainer death" in text
    assert "CANARY passed: tenant t000" in text
    assert "SWAPPED: tenant t000" in text
    assert "zero request-time compiles" in text
    assert "ROLLED BACK: tenant t001" in text
    assert "artifact_rejected; probe replay bit-identical" in text
    assert "ROLLED BACK: tenant t002" in text
    assert "CHAOS ACTIVE" in text and "drift_inject x1" in text


# --------------------------------------------------------------------------- #
# the clean cycle: hot-swap happy path + canary rollback
# --------------------------------------------------------------------------- #
def test_clean_cycle_swaps_all_and_canary_rejects_regression(
        family_v1, tmp_path):
    fac = family_v1["factory"]
    router = FleetRouter(max_loaded=4, device="cpu")
    members = router.register_family(
        family_v1["v1"], policy=small_policy(), prefix="c",
        f_models={m: fac.member_f_model(m) for m in range(3)})
    monitor = DriftMonitor(router, sample_fraction=1.0, window=2, seed=0)
    probe = query_points(MIN_B)
    for t in members.values():
        router.load(t)
        monitor.attach(t, probe)

    # organic drift: scale c000's served tensors in place (the rungs'
    # graphs read them: the next query replays on the drifted model)
    lt = router.load(members[0])
    with torch.no_grad():
        for W, b in lt.surrogate.params:
            W.mul_(3.0)
            b.mul_(3.0)
    served = 0
    while not monitor.tripped() and served < 60:
        monitor.query(members[served % 3], query_points(8, seed=served + 1))
        served += 1
    assert monitor.tripped() == ("c000",)

    pending = router.submit(members[0], query_points(5, seed=99))

    controller = RetrainController(
        router, monitor, build_factory, members,
        retrain_iters=20, chunk=10, resample_every=0, gate_ratio=50.0,
        export_kw=dict(min_bucket=MIN_B, max_bucket=MAX_B),
        workdir=str(tmp_path), verbose=False)
    pre = engine_compiles()
    cycle = controller.run_cycle()
    assert {v["tenant"] for v in cycle["swapped"]} == set(members.values())
    assert cycle["rolled_back"] == [] and cycle["generations"] == 1
    assert pending.done  # flushed by the flip, not dropped
    assert np.asarray(pending.result()).shape[0] == 5
    # every capture of the cycle was a candidate's warm start, beside the
    # live engine; after the flips, none at request time
    assert engine_compiles() - pre == sum(
        v["warm"]["aot"] + v["warm"]["jit"] for v in cycle["swapped"])
    pre = engine_compiles()
    for t in members.values():
        router.query(t, probe)
        router.query(t, probe, kind="residual")
    assert engine_compiles() - pre == 0

    before = u_bytes(router, members[0], probe)
    verdict = router.hot_swap(
        members[0], os.path.join(family_v1["v1"], "member_000"),
        f_model=fac.member_f_model(0), probe_X=probe, gate=0.0)
    assert verdict["swapped"] is False
    assert verdict["reason"] == "canary_regressed"
    assert verdict["bit_identical"] is True
    assert u_bytes(router, members[0], probe) == before


# --------------------------------------------------------------------------- #
# chaos-off bit-identity + monitor units
# --------------------------------------------------------------------------- #
def test_chaos_off_monitored_serve_is_bit_identical(chaotic):
    router, monitor = chaotic["router"], chaotic["monitor"]
    tenant = chaotic["members"][1]
    X = query_points(32, seed=7)
    plain = np.asarray(router.query(tenant, X)).tobytes()
    monitored = np.asarray(monitor.query(tenant, X)).tobytes()
    assert monitored == plain
    assert np.asarray(router.query(tenant, X)).tobytes() == plain


def test_monitor_validation_and_no_traffic():
    with pytest.raises(ValueError, match="sample_fraction"):
        DriftMonitor(object(), sample_fraction=1.5)
    with pytest.raises(ValueError, match="window"):
        DriftMonitor(object(), window=0)
    m = DriftMonitor(object(), registry=telemetry.MetricsRegistry())
    assert m.drift("ghost") is None
    assert m.tripped() == ()
    assert m.evaluate()["objectives"]["residual_drift"]["ok"] is None


def test_monitor_windowing_uses_pinned_probe_set(chaotic):
    monitor = chaotic["monitor"]
    tenant = chaotic["members"][1]
    monitor.probe(tenant)
    l2 = monitor.probe(tenant)
    assert monitor.drift(tenant) == pytest.approx(l2, rel=1e-6)
    assert 0.5 < l2 < 2.0


def test_retrain_controller_idle_poll_is_cheap(chaotic):
    router, monitor = chaotic["router"], chaotic["monitor"]
    c = RetrainController(router, monitor, build_factory,
                          chaotic["members"])
    assert c.run_cycle() == {"triggered": False}
    with pytest.raises(ValueError, match="retrain_iters"):
        RetrainController(router, monitor, build_factory,
                          chaotic["members"], retrain_iters=0)


def test_chaos_spec_roundtrip_closed_loop_knobs():
    c = Chaos(drift_inject=0.25, retrain_kill_at=5, retrain_kill_repeats=2,
              swap_corrupt_member=3, seed=7)
    assert Chaos.from_spec(c.spec()).spec() == c.spec()
    assert "drift_inject=0.25" in c.spec()
    assert Chaos().spec() == ""
    assert Chaos.from_spec("retrain_kill_at=5").retrain_kill_at == 5


def test_factory_init_params_adoption_and_validation(family_v1):
    fac = family_v1["factory"]
    given = [fac.member_params(m) for m in range(3)]
    fac2 = build_factory(init_params=given)
    for m in range(3):
        assert leaves_equal(fac2.member_params(m), given[m])
    with pytest.raises(ValueError, match="init_params"):
        build_factory(init_params=given[:2])
    bad = list(given)
    bad[1] = [(torch.zeros(2, 2), torch.zeros(2)) for _ in given[1]]
    with pytest.raises(ValueError, match="init_params"):
        build_factory(init_params=bad)


# --------------------------------------------------------------------------- #
# parity with the JAX closed loop
# --------------------------------------------------------------------------- #
def flax_tree(seed):
    rng = np.random.RandomState(seed)
    return {"params": {
        f"Dense_{i}": {
            "kernel": (rng.randn(a, b) * np.sqrt(2.0 / (a + b))
                       ).astype(np.float32),
            "bias": (0.1 * rng.randn(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(LAYERS[:-1], LAYERS[1:]))}}


def _bound(pkg, th):
    f = f_model_for(pkg)
    return lambda u, x, t: f(u, x, t, th)


@pytest.fixture(scope="module")
def served_pair(tmp_path_factory):
    """Both packages' fleets serving the same three members' weights (the
    JAX artifacts without AOT programs: the residual is jitted from the
    f_model on both sides of the comparison)."""
    root = tmp_path_factory.mktemp("torch_closedloop_parity")
    jr = jfleet.FleetRouter(max_loaded=4)
    pr = FleetRouter(max_loaded=4, device="cpu")
    names = {}
    for m, th in enumerate(THETAS):
        tree = flax_tree(10 + m)
        jsur = JSurrogate(tdq.networks.neural_net(LAYERS),
                          jax.tree_util.tree_map(jnp.asarray, tree),
                          ("x", "t"), n_out=1, f_model=_bound(tdq, th))
        psur = Surrogate(tdqt.neural_net(LAYERS, device="cpu"),
                         params_from_jax(tree, device="cpu"), ("x", "t"),
                         n_out=1, f_model=_bound(tdqt, th))
        jart, part = str(root / f"j{m}"), str(root / f"p{m}")
        jfleet.export_fleet_artifact(jsur, jart, min_bucket=MIN_B,
                                     max_bucket=MAX_B, aot=False)
        fleet.export_fleet_artifact(psur, part, min_bucket=MIN_B,
                                    max_bucket=MAX_B)
        t = f"m{m:03d}"
        jr.register(t, jart, f_model=_bound(tdq, th),
                    policy=jfleet.TenantPolicy(min_bucket=MIN_B,
                                               max_bucket=MAX_B,
                                               max_batch=256,
                                               max_latency_s=0.005))
        pr.register(t, part, f_model=_bound(tdqt, th), policy=small_policy())
        names[m] = t
    return {"jax": jr, "port": pr, "members": names}


def _drift_trace(pkg_fleet, chaos_cls, router, tenant, registry):
    monitor = pkg_fleet.DriftMonitor(router, sample_fraction=1.0, window=2,
                                     seed=0, registry=registry)
    probe = query_points(MIN_B, seed=3)
    base = monitor.attach(tenant, probe)
    levels, trips = [], []
    with chaos_cls(drift_inject=2.0, seed=0):
        for i in range(4):
            monitor.query(tenant, query_points(8, seed=60 + i))
            levels.append(monitor.drift(tenant))
            trips.append(monitor.tripped())
    return base, levels, trips


def test_drift_levels_and_trip_match_jax(served_pair):
    """The same perturbation (2.0 relative, in place here, by rebinding in
    JAX) on the same weights and probe set: the windowed drift levels
    within the band, the same trip decisions at every probe."""
    t = served_pair["members"][0]
    jb, jl, jt = _drift_trace(jfleet, JChaos, served_pair["jax"], t,
                              tdq.telemetry.MetricsRegistry())
    pb, pl, pt = _drift_trace(fleet, Chaos, served_pair["port"], t,
                              telemetry.MetricsRegistry())
    assert pb == pytest.approx(jb, rel=RTOL)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert pt == jt and pt[-1] == (t,)


def test_warm_started_retrain_losses_match_jax(served_pair):
    """Each package's controller harvests the served parameters
    (``live_params``) and warm-starts its factory from them: the first 20
    family-step losses agree within the band, member by member."""
    members = served_pair["members"]
    # (whatever drift a test before injected, it did so in both fleets)
    jc = jfleet.RetrainController(served_pair["jax"], None,
                                  lambda ip: None, members)
    pc = RetrainController(served_pair["port"], None, lambda ip: None,
                           members)
    for t in members.values():
        served_pair["jax"].load(t)
        served_pair["port"].load(t)
    jp = jc.live_params()
    pp = pc.live_params()
    d = make_domain(tdq)
    jfac = tdq.SurrogateFactory(LAYERS, f_model_for(tdq), d,
                                make_bcs(d, tdq), thetas=THETAS,
                                init_params=jp, fused=False, verbose=False)
    pfac = build_factory(init_params=pp)
    jfac.fit(tf_iter=20, chunk=20)
    pfac.fit(tf_iter=20, chunk=20)
    want = np.stack([np.asarray(r["Total Loss"]) for r in jfac.losses])
    got = np.stack([np.asarray(r["Total Loss"]) for r in pfac.losses])
    assert got.shape == want.shape == (20, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL)
