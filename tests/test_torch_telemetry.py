"""The port's training telemetry and ``fit``'s evaluation and profiling
options (``tensordiffeq_tpu_torch/telemetry``, ``training/fit.py``,
``training/lbfgs.py``, ``models/collocation.py::fit``) held to the JAX
package's.

* ``RunLogger``: events and manifest round-trip with the JAX package's
  schema, a truncated line is skipped, ``log_event`` routes its fields to
  the active logger and prints only under ``verbose``;
* a fit with a ``RunLogger``: the run config, one ``epoch`` event per Adam
  epoch with the gradient norm, λ summaries, the step-time split of both
  phases, ``step_cost`` on the ``"analytic-minimax"`` basis, ``fit_end``;
* the NaN/Inf sentinel: ``TrainingDiverged`` on a diverging fit (with the
  divergence event, strict JSON) and on a NaN row, and the event alone
  without the raise;
* ``eval_fn`` fires at the same (phase, step) pairs as the JAX solver's
  for the same ``tf_iter``, ``chunk``, ``eval_every`` and ``newton_iter``,
  at the Adam chunk boundaries and the L-BFGS ones, with parameters that
  ``apply_fn`` takes;
* ``Grad_norm`` over a 20-step SA trajectory from the JAX parameters tracks
  the JAX solver's within 5e-3 (the engines' band), the losses too; and
  telemetry without the gradient norm leaves the history and parameters
  bit for bit a plain fit's (the step is the plain one), with it the loss
  history is still the plain one's bit for bit;
* redraws reach ``resample.*`` (redraws, stall, kept fraction);
* ``fit(profile_dir=)`` writes a Chrome trace;
* the solver's former ``_UNPORTED_FIT`` table is gone.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch import telemetry
from tensordiffeq_tpu_torch.models import collocation
from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry, RunLogger,
                                              TrainingDiverged,
                                              TrainingTelemetry)
from tensordiffeq_tpu_torch.weights import params_from_jax
from test_torch_minimax_solver import burgers

torch.set_num_threads(1)
RTOL = 5e-3


def _solver(pkg=tdqt, n_f=128, lr=5e-3, **extra):
    domain, bcs, f_model, kw, layers = burgers(pkg, n_f=n_f)
    if pkg is tdqt:
        s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    else:
        s = tdq.CollocationSolverND(verbose=False)
    s.compile(layers, f_model, domain, bcs, lr=lr, lr_weights=lr, **kw,
              **extra)
    return s


# --------------------------------------------------------------------------- #
# the run log
# --------------------------------------------------------------------------- #
def test_runlog_roundtrip_and_schema(tmp_path):
    d = str(tmp_path / "run")
    reg = MetricsRegistry()
    reg.counter("things").inc(3)
    with RunLogger(d, config={"n_f": 128}, registry=reg,
                   run_id="run-test") as run:
        assert telemetry.active_logger() is run
        run.event("epoch", phase="adam", epoch=0,
                  losses={"Total Loss": np.float32(1.5)},
                  arr=np.arange(3), bad=float("nan"))
        run.event("checkpoint", phase="adam", epoch=0)
    assert telemetry.active_logger() is None
    man = telemetry.read_manifest(d)
    assert man["schema_version"] == telemetry.SCHEMA_VERSION == 2
    assert man["run_id"] == "run-test" and man["config"] == {"n_f": 128}
    assert man["n_events"] == 2
    assert man["metrics"]["counters"]["things"] == 3
    assert man["environment"]["backend"] in ("cpu", "cuda")
    evs = telemetry.read_events(d)
    assert [e["kind"] for e in evs] == ["epoch", "checkpoint"]
    assert evs[0]["losses"]["Total Loss"] == 1.5
    assert evs[0]["arr"] == [0, 1, 2] and evs[0]["bad"] == "NaN"
    assert len(telemetry.read_events(d, kind="checkpoint")) == 1
    with pytest.raises(ValueError):
        run.event("late")
    # a kill mid-write: the truncated trailing line is skipped
    with open(os.path.join(d, telemetry.EVENTS_FILE), "a") as fh:
        fh.write('{"v": 2, "kind": "b", "x"')
    assert len(telemetry.read_events(d)) == 2


def test_runlog_rotates_and_reads_across_segments(tmp_path):
    d = str(tmp_path / "run")
    with RunLogger(d, run_id="r", rotate_bytes=200) as run:
        for i in range(20):
            run.event("tick", i=i, pad="x" * 20)
    segs = telemetry.event_segments(d)
    assert len(segs) > 2 and segs[-1].endswith(telemetry.EVENTS_FILE)
    assert [e["i"] for e in telemetry.read_events(d)] == list(range(20))
    assert telemetry.read_manifest(d)["n_rotations"] == len(segs) - 1


def test_log_event_routing(tmp_path, capsys):
    d = str(tmp_path / "run")
    telemetry.log_event("fit", "hello world", verbose=True)
    assert "[fit] hello world" in capsys.readouterr().out
    with RunLogger(d, run_id="r"):
        telemetry.log_event("fit", "quiet msg", verbose=False, extra=7)
        telemetry.log_event("fit", "loud msg", verbose=True)
        telemetry.log_event("l-bfgs", "warn msg", level="warning")
    out = capsys.readouterr()
    assert "quiet msg" not in out.out
    assert "[fit] loud msg" in out.out
    assert "[l-bfgs] warn msg" in out.err
    evs = telemetry.read_events(d)
    assert [e.get("message") for e in evs] == ["quiet msg", "loud msg",
                                               "warn msg"]
    assert evs[0]["extra"] == 7 and evs[2]["level"] == "warning"


# --------------------------------------------------------------------------- #
# a fit under telemetry
# --------------------------------------------------------------------------- #
def test_fit_produces_the_run_log(tmp_path):
    d = str(tmp_path / "run")
    s = _solver()
    with RunLogger(d, config={"example": "burgers-sa"}, run_id="toy") as run:
        s.fit(tf_iter=40, newton_iter=20, chunk=20, telemetry=run)
    cfg = telemetry.read_events(d, kind="run_config")
    assert cfg[-1]["tf_iter"] == 40 and cfg[-1]["engine"] == s.engine
    epochs = telemetry.read_events(d, kind="epoch")
    adam = [e for e in epochs if e["phase"] == "adam"]
    assert [e["epoch"] for e in adam] == list(range(40))
    assert {"Total Loss", "Residual_0"} <= set(adam[0]["losses"])
    assert adam[0]["grad_norm"] > 0
    assert "Grad_norm" in s.losses[0] and "Grad_norm" not in \
        adam[0]["losses"]
    lbfgs = [e for e in epochs if e["phase"] == "l-bfgs"]
    assert [e["epoch"] for e in lbfgs] == list(range(20))
    stats = telemetry.read_events(d, kind="lambda_stats")[-1]["stats"]
    assert set(stats["residual[0]"]) == {"min", "mean", "max", "p99"}
    assert stats["residual[0]"]["min"] <= stats["residual[0]"]["p99"] \
        <= stats["residual[0]"]["max"] + 1e-12
    st = telemetry.read_events(d, kind="step_time")
    assert {e["phase"] for e in st} == {"adam", "l-bfgs"}
    assert len([e for e in st if e["phase"] == "adam"]) == 2
    assert all(e["dispatch_s"] >= 0 and e["device_s"] >= 0 for e in st)
    cost = telemetry.read_events(d, kind="step_cost")
    assert cost and cost[0]["basis"] == "analytic-minimax"
    assert cost[0]["flops_per_step"] > 0
    end = telemetry.read_events(d, kind="fit_end")[-1]
    assert end["epochs_total"] == 60 and end["newton_done"] == 20
    assert not telemetry.read_events(d, kind="divergence")


def test_sentinel_raises_on_a_diverging_fit(tmp_path):
    d = str(tmp_path / "run")
    s = _solver(lr=1e18)
    with RunLogger(d, run_id="broken") as run:
        with pytest.raises(TrainingDiverged) as ei:
            s.fit(tf_iter=60, chunk=10, telemetry=run)
    assert ei.value.phase == "adam" and ei.value.components
    assert ei.value.trace_id is None
    div = telemetry.read_events(d, kind="divergence")
    assert len(div) == 1 and div[0]["phase"] == "adam"
    assert div[0]["components"]["Total Loss"] in ("NaN", "Infinity",
                                                  "-Infinity")

    def _no_const(name):
        raise AssertionError(f"non-strict JSON literal {name}")
    with open(os.path.join(d, telemetry.EVENTS_FILE)) as fh:
        for line in fh:
            json.loads(line, parse_constant=_no_const)


def test_sentinel_trips_at_the_first_nan_row_and_can_only_record():
    tele = TrainingTelemetry(logger=None, registry=MetricsRegistry())
    rows = [{"Total Loss": 1.0}, {"Total Loss": math.nan},
            {"Total Loss": math.inf}]
    with pytest.raises(TrainingDiverged) as ei:
        tele.check_rows("adam", 10, rows)
    assert ei.value.epoch == 11
    soft = TrainingTelemetry(logger=None, registry=MetricsRegistry(),
                             raise_on_divergence=False)
    soft.check_rows("adam", 0, rows)
    soft.on_lbfgs_history([1.0, float("nan")])
    assert soft.registry.counter("divergences", phase="adam").value == 1
    assert soft.registry.counter("divergences", phase="l-bfgs").value == 1


# --------------------------------------------------------------------------- #
# eval_fn against the JAX solver's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tf_iter,chunk,eval_every,newton_iter", [
    (25, 10, 7, 12), (30, 5, 10, 0), (12, 4, 4, 250)])
def test_eval_fn_fires_where_the_jax_solvers_does(tf_iter, chunk, eval_every,
                                                  newton_iter):
    calls = {}
    for name, pkg in (("jax", tdq), ("port", tdqt)):
        s = _solver(pkg)
        got = calls[name] = []

        def eval_fn(phase, step, params, _s=s, _got=got):
            _got.append((phase, int(step)))
            if pkg is tdqt:  # the parameters apply_fn takes
                u = _s._apply_eval(params, np.zeros((3, 2), np.float32))
                assert u.shape == (3, 1) and np.all(np.isfinite(u))
        s.fit(tf_iter=tf_iter, newton_iter=newton_iter, chunk=chunk,
              eval_fn=eval_fn, eval_every=eval_every)
    assert calls["port"] == calls["jax"]
    assert calls["port"], "the cadence fires at least once"


def test_grad_norm_tracks_the_jax_solvers_and_plain_steps_stay_plain():
    js = _solver(tdq)
    ts = _solver(tdqt)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params),
                             device="cpu")
    ts.net.load_layers(params)
    js.fit(tf_iter=20, chunk=10, telemetry=tdq.telemetry.TrainingTelemetry(
        registry=tdq.telemetry.MetricsRegistry()))
    ts.fit(tf_iter=20, chunk=10, telemetry=TrainingTelemetry(
        registry=MetricsRegistry()))
    for key in ("Grad_norm", "Total Loss"):
        np.testing.assert_allclose([r[key] for r in ts.losses],
                                   [r[key] for r in js.losses], rtol=RTOL)
    # the plain step: no telemetry, telemetry without the norm, and with
    # it (the loss history only) — from one set of parameters
    runs = []
    for tele in (None, TrainingTelemetry(registry=MetricsRegistry(),
                                         grad_norm=False),
                 TrainingTelemetry(registry=MetricsRegistry())):
        s = _solver(tdqt)
        s.net.load_layers(params)
        s.fit(tf_iter=15, chunk=5, telemetry=tele)
        runs.append(s)
    plain, no_norm, norm = runs
    assert [r for r in no_norm.losses] == [r for r in plain.losses]
    for a, b in zip(no_norm.net.layers(), plain.net.layers()):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert [r["Total Loss"] for r in norm.losses] \
        == [r["Total Loss"] for r in plain.losses]
    assert "Grad_norm" not in plain.losses[0] and "Grad_norm" in \
        norm.losses[0]


def test_redraws_reach_the_resample_instruments():
    s = _solver(n_f=256)
    reg = MetricsRegistry()
    s.fit(tf_iter=30, chunk=10, resample_every=10,
          telemetry=TrainingTelemetry(registry=reg))
    snap = reg.as_dict()
    assert snap["counters"]["resample.redraws"] == 1  # the last discarded
    assert snap["histograms"]["resample.stall_s"]["count"] == 1
    assert 0.0 < snap["gauges"]["resample.kept_fraction"] <= 1.0
    assert "resample.lambda_drift" in snap["gauges"]
    assert snap["gauges"]["resample.score_flops"] > 0


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    s = _solver()
    s.fit(tf_iter=4, chunk=2, profile_dir=str(tmp_path / "prof"))
    traces = [f for f in os.listdir(tmp_path / "prof")
              if f.startswith("trace.") and f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / "prof" / traces[0]) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "fit_adam.step" in names and len(s.losses) == 4


def test_unported_fit_table_is_gone():
    assert not hasattr(collocation, "_UNPORTED_FIT")
