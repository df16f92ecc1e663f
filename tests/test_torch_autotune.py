"""``compile(fused="autotune")``: the candidate race, the minimax race and
the failure record, held to the JAX solver's protocol
(``tests/test_solver.py:610-645``, ``tests/test_fused.py:324``).

``_time_loss_step`` is the shared measurement; monkeypatched on both
packages with the same sequence of times, the two solvers consume it in
the same order (the candidates ``generic``, ``fused`` on a CPU solver, then
the minimax step against the winner's unfused step) and make the same
choices: the argmin is adopted; the minimax step only when its step is
faster; ``minimax=True`` skips the race; a candidate that fails to run is
recorded and skipped, and none surviving raises ``AutotuneFailure``.  The
real measurement runs too (on the CPU it times eager steps), and the
adopted engine trains.
"""

import numpy as np
import pytest

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch.models.collocation import AutotuneFailure

PKGS = {"jax": tdq, "torch": tdqt}


def burgers(pkg, n_f=128):
    domain = pkg.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 16)
    domain.add("t", [0.0, 1.0], 8)
    domain.generate_collocation_points(n_f, seed=0)
    bcs = [pkg.IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]]),
           pkg.dirichletBC(domain, val=0.0, var="x", target="upper")]
    grad = pkg.grad

    def f_model(u, x, t):
        u_x = grad(u, "x")
        return grad(u, "t")(x, t) + u(x, t) * u_x(x, t) \
            - 0.01 * grad(u_x, "x")(x, t)

    return domain, bcs, f_model


def build(monkeypatch, pkg, times, minimax=None, calls=None):
    cls = pkg.CollocationSolverND
    it = iter(times)

    def fake(self, residual_fn=None, residual_loss_fn=None, **kw):
        if calls is not None:
            calls.append("minimax" if residual_loss_fn is not None else
                         "generic" if residual_fn is None else "fused")
        t = next(it)
        if isinstance(t, Exception):
            raise t
        return t

    monkeypatch.setattr(cls, "_time_loss_step", fake, raising=True)
    domain, bcs, f_model = burgers(pkg)
    s = (cls(verbose=False) if pkg is tdq else
         cls(verbose=False, device="cpu"))
    s.compile([2, 8, 8, 1], f_model, domain, bcs, fused="autotune",
              minimax=minimax)
    return s


@pytest.mark.parametrize("case", ["slower", "faster", "forced"])
def test_minimax_adoption_is_measured_as_in_jax(monkeypatch, case):
    times, minimax = {"slower": ([2.0, 1.0, 3.0, 1.5], None),
                      "faster": ([2.0, 1.0, 1.0, 2.0], None),
                      "forced": ([2.0, 1.0], True)}[case]
    out = {}
    for name, pkg in PKGS.items():
        calls = []
        s = build(monkeypatch, pkg, times, minimax, calls)
        out[name] = (calls, s._minimax_kind is not None,
                     str(s._minimax_fail_reason or ""))
    (jc, ja, jr), (tc, ta, tr) = out["jax"], out["torch"]
    assert tc == jc  # the same candidates, in the same order
    assert ta == ja == (case != "slower")
    if case == "slower":
        assert "slower" in tr and "slower" in jr
    s = build(monkeypatch, tdqt, times, minimax)
    assert s.autotune_report["choice"] == "fused"
    assert s.engine == ("fused" if case == "slower" else "fused-minimax")
    race = s.autotune_report["minimax"]
    if case == "forced":
        assert race is None  # no race under minimax=True
    else:
        assert race == {"minimax_ms": times[2] * 1e3,
                        "unfused_ms": times[3] * 1e3,
                        "adopted": case == "faster"}


def test_generic_winner_skips_the_minimax_race(monkeypatch):
    calls = []
    s = build(monkeypatch, tdqt, [1.0, 2.0], calls=calls)
    assert calls == ["generic", "fused"]
    assert s.engine == "generic" and s.autotune_report["choice"] == "generic"
    assert s.autotune_report["timings_ms"] == {"generic": 1e3, "fused": 2e3}
    j = build(monkeypatch, tdq, [1.0, 2.0])
    assert j._fused_residual is None


def test_failures_are_recorded_and_all_failing_raises(monkeypatch):
    s = build(monkeypatch, tdqt, [1.5, RuntimeError("no launch")])
    assert s.engine == "generic"
    assert set(s.autotune_report["failures"]) == {"fused"}
    assert s.autotune_report["timings_ms"] == {"generic": 1.5e3}
    with pytest.raises(AutotuneFailure) as exc:
        build(monkeypatch, tdqt, [RuntimeError("a"), RuntimeError("b")])
    assert set(exc.value.failures) == {"generic", "fused"}
    with pytest.raises(tdq.models.collocation.AutotuneFailure):
        build(monkeypatch, tdq, [RuntimeError("a"), RuntimeError("b")])


def test_real_autotune_selects_a_training_engine():
    domain, bcs, f_model = burgers(tdqt)
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile([2, 10, 10, 1], f_model, domain, bcs, fused="autotune")
    rep = s.autotune_report
    assert set(rep["timings_ms"]) == {"generic", "fused"}
    assert all(v > 0 for v in rep["timings_ms"].values())
    assert rep["choice"] == min(rep["timings_ms"], key=rep["timings_ms"].get)
    assert not rep["excluded"]  # the K1/K2 candidate exists on the card only
    # the timed step does not touch the network's parameters or gradients
    assert all(p.grad is None for p in s.net.parameters())
    total, _ = s.update_loss()
    assert np.isfinite(float(total))
    s.fit(tf_iter=4, newton_iter=0, chunk=2)
    assert np.isfinite(s.losses[-1]["Total Loss"])
    # the loss is the chosen engine's own
    other = tdqt.CollocationSolverND(verbose=False, device="cpu")
    other.compile([2, 10, 10, 1], f_model, domain, bcs,
                  fused=False if rep["choice"] == "generic" else None,
                  minimax=s._minimax_kind is not None)
    other.net.load_layers(s.net.layers())
    assert other.engine == s.engine
    assert float(other.update_loss()[0]) == float(s.update_loss()[0])
