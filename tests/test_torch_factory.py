"""The port's surrogate factory (``tensordiffeq_tpu_torch/factory``) held to
the JAX package's (``tests/test_factory.py``'s cases) on the CPU.

* Parity: a 3-member SA family built on both packages from the JAX
  members' initial parameters (carried by ``weights.params_from_jax``),
  the same collocation draw and λ; each member's loss and its gradients
  with respect to the parameters and the per-point λ at step 0, and the
  20-step loss histories, within rtol 5e-3 (the f32 cross-check band).
  The JAX factory runs its generic engine (its fused engines' compile-time
  cross-checks cost about 20 s of XLA compiles here; the generic engine is
  their referee), the port's the engine its template adopts, the minimax
  step.
* The anchor: a 1-member family is bit for bit the solo solver (its fit
  IS the solver's), and members of a larger family track matched-seed solo
  solvers.
* The engine follows the template's adoption; a NaN member is frozen and
  leaves the others bit for bit; ``frozen_at`` counts global epochs;
  all-frozen raises ``TrainingDiverged``; the per-member redraws (pool and
  ascent) diverge the members' point sets, carry λ, and key their draws by
  the global epoch; checkpoints round-trip bit for bit and refuse another
  member count or θ; the ``factory.*`` instruments; the validation
  errors; the family step captured once (a stand-in graph) equals eager.
"""

import numpy as np
import pytest
import torch

import jax

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.factory import member_slice as jax_member_slice
from tensordiffeq_tpu_torch.factory import (SurrogateFactory, member_slice,
                                            stack_members)
from tensordiffeq_tpu_torch.weights import params_from_jax

from test_torch_chunk import StandInGraph

torch.set_num_threads(1)
N_F = 256
LAYERS = [2, 12, 12, 1]
THETAS = [0.001, 0.01, 0.02]
RTOL = 5e-3


def make_domain(pkg):
    d = pkg.DomainND(["x", "t"], time_var="t")
    d.add("x", [-1.0, 1.0], 32)
    d.add("t", [0.0, 1.0], 8)
    d.generate_collocation_points(N_F, seed=0)
    return d


def make_bcs(pkg, d):
    return [pkg.IC(d, [lambda x: x ** 2 * np.cos(np.pi * x)], var=[["x"]]),
            pkg.dirichletBC(d, val=0.0, var="x", target="upper"),
            pkg.dirichletBC(d, val=0.0, var="x", target="lower")]


def f_model_for(pkg):
    grad = pkg.grad

    def f_model_fam(u, x, t, th):
        return grad(u, "t")(x, t) - th * grad(grad(u, "x"), "x")(x, t) \
            + 5.0 * u(x, t) ** 3 - 5.0 * u(x, t)

    return f_model_fam


SA_KW = dict(
    Adaptive_type=1,
    dict_adaptive={"residual": [True], "BCs": [False] * 3},
    init_weights={"residual": [np.ones((N_F, 1))], "BCs": [None] * 3})


def make_factory(thetas, sa=True, seed=0, **kw):
    d = make_domain(tdqt)
    return SurrogateFactory(LAYERS, f_model_for(tdqt), d, make_bcs(tdqt, d),
                            thetas=thetas, seed=seed, verbose=False,
                            device="cpu", **dict(SA_KW if sa else {}, **kw))


def solo(theta, seed, sa=True, **kw):
    d = make_domain(tdqt)
    s = tdqt.CollocationSolverND(verbose=False, seed=seed, device="cpu")
    f = f_model_for(tdqt)
    s.compile(LAYERS, lambda u, x, t: f(u, x, t, theta), d,
              make_bcs(tdqt, d), **dict(SA_KW if sa else {}, **kw))
    return s


def flat_bytes(tensors) -> list:
    return [t.detach().numpy().tobytes() for t in tensors]


def poison(fac, m):
    with torch.no_grad():
        for p in fac.params:
            p[m].fill_(float("nan"))


# --------------------------------------------------------------------------- #
# parity with the JAX package
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_pair():
    """The JAX 3-member factory and the port's, from the JAX members'
    parameters; the step-0 values and gradients of both, then 20 steps."""
    d = make_domain(tdq)
    jfac = tdq.SurrogateFactory(LAYERS, f_model_for(tdq), d,
                                make_bcs(tdq, d), thetas=THETAS,
                                fused=False, verbose=False, **SA_KW)
    init = [params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_member_slice(jfac.params, m)), device="cpu")
        for m in range(len(THETAS))]
    fac = make_factory(THETAS, init_params=init)
    trainables = {"params": jfac.params, "lambdas": jfac.lambdas}
    jt, jc, jg, _ = jax.vmap(jfac._member_vg)(trainables, jfac.X_f,
                                                jfac.thetas)
    jax_step0 = dict(
        totals=np.asarray(jt),
        params=[[t for pair in params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_member_slice(jg["params"], m)), device="cpu")
            for t in pair] for m in range(len(THETAS))],
        lam=np.asarray(jg["lambdas"]["residual"][0]))
    step0 = fac._family_value_and_grads(fac.params, fac.lambdas, fac.X_f)
    jfac.fit(tf_iter=20, chunk=10)
    fac.fit(tf_iter=20, chunk=10)
    return jfac, fac, jax_step0, step0


def test_family_step_0_matches_jax(jax_pair):
    jfac, fac, want, got = jax_pair
    totals, g_params, g_lam = got
    np.testing.assert_allclose(totals.numpy(), want["totals"], rtol=RTOL)
    for m in range(len(THETAS)):
        for g, w in zip(g_params, want["params"][m]):
            w = w.numpy()
            scale = np.abs(w).max() + 1e-5
            assert np.abs(g[m].numpy() - w).max() / scale <= RTOL
        w = want["lam"][m]
        assert np.abs(g_lam[0][m].numpy() - w).max() / (
            np.abs(w).max() + 1e-5) <= RTOL


def test_family_histories_match_jax(jax_pair):
    jfac, fac, _, _ = jax_pair
    assert fac.engine == "fused-minimax" and jfac.engine == "generic"
    assert len(fac.losses) == len(jfac.losses) == 20
    for key in ("Total Loss", "Residual_0", "BC_0"):
        want = np.stack([np.asarray(r[key]) for r in jfac.losses])
        got = np.stack([r[key] for r in fac.losses])
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(
        fac.lambdas["residual"][0].detach().numpy(),
        np.asarray(jfac.lambdas["residual"][0]), rtol=RTOL)
    assert fac.frozen_at == jfac.frozen_at == {}


# --------------------------------------------------------------------------- #
# the anchor
# --------------------------------------------------------------------------- #
def test_one_member_family_bit_identical_to_plain_solver():
    fac = make_factory([0.001])
    fac.fit(tf_iter=30, chunk=10)
    s = solo(0.001, seed=0)
    s.fit(tf_iter=30, chunk=10)
    assert fac.engine == "fused-minimax" and s.engine == "fused-minimax"
    got = [t for pair in fac.member_params(0) for t in pair]
    assert flat_bytes(got) == flat_bytes(s.net.params())
    assert fac.lambdas["residual"][0][0].numpy().tobytes() == \
        s.lambdas["residual"][0].detach().numpy().tobytes()
    assert [float(r["Total Loss"][0]) for r in fac.losses] == \
        [r["Total Loss"] for r in s.losses]


def test_family_members_track_solo_references():
    """Each member of a 2-member family against its matched-seed solo
    solver: the same engine per member, the BC terms and Adam on the
    stacked tensors; measured within 2e-7 scale-relative."""
    thetas = [0.001, 0.01]
    fac = make_factory(thetas, sa=False)
    fac.fit(tf_iter=20, chunk=10)
    for m, th in enumerate(thetas):
        s = solo(th, seed=m, sa=False)
        s.fit(tf_iter=20, chunk=10)
        got = np.array([r["Total Loss"][m] for r in fac.losses])
        want = np.array([r["Total Loss"] for r in s.losses])
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fused,engine", [(None, "fused-minimax"),
                                          (True, "fused"),
                                          (False, "generic")])
def test_family_engine_matches_template_adoption(fused, engine):
    kw = {"minimax": False} if fused is True else {}
    fac = make_factory([0.001, 0.01], sa=False, fused=fused, **kw)
    assert fac.engine == engine
    assert fac._template.engine == engine
    fac.fit(tf_iter=2, chunk=2)
    assert np.isfinite(fac.member_losses()).all()


@pytest.mark.parametrize("fused", [None, True])
def test_every_member_lowering_is_cross_checked(fused, monkeypatch):
    """Every member's residual term is held to the generic engine with its
    own θ at build, not only member 0's: a member whose term was built
    with another member's θ is refused."""
    kw = {"minimax": False} if fused is True else {}
    thetas = [0.001, 0.5]
    fac = make_factory(thetas, fused=fused, **kw)
    assert fac._crosscheck_members() == (None, None)
    real = SurrogateFactory._member_fns
    monkeypatch.setattr(SurrogateFactory, "_member_fns",
                        lambda self, theta: real(self, self.member_thetas[0]))
    with pytest.raises(ValueError, match="member 1"):
        make_factory(thetas, fused=fused, **kw)


# --------------------------------------------------------------------------- #
# divergence
# --------------------------------------------------------------------------- #
def test_nan_member_is_frozen_and_cannot_poison_the_family():
    facA = make_factory([0.001, 0.01])
    facB = make_factory([0.001, 0.01])
    poison(facB, 1)
    facA.fit(tf_iter=10, chunk=5)
    facB.fit(tf_iter=10, chunk=5)
    assert facB.alive.tolist() == [True, False]
    assert facB.frozen_at == {1: 0}
    assert flat_bytes(p[0] for p in facA.params) == \
        flat_bytes(p[0] for p in facB.params)
    assert facA.lambdas["residual"][0][0].detach().numpy().tobytes() == \
        facB.lambdas["residual"][0][0].detach().numpy().tobytes()
    assert [r["Total Loss"][0] for r in facA.losses] == \
        [r["Total Loss"][0] for r in facB.losses]


def test_frozen_at_records_global_epoch_across_fits():
    fac = make_factory([0.001, 0.01])
    fac.fit(tf_iter=4, chunk=2)
    poison(fac, 1)
    fac.fit(tf_iter=4, chunk=2)
    assert fac.frozen_at == {1: 4}


def test_all_members_frozen_raises_training_diverged():
    from tensordiffeq_tpu_torch.telemetry import TrainingDiverged
    fac = make_factory([0.001, 0.01])
    poison(fac, 0)
    poison(fac, 1)
    with pytest.raises(TrainingDiverged):
        fac.fit(tf_iter=10, chunk=5)
    assert not fac.alive.any()


# --------------------------------------------------------------------------- #
# per-member redraws
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["pool", "ascent"])
def test_family_resample_diverges_member_point_sets_and_carries_lambda(mode):
    from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry,
                                                  TrainingTelemetry)
    reg = MetricsRegistry()
    fac = make_factory([0.001, 0.01])
    X0 = fac.X_f.clone()
    fac.fit(tf_iter=20, chunk=5, resample_every=5, resample_mode=mode,
            telemetry=TrainingTelemetry(registry=reg))
    X1 = fac.X_f
    assert X1.shape == X0.shape
    assert not torch.equal(X1[0], X0[0])  # member 0 redrew
    assert not torch.equal(X1[0], X1[1])  # the members diverged
    lam = fac.lambdas["residual"][0].detach()
    assert lam.shape[:2] == (2, N_F) and torch.isfinite(lam).all()
    assert np.isfinite(fac.member_losses()).all()
    adopted = [r for r in fac.redraws if r["adopted"] is not None]
    assert [r["adopted"] for r in adopted] == [10, 15]
    assert fac.redraws[-1]["adopted"] is None  # dispatched at 15, discarded
    assert all(0.0 <= r["stats"]["kept_fraction"] <= 1.0 for r in adopted)
    d = reg.as_dict()
    assert d["counters"]["resample.redraws"] == 2
    assert d["gauges"]["resample.score_flops"] > 0


def test_family_redraw_keeps_rows_lambda_and_moments_bit_for_bit():
    """The carry through a swap: a kept row's λ and λ-ascent moments are
    gathered exactly, a fresh row's λ is the member's kept mean and its
    moments zero."""
    from tensordiffeq_tpu_torch.ops import resampling
    fac = make_factory([0.001, 0.01])
    fac.fit(tf_iter=5, chunk=5)
    step = fac._step
    lam = fac.lambdas["residual"][0]
    st = fac._opt[1].state[lam]
    before = [lam.detach().clone(), st["exp_avg"].clone(),
              st["exp_avg_sq"].clone()]
    sampler = resampling.FamilyResampler(
        lambda m, p, X: fac._residuals[m](p, X), fac.domain.xlimits, N_F, 2,
        seed=3)
    swap = sampler.redraw([p.detach() for p in fac.params], fac.X_f,
                          [0, 1], 7)
    step.adopt(swap.X_new, swap)
    for m in range(2):
        kept = swap.kept[m]
        idx = swap.idx[m][kept]
        for now, old in zip([lam.detach(), st["exp_avg"], st["exp_avg_sq"]],
                            before):
            assert torch.equal(now[m][kept], old[m][idx])
        fresh = ~kept
        assert fresh.any()
        mean_kept = before[0][m][idx].mean(0)
        torch.testing.assert_close(lam.detach()[m][fresh],
                                   mean_kept.expand(int(fresh.sum()), 1))
        assert (st["exp_avg"][m][fresh] == 0).all()
        assert torch.equal(fac.X_f[m], swap.X_new[m])


def test_family_redraw_keys_advance_across_fits(monkeypatch):
    from tensordiffeq_tpu_torch.ops import resampling
    from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry,
                                                  TrainingTelemetry)
    seen = []
    orig = resampling.FamilyResampler.redraw

    def spy(self, params, X, members, epoch):
        seen.append(int(epoch))
        return orig(self, params, X, members, epoch)

    monkeypatch.setattr(resampling.FamilyResampler, "redraw", spy)
    swaps = []

    class Tele(TrainingTelemetry):
        def on_resample(self, phase, epoch, *a, **kw):
            swaps.append((int(epoch), int(kw["dispatched_epoch"])))
            super().on_resample(phase, epoch, *a, **kw)

    tele = Tele(registry=MetricsRegistry())
    fac = make_factory([0.001, 0.01])
    fac.fit(tf_iter=15, chunk=5, resample_every=5, telemetry=tele)
    fac.fit(tf_iter=15, chunk=5, resample_every=5, telemetry=tele)
    assert seen == [5, 10, 20, 25]
    assert swaps == [(10, 5), (25, 20)]


def test_family_carry_and_stacking_helpers():
    """``carry_rows_family`` is ``carry_rows`` per member; ``stack_members``
    and ``member_slice`` keep ``None`` slots and refuse a mismatch."""
    from tensordiffeq_tpu_torch.ops.resampling import (carry_rows,
                                                       carry_rows_family)
    gen = torch.Generator().manual_seed(0)
    rows = torch.rand(3, 10, 1, generator=gen)
    idx = torch.randint(0, 20, (3, 10), generator=gen)
    kept = idx < 10
    got, drift = carry_rows_family(rows, idx, kept)
    for m in range(3):
        want, d = carry_rows(rows[m], idx[m], kept[m])
        assert torch.equal(got[m], want) and torch.equal(drift[m], d)
    tree = stack_members([{"a": torch.ones(2), "b": None},
                          {"a": torch.zeros(2), "b": None}])
    assert tree["b"] is None and tree["a"].shape == (2, 2)
    assert torch.equal(member_slice(tree, 1)["a"], torch.zeros(2))
    with pytest.raises(ValueError, match="adaptive"):
        stack_members([{"a": None}, {"a": torch.ones(1)}])


# --------------------------------------------------------------------------- #
# checkpoints, graphs, serving, telemetry, validation
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def family_fit():
    fac = make_factory([0.001, 0.01])
    fac.fit(tf_iter=20, chunk=10)
    return fac


@pytest.mark.parametrize("thetas", [[0.001, 0.01], [0.001]])
def test_family_checkpoint_roundtrip(thetas, tmp_path):
    """Saved after 10 steps and restored into a fresh factory: the state
    bit for bit, and 4 more steps bit for bit the saved factory's own (a
    1-member family's checkpoint holds its solver's state)."""
    fac = make_factory(thetas)
    fac.fit(tf_iter=10, chunk=5)
    fac.save_checkpoint(str(tmp_path / "ck"))
    fac2 = make_factory(thetas)
    fac2.restore_checkpoint(str(tmp_path / "ck"))
    assert flat_bytes(fac2.params) == flat_bytes(fac.params)
    assert flat_bytes(fac2.lambdas["residual"]) == \
        flat_bytes(fac.lambdas["residual"])
    assert len(fac2.losses) == len(fac.losses) == 10
    for f in (fac, fac2):
        f.fit(tf_iter=4, chunk=2)
    assert flat_bytes(fac2.params) == flat_bytes(fac.params)
    assert [r["Total Loss"].tolist() for r in fac2.losses] == \
        [r["Total Loss"].tolist() for r in fac.losses]


def test_member_count_mismatch_rejected(family_fit, tmp_path):
    family_fit.save_checkpoint(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="members"):
        make_factory([0.001, 0.01, 0.02]).restore_checkpoint(
            str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="coefficients"):
        make_factory([0.005, 0.05]).restore_checkpoint(str(tmp_path / "ck"))


def test_family_step_captured_once_equals_eager():
    facs = [make_factory([0.001, 0.01]) for _ in range(2)]
    box = {}
    box["s"] = facs[0]._family_step(
        False, make_graph=lambda stream: StandInGraph(box["s"]._keyed))
    facs[0].fit(tf_iter=12, chunk=4)
    facs[1].fit(tf_iter=12, chunk=4, _graphs=False)
    assert facs[0]._step.graph.captures == 1
    assert flat_bytes(facs[0].params) == flat_bytes(facs[1].params)
    assert [r["Total Loss"].tolist() for r in facs[0].losses] == \
        [r["Total Loss"].tolist() for r in facs[1].losses]


def test_member_accessors_and_surrogate(family_fit):
    hist = family_fit.member_history(1)
    assert len(hist) == 20 and "Alive" not in hist[0]
    assert hist[-1]["Total Loss"] == pytest.approx(
        float(family_fit.member_losses()[1]))
    sur = family_fit.member_surrogate(1)
    X = np.random.RandomState(0).uniform(-1, 1, (16, 2)).astype(np.float32)
    served = sur.engine(min_bucket=16, max_bucket=16).u(X)
    layers = family_fit.member_params(1)
    want = family_fit.apply_fn(layers, torch.from_numpy(X)).detach().numpy()
    assert np.abs(np.asarray(served).reshape(-1)
                  - want.reshape(-1)).max() <= 1e-6 * np.abs(want).max()
    best = family_fit.member_params(1, best=True)
    assert len(best) == len(layers)
    f1 = family_fit.member_f_model(1)
    assert callable(f1)


def test_family_fit_emits_factory_instruments(tmp_path):
    from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry, RunLogger,
                                                  TrainingTelemetry,
                                                  read_events)
    logger = RunLogger(str(tmp_path / "run"), registry=MetricsRegistry())
    step_time_calls = []

    class Tele(TrainingTelemetry):
        def on_step_time(self, phase, n_steps, *a, **kw):
            step_time_calls.append(n_steps)
            super().on_step_time(phase, n_steps, *a, **kw)

    tele = Tele(logger=logger)
    fac = make_factory([0.001, 0.01])
    poison(fac, 1)
    fac.fit(tf_iter=6, chunk=3, telemetry=tele, converge_loss=1e9)
    assert step_time_calls == [3, 3]
    g = logger.registry.as_dict()["gauges"]
    c = logger.registry.as_dict()["counters"]
    assert g["factory.members"] == 2
    assert g["factory.members_frozen"] == 1
    assert g["factory.members_converged"] == 1
    assert g["factory.pts_per_s"] > 0
    assert any(k.startswith("factory.loss_quantile") for k in g)
    assert c["factory.divergences"] == 1
    assert any(k.startswith("cost.flops_per_step") for k in g)
    logger.close()
    kinds = {e["kind"] for e in read_events(str(tmp_path / "run"))}
    assert {"family_stats", "run_config", "step_cost", "fit_end"} <= kinds


def test_validation_errors():
    d = make_domain(tdqt)
    f = f_model_for(tdqt)
    kw = dict(verbose=False, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        SurrogateFactory(LAYERS, f, d, make_bcs(tdqt, d), thetas=[], **kw)
    with pytest.raises(ValueError, match="NTK"):
        SurrogateFactory(LAYERS, f, d, make_bcs(tdqt, d), thetas=[0.1],
                         Adaptive_type=3, **kw)
    with pytest.raises(ValueError, match="divide evenly"):
        SurrogateFactory([2, 8, 1], f, d, make_bcs(tdqt, d),
                         thetas=[0.1, 0.2, 0.3], dist=2, **kw)
    with pytest.raises(ValueError, match="init_params"):
        SurrogateFactory([2, 8, 1], f, d, make_bcs(tdqt, d),
                         thetas=[0.1, 0.2], init_params=[None], **kw)
    with pytest.raises(ValueError, match="shape"):
        SurrogateFactory([2, 8, 1], f, d, make_bcs(tdqt, d),
                         thetas=[0.1, 0.2],
                         init_params=[None, [(torch.zeros(2, 9),
                                              torch.zeros(9)),
                                             (torch.zeros(9, 1),
                                              torch.zeros(1))]], **kw)
    if not torch.cuda.is_available():
        # the card by default, as every entry point
        with pytest.raises(tdqt.utils.CudaUnavailableError):
            SurrogateFactory([2, 8, 1], f, d, make_bcs(tdqt, d),
                             thetas=[0.1], verbose=False)


def test_export_family_roundtrips_through_register_family(family_fit,
                                                          tmp_path):
    """export_family writes each live member as a v2 fleet artifact and a
    manifest with the JAX package's keys; a frozen member is skipped and
    recorded; ``FleetRouter.register_family`` loads the batch keyed by
    the original member index, and each member serves its own ``u`` bit
    for bit a direct engine over its artifact, and its residual from the
    lowered tape with no f_model attached."""
    from tensordiffeq_tpu_torch.factory import FAMILY_MANIFEST
    from tensordiffeq_tpu_torch.fleet import FleetRouter, TenantPolicy

    reg = tdqt.telemetry.MetricsRegistry()
    path = str(tmp_path / "fam")
    manifest = family_fit.export_family(path, min_bucket=64, max_bucket=128,
                                        registry=reg)
    assert set(manifest) == {"format", "n_members", "members", "frozen",
                             "thetas", "layer_sizes", "varnames"}
    assert manifest["members"] == {"0": "member_000", "1": "member_001"}
    assert manifest["frozen"] == {} and manifest["n_members"] == 2
    assert manifest["layer_sizes"] == LAYERS
    assert manifest["varnames"] == ["x", "t"]
    assert reg.as_dict()["counters"]["factory.exports"] == 2
    import json
    import os
    with open(os.path.join(path, FAMILY_MANIFEST)) as fh:
        assert json.load(fh) == manifest

    router = FleetRouter(max_loaded=2, device="cpu")
    pol = TenantPolicy(min_bucket=64, max_bucket=128, max_batch=256,
                       max_latency_s=0.005)
    names = router.register_family(path, policy=pol, prefix="m")
    assert names == {0: "m000", 1: "m001"}
    X = np.random.RandomState(2).uniform(-1, 1, (40, 2)).astype(np.float32)
    for m, t in names.items():
        lt = router.load(t)
        assert lt.warm["aot"] == 2  # the residual rungs run the tape
        u = router.query(t, X)
        want = family_fit.member_surrogate(m).engine(
            min_bucket=64, max_bucket=128).u(X)
        assert np.array_equal(u, want)
        f = router.query(t, X, kind="residual")
        generic = family_fit.member_surrogate(m).engine(
            min_bucket=64, max_bucket=128).residual(X)
        ok, why = tdqt.ops.fused.crosscheck_residuals(generic, f)
        assert ok, why

    # a frozen member is skipped and recorded with its epoch
    fac = make_factory([0.001, 0.01, 0.02])
    poison(fac, 1)
    fac.fit(tf_iter=4, chunk=2)
    manifest = fac.export_family(str(tmp_path / "fam2"), min_bucket=64,
                                 max_bucket=64, kinds=("u",))
    assert sorted(manifest["members"]) == ["0", "2"]
    assert manifest["frozen"] == {"1": fac.frozen_at[1]}
