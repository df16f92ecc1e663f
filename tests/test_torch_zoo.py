"""The port's PDE zoo (``tensordiffeq_tpu_torch/zoo``) held to the JAX
package's.

* the registry-validation matrix of ``tests/test_zoo.py``, on the port's
  registry: duplicate and malformed ids, missing sizes, bad budgets and
  gates, residual-arity drift, unknown entries and sizes, a validated
  ``spec=`` override;
* the same nine ids, titles, equations, tags and declared sizes as the JAX
  registry;
* for each scalar entry (the systems: ``test_torch_zoo_systems.py``) at a
  reduced size (``n_f`` 256, widths (8, 8)), built on both packages: the
  collocation points, every boundary condition's inputs and targets and
  the λ init are equal bit for bit (``burgers-assim``'s IC
  rows are drawn unseeded in both packages, so the JAX build's rows are
  carried into the port's); the port's CPU solver adopts
  ``fused-minimax-plain`` with ``n_eq == n_components``; and with the JAX
  parameters carried across, its step-0 loss components equal the JAX
  solver's within 1e-5 scale-relative (the same f32 arithmetic in another
  summation order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tensordiffeq_tpu import zoo as jzoo
from tensordiffeq_tpu_torch import zoo
from tensordiffeq_tpu_torch.weights import params_from_jax
from tensordiffeq_tpu_torch.zoo import (Budget, SizeSpec, ZooEntry,
                                        ZooValidationError)

torch.set_num_threads(1)
LOSS_RTOL = 1e-5


# --------------------------------------------------------------------------- #
# registry declarations (tests/test_zoo.py's matrix)
# --------------------------------------------------------------------------- #
def _spec(**kw):
    base = dict(n_f=64, widths=(4,), grid=(8, 3),
                budget=Budget(10, 5), gate_rel_l2=0.5)
    base.update(kw)
    return SizeSpec(**base)


def _entry(**kw):
    base = dict(id="tmp-entry", title="t", equation="e", n_inputs=2,
                n_components=1, build=lambda spec: None,
                reference=lambda spec: None,
                sizes={"micro": _spec(), "full": _spec()})
    base.update(kw)
    return ZooEntry(**base)


def test_registry_holds_the_jax_packages_entries():
    assert zoo.ids() == jzoo.ids()
    assert len(zoo.ids()) == 9
    for e in zoo.entries():
        j = jzoo.get(e.id)
        assert (e.title, e.equation, e.n_inputs, e.n_components, e.tags) \
            == (j.title, j.equation, j.n_inputs, j.n_components, j.tags)
        assert set(e.sizes) == set(j.sizes)
        for size, spec in e.sizes.items():
            js = j.sizes[size]
            assert (spec.n_f, spec.widths, spec.grid, spec.budget.adam,
                    spec.budget.lbfgs, spec.gate_rel_l2,
                    spec.gate_residual) == (
                js.n_f, js.widths, js.grid, js.budget.adam,
                js.budget.lbfgs, js.gate_rel_l2, js.gate_residual)
        assert (e.reference is None) == (j.reference is None)
    assert len([e for e in zoo.entries() if e.system]) >= 3


def test_register_rejects_duplicate_and_bad_ids():
    with pytest.raises(ZooValidationError, match="already registered"):
        zoo.register(_entry(id="burgers"))
    with pytest.raises(ZooValidationError, match="kebab-case"):
        zoo.register(_entry(id="Not_Kebab"))


def test_register_rejects_missing_size_and_bad_budget():
    with pytest.raises(ZooValidationError, match="missing declared"):
        zoo.register(_entry(sizes={"micro": _spec()}))
    with pytest.raises(ZooValidationError, match="budget"):
        zoo.register(_entry(sizes={
            "micro": _spec(budget=Budget(0, 0)), "full": _spec()}))
    with pytest.raises(ZooValidationError, match="budget"):
        zoo.register(_entry(sizes={
            "micro": _spec(budget=Budget(-5, 10)), "full": _spec()}))


def test_register_rejects_bad_gates():
    with pytest.raises(ZooValidationError, match="exactly one"):
        zoo.register(_entry(sizes={
            "micro": _spec(gate_rel_l2=None), "full": _spec()}))
    with pytest.raises(ZooValidationError, match="exactly one"):
        zoo.register(_entry(sizes={
            "micro": _spec(gate_residual=0.1), "full": _spec()}))
    with pytest.raises(ZooValidationError, match="predicting zero"):
        zoo.register(_entry(sizes={
            "micro": _spec(gate_rel_l2=1.5), "full": _spec()}))
    with pytest.raises(ZooValidationError, match="residual-only"):
        zoo.register(_entry(reference=None))
    with pytest.raises(ZooValidationError, match="rel-L2"):
        zoo.register(_entry(sizes={
            "micro": _spec(gate_rel_l2=None, gate_residual=0.1),
            "full": _spec()}))


def test_build_solver_rejects_residual_arity_drift():
    def bad_build(spec):
        real = zoo.get("burgers")
        return real.build(real.spec("micro"))  # layer_sizes end in 1

    entry = _entry(id="bad-arity", n_components=2, build=bad_build,
                   sizes={"micro": _spec(), "full": _spec()})
    with pytest.raises(ZooValidationError, match="n_components=2"):
        zoo.build_solver(entry, "micro", device="cpu")


def test_unknown_entry_and_unknown_size_are_typed_errors():
    with pytest.raises(ZooValidationError, match="unknown zoo entry"):
        zoo.get("no-such-entry")
    with pytest.raises(ZooValidationError, match="declares no"):
        zoo.get("burgers").spec("nano")
    assert ZooValidationError.trace_id is None


def test_spec_override_is_validated():
    entry = zoo.get("burgers")
    bad = dataclasses.replace(entry.spec("micro"), n_f=-1)
    with pytest.raises(ZooValidationError, match="n_f"):
        zoo.build_solver(entry, spec=bad, device="cpu")


def test_zoo_package_binds_entries_function_not_submodule():
    # the import-shadow the JAX package pins: zoo.entries is the registry
    # function, and importing the package registered the seed entries
    assert callable(zoo.entries) and len(zoo.entries()) == 9


# --------------------------------------------------------------------------- #
# every entry, built on both packages at a reduced size
# --------------------------------------------------------------------------- #
def _reduced(entry_id: str) -> SizeSpec:
    return dataclasses.replace(zoo.get(entry_id).spec("micro"), n_f=256,
                               widths=(8, 8))


def _bc_arrays(bc) -> list:
    out = []
    for name in ("input", "val", "upper", "lower"):
        v = getattr(bc, name, None)
        if v is None:
            continue
        out.extend(v if isinstance(v, list) else [v])
    return [np.asarray(a) for a in out]


def _carry_ic_rows(jp, tp):
    """The port's problem with the JAX build's IC rows (``burgers-assim``
    draws them unseeded in both packages)."""
    for jbc, tbc in zip(jp.bcs, tp.bcs):
        if getattr(jbc, "isInit", False):
            tbc.input = np.array(jbc.input)
            tbc.val = np.array(jbc.val)
    return tp


def _built_pair(entry_id: str):
    spec = _reduced(entry_id)
    jentry, tentry = jzoo.get(entry_id), zoo.get(entry_id)
    jp = jentry.build(spec, seed=0) if entry_id == "allen-cahn-sa" \
        else jentry.build(spec)
    tp = tentry.build(spec, seed=0) if entry_id == "allen-cahn-sa" \
        else tentry.build(spec)
    tp = _carry_ic_rows(jp, tp)
    # the solvers compile the problems just compared
    jfixed = dataclasses.replace(jentry, build=lambda s: jp)
    tfixed = dataclasses.replace(tentry, build=lambda s: tp)
    js = jzoo.build_solver(jfixed, spec=spec)
    ts = zoo.build_solver(tfixed, spec=spec, device="cpu")
    return jp, tp, js, ts


SCALAR = [e.id for e in zoo.entries() if not e.system]


@pytest.mark.parametrize("entry_id", SCALAR)
def test_entry_builds_like_the_jax_entry(entry_id):
    check_entry_against_jax(entry_id)


def check_entry_against_jax(entry_id):
    jp, tp, js, ts = _built_pair(entry_id)
    entry = zoo.get(entry_id)
    # the problem: points, BC data and the λ init, bit for bit
    assert tuple(tp.layer_sizes) == tuple(jp.layer_sizes)
    np.testing.assert_array_equal(np.asarray(tp.domain.X_f),
                                  np.asarray(jp.domain.X_f))
    assert len(tp.bcs) == len(jp.bcs)
    for jbc, tbc in zip(jp.bcs, tp.bcs):
        assert type(jbc).__name__ == type(tbc).__name__
        ja, ta = _bc_arrays(jbc), _bc_arrays(tbc)
        assert len(ja) == len(ta) > 0
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(b, a)
    if jp.data is not None:
        for a, b in zip(jp.data, tp.data):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(ts.X_f.numpy(), np.asarray(js.X_f))
    for key in ("residual", "BCs"):
        assert len(ts.lambdas[key]) == len(js.lambdas[key])
        for jl, tl in zip(js.lambdas[key], ts.lambdas[key]):
            assert (jl is None) == (tl is None)
            if jl is not None:
                np.testing.assert_array_equal(tl.detach().numpy(),
                                              np.asarray(jl))
    # the engine: the plain flavor of the minimax step, E equations
    assert zoo.engine_label(ts) == "fused-minimax-plain"
    assert jzoo.engine_label(js).startswith("fused-minimax")
    assert int(ts._minimax_n_eq) == entry.n_components
    # step 0 from the JAX parameters
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    _, jc = js.update_loss()
    _, tc = ts.update_loss()
    assert set(tc) == set(jc)
    for k in jc:
        a = float(np.asarray(jc[k]))
        b = float(tc[k]) if not isinstance(tc[k], torch.Tensor) \
            else float(tc[k].detach())
        assert abs(b - a) <= LOSS_RTOL * max(abs(a), 1e-12), (k, a, b)
