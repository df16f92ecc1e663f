"""The port's top-level API beside the JAX package's.

* every public name at the top of ``tensordiffeq_tpu`` whose defining module
  the port has (the same dotted path under ``tensordiffeq_tpu_torch``)
  resolves on ``tensordiffeq_tpu_torch``.  The list is read from the JAX
  package at run time, so a name added there with a ported module fails
  here until the port exports it;
* ``load_model(path, compile_model=...)`` takes the argument the JAX solver
  takes and ignores it, as that solver does: all three calls restore the
  same parameters.
"""

import importlib.util
import types

import numpy as np
import pytest

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch import CollocationSolverND

from test_torch_checkpoint import leaves, make_solver


def _port_module(name: str):
    """The port's counterpart of the JAX package's module ``name``, or
    ``None`` where the port has no such module yet."""
    port = "tensordiffeq_tpu_torch" + name[len("tensordiffeq_tpu"):]
    try:
        return importlib.util.find_spec(port)
    except ModuleNotFoundError:  # a parent package the port lacks
        return None


def _ported_top_level_names() -> list:
    names = []
    for name, obj in sorted(vars(tdq).items()):
        if name.startswith("_"):
            continue
        module = (obj.__name__ if isinstance(obj, types.ModuleType)
                  else getattr(obj, "__module__", None))
        if module and module.split(".")[0] == "tensordiffeq_tpu" \
                and _port_module(module) is not None:
            names.append(name)
    return names


def test_the_list_holds_the_names_of_ported_modules():
    names = _ported_top_level_names()
    # modules the port has: the list is not empty, and the JAX package's
    # names from modules the port lacks (fleet, factory, chaos) are not in it
    assert {"CollocationSolverND", "FourierMLP", "InferenceEngine",
            "MetricsRegistry", "RetryPolicy"} <= set(names)
    assert not {"FleetRouter", "SurrogateFactory", "Chaos"} & set(names)


@pytest.mark.parametrize("name", _ported_top_level_names())
def test_top_level_name_of_a_ported_module_resolves(name):
    assert hasattr(tdqt, name), (
        f"tensordiffeq_tpu.{name} has a ported module but "
        f"tensordiffeq_tpu_torch does not export it")
    jax_obj, port_obj = getattr(tdq, name), getattr(tdqt, name)
    # the same kind of thing: a module, a class or a function
    assert isinstance(jax_obj, types.ModuleType) \
        == isinstance(port_obj, types.ModuleType)
    assert isinstance(jax_obj, type) == isinstance(port_obj, type)


@pytest.mark.parametrize("compile_model", [None, False, True])
def test_load_model_accepts_and_ignores_compile_model(tmp_path, compile_model):
    s = make_solver()
    s.fit(tf_iter=3, chunk=3)
    path = str(tmp_path / "model.tdq")
    s.save(path)
    X = np.random.RandomState(1).rand(5, 2).astype(np.float32)
    restored = []
    for kw in ({}, {"compile_model": compile_model}):
        if compile_model is None and kw:
            continue
        s2 = CollocationSolverND(verbose=False, device="cpu")
        s2.load_model(path, **kw)
        assert s2.layer_sizes == [2, 8, 8, 1]
        restored.append((leaves(s2), s2.predict(X)[0]))
    for params, u in restored:
        for a, b in zip(params, leaves(s)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(u, s.predict(X)[0])
