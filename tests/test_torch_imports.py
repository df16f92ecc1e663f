"""The PyTorch port stands alone: no module of ``tensordiffeq_tpu_torch``, no
line of ``chip_smoke.py`` and no line of the card tests
(``tests/test_torch_cuda.py``, run where only PyTorch is installed) imports
JAX, flax, optax or the JAX package (whose ``__init__`` imports jax, even for
its NumPy-only modules)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tensordiffeq_tpu")


def _port_files():
    files = sorted((ROOT / "tensordiffeq_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tests" / "test_torch_cuda.py"]


def _forbidden(module: str) -> bool:
    # exact top-level name: "tensordiffeq_tpu_torch" shares the prefix
    return module.split(".")[0] in FORBIDDEN


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("tensordiffeq_tpu_torch/ops/cuda_taylor.py",
                 "tensordiffeq_tpu_torch/ops/cuda_minimax.py",
                 "tensordiffeq_tpu_torch/ops/minimax.py",
                 "tensordiffeq_tpu_torch/ops/residual_tape.py",
                 "tensordiffeq_tpu_torch/models/collocation.py",
                 "tensordiffeq_tpu_torch/models/discovery.py",
                 "tensordiffeq_tpu_torch/ops/resampling.py",
                 "tensordiffeq_tpu_torch/serving/engine.py",
                 "tensordiffeq_tpu_torch/serving/batcher.py",
                 "tensordiffeq_tpu_torch/serving/surrogate.py",
                 "tensordiffeq_tpu_torch/telemetry/registry.py",
                 "tensordiffeq_tpu_torch/resilience/retry.py",
                 "tensordiffeq_tpu_torch/resilience/breaker.py",
                 "tensordiffeq_tpu_torch/profiling.py",
                 "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, bad


def test_guard_matches_exact_module_names():
    assert _forbidden("tensordiffeq_tpu.ops.taylor")
    assert _forbidden("jax.numpy")
    assert not _forbidden("tensordiffeq_tpu_torch.ops.taylor")
    tree = ast.parse("import importlib\nimportlib.import_module('flax')\n")
    assert [m for _, m in _imports(tree) if _forbidden(m)] == ["flax"]
