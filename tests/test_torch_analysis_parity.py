"""The port's tdqlint against the JAX package's: both engines, each loaded
standalone (stdlib only: no torch, no JAX), run over the same fixture
sources with the package directory renamed (``tensordiffeq_tpu/`` for the
JAX engine, ``tensordiffeq_tpu_torch/`` for the port's).

For the framework-neutral rules (``no-bare-print``, ``span-leak``,
``metrics-catalog``, ``bare-raise-discipline``, ``dtype-discipline``) and
the engine's three meta rules the ``(line, rule)`` findings must be
identical.  The host-sync rule's hot contexts differ by framework, so it
is held at corresponding lines instead: a ``@jax.jit`` body with
``float(x)`` and its counterpart, a captured step function with
``.item()``, both flagged.
"""

import importlib.util
import os
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(pkg: str, name: str):
    if name in sys.modules:
        return sys.modules[name]
    d = os.path.join(REPO, pkg, "analysis")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(d, "__init__.py"), submodule_search_locations=[d])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ENGINES = {"tensordiffeq_tpu": _load("tensordiffeq_tpu", "_tdqa_standalone"),
           "tensordiffeq_tpu_torch": _load("tensordiffeq_tpu_torch",
                                           "_tdqta_standalone")}
CATALOG = {"tensordiffeq_tpu": os.path.join("docs", "metrics.md"),
           "tensordiffeq_tpu_torch": os.path.join(
               "tensordiffeq_tpu_torch", "telemetry", "metrics.md")}


def run(root, pkg: str, rule_id: str, files: dict, catalog: str = ""):
    """One engine's ``(line, rule)`` findings of ``rule_id`` over ``files``
    (paths relative to its package dir) written under ``root/pkg``."""
    mod = ENGINES[pkg]
    rules = sys.modules[mod.__name__ + ".rules"]
    engine = sys.modules[mod.__name__ + ".engine"]
    for rel, src in files.items():
        p = root / pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    cat = root / CATALOG[pkg]
    cat.parent.mkdir(parents=True, exist_ok=True)
    cat.write_text(textwrap.dedent(catalog))
    rule = rules.RULES_BY_ID[rule_id]
    if rule_id == "metrics-catalog":
        rule = type(rule)(legacy=())
    findings, _ = engine.run_rules([rule], repo_root=str(root),
                                   known_rules=frozenset(rules.RULES_BY_ID))
    return sorted((f.line, f.rule) for f in findings)


CASES = {
    "no-bare-print": ("no-bare-print", {
        "mod.py": "x = 1\nprint(x)\nif x:\n    print('y', x)\n",
        "telemetry/sink.py": "print('narration')\n",
        "training/progress.py": "print('bar')\n",
        "analysis/__main__.py": "print('lint output')\n",
        "analysis/rules.py": "def f():\n    print('debug')\n",
    }, ""),
    "span-leak": ("span-leak", {
        "mod.py": """
            import re

            def f(tracer, tr, holder):
                tracer.span("never.entered")
                sp = tr.open_span("never.closed")
                tr.open_span("discarded")
                with tracer.span("entered"):
                    pass
                ok = tr.open_span("closed")
                tr.close_span(ok)
                holder.span = tr.open_span("stored")
                m = re.match("a", "a").span()
                return tr.open_span("returned"), m
        """,
    }, ""),
    "metrics-catalog": ("metrics-catalog", {
        "mod.py": """
            reg.counter("serving.good").inc()
            reg.counter("not.in.catalog").inc()
            reg.gauge("badname").set(1)
            reg.histogram("a.b" if flag else "c.d").observe(1)
        """,
    }, """
        # metrics
        | name | meaning |
        |---|---|
        | `serving.good` | fine |
        | `stale.row` | emitted by nothing |
        | `a.b` | one arm |
    """),
    "bare-raise-discipline": ("bare-raise-discipline", {
        "errors.py": """
            class FooError(RuntimeError):
                pass

            class TypedError(ValueError):
                trace_id = None

            class SubError(TypedError):
                pass

            class _Private(Exception):
                pass
        """,
        "mod.py": """
            def f(flag):
                if flag:
                    raise RuntimeError("boom")
                if flag > 1:
                    raise Exception
                raise ValueError("fine")
        """,
    }, ""),
    "dtype-discipline": ("dtype-discipline", {
        "ops/mod.py": """
            import numpy as np
            a = np.zeros(3, np.float64)
            b = np.asarray(a, "float64")
            c = np.zeros(3, np.float32)
        """,
        "serving/engine.py": "import numpy as np\nx = np.float64(1)\n",
        "models/mod.py": "import numpy as np\nx = np.float64(1)\n",
    }, ""),
    "meta": ("no-bare-print", {
        "mod.py": """
            print('a')  # tdq: allow[no-bare-print]
            x = 1  # tdq: allow[no-bare-print] nothing here prints
            y = 2  # tdq: allow[no-such-rule] a typo'd id
            # tdq: allow[no-bare-print] the next line's print is the product
            print('b')
        """,
    }, ""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_both_engines_report_the_same_findings(tmp_path, case):
    rule_id, files, catalog = CASES[case]
    jax = run(tmp_path / "jax", "tensordiffeq_tpu", rule_id, files, catalog)
    port = run(tmp_path / "port", "tensordiffeq_tpu_torch", rule_id, files,
               catalog)
    assert jax, "the fixture must trip the rule"
    assert jax == port


def test_host_sync_flags_the_captured_step_where_jax_flags_the_jit(tmp_path):
    jax = run(tmp_path / "jax", "tensordiffeq_tpu", "host-sync-in-hot-path",
              {"mod.py": """
                  import jax

                  @jax.jit
                  def step(x):
                      y = x * 2.0
                      return float(y)

                  def helper(y):
                      return float(y)
              """})
    port = run(tmp_path / "port", "tensordiffeq_tpu_torch",
               "host-sync-in-hot-path", {"mod.py": """
                  from .training.graphs import StepGraph

                  class Step:
                      def _step(self):
                          y = self.x * 2.0
                          self.out = y.item()

                      def build(self, dev):
                          return StepGraph(self._step, list, dev, "s")
              """})
    assert jax == port == [(7, "host-sync-in-hot-path")]
