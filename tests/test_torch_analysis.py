"""The port's tdqlint: one tripping and one passing fixture per rule, the
engine's suppression semantics, the graph-dump reader, and the
stdlib-only import pin.

The analysis package is loaded STANDALONE from its directory (no
``tensordiffeq_tpu_torch`` parent import, hence no torch import), as
``tests/test_analysis.py`` loads the JAX package's: this module costs
milliseconds.  ``tensordiffeq_tpu_torch/analysis/dispatch_audit.py`` is
stdlib at import too, so its graph-dump reader is tested here against two
dumps ``cudaGraphDebugDotPrint`` wrote on an NVIDIA H100 (PyTorch 2.11,
CUDA 12.8): a toy graph with one copy of each direction
(``tests/fixtures/torch_graph_toy.dot``) and the minimax solver's captured
Adam step (``tests/fixtures/torch_graph_minimax_step.dot``).
"""

import ast
import importlib.util
import os
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYSIS_DIR = os.path.join(REPO, "tensordiffeq_tpu_torch", "analysis")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
PKG = "tensordiffeq_tpu_torch"


def _load_standalone():
    """Load tensordiffeq_tpu_torch/analysis as a top-level package so the
    parent package __init__ (which imports torch) never runs."""
    name = "_tdqta_standalone"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ANALYSIS_DIR, "__init__.py"),
        submodule_search_locations=[ANALYSIS_DIR])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


A = _load_standalone()
engine = sys.modules["_tdqta_standalone.engine"]
rules = sys.modules["_tdqta_standalone.rules"]
importlib.import_module("_tdqta_standalone.dispatch_audit")
audit = sys.modules["_tdqta_standalone.dispatch_audit"]


def write(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def lint(tmp_path, sources, rule, extra=None):
    """Write a miniature repo into ``tmp_path`` and run ``rule`` on it via
    the DEFAULT walk (sources under tensordiffeq_tpu_torch/ or at
    chip_smoke.py), so project-scoped rules run too.  ``extra``: files
    that are not linted (the catalog, tests, CUDA sources)."""
    write(tmp_path, sources)
    write(tmp_path, extra or {})
    findings, _ = engine.run_rules([rule], repo_root=str(tmp_path))
    return findings


def lines(findings):
    return sorted(f.line for f in findings)


# --------------------------------------------------------------------- #
# engine: suppression semantics
# --------------------------------------------------------------------- #

TRIP_PRINT = {f"{PKG}/mod.py": "print('hello')\n"}


def test_suppression_with_reason_absorbs_finding(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py": "print('x')  # tdq: allow"
                           "[no-bare-print] the CLI's stdout is its product\n"},
                rules.NoBarePrintRule()) == []


def test_suppression_standalone_comment_covers_next_line(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py":
                           "# tdq: allow[no-bare-print] demo reason\n\n"
                           "# another comment\nprint('x')\n"},
                rules.NoBarePrintRule()) == []


def test_suppression_without_reason_fails(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py":
                               "print('x')  # tdq: allow[no-bare-print]\n"},
                    rules.NoBarePrintRule())
    assert [f.rule for f in findings] == [engine.META_MISSING_REASON]


def test_unused_suppression_fails(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py": "x = 1  # tdq: allow"
                               "[no-bare-print] nothing here trips\n"},
                    rules.NoBarePrintRule())
    assert [f.rule for f in findings] == [engine.META_UNUSED]


def test_unknown_suppression_rule_id_flagged(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("x = 1  # tdq: allow[host-sync-in-hotpath] typo'd id\n")
    findings, _ = engine.run_rules(
        [rules.NoBarePrintRule()], repo_root=str(tmp_path), files=[str(p)],
        known_rules=frozenset(rules.RULES_BY_ID))
    assert [f.rule for f in findings] == [engine.META_UNKNOWN_RULE]


def test_a_string_that_mentions_the_syntax_suppresses_nothing(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py":
                               "print('# tdq: allow[no-bare-print] no')\n"},
                    rules.NoBarePrintRule())
    assert [f.rule for f in findings] == ["no-bare-print"]


def test_project_rules_skipped_on_explicit_file_subset(tmp_path):
    p = tmp_path / PKG / "mod.py"
    write(tmp_path, {f"{PKG}/mod.py": "x = 1\n",
                     rules.CATALOG_PATH: "| `some.metric` | elsewhere |\n"})
    findings, _ = engine.run_rules(
        [rules.MetricsCatalogRule(legacy=())], repo_root=str(tmp_path),
        files=[str(p)])
    assert findings == []


def test_suppression_for_unselected_rule_is_not_judged(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py": "x = 1  # tdq: allow"
                           "[dtype-discipline] other rule's allow\n"},
                rules.NoBarePrintRule()) == []


def test_finding_format_is_file_line_rule_message(tmp_path):
    findings = lint(tmp_path, TRIP_PRINT, rules.NoBarePrintRule())
    assert len(findings) == 1
    assert findings[0].format().startswith(f"{PKG}/mod.py:1 no-bare-print ")


def test_default_scope_is_the_port_and_chip_smoke(tmp_path):
    write(tmp_path, {f"{PKG}/a.py": "x = 1\n", f"{PKG}/sub/b.py": "y = 2\n",
                     "chip_smoke.py": "z = 3\n", "bench.py": "w = 4\n",
                     "tensordiffeq_tpu/c.py": "v = 5\n"})
    got = sorted(os.path.relpath(p, tmp_path)
                 for p in engine.iter_source_files(str(tmp_path)))
    assert got == ["chip_smoke.py", f"{PKG}/a.py", f"{PKG}/sub/b.py"]


# --------------------------------------------------------------------- #
# 1 · host-sync-in-hot-path
# --------------------------------------------------------------------- #

def test_host_sync_trips_in_a_captured_step(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py": """
        import numpy as np
        from .training.graphs import StepGraph

        class Step:
            def __init__(self, dev):
                self.graph = StepGraph(self._step, self._keyed, dev, "s")

            def _step(self):
                v = self.x.sum().item()
                self.out = float(self.x[0]) + v
                np.asarray(self.x)
                self.stream.synchronize()

        def build(x, dev):
            def step():
                return bool(x.any())
            return StepGraph(step, lambda: [x], dev, "t")
    """}, rules.HostSyncRule())
    assert lines(findings) == [10, 11, 12, 13, 17]


def test_host_sync_trips_in_an_autograd_function(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/ops/mod.py": """
        import torch

        class Sq(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x

            @staticmethod
            def backward(ctx, g):
                return g.cpu()

        def helper(t):
            return t.cpu()  # not a hot context
    """}, rules.HostSyncRule())
    assert lines(findings) == [11]


def test_host_sync_chunk_runner_flags_transfers_not_float(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/training/fit.py": """
        import torch

        def read(h):
            return h.cpu().numpy()

        def fit_adam(step, n):
            hist = read(step.hist)
            torch.cuda.synchronize()
            return float(hist[0]) + step.best.item()
    """}, rules.HostSyncRule())
    # the callee's copy (one level followed) and the fence; not float()
    # of host data, not .item() outside a captured step
    assert lines(findings) == [5, 5, 9]


def test_host_sync_passes_a_clean_step(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py": """
        import torch
        from .training.graphs import StepGraph

        class Step:
            def __init__(self, dev):
                self.graph = StepGraph(self._step, self._keyed, dev, "s")

            def _step(self):
                self.best.copy_(torch.where(self.x < self.best, self.x,
                                            self.best))
                self.best.fill_(float("inf"))

            def read(self):
                return float(self.best)  # a host read outside the step
    """}, rules.HostSyncRule()) == []


# --------------------------------------------------------------------- #
# 2 · explicit-generator
# --------------------------------------------------------------------- #

def test_explicit_generator_trips(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py": """
        import numpy as np
        import torch

        def draw(n, gen):
            a = torch.rand(n)
            b = np.random.uniform(size=n)
            c = torch.empty(n).normal_()
            for _ in range(3):
                gen.manual_seed(0)
                d = torch.randn(n, generator=gen)
            return a, b, c, d
    """}, rules.ExplicitGeneratorRule())
    assert lines(findings) == [6, 7, 8, 10]


def test_explicit_generator_passes_seeded_draws(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py": """
        import numpy as np
        import torch

        def draw(n, seed, epochs):
            gen = torch.Generator().manual_seed(seed)
            rs = np.random.RandomState(seed)
            a = torch.rand(n, generator=gen)
            b = torch.empty(n).uniform_(generator=gen)
            for epoch in range(epochs):
                gen.manual_seed(seed + epoch)
                c = torch.randperm(n, generator=gen)
            return a, b, c, rs.rand(n), np.random.default_rng(seed)
    """}, rules.ExplicitGeneratorRule()) == []


# --------------------------------------------------------------------- #
# 3 · dtype-discipline
# --------------------------------------------------------------------- #

def test_dtype_discipline_trips_in_the_fused_paths(tmp_path):
    findings = lint(tmp_path, {
        f"{PKG}/ops/mod.py": """
            import numpy as np
            import torch
            a = torch.zeros(3, dtype=torch.float64)
            b = torch.zeros(3).double()
            c = np.zeros(3, np.float64)
            d = torch.zeros(3, dtype=torch.double)
            e = np.zeros(3, "float64")
        """,
        f"{PKG}/serving/engine.py": "import torch\nx = torch.float64\n",
    }, rules.DtypeDisciplineRule())
    assert [(f.path.rpartition("/")[2], f.line) for f in findings] == [
        ("mod.py", 4), ("mod.py", 5), ("mod.py", 6), ("mod.py", 7),
        ("mod.py", 8), ("engine.py", 2)]


def test_dtype_discipline_scoped_to_fused_paths(tmp_path):
    assert lint(tmp_path, {
        f"{PKG}/models/mod.py": "import torch\nX = torch.float64\n",
        f"{PKG}/ops/clean.py": "import torch\nX = torch.zeros(3).float()\n",
    }, rules.DtypeDisciplineRule()) == []


# --------------------------------------------------------------------- #
# 4 · bare-raise-discipline
# --------------------------------------------------------------------- #

def test_raise_discipline_trips_generic_and_missing_trace_id(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py": """
        class FooError(RuntimeError):
            pass

        class NotYet(NotImplementedError):
            pass

        def f():
            raise RuntimeError("boom")
    """}, rules.RaiseDisciplineRule())
    assert lines(findings) == [2, 5, 9]
    assert {f.rule for f in findings} == {"bare-raise-discipline"}


def test_raise_discipline_passes_typed_with_trace_id(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py": """
        class FooError(RuntimeError):
            trace_id = None

        class SubError(FooError):
            pass

        class Timed(RuntimeError):
            def __init__(self):
                self.trace_id = None

        class _Internal(Exception):
            pass

        def f(flag):
            if flag:
                raise FooError("typed")
            raise ValueError("specific builtins stay legal")
    """}, rules.RaiseDisciplineRule()) == []


# --------------------------------------------------------------------- #
# 6 · no-bare-print
# --------------------------------------------------------------------- #

def test_no_bare_print_trips(tmp_path):
    findings = lint(tmp_path, TRIP_PRINT, rules.NoBarePrintRule())
    assert [f.rule for f in findings] == ["no-bare-print"]


def test_no_bare_print_passes_where_printing_is_the_contract(tmp_path):
    assert lint(tmp_path, {
        f"{PKG}/telemetry/runlog.py": "print('narration path')\n",
        f"{PKG}/analysis/__main__.py": "print('lint output')\n",
        f"{PKG}/training/progress.py": "print('bar')\n",
        "chip_smoke.py": "print('the smoke prints its contract')\n",
    }, rules.NoBarePrintRule()) == []


def test_no_bare_print_guards_the_engine_itself(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/analysis/rules.py": "print('dbg')\n"},
                    rules.NoBarePrintRule())
    assert [f.rule for f in findings] == ["no-bare-print"]


# --------------------------------------------------------------------- #
# 7 · metrics-catalog
# --------------------------------------------------------------------- #

_CATALOG = """
    # metrics
    | name | meaning |
    |---|---|
    | `serving.good` | fine |
    | `stale.row` | emitted by nothing |
"""


def test_metrics_catalog_trips_on_drift(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py": """
        reg.counter("serving.good").inc()
        reg.counter("not.in.catalog").inc()
        reg.gauge("badname").set(1)
    """}, rules.MetricsCatalogRule(legacy=()),
        extra={rules.CATALOG_PATH: _CATALOG})
    msgs = " | ".join(f.message for f in findings)
    assert "not.in.catalog" in msgs and "stale.row" in msgs
    assert "badname" in msgs and len(findings) == 4


def test_metrics_catalog_passes_in_sync(tmp_path):
    assert lint(tmp_path, {f"{PKG}/mod.py":
                           'reg.counter("serving.good").inc()\n'
                           'reg.histogram("stale.row").observe(2)\n'},
                rules.MetricsCatalogRule(legacy=()),
                extra={rules.CATALOG_PATH: _CATALOG}) == []


def test_metrics_catalog_legacy_must_stay_emitted(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py":
                               'reg.counter("serving.good").inc()\n'},
                    rules.MetricsCatalogRule(legacy=("checkpoints",)),
                    extra={rules.CATALOG_PATH:
                           _CATALOG + "    | `checkpoints` | x |\n"})
    gone = [f for f in findings if "no longer emitted" in f.message]
    assert len(gone) == 1 and "checkpoints" in gone[0].message


# --------------------------------------------------------------------- #
# 8 · kernel-plain-coverage
# --------------------------------------------------------------------- #

_WRAPPER = {f"{PKG}/ops/cuda_demo.py": """
    def _k1(plan, X):
        return build().tdq_demo_fwd(X)

    def k1_forward(plan, X):
        table = _k1(plan, X)
        k1_forward.launches += 1
        return table

    k1_forward.launches = 0
"""}
_CU = {f"{PKG}/csrc/demo.cu":
       'extern "C" int tdq_demo_fwd(const float* X,\n'
       '                            float* out) { return 0; }\n'
       'extern "C" int\ntdq_demo_info(int* out) { return 0; }\n'}
_TEST = {"tests/test_torch_demo.py": """
    from tensordiffeq_tpu_torch.ops import cuda_demo
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    def test_demo():
        want = taylor_derivatives(layers, X, reqs)
        assert cuda_demo.k1_forward is not None
"""}
_SMOKE = {"chip_smoke.py": """
    def _wrappers():
        return {"k1": ct.k1_forward}

    def kernels_line(meas, paths):
        for key, name in (("k1", "taylor_table_fwd (K1)"),):
            pass
"""}


def test_kernel_coverage_passes_when_tested_smoked_and_bound(tmp_path):
    cu = {f"{PKG}/csrc/demo.cu": 'extern "C" int tdq_demo_fwd(float* X) '
          '{ return 0; }\n'}
    assert lint(tmp_path, dict(_WRAPPER, **_SMOKE),
                rules.KernelPlainCoverageRule(),
                extra=dict(_TEST, **cu)) == []


def test_kernel_coverage_trips_without_test_smoke_or_binding(tmp_path):
    findings = lint(tmp_path, dict(_WRAPPER),
                    rules.KernelPlainCoverageRule(),
                    extra=dict(_CU, **{"tests/test_torch_other.py":
                                       "from x import k1_forward\n"}))
    msgs = sorted(f.message.split(" — ")[0] for f in findings)
    assert len(findings) == 3, msgs
    assert any("tests/test_torch_" in m for m in msgs)
    assert any("chip_smoke.py" in m for m in msgs)
    assert [(f.path, f.line) for f in findings if "extern" in f.message] \
        == [(f"{PKG}/csrc/demo.cu", 3)]


# --------------------------------------------------------------------- #
# 9 · span-leak
# --------------------------------------------------------------------- #

def test_span_leak_trips(tmp_path):
    findings = lint(tmp_path, {f"{PKG}/mod.py": """
        def f(tracer, tr):
            tracer.span("never.entered")
            sp = tr.open_span("never.closed")
            tr.open_span("discarded")
            return 1
    """}, rules.SpanLeakRule())
    assert lines(findings) == [3, 4, 5]


def test_span_leak_passes_closed_and_escaping_spans(tmp_path):
    assert lint(tmp_path, {
        f"{PKG}/mod.py": """
            import re

            def f(tracer, tr, holder):
                with tracer.span("entered"):
                    pass
                sp = tr.open_span("closed")
                tr.close_span(sp)
                holder.span = tr.open_span("stored")
                m = re.match("a", "a").span()
                return tr.open_span("returned"), m
        """,
        f"{PKG}/telemetry/tracing.py": "def g(tr):\n    tr.open_span('x')\n",
    }, rules.SpanLeakRule()) == []


# --------------------------------------------------------------------- #
# the registry, the JAX rules' mapping, the import pin
# --------------------------------------------------------------------- #

def test_rule_registry_shape():
    ids = [r.id for r in rules.ALL_RULES]
    assert len(ids) == len(set(ids)) == 8
    assert all(r.doc for r in rules.ALL_RULES)
    assert set(rules.RULES_BY_ID) == set(ids)


def test_every_jax_rule_has_a_counterpart_or_a_stated_substitute():
    jax_rules = os.path.join(REPO, "tensordiffeq_tpu", "analysis",
                             "rules.py")
    with open(jax_rules) as fh:
        tree = ast.parse(fh.read())
    jax_ids = {n.value.value for n in ast.walk(tree)
               if isinstance(n, ast.Assign) and isinstance(n.value,
                                                           ast.Constant)
               and any(isinstance(t, ast.Name) and t.id == "id"
                       for t in n.targets)}
    assert set(rules.JAX_RULES) == jax_ids
    for jax_id, port_id in rules.JAX_RULES.items():
        if port_id is None:
            assert "dispatch audit" in rules.NO_AST_COUNTERPART[jax_id]
        else:
            assert port_id in rules.RULES_BY_ID


def test_unknown_rule_id_raises():
    with pytest.raises(ValueError, match="no-such-rule"):
        A.run_analysis(select=["no-such-rule"])


def test_analysis_package_is_stdlib_only_at_import():
    """Importing the engine never pulls torch, numpy, JAX or either
    package: the fixture tests and the lint gate cost milliseconds.
    dispatch_audit names torch only inside function bodies."""
    heavy = {"torch", "numpy", "jax", "jaxlib", "scipy", "tensordiffeq_tpu",
             "tensordiffeq_tpu_torch"}
    for fname in sorted(os.listdir(ANALYSIS_DIR)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ANALYSIS_DIR, fname)) as fh:
            tree = ast.parse(fh.read(), filename=fname)
        for node in tree.body:  # TOP-LEVEL statements only
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & heavy, f"{fname} imports {roots & heavy}"


# --------------------------------------------------------------------- #
# the card audit's reader of cudaGraphDebugDotPrint
# --------------------------------------------------------------------- #

def _dot(name):
    with open(os.path.join(FIXTURES, name)) as fh:
        return fh.read()


def test_graph_dump_reader_counts_nodes_and_copy_directions():
    rep = audit.parse_dot(_dot("torch_graph_toy.dot"), "toy")
    assert rep.nodes == 6 and rep.kinds == {"KERNEL": 2, "MEMCPY": 4}
    assert rep.memcpy == {"DtoD": 2, "DtoH": 1, "HtoD": 1}
    assert rep.host == 0 and not rep.ok  # a copy across the host boundary
    assert rep.by_name() == {"vectorized_elementwise_kernel": 2}


def test_graph_dump_reader_holds_kernel_nodes_to_the_launches():
    rep = audit.parse_dot(_dot("torch_graph_minimax_step.dot"), "step")
    assert rep.kernel_nodes("k3") == 1
    assert rep.kernel_nodes("k1") == rep.kernel_nodes("k2") == 0
    assert set(rep.memcpy) == {"DtoD"} and rep.host == 0
    rep.launches = rep.captured = {"k3": 1}
    assert rep.ok
    rep.captured = {"k3": 1, "k1": 1}  # the twin is not the replayed graph
    assert not rep.ok
    rep.launches = rep.captured = {"k3": 2}  # a launch the graph lacks
    assert not rep.ok
    names = rep.by_name()
    assert names["minimax_step_kernel"] == names["reduce_partials"] == 1
    assert "minimax_step_kernel" in rep.line()


@pytest.mark.parametrize("mangled,short", [
    ("_Z19minimax_step_kernelILi0EEvPKfS1_", "minimax_step_kernel"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4E",
     "vectorized_elementwise_kernel"),
    ("sm80_xmma_gemm_f32f32_execute_kernel__5x_cublas",
     "sm80_xmma_gemm_f32f32_execute_kernel__5x_cublas")])
def test_kernel_short_name(mangled, short):
    assert audit.short_name(mangled) == short
