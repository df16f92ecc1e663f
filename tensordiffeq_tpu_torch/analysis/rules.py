"""The port's tdqlint rule set: each rule of the JAX package's
``analysis/rules.py``, restated for PyTorch and CUDA graphs.

==============================  ==============================
JAX rule                        the port's rule
==============================  ==============================
``host-sync-in-hot-path``       ``host-sync-in-hot-path``
``prng-key-reuse``              ``explicit-generator``
``dtype-discipline``            ``dtype-discipline``
``bare-raise-discipline``       ``bare-raise-discipline``
``donated-buffer-reuse``        none: :data:`NO_AST_COUNTERPART`
``no-bare-print``               ``no-bare-print``
``metrics-catalog``             ``metrics-catalog``
``pallas-interpret-coverage``   ``kernel-plain-coverage``
``span-leak``                   ``span-leak``
==============================  ==============================

Rules are heuristics, not proofs: they under-report (one level of calls
followed at most) and occasionally flag a deliberate site — that is what
the ``# tdq: allow[rule-id] reason`` escape hatch is for.  Every rule here
is pure-AST (stdlib only); what a captured step really runs is checked by
:mod:`.dispatch_audit`.
"""

from __future__ import annotations

import ast
import os
import re

from .engine import (PACKAGE_DIR, Context, Finding, ParsedModule, Rule,
                     call_name, dotted_name)

# --------------------------------------------------------------------- #
# shared helpers
# --------------------------------------------------------------------- #

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.While, ast.AsyncFor)
_SCOPES = _DEFS + (ast.ClassDef, ast.Lambda)


def _walk_in_order(node, skip_defs=True):
    """Yield descendants in source order; optionally do not descend into
    nested function/class definitions (they are their own scope)."""
    for child in ast.iter_child_nodes(node):
        yield child
        if skip_defs and isinstance(child, _SCOPES):
            continue
        yield from _walk_in_order(child, skip_defs)


def _function_defs(tree):
    for node in ast.walk(tree):
        if isinstance(node, _DEFS):
            yield node


def _callee_tail(node) -> str:
    """The last name of a call's callee: ``read`` for ``step.read(n)``."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


def _in_package(module: ParsedModule) -> bool:
    return module.rel.startswith(PACKAGE_DIR + "/")


# --------------------------------------------------------------------- #
# 1 · host-sync-in-hot-path
# --------------------------------------------------------------------- #

class HostSyncRule(Rule):
    """No host synchronisation inside a captured step.

    A CUDA graph holds no host work: a step that reads a value on the host
    fails its capture (:class:`~..training.graphs.GraphCaptureError`), or
    runs eagerly where a graph was meant to.  Hot contexts are (a) every
    function handed to ``StepGraph`` (its first argument: ``self._step``,
    ``step``), by name within its module, and (b) ``forward``/``backward``
    of the ``torch.autograd.Function`` subclasses, which run inside those
    steps.  Flagged there: ``.item()``, ``.tolist()``, ``.numpy()``,
    ``.cpu()``, ``float()``/``int()``/``bool()`` of anything but a
    literal, ``np.asarray``/``np.array`` and ``.synchronize()`` (the
    device's, a stream's or an event's).  (c) The chunk runners
    (``fit_adam``, ``lbfgs_minimize``) and the functions of their module
    they call directly: only *transfer-class* calls (``.cpu()``,
    ``.numpy()``, ``.tolist()``, ``np.asarray``/``np.array``,
    ``.synchronize()``), since a Python number of data already on the host
    is free; each deliberate read there carries an allow with its reason.
    """

    id = "host-sync-in-hot-path"
    doc = "no .item()/.cpu()/.numpy()/float()/synchronize() in captured " \
          "steps and autograd Functions; transfers in the chunk loops"

    CHUNK_RUNNERS = {"fit_adam", "lbfgs_minimize"}
    NP_TRANSFER = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
    TRANSFER_ATTRS = {"cpu", "numpy", "tolist", "synchronize"}
    STEP_ONLY_ATTRS = {"item"}
    SCALAR_CASTS = {"float", "int", "bool"}
    _FUNCTION_BASES = {"Function", "autograd.Function",
                       "torch.autograd.Function"}

    def _hot_defs(self, module: ParsedModule):
        """(def_node, captured) pairs: captured=True for the steps and the
        autograd Functions, False for the chunk loops and their callees."""
        captured = set()
        for node in module.nodes:
            if isinstance(node, ast.Call) and node.args \
                    and call_name(node).rpartition(".")[2] == "StepGraph":
                target = node.args[0]
                if isinstance(target, ast.Name):
                    captured.add(target.id)
                elif isinstance(target, ast.Attribute):
                    captured.add(target.attr)
        functions = set()
        for node in module.nodes:
            if isinstance(node, ast.ClassDef) and any(
                    dotted_name(b) in self._FUNCTION_BASES
                    for b in node.bases):
                functions |= {id(d) for d in node.body
                              if isinstance(d, _DEFS)
                              and d.name in ("forward", "backward")}
        defs = [n for n in module.nodes if isinstance(n, _DEFS)]
        runners = [fn for fn in defs if fn.name in self.CHUNK_RUNNERS]
        called = {_callee_tail(n) for fn in runners for n in ast.walk(fn)
                  if isinstance(n, ast.Call)}
        for fn in defs:
            if fn.name in captured or id(fn) in functions:
                yield fn, True
            elif fn.name in self.CHUNK_RUNNERS or fn.name in called:
                yield fn, False

    def _hit(self, node, captured: bool):
        if not isinstance(node, ast.Call):
            return None
        name = call_name(node)
        tail = _callee_tail(node)
        if name in self.NP_TRANSFER:
            return f"{name} device->host transfer"
        if isinstance(node.func, ast.Attribute):
            if tail in self.TRANSFER_ATTRS:
                return f".{tail}() host synchronisation"
            if captured and tail in self.STEP_ONLY_ATTRS:
                return f".{tail}() host synchronisation"
        elif captured and tail in self.SCALAR_CASTS and node.args \
                and not isinstance(node.args[0], ast.Constant):
            return f"{tail}() of a tensor reads it on the host"
        return None

    def check(self, module: ParsedModule):
        findings, seen = [], set()
        for fn, captured in self._hot_defs(module):
            ctx = "captured step" if captured else "fit chunk loop"
            for node in ast.walk(fn):
                hit = self._hit(node, captured)
                if hit and (node.lineno, hit) not in seen:
                    seen.add((node.lineno, hit))
                    findings.append(Finding(
                        module.rel, node.lineno, self.id,
                        f"{hit} inside {ctx} '{fn.name}' — a CUDA graph "
                        "holds no host work: the capture fails or the "
                        "step waits for the card"))
        return findings


# --------------------------------------------------------------------- #
# 2 · explicit-generator (the JAX package's prng-key-reuse)
# --------------------------------------------------------------------- #

class ExplicitGeneratorRule(Rule):
    """Every random draw names its generator.

    PyTorch has no keys to reuse; its counterpart hazard is the hidden
    global state: a draw without ``generator=`` takes whatever the global
    generator holds (any other caller moves it, so a seed does not pin
    the run), and numpy's module-level ``np.random.<draw>`` is the same.
    A generator re-seeded with a constant inside a loop redraws the same
    numbers on every pass: the reused key of the JAX rule, where each
    redraw re-selects the same points."""

    id = "explicit-generator"
    doc = "torch draws pass generator=; no np.random.<draw> global state; " \
          "no constant manual_seed inside a loop"

    TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                   "randn_like", "randint_like", "bernoulli", "multinomial",
                   "normal", "poisson"}
    INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                     "exponential_", "cauchy_", "log_normal_", "geometric_"}
    NP_STATE_OK = {"RandomState", "default_rng", "Generator", "SeedSequence",
                   "PCG64", "MT19937", "Philox", "SFC64", "BitGenerator",
                   "get_state"}

    @staticmethod
    def _in_loops(tree) -> set:
        """ids of the nodes inside a loop's body or ``else``."""
        out = set()

        def visit(node, inside):
            for name, value in ast.iter_fields(node):
                loop_part = isinstance(node, _LOOPS) and name in (
                    "body", "orelse")
                for child in (value if isinstance(value, list)
                              else [value]):
                    if isinstance(child, ast.AST):
                        if inside or loop_part:
                            out.add(id(child))
                        visit(child, inside or loop_part)

        visit(tree, False)
        return out

    def check(self, module: ParsedModule):
        findings = []
        in_loop = None
        for node in module.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            head, _, tail = name.rpartition(".")
            has_gen = any(kw.arg == "generator" for kw in node.keywords)
            msg = None
            if head == "torch" and tail in self.TORCH_DRAWS and not has_gen:
                msg = (f"torch.{tail}() without generator= draws from the "
                       "global generator — pass the caller's seeded one")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self.INPLACE_DRAWS and not has_gen:
                msg = (f".{node.func.attr}() without generator= draws from "
                       "the global generator — pass the caller's seeded one")
            elif head in ("np.random", "numpy.random") \
                    and tail not in self.NP_STATE_OK:
                msg = (f"{name}() uses numpy's global random state — draw "
                       "from a seeded RandomState/Generator")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "manual_seed" and node.args \
                    and isinstance(node.args[0], ast.Constant):
                if in_loop is None:
                    in_loop = self._in_loops(module.tree)
                if id(node) not in in_loop:
                    continue
                msg = ("manual_seed(<constant>) inside a loop redraws the "
                       "same numbers every pass (a reused key) — seed once, "
                       "or seed from the pass")
            if msg:
                findings.append(Finding(module.rel, node.lineno, self.id,
                                        msg))
        return findings


# --------------------------------------------------------------------- #
# 3 · dtype-discipline
# --------------------------------------------------------------------- #

class DtypeDisciplineRule(Rule):
    """The fused paths (``ops/``, ``serving/engine.py``) keep device math at
    float32 or narrower: a float64 tensor there runs on the card's FP64
    units (a fraction of its FP32 rate), and a float64 leaf promotes what
    it touches.  A deliberate float64 referee or host-side selection
    says so with an allow."""

    id = "dtype-discipline"
    doc = "no float64 inside the fused paths (ops/, serving/engine.py)"

    F64_ATTRS = {"np.float64", "numpy.float64", "torch.float64",
                 "torch.double"}

    def files(self, module: ParsedModule) -> bool:
        return (module.rel.startswith(PACKAGE_DIR + "/ops/")
                or module.rel == PACKAGE_DIR + "/serving/engine.py")

    def check(self, module: ParsedModule):
        findings, seen = [], set()
        for node in module.nodes:
            hit = None
            if isinstance(node, ast.Attribute) \
                    and dotted_name(node) in self.F64_ATTRS:
                hit = dotted_name(node)
            elif isinstance(node, ast.Constant) and node.value == "float64":
                hit = '"float64"'
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "double" and not node.args:
                hit = ".double()"
            if hit and node.lineno not in seen:
                seen.add(node.lineno)
                findings.append(Finding(
                    module.rel, node.lineno, self.id,
                    f"{hit} inside a fused path — float64 runs on the "
                    "card's FP64 units and promotes what it touches; keep "
                    "device math <= f32 or allow with the reason"))
        return findings


# --------------------------------------------------------------------- #
# 4 · bare-raise-discipline
# --------------------------------------------------------------------- #

class RaiseDisciplineRule(Rule):
    """Every raise uses a *typed* error, and every public error class
    declares the ``trace_id`` attach hook (structured errors carry the
    trace id that resolves the failure's span tree in the run log — a
    generic ``RuntimeError`` is invisible to that machinery)."""

    id = "bare-raise-discipline"
    doc = "no generic RuntimeError/Exception raises; public error " \
          "classes declare trace_id"

    GENERIC = {"Exception", "RuntimeError", "BaseException"}
    BUILTIN_BASES = {"Exception", "BaseException", "RuntimeError",
                     "ValueError", "TypeError", "KeyError", "OSError",
                     "ArithmeticError", "LookupError", "IOError",
                     "NotImplementedError"}

    def _error_classes(self, ctx: Context):
        """{name: (module, node, has_trace_id, base_names)} over the
        package, closed transitively over package bases."""
        classes = {}
        for module in ctx.modules:
            if not _in_package(module):
                continue
            for node in module.nodes:
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = {dotted_name(b).rpartition(".")[2]
                         for b in node.bases}
                # the hook is a class attr (`trace_id = None`), an
                # annotated one, or an instance attr set in __init__
                has_tid = False
                for n in ast.walk(node):
                    if isinstance(n, ast.Assign):
                        for t in n.targets:
                            if (isinstance(t, ast.Name)
                                    and t.id == "trace_id") \
                                or (isinstance(t, ast.Attribute)
                                    and t.attr == "trace_id"
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                has_tid = True
                    elif isinstance(n, ast.AnnAssign) \
                            and isinstance(n.target, ast.Name) \
                            and n.target.id == "trace_id":
                        has_tid = True
                classes[node.name] = (module, node, has_tid, bases)
        # keep only exception classes: a base is a builtin exception or
        # another collected error class (iterate to fixpoint)
        errors = {}
        changed = True
        while changed:
            changed = False
            for name, (module, node, has_tid, bases) in classes.items():
                if name in errors:
                    continue
                if bases & self.BUILTIN_BASES or bases & errors.keys():
                    errors[name] = (module, node, has_tid, bases)
                    changed = True

        def carries_trace_id(name, seen=()):
            if name not in errors or name in seen:
                return False
            module, node, has_tid, bases = errors[name]
            return has_tid or any(carries_trace_id(b, seen + (name,))
                                  for b in bases)

        return errors, carries_trace_id

    def check_project(self, ctx: Context):
        findings = []
        errors, carries_trace_id = self._error_classes(ctx)
        for name, (module, node, _tid, _bases) in errors.items():
            if name.startswith("_"):
                continue  # private control-flow sentinels are exempt
            if not carries_trace_id(name):
                findings.append(Finding(
                    module.rel, node.lineno, self.id,
                    f"error class {name} does not declare the trace_id "
                    "attach hook (add `trace_id = None` so attach_trace "
                    "resolves failures to their span tree)"))
        for module in ctx.modules:
            if not _in_package(module):
                continue
            for node in module.nodes:
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                exc = node.exc
                name = call_name(exc) if isinstance(exc, ast.Call) \
                    else dotted_name(exc)
                if name.rpartition(".")[2] in self.GENERIC:
                    findings.append(Finding(
                        module.rel, node.lineno, self.id,
                        f"generic `raise {name}` — use a typed error "
                        "from the structured set so callers and the "
                        "trace layer can dispatch on it"))
        return findings


# --------------------------------------------------------------------- #
# 5 · donated-buffer-reuse: no AST counterpart
# --------------------------------------------------------------------- #

#: JAX rules the port checks by other means, with where (printed by
#: ``--list-rules`` so that a rule is not silently gone)
NO_AST_COUNTERPART = {
    "donated-buffer-reuse":
        "torch donates no buffer; its hazard, a replay reading storage "
        "the Python side replaced, is the dispatch audit's `unkeyed` "
        "check (python -m tensordiffeq_tpu_torch.analysis --audit)",
}


# --------------------------------------------------------------------- #
# 6 · no-bare-print
# --------------------------------------------------------------------- #

class NoBarePrintRule(Rule):
    """All package narration routes through ``telemetry.log_event``
    (leveled, honours ``verbose``, mirrored into the JSONL sink) so quiet
    runs are quiet and events are machine-readable.  Only the telemetry
    package itself, the progress bar and the lint CLI module (whose
    stdout IS its product — the engine/rules/audit modules stay guarded)
    may print; ``chip_smoke.py``, outside the package, prints its
    contract."""

    id = "no-bare-print"
    doc = "no bare print() outside telemetry/, training/progress.py, " \
          "and the lint CLI module"

    ALLOWED_PREFIXES = ("telemetry/",)
    ALLOWED_FILES = ("training/progress.py", "analysis/__main__.py")

    def files(self, module: ParsedModule) -> bool:
        rel = module.pkg_rel()
        if not rel:
            return False
        return not (rel.startswith(self.ALLOWED_PREFIXES)
                    or rel in self.ALLOWED_FILES)

    def check(self, module: ParsedModule):
        return [Finding(module.rel, node.lineno, self.id,
                        "bare print() — route narration through "
                        "telemetry.log_event so quiet runs stay quiet "
                        "and events reach the JSONL sink")
                for node in module.nodes
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"]


# --------------------------------------------------------------------- #
# 7 · metrics-catalog
# --------------------------------------------------------------------- #

#: names outside the dotted scheme: the JAX package's frozen legacy
#: allowlist, which the port emits for report parity
LEGACY_METRICS = frozenset({"step_time_dispatch_s", "step_time_device_s",
                            "step_time_data_s", "checkpoints", "divergences",
                            "device_memory_peak_bytes"})

_DOTTED = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
_EMITTERS = {"counter", "gauge", "histogram"}
_CATALOG_ROW = re.compile(r"^\s*\|\s*`([a-z0-9_.]+)`\s*\|")
CATALOG_PATH = PACKAGE_DIR + "/telemetry/metrics.md"
_REGISTRY = PACKAGE_DIR + "/telemetry/registry.py"


def emitted_metrics(ctx: Context) -> dict:
    """``{name: [(rel, line), ...]}`` over the package + chip_smoke.py —
    an emission is ``<expr>.counter("lit", ...)`` (/gauge/histogram) with
    a string-literal first argument; ``IfExp`` first args count both
    arms.  ``telemetry/registry.py`` (the instrument definitions) is
    excluded."""
    out = {}
    for module in ctx.modules:
        if module.rel == _REGISTRY:
            continue
        for node in module.nodes:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMITTERS and node.args):
                continue
            arg = node.args[0]
            names = []
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.append(arg.value)
            elif isinstance(arg, ast.IfExp):
                for side in (arg.body, arg.orelse):
                    if isinstance(side, ast.Constant) \
                            and isinstance(side.value, str):
                        names.append(side.value)
            for name in names:
                out.setdefault(name, []).append((module.rel, node.lineno))
    return out


def catalog_metrics(repo_root: str) -> dict:
    """``{name: line}`` — the backticked first cell of each table row in
    the port's catalog."""
    names = {}
    with open(os.path.join(repo_root, CATALOG_PATH)) as fh:
        for lineno, line in enumerate(fh, 1):
            m = _CATALOG_ROW.match(line)
            if m:
                names.setdefault(m.group(1), lineno)
    return names


class MetricsCatalogRule(Rule):
    """The port's ``telemetry/metrics.md`` is the operator contract for
    every instrument it emits: emissions missing from the catalog, stale
    catalog rows, names violating the dotted ``subsystem.noun[.verb]``
    scheme, and legacy-allowlist entries whose emission is gone are all
    drift.  (The JAX package's ``docs/metrics.md`` describes XLA compiles
    and AOT loads; the port's rows say what each instrument means here.)"""

    id = "metrics-catalog"
    doc = "every metric emission catalogued in " \
          "tensordiffeq_tpu_torch/telemetry/metrics.md, dotted naming, " \
          "no stale rows"

    def __init__(self, legacy=LEGACY_METRICS):
        self.legacy = frozenset(legacy)

    def check_project(self, ctx: Context):
        findings = []
        emitted = emitted_metrics(ctx)
        catalog = catalog_metrics(ctx.repo_root)
        for name, sites in sorted(emitted.items()):
            if name not in catalog:
                rel, line = sites[0]
                findings.append(Finding(
                    rel, line, self.id,
                    f"metric '{name}' is emitted but missing from "
                    f"{CATALOG_PATH} — document it or rename"))
            if name not in self.legacy and not _DOTTED.match(name):
                rel, line = sites[0]
                findings.append(Finding(
                    rel, line, self.id,
                    f"metric '{name}' violates the dotted "
                    "subsystem.noun[.verb] scheme (the legacy allowlist "
                    "is frozen)"))
        for name, line in sorted(catalog.items()):
            if name not in emitted:
                findings.append(Finding(
                    CATALOG_PATH, line, self.id,
                    f"catalog row '{name}' has no emission in the "
                    "source — remove the row or restore the emission"))
        for name in sorted(self.legacy - emitted.keys()):
            findings.append(Finding(
                CATALOG_PATH, catalog.get(name, 1), self.id,
                f"legacy allowlist entry '{name}' is no longer emitted "
                "— delete it from the allowlist and the catalog"))
        return findings


# --------------------------------------------------------------------- #
# 8 · kernel-plain-coverage (the JAX package's pallas-interpret-coverage)
# --------------------------------------------------------------------- #

def _counted_wrappers(module: ParsedModule) -> dict:
    """``{name: line}``: the module's functions that count their own
    launches (``<name>.launches += 1`` in their body) — the kernel
    wrappers."""
    out = {}
    for fn in module.tree.body:
        if not isinstance(fn, _DEFS):
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.AugAssign) \
                    and isinstance(n.target, ast.Attribute) \
                    and n.target.attr == "launches" \
                    and dotted_name(n.target.value) == fn.name:
                out[fn.name] = fn.lineno
    return out


def _parse_file(path: str):
    try:
        with open(path, encoding="utf-8") as fh:
            return ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _names_and_calls(tree) -> tuple:
    """(identifiers a module mentions, the callee tails it calls)."""
    names, calls = set(), set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
        elif isinstance(n, ast.alias):
            names.add(n.asname or n.name.rpartition(".")[2])
        if isinstance(n, ast.Call):
            calls.add(_callee_tail(n))
    return names, calls


class KernelPlainCoverageRule(Rule):
    """Every kernel wrapper (an ``ops/cuda_*.py`` function that counts its
    launches) is (a) named by a ``tests/test_torch_*.py`` file that also
    calls the wrapper's plain flavor — the CPU's only view of the
    kernel's arithmetic, since no kernel runs here — and (b) named in
    ``chip_smoke.py``'s kernels line (a ``_wrappers`` key that
    ``kernels_line`` reports), which holds it against that flavor on the
    card.  Every ``extern "C"`` entry of ``csrc/*.cu`` is bound by a
    wrapper module (its name appears in an ``ops/`` source): an unbound
    entry is a kernel no path can launch."""

    id = "kernel-plain-coverage"
    doc = "every kernel wrapper tested beside its plain flavor and in " \
          "chip_smoke.py's kernels line; every extern \"C\" entry bound"

    #: the plain flavor a wrapper family is held to (the callee's tail)
    PLAIN = {"k1_": "taylor_derivatives", "k2_": "taylor_derivatives",
             "k3_": "plain"}
    _EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')

    def _plain_of(self, wrapper: str):
        for prefix, plain in self.PLAIN.items():
            if wrapper.startswith(prefix):
                return plain
        return None

    def _tests(self, root: str, wrappers) -> list:
        """``(names, calls)`` of each ``tests/test_torch_*.py`` file that
        mentions a wrapper (the others are not parsed)."""
        tdir = os.path.join(root, "tests")
        try:
            files = sorted(os.listdir(tdir))
        except OSError:
            return []
        out = []
        for name in files:
            if not (name.startswith("test_torch_") and name.endswith(".py")):
                continue
            try:
                with open(os.path.join(tdir, name), encoding="utf-8") as fh:
                    src = fh.read()
            except OSError:
                continue
            if any(w in src for w in wrappers):
                try:
                    out.append(_names_and_calls(ast.parse(src)))
                except SyntaxError:
                    continue
        return out

    @staticmethod
    def _smoke_keys(root: str) -> tuple:
        """({wrapper: key} of chip_smoke.py's dict literals, the string
        keys ``kernels_line`` lists first in its tuples)."""
        tree = _parse_file(os.path.join(root, "chip_smoke.py"))
        if tree is None:
            return {}, set()
        keys, reported = {}, set()
        for n in ast.walk(tree):
            if isinstance(n, ast.Dict):
                for k, v in zip(n.keys, n.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(v, ast.Attribute):
                        keys.setdefault(v.attr, k.value)
            if isinstance(n, _DEFS) and n.name == "kernels_line":
                for t in ast.walk(n):
                    if isinstance(t, ast.Tuple) and t.elts \
                            and isinstance(t.elts[0], ast.Constant):
                        reported.add(t.elts[0].value)
        return keys, reported

    def check_project(self, ctx: Context):
        findings = []
        ops = [m for m in ctx.modules
               if m.rel.startswith(PACKAGE_DIR + "/ops/")]
        wrappers = [(m, name, line)
                    for m in ops if os.path.basename(m.rel).startswith("cuda_")
                    for name, line in _counted_wrappers(m).items()]
        tests = self._tests(ctx.repo_root, {w for _, w, _ in wrappers}) \
            if wrappers else []
        keys, reported = self._smoke_keys(ctx.repo_root) if wrappers \
            else ({}, set())
        for module, name, line in wrappers:
            plain = self._plain_of(name)
            if plain is None or not any(name in names and plain in calls
                                        for names, calls in tests):
                findings.append(Finding(
                    module.rel, line, self.id,
                    f"kernel wrapper '{name}' has no tests/test_torch_*.py "
                    f"file that names it and calls its plain flavor "
                    f"({plain or 'unknown'}) — the plain flavor is the "
                    "CPU's only view of the kernel's arithmetic"))
            if keys.get(name) not in reported:
                findings.append(Finding(
                    module.rel, line, self.id,
                    f"kernel wrapper '{name}' is not in chip_smoke.py's "
                    "kernels line (a _wrappers key that kernels_line "
                    "reports) — the card never holds it to its plain "
                    "flavor"))
        csrc = os.path.join(ctx.repo_root, PACKAGE_DIR, "csrc")
        try:
            cu = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
        except OSError:
            cu = []
        bound = "\n".join(m.source for m in ops)
        for fname in cu:
            with open(os.path.join(csrc, fname), encoding="utf-8") as fh:
                src = fh.read()
            for m in self._EXTERN.finditer(src):
                if not re.search(rf"\b{m.group(1)}\b", bound):
                    findings.append(Finding(
                        f"{PACKAGE_DIR}/csrc/{fname}",
                        src[:m.start()].count("\n") + 1, self.id,
                        f'extern "C" {m.group(1)} is bound by no ops/ '
                        "wrapper — a kernel entry no path can launch"))
        return findings


# --------------------------------------------------------------------- #
# 9 · span-leak
# --------------------------------------------------------------------- #

class SpanLeakRule(Rule):
    """A span that is opened and never closed never emits its ``trace``
    record: the run log shows the parent finishing instantly, the
    Perfetto export drops the slice, and every child becomes an orphan
    root in ``span_tree``.

    Two shapes are flagged: ``tracer.span(...)`` whose result is not
    entered with ``with`` (the context manager never runs, so the span
    never even opens), and ``open_span(...)`` whose result is discarded
    or bound to a name that is neither ``close_span``'d nor escapes the
    scope.  Escapes — passed as a call argument, returned, yielded,
    stored to an attribute, aliased — count as closed (no
    interprocedural analysis; under-report by design).
    """

    id = "span-leak"
    doc = "tracer.span() entered via with; open_span() results " \
          "close_span'd or escaping the scope"

    #: the tracer implementation itself builds/returns spans freely
    SKIP = (PACKAGE_DIR + "/telemetry/tracing.py",)
    #: receiver-name filter for bare ``.span`` (``re.Match.span()`` and
    #: friends must not trip the rule); open/close_span are unambiguous
    _TRACERISH = ("tr", "tracer")

    def files(self, module: ParsedModule) -> bool:
        return module.rel not in self.SKIP

    @staticmethod
    def _scopes(tree):
        yield tree
        yield from _function_defs(tree)

    @staticmethod
    def _parents(scope) -> dict:
        """child -> parent map over the scope, not descending into
        nested defs (their spans are judged in their own scope)."""
        out = {}

        def build(node):
            for ch in ast.iter_child_nodes(node):
                out[ch] = node
                if not isinstance(ch, _SCOPES):
                    build(ch)

        build(scope)
        return out

    def _consumption(self, call, parents):
        """How the span-call's value is consumed: ``('with', None)``,
        ``('escape', None)``, ``('discard', None)``, or
        ``('name', ident)`` for a trackable simple-name binding."""
        ch, p = call, parents.get(call)
        while p is not None:
            if isinstance(p, ast.withitem):
                return ("with" if p.context_expr is ch else "escape", None)
            if isinstance(p, ast.Call):
                # argument position (close_span(sp), self._watch(sp, ...))
                return ("escape", None)
            if isinstance(p, (ast.Return, ast.Yield, ast.YieldFrom)):
                return ("escape", None)
            if isinstance(p, ast.Assign):
                if len(p.targets) == 1 \
                        and isinstance(p.targets[0], ast.Name):
                    return ("name", p.targets[0].id)
                return ("escape", None)   # attr/subscript/tuple target
            if isinstance(p, ast.Expr):
                return ("discard", None)
            if isinstance(p, (ast.IfExp, ast.BoolOp, ast.Await,
                              ast.NamedExpr)):
                ch, p = p, parents.get(p)   # x = a if c else open_span()
                continue
            # attribute read / comparison off the fresh value — give up
            # tracking rather than guess (under-report)
            return ("escape", None)
        return ("escape", None)

    def _name_is_settled(self, name, binder, scope, parents):
        """True when some use of ``name`` after its binding closes or
        escapes the span: call argument, method call on it, return /
        yield, re-assignment, or a ``with`` entry."""
        after = (binder.lineno, binder.col_offset)
        for node in _walk_in_order(scope):
            if not (isinstance(node, ast.Name) and node.id == name
                    and isinstance(node.ctx, ast.Load)
                    and (node.lineno, node.col_offset) > after):
                continue
            ch, p = node, parents.get(node)
            while p is not None:
                if isinstance(p, ast.Call):
                    # arg of any call — close_span(sp) and every other
                    # hand-off — or a method call sp.xxx(...) via func
                    return True
                if isinstance(p, (ast.Return, ast.Yield, ast.YieldFrom)):
                    return True
                if isinstance(p, ast.Assign) and p.value is ch:
                    return True             # aliased / stored
                if isinstance(p, ast.withitem) and p.context_expr is ch:
                    return True
                if isinstance(p, (ast.Attribute, ast.IfExp, ast.BoolOp,
                                  ast.NamedExpr)):
                    ch, p = p, parents.get(p)
                    continue
                break                       # plain read (compare, if sp:)
        return False

    def check(self, module: ParsedModule):
        findings = []
        if not any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                   and n.func.attr in ("span", "open_span")
                   for n in module.nodes):
            return findings
        for scope in self._scopes(module.tree):
            parents = self._parents(scope)
            for node in _walk_in_order(scope):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("span", "open_span")):
                    continue
                kind = node.func.attr
                if kind == "span":
                    recv = dotted_name(node.func.value).split(".")[-1]
                    if not (recv in self._TRACERISH or "tracer" in recv):
                        continue
                use, ident = self._consumption(node, parents)
                if use in ("with", "escape"):
                    continue
                if use == "name" and self._name_is_settled(
                        ident, node, scope, parents):
                    continue
                if kind == "span":
                    msg = (".span(...) returns a context manager — "
                           "without `with` the span never even opens "
                           "(use `with tracer.span(...)`)")
                else:
                    held = f" bound to '{ident}'" if ident else ""
                    msg = (f"open_span(...) result{held} is never "
                           "close_span'd and never escapes this scope — "
                           "an unclosed span emits no trace record and "
                           "orphans its children in the span tree")
                findings.append(Finding(module.rel, node.lineno,
                                        self.id, msg))
        return findings


#: registration order == report order for equal (file, line)
ALL_RULES = (HostSyncRule(), ExplicitGeneratorRule(), DtypeDisciplineRule(),
             RaiseDisciplineRule(), NoBarePrintRule(), MetricsCatalogRule(),
             KernelPlainCoverageRule(), SpanLeakRule())

RULES_BY_ID = {r.id: r for r in ALL_RULES}

#: each JAX rule id -> the port's rule id (None: checked otherwise,
#: :data:`NO_AST_COUNTERPART`)
JAX_RULES = {
    "host-sync-in-hot-path": "host-sync-in-hot-path",
    "prng-key-reuse": "explicit-generator",
    "dtype-discipline": "dtype-discipline",
    "bare-raise-discipline": "bare-raise-discipline",
    "donated-buffer-reuse": None,
    "no-bare-print": "no-bare-print",
    "metrics-catalog": "metrics-catalog",
    "pallas-interpret-coverage": "kernel-plain-coverage",
    "span-leak": "span-leak",
}
