"""tdqlint for the port: one AST walk, pluggable rules, one suppression
syntax.

The counterpart of the JAX package's ``analysis/engine.py``, kept as the
port's own copy.  The engine parses every source file in scope ONCE into a
:class:`ParsedModule` (AST + raw lines + ``# tdq: allow[...]``
suppressions) and hands the parsed set to each registered rule.  Rules
come in two shapes:

* **module rules** — ``check(module) -> [Finding]``, called per file the
  rule's ``files()`` filter admits;
* **project rules** — ``check_project(ctx) -> [Finding]``, called once
  with the whole :class:`Context` (cross-file properties: the metrics
  catalog diff, kernel coverage).

Suppression syntax (the ONE escape hatch, same for every rule)::

    got = hist.cpu().numpy()  # tdq: allow[host-sync-in-hot-path] the chunk's one history read
    # tdq: allow[dtype-discipline] the float64-summed referee of the TF32 flavor
    acc = torch.zeros(n, dtype=torch.float64)

A trailing comment covers its own line; a standalone comment line covers
the next source line.  A suppression **must** carry a reason (a finding
of rule ``suppression-missing-reason`` otherwise) and **must** match a
real finding (``unused-suppression`` otherwise) — so the allow list can
never rot into a loophole.  The meta rules are not themselves
suppressible.

This module is deliberately **stdlib-only** (``ast``/``tokenize``/``os``/
``re``): importing it never pulls torch, so the fixture tests cost
milliseconds.  The recording audit of the captured steps lives in
:mod:`.dispatch_audit` and imports torch lazily.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

#: repo-relative path of the package root the default walk covers
PACKAGE_DIR = "tensordiffeq_tpu_torch"
#: extra top-level modules in the default scope: the port's card smoke,
#: which drives every path and emits through the same registry
EXTRA_FILES = ("chip_smoke.py",)

_SUPPRESS_RE = re.compile(
    r"#\s*tdq:\s*allow\[([a-z0-9-]+)\]\s*(.*?)\s*$")

#: meta rule ids the engine itself emits (never suppressible)
META_MISSING_REASON = "suppression-missing-reason"
META_UNUSED = "unused-suppression"
META_UNKNOWN_RULE = "unknown-suppression-rule"


@dataclass(frozen=True)
class Finding:
    """One ``file:line rule-id message`` report."""
    path: str          # repo-relative, forward slashes
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


@dataclass
class Suppression:
    line: int          # line the comment sits on
    target: int        # line the suppression covers
    rule: str
    reason: str
    used: bool = False


@dataclass
class ParsedModule:
    """One source file, parsed once and shared by every rule."""
    path: str          # absolute
    rel: str           # repo-relative, forward slashes
    source: str
    tree: ast.AST
    lines: list
    suppressions: list = field(default_factory=list)
    _nodes: list = field(default=None, repr=False)

    @property
    def nodes(self) -> list:
        """Every node of the tree (``ast.walk`` order), listed once: the
        rules scan it many times."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def pkg_rel(self) -> str:
        """Path relative to the package dir ('' prefix when outside)."""
        prefix = PACKAGE_DIR + "/"
        return self.rel[len(prefix):] if self.rel.startswith(prefix) else ""


def parse_suppressions(source: str, lines: list) -> list:
    """Extract ``# tdq: allow[rule] reason`` comments via tokenize (a
    string literal that *mentions* the syntax never false-positives)."""
    out = []
    if "tdq:" not in source:
        return out  # nothing to find: skip the tokenizer
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(tok.start[0], tok.string) for tok in tokens
                    if tok.type == tokenize.COMMENT]
    except tokenize.TokenError:
        comments = []
    for lineno, text in comments:
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rule, reason = m.group(1), m.group(2).strip()
        stripped = lines[lineno - 1].lstrip() if lineno <= len(lines) else ""
        if stripped.startswith("#"):
            # standalone comment: covers the next non-blank, non-comment
            # source line
            target = lineno + 1
            while target <= len(lines):
                nxt = lines[target - 1].strip()
                if nxt and not nxt.startswith("#"):
                    break
                target += 1
        else:
            target = lineno
        out.append(Suppression(lineno, target, rule, reason))
    return out


def parse_module(path: str, repo_root: str) -> ParsedModule:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
    lines = source.splitlines()
    tree = ast.parse(source, filename=rel)
    return ParsedModule(path, rel, source, tree, lines,
                        parse_suppressions(source, lines))


@dataclass
class Context:
    """Everything a project rule may need: the parsed module set plus the
    repo root (for reads outside the linted files: the metrics catalog,
    the tests, the CUDA sources)."""
    repo_root: str
    modules: list


def iter_source_files(repo_root: str):
    """Default lint scope: every ``.py`` under the package + EXTRA_FILES."""
    pkg = os.path.join(repo_root, PACKAGE_DIR)
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    for name in EXTRA_FILES:
        path = os.path.join(repo_root, name)
        if os.path.exists(path):
            yield path


def repo_root_default() -> str:
    """The repo this package lives in (…/tensordiffeq_tpu_torch/analysis
    -> two levels up)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class Rule:
    """Base class; subclasses set ``id``/``doc`` and override one of
    ``check`` (per module) or ``check_project`` (once)."""

    id: str = ""
    doc: str = ""

    def files(self, module: ParsedModule) -> bool:
        """Module-rule file filter; default: every file in scope (the
        package, chip_smoke.py, and any path passed explicitly to the CLI).
        Rules with a narrower contract (no-bare-print's allowlist,
        dtype-discipline's fused paths) override this."""
        return True

    def check(self, module: ParsedModule):
        return []

    def check_project(self, ctx: Context):
        return []


def run_rules(rules, repo_root=None, files=None, known_rules=None):
    """Parse once, run every rule, apply suppressions.

    Returns ``(findings, modules)`` — findings already filtered through
    the suppression pass and extended with the meta findings (missing
    reason / unused / unknown-rule suppression), sorted by path then
    line.

    ``files``: explicit file subset.  Project-scoped rules (cross-file
    properties: the metrics-catalog diff, kernel coverage) are SKIPPED
    for subset runs — judging the whole catalog against one file's
    emissions would drown a clean file in false positives.

    ``known_rules``: the full registry's rule ids; when given, a
    suppression naming an id outside it is a finding (a typo'd allow
    must not sit inert forever).
    """
    repo_root = repo_root or repo_root_default()
    subset = files is not None
    paths = list(files) if subset else list(iter_source_files(repo_root))
    modules = [parse_module(p, repo_root) for p in paths]
    ctx = Context(repo_root, modules)

    raw = []
    for rule in rules:
        for module in modules:
            if rule.files(module):
                raw.extend(rule.check(module))
        if not subset:
            raw.extend(rule.check_project(ctx))

    by_rel = {m.rel: m for m in modules}
    findings = []
    for f in raw:
        sup = None
        mod = by_rel.get(f.path)
        if mod is not None:
            for s in mod.suppressions:
                if s.target == f.line and s.rule == f.rule:
                    sup = s
                    break
        if sup is not None:
            # the suppression absorbs the finding either way; a missing
            # reason surfaces as its own meta finding below, so the run
            # still fails — but with the actionable message
            sup.used = True
            continue
        findings.append(f)
    # meta checks only judge suppressions of rules that RAN: a subset
    # run (select=...) must not read another rule's allow as stale.  A
    # suppression naming an id the full registry doesn't know is flagged
    # regardless — a typo'd allow would otherwise be silently inert.
    ran = {r.id for r in rules}
    for mod in modules:
        for s in mod.suppressions:
            if known_rules is not None and s.rule not in known_rules:
                findings.append(Finding(
                    mod.rel, s.line, META_UNKNOWN_RULE,
                    f"allow[{s.rule}] names no known rule — typo'd "
                    "suppressions never fire; known ids: "
                    + ", ".join(sorted(known_rules))))
                continue
            if s.rule not in ran:
                continue
            if not s.reason:
                findings.append(Finding(
                    mod.rel, s.line, META_MISSING_REASON,
                    f"allow[{s.rule}] carries no reason — every "
                    "suppression must say why"))
            if not s.used:
                findings.append(Finding(
                    mod.rel, s.line, META_UNUSED,
                    f"allow[{s.rule}] matches no finding on line "
                    f"{s.target} — stale suppressions must be deleted"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, modules


# --------------------------------------------------------------------- #
# shared AST helpers the rules lean on
# --------------------------------------------------------------------- #

def dotted_name(node) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node) -> str:
    """Dotted name of a Call's callee ('' when not a plain name chain)."""
    return dotted_name(node.func) if isinstance(node, ast.Call) else ""
