"""tdqlint for the port: the AST rules over ``tensordiffeq_tpu_torch`` and
``chip_smoke.py``, and an audit of what the captured steps run.

    python -m tensordiffeq_tpu_torch.analysis          # AST pass, exit 1 on findings
    python -m tensordiffeq_tpu_torch.analysis --audit  # + the dispatch audit
    scripts/torch_lint.sh                              # the local alias

The counterpart of the JAX package's ``analysis`` (its own copy: the port
imports nothing of that package).  Each rule encodes an invariant the
port keeps: no host sync inside a captured step, explicit random
generators, float32-max device math in the fused paths, typed errors with
the ``trace_id`` hook, no bare print, metrics-catalog drift, every kernel
tested beside its plain flavor, no leaked span (:mod:`.rules`).
:mod:`.dispatch_audit` runs the registered hot steps on the CPU under a
recording mode and, on the card, reads what a captured graph holds.

Suppress a deliberate violation with ``# tdq: allow[rule-id] reason`` —
a suppression without a reason fails, and a suppression matching no
finding fails (``unused-suppression``), so the allow list cannot rot.

This package is stdlib-only at import time: the fixture tests and the
lint gate never pay a torch import.  :mod:`.dispatch_audit` imports
torch inside its functions.
"""

from .engine import (Context, Finding, ParsedModule, Rule,  # noqa: F401
                     iter_source_files, parse_module, repo_root_default,
                     run_rules)
from .rules import ALL_RULES, RULES_BY_ID  # noqa: F401


def run_analysis(repo_root=None, select=None, files=None):
    """Run the AST pass; returns ``(findings, modules)``.

    ``select``: iterable of rule ids (default: every rule).  ``files``:
    explicit file list (default: the package + chip_smoke.py).
    """
    if select is None:
        rules = ALL_RULES
    else:
        unknown = [s for s in select if s not in RULES_BY_ID]
        if unknown:
            raise ValueError(f"unknown rule id(s): {unknown}; "
                             f"known: {sorted(RULES_BY_ID)}")
        rules = tuple(RULES_BY_ID[s] for s in select)
    return run_rules(rules, repo_root=repo_root, files=files,
                     known_rules=frozenset(RULES_BY_ID))
