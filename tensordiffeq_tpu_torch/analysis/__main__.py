"""CLI: ``python -m tensordiffeq_tpu_torch.analysis`` (alias
``tdqlint-torch``).

Exit codes: 0 clean, 1 findings, 2 usage/internal error.  Output is one
``file:line rule-id message`` per finding — editor/CI friendly.
"""

import argparse
import sys

from . import ALL_RULES, run_analysis
from .rules import JAX_RULES, NO_AST_COUNTERPART


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tdqlint-torch",
        description="static analysis for tensordiffeq_tpu_torch: the JAX "
                    "package's invariants restated for PyTorch and CUDA "
                    "graphs, as one checked-in pass")
    ap.add_argument("files", nargs="*",
                    help="files to lint (default: the whole package "
                         "+ chip_smoke.py)")
    ap.add_argument("--select", metavar="RULES",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule ids + one-line docs, and the "
                         "JAX rules' counterparts, and exit")
    ap.add_argument("--audit", action="store_true",
                    help="also run the dispatch audit over the hot-step "
                         "registry (imports torch; slower)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:28s} {rule.doc}")
        print()
        for jax_id, port_id in JAX_RULES.items():
            print(f"{jax_id:28s} -> "
                  f"{port_id or 'no AST rule: ' + NO_AST_COUNTERPART[jax_id]}")
        return 0

    select = args.select.split(",") if args.select else None
    try:
        findings, _ = run_analysis(select=select,
                                   files=args.files or None)
    except ValueError as e:
        print(f"tdqlint-torch: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.format())

    n_bad = 0
    if args.audit:
        from .dispatch_audit import audit_all
        for report in audit_all():
            status = "ok" if report.ok else "FLAGGED"
            print(f"dispatch-audit {report.name}: {status} "
                  f"({report.summary()})")
            if not report.ok:
                n_bad += 1

    if findings or n_bad:
        print(f"tdqlint-torch: {len(findings) + n_bad} finding(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
