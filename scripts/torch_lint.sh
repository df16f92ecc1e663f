#!/usr/bin/env bash
# tdqlint-torch local entry point: the port's AST pass, which tier-1 gates
# on (tests/test_torch_lint_clean.py).
#
#   scripts/torch_lint.sh                # AST rules over the port + chip_smoke.py
#   scripts/torch_lint.sh --audit        # + the dispatch audit of the hot steps
#   scripts/torch_lint.sh --list-rules   # rule ids, docs, the JAX rules' mapping
#
# Exit codes: 0 clean, 1 findings, 2 usage error.  The captured graphs'
# audit on the card is chip_smoke.py's phase 22 (--audit-only).
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m tensordiffeq_tpu_torch.analysis "$@"
