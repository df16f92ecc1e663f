"""The PDE zoo: declarative benchmark problems and the convergence-gated
scorecard.

Counterpart of the JAX package's ``zoo/``.  Importing this package
registers the nine seed entries (Burgers, SA Allen-Cahn, Schrödinger,
reaction-diffusion, Taylor-Green/Navier-Stokes, 3D heat, stiff convection,
Burgers assimilation, the residual-only 2D Burgers system) and exposes the
registry and the scorecard: ``build_solver(get(id), size)`` compiles an
entry (on the card by default, where each trains on the fused minimax
kernel K3), ``race_entry``/``run_scorecard`` race the fixed, pool and
ascent arms, and ``diff_scorecards`` holds a card to a baseline such as the
JAX package's ``SCORECARD.json``.
"""

from .registry import (Budget, Reference, SizeSpec,  # noqa: F401
                       ZooEntry, ZooProblem, ZooValidationError,
                       build_solver, engine_label, get, ids, register)
# NB: import the seed-entry submodule BEFORE binding registry.entries —
# `from . import entries` resolves an existing package attribute instead
# of the submodule, and the zoo would silently register nothing.
from . import entries as _entries  # noqa: F401  (registers the seed zoo)
from .registry import entries  # noqa: F401
from .scorecard import (ARMS, SCHEMA_VERSION,  # noqa: F401
                        diff_scorecards, race_entry, run_scorecard,
                        scorecard_of)

__all__ = [
    "ARMS", "Budget", "Reference", "SCHEMA_VERSION", "SizeSpec",
    "ZooEntry", "ZooProblem", "ZooValidationError", "build_solver",
    "diff_scorecards", "engine_label", "entries", "get", "ids",
    "race_entry", "register", "run_scorecard", "scorecard_of",
]
