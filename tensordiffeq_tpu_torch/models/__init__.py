"""Solvers."""

from .collocation import CollocationSolverND, NotCompiledError  # noqa: F401
from .discovery import DiscoveryModel  # noqa: F401
