"""The declarative PDE-zoo registry.

Counterpart of the JAX package's ``zoo/registry.py``.  A :class:`ZooEntry`
is a *declaration* of a benchmark problem — domain, BCs, (possibly
tuple/system) residual, reference solution, and a declared ``(budget,
gate)`` per operating size — rather than an example script.  The registry
is the single source of truth: the scorecard (:mod:`.scorecard`) races the
adaptive-collocation arms over it and its diff holds every entry to the
accuracy it declared.

Entries register at import time (:mod:`.entries`); user code reaches
them through :func:`get` / :func:`entries` / :func:`ids` and builds a
compiled solver with :func:`build_solver`.  Registration and build both
validate the declaration (unique kebab-case ids, sane budgets and gates,
network/residual arity agreement) and raise the typed
:class:`ZooValidationError` on drift.
"""

from __future__ import annotations

import inspect
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Budget", "Reference", "SizeSpec", "ZooEntry", "ZooProblem",
    "ZooValidationError", "build_solver", "engine_label", "entries",
    "get", "ids", "register",
]

_ID = re.compile(r"^[a-z0-9]+(-[a-z0-9]+)*$")

#: the operating sizes every entry must declare: ``micro`` is the
#: CPU-scale scorecard/CI point, ``full`` the paper-scale configuration
REQUIRED_SIZES = ("micro", "full")


class ZooValidationError(ValueError):
    """A zoo declaration failed validation (registration or build time)."""

    trace_id = None


@dataclass(frozen=True)
class Budget:
    """Declared optimizer budget: Adam epochs then L-BFGS iterations."""

    adam: int
    lbfgs: int

    @property
    def total(self) -> int:
        return self.adam + self.lbfgs


@dataclass(frozen=True)
class SizeSpec:
    """One declared operating point of an entry.

    ``grid`` is builder-interpreted fidelity (e.g. ``(nx, nt)``); the
    gate is the entry's OWN accuracy bar at this budget — rel-L2 against
    the reference when one exists, RMS residual on a held-out
    collocation grid for residual-only entries (``gate_residual``).
    """

    n_f: int
    widths: Tuple[int, ...]
    grid: Tuple[int, ...]
    budget: Budget
    gate_rel_l2: Optional[float] = None
    gate_residual: Optional[float] = None


@dataclass(frozen=True)
class Reference:
    """Reference solution on a grid: query points ``X`` ``[M, n_in]``,
    truth ``u`` ``[M, k]``, and an optional ``transform`` mapping raw
    network predictions ``[M, n_out] -> [M, k]`` (e.g. |h| for the
    complex NLS field)."""

    X: np.ndarray
    u: np.ndarray
    transform: Optional[Callable] = None

    def compare(self, pred: np.ndarray) -> np.ndarray:
        pred = np.asarray(pred)
        return pred if self.transform is None else self.transform(pred)


@dataclass(frozen=True)
class ZooProblem:
    """What an entry's builder returns: everything ``compile()`` needs,
    plus optional sparse observations for assimilation entries
    (``data`` goes to ``compile_data``)."""

    domain: object
    bcs: Sequence[object]
    f_model: Callable
    layer_sizes: Tuple[int, ...]
    compile_kw: Dict = field(default_factory=dict)
    data: Optional[Tuple[np.ndarray, ...]] = None


@dataclass(frozen=True)
class ZooEntry:
    """A declarative benchmark-problem registration.

    ``build(spec)`` constructs the :class:`ZooProblem` at a declared
    size; ``reference(spec)`` returns the :class:`Reference` (or
    ``None`` for residual-only entries).  ``n_components`` is the
    residual arity — >1 declares a true multi-component system, which
    the micro-compile test holds to fused-system-engine adoption.
    """

    id: str
    title: str
    equation: str
    n_inputs: int
    n_components: int
    build: Callable[[SizeSpec], ZooProblem]
    reference: Optional[Callable[[SizeSpec], Reference]]
    sizes: Mapping[str, SizeSpec]
    tags: Tuple[str, ...] = ()
    notes: str = ""

    @property
    def system(self) -> bool:
        return self.n_components > 1

    @property
    def inverse(self) -> bool:
        return "inverse" in self.tags or "assimilation" in self.tags

    def spec(self, size: str) -> SizeSpec:
        try:
            return self.sizes[size]
        except KeyError:
            raise ZooValidationError(
                f"zoo entry '{self.id}' declares no '{size}' size "
                f"(declared: {sorted(self.sizes)})") from None

    def gate(self, size: str) -> float:
        s = self.spec(size)
        return s.gate_rel_l2 if s.gate_rel_l2 is not None \
            else s.gate_residual


_REGISTRY: Dict[str, ZooEntry] = {}


def _validate_spec(entry_id: str, name: str, spec: SizeSpec) -> None:
    if not isinstance(spec.n_f, int) or spec.n_f <= 0:
        raise ZooValidationError(
            f"zoo entry '{entry_id}' size '{name}': n_f must be a "
            f"positive int, got {spec.n_f!r}")
    if not spec.widths or any(int(w) <= 0 for w in spec.widths):
        raise ZooValidationError(
            f"zoo entry '{entry_id}' size '{name}': widths must be "
            f"positive, got {spec.widths!r}")
    b = spec.budget
    if b.adam < 0 or b.lbfgs < 0 or b.total <= 0:
        raise ZooValidationError(
            f"zoo entry '{entry_id}' size '{name}': budget must have "
            f"non-negative phases and a positive total, got "
            f"adam={b.adam} lbfgs={b.lbfgs}")
    gates = [g for g in (spec.gate_rel_l2, spec.gate_residual)
             if g is not None]
    if len(gates) != 1:
        raise ZooValidationError(
            f"zoo entry '{entry_id}' size '{name}': declare exactly one "
            "of gate_rel_l2 (reference entries) / gate_residual "
            "(residual-only entries)")
    if not (0.0 < float(gates[0])):
        raise ZooValidationError(
            f"zoo entry '{entry_id}' size '{name}': gate must be "
            f"positive, got {gates[0]!r}")
    if spec.gate_rel_l2 is not None and not spec.gate_rel_l2 <= 1.0:
        raise ZooValidationError(
            f"zoo entry '{entry_id}' size '{name}': gate_rel_l2 must be "
            f"in (0, 1] — a gate above 1.0 is met by predicting zero "
            f"(got {spec.gate_rel_l2!r})")


def register(entry: ZooEntry) -> ZooEntry:
    """Validate and register an entry; returns it (decorator-friendly)."""
    if not _ID.match(entry.id):
        raise ZooValidationError(
            f"zoo entry id {entry.id!r} is not kebab-case "
            "([a-z0-9]+(-[a-z0-9]+)*)")
    if entry.id in _REGISTRY:
        raise ZooValidationError(
            f"zoo entry id '{entry.id}' is already registered")
    if entry.n_components < 1 or entry.n_inputs < 2:
        raise ZooValidationError(
            f"zoo entry '{entry.id}': n_components >= 1 and "
            f"n_inputs >= 2 required, got {entry.n_components}/"
            f"{entry.n_inputs}")
    missing = [s for s in REQUIRED_SIZES if s not in entry.sizes]
    if missing:
        raise ZooValidationError(
            f"zoo entry '{entry.id}' is missing declared sizes: "
            f"{missing} (every entry declares {list(REQUIRED_SIZES)})")
    for name, spec in entry.sizes.items():
        _validate_spec(entry.id, name, spec)
        if entry.reference is None and spec.gate_rel_l2 is not None:
            raise ZooValidationError(
                f"zoo entry '{entry.id}' size '{name}': a residual-only "
                "entry (reference=None) cannot declare gate_rel_l2")
        if entry.reference is not None and spec.gate_residual is not None:
            raise ZooValidationError(
                f"zoo entry '{entry.id}' size '{name}': an entry with a "
                "reference gates on rel-L2, not gate_residual")
    _REGISTRY[entry.id] = entry
    return entry


def get(entry_id: str) -> ZooEntry:
    try:
        return _REGISTRY[entry_id]
    except KeyError:
        raise ZooValidationError(
            f"unknown zoo entry '{entry_id}' "
            f"(registered: {sorted(_REGISTRY)})") from None


def ids() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def entries() -> Tuple[ZooEntry, ...]:
    return tuple(_REGISTRY[i] for i in ids())


def engine_label(solver) -> str:
    """The loss engine a compiled solver actually adopted:
    ``"fused-minimax-cuda"`` (K3 on the card), ``"fused-minimax-plain"``
    (its plain flavor on the CPU), ``"fused"`` or ``"generic"`` — the
    JAX package's labels, with the port's minimax kinds."""
    kind = getattr(solver, "_minimax_kind", None)
    if kind:
        return f"fused-minimax-{kind}"
    if getattr(solver, "_fused_residual", None) is not None:
        return "fused"
    return "generic"


def build_solver(entry: ZooEntry, size: str = "micro", *,
                 spec: Optional[SizeSpec] = None, seed: int = 0,
                 network_factory: Optional[Callable] = None,
                 verbose: bool = False, device="cuda",
                 **compile_overrides):
    """Build and ``compile()`` a :class:`CollocationSolverND` for an entry
    at a declared size (or an explicit ``spec`` override, the example
    scripts' path to CLI-overridden configs).

    ``network_factory(layer_sizes, domain) -> network`` lets callers swap
    the ansatz (e.g. the exactly-periodic embedding) without the entry
    losing ownership of the problem declaration; ``compile_overrides``
    pass straight through to ``compile()``.  ``device`` is the solver's
    (the card by default; ``"cpu"`` for the plain flavors).  Raises
    :class:`ZooValidationError` when the built problem contradicts the
    declaration (wrong network in/out arity, or a fused system engine
    whose equation count disagrees with ``n_components``).
    """
    from ..models import CollocationSolverND

    if spec is None:
        spec = entry.spec(size)
    else:
        _validate_spec(entry.id, f"override({size})", spec)
    # builders that declare a ``seed`` kwarg get the run seed too, so one
    # seed pins ALL RNG consumers (collocation draw, net init, λ init)
    if "seed" in inspect.signature(entry.build).parameters:
        problem = entry.build(spec, seed=seed)
    else:
        problem = entry.build(spec)
    layers = list(problem.layer_sizes)
    if layers[0] != entry.n_inputs:
        raise ZooValidationError(
            f"zoo entry '{entry.id}': built network takes {layers[0]} "
            f"inputs but the entry declares n_inputs={entry.n_inputs}")
    if layers[-1] != entry.n_components:
        raise ZooValidationError(
            f"zoo entry '{entry.id}': built network has {layers[-1]} "
            f"outputs but the entry declares "
            f"n_components={entry.n_components} residual components")
    solver = CollocationSolverND(assimilate=problem.data is not None,
                                 verbose=verbose, seed=seed, device=device)
    compile_kw = dict(problem.compile_kw)
    compile_kw.update(compile_overrides)
    if network_factory is not None:
        compile_kw["network"] = network_factory(layers, problem.domain)
    solver.compile(layers, problem.f_model, problem.domain,
                   list(problem.bcs), **compile_kw)
    if problem.data is not None:
        solver.compile_data(*problem.data)
    n_eq = getattr(solver, "_minimax_n_eq", None)
    if n_eq is not None and int(n_eq) != entry.n_components:
        raise ZooValidationError(
            f"zoo entry '{entry.id}': the fused system engine counted "
            f"{int(n_eq)} equations but the entry declares "
            f"n_components={entry.n_components} — residual arity drift")
    return solver
