"""Collocation-point sampling.

Capability parity with the reference's vendored-SMT sampler stack
(``tensordiffeq/sampling.py``): an options-validated sampling-method hierarchy
(``sampling.py:14,148,201``) and a Latin-Hypercube sampler with the classic
criteria set including the maximin-ESE annealing optimizer
(``sampling.py:256-534``).

Plain LHS is delegated to ``scipy.stats.qmc.LatinHypercube`` (pyDOE2 is
not vendored), and the "enhanced stochastic evolutionary" (ESE) maximin
optimizer is implemented from the published algorithm (Jin, Chen &
Sudjianto 2005) in vectorised NumPy.  Sampling is host-side setup work;
determinism comes from explicit seeds rather than global RNG state, so for
the same seed every criterion gives the same arrays as the JAX package's
sampler.  ``"ese"`` runs the native C++ optimizer (:mod:`.native`) when it
builds, as the JAX package does, and the NumPy one otherwise.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
from scipy.spatial.distance import pdist
from scipy.stats import qmc


class OptionsDictionary:
    """Declare/validate options mapping (parity: reference ``sampling.py:14-146``)."""

    def __init__(self):
        self._declared: dict[str, dict[str, Any]] = {}
        self._values: dict[str, Any] = {}

    def declare(self, name: str, default: Any = None, values: Optional[Sequence] = None,
                types: Any = None, desc: str = ""):
        self._declared[name] = {"values": values, "types": types, "desc": desc}
        self._values[name] = default

    def update(self, other: dict):
        for name, value in other.items():
            self[name] = value

    def __setitem__(self, name: str, value: Any):
        if name not in self._declared:
            raise KeyError(f"Option {name!r} has not been declared")
        spec = self._declared[name]
        if spec["values"] is not None and value not in spec["values"]:
            if spec["types"] is None or not isinstance(value, spec["types"]):
                raise ValueError(
                    f"Option {name!r}: value {value!r} not in {spec['values']}")
        elif spec["types"] is not None and not isinstance(value, spec["types"]):
            raise TypeError(f"Option {name!r}: expected {spec['types']}, got {type(value)}")
        self._values[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values


class SamplingMethod:
    """Base sampler over a box domain (parity: reference ``sampling.py:148-198``).

    ``xlimits`` is an ``[nx, 2]`` array of per-dimension ``[lower, upper]``.
    Calling the instance with ``nt`` returns an ``[nt, nx]`` design.
    """

    def __init__(self, **kwargs):
        self.options = OptionsDictionary()
        self.options.declare("xlimits", types=np.ndarray,
                             desc="[nx, 2] per-dimension bounds")
        self._initialize()
        self.options.update(kwargs)

    def _initialize(self):
        pass

    def __call__(self, nt: int) -> np.ndarray:
        return self._compute(nt)

    def _compute(self, nt: int) -> np.ndarray:
        raise NotImplementedError


class ScaledSamplingMethod(SamplingMethod):
    """Sampler computed in the unit hypercube then affinely scaled to
    ``xlimits`` (parity: reference ``sampling.py:201-253``)."""

    def __call__(self, nt: int) -> np.ndarray:
        xlimits = self.options["xlimits"]
        unit = self._compute_unit(nt)
        return _scale_to_xlimits(unit, xlimits)

    def _compute(self, nt: int) -> np.ndarray:
        return self.__call__(nt)

    def _compute_unit(self, nt: int) -> np.ndarray:
        raise NotImplementedError


def _scale_to_xlimits(samples: np.ndarray, xlimits: np.ndarray) -> np.ndarray:
    lower = xlimits[:, 0]
    upper = xlimits[:, 1]
    return lower + samples * (upper - lower)


class LHS(ScaledSamplingMethod):
    """Latin Hypercube sampling with optimality criteria.

    Criteria (parity with reference ``sampling.py:259-311``):
      - ``'c'``/``'center'``: centered within strata
      - ``'m'``/``'maximin'``: best-of-k random designs by min pairwise distance
      - ``'cm'``/``'centermaximin'``: centered variant of maximin
      - ``'corr'``/``'correlation'``: best-of-k by minimal max off-diagonal corr
      - ``'ese'``: maximin via Enhanced Stochastic Evolutionary annealing
      - ``None``: plain randomized LHS
    """

    def _initialize(self):
        self.options.declare(
            "criterion", default="c",
            values=["center", "maximin", "centermaximin", "correlation",
                    "c", "m", "cm", "corr", "ese", None],
            desc="LHS optimality criterion")
        self.options.declare("random_state", default=None,
                             types=(int, np.random.RandomState, type(None)),
                             desc="seed or RandomState for determinism")

    def _rng(self) -> np.random.RandomState:
        rs = self.options["random_state"]
        if isinstance(rs, np.random.RandomState):
            return rs
        return np.random.RandomState(rs)

    def _compute_unit(self, nt: int) -> np.ndarray:
        xlimits = self.options["xlimits"]
        nx = xlimits.shape[0]
        crit = self.options["criterion"]
        rng = self._rng()
        seed = rng.randint(0, 2**31 - 1)

        if crit in (None, "c", "center"):
            scramble = crit is None
            sampler = qmc.LatinHypercube(d=nx, scramble=scramble, seed=seed)
            return sampler.random(nt)
        if crit in ("m", "maximin", "cm", "centermaximin"):
            scramble = crit in ("m", "maximin")
            best, best_score = None, -np.inf
            for k in range(5):
                sampler = qmc.LatinHypercube(d=nx, scramble=scramble, seed=seed + k)
                cand = sampler.random(nt)
                score = pdist(cand).min() if nt > 1 else 1.0
                if score > best_score:
                    best, best_score = cand, score
            return best
        if crit in ("corr", "correlation"):
            best, best_score = None, np.inf
            for k in range(5):
                sampler = qmc.LatinHypercube(d=nx, scramble=True, seed=seed + k)
                cand = sampler.random(nt)
                if nx < 2 or nt < 3:
                    return cand
                r = np.corrcoef(cand.T)
                score = np.max(np.abs(r - np.eye(nx)))
                if score < best_score:
                    best, best_score = cand, score
            return best
        if crit == "ese":
            sampler = qmc.LatinHypercube(d=nx, scramble=True, seed=seed)
            X0 = sampler.random(nt)
            if nt >= 3:
                from . import native
                if native.available():
                    outer, inner, J = _ese_schedule(*X0.shape)
                    return native.ese_optimize(
                        X0, outer_loops=outer, inner_loops=inner, J=J,
                        seed=seed)
            return _maximin_ese(X0, rng)
        raise ValueError(f"Unknown LHS criterion: {crit!r}")


def _ese_schedule(n: int, nx: int) -> tuple:
    """Annealing schedule (outer loops, inner loops, J proposals) shared by
    the NumPy and native C++ ESE optimizers."""
    outer = min(30, max(5, int(1.5 * nx)))
    inner = min(20, max(5, n // 5))
    J = min(10, max(1, n // 10))
    return outer, inner, J


def _phi_p(X: np.ndarray, p: float = 10.0) -> float:
    """PhiP space-filling criterion (smaller = better; reference
    ``sampling.py:454-462``): ``(sum d_ij^-p)^(1/p)`` over pairwise distances."""
    d = pdist(X)
    return float((d ** (-p)).sum() ** (1.0 / p))


def _phi_p_swap(X: np.ndarray, phi: float, k: int, i1: int, i2: int,
                p: float) -> float:
    """PhiP value X would have after swapping rows ``i1``/``i2`` in column
    ``k``, computed incrementally in O(n) without modifying ``X``
    (the rank-1 update idea of reference ``sampling.py:465-513``,
    re-derived from the PhiP definition as a pure function)."""
    n = X.shape[0]
    mask = np.ones(n, dtype=bool)
    mask[[i1, i2]] = False
    others = X[mask]

    d1_old = np.sqrt(((others - X[i1]) ** 2).sum(axis=1))
    d2_old = np.sqrt(((others - X[i2]) ** 2).sum(axis=1))
    X1_new = X[i1].copy()
    X2_new = X[i2].copy()
    X1_new[k], X2_new[k] = X2_new[k], X1_new[k]
    d1_new = np.sqrt(((others - X1_new) ** 2).sum(axis=1))
    d2_new = np.sqrt(((others - X2_new) ** 2).sum(axis=1))

    res = (phi ** p
           + (d1_new ** (-p) - d1_old ** (-p)).sum()
           + (d2_new ** (-p) - d2_old ** (-p)).sum())
    return float(max(res, 0.0) ** (1.0 / p))


def _maximin_ese(X: np.ndarray, rng: np.random.RandomState, p: float = 10.0,
                 outer_loops: Optional[int] = None,
                 inner_loops: Optional[int] = None) -> np.ndarray:
    """Enhanced Stochastic Evolutionary maximin-LHS optimizer.

    Implements Jin, Chen & Sudjianto (2005) as used by the reference's
    ``_maximinESE`` / ``_ese`` (``sampling.py:315-534``): an annealing loop
    whose acceptance temperature T adapts to the accept/improve ratios, inner
    loop proposing column-wise row swaps that preserve the LHS property.
    """
    n, nx = X.shape
    if n < 3:
        return X
    default_outer, default_inner, J = _ese_schedule(n, nx)
    outer_loops = outer_loops or default_outer
    inner_loops = inner_loops or default_inner

    X = X.copy()
    phi = _phi_p(X, p)
    phi_best = phi
    X_best = X.copy()
    T = 0.005 * phi

    for _ in range(outer_loops):
        n_accept = 0
        n_improve = 0
        for inner in range(inner_loops):
            k = inner % nx
            # best of J random row-swap proposals in column k
            best_try_phi, best_pair = np.inf, None
            for _ in range(J):
                i1, i2 = rng.choice(n, size=2, replace=False)
                phi_try = _phi_p_swap(X, phi, k, i1, i2, p)
                if phi_try < best_try_phi:
                    best_try_phi, best_pair = phi_try, (i1, i2)
            i1, i2 = best_pair
            if best_try_phi - phi <= T * rng.rand():
                X[[i1, i2], k] = X[[i2, i1], k]
                phi = best_try_phi
                n_accept += 1
                if phi < phi_best:
                    phi_best = phi
                    X_best = X.copy()
                    n_improve += 1
        # temperature adaptation (Jin et al. §3.2)
        acc = n_accept / inner_loops
        imp = n_improve / inner_loops
        if imp < 0.1:
            T = T * 0.8 if acc > 0.1 else T / 0.7
        else:
            T = T * 0.9 if acc > imp else T / 0.9
    return X_best


def LatinHypercubeSample(N_f: int, bounds: np.ndarray,
                         criterion: str = "c",
                         seed: Optional[int] = None) -> np.ndarray:
    """One-call LHS over ``bounds=[nx,2]`` (parity: reference
    ``utils.py:59-61``)."""
    sampler = LHS(xlimits=np.asarray(bounds, dtype=np.float64),
                  criterion=criterion, random_state=seed)
    return sampler(N_f)
