"""Fused residual evaluation: trace ``f_model``'s derivative requests, then
serve them from one stacked Taylor propagation (:mod:`.taylor`).

Counterpart of the JAX package's ``ops/fused.py``.  At compile time the
solver runs ``f_model`` once against a *symbolic* ``u`` whose ``grad``
applications build multi-indices instead of jvp chains; each call site is
checked to receive the untouched coordinate arguments (object identity), so
evaluating ``u`` at shifted points, transformed coordinates, or unsupported
derivative orders aborts the analysis and the solver keeps the generic
per-point autodiff engine.  The analysis only sees how ``u`` is *used*, so
the solver also cross-checks the fused residual numerically against the
generic engine on a small sample before adopting it.

When analysis succeeds and the network is the standard tanh MLP, the batched
residual becomes one derivative table (``{mi: [N, n_out]}``) and ONE batched
re-run of ``f_model`` whose ``u`` lookups return whole table columns.  The
table comes from :func:`~.taylor.taylor_derivatives` (plain flavor) or from
a ``table_producer`` such as the CUDA kernels
(:func:`~.cuda_taylor.build_cuda_table_fn`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_compute_dtype
from .derivatives import UFn
from .taylor import canonical, extract_mlp_layers, supported, taylor_derivatives


class _AbortAnalysis(Exception):
    """Internal: f_model used ``u`` in a way the fused engine can't serve."""


class _AnalysisEngine:
    """Records the set of multi-indices ``f_model`` requests."""

    def __init__(self, ndim: int):
        # Distinct 0-d tensors: object identity marks "the raw coordinate",
        # and torch functions of a coordinate (torch.sin(x)) take them, as
        # the batched and per-point engines' coordinates are tensors too
        self.tokens = tuple(torch.tensor(0.1 + 0.05 * i) for i in range(ndim))
        self.requests: set = set()

    def lookup(self, multi_index, component, coords, n_out):
        if len(coords) != len(self.tokens) or any(
                c is not t for c, t in zip(coords, self.tokens)):
            raise _AbortAnalysis(
                "u was evaluated at transformed or reordered coordinates")
        mi = canonical(multi_index)
        if not supported(mi):
            raise _AbortAnalysis(f"unsupported derivative order {mi}")
        self.requests.add(mi)
        if component is None and n_out > 1:
            return torch.zeros(n_out)
        return torch.tensor(0.0)


class _TableEngine:
    """Serves recorded derivatives from the batched derivative table."""

    def __init__(self, tokens: tuple, table: dict):
        self.tokens = tokens
        self.table = table  # {multi_index: [N, n_out] tensor}

    def lookup(self, multi_index, component, coords, n_out):
        if len(coords) != len(self.tokens) or any(
                c is not t for c, t in zip(coords, self.tokens)):
            # tdq: allow[bare-raise-discipline] internal invariant guard — unreachable once analyze_f_model accepted the f_model
            raise RuntimeError(
                "fused residual: u evaluated at unexpected coordinates "
                "(analysis should have rejected this f_model)")
        arr = self.table[canonical(multi_index)]
        if component is None and n_out > 1:
            return arr  # [N, n_out]
        return arr[:, 0 if component is None else component]  # [N]


class SymbolicUFn(UFn):
    """A ``UFn`` whose derivative structure is interpreted by an engine
    (analysis recording or table lookup) instead of autodiff."""

    def __init__(self, engine, varnames: Sequence[str], n_out: int = 1,
                 multi_index: tuple = (), component: Optional[int] = None):
        self._engine = engine
        self.varnames = tuple(varnames)
        self._n_out_full = n_out
        self.n_out = 1 if component is not None else n_out
        self._multi_index = multi_index
        self._component = component

    def __call__(self, *coords):
        return self._engine.lookup(self._multi_index, self._component, coords,
                                   self._n_out_full)

    def __getitem__(self, k: int) -> "SymbolicUFn":
        if self.n_out == 1:  # scalar (or already component-selected)
            if k != 0:
                raise IndexError("scalar UFn only has component 0")
            return self
        return SymbolicUFn(self._engine, self.varnames, self._n_out_full,
                           self._multi_index, component=k)

    def differentiate(self, num: int, mode: str) -> "SymbolicUFn":
        return SymbolicUFn(self._engine, self.varnames, self._n_out_full,
                           self._multi_index + (num,),
                           component=self._component)


def mlp_qualifies(net, params=None):
    """The ``[(W, b), ...]`` layers when ``net`` is exactly the port's
    standard float32 tanh :class:`~tensordiffeq_tpu_torch.networks.MLP`
    the Taylor propagation can differentiate, else ``None``: the JAX
    package's gate.  A subclass may override ``forward`` (and the
    embedding families transform the coordinates), another activation is
    another chain rule, and a bf16 ``dtype`` or ``param_dtype`` would
    diverge from the generic engine's numerics, so all are excluded; the
    ``precision`` is no part of the gate."""
    from ..networks import MLP, TANH

    if (type(net) is not MLP or net.activation not in TANH
            or net.dtype != torch.float32
            or net.param_dtype != torch.float32):
        return None
    layers = extract_mlp_layers(net if params is None else params)
    if layers is None or any(W.dtype != torch.float32 for W, _ in layers):
        return None
    return layers


class FusedMismatch(ValueError):
    """The fused engine's values disagree with the generic engine's beyond
    the legitimate contraction-order band — the engine is computing
    different math, not merely failing to compile."""

    trace_id = None


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def crosscheck_residuals(generic, fused, rtol: float = 5e-3,
                         atol: float = 1e-5):
    """Compare a fused engine's residual against the generic engine's on the
    same sample points.  Returns ``(ok, reason)``.  Scale-relative, NaN-safe
    (``not (err <= band)``) — the JAX package's band and policy."""
    gen_t = generic if isinstance(generic, tuple) else (generic,)
    fus_t = fused if isinstance(fused, tuple) else (fused,)
    if len(gen_t) != len(fus_t):
        return False, FusedMismatch(
            f"fused residual returned {len(fus_t)} component(s), "
            f"generic returned {len(gen_t)}")
    for i, (g_c, f_c) in enumerate(zip(gen_t, fus_t)):
        g_np, f_np = _to_numpy(g_c), _to_numpy(f_c)
        if g_np.shape != f_np.shape:
            return False, FusedMismatch(
                f"fused residual component {i} has shape {f_np.shape}, "
                f"generic has {g_np.shape}")
        err = float(np.max(np.abs(f_np - g_np)))
        scale = float(np.max(np.abs(g_np)))
        if not (err <= atol + rtol * scale):
            return False, FusedMismatch(
                f"fused residual disagrees with the generic engine on "
                f"{g_np.shape[0]} sample points (component {i}, max abs "
                f"diff {err:.3e} vs scale {scale:.3e}); the f_model is "
                "likely not pointwise when evaluated batched")
    return True, None


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def crosscheck_grads(g_gen, g_fus, rtol: float = 5e-3, atol: float = 1e-5):
    """Leaf-wise gradient agreement between engines (nests of lists/tuples
    of tensors).  Returns ``(ok, reason)``."""
    gen_leaves, fus_leaves = _leaves(g_gen), _leaves(g_fus)
    if len(gen_leaves) != len(fus_leaves):
        return False, FusedMismatch(
            f"gradient trees have {len(fus_leaves)} vs {len(gen_leaves)} "
            "leaves")
    for lg, lf in zip(gen_leaves, fus_leaves):
        lg, lf = _to_numpy(lg), _to_numpy(lf)
        scale = float(np.max(np.abs(lg))) + atol
        err = float(np.max(np.abs(lf - lg)))
        if not (err / scale <= rtol):  # NaN-safe: see crosscheck_residuals
            return False, FusedMismatch(
                f"fused residual GRADIENT disagrees with the generic "
                f"engine (relative error {err / scale:.3e} on a parameter "
                f"leaf); the engine's backward pass is wrong")
    return True, None


def analyze_f_model(f_model: Callable, varnames: Sequence[str],
                    n_out: int, return_reason: bool = False,
                    prefix_args: tuple = ()):
    """Dry-run ``f_model`` symbolically.  Returns the set of canonical
    multi-indices it requests (with the primal), or ``None`` if it isn't
    fusable; with ``return_reason=True`` returns ``(requests_or_None,
    reason)``."""
    engine = _AnalysisEngine(len(varnames))
    u = SymbolicUFn(engine, varnames, n_out)
    reason = None
    try:
        f_model(u, *prefix_args, *engine.tokens)
    except Exception as e:  # _AbortAnalysis, or the user's own error
        reason = e
    requests = None if reason is not None else engine.requests | {()}
    return (requests, reason) if return_reason else requests


def make_fused_residual(f_model: Callable, varnames: Sequence[str],
                        n_out: int, requests: set,
                        table_producer: Optional[Callable] = None,
                        has_prefix_arg: bool = False,
                        return_primal: bool = False,
                        compute_dtype=None,
                        precision="highest") -> Callable:
    """Build ``residual(params, X) -> [N] | tuple of [N]`` backed by one
    Taylor propagation.  ``params`` is an MLP, its flat parameter list or
    its ``[(W, b), ...]``.

    ``table_producer(layers, X) -> {mi: [N, n_out]}`` replaces the plain
    propagation — the hook the CUDA kernels plug into
    (:func:`~.cuda_taylor.build_cuda_table_fn`).

    ``has_prefix_arg=True`` builds ``residual(params, X, var)`` for the
    inverse-problem contract ``f_model(u, var, *coords)``: ``var`` (the
    trainable coefficients) multiplies the table's columns like any other
    batched value.  ``return_primal=True`` returns ``(residual, u)`` with
    ``u = table[()]``: a data loss at the same ``X`` takes the primal from
    the propagation instead of a second network forward.

    ``compute_dtype`` (``None`` or ``"bfloat16"``/``torch.bfloat16``): the
    plain propagation's flavor (:func:`~.taylor.taylor_derivatives`); a
    ``table_producer`` carries its own.  ``precision``: the network's, for
    the plain propagation's products (on the card; IEEE float32 on the
    CPU at every precision)."""
    ndim = len(varnames)
    dtype = resolve_compute_dtype(compute_dtype)

    def residual(params, X, *prefix):
        layers = extract_mlp_layers(params)
        if layers is None:
            raise ValueError(
                "fused residual requires the standard MLP parameters "
                "(its flat list, or [(W, b), ...])")
        if table_producer is not None:
            table = table_producer(layers, X)
        else:
            table = taylor_derivatives(layers, X, requests,
                                       compute_dtype=dtype,
                                       precision=precision)
        # ONE batched re-run of f_model: lookups return whole [N] columns
        coords = tuple(X[:, i] for i in range(ndim))
        u = SymbolicUFn(_TableEngine(coords, table), varnames, n_out)
        out = f_model(u, *prefix, *coords)
        if return_primal:
            return out, table[()]
        return out

    if not has_prefix_arg:
        def residual_no_prefix(params, X):
            return residual(params, X)
        return residual_no_prefix
    return residual
