"""NTK-based adaptive loss weighting (Wang, Yu & Perdikaris,
arXiv:2007.14527), ``Adaptive_type=3``.

Counterpart of the JAX package's ``ops/ntk.py`` on ``torch.func``.  For
loss terms ``L_i`` with per-point errors ``e_i(θ)``, the NTK of term i is
``K_i = J_i J_iᵀ`` with ``J_i = ∂e_i/∂θ``, and the balanced weights are

    λ_i = (Σ_j tr K_j) / tr K_i,

with ``tr K_i = ‖J_i‖_F²`` over a fixed stride subsample of each term's
points (no N×N kernel is formed).  The weights are recomputed between
training chunks, outside the step, and enter the loss as frozen scalars
(the SA type-2 position); ``max_ratio`` clips every λ to ``max_ratio ×
min(λ)``.  The Jacobians are ``torch.func.jacrev`` over the network's
parameters (its flat list, or ``[(W, b), ...]``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import jacrev, vmap

from ..boundaries import BC
from ..utils import param_leaves, params_like
from .derivatives import make_ufn, vmap_residual


def _subsample_index(n_rows: int, n: Optional[int]):
    """``n`` evenly strided row indices from ``0`` to ``n_rows - 1`` (the
    JAX package's ``jnp.linspace(0, n_rows - 1, n).astype(int32)``, taken
    in float64: XLA's float32 linspace puts a few of them one row off at
    large ``n_rows``), or ``None`` when no subsample is taken."""
    if n is None or n_rows <= n:
        return None
    return np.linspace(0, n_rows - 1, n).astype(np.int64)


def _subsample(arr: torch.Tensor, n: Optional[int]) -> torch.Tensor:
    """Deterministic stride subsample of the leading axis to ≤ n rows."""
    idx = _subsample_index(int(arr.shape[0]), n)
    if idx is None:
        return arr
    return arr.index_select(0, torch.as_tensor(idx, dtype=torch.long,
                                               device=arr.device))


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
        a, torch.Tensor) else a, dtype=torch.float32).to(device)


def residual_subsample(X_f: torch.Tensor, max_points: int = 256):
    """The residual term's trace points: the stride subsample
    :func:`build_error_fns` takes at build time, from the *current*
    collocation set (a redraw changes it)."""
    return _subsample(X_f.to(torch.float32), max_points)


def build_error_fns(apply_fn: Callable, varnames: Sequence[str], n_out: int,
                    f_model: Callable, bcs: Sequence[BC], X_f: torch.Tensor,
                    n_residuals: int, max_points: int = 256,
                    data_X=None, data_s=None, device=None):
    """Per-term error functions ``e(layers) -> [m]`` on fixed subsampled
    points, in the term order of :func:`..models.assembly.build_loss_fn`.

    Returns ``(bc_fns, res_all_fn, data_fn)``; ``res_all_fn(layers,
    X_sub=None) -> [n_residuals, m]`` stacks every residual equation
    (``X_sub`` overrides the build-time subsample); ``data_fn`` is ``None``
    without assimilation data."""
    device = X_f.device if device is None else device
    ndim = len(varnames)

    def vderiv(dfn, layers, pts):
        u = make_ufn(apply_fn, layers, varnames, n_out)
        out = vmap(lambda pt: dfn(u, *(pt[i] for i in range(ndim))))(pts)
        return out if isinstance(out, tuple) else (out,)

    bc_fns = []
    for bc in bcs:
        if bc.isPeriodic:
            uppers = [_subsample(_f32(p, device), max_points)
                      for p in bc.upper]
            lowers = [_subsample(_f32(p, device), max_points)
                      for p in bc.lower]
            derivs = list(bc.deriv_model)

            def e_periodic(layers, uppers=uppers, lowers=lowers,
                           derivs=derivs):
                outs = []
                for up_pts, lo_pts, dfn in zip(uppers, lowers, derivs):
                    ups = vderiv(dfn, layers, up_pts)
                    los = vderiv(dfn, layers, lo_pts)
                    outs += [(a - b).reshape(-1) for a, b in zip(ups, los)]
                return torch.cat(outs)

            bc_fns.append(e_periodic)
        elif bc.isNeumann:
            inputs = [_subsample(_f32(p, device), max_points)
                      for p in bc.input]
            vals = [_subsample(_f32(v, device), max_points) for v in bc.val]
            derivs = list(bc.deriv_model)

            def e_neumann(layers, inputs=inputs, vals=vals, derivs=derivs):
                outs = []
                for pts, val, dfn in zip(inputs, vals, derivs):
                    for comp in vderiv(dfn, layers, pts):
                        outs.append((comp.reshape(val.shape) - val)
                                    .reshape(-1))
                return torch.cat(outs)

            bc_fns.append(e_neumann)
        else:  # value-type (IC / Dirichlet)
            pts = _subsample(_f32(bc.input, device), max_points)
            val = _subsample(_f32(bc.val, device), max_points)

            def e_value(layers, pts=pts, val=val):
                return (apply_fn(layers, pts) - val).reshape(-1)

            bc_fns.append(e_value)

    X_sub0 = residual_subsample(X_f, max_points)

    def res_all_fn(layers, X_sub=None):
        pts = X_sub0 if X_sub is None else X_sub
        u = make_ufn(apply_fn, layers, varnames, n_out)
        out = vmap_residual(f_model, u, ndim)(pts)
        out = out if isinstance(out, tuple) else (out,)
        if len(out) != n_residuals:
            raise ValueError(f"f_model returned {len(out)} residual "
                             f"components, expected {n_residuals}")
        return torch.stack([o.reshape(-1) for o in out])

    data_fn = None
    if data_X is not None:
        dX = _subsample(_f32(data_X, device), max_points)
        ds = _subsample(_f32(data_s, device), max_points)

        def data_fn(layers):
            return (apply_fn(layers, dX) - ds).reshape(-1)

    return bc_fns, res_all_fn, data_fn


def _jac_leaves(e_fn: Callable, params) -> list:
    params = list(params)
    flat = [t.detach() for t in param_leaves(params)]

    def of_flat(*ts):
        return e_fn(params_like(params, ts))

    return list(jacrev(of_flat, argnums=tuple(range(len(flat))))(*flat))


def trace_K(e_fn: Callable, layers) -> torch.Tensor:
    """``tr(J Jᵀ) = ‖∂e/∂θ‖_F²`` for one loss term."""
    return sum(torch.sum(torch.square(J)) for J in _jac_leaves(e_fn, layers))


def make_ntk_weight_fn(bc_fns, res_all_fn, n_residuals: int, data_fn=None,
                       eps: float = 1e-12,
                       max_ratio: Optional[float] = None) -> Callable:
    """``ntk_weights(layers[, X_sub]) -> {"BCs": [...], "residual": [...][,
    "data": [...]]}``, each weight a 0-d tensor ``λ_i = Σ tr K / tr K_i``
    in the layout of the solver's λ.  ``X_sub`` re-points the residual
    traces at the current collocation subsample
    (:func:`residual_subsample`).  ``max_ratio`` clips every λ to
    ``max_ratio × min(λ)`` (uncapped terms keep ``λ_i·tr K_i =
    Σ tr K``)."""

    def ntk_weights(layers, X_sub=None):
        bc_traces = [trace_K(f, layers) for f in bc_fns]
        res_fn = (res_all_fn if X_sub is None
                  else (lambda p: res_all_fn(p, X_sub)))
        # one Jacobian of the stacked [n_res, m] residuals; per-row
        # Frobenius norms give every equation's trace in one pass
        res_vec = sum(torch.sum(torch.square(J),
                                dim=tuple(range(1, J.ndim)))
                      for J in _jac_leaves(res_fn, layers))
        res_traces = [res_vec[j] for j in range(n_residuals)]
        data_traces = [trace_K(data_fn, layers)] if data_fn else []
        traces = bc_traces + res_traces + data_traces
        total = sum(traces)
        lam = [(total / (t + eps)).reshape(()) for t in traces]
        if max_ratio is not None:
            lam_min = torch.min(torch.stack(lam))
            lam = [torch.minimum(v, max_ratio * lam_min) for v in lam]
        n_bc = len(bc_fns)
        out = {"BCs": lam[:n_bc],
               "residual": lam[n_bc:n_bc + n_residuals]}
        if data_fn:
            out["data"] = [lam[-1]]
        return out

    return ntk_weights
