"""Composite PINN loss assembly.

Counterpart of the JAX package's ``models/assembly.py::build_loss_fn`` (the
re-design of the reference's ``CollocationSolverND.update_loss``,
``models.py:116-218``):

* **Pure**: ``loss(params, lam_bcs, lam_res, X_batch) -> (total,
  components)`` with all BC meshes/targets moved to the device once and
  closed over.  Component losses are returned; the trainer records them.
* **Structural λ routing**: λ arrive as per-term lists (``None`` for
  non-adaptive terms).
* **Residuals** through the generic per-point engine
  (:func:`~..ops.derivatives.vmap_residual`), a fused batched
  ``residual_fn`` (one Taylor wavefront, :mod:`..ops.fused`), or a fused
  minimax ``residual_loss_fn`` (:mod:`..ops.minimax`) that replaces the
  whole residual term.
* **Periodic BCs match every derivative** the user's ``deriv_model``
  returns; **data assimilation is a real loss term**.

Self-adaptive weighting follows McClenny et al. (arXiv:2009.04544): type 1
weights point-wise inside the mean, type 2 scales each term's mean,
optional ``g(λ)`` transform on residual terms.  Causal weighting
(``causal_eps``, :func:`~..ops.losses.causal_residual_loss`) bins the
residual along time; ``remat`` recomputes the residual's evaluation in the
backward pass (``torch.utils.checkpoint``) instead of keeping it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from ..boundaries import BC
from ..ops.derivatives import UFn, make_ufn, vmap_residual
from ..ops.losses import MSE, causal_residual_loss, g_MSE
from ..utils import param_leaves, params_like, resolve_device, span


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _vmap_deriv(deriv_fn: Callable, u: UFn, pts: torch.Tensor):
    """Evaluate a user ``deriv_model(u, *coords)`` over an ``[n, d]`` face
    mesh; returns a tuple of ``[n]`` tensors (one per returned derivative)."""
    ndim = pts.shape[1]

    def per_point(pt):
        return _as_tuple(deriv_fn(u, *(pt[i] for i in range(ndim))))

    return vmap(per_point)(pts)


def build_loss_fn(apply_fn: Callable,
                  varnames: Sequence[str],
                  n_out: int,
                  f_model: Callable,
                  bcs: Sequence[BC],
                  weight_outside_sum: bool = False,
                  g: Optional[Callable] = None,
                  data_X=None,
                  data_s=None,
                  residual_fn: Optional[Callable] = None,
                  residual_loss_fn: Optional[Callable] = None,
                  causal_eps=None,
                  causal_bins: int = 32,
                  time_index: Optional[int] = None,
                  time_bounds: Optional[tuple] = None,
                  remat: bool = False,
                  mesh=None,
                  device="cuda") -> Callable:
    """Assemble ``loss(params, lam_bcs, lam_res, X_batch, lam_data=None)``.

    ``params`` is what ``apply_fn`` takes: the network's flat parameter
    list (its ``params()``; the MLP family also takes ``[(W, b), ...]``).

    Args:
      apply_fn: batched network apply ``(params, x[..., d]) -> y[..., n_out]``.
      varnames: domain variable names, in column order of ``X_batch``.
      n_out: network output dimension.
      f_model: user residual ``f_model(u, *coords)`` (per point).
      bcs: boundary/initial condition objects (host data already built).
      weight_outside_sum: SA type-2 semantics (λ scales the term's mean).
      g: optional λ transform for residual terms (``g_MSE``).
      data_X / data_s: optional assimilation observations.
      residual_fn: optional fused batched residual ``(params, X) -> preds``;
        the generic per-point engine is used when ``None``.
      residual_loss_fn: optional fused minimax residual term
        ``(params, lam_res, X) -> scalar``
        (:func:`~..ops.minimax.make_minimax_residual_loss`); when given it
        is the whole residual term (every equation and its λ), reported as
        ``Residual_0``.  The solver never pairs it with ``causal_eps`` or
        ``remat``.
      causal_eps / causal_bins / time_index / time_bounds: temporal
        causality weighting of the residual terms, on when ``causal_eps``
        is set (a number, or a 0-d tensor the caller may rewrite between
        steps); ``time_index`` is the time column of ``X_batch`` and
        ``time_bounds`` its range.  Each term reports ``Causal_w_last_j``.
        Per-point λ fold into the squared errors as the plain term does;
        a type-2 scalar λ scales the causal term.  Under ``mesh`` (data
        parallelism) the bins span the ranks
        (:func:`~..ops.losses.causal_residual_loss`); the rank's term is its
        share of the global one times the world size, so that
        :func:`~..parallel.scale_loss_fn`'s division leaves the share.
      remat: recompute the residual evaluation in the backward pass
        (``torch.utils.checkpoint``, non-reentrant, without saving the RNG
        state: the residual draws no random numbers, and a capture may
        refuse the RNG's state calls).  The same maths for one more
        forward evaluation of the residual: on ``fused="cuda"`` K1 runs
        twice per step and K2 once.
      device: where the BC meshes and targets live; ``"cuda"`` (the
        default) raises :class:`~..utils.CudaUnavailableError` without a
        card.

    Returns ``loss(...) -> (total, components)`` where ``components`` is the
    reference's per-epoch loss dict (``BC_i`` / ``Residual_i`` / ``Data`` /
    ``Total Loss``) of scalar tensors.
    """
    device = resolve_device(device)
    ndim = len(varnames)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    frozen = []
    for bc in bcs:
        if bc.isPeriodic:
            frozen.append(("periodic", [dev(p) for p in bc.upper],
                           [dev(p) for p in bc.lower], list(bc.deriv_model)))
        elif bc.isNeumann:
            frozen.append(("neumann", [dev(p) for p in bc.input],
                           [dev(v) for v in bc.val], list(bc.deriv_model)))
        elif bc.isInit or bc.isDirichlet or bc.isDirichlect:
            frozen.append(("value", dev(bc.input), dev(bc.val), None))
        else:
            raise ValueError(f"Unsupported boundary condition: {bc!r}")

    if data_X is not None:
        data_X, data_s = dev(data_X), dev(data_s)

    def residual_eval(params, X_batch):
        if residual_fn is not None:
            return residual_fn(params, X_batch)
        u_local = make_ufn(apply_fn, params, varnames, n_out)
        return vmap_residual(f_model, u_local, ndim)(X_batch)

    if remat:
        evaluate = residual_eval

        def residual_eval(params, X_batch):
            def run(X, *flat):
                return evaluate(params_like(params, flat), X)
            return checkpoint(run, X_batch, *param_leaves(params),
                              use_reentrant=False, preserve_rng_state=False)

    def loss(params, lam_bcs, lam_res, X_batch, lam_data=None):
        u = make_ufn(apply_fn, params, varnames, n_out)
        components: dict[str, torch.Tensor] = {}

        loss_bcs = 0.0
        for i, (kind, a, b, derivs) in enumerate(frozen):
            lam = lam_bcs[i] if i < len(lam_bcs) else None
            if kind == "value":
                loss_bc = MSE(apply_fn(params, a), b, lam, weight_outside_sum)
            elif kind == "periodic":
                loss_bc = 0.0
                for upper_pts, lower_pts, dfn in zip(a, b, derivs):
                    ups = _vmap_deriv(dfn, u, upper_pts)
                    los = _vmap_deriv(dfn, u, lower_pts)
                    for up, lo in zip(ups, los):
                        loss_bc = loss_bc + MSE(up, lo)
                if lam is not None and weight_outside_sum:
                    loss_bc = torch.reshape(lam, ()) * loss_bc
            else:  # neumann — derivative on each var's face vs its target
                loss_bc = 0.0
                for inp_pts, val_i, dfn in zip(a, b, derivs):
                    for comp in _vmap_deriv(dfn, u, inp_pts):
                        loss_bc = loss_bc + MSE(val_i,
                                                comp.reshape(val_i.shape))
                if lam is not None and weight_outside_sum:
                    loss_bc = torch.reshape(lam, ()) * loss_bc
            components[f"BC_{i}"] = loss_bc
            loss_bcs = loss_bcs + loss_bc

        loss_res = 0.0
        if residual_loss_fn is not None:
            # the fused minimax unit: residual, λ weighting and reduction in
            # one step; a system's whole residual reports as one component
            with span("loss.residual"):
                loss_res = residual_loss_fn(params, lam_res, X_batch)
            components["Residual_0"] = loss_res
            preds = ()
        else:
            with span("loss.residual"):
                preds = _as_tuple(residual_eval(params, X_batch))
        for j, f_pred in enumerate(preds):
            f_pred = f_pred.reshape(-1, 1)
            lam = lam_res[j] if j < len(lam_res) else None
            if causal_eps is not None:
                # per-point squared errors with λ folded in as the plain
                # term below does, then the causality-weighted bin means
                outer = None
                if lam is not None and g is not None:
                    sq = g(lam) * torch.square(f_pred)
                elif lam is not None and not weight_outside_sum:
                    sq = torch.square(lam * f_pred)
                else:
                    sq = torch.square(f_pred)
                    outer = lam
                loss_r, w_last = causal_residual_loss(
                    sq, X_batch[:, time_index], time_bounds, causal_eps,
                    causal_bins, mesh=mesh)
                if mesh is not None and mesh.size > 1:
                    loss_r = loss_r * mesh.size
                if outer is not None:
                    loss_r = torch.reshape(outer, ()) * loss_r
                components[f"Causal_w_last_{j}"] = w_last
            elif lam is not None:
                if g is not None:
                    loss_r = g_MSE(f_pred, 0.0, g(lam))
                else:
                    loss_r = MSE(f_pred, 0.0, lam, weight_outside_sum)
            else:
                loss_r = MSE(f_pred, 0.0)
            components[f"Residual_{j}"] = loss_r
            loss_res = loss_res + loss_r

        total = loss_bcs + loss_res
        if data_X is not None:
            loss_data = MSE(apply_fn(params, data_X), data_s)
            if lam_data is not None:
                loss_data = torch.reshape(lam_data, ()) * loss_data
            components["Data"] = loss_data
            total = total + loss_data

        components["Total Loss"] = total
        return total, components

    return loss
