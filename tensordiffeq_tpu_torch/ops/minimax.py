"""One fused minimax step: collocation points → SA-λ-weighted residual loss
→ parameter cotangents and the per-point λ gradient-ascent direction, for
scalar residuals and E-equation systems alike.

Counterpart of the JAX package's ``ops/pallas_minimax.py``.  The loss term
itself is the fused unit: ``sq(layers, w, X) = Σ_e Σ_p w_{p,e}·f_{p,e}(X)²``
is a ``torch.autograd.Function`` whose forward computes the value and
every cotangent (dW/db, ``∂/∂w = f² [N, E]`` which becomes the SA-λ ascent
direction, and ``∂/∂X`` summed over the equations) in one pass; its
backward only scales them by the incoming scalar.

Two flavors, chosen by the tensors' device, never by a fallback:

* CPU tensors take the plain flavor, ``tile_sq``: the Taylor table from
  :func:`~.taylor.taylor_derivatives` (``flat_matmul=True``), one batched
  re-run of ``f_model`` on it, ``sum(w·f²)``, and autograd for the
  cotangents.  It is the CPU path and the referee for the kernel.
* CUDA tensors launch the hand-written kernel K3
  (:func:`~.cuda_minimax.k3_minimax`, ``csrc/minimax_step.cu``), or raise.
  K3 runs the ``f_model`` as the residual tape it was lowered to at build
  time (:mod:`.residual_tape`).  The lowering runs on both devices, so
  whether the step can be built does not depend on the device.

The λ modes map onto the ``w`` channels as in the JAX package
(:func:`make_minimax_residual_loss`); their chain rule composes by
ordinary autograd outside the fused unit.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils import resolve_device
from .cuda_minimax import MinimaxPlan, k3_minimax
from .fused import SymbolicUFn, _TableEngine
from .residual_tape import lower_residual
from .taylor import (canonical, channel_order, closure, extract_mlp_layers,
                     taylor_derivatives)


def _sorted_mis(requests: set) -> list:
    return sorted(set(map(canonical, requests)) | {()},
                  key=lambda t: (len(t), t))


def n_channels(requests: set) -> int:
    """Channels the wavefront carries for a request set (primal included):
    the per-layer matmul multiplicity."""
    firsts, seconds, thirds, fourths = closure(set(requests))
    return 1 + len(firsts) + len(seconds) + len(thirds) + len(fourths)


def residual_columns(f_model: Callable, varnames: Sequence[str], n_out: int,
                     requests: set) -> int:
    """Number of single-column residual equations ``f_model`` defines: the
    E of ``Σ_e Σ_p w_{p,e}·f_{p,e}²`` and the width of its ``w`` block.

    A tuple-returning ``f_model`` is an E-equation system; a plain tensor
    is E = 1.  Raises :class:`ValueError` for a component (or the single
    residual) that has more than one column per point."""
    ndim = len(varnames)
    X = torch.zeros((2, ndim))
    table = {mi: torch.zeros((2, n_out)) for mi in _sorted_mis(requests)}
    coords = tuple(X[:, i] for i in range(ndim))
    u = SymbolicUFn(_TableEngine(coords, table), varnames, n_out)
    with torch.no_grad():
        out = f_model(u, *coords)
    parts = out if isinstance(out, tuple) else (out,)
    for e, p in enumerate(parts):
        cols = int(torch.reshape(torch.as_tensor(p), (2, -1)).shape[1])
        if cols != 1:
            raise ValueError(
                f"residual component {e} has {cols} output columns; "
                "per-point λ weighting is defined for single-column "
                "residual equations")
    return len(parts)


class _MinimaxSq(torch.autograd.Function):
    """``value = sq(w, X, *flat)``: the forward computes the value and
    saves every cotangent; the backward scales them by the incoming
    scalar (the JAX package's ``sq_bwd``)."""

    @staticmethod
    def forward(ctx, value_and_grads, w, X, *flat):
        val, gflat, gw, gX = value_and_grads(flat, w, X)
        ctx.save_for_backward(gw, gX, *gflat)
        return val

    @staticmethod
    def backward(ctx, g):
        gw, gX, *gflat = ctx.saved_tensors
        need = ctx.needs_input_grad
        return (None, *(t * g if n else None
                        for t, n in zip([gw, gX, *gflat], need[1:])))


def build_minimax_sq_fn(f_model: Callable, varnames: Sequence[str],
                        n_out: int, requests: set,
                        layer_shapes: Sequence[tuple],
                        device="cuda") -> Callable:
    """Build ``sq_fn(layers, w, X) -> Σ_e Σ_p w_{p,e}·f_{p,e}(X)²`` (see
    the module docstring).

    Args:
      f_model: the residual, a tensor (E = 1) or a tuple of E
        single-column equations (the lowering to the tape gates it).
      requests: canonical multi-indices the residual needs.
      layer_shapes: ``[(in, out), ...]`` static layer dims.
      device: where the caller means to run; ``"cuda"`` (the default)
        raises :class:`~..utils.CudaUnavailableError` without a card.  The
        returned function dispatches on each call's tensors.

    Raises :class:`ValueError` (a
    :class:`~.residual_tape.MinimaxLoweringError` when the ``f_model``
    does not lower to the kernel's residual tape) when the step cannot be
    built.  ``layers`` is ``[(W, b), ...]``, ``w`` the ``[N, E]`` weight
    block.  ``sq_fn.n_equations`` is E, ``sq_fn.plan`` the kernel's
    :class:`~.cuda_minimax.MinimaxPlan`, and ``sq_fn.plain(flat, w, X)``
    the plain flavor's ``(value, [dW_0, db_0, ...], gw, gX)`` on any
    device (biases as ``[1, fan_out]``)."""
    resolve_device(device)
    mis = _sorted_mis(requests)
    ndim = len(varnames)
    # the lowering rejects any equation that is not one value per point and
    # counts the equations: E is the tape's
    tape = lower_residual(f_model, varnames, n_out, channel_order(requests))
    plan = MinimaxPlan(set(map(canonical, requests)), layer_shapes, tape)

    def tile_sq(layers, w, x):
        table = taylor_derivatives(list(layers), x, set(mis),
                                   flat_matmul=True)
        coords = tuple(x[:, i] for i in range(ndim))
        u = SymbolicUFn(_TableEngine(coords, table), varnames, n_out)
        out = f_model(u, *coords)
        parts = out if isinstance(out, tuple) else (out,)
        cols = [torch.reshape(p, (x.shape[0], -1)) for p in parts]
        stacked = cols[0] if len(cols) == 1 else torch.cat(cols, 1)
        return torch.sum(w * torch.square(stacked))

    def plain(flat, w, X):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in flat]
            wl = w.detach().requires_grad_(True)
            Xl = X.detach().requires_grad_(True)
            val = tile_sq(list(zip(leaves[0::2], leaves[1::2])), wl, Xl)
            # a residual that never reads the primal leaves the head's bias
            # out of the graph: its cotangent is zero, as in JAX
            grads = torch.autograd.grad(val, leaves + [wl, Xl],
                                        materialize_grads=True)
        return val.detach(), list(grads[:-2]), grads[-2], grads[-1]

    def kernel(flat, w, X):
        val, dflat, gw, gX = k3_minimax(plan, X, w, plan.pack(flat))
        return (val, [g.view_as(t) for g, t in zip(plan.unpack(dflat), flat)],
                gw, gX)

    def value_and_grads(flat, w, X):
        return plain(flat, w, X) if X.device.type == "cpu" \
            else kernel(flat, w, X)

    def sq_fn(layers, w, X):
        # biases as [1, fan_out] outside the Function, so their reshape is
        # transposed by ordinary autograd
        flat = [a if a.ndim == 2 else a.reshape(1, -1)
                for pair in layers for a in pair]
        return _MinimaxSq.apply(value_and_grads, w.contiguous(),
                                X.contiguous(), *flat)

    sq_fn.n_equations = plan.E
    sq_fn.plan = plan
    sq_fn.plain = plain
    return sq_fn


def make_minimax_residual_loss(sq_fn: Callable,
                               weight_outside_sum: bool = False,
                               g=None) -> Callable:
    """Wrap a :func:`build_minimax_sq_fn` unit as the solver's residual
    loss term ``residual_loss(params, lam_res, X) -> scalar``, with
    :func:`~..models.assembly.build_loss_fn`'s λ semantics per equation
    (``lam_res`` holds one entry per residual equation, ``None`` for a
    non-adaptive one):

    * no λ             → ``mean(f²)``      (``w = 1``)
    * per-point type-1 → ``mean((λ·f)²)``  (``w = λ²``)
    * ``g`` transform  → ``mean(g(λ)·f²)`` (``w = g(λ)``)
    * scalar type-2    → ``λ·mean(f²)``    (E = 1: an outer multiply;
      systems: λ folds linearly into its equation's weight channel)
    """
    n_eq = int(getattr(sq_fn, "n_equations", 1))

    def _weight_column(lam, N, X):
        """One equation's ``[N, 1]`` weights and an optional outer
        scalar."""
        if lam is None:
            return torch.ones((N, 1), dtype=X.dtype, device=X.device), None
        if g is not None:
            return torch.broadcast_to(torch.reshape(g(lam), (-1, 1)),
                                      (N, 1)), None
        if weight_outside_sum:
            return (torch.ones((N, 1), dtype=X.dtype, device=X.device),
                    torch.reshape(lam, ()))
        lam2 = torch.broadcast_to(torch.reshape(lam, (-1, 1)), (N, 1))
        return lam2 * lam2, None

    def residual_loss(params, lam_res, X):
        layers = extract_mlp_layers(params)
        if layers is None:
            raise ValueError(
                "minimax residual loss requires the standard MLP parameters "
                "[(W, b), ...]")
        N = X.shape[0]
        if n_eq == 1:
            lam = lam_res[0] if len(lam_res) > 0 else None
            w, outer = _weight_column(lam, N, X)
            loss = sq_fn(layers, w, X) / N
            return loss if outer is None else outer * loss
        cols = []
        for e in range(n_eq):
            lam = lam_res[e] if e < len(lam_res) else None
            w_e, outer_e = _weight_column(lam, N, X)
            if outer_e is not None:
                # λ_e·mean(f_e²) is linear in λ_e: fold it into the
                # channel, since one fused reduction covers every equation
                w_e = w_e * outer_e
            cols.append(w_e)
        return sq_fn(layers, torch.cat(cols, 1), X) / N

    return residual_loss
