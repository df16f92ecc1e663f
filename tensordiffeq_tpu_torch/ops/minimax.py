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

``compute_dtype=torch.bfloat16`` builds the mixed-precision flavor of the
JAX package's ``build_minimax_sq_fn(compute_dtype=jnp.bfloat16)``: the plain
flavor over ``taylor_derivatives(compute_dtype=torch.bfloat16)`` on the CPU,
K3's bf16-operand flavor (:func:`~.cuda_minimax.k3_minimax_bf16`) on the
card.  The network's ``precision=`` picks K3's flavor on the card
(:func:`~..utils.resolve_flavor`): ``"default"`` the single-pass TF32 one
(:func:`~.cuda_minimax.k3_minimax_tf32`), ``"high"``/``"highest"`` the
3xTF32 one; the plain flavor computes IEEE float32 on the CPU at every
precision, and ``plain(..., emulate_tf32=True)`` is the TF32 flavor's
referee.

The λ modes map onto the ``w`` channels as in the JAX package
(:func:`make_minimax_residual_loss`); their chain rule composes by
ordinary autograd outside the fused unit.

:func:`build_family_sq_fn` is the unit over a member axis (the JAX
package vmaps its XLA flavor over a factory's members): each member's own
lowered tape, one K3 launch per group of members whose tapes share their
ops on the card (:func:`~.cuda_minimax.k3_minimax_family`), each member's
plain flavor stacked on the CPU.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils import resolve_compute_dtype, resolve_device, resolve_flavor
from .cuda_minimax import FAMILY_FLAVORS, FLAVORS, MinimaxPlan
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
    scalar (the JAX package's ``sq_bwd``).  Over a member axis
    (:func:`build_family_sq_fn`) the value is ``[M]`` and each member's
    cotangents are scaled by its entry of the incoming ``[M]``."""

    @staticmethod
    def forward(ctx, value_and_grads, w, X, *flat):
        val, gflat, gw, gX = value_and_grads(flat, w, X)
        ctx.save_for_backward(gw, gX, *gflat)
        return val

    @staticmethod
    def backward(ctx, g):
        gw, gX, *gflat = ctx.saved_tensors
        need = ctx.needs_input_grad
        return (None, *(t * g.reshape(g.shape + (1,) * (t.ndim - g.ndim))
                        if n else None
                        for t, n in zip([gw, gX, *gflat], need[1:])))


def build_minimax_sq_fn(f_model: Callable, varnames: Sequence[str],
                        n_out: int, requests: set,
                        layer_shapes: Sequence[tuple],
                        device="cuda", compute_dtype=None,
                        precision="highest") -> Callable:
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
      compute_dtype: ``None`` or ``"bfloat16"``/``torch.bfloat16``: the
        flavor (module docstring).
      precision: the network's; ``"default"`` takes K3's TF32 flavor on the
        card (module docstring).  A bf16 ``compute_dtype`` overrides it.

    Raises :class:`ValueError` (a
    :class:`~.residual_tape.MinimaxLoweringError` when the ``f_model``
    does not lower to the kernel's residual tape) when the step cannot be
    built.  ``layers`` is ``[(W, b), ...]``, ``w`` the ``[N, E]`` weight
    block.  ``sq_fn.n_equations`` is E, ``sq_fn.plan`` the kernel's
    :class:`~.cuda_minimax.MinimaxPlan`, and ``sq_fn.plain(flat, w, X)``
    the plain flavor's ``(value, [dW_0, db_0, ...], gw, gX)`` on any
    device (biases as ``[1, fan_out]``; ``emulate_tf32=True``: the TF32
    flavor's referee); ``sq_fn.value_and_grads(flat, w, X)`` the same from
    the flavor the tensors' device takes (one K3 launch for CUDA tensors),
    outside autograd.  ``sq_fn.compute_dtype`` is the mixed-precision
    dtype, ``sq_fn.flavor`` the kernel's flavor key."""
    resolve_device(device)
    dtype = resolve_compute_dtype(compute_dtype)
    flavor = resolve_flavor(dtype, precision)
    mis = _sorted_mis(requests)
    ndim = len(varnames)
    # the lowering rejects any equation that is not one value per point and
    # counts the equations: E is the tape's
    tape = lower_residual(f_model, varnames, n_out, channel_order(requests))
    plan = MinimaxPlan(set(map(canonical, requests)), layer_shapes, tape)

    def tile_sq(layers, w, x, emulate_tf32=False):
        table = taylor_derivatives(list(layers), x, set(mis),
                                   flat_matmul=True, compute_dtype=dtype,
                                   emulate_tf32=emulate_tf32)
        coords = tuple(x[:, i] for i in range(ndim))
        u = SymbolicUFn(_TableEngine(coords, table), varnames, n_out)
        out = f_model(u, *coords)
        parts = out if isinstance(out, tuple) else (out,)
        cols = [torch.reshape(p, (x.shape[0], -1)) for p in parts]
        stacked = cols[0] if len(cols) == 1 else torch.cat(cols, 1)
        return torch.sum(w * torch.square(stacked))

    def plain(flat, w, X, emulate_tf32=False):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in flat]
            wl = w.detach().requires_grad_(True)
            Xl = X.detach().requires_grad_(True)
            val = tile_sq(list(zip(leaves[0::2], leaves[1::2])), wl, Xl,
                          emulate_tf32)
            # a residual that never reads the primal leaves the head's bias
            # out of the graph: its cotangent is zero, as in JAX
            grads = torch.autograd.grad(val, leaves + [wl, Xl],
                                        materialize_grads=True)
        return val.detach(), list(grads[:-2]), grads[-2], grads[-1]

    def kernel(flat, w, X):
        val, dflat, gw, gX = FLAVORS[flavor](plan, X, w, plan.pack(flat))
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
    sq_fn.compute_dtype = dtype
    sq_fn.flavor = flavor
    sq_fn.plan = plan
    sq_fn.plain = plain
    sq_fn.value_and_grads = value_and_grads
    return sq_fn


def tape_groups(sqs: Sequence[Callable]) -> list:
    """The members of :func:`build_minimax_sq_fn` functions ``sqs`` grouped
    by their tapes' ops (``ResidualTape.encode()``'s ints), in order of
    first appearance: one member-axis K3 launch runs a group, each member
    with its own constants.  A member whose lowering folded its θ otherwise
    (a θ equal to another constant of its residual shares that constant's
    slot) lands in a group of its own."""
    groups = {}
    for m, sq in enumerate(sqs):
        groups.setdefault(tuple(sq.plan.tape.encode()[0]), []).append(m)
    return list(groups.values())


def build_family_sq_fn(sqs: Sequence[Callable], device="cuda") -> Callable:
    """``fam(layers, w, X) -> values [M]``: :func:`build_minimax_sq_fn`'s
    ``sq_fn`` over a member axis, member ``m`` through ``sqs[m]`` (its own
    lowered tape) on its slice of the stacked ``layers`` (``[(W [M, in,
    out], b [M, out]), ...]``), ``w [M, N, E]`` and ``X [M, N, d]``.

    CPU tensors take the plain flavor, each member's ``sq.plain`` on its
    slice, stacked.  CUDA tensors launch K3 over the member axis
    (:func:`~.cuda_minimax.k3_minimax_family` in ``sqs``' flavor) once per
    tape group (:func:`tape_groups`), on the stacked tensors when there is
    one group; each member's outputs are its single launch's bit for bit.
    Off the wgmma route's shapes (hidden widths past 256, or past 128 in
    the bf16 flavor; more than 8 channels) there is no member-axis kernel and each member's K3 launches
    on its own, as :func:`build_minimax_sq_fn`'s would.
    ``fam.k3_routes[flavor]`` records which ran (``"wgmma"``: member-axis
    launches; ``"mma"``: one per member).

    ``fam.plain(flat, w, X)`` / ``fam.value_and_grads(flat, w, X)`` return
    ``(values [M], [dW_0, db_0, ...] stacked, gw [M, N, E], gX [M, N,
    d])`` (biases as ``[M, 1, fan_out]``); ``fam.groups`` lists the tape
    groups' members, ``fam.constants`` each group's constant table
    ``[M_group, MAX_TAPE_CONSTS]``.  ``device="cuda"`` (the default)
    raises :class:`~..utils.CudaUnavailableError` without a card; on a
    card the tables and the groups' member indices are put there at build,
    so a captured step copies nothing from the host."""
    device = resolve_device(device)
    sqs = list(sqs)
    if not sqs:
        raise ValueError("a member axis needs at least one member")
    sq0 = sqs[0]
    plan0 = sq0.plan
    for sq in sqs[1:]:
        if (sq.flavor != sq0.flavor or sq.plan.layer_shapes
                != plan0.layer_shapes or sq.plan.channels != plan0.channels
                or sq.plan.E != plan0.E):
            raise ValueError("the members' minimax steps must share the "
                             "architecture, the request set, the equation "
                             "count and the flavor")
    flavor = sq0.flavor
    groups = tape_groups(sqs)
    constants = [torch.tensor([sqs[m].plan.tape.encode()[1] for m in g],
                              dtype=torch.float32) for g in groups]
    on_card = {}  # device -> (constant tables, member indices)

    def placed(dev):
        if dev not in on_card:
            on_card[dev] = ([c.to(dev) for c in constants],
                            [torch.tensor(g, device=dev) for g in groups])
        return on_card[dev]

    if device.type == "cuda":
        placed(device)

    def stacked(outs):
        """Each member's ``(value, leaves, gw, gX)`` stacked on the member
        axis."""
        return (torch.stack([o[0] for o in outs]),
                [torch.stack(leaf) for leaf in zip(*[o[1] for o in outs])],
                torch.stack([o[2] for o in outs]),
                torch.stack([o[3] for o in outs]))

    def plain(flat, w, X, emulate_tf32=False):
        return stacked([sq.plain([t[m] for t in flat], w[m], X[m],
                                 emulate_tf32)
                        for m, sq in enumerate(sqs)])

    def unpack(dflat, flat):
        # each leaf's columns of the members' packed cotangents, as views
        out = []
        for (fi, fo), (ow, ob) in zip(plan0.layer_shapes, plan0.offsets):
            out += [dflat[:, ow:ow + fi * fo], dflat[:, ob:ob + fo]]
        return [g.view(t.shape) for g, t in zip(out, flat)]

    def kernel(flat, w, X):
        M, N = int(X.shape[0]), int(X.shape[1])
        if plan0.wb_route(X.device, flavor, N, "k3") is None:
            fam.k3_routes[flavor] = "mma"
            return stacked([sq.value_and_grads([t[m] for t in flat], w[m],
                                               X[m])
                            for m, sq in enumerate(sqs)])
        fam.k3_routes[flavor] = "wgmma"
        launch = FAMILY_FLAVORS[flavor]
        packed = torch.cat([t.reshape(M, -1) for t in flat], 1)
        tables, index = placed(X.device)
        if len(groups) == 1:
            val, dflat, gw, gX = launch(plan0, X, w, packed, tables[0])
            return val, unpack(dflat, flat), gw, gX
        val = torch.empty((M,), dtype=X.dtype, device=X.device)
        dflat = torch.empty((M, plan0.P_total), dtype=X.dtype,
                            device=X.device)
        gw, gX = torch.empty_like(w), torch.empty_like(X)
        for g, table, idx in zip(groups, tables, index):
            got = launch(sqs[g[0]].plan, X.index_select(0, idx),
                         w.index_select(0, idx), packed.index_select(0, idx),
                         table)
            for dst, src in zip((val, dflat, gw, gX), got):
                dst.index_copy_(0, idx, src)
        return val, unpack(dflat, flat), gw, gX

    def value_and_grads(flat, w, X):
        return plain(flat, w, X) if X.device.type == "cpu" \
            else kernel(flat, w, X)

    def fam(layers, w, X):
        # biases as [M, 1, fan_out] outside the Function, as sq_fn's
        flat = [a if a.ndim == 3 else a.reshape(a.shape[0], 1, -1)
                for pair in layers for a in pair]
        return _MinimaxSq.apply(value_and_grads, w.contiguous(),
                                X.contiguous(), *flat)

    fam.n_equations = plan0.E
    fam.compute_dtype = sq0.compute_dtype
    fam.flavor = flavor
    fam.members = sqs
    fam.groups = groups
    fam.constants = constants
    fam.k3_routes = {}
    fam.plain = plain
    fam.value_and_grads = value_and_grads
    return fam


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

    A :func:`build_family_sq_fn` unit takes a member axis: ``X [M, N,
    d]``, the stacked parameters (``[W [M, in, out], b [M, out], ...]``)
    and each λ stacked on the member axis; the term is then ``[M]``, each
    member's entry its single-network term."""
    n_eq = int(getattr(sq_fn, "n_equations", 1))

    def _weight_column(lam, X):
        """One equation's ``[..., N, 1]`` weights (``...``: X's member axis,
        if any) and an optional outer scalar per member."""
        lead, N = tuple(X.shape[:-2]), X.shape[-2]
        col = lead + (N, 1)
        if lam is None:
            return torch.ones(col, dtype=X.dtype, device=X.device), None
        if g is not None:
            return torch.broadcast_to(torch.reshape(g(lam), lead + (-1, 1)),
                                      col), None
        if weight_outside_sum:
            return (torch.ones(col, dtype=X.dtype, device=X.device),
                    torch.reshape(lam, lead))
        lam2 = torch.broadcast_to(torch.reshape(lam, lead + (-1, 1)), col)
        return lam2 * lam2, None

    def residual_loss(params, lam_res, X):
        flat = list(params) if X.ndim == 3 else None
        layers = (extract_mlp_layers(params) if flat is None else
                  list(zip(flat[0::2], flat[1::2]))
                  if len(flat) % 2 == 0 and all(W.ndim == 3
                                                for W in flat[0::2])
                  else None)
        if layers is None:
            raise ValueError(
                "minimax residual loss requires the standard MLP parameters "
                "(its flat list, or [(W, b), ...]; over a member axis the "
                "stacked leaves [W [M, in, out], b [M, out], ...])")
        N = X.shape[-2]
        if n_eq == 1:
            lam = lam_res[0] if len(lam_res) > 0 else None
            w, outer = _weight_column(lam, X)
            loss = sq_fn(layers, w, X) / N
            return loss if outer is None else outer * loss
        cols = []
        for e in range(n_eq):
            lam = lam_res[e] if e < len(lam_res) else None
            w_e, outer_e = _weight_column(lam, X)
            if outer_e is not None:
                # λ_e·mean(f_e²) is linear in λ_e: fold it into the
                # channel, since one fused reduction covers every equation
                w_e = w_e * outer_e.reshape(outer_e.shape + (1, 1))
            cols.append(w_e)
        return sq_fn(layers, torch.cat(cols, -1), X) / N

    return residual_loss
