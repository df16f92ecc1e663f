"""The surrogate factory: a parametric family of PINNs trained as one
captured step.

Counterpart of the JAX package's ``factory/family.py``.  Users sweep a PDE
coefficient θ and train one small PINN per value; one such network
underfills a card, so the factory trains the whole family together:

* every member's network parameters, SA λ, Adam moments and collocation
  set are stacked on a leading **member axis** (``W [M, in, out]``, ``λ
  [M, N, 1]``, ``X_f [M, N, d]``); a non-adaptive λ slot stays ``None``;
* the loss engine is the one the **template solver** adopted: a
  :class:`~..models.CollocationSolverND` compiled with member 0's θ baked
  in, behind its own gates and cross-checks.  On the minimax step the
  members' residual terms are one call on the stacked tensors
  (:func:`~..ops.minimax.build_family_sq_fn`): one K3 launch over the
  member axis per tape group (a group shares its tape's ops, each member
  its own constants), each member's outputs bit for bit its own launch's,
  as JAX vmaps its XLA flavor over the member axis with θ traced.  On the
  fused engine (K1 and K2 under ``fused="cuda"``; the plain table
  otherwise) and the generic engine (autograd) each member's term goes
  through the engine with its θ bound, one call per member on its slice.
  The plain flavor never runs on a CUDA tensor: it is the kernels'
  referee.
* K3's tape is data, so a member's θ is another constant of its pool.
  Each member's ``f_model`` is lowered on its own at build
  (:mod:`..ops.residual_tape`): the lowering folds and pools constants
  (θ² computed in Python, θ equal to another constant of the residual,
  θ as a divisor) in ways that no record of "the slot that holds θ" would
  survive, and a lowering costs milliseconds, once.  A θ that is not a
  scalar does not lower; the template then declines the minimax step for
  member 0's θ and the family keeps the engine it adopted instead, as the
  solo solver does;
* the BC terms run once for the whole family on the stacked tensors
  (``torch.func.vmap`` of the template's BC terms over the member axis),
  and so do Adam (descent on the parameters, ascent on λ: two
  ``torch.optim.Adam`` over the stacked leaves, elementwise, so each
  member's update is its own) and the per-member gradient norms;
* the members' losses are summed before one backward pass: a member's
  gradient depends only on its own loss, so a member that goes NaN cannot
  reach another.  A member whose loss or gradient norm is non-finite is
  frozen by a ``torch.where`` on a device alive-mask inside the step (its
  parameters, λ and moments keep their values), with no host read;
  ``frozen_at`` records the global epoch of the trip, and
  :class:`~..telemetry.TrainingDiverged` is raised only when every member
  has frozen.

The step is the solver's own :class:`~..training.fit.AdamStep` with a
member axis, run by :func:`~..training.fit.fit_adam`: one CUDA graph
captured for the family step and replayed in chunks, one host read of the
chunk's history per chunk, the redraws pipelined and the resilience
boundary at each chunk boundary, as for a solo solver.

A **1-member family** is the solo solver: it trains the template's own
state through the solver's own ``fit`` (its ``AdamStep``, K3 included),
so its fit is bit for bit ``CollocationSolverND(seed=seed).fit``, and its
redraws are the solo solver's.

``dist=``: over ``torch.distributed`` each rank owns ``M / world`` whole
members (contiguous blocks) and trains them with no collective inside the
step; the chunk's history is gathered at its boundary, so every rank holds
the family's rows.  The checkpoint is sharded by member block
(:class:`~..checkpoint.RowBlock`) and restores at another world size.

``export_family`` writes every live member as a v2 fleet artifact
(:func:`~..fleet.export_fleet_artifact`: the ladder spec and the member's
residual lowered to its tape, so a replica serves it with no ``f_model``)
and a ``family_manifest.json`` that :meth:`~..fleet.FleetRouter.
register_family` loads; frozen members are skipped and recorded.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.assembly import build_loss_fn
from ..models.collocation import CollocationSolverND
from ..networks import MLP, as_layers, init_generator
from ..telemetry import as_training_telemetry, log_event
from ..training.fit import AdamStep, fit_adam, init_adam_state, make_optimizer
from ..utils import device_scalar, resolve_device

#: the family manifest's file name (written by ``export_family``, read by
#: ``fleet.FleetRouter.register_family``)
FAMILY_MANIFEST = "family_manifest.json"


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nests of dicts and lists/tuples;
    ``None`` leaves stay ``None`` (and must be ``None`` in every tree)."""
    t0 = trees[0]
    if t0 is None:
        if any(t is not None for t in trees):
            raise ValueError("members disagree on which λ terms are "
                             "adaptive; the family must share one adaptive "
                             "configuration")
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_members(trees: Sequence):
    """Stack identically structured nests of tensors along a new leading
    member axis (``None`` leaves stay ``None``: shared, non-adaptive λ)."""
    return _tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                              for x in xs]), *trees)


def member_slice(tree, m: int):
    """Member ``m``'s slice of a member-stacked nest (``None`` leaves pass
    through)."""
    return _tree_map(lambda a: a[m], tree)


def _as_theta(theta, device):
    """A member's θ as its residual sees it: a scalar as the Python float
    of its float32 value (the JAX package casts θ to float32), so that the
    residual tape pools it as a constant; anything else a float32 tensor
    on the device."""
    if np.ndim(theta) == 0:
        return float(np.float32(theta))
    return torch.as_tensor(np.asarray(theta, np.float32), device=device)


def _bind(f_model: Callable, theta) -> Callable:
    return lambda u, *coords: f_model(u, *coords, theta)


def _moments(opts) -> list:
    """``(param, exp_avg, exp_avg_sq)`` of every leaf of an Adam pair."""
    out = []
    for opt in opts:
        if opt is None:
            continue
        for p in opt.param_groups[0]["params"]:
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out.append((p, st["exp_avg"], st["exp_avg_sq"]))
    return out


class SurrogateFactory:
    """Train a parametric family of PINN surrogates as one captured step.

    Args:
      layer_sizes: the members' MLP sizes (one architecture: the member
        axis stacks parameters, not programs).
      f_model: the family residual ``f_model(u, *coords, theta)``, the
        solver's signature with the member's θ appended (a scalar, or an
        array: then the minimax step is declined, module docstring).
      domain / bcs: the shared geometry; every member starts from the
        domain's collocation draw (per-member redraws diverge them).
      thetas: ``M`` values of θ, one per member.
      Adaptive_type / dict_adaptive / init_weights / g: the solver's SA
        contract, applied per member (each trains its own λ).  NTK
        weighting (type 3) is refused, as in the JAX package.
      dist: ``torch.distributed`` over the member axis (module
        docstring): ``True`` every rank of the group, an ``int`` the first
        that many, a sequence those ranks.  ``M`` must divide evenly.
      lr / lr_weights: the Adam rates of the parameters and of λ.
      fused / minimax: forwarded to the template solver (member 0's θ);
        the engine it adopts is the family's (:attr:`engine`).
      seed: member ``m`` initialises its network from ``seed + m``, so
        ``CollocationSolverND(seed=seed + m)`` is its solo reference.
      init_params: ``M`` entries of member parameters (``[(W, b), ...]``
        or the flat list; ``None`` for the seeded draw) that replace the
        draw: a warm start; each must match the architecture's shapes.
      device: ``"cuda"`` (the default) raises
        :class:`~..utils.CudaUnavailableError` without a card; pass
        ``"cpu"`` to run on the CPU.

    At build, member 0's value and gradients through the family step are
    held to the template solver's loss, and every member's residual term
    (its own lowered tape or fused residual) to the generic engine's with
    its θ (32 points, rtol 5e-3; the bf16 bands under ``fused_dtype``).
    """

    def __init__(self, layer_sizes: Sequence[int], f_model: Callable,
                 domain, bcs: Sequence, thetas: Sequence,
                 Adaptive_type: int = 0, dict_adaptive: Optional[dict] = None,
                 init_weights: Optional[dict] = None,
                 g: Optional[Callable] = None, dist=False,
                 lr: float = 0.005, lr_weights: float = 0.005,
                 fused=None, minimax: Optional[bool] = None, seed: int = 0,
                 init_params: Optional[Sequence] = None,
                 verbose: bool = True, device="cuda"):
        if len(thetas) < 1:
            raise ValueError("a family needs at least one member "
                             "(thetas is empty)")
        if init_params is not None and len(init_params) != len(thetas):
            raise ValueError(
                f"init_params has {len(init_params)} entries for "
                f"{len(thetas)} members; pass one per member (None for a "
                "fresh seeded init)")
        if Adaptive_type == 3:
            raise ValueError(
                "NTK weighting (Adaptive_type=3) recomputes λ between chunks "
                "on the host and is not supported on the family path; use "
                "0, 1 or 2")
        M = self.n_members = len(thetas)
        if dist:
            from ..parallel import process_count
            world = (process_count() if dist is True else
                     int(dist) if isinstance(dist, (int, np.integer))
                     else len(dist))
            if M % world:
                raise ValueError(
                    f"n_members={M} must divide evenly over the {world} "
                    "ranks (each rank owns M/world members)")
        self.device = resolve_device(device)
        self.member_thetas = [_as_theta(t, self.device) for t in thetas]
        self.thetas = np.stack([np.asarray(t, np.float32) for t in thetas])
        self.f_model = f_model
        self.seed = int(seed)
        self.verbose = verbose
        self.lr, self.lr_weights = lr, lr_weights
        self.domain = domain
        self.layer_sizes = [int(s) for s in layer_sizes]
        self.Adaptive_type = Adaptive_type

        # the template: member 0's θ baked in; its adoption (fused table,
        # minimax step, each behind its cross-check), λ semantics and loss
        # assembly are the family's
        tpl = CollocationSolverND(verbose=False, seed=self.seed,
                                  device=self.device)
        tpl.compile(list(layer_sizes), _bind(f_model, self.member_thetas[0]),
                    domain, list(bcs), Adaptive_type=Adaptive_type,
                    dict_adaptive=dict_adaptive, init_weights=init_weights,
                    g=g, lr=lr, lr_weights=lr_weights, fused=fused,
                    minimax=minimax)
        self._template = tpl
        self.engine = ("fused-minimax" if tpl._minimax_kind is not None
                       else "fused" if tpl._fused_residual is not None
                       else "generic")
        self.net = tpl.net
        self.apply_fn = tpl.apply_fn
        self.n_out = tpl.n_out
        self.varnames = tuple(domain.vars)

        self.mesh = None
        self._members = list(range(M))
        if dist:
            from ..parallel import resolve_mesh
            self.mesh = resolve_mesh(dist, device=self.device)
            k = M // self.mesh.size
            self._members = list(range(self.mesh.rank * k,
                                       (self.mesh.rank + 1) * k))
        self.losses: list = []
        self.frozen_at: dict = {}
        self.redraws: list = []
        self._init_params = init_params
        self._step = None
        self._single = M == 1
        if self._single:
            if init_params is not None and init_params[0] is not None:
                tpl.net.load_params(self._member_init(0))
            self._opt = None
            self._bind_single_views()
        else:
            self._init_stacked()
            self._build_member_fns()
            ok, why = self._crosscheck_family()
            if not ok:
                raise ValueError(
                    "the family step disagrees with the template solver's "
                    "loss on member 0: the member loss with θ bound is "
                    "broken") from why
            m, why = self._crosscheck_members()
            if m is not None:
                raise ValueError(
                    f"member {m}'s residual term disagrees with the generic "
                    "engine's with its θ: its lowering is broken") from why
        log_event("factory", f"family of {M} compiled ({self.engine} "
                  "engine, " + ("member-sharded over "
                                f"{self.mesh.size} ranks"
                                if self.mesh is not None else "one process")
                  + ")", verbose=self.verbose, members=M, engine=self.engine)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #
    def _member_init(self, m: int) -> list:
        """Member ``m``'s initial flat parameter list: its ``init_params``
        entry (validated against the architecture) or the draw from
        ``seed + m``."""
        fresh = MLP(self.layer_sizes, device=self.device,
                    generator=init_generator(self.seed + m)).params()
        fresh = [t.detach() for t in fresh]
        given = None if self._init_params is None else self._init_params[m]
        if given is None:
            return fresh
        try:
            leaves = [t for pair in as_layers(given) for t in pair]
        except (TypeError, ValueError) as e:
            raise ValueError(f"init_params[{m}] is not a parameter list of "
                             "this MLP") from e
        if len(leaves) != len(fresh):
            raise ValueError(
                f"init_params[{m}] has {len(leaves)} leaves; the "
                f"architecture has {len(fresh)}")
        out = []
        for t, f in zip(leaves, fresh):
            t = torch.as_tensor(np.asarray(
                t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                np.float32), device=self.device)
            if tuple(t.shape) != tuple(f.shape):
                raise ValueError(
                    f"init_params[{m}] leaf shape {tuple(t.shape)} does not "
                    f"match the architecture's {tuple(f.shape)}")
            out.append(t)
        return out

    def _init_stacked(self):
        """The stacked state of this process's members (M > 1)."""
        tpl, dev = self._template, self.device
        members = [self._member_init(m) for m in self._members]
        k = len(self._members)
        self.params = [torch.stack([mp[i] for mp in members])
                       .requires_grad_(True) for i in range(len(members[0]))]
        self.lambdas = {
            key: [None if lam is None else
                  lam.detach()[None].expand((k,) + tuple(lam.shape))
                  .clone().requires_grad_(True)
                  for lam in tpl.lambdas.get(key, [])]
            for key in ("residual", "BCs")}
        self.X_f = tpl.X_f.detach()[None].expand(
            (k,) + tuple(tpl.X_f.shape)).clone()
        self.alive = torch.ones(k, dtype=torch.bool, device=dev)
        self.best_params = [p.detach().clone() for p in self.params]
        self.best_loss = torch.full((k,), float("inf"), device=dev)
        self.best_step = torch.full((k,), -1, dtype=torch.long, device=dev)
        self._opt = make_optimizer(self.params, self.lambdas, self.lr,
                                   self.lr_weights)

    def _bind_single_views(self):
        """A 1-member family's stacked attributes: views of the template's
        live tensors with a member axis of 1 (writes reach the solver)."""
        tpl = self._template
        self.params = [p.detach().unsqueeze(0) for p in tpl.net.params()]
        self.lambdas = {
            key: [None if lam is None else lam.detach().unsqueeze(0)
                  for lam in tpl.lambdas.get(key, [])]
            for key in ("residual", "BCs")}
        self.X_f = tpl.X_f.unsqueeze(0)
        self.alive = torch.ones(1, dtype=torch.bool, device=self.device)

    # ------------------------------------------------------------------ #
    # the member engine
    # ------------------------------------------------------------------ #
    def _member_fns(self, theta):
        """``(term, residual, sq)`` of one member: its residual term through
        the template's engine with ``theta`` bound (a loss over no BC,
        :func:`~..models.assembly.build_loss_fn`), its batched residual (the
        redraws' scores) and, on the minimax step, its K3 function
        (:func:`~..ops.minimax.build_minimax_sq_fn`, ``None`` off that
        step)."""
        from ..ops import minimax as mmx
        from ..ops.derivatives import make_ufn, vmap_residual
        from ..ops.fused import make_fused_residual

        tpl = self._template
        f_m = _bind(self.f_model, theta)
        names, n_out = self.varnames, self.n_out
        kw = dict(weight_outside_sum=tpl.weight_outside_sum, g=tpl.g,
                  device=self.device)
        residual = None
        if tpl._fused_residual is not None:
            residual = make_fused_residual(
                f_m, names, n_out, tpl._fuse_requests,
                table_producer=self._table_producer,
                compute_dtype=tpl.fused_dtype, precision=tpl.precision)
        sq = None
        if self.engine == "fused-minimax":
            sq = mmx.build_minimax_sq_fn(
                f_m, names, n_out, tpl._fuse_requests,
                [tuple(W.shape) for W, _ in tpl.net.layers()],
                device=self.device, compute_dtype=tpl.fused_dtype,
                precision=tpl.precision)
            mm = mmx.make_minimax_residual_loss(
                sq, weight_outside_sum=tpl.weight_outside_sum, g=tpl.g)
            term = build_loss_fn(self.apply_fn, names, n_out, f_m, [],
                                 residual_loss_fn=mm, **kw)
        else:
            term = build_loss_fn(self.apply_fn, names, n_out, f_m, [],
                                 residual_fn=residual, **kw)
        if residual is None:
            ndim = len(names)

            def residual(params, X):
                u = make_ufn(self.apply_fn, params, names, n_out)
                return vmap_residual(f_m, u, ndim)(X)

        return term, residual, sq

    def _family_engine(self, sqs):
        """The minimax step over the member axis of ``sqs`` (the members'
        K3 functions): ``(residual, score_grad)``, the members' residual
        terms as one call returning ``[M]``
        (:func:`~..ops.minimax.make_minimax_residual_loss` over the
        member-axis unit, ``residual.family``) and their ``(scores [M, N],
        gX [M, N, d])`` at w ≡ 1 (the ascent mover); each one K3 launch
        over the member axis per tape group on the card."""
        from ..ops import minimax as mmx

        tpl = self._template
        fam = mmx.build_family_sq_fn(sqs, device=self.device)
        res = mmx.make_minimax_residual_loss(
            fam, weight_outside_sum=tpl.weight_outside_sum, g=tpl.g)
        n_eq = int(fam.n_equations)

        def score_grad(params, X):
            flat = [a if a.ndim == 3 else a.reshape(a.shape[0], 1, -1)
                    for a in params]
            w = torch.ones(tuple(X.shape[:2]) + (n_eq,), dtype=X.dtype,
                           device=X.device)
            _, _, gw, gX = fam.value_and_grads(flat, w, X.contiguous())
            return torch.sum(gw, 2), gX

        res.family = fam
        return res, score_grad

    def _build_member_fns(self):
        tpl = self._template
        self._table_producer = None
        if tpl._fused_residual is not None and tpl._fused_kind == "cuda":
            from ..ops.cuda_taylor import build_cuda_table_fn
            self._table_producer = build_cuda_table_fn(
                tpl._fuse_requests,
                [tuple(W.shape) for W, _ in tpl.net.layers()],
                device=self.device, compute_dtype=tpl.fused_dtype,
                precision=tpl.precision)
        fns = [self._member_fns(self.member_thetas[m]) for m in self._members]
        self._terms = [f[0] for f in fns]
        self._residuals = {m: f[1] for m, f in zip(self._members, fns)}
        self._member_sq = {m: f[2] for m, f in zip(self._members, fns)}
        # the minimax step: the members' terms as one member-axis call
        self._family_res = self._family_score_grad = None
        if self.engine == "fused-minimax":
            self._family_res, self._family_score_grad = self._family_engine(
                [self._member_sq[m] for m in self._members])
        # the BC terms of the template, vmapped over the member axis
        self._n_bc = len(tpl.bcs)
        self._bc_adaptive = [lam is not None for lam in tpl.lambdas["BCs"]]
        bc_loss = build_loss_fn(
            self.apply_fn, self.varnames, self.n_out, tpl.f_model, tpl.bcs,
            weight_outside_sum=tpl.weight_outside_sum, g=tpl.g,
            residual_loss_fn=lambda p, lam, X: 0.0, device=self.device)

        def bc_member(params, lams):
            it = iter(lams)
            lam_bcs = [next(it) if a else None for a in self._bc_adaptive]
            comps = bc_loss(params, lam_bcs, [], None)[1]
            return [comps[f"BC_{i}"] for i in range(self._n_bc)]

        self._bc_terms = torch.func.vmap(bc_member)

    def _family_loss(self, params, lam_bcs, lam_res, X, lam_data=None,
                     terms=None):
        """``(totals [M], components {name: [M]})`` of the members'
        losses (the member-axis step's ``loss_fn``; the family has no data
        term): the BC terms vmapped over the member axis, the residual
        terms (on the minimax step one member-axis call, ``terms`` then a
        :meth:`_family_engine` residual; else each member's term, ``terms``
        their list, through its own engine call on its slice), and each
        total summed in :func:`~..models.assembly.build_loss_fn`'s order
        (BC terms, then the residual terms)."""
        if terms is None:
            terms = (self._family_res if self._family_res is not None
                     else self._terms)
        comps = {}
        loss_bcs = 0.0
        if self._n_bc:
            bcs = self._bc_terms(list(params), [
                lam for lam in lam_bcs if lam is not None])
            for i, v in enumerate(bcs):
                comps[f"BC_{i}"] = v
                loss_bcs = loss_bcs + v
        if callable(terms):
            # the member-axis minimax step: build_loss_fn's lone residual
            # component, Residual_0, for every member at once
            res = terms(list(params), list(lam_res), X)
            comps["Residual_0"] = res.detach()
            totals = loss_bcs + res
            comps["Total Loss"] = totals
            return totals, comps
        Ps = [p.unbind(0) for p in params]
        Ls = [None if lam is None else lam.unbind(0) for lam in lam_res]
        Xs = X.unbind(0)
        rows = []
        for i, term in enumerate(terms):
            rows.append(term([P[i] for P in Ps], [],
                             [None if L is None else L[i] for L in Ls],
                             Xs[i])[1])
        dev = X.device
        for key in rows[0]:
            if key != "Total Loss":
                comps[key] = torch.stack([device_scalar(r[key], dev)
                                          for r in rows])
        # the totals keep their graph (device_scalar detaches)
        totals = loss_bcs + torch.stack([r["Total Loss"].reshape(())
                                         for r in rows])
        comps["Total Loss"] = totals
        return totals, comps

    def _family_value_and_grads(self, params, lambdas, X, terms=None):
        """The family loss and its gradients with respect to the stacked
        parameters and residual λ (copies that require grad): ``(totals,
        param grads, λ grads)``, each gradient stacked on the member
        axis."""
        ps = [p.detach().clone().requires_grad_(True) for p in params]
        lams = {key: [None if lam is None else
                      lam.detach().clone().requires_grad_(True)
                      for lam in vals] for key, vals in lambdas.items()}
        totals, _ = self._family_loss(ps, lams["BCs"], lams["residual"], X,
                                      terms=terms)
        res = [lam for lam in lams["residual"] if lam is not None]
        grads = torch.autograd.grad(torch.sum(totals), ps + res,
                                    materialize_grads=True)
        return totals.detach(), list(grads[:len(ps)]), list(grads[len(ps):])

    def _crosscheck_family(self, n_check: int = 32):
        """Member 0 (its parameters and θ) through the family step on a
        sample of the collocation set, value and gradients, against the
        template solver's loss: the solver's cross-check discipline on the
        member axis.  Returns ``(ok, reason)``."""
        from ..ops.fused import FusedMismatch, crosscheck_grads

        tpl = self._template
        n_f = int(tpl.X_f.shape[0])
        n_s = min(n_check, n_f)
        X_s = tpl.X_f[:n_s]

        def cut(lam):
            if lam is None:
                return None
            lam = lam.detach()
            return lam[:n_s] if lam.ndim >= 1 and lam.shape[0] == n_f \
                else lam

        lam_res = [cut(lam) for lam in tpl.lambdas["residual"]]
        lam_bcs = [None if lam is None else lam.detach()
                   for lam in tpl.lambdas["BCs"]]
        p0 = self._member_init(0)
        leaves = [t.clone().requires_grad_(True) for t in p0]
        res_leaves = [None if lam is None else lam.clone().requires_grad_(
            True) for lam in lam_res]
        v_t = tpl.loss_fn(leaves, lam_bcs, res_leaves, X_s)[0]
        want = torch.autograd.grad(
            v_t, leaves + [lam for lam in res_leaves if lam is not None],
            materialize_grads=True)
        fns0 = (None if self._members[0] == 0
                else self._member_fns(self.member_thetas[0]))
        if self._family_res is not None:
            # member 0 alone through the member-axis step
            term0 = self._family_engine(
                [self._member_sq[0] if fns0 is None else fns0[2]])[0]
        else:
            term0 = [self._terms[0] if fns0 is None else fns0[0]]
        try:
            totals, g_p, g_l = self._family_value_and_grads(
                [t[None] for t in p0],
                {"residual": [None if lam is None else lam[None]
                              for lam in lam_res],
                 "BCs": [None if lam is None else lam[None]
                         for lam in lam_bcs]},
                X_s[None], terms=term0)
        except Exception as e:  # noqa: BLE001 - the reason is reported
            return False, e
        v_f, v_t = float(totals[0]), float(v_t.detach())
        if not abs(v_f - v_t) <= 1e-5 + 5e-3 * abs(v_t):
            return False, FusedMismatch(
                f"family loss {v_f:.6e} disagrees with the template's "
                f"{v_t:.6e} on member 0")
        return crosscheck_grads(list(want), [g[0] for g in g_p + g_l])

    def _crosscheck_members(self, n_check: int = 32):
        """Each of this process's members' residual terms (its own lowered
        tape on the minimax step, its fused residual on the fused engine),
        value and gradients with respect to its parameters and λ, against
        the generic engine's term with its θ, on its parameters, λ and the
        first ``n_check`` rows of its collocation set: every lowering is
        checked, not only member 0's.  Returns ``(None, None)``, or the
        first member that disagrees and the reason."""
        from ..models.collocation import BF16_GRAD_BAND, BF16_VALUE_BAND
        from ..ops.fused import FusedMismatch, crosscheck_grads

        if self.engine == "generic":
            return None, None  # the member terms are the generic engine's
        tpl = self._template
        n_f = int(self.X_f.shape[1])
        n_s = min(n_check, n_f)
        bf16 = tpl.fused_dtype is not None
        rtol = BF16_VALUE_BAND["rtol"] if bf16 else 5e-3
        kw = dict(weight_outside_sum=tpl.weight_outside_sum, g=tpl.g,
                  device=self.device)

        def val_grad(term, i):
            ps = [p[i].detach().clone().requires_grad_(True)
                  for p in self.params]
            lams = [None if lam is None else
                    (lam[i, :n_s] if lam.ndim >= 2 and lam.shape[1] == n_f
                     else lam[i]).detach().clone().requires_grad_(True)
                    for lam in self.lambdas["residual"]]
            val = term(ps, [], lams, self.X_f[i, :n_s])[0]
            leaves = ps + [lam for lam in lams if lam is not None]
            return float(val.detach()), torch.autograd.grad(
                val, leaves, materialize_grads=True)

        for i, m in enumerate(self._members):
            gen = build_loss_fn(self.apply_fn, self.varnames, self.n_out,
                                _bind(self.f_model, self.member_thetas[m]),
                                [], **kw)
            try:
                v_m, g_m = val_grad(self._terms[i], i)
            except Exception as e:  # noqa: BLE001 - the reason is reported
                return m, e
            v_g, g_g = val_grad(gen, i)
            if not abs(v_m - v_g) <= 1e-5 + rtol * abs(v_g):  # NaN-safe
                return m, FusedMismatch(
                    f"member {m}'s residual term {v_m:.6e} disagrees with "
                    f"the generic engine's {v_g:.6e}")
            ok, why = crosscheck_grads(g_g, g_m,
                                       **(BF16_GRAD_BAND if bf16 else {}))
            if not ok:
                return m, why
        return None, None

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def fit(self, tf_iter: int, chunk: int = 100, resample_every: int = 0,
            resample_pool: int = 4, resample_temp: float = 1.0,
            resample_uniform: float = 0.1, resample_seed: int = 0,
            resample_mode: str = "pool", resample_ascent_steps: int = 5,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            telemetry=None, converge_loss: Optional[float] = None,
            _graphs: bool = True):
        """Train the whole family ``tf_iter`` Adam(+SA) epochs, in chunks
        of ``chunk`` replays of the family step with one host read each.

        ``resample_every``: per-member redraws (``resample_mode`` ``"pool"``:
        :class:`~..ops.resampling.FamilyResampler`; ``"ascent"``:
        :class:`~..ops.resampling.FamilyAscentResampler`), dispatched at a
        chunk boundary on the redraw stream and adopted at the next, each
        member's λ and λ moments carried; a redraw pending at the end is
        discarded.  Draws are keyed by the global epoch, so a second fit
        explores new pools.  ``self.redraws`` keeps a record of each.

        ``checkpoint_dir`` + ``checkpoint_every``: :meth:`save_checkpoint`
        at chunk boundaries crossing the cadence.

        ``telemetry``: a :class:`~..telemetry.TrainingTelemetry` or
        :class:`~..telemetry.RunLogger`: the ``factory.*`` instruments
        (:meth:`~..telemetry.TrainingTelemetry.on_family_stats`), the step
        time per chunk (family steps, not member steps) and the ``cost.*``
        gauges with the family step priced at M times the member's
        analytic count.  ``converge_loss`` arms the converged-members
        gauge.

        A non-finite member is frozen and the family trains on;
        :class:`~..telemetry.TrainingDiverged` is raised when every member
        has frozen.  ``_graphs=False`` runs every step eagerly (the graph's
        referee on the card, not an option)."""
        if resample_every > 0 and resample_mode not in ("pool", "ascent"):
            raise ValueError(f"resample_mode={resample_mode!r}: expected "
                             "'pool' or 'ascent'")
        tele = as_training_telemetry(telemetry)
        if tele is not None and tele.logger is not None \
                and self.mesh is not None:
            tele.logger.set_writer(self.mesh.coordinator)
        epochs_at_entry = len(self.losses)
        M, N = self.n_members, int(self.X_f.shape[1])
        if tele is not None:
            self._telemetry_start(tele, tf_iter, N, resample_every,
                                  epochs_at_entry)
        fit_kw = dict(resample_every=resample_every,
                      resample_pool=resample_pool,
                      resample_temp=resample_temp,
                      resample_uniform=resample_uniform,
                      resample_seed=resample_seed,
                      resample_mode=resample_mode,
                      resample_ascent_steps=resample_ascent_steps)
        t0 = time.time()
        if self._single:
            self._fit_single(tf_iter, chunk, tele, converge_loss,
                             checkpoint_dir, checkpoint_every, _graphs,
                             fit_kw)
        else:
            self._fit_family(tf_iter, chunk, tele, converge_loss,
                             checkpoint_dir, checkpoint_every, _graphs,
                             fit_kw)
        if tele is not None:
            losses = self.member_losses()
            tele.on_fit_end(dict(
                epochs_total=len(self.losses), n_members=M,
                members_frozen=len(self.frozen_at),
                min_loss={"factory": float(np.nanmin(losses))
                          if np.isfinite(losses).any() else float("nan")},
                wall_adam=time.time() - t0))
        return self

    def _telemetry_start(self, tele, tf_iter, N, resample_every,
                         epochs_at_entry):
        from ..ops.minimax import n_channels
        from ..telemetry.costmodel import (analytic_minimax_flops,
                                           analytic_step_bytes,
                                           analytic_step_floor,
                                           per_point_lambda_columns)
        M, tpl = self.n_members, self._template
        # one family step on this process: its members
        k = len(self._members)
        tele.cost_floor = k * analytic_step_floor(N, self.layer_sizes)
        tele.cost_bytes = k * analytic_step_bytes(
            self.layer_sizes, N,
            n_lambdas=per_point_lambda_columns(tpl.lambdas["residual"], N),
            n_outputs=(tpl._minimax_n_eq if self.engine == "fused-minimax"
                       else self.layer_sizes[-1]))
        if self.engine == "fused-minimax":
            tele.cost_fallback = (
                k * analytic_minimax_flops(
                    self.layer_sizes, N, n_channels(tpl._fuse_requests),
                    n_equations=tpl._minimax_n_eq), "analytic-minimax")
        tele.on_fit_start(dict(
            tf_iter=tf_iter, n_members=M, N_f=N,
            layer_sizes=list(self.layer_sizes),
            Adaptive_type=self.Adaptive_type,
            engine=f"family-{self.engine}", resample_every=resample_every,
            dist=self.mesh.size if self.mesh is not None else False,
            prior_epochs=epochs_at_entry))
        if tf_iter > 0:
            tele.on_step_program("factory")

    def _chunk_report(self, tele, rows_alive, prev_epochs, n, t_disp,
                      t_dev, epochs_at_entry, converge_loss, N):
        """The chunk's frozen members (``frozen_at`` in global epochs), its
        telemetry, and the all-frozen stop."""
        newly = 0
        for m in range(self.n_members):
            if m in self.frozen_at:
                continue
            dead = np.nonzero(rows_alive[:, m] < 0.5)[0]
            if dead.size:
                self.frozen_at[m] = epochs_at_entry + prev_epochs + int(
                    dead[0])
                newly += 1
                log_event("factory", f"member {m} diverged at epoch "
                          f"{self.frozen_at[m]}: frozen (the family trains "
                          "on)", verbose=self.verbose, level="warning",
                          member=m, epoch=self.frozen_at[m])
        if tele is not None:
            tele.on_step_time("factory", n, t_disp, t_dev)
            pts = self.n_members * N * n / max(t_disp + t_dev, 1e-9)
            tele.on_family_stats(
                epochs_at_entry + prev_epochs + n,
                self.losses[-1]["Total Loss"], rows_alive[-1] > 0.5,
                newly_frozen=newly, converge_loss=converge_loss,
                pts_per_s=pts)
        if not bool(np.any(rows_alive[-1] > 0.5)):
            from ..telemetry import TrainingDiverged
            raise TrainingDiverged(
                "factory", epochs_at_entry + prev_epochs,
                {"Total Loss": float("nan"),
                 "members_frozen": float(self.n_members)})

    def _fit_single(self, tf_iter, chunk, tele, converge_loss,
                    checkpoint_dir, checkpoint_every, graphs, fit_kw):
        """The 1-member family: the template solver's own ``fit`` (module
        docstring), its chunks reported at each boundary."""
        tpl = self._template
        epochs_at_entry = len(self.losses)
        seen = {"rows": len(tpl.losses), "epochs": 0,
                "t": time.perf_counter()}
        N = int(self.X_f.shape[1])

        def absorb(epoch=None):
            rows = tpl.losses[seen["rows"]:]
            if not rows:
                return
            seen["rows"] = len(tpl.losses)
            alive = bool(self.alive[0])
            flags = []
            for row in rows:
                alive = alive and all(np.isfinite(v) for v in row.values())
                flags.append(1.0 if alive else 0.0)
                self.losses.append(
                    {**{k: np.asarray([v], np.float32)
                        for k, v in row.items()},
                     "Alive": np.asarray([flags[-1]], np.float32)})
            self.alive.fill_(alive)
            prev, seen["epochs"] = seen["epochs"], seen["epochs"] + len(rows)
            now = time.perf_counter()
            dt, seen["t"] = now - seen["t"], now
            self._chunk_report(tele, np.asarray(flags)[:, None], prev,
                               len(rows), dt, 0.0, epochs_at_entry,
                               converge_loss, N)
            if (checkpoint_dir is not None and checkpoint_every > 0
                    and prev // checkpoint_every
                    != seen["epochs"] // checkpoint_every):
                self.save_checkpoint(checkpoint_dir)
                if tele is not None:
                    tele.on_checkpoint("factory", len(self.losses))

        n_before = len(tpl.redraws)
        tpl.fit(tf_iter=tf_iter, chunk=chunk, eval_fn=lambda *a: absorb(),
                eval_every=chunk, _graphs=graphs, **fit_kw)
        absorb()
        self.redraws.extend(tpl.redraws[n_before:])

    def _family_step(self, eager: bool, make_graph=None) -> AdamStep:
        """The family step: an :class:`~..training.fit.AdamStep` with a
        member axis over the stacked state, kept across fits (its graph is
        captured once); its running best is the factory's, which outlives
        a step (checkpoints, an eager twin).  ``make_graph``: a stand-in
        graph, as for the solo step."""
        if (self._step is None or self._step.eager != eager
                or make_graph is not None):
            step = AdamStep(self._family_loss, self.params, self.lambdas,
                            self.X_f, self._opt, verbose=False, eager=eager,
                            make_graph=make_graph, mesh=self.mesh,
                            alive=self.alive)
            step.best_params = self.best_params
            step.best_loss, step.best_step = self.best_loss, self.best_step
            self._step = step
        return self._step

    def _make_sampler(self, kw, N):
        from ..ops.resampling import FamilyAscentResampler, FamilyResampler
        xl = self.domain.xlimits
        residual = lambda m, p, X: self._residuals[m](p, X)  # noqa: E731
        if kw["resample_mode"] == "ascent":
            return FamilyAscentResampler(
                residual, xl, N, len(self._members),
                n_steps=kw["resample_ascent_steps"],
                fresh_frac=kw["resample_uniform"],
                seed=kw["resample_seed"],
                family_score_grad_fn=self._family_score_grad)
        return FamilyResampler(
            residual, xl, N, len(self._members),
            pool_factor=kw["resample_pool"], temp=kw["resample_temp"],
            uniform_frac=kw["resample_uniform"], seed=kw["resample_seed"])

    def _fit_family(self, tf_iter, chunk, tele, converge_loss,
                    checkpoint_dir, checkpoint_every, graphs, kw):
        """``fit_adam`` over the family step: each chunk's rows recorded
        and reported (:meth:`_chunk_report`), the redraws pipelined and
        keyed by the global epoch, the checkpoints through its state
        hook."""
        from ..telemetry.costmodel import analytic_mlp_flops

        step = self._family_step(eager=not graphs)
        epochs_at_entry = len(self.losses)
        N = int(self.X_f.shape[1])
        resample = flops = None
        if kw["resample_every"] > 0:
            sampler = self._make_sampler(kw, N)
            members = list(self._members)
            flops = len(members) * analytic_mlp_flops(
                self.layer_sizes, sampler.n_f + sampler.n_fresh)

            def redraw(params, X, epoch):
                if tele is not None:
                    # credited to the chunk the redraw runs behind
                    tele.note_resample_flops(flops)
                return sampler.redraw(params, X, members, epoch)

            resample = SimpleNamespace(pipelined=True, redraw=redraw)

        def on_chunk(rows, prev, t_disp, t_dev):
            self.losses.extend(rows)
            self._chunk_report(tele, np.stack([r["Alive"] for r in rows]),
                               prev, len(rows), t_disp, t_dev,
                               epochs_at_entry, converge_loss, N)

        hook = None
        if checkpoint_dir is not None and checkpoint_every > 0:
            def hook(epoch, best):
                self.save_checkpoint(checkpoint_dir)
                if tele is not None:
                    tele.on_checkpoint("factory", epoch)

        res = fit_adam(step, tf_iter, chunk, verbose=False, state_hook=hook,
                       state_hook_every=checkpoint_every,
                       resample_fn=resample,
                       resample_every=kw["resample_every"],
                       epoch_offset=epochs_at_entry, epoch0=epochs_at_entry,
                       chunk_fn=on_chunk)
        for rec in res.redraws:
            if tele is not None and rec["adopted"] is not None:
                tele.on_resample("factory", rec["adopted"],
                                 rec["dispatch_s"] + rec["stall_s"],
                                 stats=rec["stats"], pipelined=True,
                                 dispatched_epoch=rec["epoch"],
                                 flops=(flops, "analytic-resample"))
        self.redraws.extend(res.redraws)

    # ------------------------------------------------------------------ #
    # members
    # ------------------------------------------------------------------ #
    def _local(self, m: int) -> int:
        """Member ``m``'s row in this process's stacked state."""
        if m not in self._members:
            raise ValueError(
                f"member {m} is trained by another rank of the group "
                f"(this rank holds {self._members[0]}-{self._members[-1]})")
        return self._members.index(m)

    def member_losses(self) -> np.ndarray:
        """``[M]`` latest per-member total losses."""
        if not self.losses:
            return np.full((self.n_members,), np.nan)
        return np.asarray(self.losses[-1]["Total Loss"], np.float64)

    def member_history(self, m: int) -> list:
        """Member ``m``'s loss history as the solver's per-epoch rows."""
        return [{k: float(v[m]) for k, v in row.items() if k != "Alive"}
                for row in self.losses]

    def member_params(self, m: int, best: bool = False) -> list:
        """Member ``m``'s parameters as ``[(W, b), ...]`` (copies);
        ``best=True`` its best iterate of the training."""
        i = self._local(m)
        if self._single:
            src = self._template.best_model["adam"] if best else None
            if src is not None:
                return [(W.detach().clone(), b.detach().clone())
                        for W, b in src]
            return [(W.detach().clone(), b.detach().clone())
                    for W, b in self._template.net.layers()]
        src = self.best_params if best else self.params
        flat = [t[i].detach().clone() for t in src]
        return list(zip(flat[0::2], flat[1::2]))

    def member_f_model(self, m: int) -> Callable:
        """Member ``m``'s residual with its θ bound: ``f_model(u,
        *coords)``."""
        return _bind(self.f_model, self.member_thetas[m])

    def member_surrogate(self, m: int, best: bool = False):
        """Member ``m`` as a deployable :class:`~..serving.Surrogate`."""
        from ..serving import Surrogate
        return Surrogate(self.net, self.member_params(m, best=best),
                         self.varnames, n_out=self.n_out,
                         f_model=self.member_f_model(m), contract="forward")

    def export_family(self, path: str, *, min_bucket: int = 256,
                      max_bucket: int = 4096, kinds=None,
                      best: bool = False, aot: bool = True,
                      registry=None) -> dict:
        """Slice every LIVE member into a v2 fleet artifact under
        ``path/member_<m:03d>`` (:func:`~..fleet.export_fleet_artifact`)
        and write ``family_manifest.json`` — the artifact batch
        :meth:`~..fleet.FleetRouter.register_family` loads directly.
        Frozen (diverged) members are skipped and recorded in the manifest
        (member index → the global epoch it froze at) instead of shipping
        a poisoned surrogate.  A family sharded over more than one rank
        holds only its own members on each: restore its checkpoint at
        world 1 and export from there.  ``registry`` receives the
        ``factory.exports`` counter (default: the process registry).
        Returns the manifest dict (the JAX package's keys)."""
        from ..fleet import export_fleet_artifact
        from ..telemetry import default_registry

        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError(
                "export_family needs every member's parameters in this "
                f"process; this family is sharded over {self.mesh.size} "
                "ranks (restore its checkpoint at world 1 and export "
                "there)")

        kw = {"min_bucket": min_bucket, "max_bucket": max_bucket,
              "aot": aot}
        if kinds is not None:
            kw["kinds"] = kinds
        os.makedirs(path, exist_ok=True)
        alive = self.alive.detach().cpu().numpy()
        members, frozen = {}, {}
        for m in range(self.n_members):
            if not bool(alive[self._local(m)]):
                frozen[str(m)] = int(self.frozen_at.get(m, -1))
                continue
            rel = f"member_{m:03d}"
            export_fleet_artifact(self.member_surrogate(m, best=best),
                                  os.path.join(path, rel), **kw)
            members[str(m)] = rel
        manifest = {
            "format": 1,
            "n_members": self.n_members,
            "members": members,
            "frozen": frozen,
            "thetas": [[float(v) for v in np.ravel(t)]
                       for t in self.thetas],
            "layer_sizes": list(self.layer_sizes),
            "varnames": list(self.varnames),
        }
        with open(os.path.join(path, FAMILY_MANIFEST), "w") as fh:
            json.dump(manifest, fh, indent=1)
        registry = registry if registry is not None else default_registry()
        registry.counter("factory.exports").inc(len(members))
        log_event("factory", f"exported {len(members)} member artifact(s) "
                  f"-> {path}" + (f" ({len(frozen)} frozen member(s) "
                                  "skipped)" if frozen else ""),
                  verbose=self.verbose, path=str(path),
                  members=len(members), frozen=len(frozen))
        return manifest

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def _opt_pair(self):
        return self._template._opt if self._single else self._opt

    def _block(self, t):
        """A stacked leaf as a checkpoint leaf: this rank's member block
        of the family's rows under ``dist``."""
        from ..checkpoint import RowBlock
        if self.mesh is None or self.mesh.size == 1:
            return t.detach()
        k = len(self._members)
        return RowBlock(t.detach(), self.mesh.rank * k, self.n_members)

    def _state_leaves(self) -> dict:
        """The stacked tensors a checkpoint holds, by name (views with a
        member axis of 1 for a 1-member family)."""
        out = {"params": list(self.params),
               "lambdas": {k: list(v) for k, v in self.lambdas.items()},
               "X_f": self.X_f}
        opts = self._opt_pair()
        if opts is not None and _moments(opts):
            moments = _moments(opts)
            out["opt_state"] = {
                "exp_avg": [m[1].unsqueeze(0) if self._single else m[1]
                            for m in moments],
                "exp_avg_sq": [m[2].unsqueeze(0) if self._single else m[2]
                               for m in moments],
                "step": [opt.state[opt.param_groups[0]["params"][0]]["step"]
                         for opt in opts if opt is not None]}
        return out

    def save_checkpoint(self, path: str, sharded: Optional[bool] = None):
        """Checkpoint the family's whole training state: stacked
        parameters, λ, Adam moments and step counts, collocation sets, θ,
        the alive mask and the best iterates, with the history and
        ``frozen_at`` in the meta (:mod:`..checkpoint`).  Under ``dist``
        every rank calls it; each writes its member block."""
        from ..checkpoint import save_checkpoint
        leaves = self._state_leaves()
        blk = self._block
        state = {"params": [blk(t) for t in leaves["params"]],
                 "lambdas": {k: [None if t is None else blk(t) for t in v]
                             for k, v in leaves["lambdas"].items()},
                 "X_f": blk(leaves["X_f"]), "thetas": self.thetas,
                 "alive": blk(self.alive.to(torch.float32))}
        if "opt_state" in leaves:
            o = leaves["opt_state"]
            state["opt_state"] = {
                "exp_avg": [blk(t) for t in o["exp_avg"]],
                "exp_avg_sq": [blk(t) for t in o["exp_avg_sq"]],
                "step": [t.detach() for t in o["step"]]}
        if not self._single:
            state["best_params"] = [blk(t) for t in self.best_params]
            state["best_loss"] = blk(self.best_loss)
            state["best_step"] = blk(self.best_step.to(torch.float32))
        meta = {"n_members": self.n_members, "epochs": len(self.losses),
                "losses": [{k: np.asarray(v).tolist() for k, v in row.items()}
                           for row in self.losses],
                "frozen_at": {str(k): int(v)
                              for k, v in self.frozen_at.items()},
                "has_opt_state": "opt_state" in state,
                "has_best": "best_params" in state}
        save_checkpoint(path, state, meta, sharded=sharded, mesh=self.mesh)
        log_event("checkpoint", f"saved family state -> {path}",
                  verbose=False, path=str(path), members=self.n_members,
                  epochs=len(self.losses))

    def restore_checkpoint(self, path: str):
        """Restore a family checkpoint into this factory, in place (a
        captured family step replays on).  Rejects a checkpoint of another
        member count or other θ: the family axis is configuration.  Under
        ``dist`` each rank takes its member block of the family's rows, so
        a checkpoint written at another world size restores."""
        from ..checkpoint import resolve_checkpoint_dir, restore_checkpoint
        with open(os.path.join(resolve_checkpoint_dir(path),
                               "tdq_meta.json")) as fh:
            meta_peek = json.load(fh)["meta"]
        if int(meta_peek.get("n_members", -1)) != self.n_members:
            raise ValueError(
                f"checkpoint has {meta_peek.get('n_members')} members but "
                f"this factory was built with {self.n_members}; the family "
                "axis is part of the configuration")
        M = self.n_members
        if meta_peek.get("has_opt_state") and self._opt_pair() is None:
            tpl = self._template
            tpl._opt = make_optimizer(tpl.net.params(), tpl.lambdas,
                                      tpl.lr, tpl.lr_weights)
            tpl._opt_rates = (tpl.lr, tpl.lr_weights)
        for opt in self._opt_pair() or ():
            init_adam_state(opt)
        leaves = self._state_leaves()

        def glob(t):
            return np.zeros((M,) + tuple(t.shape[1:]), np.float32)

        template = {"params": [glob(t) for t in leaves["params"]],
                    "lambdas": {k: [None if t is None else glob(t)
                                    for t in v]
                                for k, v in leaves["lambdas"].items()},
                    "X_f": glob(leaves["X_f"]), "thetas": self.thetas,
                    "alive": np.zeros((M,), np.float32)}
        if meta_peek.get("has_opt_state"):
            o = leaves["opt_state"]
            template["opt_state"] = {
                "exp_avg": [glob(t) for t in o["exp_avg"]],
                "exp_avg_sq": [glob(t) for t in o["exp_avg_sq"]],
                "step": [np.zeros((), np.float32) for _ in o["step"]]}
        has_best = meta_peek.get("has_best") and not self._single
        if has_best:
            template["best_params"] = [glob(t) for t in self.best_params]
            template["best_loss"] = np.zeros((M,), np.float32)
            template["best_step"] = np.zeros((M,), np.float32)
        state, meta = restore_checkpoint(path, template)
        if not np.array_equal(np.asarray(state["thetas"]), self.thetas):
            raise ValueError(
                "checkpoint was trained with different member coefficients "
                "(thetas) than this factory was built with; the family "
                "axis is part of the configuration")
        rows = slice(self._members[0], self._members[-1] + 1)

        def put(live, saved):
            live.copy_(torch.as_tensor(np.asarray(saved)[rows],
                                       device=live.device).to(live.dtype))

        with torch.no_grad():
            for t, s in zip(leaves["params"], state["params"]):
                put(t, s)
            for key, vals in leaves["lambdas"].items():
                for t, s in zip(vals, state["lambdas"][key]):
                    if t is not None:
                        put(t, s)
            put(leaves["X_f"], state["X_f"])
            self.alive.copy_(torch.as_tensor(
                np.asarray(state["alive"])[rows] > 0.5, device=self.device))
            if "opt_state" in state:
                o = leaves["opt_state"]
                for key in ("exp_avg", "exp_avg_sq"):
                    for t, s in zip(o[key], state["opt_state"][key]):
                        put(t, s)
                # every leaf of an Adam carries the same step count
                opts = [opt for opt in self._opt_pair() if opt is not None]
                for opt, s in zip(opts, state["opt_state"]["step"]):
                    for p in opt.param_groups[0]["params"]:
                        t = opt.state[p]["step"]
                        t.copy_(torch.as_tensor(np.asarray(s)).to(t.dtype))
            if has_best:
                for t, s in zip(self.best_params, state["best_params"]):
                    put(t, s)
                put(self.best_loss, state["best_loss"])
                self.best_step.copy_(torch.as_tensor(
                    np.asarray(state["best_step"])[rows],
                    device=self.device).to(torch.long))
        self.losses = [{k: np.asarray(v, np.float32) for k, v in row.items()}
                       for row in meta.get("losses", [])]
        self.frozen_at = {int(k): int(v)
                          for k, v in meta.get("frozen_at", {}).items()}
        if self._single:
            tpl = self._template
            tpl.losses = [{k: float(v[0]) for k, v in row.items()
                           if k != "Alive"} for row in self.losses]
        log_event("restore", f"restored family state from {path} "
                  f"({len(self.losses)} epochs, {len(self.frozen_at)} "
                  "frozen)", verbose=False, path=str(path),
                  epochs=len(self.losses))
        return self
