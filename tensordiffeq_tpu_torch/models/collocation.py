"""The forward collocation solver.

Counterpart of the JAX package's ``models/collocation.py::
CollocationSolverND`` (reference ``tensordiffeq/models.py:12-322``), with
the same user workflow::

    solver = CollocationSolverND()            # device="cuda" by default
    solver.compile(layer_sizes, f_model, domain, bcs, fused="cuda")
    solver.fit(tf_iter=10_000, newton_iter=10_000)  # Adam, then L-BFGS
    u_pred, f_pred = solver.predict(X_star)

Residual engines (``compile(fused=...)``):

* ``False`` — the generic per-point autodiff engine (``torch.func``);
* ``None`` — the fused Taylor-propagation engine (plain flavor) when the
  network and ``f_model`` qualify and pass the numeric cross-check, else
  the generic engine;
* ``True`` — the fused engine, plain flavor, or raise;
* ``"cuda"`` — the fused engine whose derivative table comes from the
  hand-written CUDA kernels (:mod:`..ops.cuda_taylor`), the counterpart of
  the JAX package's ``"pallas"``; on a CPU solver the same producer takes
  the plain flavor.

The fused minimax step (``compile(minimax=...)``, :mod:`..ops.minimax`)
replaces the training loss's residual term with one unit that computes the
λ-weighted residual loss and every cotangent: on a CUDA solver the
hand-written kernel K3 (:mod:`..ops.cuda_minimax`), on a CPU solver its
plain flavor.  ``None`` adopts it behind a numeric cross-check whenever the
fused residual is active, as the JAX solver does; ``True`` requires it;
``False`` keeps the unfused loss.

``fit(newton_iter=...)`` refines with L-BFGS (:mod:`..training.lbfgs`) on
the same training loss, so on the card every evaluation of the loss and its
gradient is one K3 launch.  ``save_checkpoint``/``restore_checkpoint``
carry the whole training state (:mod:`..checkpoint`), ``fit(checkpoint_dir=,
checkpoint_every=)`` saves it at chunk boundaries of both phases, and
``save``/``load_model`` write and read the network alone, self-describing.
``export_surrogate`` hands the trained network to the serving path
(:mod:`..serving`).  The training options of the JAX solver are here too:
learning-rate schedules (``lr``/``lr_weights`` callables, evaluated on the
device inside the Adam step, :mod:`..training.schedules`), the embedding
network families (``network=FourierMLP/PeriodicMLP``, on the generic
engine), NTK weighting (``Adaptive_type=3``, :mod:`..ops.ntk`), causal
weighting with its ε ladder (``causal_eps``), ``remat``, and
``fused="autotune"``, which times each residual engine's graphed
loss-and-gradient step and races the minimax step against the winner.
``network=`` takes any ``nn.Module`` (through the network protocol of
:mod:`..networks`; a custom module, another activation or a bf16 ``dtype``
trains on the generic engine), and the network's ``precision`` runs
through every engine: ``None``/``"default"`` takes the single-pass TF32
flavor of K1, K2 and K3 and TF32 matmuls outside them on the card, as
XLA's f32 DEFAULT product does on a GPU.
``fit(resample_every=...)`` redraws the collocation
set during the Adam phase (:mod:`..ops.resampling`): the pool redraw,
scored through the residual engine (K1 on ``fused="cuda"``), or the
PACMANN ascent mover (``resample_mode="ascent"``), scored and moved by one
K3 launch at w ≡ 1 per step when the minimax step is adopted.

``compile(fused_dtype="bfloat16")`` is the mixed precision of the JAX
solver: every fused engine takes its bf16-operand flavor (the products on
operands rounded to bf16 with f32 sums; K1-bf16/K2-bf16 on ``fused="cuda"``
and K3-bf16 for the minimax step on the card), the cross-checks take the
reference's bf16 bands, and the L-BFGS leg starts on the bf16 loss and
retreats to the f32 flavor of the same engines when its line search
stagnates (:func:`~..training.lbfgs.lbfgs_minimize`'s ``fun_fallback``).

Of the JAX solver only ``dist=`` (and ``save_checkpoint(sharded=True)``)
is not ported yet; both raise :class:`~..utils.NotPortedError` naming
their ROADMAP item.
"""

from __future__ import annotations

import io
import json
import os
import struct
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..boundaries import BC
from ..domains import DomainND
from ..networks import (MLP, ModuleNet, as_network, init_generator,
                        net_buffers, net_from_metadata, net_metadata)
from ..ops.derivatives import make_ufn, vmap_residual
from ..training.fit import (AdamStep, FitResult, fit_adam, make_optimizer,
                            relink_schedules)
from ..training.lbfgs import fit_lbfgs
from ..utils import (initialize_lambdas, matmul_precision, not_ported,
                     param_leaves, resolve_compute_dtype, resolve_device)
from .assembly import build_loss_fn


class NotCompiledError(RuntimeError):
    """A method that needs the compiled training graph ran before
    ``compile(...)``."""


class AutotuneFailure(RuntimeError):
    """``fused="autotune"`` had no surviving residual-engine candidate:
    every engine failed to run.  ``failures`` maps each candidate's name to
    its exception."""

    def __init__(self, failures: dict):
        self.failures = dict(failures)
        super().__init__(
            "autotune: every residual engine candidate failed: "
            + "; ".join(f"{k}: {type(e).__name__}: {e}"
                        for k, e in failures.items()))


# compile() options of the JAX solver that the port does not have yet:
# name -> (value that means "off", ROADMAP item)
_UNPORTED_COMPILE = {
    "dist": (False, "queue 1, multi-GPU"),
}
# the JAX solver's cross-check bands under fused_dtype (its
# collocation.py:610-613, 812-820): bf16 keeps ~3 significant digits,
# compounded across the layers, and twice in the backward pass
BF16_VALUE_BAND = dict(rtol=5e-2, atol=1e-3)
BF16_GRAD_BAND = dict(rtol=1.5e-1, atol=1e-3)


def _reject_unported(table: dict, given: dict, where: str):
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        off, item = table[name]
        if value is not off and value != off:
            raise not_ported(f"{where}({name}=...)", item)


class _DeviceResampleHook:
    """``fit_adam``-facing adapter around a device resampler
    (:class:`~..ops.resampling.DeviceResampler` or
    :class:`~..ops.resampling.AscentResampler`): re-bases the loop's
    call-relative epoch by the epochs already trained, so a warm-restarted
    ``fit`` explores new pools instead of replaying the last one's draws,
    and prices a redraw's scoring for the live cost model
    (:meth:`flops_info`).  The swap writes into the solver's ``X_f`` in
    place, so nothing else needs syncing."""

    pipelined = True

    def __init__(self, sampler, epoch_offset: int, layer_sizes):
        self.sampler = sampler
        self.epoch_offset = int(epoch_offset)
        self.layer_sizes = layer_sizes

    def redraw(self, layers, X_cur, epoch: int):
        return self.sampler.redraw(layers, X_cur, epoch + self.epoch_offset)

    def flops_info(self):
        """``(flops, basis)`` of one redraw's scoring: one forward pass of
        the network over the pool (current points and fresh ones), the
        JAX solver's ``"analytic-resample"`` floor."""
        from ..telemetry.costmodel import analytic_mlp_flops
        n_pool = self.sampler.n_f + self.sampler.n_fresh
        return analytic_mlp_flops(self.layer_sizes, n_pool), \
            "analytic-resample"


_SAVE_MAGIC = b"TDQM"


class CollocationSolverND:
    """N-dimensional collocation PINN solver (forward problems).

    ``Adaptive_type`` keeps the reference's encoding: 0 = baseline, 1 =
    self-adaptive per-point (SA-PINN), 2 = self-adaptive scalar per loss,
    3 = NTK weighting (scalar per loss, recomputed between chunks).
    ``device`` defaults to ``"cuda"`` and raises
    :class:`~..utils.CudaUnavailableError` without a card; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, assimilate: bool = False, verbose: bool = True,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.assimilate = assimilate
        self.verbose = verbose
        self.seed = seed
        self.losses: list[dict] = []
        self.best_epoch = {"adam": -1, "l-bfgs": -1, "overall": -1}
        self.min_loss = {"adam": np.inf, "l-bfgs": np.inf, "overall": np.inf}
        self.best_model = {"adam": None, "l-bfgs": None, "overall": None}
        self.data_X = None
        self.data_s = None
        self._opt = None  # Adam pair; the moments persist across fit() calls
        self._opt_grad_clip = None  # the clipping the moments were made under
        self._adam = None  # the AdamStep (and its CUDA graph) of the last fit
        self._compiled = False
        self._loaded = False  # load_model() on an uncompiled solver
        # L-BFGS iterations done so far (restored from checkpoints), so a
        # resumed run credits the refinement it already did
        self.newton_done = 0
        # the absolute L-BFGS iteration at which the last leg retreated to
        # the f32 loss (fused_dtype), else None
        self.lbfgs_retreat = None
        # the least resample_uniform a redraw uses (a resilience remedy in
        # the JAX package); checkpoints carry it
        self._resample_uniform_floor = 0.0
        # one record per redraw of every fit (training.fit.fit_adam)
        self.redraws: list[dict] = []
        # one record per NTK weight update: host s, device ms, the weights
        self.ntk_updates: list[dict] = []

    @property
    def params(self) -> list:
        """The network's live parameters in its structure (``param_tree``):
        ``[(W, b), ...]`` for the MLP family, the flat list of a custom
        module's parameters."""
        return self.net.param_tree(self.net.params())

    def _tree(self, params) -> list:
        """The checkpoint's layout of parameters (a flat list or the
        network's structure): ``[[W, b], ...]`` for the MLP family, as
        before custom modules, else the flat list."""
        tree = self.net.param_tree(param_leaves(params))
        return ([list(pair) for pair in tree] if isinstance(self.net, MLP)
                else list(tree))

    # ------------------------------------------------------------------ #
    def compile(self, layer_sizes: Sequence[int], f_model: Callable,
                domain: DomainND, bcs: Sequence[BC], Adaptive_type: int = 0,
                dict_adaptive: Optional[dict] = None,
                init_weights: Optional[dict] = None,
                g: Optional[Callable] = None,
                network: Optional[torch.nn.Module] = None,
                lr=0.005, lr_weights=0.005,
                fused=None, fused_dtype=None,
                minimax: Optional[bool] = None, causal_eps=None,
                causal_bins: int = 32, causal_delta: float = 0.99,
                remat: bool = False,
                ntk_max_ratio: Optional[float] = 100.0,
                ntk_max_points: int = 256, **unported):
        """Assemble the problem (reference ``models.py:27-105``).

        Args:
          layer_sizes: ``[n_in, …, n_out]`` MLP sizes; ``None`` after
            :meth:`load_model` reuses the loaded network and its parameters
            (transfer learning without restating the architecture).
          f_model: per-point residual ``f_model(u, *coords)`` written with
            :func:`tensordiffeq_tpu_torch.grad` combinators.
          domain: :class:`DomainND` with collocation points generated.
          bcs: list of boundary/initial conditions.
          Adaptive_type: 0/1/2 as in the reference; 3 = NTK weighting
            (:mod:`..ops.ntk`): one scalar λ per loss term starting at 1,
            recomputed from the terms' tangent-kernel traces before the
            first step and at every chunk boundary, frozen inside the step
            (``dict_adaptive``/``init_weights`` must be ``None``).
          dict_adaptive/init_weights: SA contract — which loss terms carry λ
            and their initial values.
          g: optional λ transform for residual terms.
          network: any ``nn.Module`` mapping ``[N, n_in]`` to ``[N,
            n_out]`` to train instead of a fresh MLP: the MLP family (with
            its knobs: ``activation``, ``precision``, ``dtype``,
            ``param_dtype``) or a custom module (adapted by
            :class:`~..networks.ModuleNet`; it trains in place); its
            parameters are moved to the solver's device.  Only the plain
            float32 tanh MLP qualifies for the fused engines, as in the JAX
            package; the rest takes the generic engine (``fused=True`` or
            ``"cuda"`` then raises).  The network's ``precision`` is the
            solver's: ``None``/``"default"`` takes the kernels' TF32
            flavor and TF32 matmuls on the card.
          lr, lr_weights: the Adam rates of the network and of the SA λ: a
            float, or a schedule (:mod:`..training.schedules`, or any
            callable of a 0-d integer device tensor returning a 0-d float32
            tensor), evaluated on the device at optax's count inside the
            Adam step.  The count persists across ``fit`` calls and through
            checkpoints.
          fused: residual engine selection (module docstring), or
            ``"autotune"``: the generic engine, the fused engine's plain
            flavor and, on the card, its K1/K2 flavor (behind a
            cross-check of its own) each time a graphed loss-and-gradient
            step over the full training loss (CUDA events over replays,
            warm-up and capture excluded; eager steps on the CPU), the
            fastest is kept, and the minimax step is then adopted only if
            its own step beats the winner's.  ``autotune_report`` records
            the race.
          fused_dtype: ``None``, or ``"bfloat16"``/``torch.bfloat16``:
            the fused engines' mixed precision (module docstring), the
            JAX solver's option.  The cross-checks then take its bands
            (values 5e-2, gradients 1.5e-1, atol 1e-3).  Ignored with a
            warning under ``fused=False``, and with a warning when no fused
            engine is adopted.  ``loss_fn_refine`` is the f32 loss the
            L-BFGS leg retreats to.
          minimax: the fused minimax step (module docstring).  ``None``
            adopts it when the fused residual is active, the ``f_model``
            lowers to the kernel's residual tape and the step passes the
            cross-check, else records why in ``_minimax_fail_reason``;
            ``True`` raises :class:`ValueError` instead of falling back;
            ``False`` keeps the unfused loss.
          causal_eps / causal_bins / causal_delta: temporal-causality
            weighting of the residual (Wang et al. 2203.07404): bin ``b``
            along time weighted by ``exp(-ε · Σ earlier bins' loss)``; the
            history gets ``Causal_w_last_j`` per epoch.  A sequence of ε is
            the annealing ladder: Adam starts at the smallest and advances
            at a chunk boundary once ``min Causal_w_last > causal_delta``,
            handing the remaining epochs, the moments and λ to the next
            stage.  ε lives in a device scalar, so one captured step serves
            the whole ladder.  Needs a domain with ``time_var``; the minimax
            step declines it.
          remat: recompute the residual's evaluation in the backward pass
            (:func:`~.assembly.build_loss_fn`); the minimax step declines
            it.
          ntk_max_ratio / ntk_max_points: NTK weighting's bound on the
            weights' range (``None``: unbounded) and per-term trace
            subsample.
          **unported: ``dist`` at anything but its "off" value raises
            :class:`~..utils.NotPortedError` (multi-GPU, the only option
            of the JAX solver's ``compile`` not ported yet).
        """
        _reject_unported(_UNPORTED_COMPILE, unported, "compile")
        if fused_dtype is not None and fused is False:
            warnings.warn("fused_dtype is ignored with fused=False (the "
                          "generic engine has no Taylor matmuls)")
            fused_dtype = None
        fused_dtype = resolve_compute_dtype(fused_dtype)
        if fused not in (None, False, True, "cuda", "autotune"):
            raise ValueError(f"fused={fused!r}: expected None, False, True, "
                             "'cuda' or 'autotune' ('pallas' is the JAX "
                             "package's TPU kernel; its counterpart here is "
                             "'cuda')")
        if causal_eps is not None and domain.time_var is None:
            raise ValueError("causal_eps requires a domain with time_var "
                             "set (causality is ordered along time)")
        if layer_sizes is None:
            if not self._loaded:
                raise ValueError(
                    "layer_sizes=None requires load_model(path) first (the "
                    "architecture is then taken from the saved file)")
            layer_sizes = self.layer_sizes
            if network is None:
                network = self.net
        if Adaptive_type not in (0, 1, 2, 3):
            raise ValueError("Adaptive method invalid! (expected 0, 1, 2 or 3)")
        if Adaptive_type == 3 and (dict_adaptive is not None
                                   or init_weights is not None):
            raise ValueError(
                "NTK weighting (type 3) computes all term weights from the "
                "tangent kernel; dict_adaptive/init_weights must be None")
        if domain.X_f is None:
            raise ValueError("Domain has no collocation points; call "
                             "domain.generate_collocation_points(N_f) first")
        self.layer_sizes = list(layer_sizes)
        self.domain = domain
        self.bcs = list(bcs)
        self.f_model = f_model
        self.g = g
        self.fused = fused
        self.fused_dtype = fused_dtype
        self.minimax = minimax
        self.lr = lr
        self.lr_weights = lr_weights
        self.n_out = int(layer_sizes[-1])
        # a number: one stage; a sequence: the annealing ladder, ascending
        if causal_eps is None:
            self.causal_ladder = []
        elif np.ndim(causal_eps) == 0:
            self.causal_ladder = [float(causal_eps)]
        else:
            self.causal_ladder = sorted(float(e) for e in causal_eps)
            if not self.causal_ladder:
                raise ValueError("causal_eps sequence must be non-empty")
        self.causal_eps = (self.causal_ladder[0] if self.causal_ladder
                           else None)
        self.causal_bins = int(causal_bins)
        self.causal_delta = float(causal_delta)
        self._ladder_active = False
        # ε in a device scalar: a ladder stage rewrites it with fill_, and
        # the captured step reads it
        self._causal_kw = {} if self.causal_eps is None else dict(
            causal_eps=torch.full((), self.causal_eps, device=self.device),
            causal_bins=self.causal_bins,
            time_index=domain.vars.index(domain.time_var),
            time_bounds=tuple(float(v) for v in
                              domain.bounds(domain.time_var)))
        self.remat = bool(remat)
        self.ntk_max_ratio = ntk_max_ratio
        self.ntk_max_points = int(ntk_max_points)

        if network is None:
            network = MLP(layer_sizes, device=self.device,
                          generator=init_generator(self.seed))
        self.net = as_network(network).to(self.device)
        self.apply_fn = self.net.apply
        self.precision = self.net.precision
        self._opt = None
        self._adam = None

        self.Adaptive_type = Adaptive_type
        self.isAdaptive = Adaptive_type in (1, 2)
        self.use_ntk = Adaptive_type == 3
        self.weight_outside_sum = Adaptive_type in (2, 3)
        self.dict_adaptive = dict_adaptive
        if self.isAdaptive:
            if dict_adaptive is None or init_weights is None:
                raise ValueError(
                    "Adaptive weights selected but no inputs were specified!")
            if all(not any(v) for v in dict_adaptive.values()):
                raise ValueError("Adaptive method was selected but no loss "
                                 "was marked to be adaptive")
            for name, dct in (("dict_adaptive", dict_adaptive),
                              ("init_weights", init_weights)):
                unknown = set(dct) - {"residual", "BCs"}
                if unknown:
                    raise ValueError(
                        f"{name} has unknown key(s) {sorted(unknown)}; "
                        "expected only 'residual' and 'BCs'")
            dict_adaptive = {
                "residual": list(dict_adaptive.get("residual", [])),
                "BCs": list(dict_adaptive.get("BCs", [False] * len(self.bcs))),
            }
            init_weights = {
                "residual": list(init_weights.get("residual", [])),
                "BCs": list(init_weights.get("BCs", [None] * len(self.bcs))),
            }
            if len(dict_adaptive["BCs"]) != len(self.bcs):
                raise ValueError(
                    f"dict_adaptive['BCs'] has {len(dict_adaptive['BCs'])} "
                    f"entries but {len(self.bcs)} boundary conditions were "
                    "passed")
            for i, bc in enumerate(self.bcs):
                if dict_adaptive["BCs"][i] and (bc.isPeriodic or bc.isNeumann):
                    kind = "periodic" if bc.isPeriodic else "Neumann"
                    raise ValueError(
                        f"Adaptive {kind} boundary conditions are not "
                        "supported (reference models.py:138-140,159-161)")
            self.lambdas = initialize_lambdas(init_weights, dict_adaptive,
                                              device=self.device)
        else:
            if dict_adaptive is not None or init_weights is not None:
                raise ValueError(
                    "Adaptive weights are turned off but weight vectors were "
                    "provided; set them to None to continue")
            self.lambdas = {"residual": [], "BCs": []}

        # row-major: SciPy's LHS hands back a Fortran-ordered design
        self.X_f = torch.as_tensor(
            np.ascontiguousarray(domain.X_f, np.float32), device=self.device)
        if self.use_ntk:
            # one scalar weight per loss term, balanced at 1, rewritten in
            # place by each NTK update (the step's graph reads them)
            one = lambda: torch.ones((), device=self.device)  # noqa: E731
            self.lambdas = {
                "residual": [one() for _ in range(self._count_residuals())],
                "BCs": [one() for _ in self.bcs]}
        with matmul_precision(self.precision):
            self._build()
        self._compiled = True
        return self

    def _try_fuse(self):
        """The fused Taylor-propagation residual when both the network and
        ``f_model`` qualify, else ``None`` (the failure is recorded in
        ``_fuse_fail_reason``)."""
        from ..ops.fused import analyze_f_model, mlp_qualifies

        self._fuse_fail_reason = None
        self._fuse_requests = None
        self._fused_kind = None
        layers = mlp_qualifies(self.net)
        if layers is None:
            return None
        requests, reason = analyze_f_model(
            self.f_model, self.domain.vars, self.n_out, return_reason=True)
        if requests is None:
            self._fuse_fail_reason = reason
            return None
        self._fuse_requests = requests
        self._fused_kind = "cuda" if self.fused == "cuda" else "plain"
        return self._fused_flavor(self._fused_kind)

    def _fused_flavor(self, kind: str, f32: bool = False):
        """The fused residual whose table comes from K1/K2 (``"cuda"``; the
        plain flavor on a CPU solver) or from the plain flavor
        (``"plain"``), in ``fused_dtype``'s flavor unless ``f32``."""
        from ..ops.fused import make_fused_residual

        dtype = None if f32 else self.fused_dtype
        table_producer = None
        if kind == "cuda":
            from ..ops.cuda_taylor import build_cuda_table_fn
            table_producer = build_cuda_table_fn(
                self._fuse_requests,
                [tuple(W.shape) for W, _ in self.net.layers()],
                device=self.device, compute_dtype=dtype,
                precision=self.precision)
        return make_fused_residual(self.f_model, self.domain.vars, self.n_out,
                                   self._fuse_requests,
                                   table_producer=table_producer,
                                   compute_dtype=dtype,
                                   precision=self.precision)

    def _generic_residual(self, params, X):
        u = make_ufn(self.apply_fn, params, self.domain.vars, self.n_out)
        return vmap_residual(self.f_model, u, self.domain.ndim)(X)

    def _count_residuals(self) -> int:
        """The number of residual components ``f_model`` returns (a system
        returns a tuple), from one point."""
        with torch.no_grad():
            out = self._generic_residual(self.net.params(),
                                         self.X_f[:1])
        return len(out) if isinstance(out, tuple) else 1

    def _crosscheck_fused(self, n_check: int = 32, residual_fn=None,
                          catch: bool = True):
        """Compare a fused residual engine (values AND the gradient of the
        squared residual w.r.t. the parameters) against the generic engine
        on a small sample of the collocation set; for ``fused="cuda"`` this
        runs K1 and K2.  Under ``fused_dtype`` the bands are the JAX
        solver's bf16 ones.  Returns ``(ok, reason)``; what running the
        engine raises is a reason too, unless ``catch`` is false."""
        from ..ops.fused import crosscheck_grads, crosscheck_residuals

        if residual_fn is None:
            residual_fn = self._fused_residual
        X_s = self.X_f[:min(n_check, int(self.X_f.shape[0]))]
        params = flat = self.net.params()

        def sumsq(out):
            comps = out if isinstance(out, tuple) else (out,)
            return sum(torch.sum(c ** 2) for c in comps)

        generic = self._generic_residual(params, X_s)
        # materialize: a residual that never reads the primal leaves the
        # head's bias out of the graph (its gradient is zero, as in JAX)
        g_gen = torch.autograd.grad(sumsq(generic), flat,
                                    materialize_grads=True)
        try:
            fused = residual_fn(params, X_s)
        except Exception as e:  # e.g. control flow on values in f_model
            if not catch:
                raise
            return False, e
        bf16 = self.fused_dtype is not None
        ok, reason = crosscheck_residuals(
            generic, fused, **(BF16_VALUE_BAND if bf16 else {}))
        if not ok:
            return ok, reason
        try:
            g_fus = torch.autograd.grad(sumsq(fused), flat,
                                        materialize_grads=True)
        except Exception as e:  # backward-only failure
            if not catch:
                raise
            return False, e
        return crosscheck_grads(g_gen, g_fus,
                                **(BF16_GRAD_BAND if bf16 else {}))

    def _try_minimax(self):
        """Build and cross-check the fused minimax loss term
        (:mod:`..ops.minimax`) and adopt it for the training loss when it
        qualifies and agrees with the generic loss.  Records the
        disqualifying reason in ``_minimax_fail_reason`` (raised from under
        ``minimax=True``).

        Only the residual disqualifies the step: an ``f_model`` that does
        not lower to K3's tape (one value per point per equation, within
        the kernel's caps) or a numeric mismatch.  Whatever running the
        step raises (on a CUDA solver: K3 does not build or launch) leaves
        ``compile`` as it is; the step is never handed to another
        engine."""
        from ..ops import minimax as mmx

        def decline(reason: Exception):
            self._minimax_fail_reason = reason
            if self.minimax is True:
                raise ValueError("minimax=True but the fused minimax engine "
                                 "cannot be adopted") from reason
            if self.verbose:
                print(f"[fuse] minimax engine not adopted ("
                      f"{type(reason).__name__}: {reason}); keeping the "
                      "unfused loss", flush=True)

        if self._causal_kw:
            return decline(ValueError(
                "causal weighting bins residuals across points; the "
                "per-point minimax fusion cannot serve it"))
        if self.remat:
            return decline(ValueError(
                "remat wraps the residual evaluation; the fused minimax "
                "loss already owns its memory layout"))
        shapes = [tuple(W.shape) for W, _ in self.net.layers()]
        try:
            # the lowering to K3's tape: a MinimaxLoweringError when the
            # f_model does not lower, or the plan's caps refuse the network
            sq = mmx.build_minimax_sq_fn(
                self.f_model, self.domain.vars, self.n_out,
                self._fuse_requests, shapes, device=self.device,
                compute_dtype=self.fused_dtype, precision=self.precision)
        except ValueError as e:
            return decline(e)
        mm = mmx.make_minimax_residual_loss(
            sq, weight_outside_sum=self.weight_outside_sum, g=self.g)
        # runs the step (K3 on a CUDA solver): whatever it raises leaves
        # compile as it is
        ok, why = self._crosscheck_minimax(mm)
        if not ok:
            mismatch = ValueError("minimax engine failed the numeric "
                                  "cross-check against the generic loss")
            mismatch.__cause__ = why
            return decline(mismatch)
        if self.fused == "autotune" and self.minimax is not True:
            # measured choice: the minimax step replaces the timed winner's
            # residual term, so it must beat that step, not only agree
            t_mm = self._time_loss_step(residual_loss_fn=mm)
            t_un = self._time_loss_step(residual_fn=self._fused_residual)
            self.autotune_report["minimax"] = {
                "minimax_ms": t_mm * 1e3, "unfused_ms": t_un * 1e3,
                "adopted": t_mm < t_un}
            if t_mm >= t_un:
                return decline(ValueError(
                    f"autotune: minimax step measured slower than the "
                    f"selected residual engine ({t_mm * 1e3:.3f} ms vs "
                    f"{t_un * 1e3:.3f} ms)"))
            if self.verbose:
                print(f"[autotune] minimax loss step: {t_mm * 1e3:.3f} ms "
                      f"vs unfused {t_un * 1e3:.3f} ms; adopting",
                      flush=True)
        self._minimax_loss = mm
        # the kernel follows the device, as the JAX solver takes Pallas
        # whenever a TPU is present
        self._minimax_kind = "cuda" if self.device.type == "cuda" else "plain"
        self._minimax_sq = sq
        self._minimax_n_eq = sq.n_equations
        self._minimax_loss_refine = mm
        if self.fused_dtype is not None:
            # the f32 flavor of the same step (K3 on the card), for the
            # L-BFGS leg's retreat
            sq32 = mmx.build_minimax_sq_fn(
                self.f_model, self.domain.vars, self.n_out,
                self._fuse_requests, shapes, device=self.device,
                precision=self.precision)
            self._minimax_loss_refine = mmx.make_minimax_residual_loss(
                sq32, weight_outside_sum=self.weight_outside_sum, g=self.g)
        if self.verbose:
            print(f"[fuse] minimax engine adopted ({self._minimax_kind}: "
                  "residual + SA-λ loss + cotangents in one step)",
                  flush=True)

    def _minimax_score_grad_fn(self):
        """``score_grad(layers, X) -> (scores [N], gX [N, d])`` for the
        ascent mover, from the adopted minimax step: one evaluation at
        w ≡ 1 (one K3 launch on the card) gives ``gw = f²`` per point and
        equation, summed into the scores, and ``gX``, the ascent direction.
        ``None`` when the step is not adopted (the mover then takes
        autograd over the residual: K1 + K2 on ``fused="cuda"``)."""
        sq = self._minimax_sq
        if sq is None:
            return None
        n_eq = int(sq.n_equations)

        from ..ops.taylor import extract_mlp_layers

        def score_grad(params, X):
            flat = [a if a.ndim == 2 else a.reshape(1, -1)
                    for pair in extract_mlp_layers(params) for a in pair]
            w = torch.ones((X.shape[0], n_eq), dtype=X.dtype, device=X.device)
            _, _, gw, gX = sq.value_and_grads(flat, w, X.contiguous())
            return torch.sum(gw.reshape(X.shape[0], -1), 1), gX

        return score_grad

    def _crosscheck_minimax(self, mm_loss, n_check: int = 32):
        """Compare the fused minimax loss term (value and gradients with
        respect to the parameters and λ) against the generic engine's
        residual term on a sample of the collocation set, at rtol 5e-3 (the
        JAX solver's bf16 bands under ``fused_dtype``: 5e-2 on the value,
        1.5e-1 with atol 1e-3 on the gradients).
        On a CUDA solver this launches K3, and a kernel that does not build
        or launch raises.  Returns ``(ok, reason)``."""
        from ..ops.fused import FusedMismatch, crosscheck_grads

        n_f = int(self.X_f.shape[0])
        n_s = min(n_check, n_f)
        X_s = self.X_f[:n_s]
        # residual-term-only losses (no BC terms), with assembly's own λ
        # semantics on both sides
        kw = dict(weight_outside_sum=self.weight_outside_sum, g=self.g,
                  device=self.device)
        gen = build_loss_fn(self.apply_fn, self.domain.vars, self.n_out,
                            self.f_model, [], **kw)
        mm = build_loss_fn(self.apply_fn, self.domain.vars, self.n_out,
                           self.f_model, [], residual_loss_fn=mm_loss, **kw)

        def val_grad(loss_fn):
            params = [t.detach().clone().requires_grad_(True)
                      for t in self.net.params()]
            lams = [None if lam is None else
                    (lam[:n_s] if lam.ndim >= 1 and lam.shape[0] == n_f
                     else lam).detach().clone().requires_grad_(True)
                    for lam in self.lambdas["residual"]]
            val = loss_fn(params, [], lams, X_s)[0]
            leaves = params + [lam for lam in lams if lam is not None]
            return float(val.detach()), torch.autograd.grad(
                val, leaves, materialize_grads=True)

        v_m, g_m = val_grad(mm)
        v_g, g_g = val_grad(gen)
        bf16 = self.fused_dtype is not None
        rtol = BF16_VALUE_BAND["rtol"] if bf16 else 5e-3
        if not (abs(v_m - v_g) <= 1e-5 + rtol * abs(v_g)):  # NaN-safe form
            return False, FusedMismatch(
                f"minimax loss value {v_m:.6e} disagrees with the generic "
                f"engine's {v_g:.6e}")
        return crosscheck_grads(g_g, g_m, **(BF16_GRAD_BAND if bf16 else {}))

    def _time_loss_step(self, residual_fn=None, residual_loss_fn=None,
                        reps: int = 3) -> float:
        """Seconds per loss-and-gradient step of the full training loss
        with the given residual flavor, over the collocation set: the
        measurement every ``fused="autotune"`` candidate and the minimax
        race take.  On the card it times what ``fit`` will run, replays of
        the step captured as a CUDA graph, by CUDA events (the warm-ups
        and the capture are not timed; the graph is freed on return);
        eager steps there are host-bound and would choose by the host's
        overhead.  On the CPU it times eager steps after one warm-up."""
        import time

        from ..training.graphs import StepGraph

        loss_fn = build_loss_fn(
            self.apply_fn, self.domain.vars, self.n_out, self.f_model,
            self.bcs, weight_outside_sum=self.weight_outside_sum, g=self.g,
            data_X=self.data_X, data_s=self.data_s, residual_fn=residual_fn,
            residual_loss_fn=residual_loss_fn, remat=self.remat,
            device=self.device, **self._causal_kw)
        params = [t.detach().clone().requires_grad_(True)
                  for t in self.net.params()]
        lam = {k: [None if v is None else v.detach() for v in vs]
               for k, vs in self.lambdas.items()}
        lam_data = lam.get("data", [None])[0]
        grads = [torch.zeros_like(p) for p in params]
        total_buf = torch.zeros((), device=self.device)

        def step():
            total = loss_fn(params, lam["BCs"], lam["residual"], self.X_f,
                            lam_data=lam_data)[0]
            gs = torch.autograd.grad(total, params, materialize_grads=True)
            with torch.no_grad():
                for g_buf, g in zip(grads, gs):
                    g_buf.copy_(g)
                total_buf.copy_(total.detach())

        def keyed():
            return (params + grads + [total_buf, self.X_f]
                    + [v for vs in lam.values() for v in vs if v is not None])

        if self.device.type != "cuda":
            step()  # warm-up
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            return (time.perf_counter() - t0) / reps
        graph = StepGraph(step, keyed, self.device, "autotune step")
        graph.prime()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps

    def _autotune_engine(self):
        """``fused="autotune"``: time one graphed loss-and-gradient step per
        residual engine on the collocation set (:meth:`_time_loss_step`)
        and return the fastest engine's residual (``None``: the generic
        engine).  The candidates are ``"generic"``, ``"fused"`` (the plain
        flavor, already cross-checked) and, on a CUDA solver, ``"cuda"``
        (the K1/K2 table, the counterpart of the JAX package's Pallas
        tiles) behind a cross-check of its own over 257 points (more than
        two of the kernels' 128-row tiles).  A candidate whose numbers
        disagree there is excluded and recorded; whatever building,
        checking or timing the ``"cuda"`` candidate raises (K1/K2 do not
        build or launch; the plain flavor already ran this ``f_model``)
        propagates, and training never moves off the kernels quietly.  A
        ``"generic"`` or ``"fused"`` candidate that fails to run is recorded
        in the failures, as in the JAX package.  ``autotune_report`` keeps
        the times, the choice, the exclusions and failures."""
        from ..ops.cuda_taylor import BLOCK_ROWS

        report = self.autotune_report
        candidates = {"generic": None, "fused": self._fused_residual}
        kinds = {"generic": None, "fused": "plain", "cuda": "cuda"}
        if self.device.type == "cuda":
            res = self._fused_flavor("cuda")
            ok, reason = self._crosscheck_fused(
                n_check=2 * BLOCK_ROWS + 1, residual_fn=res, catch=False)
            if ok:
                candidates["cuda"] = res
            else:
                report["excluded"]["cuda"] = reason
                if self.verbose:
                    print(f"[autotune] cuda excluded ({type(reason).__name__}"
                          f": {reason})", flush=True)
        for name, res in candidates.items():
            try:
                report["timings_ms"][name] = 1e3 * self._time_loss_step(
                    residual_fn=res)
            except Exception as e:  # a candidate that cannot run
                if name == "cuda":  # K1/K2 do not launch or capture
                    raise
                report["failures"][name] = e
        timings = report["timings_ms"]
        if not timings:
            raise AutotuneFailure(report["failures"])
        best = min(timings, key=timings.get)
        report["choice"] = best
        if self.verbose:
            shown = ", ".join(f"{k}={v:.3f}ms" for k, v in timings.items())
            for k, e in report["failures"].items():
                shown += f", {k}=FAILED({type(e).__name__})"
            print(f"[autotune] residual engine: {best} ({shown})", flush=True)
        self._fused_kind = kinds[best]
        return candidates[best]

    def _set_causal_eps(self, eps: float):
        """Advance the causal ε (the annealing ladder): written into the
        device scalar the loss reads, so no step is rebuilt or captured
        again."""
        self.causal_eps = float(eps)
        self._causal_kw["causal_eps"].fill_(float(eps))

    def _build(self):
        self.autotune_report = {"timings_ms": {}, "failures": {},
                                "excluded": {}, "choice": None,
                                "minimax": None}
        self._fused_residual = (self._try_fuse() if self.fused is not False
                                else None)
        if self.fused in (True, "cuda") and self._fused_residual is None:
            msg = ("fused=%r but the residual cannot be fused: it requires "
                   "the standard float32 tanh MLP (this network: %s) and an "
                   "f_model using "
                   "grad() combinators on untransformed coordinates with "
                   "derivative orders <= 3 (or unmixed 4th)"
                   % (self.fused, self._net_description()))
            reason = getattr(self, "_fuse_fail_reason", None)
            if reason is not None:
                raise ValueError(f"{msg}; analysis stopped on: "
                                 f"{type(reason).__name__}: {reason}") \
                    from reason
            raise ValueError(msg)
        if self._fused_residual is not None:
            ok, reason = self._crosscheck_fused()
            if not ok:
                if self.fused in (True, "cuda"):
                    raise ValueError(
                        "fused residual failed the numeric cross-check "
                        "against the generic engine") from reason
                self._fuse_fail_reason = reason
                self._fused_residual = None
                self._fused_kind = None
                if self.verbose:
                    print(f"[fuse] cross-check failed ({type(reason).__name__}"
                          f": {reason}); using the generic autodiff engine",
                          flush=True)
        if self.fused == "autotune":
            if self._fused_residual is not None:
                self._fused_residual = self._autotune_engine()
            elif self.verbose:
                print("[autotune] fused engine excluded; only the generic "
                      "engine was considered", flush=True)
        if self.fused_dtype is not None and self._fused_residual is None:
            warnings.warn(
                "fused_dtype was requested but no fused engine is active "
                "(the residual fell back to the generic autodiff engine); "
                "training runs full precision")
        # the L-BFGS leg's retreat: the f32 flavor of the adopted engine
        self._refine_residual = self._fused_residual
        if self.fused_dtype is not None and self._fused_residual is not None:
            self._refine_residual = self._fused_flavor(self._fused_kind,
                                                       f32=True)
        # the fused minimax step replaces the training loss's residual term
        # when it qualifies, behind the same numeric cross-check discipline
        self._minimax_loss = None
        self._minimax_loss_refine = None
        self._minimax_kind = None
        self._minimax_sq = None
        self._minimax_n_eq = 1
        self._minimax_fail_reason = None
        if self.minimax is not False:
            if self._fused_residual is not None:
                self._try_minimax()
            else:
                reason = getattr(self, "_fuse_fail_reason", None)
                why = ValueError(
                    "the fused minimax step needs the fused residual engine "
                    "(the standard float32 tanh MLP and an analysable "
                    "f_model, fused != False)")
                why.__cause__ = reason
                self._minimax_fail_reason = why
                if self.minimax is True:
                    detail = ("" if reason is None else
                              f"; analysis stopped on: "
                              f"{type(reason).__name__}: {reason}")
                    raise ValueError(f"minimax=True: {why}{detail}") \
                        from reason
        self._residual = self._fused_residual or self._generic_residual
        loss_kw = dict(weight_outside_sum=self.weight_outside_sum, g=self.g,
                       data_X=self.data_X, data_s=self.data_s,
                       remat=self.remat, device=self.device,
                       **self._causal_kw)
        self.loss_fn = build_loss_fn(
            self.apply_fn, self.domain.vars, self.n_out, self.f_model,
            self.bcs, residual_fn=self._fused_residual,
            residual_loss_fn=self._minimax_loss, **loss_kw)
        # the f32 loss of the L-BFGS leg's retreat (the training loss
        # itself without fused_dtype)
        self.loss_fn_refine = self.loss_fn
        if (self._refine_residual is not self._fused_residual
                or self._minimax_loss_refine is not self._minimax_loss):
            self.loss_fn_refine = build_loss_fn(
                self.apply_fn, self.domain.vars, self.n_out, self.f_model,
                self.bcs, residual_fn=self._refine_residual,
                residual_loss_fn=self._minimax_loss_refine, **loss_kw)
        self._ntk_fn = None
        if self.use_ntk:
            from ..ops.ntk import build_error_fns, make_ntk_weight_fn
            n_res = len(self.lambdas["residual"])
            bc_fns, res_all_fn, data_fn = build_error_fns(
                self.apply_fn, self.domain.vars, self.n_out, self.f_model,
                self.bcs, self.X_f, n_residuals=n_res,
                max_points=self.ntk_max_points, data_X=self.data_X,
                data_s=self.data_s)
            self._ntk_fn = make_ntk_weight_fn(bc_fns, res_all_fn, n_res,
                                              data_fn=data_fn,
                                              max_ratio=self.ntk_max_ratio)
            if data_fn is not None and "data" not in self.lambdas:
                self.lambdas["data"] = [torch.ones((), device=self.device)]

    @property
    def engine(self) -> str:
        """``"fused-minimax-cuda"`` or ``"fused-minimax"`` when the
        minimax step is adopted, else ``"fused-cuda"``, ``"fused"`` or
        ``"generic"``."""
        if self._minimax_kind is not None:
            return ("fused-minimax-cuda" if self._minimax_kind == "cuda"
                    else "fused-minimax")
        if self._fused_residual is None:
            return "generic"
        return "fused-cuda" if self._fused_kind == "cuda" else "fused"

    # ------------------------------------------------------------------ #
    def compile_data(self, x, t, y):
        """Register observation data for assimilation (reference
        ``models.py:107-114``; here a real ``Data`` loss term)."""
        if not self.assimilate:
            raise ValueError(
                "Assimilate needs to be set to 'true' for data assimilation. "
                "Re-initialize CollocationSolverND with assimilate=True.")
        if isinstance(x, (list, tuple)):
            x = np.hstack([np.reshape(c, (-1, 1)) for c in x])
        else:
            x = np.reshape(np.asarray(x), (np.shape(np.ravel(x))[0] //
                                           max(self.domain.ndim - 1, 1), -1))
        t = np.reshape(t, (-1, 1))
        if x.shape[0] != t.shape[0]:
            raise ValueError(
                f"compile_data: {x.shape[0]} spatial rows vs {t.shape[0]} "
                "time rows")
        self.data_X = np.hstack([x, t]).astype(np.float32)
        self.data_s = np.reshape(y, (-1, self.n_out)).astype(np.float32)
        if self._compiled:
            with matmul_precision(self.precision):
                self._build()

    # ------------------------------------------------------------------ #
    def update_loss(self):
        """Current composite loss and components on the full collocation set,
        as values (no autograd graph, as the JAX package returns arrays): a
        graph kept alive by the caller would hold the parameters' gradient
        accumulators of the current stream, and the next capture of the
        Adam step on the card would fail on them."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before update_loss()")
        with matmul_precision(self.precision), torch.no_grad():
            return self.loss_fn(self.net.params(), self.lambdas["BCs"],
                                self.lambdas["residual"], self.X_f,
                                lam_data=self.lambdas.get("data", [None])[0])

    def fit(self, tf_iter: int = 0, newton_iter: int = 0,
            newton_eager: Optional[bool] = None, chunk: int = 100,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            batch_sz: Optional[int] = None,
            grad_clip: Optional[float] = None,
            resample_every: int = 0, resample_pool: int = 4,
            resample_temp: float = 1.0, resample_uniform: float = 0.1,
            resample_seed: int = 0, resample_device: Optional[bool] = None,
            resample_mode: str = "pool", resample_ascent_steps: int = 5,
            profile_dir: Optional[str] = None,
            eval_fn: Optional[Callable] = None, eval_every: int = 0,
            telemetry=None, _graphs: bool = True):
        """Adam with SA-λ ascent, then L-BFGS refinement (reference
        ``models.py:227`` → ``fit.py:17-102``).

        ``tf_iter`` Adam epochs run in chunks of ``chunk`` with no host
        synchronisation inside a chunk; the loss history (``self.losses``)
        gets one component dict per epoch.  On a CUDA solver each Adam step,
        each L-BFGS evaluation and two-loop sweep, and each fixed-step
        L-BFGS iteration is a replayed CUDA graph
        (:mod:`~..training.graphs`); on a CPU solver the same steps run
        eagerly.

        ``batch_sz``: minibatching as in the JAX solver on one device: every
        epoch runs all ``ceil(N_f / batch_sz)`` batches (the tail wraps to
        the front of the set), per-point λ rows are gathered with their
        points, and the history records each epoch's last batch.
        ``grad_clip``: global-norm clipping of the network's gradient ahead
        of its Adam and, separately, of the λ gradient ahead of their
        ascent (``optax.clip_by_global_norm``); turning it on or off
        restarts the Adam moments, as the JAX solver's optimizer-state
        check does.  ``newton_iter`` L-BFGS
        iterations then refine the network parameters on the same loss with
        the λ frozen (:func:`~..training.lbfgs.fit_lbfgs`): with the zoom
        line search by default, with the reference's fixed step of 0.8 for
        ``newton_eager=True``.  The history gets one ``{"Total Loss": v}``
        per iteration, ``newton_done`` counts the iterations that ran (also
        across checkpoint restores), and the best iterate of each phase is
        kept; ``predict(best_model=True)`` takes the better one.

        ``checkpoint_dir`` + ``checkpoint_every``: :meth:`save_checkpoint`'s
        full state, saved when a chunk boundary crosses a
        ``checkpoint_every`` boundary, in both phases; during L-BFGS it
        carries the current iterate and the absolute ``newton_done``.  A
        killed run resumes by compiling the same configuration,
        :meth:`restore_checkpoint`, and ``fit`` with what is left of the
        budget.

        ``resample_every`` (:mod:`..ops.resampling`): every that many Adam
        epochs, at a chunk boundary, the N_f collocation points are redrawn
        (never at the phase's last boundary); L-BFGS refines on the final
        set.  ``resample_device=None``/``True`` (the default): the device
        redraw, dispatched at one boundary on a stream of its own and
        swapped in at the next, written into the step's buffers, so the
        Adam step's CUDA graph replays on without a new capture; a redraw
        still pending at the phase's end is discarded.
        ``resample_mode="pool"``: ``[X_f ; (resample_pool - 1)·N_f fresh
        stratified points]`` scored by the residual engine (one K1 launch
        on ``fused="cuda"``), ``N_f`` rows kept by Gumbel top-k under ``p ∝
        |f|^resample_temp`` with a ``resample_uniform`` floor; kept rows
        carry their per-point λ, fresh rows start at the kept mean, and the
        λ-ascent moments follow with fresh rows at zero.
        ``resample_mode="ascent"``: the PACMANN mover,
        ``resample_ascent_steps`` normalized-gradient steps up ``Σ f²``
        (clipped to the domain box; scores and direction from one K3
        launch at w ≡ 1 when the minimax step is adopted), then the
        ``resample_uniform``·N_f lowest-score rows are replaced by a
        stratified draw; moved rows keep their λ.  ``resample_device=
        False``: the host path (NumPy LHS pool, host scores, synchronous);
        it raises :class:`ValueError` under per-point λ (its pool is all
        fresh) and with ``resample_mode="ascent"``.  Draws are seeded by
        ``(resample_seed, epoch)``, the epoch counted from the epochs
        already trained.  ``self.redraws`` gets one record per redraw
        (:func:`~..training.fit.fit_adam`).

        ``profile_dir``: the whole call runs under
        :func:`~..profiling.trace`, which writes a Chrome trace of it there
        (``torch.profiler``, CUDA activity included: every kernel launch and
        graph replay).

        ``eval_fn(phase, step, params)`` + ``eval_every``: periodic
        evaluation inside one continuous run (rel-L2 timelines), called at
        the chunk boundaries of both phases that cross an ``eval_every``
        boundary: ``("adam", epoch, layers)`` with the run-relative epoch,
        and ``("l-bfgs", iteration, params)`` with the iteration of this
        leg; ``params`` is the network's structure (:attr:`params`), which
        ``apply_fn`` takes.
        It runs between chunks, so the captured steps never wait for it.

        ``telemetry``: a :class:`~..telemetry.TrainingTelemetry` or a bare
        :class:`~..telemetry.RunLogger` (wrapped with defaults).  The run
        emits its config, per-epoch loss components with the gradient
        global-norm (``"Grad_norm"`` in ``losses``: the Adam step that
        records it is captured once, apart from the plain one), SA-λ
        summaries, the step-time split of both phases, redraws
        (``resample.*``), checkpoint writes and the cost gauges (an
        analytic basis, ``"analytic-minimax"`` on the minimax step); the
        NaN/Inf sentinel raises :class:`~..telemetry.TrainingDiverged`.

        ``_graphs=False`` runs every step eagerly: the referee the graphs
        are held to on the card, not an option of the training run."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before fit(...)")
        if profile_dir is not None:
            from ..profiling import trace
            with trace(profile_dir):
                return self.fit(
                    tf_iter=tf_iter, newton_iter=newton_iter,
                    newton_eager=newton_eager, chunk=chunk,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every, batch_sz=batch_sz,
                    grad_clip=grad_clip, resample_every=resample_every,
                    resample_pool=resample_pool, resample_temp=resample_temp,
                    resample_uniform=resample_uniform,
                    resample_seed=resample_seed,
                    resample_device=resample_device,
                    resample_mode=resample_mode,
                    resample_ascent_steps=resample_ascent_steps,
                    eval_fn=eval_fn, eval_every=eval_every,
                    telemetry=telemetry, _graphs=_graphs)
        from ..telemetry import as_training_telemetry
        tele = as_training_telemetry(telemetry)
        epochs_at_entry = len(self.losses)
        if tele is not None:
            self._telemetry_start(tele, tf_iter, newton_iter, batch_sz,
                                  resample_every, epochs_at_entry)
        if self.verbose:
            from ..output import print_screen
            print_screen(self)
            print(f"[fit] engine={self.engine} device={self.device} "
                  f"N_f={int(self.X_f.shape[0])} tf_iter={tf_iter} "
                  f"newton_iter={newton_iter}", flush=True)
        newton_prior = int(self.newton_done)
        save = None
        if checkpoint_dir is not None and checkpoint_every > 0:
            def save(layers, newton_done, live):
                self._save_state(checkpoint_dir, layers, newton_done, live)
                if tele is not None:
                    # absolute: the restored history's epochs counted in
                    tele.on_checkpoint(live[0], int(newton_done)
                                       if live[0] == "l-bfgs"
                                       else len(self.losses))

        resample_fn = None
        if resample_every > 0:
            resample_fn = self._resample_hook(
                resample_pool, resample_temp, resample_uniform,
                resample_seed, resample_device, resample_mode,
                resample_ascent_steps)

        if tf_iter > 0:
            params = self.net.params()
            if self._opt is None or (grad_clip is None) != (
                    self._opt_grad_clip is None):
                self._opt = make_optimizer(params, self.lambdas, self.lr,
                                           self.lr_weights,
                                           freeze_lambdas=self.use_ntk)
            self._opt_grad_clip = grad_clip
            eager = not _graphs
            grad_norm = tele is not None and tele.grad_norm
            if self._adam is None or not self._adam.matches(
                    self.loss_fn, self._opt, self.X_f, batch_sz, grad_clip,
                    eager, grad_norm):
                self._adam = AdamStep(self.loss_fn, params, self.lambdas,
                                      self.X_f, self._opt, batch_sz=batch_sz,
                                      grad_clip=grad_clip,
                                      verbose=self.verbose, eager=eager,
                                      grad_norm=grad_norm)
            ntk_update = self._ntk_update(resample_fn is not None)
            adam_eval = None
            if eval_fn is not None:
                def adam_eval(epoch, params):
                    eval_fn("adam", epoch, self.net.param_tree(params))
            hook = None
            if save is not None:
                def hook(epoch, best):
                    save(self.net.params(), newton_prior,
                         ("adam", best[0], best[1], best[2]))
            # the causal ε ladder (Wang et al. 2203.07404, Alg. 1): Adam at
            # each ε in ascending order, the next once the gate opens (min
            # Causal_w_last > causal_delta at a chunk boundary); the epochs
            # left, the parameters, λ and the moments carry over, and the
            # same step (and graph) serves every stage
            ladder = list(self.causal_ladder)
            stages = ladder if len(ladder) > 1 else [None]
            multi_stage = len(stages) > 1
            self._ladder_active = multi_stage
            result = FitResult(losses=self.losses)
            remaining, stage_off, stage_epochs = tf_iter, 0, 0
            wall = 0.0
            for si, eps in enumerate(stages):
                if eps is not None and eps != self.causal_eps:
                    if self.verbose:
                        why = "ladder restart" if si == 0 else "gate open"
                        print(f"[causal] {why}: eps -> {eps:g} ({remaining} "
                              "Adam epochs left)", flush=True)
                    self._set_causal_eps(eps)
                stop_fn = None
                if si < len(stages) - 1:
                    def stop_fn(res, _d=self.causal_delta):
                        last = res.losses[-1] if res.losses else {}
                        w = [v for k, v in last.items()
                             if k.startswith("Causal_w_last")]
                        return bool(w) and min(w) > _d
                epochs_before = len(result.losses)
                if tele is not None:
                    # run-relative: the restored history and the epochs
                    # earlier ε stages trained in this call
                    tele.epoch_offset = epochs_at_entry + stage_off
                with matmul_precision(self.precision):
                    result = fit_adam(self._adam, remaining, chunk=chunk,
                                      verbose=self.verbose, result=result,
                                      state_hook=hook,
                                      state_hook_every=checkpoint_every,
                                      resample_fn=resample_fn,
                                      resample_every=resample_every,
                                      lambda_update_fn=ntk_update,
                                      stop_fn=stop_fn,
                                      epoch_offset=stage_off,
                                      callback=adam_eval,
                                      callback_every=eval_every,
                                      telemetry=tele)
                wall += result.wall_time["adam"]
                stage_epochs = len(result.losses) - epochs_before
                remaining -= stage_epochs
                stage_off += stage_epochs
                if remaining <= 0:
                    break
            result.wall_time["adam"] = wall
            for rec in self.ntk_updates:  # fit_adam synchronised the card
                events = rec.pop("events", None)
                if events is not None:
                    rec["device_ms"] = events[0].elapsed_time(events[1])
            if multi_stage and result.best_epoch["adam"] >= 0:
                # stages weigh the residual by different ε: the last
                # (strictest) stage's best is the run's, at its epoch
                result.best_epoch["adam"] += stage_off - stage_epochs
            self.wall_time = result.wall_time
            self.redraws.extend(result.redraws)
            self._adam_result = result  # its chunk_seconds, for timing
            # losses on other point sets or ε stages do not compare: under
            # resampling or a ladder this leg's best wins, as in the JAX
            # solver
            if (self.best_model["adam"] is None or resample_fn is not None
                    or multi_stage
                    or result.min_loss["adam"] <= self.min_loss["adam"]):
                self.best_model["adam"] = self.net.param_tree(
                    result.best_params["adam"])
                self.min_loss["adam"] = result.min_loss["adam"]
                self.best_epoch["adam"] = result.best_epoch["adam"]

        if newton_iter > 0:
            # one callback serves the checkpoint and the evaluation hooks,
            # each at its own cadence: fit_lbfgs fires at chunk boundaries
            # that cross the smaller one, and each hook fires on crossing
            # its own (the JAX solver's lb_callback)
            evals = eval_every if eval_fn is not None else 0
            saves = checkpoint_every if save is not None else 0
            lb_every = min((v for v in (evals, saves) if v > 0), default=0)
            lb_prev = {"i": 0}
            callback = None
            if lb_every > 0:
                def callback(done, params, best):
                    prev, lb_prev["i"] = lb_prev["i"], done
                    # checkpoint before the evaluation, as in the Adam leg
                    if saves and prev // saves != done // saves:
                        # the live best counts iterations within this leg:
                        # re-based to absolute beside the absolute
                        # newton_done
                        save(params, newton_prior + done,
                             ("l-bfgs", best[0], best[1],
                              newton_prior + best[2]))
                    if evals and prev // evals != done // evals:
                        eval_fn("l-bfgs", done, self.net.param_tree(params))
            # under fused_dtype the leg starts on the bf16 loss and
            # retreats to the f32 one when its line search stagnates, as
            # in the JAX solver
            fallback = (self.loss_fn_refine
                        if self.loss_fn_refine is not self.loss_fn else None)
            (final, best_params, best_loss, best_iter, history,
             self.lbfgs_retreat) = fit_lbfgs(
                self.loss_fn, self.net.params(), self.lambdas, self.X_f,
                maxiter=newton_iter, verbose=self.verbose,
                eager=bool(newton_eager), callback=callback,
                callback_every=lb_every, iter0=newton_prior,
                loss_fn_fallback=fallback, telemetry=tele,
                precision=self.precision, _graphs=_graphs)
            self.net.load_params(final)
            self.losses.extend(history)
            if tele is not None:
                # absolute refinement iterations; a NaN stop logs a
                # divergence event (the leg already kept its best iterate)
                tele.epoch_offset = 0
                tele.on_lbfgs_history([d["Total Loss"] for d in history],
                                      start_iter=newton_prior)
            # adopt-if-better, as in the Adam phase: a resumed leg keeps a
            # restored best that is better
            if (self.best_model["l-bfgs"] is None
                    or best_loss <= self.min_loss["l-bfgs"]):
                self.best_model["l-bfgs"] = self.net.param_tree(
                    [t.clone() for t in best_params])
                self.min_loss["l-bfgs"] = best_loss
                self.best_epoch["l-bfgs"] = newton_prior + best_iter
            # the iterations that ran, not the budget: the loop may stop
            # early, and a resume must not skip refinement that never ran
            self.newton_done = newton_prior + len(history)

        # the overall best (reference fit.py:95-102); a phase without a
        # snapshot (skipped by a resumed fit) never wins
        adam_ok = self.best_model["adam"] is not None
        lbfgs_ok = self.best_model["l-bfgs"] is not None
        if adam_ok and (not lbfgs_ok
                        or self.min_loss["adam"] <= self.min_loss["l-bfgs"]):
            which, offset = "adam", 0
        else:
            which, offset = "l-bfgs", tf_iter
        self.min_loss["overall"] = self.min_loss[which]
        self.best_epoch["overall"] = self.best_epoch[which] + offset
        self.best_model["overall"] = self.best_model[which]
        if tele is not None:
            tele.on_fit_end(dict(
                epochs_total=len(self.losses),
                newton_done=int(self.newton_done),
                min_loss={k: float(v) for k, v in self.min_loss.items()},
                best_epoch={k: int(v) for k, v in self.best_epoch.items()},
                wall_adam=float(getattr(self, "wall_time", {}).get(
                    "adam", 0.0)) if tf_iter > 0 else 0.0))
        return self

    def _telemetry_start(self, tele, tf_iter, newton_iter, batch_sz,
                         resample_every, epochs_at_entry):
        """Prime a fit's telemetry: the analytic price of one Adam step
        (the floor over the step's batch; on the minimax step its
        channel-exact count, basis ``"analytic-minimax"``) and the
        ``run_config`` event."""
        from ..ops.minimax import n_channels
        from ..telemetry.costmodel import (analytic_minimax_flops,
                                           analytic_step_floor)
        n_f = int(self.X_f.shape[0])
        points = n_f if batch_sz is None else min(int(batch_sz), n_f)
        tele.cost_floor = analytic_step_floor(points, self.layer_sizes)
        if self._minimax_kind is not None:
            tele.cost_fallback = (
                analytic_minimax_flops(self.layer_sizes, points,
                                       n_channels(self._fuse_requests),
                                       n_equations=self._minimax_n_eq),
                "analytic-minimax")
        tele.on_fit_start(dict(
            tf_iter=tf_iter, newton_iter=newton_iter, batch_sz=batch_sz,
            N_f=n_f, layer_sizes=list(self.layer_sizes),
            Adaptive_type=self.Adaptive_type, dist=False,
            engine=self.engine, resample_every=resample_every,
            causal_ladder=list(self.causal_ladder),
            prior_epochs=epochs_at_entry,
            prior_newton=int(self.newton_done)))

    def _ntk_update(self, resampling: bool):
        """``fit_adam``'s ``lambda_update_fn`` under NTK weighting (else
        ``None``): the weights from :mod:`..ops.ntk` at the live
        parameters, on the build-time trace points or, under resampling,
        on the live collocation set's subsample, so the balance follows
        each redraw.  Each update leaves a record in ``ntk_updates``: host
        seconds, device ms (CUDA events; ``None`` on the CPU) and the
        weights."""
        if self._ntk_fn is None:
            return None
        import time

        from ..ops.ntk import residual_subsample
        cuda = self.device.type == "cuda"

        def update(params):
            t0 = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            X_sub = (residual_subsample(self.X_f, self.ntk_max_points)
                     if resampling else None)
            new = self._ntk_fn([t.detach() for t in params], X_sub)
            rec = {"host_s": time.perf_counter() - t0, "device_ms": None,
                   "weights": new}
            if cuda:
                end.record()
                rec["events"] = (start, end)
            self.ntk_updates.append(rec)
            return new

        return update

    def _resample_hook(self, pool, temp, uniform, seed, device, mode,
                       ascent_steps):
        """The ``fit_adam`` resample hook for ``fit``'s ``resample_*``
        options, with the JAX solver's validation."""
        from ..ops import resampling as rs

        n_f = int(self.X_f.shape[0])
        per_point = any(lam is not None and lam.ndim >= 1
                        and lam.shape[0] == n_f
                        for lam in self.lambdas["residual"])
        uniform_frac = max(float(uniform),
                           float(self._resample_uniform_floor or 0.0))
        # fit_adam counts this call's epochs from 0: offset by the epochs
        # already trained, so a warm restart explores new pools
        epoch_offset = len(self.losses)
        xlimits = self.domain.xlimits
        if mode not in ("pool", "ascent"):
            raise ValueError(
                f"resample_mode={mode!r}: expected 'pool' (pool→top-k "
                "redraw) or 'ascent' (PACMANN gradient mover)")
        if mode == "ascent":
            if device is False:
                raise ValueError(
                    "resample_mode='ascent' is device-resident by "
                    "construction (the mover is a gradient program on the "
                    "solver's device); it has no host path — drop "
                    "resample_device=False")
            sampler = rs.AscentResampler(
                self._residual, xlimits, n_f, n_steps=ascent_steps,
                fresh_frac=uniform_frac, seed=seed,
                score_grad_fn=self._minimax_score_grad_fn())
            return _DeviceResampleHook(sampler, epoch_offset,
                                       self.layer_sizes)
        if device is not False:
            sampler = rs.DeviceResampler(
                self._residual, xlimits, n_f, pool_factor=pool, temp=temp,
                uniform_frac=uniform_frac, seed=seed)
            return _DeviceResampleHook(sampler, epoch_offset,
                                       self.layer_sizes)
        if per_point:
            raise ValueError(
                "resample_device=False (the host-path redraw) is "
                "incompatible with per-point residual λ (Adaptive_type=1): "
                "the host pool is entirely fresh, so trained λ rows have no "
                "points to ride.  Use the device path (resample_device="
                "None/True, the default), which keeps the current points in "
                "the pool and carries kept rows' λ through the redraw.")
        base = rs.make_residual_resampler(
            self._residual, xlimits, n_f, pool_factor=pool, temp=temp,
            uniform_frac=uniform_frac, seed=seed, device=self.device)

        def resample(layers, epoch):
            return base(layers, epoch + epoch_offset)

        return resample

    # ------------------------------------------------------------------ #
    @staticmethod
    def _opt_tree(opts) -> dict:
        """The Adam pair's states as ``{"net": [...], "lam": [...]}``, one
        ``{"exp_avg", "exp_avg_sq", "step"}`` per parameter (zeros for a
        parameter that has not stepped: the same as a fresh moment)."""
        tree = {}
        for name, opt in zip(("net", "lam"), opts):
            if opt is None:
                continue
            entries = []
            for p in opt.param_groups[0]["params"]:
                st = opt.state.get(p, {})
                entries.append({
                    "exp_avg": st.get("exp_avg", torch.zeros_like(p)),
                    "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p)),
                    "step": st.get("step", torch.zeros(()))})
            tree[name] = entries
        return tree

    def _state_and_meta(self, layers, newton_done: int, live=None):
        """The checkpoint's state tree and meta (the JAX solver's keys).
        ``layers`` are the parameters (flat, or the network's structure);
        ``live = (phase, best_params, best_loss, best_iter)`` is the running
        best of a phase in progress, which competes with the stored phase
        bests for the saved best iterate."""
        state = {"params": self._tree(layers),
                 "lambdas": self.lambdas}
        buffers = net_buffers(self.net)
        if buffers:
            state["net_buffers"] = buffers
        if self._opt is not None:
            state["opt_state"] = self._opt_tree(self._opt)
        state["X_f"] = self.X_f
        min_loss = {k: float(v) for k, v in self.min_loss.items()}
        best_epoch = dict(self.best_epoch)
        cand = []
        if live is not None:
            phase, bp, bl, bi = live
            bl, bi = float(bl), int(bi)
            if np.isfinite(bl):
                cand.append((bl, bi, phase, bp))
                if bl < min_loss.get(phase, np.inf):
                    min_loss[phase], best_epoch[phase] = bl, bi
        phases = ("adam", "l-bfgs") if live is not None else \
            ("adam", "l-bfgs", "overall")
        for ph in phases:
            if ph == "adam" and live is not None and live[0] == "adam" \
                    and self._ladder_active:
                # mid-ladder: a stored Adam best carries another ε stage's
                # loss scale; the live (current stage's) best competes
                continue
            bp = self.best_model.get(ph)
            if bp is not None and np.isfinite(float(self.min_loss[ph])):
                cand.append((float(self.min_loss[ph]),
                             int(self.best_epoch[ph]), ph, bp))
        meta = {"losses": self.losses,
                "min_loss": min_loss,
                "best_epoch": best_epoch,
                "newton_done": int(newton_done),
                "has_opt_state": self._opt is not None,
                "has_net_buffers": bool(buffers),
                "has_X_f": True,
                "n_f": int(self.X_f.shape[0]),
                "grad_clip": self._opt_grad_clip,
                "resample_uniform_floor": float(
                    self._resample_uniform_floor or 0.0)}
        if cand:
            # the lowest loss; ties go to the first candidate (the live
            # best) or, in a plain save, to the phase bucket before
            # "overall", which mirrors one of them
            bl, bi, ph, bp = min(cand, key=lambda c: c[0])
            state["best_params"] = self._tree(bp)
            meta.update(has_best=True, best_phase=ph, best_loss=bl,
                        best_iter=bi)
        return state, meta

    def _save_state(self, path, layers, newton_done, live=None,
                    sharded=None):
        from ..checkpoint import save_checkpoint
        state, meta = self._state_and_meta(layers, newton_done, live)
        save_checkpoint(path, state, meta, sharded=sharded)

    def save_checkpoint(self, path: str, sharded: Optional[bool] = None):
        """Checkpoint the full training state under the directory ``path``
        (:mod:`..checkpoint`): the parameters, the SA λ, both Adam states
        (moments and step counts), the collocation set, the loss history,
        ``min_loss``, ``best_epoch``, ``newton_done`` and the best iterate.
        ``sharded=True`` (the multi-process layout) is not ported."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before save_checkpoint")
        self._save_state(path, self.net.params(), self.newton_done,
                         sharded=sharded)

    def restore_checkpoint(self, path: str):
        """Restore a :meth:`save_checkpoint` state into this solver, which
        must be compiled with the same configuration (else
        :class:`~..checkpoint.TemplateMismatch`).  Everything lands on the
        solver's device; the best iterate is re-bucketed by its phase and
        mirrored into ``"overall"``."""
        if not self._compiled:
            raise NotCompiledError(
                "Call compile(...) before restore_checkpoint")
        from ..checkpoint import resolve_checkpoint_dir, restore_checkpoint
        with open(os.path.join(resolve_checkpoint_dir(path),
                               "tdq_meta.json")) as fh:
            peek = json.load(fh)["meta"]
        params = self.net.params()
        template = {"params": self._tree(params),
                    "lambdas": self.lambdas}
        fresh = make_optimizer(params, self.lambdas, self.lr,
                               self.lr_weights, freeze_lambdas=self.use_ntk)
        if peek.get("has_opt_state", False):
            template["opt_state"] = self._opt_tree(fresh)
        if peek.get("has_net_buffers", False):
            template["net_buffers"] = net_buffers(self.net)
        if peek.get("has_X_f", False):
            template["X_f"] = self.X_f
        if peek.get("has_best", False):
            template["best_params"] = template["params"]
        state, meta = restore_checkpoint(path, template)

        def dev(a):
            return torch.as_tensor(np.array(a), device=self.device)

        self.net.load_params([dev(a) for a in param_leaves(state["params"])])
        with torch.no_grad():
            live = net_buffers(self.net)
            for name, saved in state.get("net_buffers", {}).items():
                live[name].copy_(dev(saved))
            for key, lams in self.lambdas.items():
                for lam, saved in zip(lams, state["lambdas"][key]):
                    if lam is not None:
                        lam.copy_(dev(saved))
        if "opt_state" in state:
            for opt, entries in zip(fresh, (state["opt_state"].get("net"),
                                            state["opt_state"].get("lam"))):
                if opt is None:
                    continue
                sd = opt.state_dict()
                sd["state"] = {
                    i: {"step": torch.as_tensor(np.array(e["step"])),
                        "exp_avg": dev(e["exp_avg"]),
                        "exp_avg_sq": dev(e["exp_avg_sq"])}
                    for i, e in enumerate(entries)}
                opt.load_state_dict(sd)
                relink_schedules(opt)
            self._opt = fresh
        else:
            self._opt = None
        if "X_f" in state:
            self.X_f = dev(np.ascontiguousarray(state["X_f"], np.float32))
        self.losses = list(meta.get("losses", []))
        for k, v in meta.get("min_loss", {}).items():
            self.min_loss[k] = float(v)
        for k, v in meta.get("best_epoch", {}).items():
            self.best_epoch[k] = int(v)
        if "best_params" in state:
            best = self.net.param_tree(
                [dev(a) for a in param_leaves(state["best_params"])])
            ph = meta.get("best_phase", "adam")
            if ph in ("adam", "l-bfgs"):
                self.best_model[ph] = best
            self.best_model["overall"] = best
            self.min_loss["overall"] = float(meta.get("best_loss", np.inf))
            self.best_epoch["overall"] = int(meta.get("best_iter", -1))
        self.newton_done = int(meta.get("newton_done", 0))
        # the restored moments carry this clipping config; a fit() that
        # turns clipping on or off restarts them
        self._opt_grad_clip = meta.get("grad_clip")
        floor = float(meta.get("resample_uniform_floor", 0.0) or 0.0)
        if floor > 0.0:
            self._resample_uniform_floor = floor
        return self

    # ------------------------------------------------------------------ #
    def export_surrogate(self, best_model: bool = False):
        """Export the trained solution as a deployable
        :class:`~..serving.Surrogate`: the network, a copy of its
        parameters and the ``u``/derivative/residual closures, with no
        training state (no optimizer moments, no λ, no collocation set).
        It ``save``s through the checkpoint protocol and restores in a fresh
        process (``Surrogate.load(path, f_model=...)``); batched queries go
        through ``surrogate.engine()``.  ``best_model=True`` exports the
        best iterate, as in :meth:`predict`."""
        if not (self._compiled or self._loaded):
            raise NotCompiledError("Call compile(...) or load_model(...) "
                                   "before export_surrogate()")
        from ..serving import Surrogate
        return Surrogate.from_solver(self, best_model=best_model)

    def _arch_meta(self) -> dict:
        return net_metadata(self.net, self.layer_sizes, self.n_out)

    def _net_description(self) -> str:
        net = self.net
        if isinstance(net, ModuleNet):
            return f"a custom {type(net.module).__name__} module"
        act = getattr(net.activation, "__name__", str(net.activation))
        return (f"{type(net).__name__}(activation={act}, dtype={net.dtype}, "
                f"param_dtype={net.param_dtype})")

    def save(self, path: str):
        """Write the network, self-describing (reference ``models.py:315-
        316``): ``TDQM``, the JSON architecture header's length (8 bytes,
        little-endian) and the header, then the parameters as an ``.npz``:
        the MLP family's in the flax layout of
        :func:`~..weights.params_to_numpy`, a custom module's by their
        ``named_parameters()`` names (``params/<name>``)."""
        from ..checkpoint import write_npz
        from ..weights import params_to_numpy
        if not (self._compiled or self._loaded):
            raise NotCompiledError("Call compile(...) or load_model(...) "
                                   "before save(...)")
        header = json.dumps(self._arch_meta()).encode("utf-8")
        if isinstance(self.net, MLP):
            tree = params_to_numpy(self.net)["params"]
            arrays = {f"params/{name}/{leaf}": arr
                      for name, layer in tree.items()
                      for leaf, arr in layer.items()}
        else:
            arrays = {f"params/{name}": p.detach().cpu().numpy()
                      for name, p in zip(self.net.names, self.net.params())}
        # a FourierMLP's frequency matrix, a custom module's buffers: the
        # network's function needs them
        arrays.update({f"buffers/{name}": t.detach().cpu().numpy()
                       for name, t in net_buffers(self.net).items()})
        blob = io.BytesIO()
        write_npz(blob, arrays)
        with open(path, "wb") as fh:
            fh.write(_SAVE_MAGIC + struct.pack("<Q", len(header)) + header
                     + blob.getvalue())

    def load_model(self, path: str, compile_model: bool = False,
                   network: Optional[torch.nn.Module] = None):
        """Read a network written by :meth:`save` (reference ``models.py:
        318-319``).  On a compiled solver the file's architecture must match
        the compiled one.  On an uncompiled solver the standard tanh MLP
        family is rebuilt from the file; any other network (a custom
        module, another activation) is the caller's to build, as in the JAX
        package: pass it as ``network=`` (its type must match the file's),
        or ``compile(..., network=...)`` first.  ``predict`` then gives
        ``u`` (and ``None`` for the residual), and ``compile(layer_sizes=
        None, ...)`` trains on from the loaded network (the transfer-learn
        flow).  ``compile_model`` is accepted and ignored, as the JAX solver
        does."""
        from ..checkpoint import read_npz
        with open(path, "rb") as fh:
            raw = fh.read()
        if raw[:4] != _SAVE_MAGIC:
            raise ValueError(f"{path} is not a model saved by save() (no "
                             "TDQM header)")
        hlen = struct.unpack("<Q", raw[4:12])[0]
        meta = json.loads(raw[12:12 + hlen].decode("utf-8"))
        arrays = read_npz(io.BytesIO(raw[12 + hlen:]))
        if self._compiled:
            if list(meta["layer_sizes"]) != list(self.layer_sizes):
                raise ValueError(
                    f"saved model has layer_sizes {meta['layer_sizes']} but "
                    f"this solver was compiled with {self.layer_sizes}")
            mine = self._arch_meta()
            for key in ("network_type", "net_config"):
                if meta.get(key) != mine.get(key):
                    raise ValueError(
                        f"saved model has {key} {meta.get(key)!r} but this "
                        f"solver was compiled with {mine.get(key)!r}")
            net = self.net
        elif network is not None:
            net = as_network(network).to(self.device)
            mine = net_metadata(net, meta["layer_sizes"],
                                meta.get("n_out", meta["layer_sizes"][-1]))
            for key in ("network_type", "net_config"):
                if meta.get(key) != mine.get(key):
                    raise ValueError(
                        f"saved model has {key} {meta.get(key)!r} but the "
                        f"network passed has {mine.get(key)!r}")
        else:
            try:
                net = net_from_metadata(meta, device=self.device)
            except ValueError as e:
                raise ValueError(f"{e}: load_model(path, network=...) or "
                                 "compile(..., network=...) first") from None
        if isinstance(net, MLP):
            n_layers = len(meta["layer_sizes"]) - 1
            net.load_layers([
                (torch.from_numpy(arrays[f"params/Dense_{i}/kernel"]),
                 torch.from_numpy(arrays[f"params/Dense_{i}/bias"]))
                for i in range(n_layers)])
        else:
            net.load_params([torch.from_numpy(arrays[f"params/{name}"])
                             for name in net.names])
        with torch.no_grad():
            for name, t in net_buffers(net).items():
                t.copy_(torch.from_numpy(arrays[f"buffers/{name}"]))
        if self._compiled:
            return self
        self.net = net
        self.apply_fn = net.apply
        self.precision = net.precision
        self.layer_sizes = list(meta["layer_sizes"])
        self.n_out = int(meta.get("n_out", self.layer_sizes[-1]))
        self._loaded = True
        return self

    # ------------------------------------------------------------------ #
    def predict(self, X_star, best_model: bool = False):
        """Evaluate the solution and the PDE residual at query points
        (reference ``models.py:297-313``).  Returns ``(u, f_u)`` as NumPy;
        ``f_u`` is a tuple for multi-equation systems, ``None`` on a solver
        that loaded a network but is not compiled."""
        if not (self._compiled or self._loaded):
            raise NotCompiledError("Call compile(...) or load_model(...) "
                                   "before predict(...)")
        params = (self.best_model["overall"]
                  if best_model and self.best_model["overall"] is not None
                  else self.net.params())
        u = self._apply_eval(params, X_star)
        if not self._compiled:
            # loaded, not compiled: the solution network exists, the
            # residual does not (no f_model yet)
            return u, None
        f = self._residual_eval(params, X_star)
        if isinstance(f, tuple) and len(f) == 1:
            f = f[0]
        return u, f

    def _query(self, X) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(X, np.float32),
                               device=self.device)

    def _apply_eval(self, params, X) -> np.ndarray:
        """The network at ``params`` (what ``apply_fn`` takes: the flat
        list or the network's structure) on the points ``X``, as NumPy
        (float32): the counterpart of the JAX
        solver's ``_apply_jit``, which evaluation hooks call between
        chunks (the zoo's scorecard)."""
        with matmul_precision(self.precision), torch.no_grad():
            return self.net.apply(params, self._query(X)).float().cpu() \
                .numpy()

    def _residual_eval(self, params, X):
        """The PDE residual at ``params`` on ``X`` through the adopted
        residual engine, as NumPy (a tuple for a system): the counterpart
        of the JAX solver's ``_residual_jit``."""
        with matmul_precision(self.precision), torch.no_grad():
            f = self._residual(params, self._query(X))
        if isinstance(f, tuple):
            return tuple(c.float().cpu().numpy() for c in f)
        return f.float().cpu().numpy()
