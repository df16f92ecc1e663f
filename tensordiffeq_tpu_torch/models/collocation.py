"""The forward collocation solver.

Counterpart of the JAX package's ``models/collocation.py::
CollocationSolverND`` (reference ``tensordiffeq/models.py:12-322``), with
the same user workflow::

    solver = CollocationSolverND()            # device="cuda" by default
    solver.compile(layer_sizes, f_model, domain, bcs, fused="cuda")
    solver.fit(tf_iter=10_000)
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

Everything of the JAX solver that is not ported yet raises
:class:`~..utils.NotPortedError` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..boundaries import BC
from ..domains import DomainND
from ..networks import MLP, init_generator, mlp_forward
from ..ops.derivatives import make_ufn, vmap_residual
from ..training.fit import FitResult, fit_adam, make_optimizer
from ..utils import (ieee_f32, initialize_lambdas, not_ported,
                     resolve_device)
from .assembly import build_loss_fn


class NotCompiledError(RuntimeError):
    """A method that needs the compiled training graph ran before
    ``compile(...)``."""


# compile()/fit() options of the JAX solver that the port does not have yet:
# name -> (value that means "off", ROADMAP item)
_UNPORTED_COMPILE = {
    "dist": (False, "queue 1, multi-GPU"),
    "fused_dtype": (None, "queue 2, bf16-operand flavor of K1-K3"),
    "causal_eps": (None, "queue 1, resampling/discovery/NTK/causal"),
    "remat": (False, "queue 1, remaining solver features"),
}
_UNPORTED_FIT = {
    "newton_iter": (0, "queue 1, L-BFGS"),
    "newton_eager": (None, "queue 1, L-BFGS"),
    "batch_sz": (None, "queue 1, minibatching"),
    "profile_dir": (None, "queue 1, telemetry"),
    "eval_fn": (None, "queue 1, telemetry"),
    "eval_every": (0, "queue 1, telemetry"),
    "resample_every": (0, "queue 1, resampling"),
    "checkpoint_dir": (None, "queue 1, checkpointing"),
    "checkpoint_every": (0, "queue 1, checkpointing"),
    "telemetry": (None, "queue 1, telemetry"),
    "grad_clip": (None, "queue 1, resilience"),
}


def _reject_unported(table: dict, given: dict, where: str):
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        off, item = table[name]
        if value is not off and value != off:
            raise not_ported(f"{where}({name}=...)", item)


def _flat(layers) -> list:
    return [t for pair in layers for t in pair]


class CollocationSolverND:
    """N-dimensional collocation PINN solver (forward problems).

    ``Adaptive_type`` keeps the reference's encoding: 0 = baseline, 1 =
    self-adaptive per-point (SA-PINN), 2 = self-adaptive scalar per loss.
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
        self._compiled = False

    @property
    def params(self) -> list:
        """The network's live ``[(W, b), ...]``."""
        return self.net.layers()

    # ------------------------------------------------------------------ #
    def compile(self, layer_sizes: Sequence[int], f_model: Callable,
                domain: DomainND, bcs: Sequence[BC], Adaptive_type: int = 0,
                dict_adaptive: Optional[dict] = None,
                init_weights: Optional[dict] = None,
                g: Optional[Callable] = None, network: Optional[MLP] = None,
                lr: float = 0.005, lr_weights: float = 0.005,
                fused=None, minimax: Optional[bool] = None, **unported):
        """Assemble the problem (reference ``models.py:27-105``).

        Args:
          layer_sizes: ``[n_in, …, n_out]`` MLP sizes.
          f_model: per-point residual ``f_model(u, *coords)`` written with
            :func:`tensordiffeq_tpu_torch.grad` combinators.
          domain: :class:`DomainND` with collocation points generated.
          bcs: list of boundary/initial conditions.
          Adaptive_type: 0/1/2 as in the reference.
          dict_adaptive/init_weights: SA contract — which loss terms carry λ
            and their initial values.
          g: optional λ transform for residual terms.
          network: an :class:`~..networks.MLP` to train instead of a fresh
            one (its parameters are moved to the solver's device).
          fused: residual engine selection (module docstring).
          minimax: the fused minimax step (module docstring).  ``None``
            adopts it when the fused residual is active, the ``f_model``
            lowers to the kernel's residual tape and the step passes the
            cross-check, else records why in ``_minimax_fail_reason``;
            ``True`` raises :class:`ValueError` instead of falling back;
            ``False`` keeps the unfused loss.
          **unported: ``dist``, ``fused_dtype``, ``causal_eps``, ``remat``
            at anything but their "off" value raise
            :class:`~..utils.NotPortedError`.
        """
        _reject_unported(_UNPORTED_COMPILE, unported, "compile")
        if fused == "autotune":
            raise not_ported("compile(fused='autotune')",
                             "queue 1, solver features")
        if fused not in (None, False, True, "cuda"):
            raise ValueError(f"fused={fused!r}: expected None, False, True or "
                             "'cuda' ('pallas' is the JAX package's TPU "
                             "kernel; its counterpart here is 'cuda')")
        if layer_sizes is None:
            raise not_ported("compile(layer_sizes=None) after load_model",
                             "queue 1, checkpointing")
        if Adaptive_type == 3:
            raise not_ported("NTK weighting (Adaptive_type=3)",
                             "queue 1, resampling/discovery/NTK")
        if Adaptive_type not in (0, 1, 2):
            raise ValueError("Adaptive method invalid! (expected 0, 1, 2 or 3)")
        if domain.X_f is None:
            raise ValueError("Domain has no collocation points; call "
                             "domain.generate_collocation_points(N_f) first")
        self.layer_sizes = list(layer_sizes)
        self.domain = domain
        self.bcs = list(bcs)
        self.f_model = f_model
        self.g = g
        self.fused = fused
        self.minimax = minimax
        self.lr = lr
        self.lr_weights = lr_weights
        self.n_out = int(layer_sizes[-1])

        if network is None:
            network = MLP(layer_sizes, device=self.device,
                          generator=init_generator(self.seed))
        elif type(network) is not MLP:
            raise not_ported("custom networks", "queue 1, solver features")
        self.net = network.to(self.device)
        self._opt = None

        self.Adaptive_type = Adaptive_type
        self.isAdaptive = Adaptive_type in (1, 2)
        self.weight_outside_sum = Adaptive_type == 2
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
        with ieee_f32():
            self._build()
        self._compiled = True
        return self

    def _try_fuse(self):
        """The fused Taylor-propagation residual when both the network and
        ``f_model`` qualify, else ``None`` (the failure is recorded in
        ``_fuse_fail_reason``)."""
        from ..ops.fused import analyze_f_model, make_fused_residual, \
            mlp_qualifies

        self._fuse_fail_reason = None
        self._fuse_requests = None
        layers = mlp_qualifies(self.net)
        if layers is None:
            return None
        requests, reason = analyze_f_model(
            self.f_model, self.domain.vars, self.n_out, return_reason=True)
        if requests is None:
            self._fuse_fail_reason = reason
            return None
        self._fuse_requests = requests
        table_producer = None
        if self.fused == "cuda":
            from ..ops.cuda_taylor import build_cuda_table_fn
            table_producer = build_cuda_table_fn(
                requests, [tuple(W.shape) for W, _ in layers],
                device=self.device)
        return make_fused_residual(self.f_model, self.domain.vars, self.n_out,
                                   requests, table_producer=table_producer)

    def _generic_residual(self, params, X):
        u = make_ufn(mlp_forward, params, self.domain.vars, self.n_out)
        return vmap_residual(self.f_model, u, self.domain.ndim)(X)

    def _crosscheck_fused(self, n_check: int = 32, residual_fn=None):
        """Compare a fused residual engine (values AND the gradient of the
        squared residual w.r.t. the parameters) against the generic engine
        on a small sample of the collocation set; for ``fused="cuda"`` this
        runs K1 and K2.  Returns ``(ok, reason)``."""
        from ..ops.fused import crosscheck_grads, crosscheck_residuals

        if residual_fn is None:
            residual_fn = self._fused_residual
        X_s = self.X_f[:min(n_check, int(self.X_f.shape[0]))]
        params = self.net.layers()
        flat = _flat(params)

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
            return False, e
        ok, reason = crosscheck_residuals(generic, fused)
        if not ok:
            return ok, reason
        try:
            g_fus = torch.autograd.grad(sumsq(fused), flat,
                                        materialize_grads=True)
        except Exception as e:  # backward-only failure
            return False, e
        return crosscheck_grads(g_gen, g_fus)

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

        try:
            # the lowering to K3's tape: a MinimaxLoweringError when the
            # f_model does not lower, or the plan's caps refuse the network
            sq = mmx.build_minimax_sq_fn(
                self.f_model, self.domain.vars, self.n_out,
                self._fuse_requests,
                [tuple(W.shape) for W, _ in self.net.layers()],
                device=self.device)
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
        self._minimax_loss = mm
        # the kernel follows the device, as the JAX solver takes Pallas
        # whenever a TPU is present
        self._minimax_kind = "cuda" if self.device.type == "cuda" else "plain"
        self._minimax_sq = sq
        self._minimax_n_eq = sq.n_equations
        if self.verbose:
            print(f"[fuse] minimax engine adopted ({self._minimax_kind}: "
                  "residual + SA-λ loss + cotangents in one step)",
                  flush=True)

    def _crosscheck_minimax(self, mm_loss, n_check: int = 32):
        """Compare the fused minimax loss term (value and gradients with
        respect to the parameters and λ) against the generic engine's
        residual term on a sample of the collocation set, at rtol 5e-3.
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
        gen = build_loss_fn(mlp_forward, self.domain.vars, self.n_out,
                            self.f_model, [], **kw)
        mm = build_loss_fn(mlp_forward, self.domain.vars, self.n_out,
                           self.f_model, [], residual_loss_fn=mm_loss, **kw)

        def val_grad(loss_fn):
            params = [t.detach().clone().requires_grad_(True)
                      for t in _flat(self.net.layers())]
            lams = [None if lam is None else
                    (lam[:n_s] if lam.ndim >= 1 and lam.shape[0] == n_f
                     else lam).detach().clone().requires_grad_(True)
                    for lam in self.lambdas["residual"]]
            val = loss_fn(list(zip(params[0::2], params[1::2])), [], lams,
                          X_s)[0]
            leaves = params + [lam for lam in lams if lam is not None]
            return float(val.detach()), torch.autograd.grad(
                val, leaves, materialize_grads=True)

        v_m, g_m = val_grad(mm)
        v_g, g_g = val_grad(gen)
        if not (abs(v_m - v_g) <= 1e-5 + 5e-3 * abs(v_g)):  # NaN-safe form
            return False, FusedMismatch(
                f"minimax loss value {v_m:.6e} disagrees with the generic "
                f"engine's {v_g:.6e}")
        return crosscheck_grads(g_g, g_m)

    def _build(self):
        self._fused_residual = (self._try_fuse() if self.fused is not False
                                else None)
        if self.fused in (True, "cuda") and self._fused_residual is None:
            msg = ("fused=%r but the residual cannot be fused: it requires "
                   "the standard float32 tanh MLP and an f_model using "
                   "grad() combinators on untransformed coordinates with "
                   "derivative orders <= 3 (or unmixed 4th)" % (self.fused,))
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
                if self.verbose:
                    print(f"[fuse] cross-check failed ({type(reason).__name__}"
                          f": {reason}); using the generic autodiff engine",
                          flush=True)
        # the fused minimax step replaces the training loss's residual term
        # when it qualifies, behind the same numeric cross-check discipline
        self._minimax_loss = None
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
        self.loss_fn = build_loss_fn(
            mlp_forward, self.domain.vars, self.n_out, self.f_model,
            self.bcs, weight_outside_sum=self.weight_outside_sum, g=self.g,
            data_X=self.data_X, data_s=self.data_s,
            residual_fn=self._fused_residual,
            residual_loss_fn=self._minimax_loss, device=self.device)

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
        return "fused-cuda" if self.fused == "cuda" else "fused"

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
            with ieee_f32():
                self._build()

    # ------------------------------------------------------------------ #
    def update_loss(self):
        """Current composite loss and components on the full collocation set."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before update_loss()")
        with ieee_f32():
            return self.loss_fn(self.net.layers(), self.lambdas["BCs"],
                                self.lambdas["residual"], self.X_f)

    def fit(self, tf_iter: int = 0, chunk: int = 100, **unported):
        """Adam phase with SA-λ ascent (reference ``models.py:227`` →
        ``fit.py:17-102``).  ``tf_iter`` epochs run in chunks of ``chunk``
        with no host synchronisation inside a chunk; the loss history
        (``self.losses``) gets one component dict per epoch.

        ``newton_iter > 0`` (L-BFGS) and the JAX solver's other fit
        options (minibatching, resampling, checkpointing, telemetry,
        clipping, profiling, eval hooks) raise
        :class:`~..utils.NotPortedError`."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before fit(...)")
        _reject_unported(_UNPORTED_FIT, unported, "fit")
        if self.verbose:
            print(f"[fit] engine={self.engine} device={self.device} "
                  f"N_f={int(self.X_f.shape[0])} tf_iter={tf_iter}",
                  flush=True)
        if tf_iter <= 0:
            return self
        params = _flat(self.net.layers())
        if self._opt is None:
            self._opt = make_optimizer(params, self.lambdas, self.lr,
                                       self.lr_weights)
        with ieee_f32():
            result = fit_adam(self.loss_fn, params, self.lambdas, self.X_f,
                              tf_iter, self._opt, chunk=chunk,
                              verbose=self.verbose,
                              result=FitResult(losses=self.losses))
        self.wall_time = result.wall_time
        if (self.best_model["adam"] is None
                or result.min_loss["adam"] <= self.min_loss["adam"]):
            best = result.best_params["adam"]
            self.best_model["adam"] = list(zip(best[0::2], best[1::2]))
            self.min_loss["adam"] = result.min_loss["adam"]
            self.best_epoch["adam"] = result.best_epoch["adam"]
        self.min_loss["overall"] = self.min_loss["adam"]
        self.best_epoch["overall"] = self.best_epoch["adam"]
        self.best_model["overall"] = self.best_model["adam"]
        return self

    # ------------------------------------------------------------------ #
    def predict(self, X_star, best_model: bool = False):
        """Evaluate the solution and the PDE residual at query points
        (reference ``models.py:297-313``).  Returns ``(u, f_u)`` as NumPy;
        ``f_u`` is a tuple for multi-equation systems."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before predict(...)")
        params = (self.best_model["overall"]
                  if best_model and self.best_model["overall"] is not None
                  else self.net.layers())
        X = torch.as_tensor(np.ascontiguousarray(X_star, np.float32),
                            device=self.device)
        with ieee_f32(), torch.no_grad():
            u = mlp_forward(params, X)
            f = self._residual(params, X)
        if isinstance(f, tuple):
            f_np = tuple(c.cpu().numpy() for c in f)
            f_np = f_np[0] if len(f_np) == 1 else f_np
        else:
            f_np = f.cpu().numpy()
        return u.cpu().numpy(), f_np
