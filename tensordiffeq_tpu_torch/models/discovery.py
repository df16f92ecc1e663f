"""Inverse-problem solver: learn PDE coefficients from observed data.

Counterpart of the JAX package's ``models/discovery.py::DiscoveryModel``
(reference ``models.py:324-398``).  The unknown coefficients are 0-d
tensors trained beside the network; the SA collocation weights, when given,
are trained by gradient ascent.  The JAX package's one
``optax.multi_transform`` is three ``torch.optim.Adam`` here, with its rates
and β's: Adam on the network (``lr``, β₁ 0.99), Adam on the coefficients
(``lr_vars``: one rate, or one per coefficient as a parameter group each,
β₁ 0.99) and Adam ascent on ``col_weights`` (``lr_weights``, β₁ 0.99,
``maximize=True``, the same update as ``chain(scale(-1), adam)``).

User contract (per point)::

    def f_model(u, var, x, t):
        c1, c2 = var
        u_xx = grad(grad(u, "x"), "x")
        uv = u(x, t)
        return grad(u, "t")(x, t) - c1 * u_xx(x, t) + c2 * uv ** 3 - c2 * uv

    model = DiscoveryModel()                  # device="cuda" by default
    model.compile([2, 128, 128, 1], f_model, [x, t], u, var=[0.0, 0.0],
                  col_weights=..., lr_vars=[2e-5, 0.01], varnames=["x", "t"])
    model.fit(tf_iter=10_000)
    c1, c2 = model.vars

The residual runs on the fused Taylor engine (:mod:`..ops.fused`, the plain
flavor: the JAX package's discovery reaches no kernel either) when the
network and ``f_model`` qualify and pass the numeric cross-check, with the
data loss reading the table's primal channel; else on the generic
per-point engine.  Each Adam step is one step over static buffers
(:class:`_DiscoveryStep`), replayed as a CUDA graph on the card
(:mod:`..training.graphs`), the counterpart of the JAX package's
``lax.scan`` chunk; on the CPU the same code runs eagerly.

Every rate (``lr``, ``lr_weights``, each of ``lr_vars``) is a float or a
schedule (:mod:`..training.schedules`), evaluated on the device inside the
step; ``network=`` takes any ``nn.Module`` (the MLP family with its
knobs, or a custom module through :class:`~..networks.ModuleNet`), which
trains on the generic engine unless it is the plain float32 tanh MLP, and
the network's ``precision`` is the step's matmul precision on the card.
Not ported (ROADMAP queue 1): ``dist=True`` (item 6); it raises
:class:`~..utils.NotPortedError`.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..networks import MLP, as_network, init_generator, net_buffers
from ..ops.derivatives import make_ufn, vmap_residual
from ..ops.losses import MSE, default_g, g_MSE
from ..training.fit import (adam, make_batches, optimizer_step,
                            relink_schedules, schedule_tensors)
from ..training.graphs import StepGraph
from ..training.progress import progress_bar
from ..utils import (matmul_precision, not_ported, param_leaves,
                     resolve_device)
from .collocation import NotCompiledError


def _opt_entries(opt) -> list:
    """An Adam's state as one ``{"exp_avg", "exp_avg_sq", "step"}`` per
    parameter, over every parameter group (zeros before its first step)."""
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            out.append({"exp_avg": st.get("exp_avg", torch.zeros_like(p)),
                        "exp_avg_sq": st.get("exp_avg_sq",
                                             torch.zeros_like(p)),
                        "step": st.get("step", torch.zeros(()))})
    return out


class _DiscoveryStep:
    """One Adam step of the inverse problem over static buffers: the batch
    ``b = counter % n_batches`` (the counter runs on across ``fit`` calls
    and resumes, so batches rotate as in the JAX package), the loss and its
    backward, the three optimizers, and the step's total loss and
    coefficients into row ``row`` of the chunk's history.  :attr:`graph`
    runs it (captured and replayed on a CUDA device)."""

    def __init__(self, model: "DiscoveryModel", batch_sz: Optional[int],
                 eager: bool):
        # weakly: the model owns its step, and a cycle would keep the
        # step's graph and its pool alive until the cyclic collector runs
        self.model = weakref.proxy(model)
        self.batch_sz = batch_sz
        self.eager = eager
        self.X_batched, self.idx_batched, self.n_batches = make_batches(
            model.X, batch_sz, verbose=model.verbose, permute=True)
        dev = model.device
        self.counter = torch.zeros((), dtype=torch.long, device=dev)
        self.row = torch.zeros((), dtype=torch.long, device=dev)
        self.hist = None
        self.rows = 0
        self.graph = StepGraph(self._step, self._keyed, dev,
                               "discovery step", eager=eager)

    def _keyed(self) -> list:
        m = self.model
        state = [v for opt in m._opts if opt is not None
                 for st in opt.state.values() for v in st.values()
                 if isinstance(v, torch.Tensor)]
        state += [t for opt in m._opts if opt is not None
                  for t in schedule_tensors(opt)]
        bufs = [m.X, m.u_data, self.X_batched, self.idx_batched,
                self.counter, self.row]
        if m._cw is not None:
            bufs.append(m._cw)
        if self.hist is not None:
            bufs.append(self.hist)
        return m._params() + m._vars + state + bufs

    def begin(self, rows: int, step0: int):
        """Start a ``fit``: the step counter at ``step0`` (the batch
        rotation resumes where the record ends), room for ``rows`` history
        rows per chunk."""
        with torch.no_grad():
            self.counter.fill_(int(step0))
        if self.hist is not None and self.hist.shape[0] < rows:
            self.hist = torch.zeros((rows, self.hist.shape[1]),
                                    device=self.model.device)
        self.rows = max(self.rows, rows)

    def _batch(self):
        m = self.model
        if self.n_batches == 1:
            return m.X, m.u_data, m._cw
        b = torch.remainder(self.counter, self.n_batches).reshape(1)
        idx = self.idx_batched.index_select(0, b)[0]
        X_b = self.X_batched.index_select(0, b)[0]
        cw = None if m._cw is None else m._cw.index_select(0, idx)
        return X_b, m.u_data.index_select(0, idx), cw

    def _step(self):
        m = self.model
        for opt in m._opts:
            if opt is not None:
                opt.zero_grad(set_to_none=True)
        X_b, u_b, cw_b = self._batch()
        total, _ = m._loss(m._params(), m._vars, cw_b, X_b, u_b)
        total.backward()
        for opt in m._opts:
            if opt is not None:
                optimizer_step(opt)
        with torch.no_grad():
            vals = torch.stack([total.detach().reshape(())]
                               + [v.detach().reshape(()) for v in m._vars])
            if self.hist is None:  # the first step, always an eager one
                self.hist = torch.zeros((self.rows, vals.shape[0]),
                                        device=m.device)
            self.hist.index_copy_(0, self.row.reshape(1), vals[None])
            self.counter.add_(1)
            self.row.add_(1)


class DiscoveryModel:
    """Learn PDE coefficients ``var`` jointly with the solution network.

    ``device`` defaults to ``"cuda"`` and raises
    :class:`~..utils.CudaUnavailableError` without a card; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._compiled = False
        self._step_obj = None
        self.losses: list[float] = []
        self.var_history: list[list[float]] = []

    # ------------------------------------------------------------------ #
    def compile(self, layer_sizes: Sequence[int], f_model: Callable, X, u,
                var: Sequence[float], col_weights=None,
                varnames: Optional[Sequence[str]] = None, lr=0.005,
                lr_vars=0.005, lr_weights=0.005, seed: int = 0,
                verbose: bool = True, fused: Optional[bool] = None,
                dist: bool = False, network=None,
                g: Optional[Callable] = None):
        """Assemble the inverse problem (reference ``models.py:325-341``).

        Args:
          layer_sizes: MLP sizes ``[n_in, …, n_out]``.
          f_model: per-point residual ``f_model(u, var, *coords)``.
          X: observation coordinates, ``[n, d]`` or a list of ``d`` column
            vectors.
          u: observed solution values ``[n, n_out]``.
          var: initial guesses for the unknown coefficients.
          col_weights: optional SA weights ``[n, 1]``, trained by ascent;
            the residual term is ``mean(g(λ)·f²)``.
          varnames: coordinate names for ``grad(u, "x")`` (default ``x0,
            x1, …``).
          lr, lr_weights: Adam rates of the network and of
            ``col_weights``: floats or schedules
            (:mod:`..training.schedules`).
          lr_vars: the coefficients' Adam rate, one float or schedule, or
            one per coefficient (coefficients at very different scales,
            such as Allen-Cahn's 1e-4 diffusion beside its reaction rate of
            5).
          fused: ``None`` the fused engine when it qualifies and passes the
            cross-check, ``False`` the generic engine, ``True`` the fused
            engine or raise.
          g: the λ transform (default ``λ²``).
          network: any ``nn.Module`` to train instead of a fresh MLP
            (``layer_sizes`` must describe it): the MLP family with its
            knobs, or a custom module (:class:`~..networks.ModuleNet`, as
            the JAX package's custom Flax module); all but the plain
            float32 tanh MLP take the generic engine.
          dist: not ported (raises :class:`~..utils.NotPortedError`).
        """
        if dist:
            raise not_ported("DiscoveryModel.compile(dist=True)",
                             "queue 1 item 6, multi-GPU and multi-host")
        if getattr(lr_vars, "ndim", 0) > 0:  # an array of rates
            lr_vars = [float(v) for v in np.asarray(lr_vars)]
        per_var = isinstance(lr_vars, (list, tuple))
        rates = list(lr_vars) if per_var else [lr_vars]
        if fused not in (None, False, True):
            raise ValueError(f"fused={fused!r}: expected None, False or True "
                             "(the discovery residual has no kernel flavor)")
        if isinstance(X, (list, tuple)):
            X = np.hstack([np.reshape(c, (-1, 1)) for c in X])
        X = np.ascontiguousarray(X, np.float32)
        self.X = torch.as_tensor(X, device=self.device)
        self.ndim = int(X.shape[1])
        self.u_data = torch.as_tensor(
            np.ascontiguousarray(np.reshape(u, (X.shape[0], -1)),
                                 np.float32), device=self.device)
        self.layer_sizes = list(layer_sizes)
        self.n_out = int(layer_sizes[-1])
        self.f_model = f_model
        self.varnames = tuple(varnames) if varnames is not None else tuple(
            f"x{i}" for i in range(self.ndim))
        if len(self.varnames) != self.ndim:
            raise ValueError(
                f"X has {self.ndim} coordinate column(s) but varnames names "
                f"{len(self.varnames)}: {self.varnames}")
        if per_var and len(rates) != len(var):
            raise ValueError(f"lr_vars has {len(rates)} entries for "
                             f"{len(var)} coefficients")
        self.verbose = verbose
        self.fused = fused
        self.g = g
        self.net = (MLP(layer_sizes, device=self.device,
                        generator=init_generator(seed))
                    if network is None
                    else as_network(network).to(self.device))
        self.apply_fn = self.net.apply
        self.precision = self.net.precision
        self._vars = [torch.full((), float(np.asarray(v)), device=self.device)
                      .requires_grad_(True) for v in var]
        self._cw = (None if col_weights is None else torch.as_tensor(
            np.asarray(col_weights, np.float32),
            device=self.device).clone().requires_grad_(True))
        self._lrs = (lr, list(rates) if per_var else rates[0], lr_weights)
        self._opts = self._make_optimizers()
        self._step_obj = None
        self.losses, self.var_history = [], []
        with matmul_precision(self.precision):
            self._build()
        self._compiled = True
        return self

    def _make_optimizers(self) -> tuple:
        lr, lr_vars, lr_w = self._lrs
        dev = self.device
        opt_net = adam([(self._params(), lr)], dev)
        per = lr_vars if isinstance(lr_vars, list) \
            else [lr_vars] * len(self._vars)
        opt_vars = (adam([([v], r) for v, r in zip(self._vars, per)], dev)
                    if self._vars else None)
        opt_lam = (None if self._cw is None else
                   adam([([self._cw], lr_w)], dev, maximize=True))
        return opt_net, opt_vars, opt_lam

    def _params(self) -> list:
        return self.net.params()

    # ------------------------------------------------------------------ #
    def _try_fuse(self):
        """The fused residual ``(params, X, var) -> (f, u)`` when the
        network and ``f_model`` qualify, else ``None`` (the reason in
        ``_fuse_fail_reason``)."""
        from ..ops.fused import (analyze_f_model, make_fused_residual,
                                 mlp_qualifies)

        self._fuse_fail_reason = None
        if mlp_qualifies(self.net) is None:
            return None
        dummies = [float(v.detach()) for v in self._vars]
        requests, reason = analyze_f_model(
            self.f_model, self.varnames, self.n_out, return_reason=True,
            prefix_args=(dummies,))
        if requests is None:
            self._fuse_fail_reason = reason
            return None
        return make_fused_residual(self.f_model, self.varnames, self.n_out,
                                   requests, has_prefix_arg=True,
                                   return_primal=True,
                                   precision=self.precision)

    def _generic_residual(self, params, vars_, X):
        """The one generic construction of ``f_model(u, var, ·)``: the
        training fallback, the cross-check's referee and
        :meth:`predict_f`."""
        u = make_ufn(self.apply_fn, params, self.varnames, self.n_out)
        return vmap_residual(
            lambda u_, *coords: self.f_model(u_, vars_, *coords),
            u, self.ndim)(X)

    def _crosscheck_fused(self, n_check: int = 32):
        """The fused residual and its primal channel against the generic
        engine and the network on a sample of the observations."""
        from ..ops.fused import crosscheck_residuals

        X_s = self.X[:min(n_check, int(self.X.shape[0]))]
        layers = self.net.params()
        with torch.no_grad():
            generic = self._generic_residual(layers, self._vars, X_s)
            try:
                fused, u_primal = self._fused_residual(layers, X_s,
                                                       self._vars)
            except Exception as e:  # e.g. control flow on values
                return False, e
            ok, reason = crosscheck_residuals(generic, fused)
            if not ok:
                return ok, reason
            # the data loss reads the table's primal channel: check it too
            return crosscheck_residuals(self.apply_fn(layers, X_s), u_primal)

    def _build(self):
        self._fused_residual = (self._try_fuse() if self.fused is not False
                                else None)
        if self.fused is True and self._fused_residual is None:
            reason = self._fuse_fail_reason
            msg = ("fused=True but the discovery residual cannot be fused "
                   "(requires the standard float32 tanh MLP and grad() "
                   "combinators on untransformed coordinates)")
            if reason is not None:
                raise ValueError(f"{msg}; analysis stopped on: "
                                 f"{type(reason).__name__}: {reason}") \
                    from reason
            raise ValueError(msg)
        if self._fused_residual is not None:
            ok, reason = self._crosscheck_fused()
            if not ok:
                if self.fused is True:
                    raise ValueError("fused discovery residual failed the "
                                     "numeric cross-check") from reason
                self._fuse_fail_reason = reason
                self._fused_residual = None
                if self.verbose:
                    print(f"[fuse] discovery cross-check failed "
                          f"({type(reason).__name__}); using the generic "
                          "engine", flush=True)

    @property
    def engine(self) -> str:
        """``"fused"`` or ``"generic"``."""
        return "fused" if self._fused_residual is not None else "generic"

    def _loss(self, layers, vars_, cw, X, u_obs):
        """``(total, components)``: ``MSE(u, u_obs)`` plus each residual
        equation's ``mean(g(λ)·f²)`` (``mean(f²)`` without weights)."""
        if self._fused_residual is not None:
            f_pred, u_pred = self._fused_residual(layers, X, vars_)
        else:
            u_pred = self.apply_fn(layers, X)
            f_pred = self._generic_residual(layers, vars_, X)
        preds = f_pred if isinstance(f_pred, tuple) else (f_pred,)
        g_fn = self.g if self.g is not None else default_g
        data = MSE(u_pred, u_obs)
        comps = {"Data": data}
        total = data
        for i, p in enumerate(preds):
            p = p.reshape(-1, 1)
            term = g_MSE(p, 0.0, g_fn(cw)) if cw is not None else MSE(p, 0.0)
            comps[f"Residual_{i}" if len(preds) > 1 else "Residual"] = term
            total = total + term
        return total, comps

    # ------------------------------------------------------------------ #
    @property
    def vars(self) -> list:
        """The current coefficient estimates (0-d NumPy arrays, copies)."""
        return [v.detach().cpu().numpy().copy() for v in self._vars]

    @property
    def col_weights(self):
        """A copy of the SA weights, ``None`` without them."""
        return (None if self._cw is None
                else self._cw.detach().cpu().numpy().copy())

    def fit(self, tf_iter: int, chunk: int = 100,
            batch_sz: Optional[int] = None, _graphs: bool = True):
        """Joint Adam training (reference ``models.py:381-398``).

        ``tf_iter`` counts epochs: with ``batch_sz`` every epoch trains
        every batch (``ceil(n / batch_sz)`` steps, the tail wrapping to the
        front); the batches are a fixed ``RandomState(0)`` permutation of
        the rows (an observation grid is ordered, and a contiguous batch
        would be a thin slab of the domain), rotating continuously across
        ``fit`` calls and resumes.  Per-row ``col_weights`` ride with their
        rows.  ``losses`` and ``var_history`` get one entry per epoch (its
        last batch's loss, the coefficients after its update).  On a CUDA
        device each step is a replayed CUDA graph; ``_graphs=False`` runs
        it eagerly, the referee the graph is held to, not an option."""
        self.train_loop(tf_iter, chunk=chunk, batch_sz=batch_sz,
                        _graphs=_graphs)
        return self

    def train_loop(self, tf_iter: int, chunk: int = 100,
                   batch_sz: Optional[int] = None, _graphs: bool = True):
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before fit(...)")
        eager = not _graphs
        step = self._step_obj
        if step is None or step.batch_sz != batch_sz or step.eager != eager:
            step = self._step_obj = _DiscoveryStep(self, batch_sz, eager)
        if self.verbose:
            from ..output import print_screen
            print_screen(self, discovery_model=True)
            print(f"[discovery] engine={self.engine} device={self.device} "
                  f"n={int(self.X.shape[0])} tf_iter={tf_iter} "
                  f"batches={step.n_batches}", flush=True)
        n_b = step.n_batches
        total_steps = tf_iter * n_b
        step.begin(chunk * n_b, len(self.losses) * n_b)
        t0 = time.time()
        done = 0
        pbar = progress_bar(tf_iter, desc="Discovery") if self.verbose \
            else None
        with matmul_precision(self.precision):
            while done < total_steps:
                n = min(chunk * n_b, total_steps - done)
                step.graph.check()
                step.row.zero_()
                for _ in range(n):
                    step.graph()
                hist = step.hist[:n].cpu().numpy()  # one copy per chunk
                for row in hist[n_b - 1::n_b]:
                    self.losses.append(float(row[0]))
                    self.var_history.append([float(v) for v in row[1:]])
                done += n
                if pbar is not None:
                    pbar.update(n // n_b)
                    pbar.set_postfix(loss=self.losses[-1],
                                     vars=[round(v, 6) for v in
                                           self.var_history[-1]])
        if pbar is not None:
            pbar.close()
        self.wall_time = time.time() - t0

    # ------------------------------------------------------------------ #
    def _state(self) -> dict:
        state = {"trainables": {
                     "params": self._tree(),
                     "vars": list(self._vars), "col_weights": self._cw},
                 "opt_state": {name: _opt_entries(opt) for name, opt in
                               zip(("net", "vars", "lam"), self._opts)
                               if opt is not None}}
        buffers = net_buffers(self.net)
        if buffers:  # a FourierMLP's B: the function depends on it
            state["net_buffers"] = buffers
        return state

    def _tree(self) -> list:
        """The parameters in the checkpoint's layout: ``[[W, b], ...]`` for
        the MLP family, the flat list of a custom module's."""
        tree = self.net.param_tree(self.net.params())
        return ([list(pair) for pair in tree] if isinstance(self.net, MLP)
                else list(tree))

    def save_checkpoint(self, path: str):
        """The full inverse-problem state under the directory ``path``
        (:mod:`..checkpoint`): the network (a :class:`~..networks.FourierMLP`
        with its ``B``), the coefficients, the SA weights, the three Adam
        states, the loss and coefficient histories."""
        if not self._compiled:
            raise NotCompiledError("Call compile(...) before save_checkpoint")
        from ..checkpoint import save_checkpoint
        save_checkpoint(path, self._state(),
                        {"losses": list(self.losses),
                         "var_history": [list(v) for v in self.var_history]})

    def restore_checkpoint(self, path: str):
        """Restore a :meth:`save_checkpoint` state into this model, which
        must be compiled the same way (else
        :class:`~..checkpoint.TemplateMismatch`)."""
        if not self._compiled:
            raise NotCompiledError(
                "Call compile(...) before restore_checkpoint")
        from ..checkpoint import restore_checkpoint
        state, meta = restore_checkpoint(path, self._state())

        def dev(a):
            return torch.as_tensor(np.array(a), device=self.device)

        tr = state["trainables"]
        with torch.no_grad():
            self.net.load_params([dev(a) for a in param_leaves(tr["params"])])
            live = net_buffers(self.net)
            for name, saved in state.get("net_buffers", {}).items():
                live[name].copy_(dev(saved))
            for v, saved in zip(self._vars, tr["vars"]):
                v.copy_(dev(saved))
            if self._cw is not None:
                self._cw.copy_(dev(tr["col_weights"]))
        self._opts = self._make_optimizers()
        for opt, name in zip(self._opts, ("net", "vars", "lam")):
            if opt is None:
                continue
            sd = opt.state_dict()
            sd["state"] = {
                i: {"step": torch.as_tensor(np.array(e["step"])),
                    "exp_avg": dev(e["exp_avg"]),
                    "exp_avg_sq": dev(e["exp_avg_sq"])}
                for i, e in enumerate(state["opt_state"][name])}
            opt.load_state_dict(sd)
            relink_schedules(opt)
        self._step_obj = None  # new optimizer state: a new step and graph
        self.losses = [float(v) for v in meta.get("losses", [])]
        self.var_history = [list(v) for v in meta.get("var_history", [])]
        return self

    # ------------------------------------------------------------------ #
    def export_surrogate(self):
        """The learned solution and the learned PDE as a
        :class:`~..serving.Surrogate`: the current coefficients are frozen
        into the artifact (``"discovery"`` contract), so
        ``Surrogate.load(path, f_model=f_model)`` evaluates the learned
        equation's residual with no training state."""
        if not self._compiled:
            raise NotCompiledError(
                "Call compile(...) before export_surrogate()")
        from ..serving import Surrogate
        return Surrogate.from_discovery(self)

    def predict(self, X_star):
        """The network's ``u`` at ``X_star`` (NumPy)."""
        X = torch.as_tensor(np.ascontiguousarray(X_star, np.float32),
                            device=self.device)
        with matmul_precision(self.precision), torch.no_grad():
            return self.apply_fn(self.net.params(), X).float().cpu().numpy()

    def predict_f(self, X_star):
        """The learned PDE's residual at ``X_star`` under the current
        coefficients, through the generic engine: one ``[n, 1]`` array per
        equation (a tuple for systems)."""
        X = torch.as_tensor(np.ascontiguousarray(X_star, np.float32),
                            device=self.device)
        with matmul_precision(self.precision), torch.no_grad():
            f = self._generic_residual(self.net.params(), self._vars, X)
        if isinstance(f, tuple):
            return tuple(p.cpu().numpy().reshape(-1, 1) for p in f)
        return f.cpu().numpy().reshape(-1, 1)
