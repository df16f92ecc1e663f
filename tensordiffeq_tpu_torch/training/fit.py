"""Training engine: chunked Adam epochs with self-adaptive λ ascent.

Counterpart of the JAX package's ``training/fit.py`` (``make_optimizer``,
``make_batches``, ``_chunk_runner``, ``fit_adam``).  There a chunk of
epochs is one ``lax.scan`` under ``jit``; here the scan's body is
:class:`AdamStep`, one step written over static buffers (the parameters,
the λ, the optimizer state, the batches, a device step counter, the
chunk's history rows and the running best), and :func:`fit_adam` is the
loop that runs it once per step.  On a CUDA device the step is captured as
a CUDA graph and replayed (:mod:`.graphs`): the device never waits on the
host between steps, and the host issues a step as one graph launch.  On
the CPU the same Python runs eagerly.  The loss components of every step
stay on the device and come back in one copy per chunk; the best-model
snapshot is a ``torch.where`` select on the device (a true copy, fixing the
reference's aliasing best-model bug).

The optimizer is the JAX package's ``optax.multi_transform`` written as two
``torch.optim.Adam``: descent on the network parameters, and ascent on the
λ (``maximize=True``, the same update as ``optax.chain(scale(-1), adam)``),
both with the reference's ``lr=0.005, beta_1=0.99``; ``grad_clip`` puts
``optax.clip_by_global_norm`` ahead of each (:func:`clip_by_global_norm`).

Minibatching (``batch_sz``) scans every batch each epoch, with ceil
batching and a wraparound tail (:func:`make_batches`), and gathers per-point
λ rows alongside their points, as the JAX package does on one device.

Not ported yet (ROADMAP queue 1): learning-rate schedules, ``permute`` and
the mesh branch of ``make_batches``, resampling, telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import span, tree_copy
from .graphs import StepGraph


def make_optimizer(params, lambdas: dict, lr: float = 0.005,
                   lr_weights: float = 0.005, b1: float = 0.99):
    """``(opt_net, opt_lam)``: Adam descent on ``params`` and Adam ascent on
    every λ tensor in ``lambdas`` (``opt_lam`` is ``None`` without any).
    On a CUDA device both are ``capturable`` (their step counts live on the
    device), so a CUDA graph can hold their updates."""
    for name, v in (("lr", lr), ("lr_weights", lr_weights)):
        if callable(v):
            raise NotImplementedError(
                f"{name} schedules are not ported yet (ROADMAP queue 1); "
                "pass a float")
    params = list(params)
    capturable = params[0].device.type == "cuda"
    opt_net = torch.optim.Adam(params, lr=float(lr), betas=(b1, 0.999),
                               capturable=capturable)
    lams = [lam for terms in lambdas.values() for lam in terms
            if lam is not None]
    opt_lam = (torch.optim.Adam(lams, lr=float(lr_weights),
                                betas=(b1, 0.999), maximize=True,
                                capturable=capturable)
               if lams else None)
    return opt_net, opt_lam


def clip_by_global_norm(tensors, max_norm: float):
    """``optax.clip_by_global_norm(max_norm)`` on the gradients of
    ``tensors``, in place: each becomes ``g / ‖g‖ · max_norm`` unless the
    global norm ``‖g‖`` is below ``max_norm``.  Device arithmetic only (the
    norm is never read on the host), so a CUDA graph can hold it."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, float(max_norm))
    for g, c in zip(grads, clipped):
        g.copy_(torch.where(keep, g, c))


def make_batches(X_f: torch.Tensor, batch_sz: Optional[int],
                 verbose: bool = True):
    """``(X_batched [n_b, bsz, d], idx_batched [n_b, bsz], n_batches)``, the
    single-device branch of the JAX package's ``make_batches``:
    ``idx_batched`` maps each batch row to its row of ``X_f`` (for the
    per-point λ gather).  Every row trains: when ``batch_sz`` does not
    divide the point count, the tail batch wraps to the front of the set."""
    n_f = int(X_f.shape[0])
    if batch_sz is None or batch_sz >= n_f:
        idx = torch.arange(n_f, device=X_f.device)[None]
        return X_f[None], idx, 1
    bsz = int(batch_sz)
    n_batches = -(-n_f // bsz)  # ceil: keep every row
    take = torch.arange(n_batches * bsz, device=X_f.device) % n_f
    if take.numel() != n_f and verbose:
        print(f"[fit] tail batch wraps {take.numel() - n_f} rows so "
              f"{bsz}-point batches cover every point", flush=True)
    X_batched = X_f.index_select(0, take).reshape(n_batches, bsz, -1)
    return X_batched, take.reshape(n_batches, bsz), n_batches


@dataclass
class FitResult:
    """Host-side training record (parity with the reference's ``self.losses``
    history and best-model tracking, ``models.py:17-25,117``)."""
    losses: list = field(default_factory=list)
    min_loss: dict = field(default_factory=lambda: {"adam": np.inf,
                                                    "l-bfgs": np.inf,
                                                    "overall": np.inf})
    best_epoch: dict = field(default_factory=lambda: {"adam": -1,
                                                      "l-bfgs": -1,
                                                      "overall": -1})
    best_params: dict = field(default_factory=lambda: {"adam": None,
                                                       "l-bfgs": None,
                                                       "overall": None})
    wall_time: dict = field(default_factory=dict)


def _device_scalar(v, dev) -> torch.Tensor:
    """A loss component as a 0-d tensor on ``dev``; a Python number (a term
    with nothing in it) becomes a fill, not a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.detach().reshape(())
    return torch.full((), float(v), device=dev)


class AdamStep:
    """One Adam(+SA) step over static buffers, the JAX chunk runner's
    ``step(carry, i)``: the batch ``b = i % n_batches`` (a device index into
    the batches and the per-point λ), the loss and its backward, the
    optional global-norm clipping, Adam on the network, Adam ascent on the
    λ, the step's loss components into row ``row`` of the chunk's history,
    and the best-iterate select.  :attr:`graph` runs it (captured and
    replayed on a CUDA device, :mod:`.graphs`).

    ``loss_fn(layers, lam_bcs, lam_res, X) -> (total, components)``;
    ``params`` is the network's live parameter list (``[W_0, b_0, ...]``),
    ``optimizers`` the :func:`make_optimizer` pair (kept by the caller so
    the moments persist).  A solver keeps its step across ``fit`` calls, so
    its graph is captured once."""

    def __init__(self, loss_fn: Callable, params: list, lambdas: dict,
                 X_f: torch.Tensor, optimizers: tuple,
                 batch_sz: Optional[int] = None,
                 grad_clip: Optional[float] = None, verbose: bool = True,
                 eager: bool = False, make_graph: Optional[Callable] = None):
        self.loss_fn = loss_fn
        self.params = list(params)
        self.layers = list(zip(self.params[0::2], self.params[1::2]))
        self.lambdas = lambdas
        self.X_f = X_f
        self.optimizers = optimizers
        self.batch_sz = batch_sz
        self.eager = eager
        self.grad_clip = None if grad_clip is None else float(grad_clip)
        self.X_batched, self.idx_batched, self.n_batches = make_batches(
            X_f, batch_sz, verbose)
        n_f = int(X_f.shape[0])
        # per-point λ ride the batch's rows; scalar (type-2) λ apply to the
        # whole term and pass through untouched
        self.per_point = [lam is not None and lam.ndim >= 1
                          and lam.shape[0] == n_f
                          for lam in lambdas["residual"]]
        dev = self.device = X_f.device
        self.counter = torch.zeros((), dtype=torch.long, device=dev)
        self.row = torch.zeros((), dtype=torch.long, device=dev)
        self.best_params = tree_copy(self.params)
        self.best_loss = torch.full((), float("inf"), device=dev)
        self.best_step = torch.full((), -1, dtype=torch.long, device=dev)
        self.keys = None
        self.hist = None
        self.rows = 0
        self.graph = StepGraph(self._step, self._keyed, dev, "Adam step",
                               eager=eager, make_graph=make_graph)

    def matches(self, loss_fn, optimizers, X_f, batch_sz, grad_clip,
                eager) -> bool:
        """Whether this step serves a ``fit`` with these inputs."""
        return (self.loss_fn is loss_fn and self.optimizers is optimizers
                and self.X_f is X_f and self.batch_sz == batch_sz
                and self.grad_clip == (None if grad_clip is None
                                       else float(grad_clip))
                and self.eager == eager)

    def _keyed(self) -> list:
        lams = [lam for terms in self.lambdas.values() for lam in terms
                if lam is not None]
        state = [v for opt in self.optimizers if opt is not None
                 for st in opt.state.values() for v in st.values()
                 if isinstance(v, torch.Tensor)]
        bufs = [self.X_f, self.X_batched, self.idx_batched, self.counter,
                self.row, self.best_loss, self.best_step]
        if self.hist is not None:
            bufs.append(self.hist)
        return self.params + lams + state + bufs + self.best_params

    def begin(self, rows: int):
        """Start a ``fit``: step counter 0, the best reset to the current
        parameters, room for ``rows`` history rows per chunk (a chunk's
        worth, so shorter fits keep the buffer and the graph)."""
        with torch.no_grad():
            self.counter.zero_()
            for bp, p in zip(self.best_params, self.params):
                bp.copy_(p)
            self.best_loss.fill_(float("inf"))
            self.best_step.fill_(-1)
        if self.hist is not None and self.hist.shape[0] < rows:
            # a new buffer: the graph's key moves and it is captured again
            self.hist = torch.zeros((rows, len(self.keys)), device=self.device)
        self.rows = max(self.rows, rows)

    def _batch(self):
        lam_res = self.lambdas["residual"]
        if self.n_batches == 1:
            return self.X_f, lam_res
        b = torch.remainder(self.counter, self.n_batches).reshape(1)
        X_b = self.X_batched.index_select(0, b)[0]
        idx = self.idx_batched.index_select(0, b)[0]
        return X_b, [lam.index_select(0, idx) if pp else lam
                     for lam, pp in zip(lam_res, self.per_point)]

    def _step(self):
        opt_net, opt_lam = self.optimizers
        opt_net.zero_grad(set_to_none=True)
        if opt_lam is not None:
            opt_lam.zero_grad(set_to_none=True)
        X_b, lam_res = self._batch()
        with span("fit_adam.loss"):
            total, comps = self.loss_fn(self.layers, self.lambdas["BCs"],
                                        lam_res, X_b)
        with span("fit_adam.backward"):
            total.backward()
        with span("fit_adam.adam"):
            if self.grad_clip is not None:
                clip_by_global_norm(self.params, self.grad_clip)
                if opt_lam is not None:
                    clip_by_global_norm(opt_lam.param_groups[0]["params"],
                                        self.grad_clip)
            opt_net.step()
            if opt_lam is not None:
                opt_lam.step()
        with span("fit_adam.record"), torch.no_grad():
            if self.hist is None:  # the first step, always an eager one
                self.keys = list(comps)
                self.hist = torch.zeros((self.rows, len(self.keys)),
                                        device=self.device)
            vals = torch.stack([_device_scalar(comps[k], self.device)
                                for k in self.keys])
            self.hist.index_copy_(0, self.row.reshape(1), vals[None])
            # best iterate: the params after this step, kept when the
            # step's loss improves — a device-side select, no host sync
            total = total.detach().reshape(())
            improved = total < self.best_loss
            for bp, p in zip(self.best_params, self.params):
                bp.copy_(torch.where(improved, p, bp))
            self.best_loss.copy_(torch.where(improved, total,
                                             self.best_loss))
            self.best_step.copy_(torch.where(improved, self.counter,
                                             self.best_step))
            self.counter.add_(1)
            self.row.add_(1)


def fit_adam(step: AdamStep, tf_iter: int, chunk: int = 100,
             verbose: bool = True, result: Optional[FitResult] = None,
             state_hook: Optional[Callable] = None,
             state_hook_every: int = 0) -> FitResult:
    """Run ``tf_iter`` Adam(+SA) epochs of ``step`` in place on its
    parameters and λ: ``tf_iter · n_batches`` steps in chunks of ``chunk ·
    n_batches``, so the batch index restarts at each chunk as in the JAX
    package.  Returns the record with one loss-component dict per epoch
    (its last batch's) and the best iterate (``best_epoch`` counts epochs).

    ``state_hook(epoch, best)`` + ``state_hook_every``: called at a chunk
    boundary that crosses a ``state_hook_every`` boundary (``epoch`` counts
    this call's epochs), with the live parameters and optimizers as they
    are then and ``best = (best_params, best_loss, best_epoch)``, the
    running best as device tensors: the mid-run checkpoint path."""
    result = result or FitResult()
    n_b = step.n_batches
    total_steps = tf_iter * n_b
    step.begin(chunk * n_b)
    t0 = time.time()
    done = 0
    while done < total_steps:
        n = min(chunk * n_b, total_steps - done)
        step.graph.check()
        step.row.zero_()
        for _ in range(n):
            with span("fit_adam.step"):
                step.graph()
        with span("fit_adam.read"):
            hist = step.hist[:n].cpu().numpy()  # one host copy per chunk
        # one entry per epoch: its last batch's
        for row in hist[n_b - 1::n_b]:
            result.losses.append({k: float(v)
                                  for k, v in zip(step.keys, row)})
        prev = done // n_b
        done += n
        epochs = done // n_b
        if (state_hook is not None and state_hook_every > 0
                and prev // state_hook_every != epochs // state_hook_every):
            state_hook(epochs, (step.best_params, step.best_loss,
                                torch.div(step.best_step, n_b,
                                          rounding_mode="floor")))
        if verbose:
            print(f"Adam epoch {epochs}/{tf_iter}: total loss "
                  f"{result.losses[-1]['Total Loss']:.6e}", flush=True)
    if step.device.type == "cuda":
        torch.cuda.synchronize(step.device)
    result.wall_time["adam"] = time.time() - t0
    result.best_params["adam"] = tree_copy(step.best_params)
    result.min_loss["adam"] = float(step.best_loss)
    result.best_epoch["adam"] = int(step.best_step) // n_b
    return result
