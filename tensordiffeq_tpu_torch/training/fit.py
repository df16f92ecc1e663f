"""Training engine: chunked Adam epochs with self-adaptive λ ascent.

Counterpart of the JAX package's ``training/fit.py`` (``make_optimizer``,
``_chunk_runner``, ``fit_adam``).  There a chunk of epochs is one
``lax.scan`` under ``jit``; here it is a Python loop of eager steps that
never synchronises with the host inside the chunk: the loss components of
every step stay on the device and come back in one copy per chunk, and the
best-model snapshot is a ``torch.where`` select on the device (a true copy,
fixing the reference's aliasing best-model bug).

The optimizer is the JAX package's ``optax.multi_transform`` written as two
``torch.optim.Adam``: descent on the network parameters, and ascent on the
λ (``maximize=True``, the same update as ``optax.chain(scale(-1), adam)``),
both with the reference's ``lr=0.005, beta_1=0.99``.

Not ported yet (ROADMAP queue 1): minibatching (``batch_sz``), learning-rate
schedules, gradient clipping, resampling, telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import span, tree_copy


def make_optimizer(params, lambdas: dict, lr: float = 0.005,
                   lr_weights: float = 0.005, b1: float = 0.99):
    """``(opt_net, opt_lam)``: Adam descent on ``params`` and Adam ascent on
    every λ tensor in ``lambdas`` (``opt_lam`` is ``None`` without any)."""
    for name, v in (("lr", lr), ("lr_weights", lr_weights)):
        if callable(v):
            raise NotImplementedError(
                f"{name} schedules are not ported yet (ROADMAP queue 1); "
                "pass a float")
    opt_net = torch.optim.Adam(list(params), lr=float(lr), betas=(b1, 0.999))
    lams = [lam for terms in lambdas.values() for lam in terms
            if lam is not None]
    opt_lam = (torch.optim.Adam(lams, lr=float(lr_weights),
                                betas=(b1, 0.999), maximize=True)
               if lams else None)
    return opt_net, opt_lam


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


def fit_adam(loss_fn: Callable, params: list, lambdas: dict,
             X_f: torch.Tensor, tf_iter: int, optimizers: tuple,
             chunk: int = 100, verbose: bool = True,
             result: Optional[FitResult] = None,
             state_hook: Optional[Callable] = None,
             state_hook_every: int = 0) -> FitResult:
    """Run ``tf_iter`` Adam(+SA) epochs in place on ``params`` / ``lambdas``.

    ``loss_fn(params, lam_bcs, lam_res, X) -> (total, components)``;
    ``params`` is the network's live parameter list (``[W_0, b_0, ...]`` in
    layer pairs), ``optimizers`` the :func:`make_optimizer` pair (kept by
    the caller so the Adam moments persist across calls).  Returns the
    record with one loss-component dict per epoch and the best iterate.

    ``state_hook(epoch, best)`` + ``state_hook_every``: called at a chunk
    boundary that crosses a ``state_hook_every`` boundary (``epoch`` counts
    this call's steps), with the live parameters and optimizers as they are
    then and ``best = (best_params, best_loss, best_epoch)``, the running
    best as device tensors: the mid-run checkpoint path."""
    result = result or FitResult()
    opt_net, opt_lam = optimizers
    layers = list(zip(params[0::2], params[1::2]))
    dev = X_f.device
    best_params = tree_copy(params)
    best_loss = torch.tensor(float("inf"), device=dev)
    best_step = torch.tensor(-1, device=dev)
    # step numbers live on the device: a tensor made from a Python int per
    # step would be a host-to-device copy, which waits for the stream
    step_ids = torch.arange(tf_iter, device=dev)
    keys = None
    t0 = time.time()
    step = 0
    while step < tf_iter:
        n = min(chunk, tf_iter - step)
        rows = []
        for i in range(n):
            opt_net.zero_grad(set_to_none=True)
            if opt_lam is not None:
                opt_lam.zero_grad(set_to_none=True)
            with span("fit_adam.loss"):
                total, comps = loss_fn(layers, lambdas["BCs"],
                                       lambdas["residual"], X_f)
            with span("fit_adam.backward"):
                total.backward()
            with span("fit_adam.adam"):
                opt_net.step()
                if opt_lam is not None:
                    opt_lam.step()
            if keys is None:
                keys = list(comps)
            with span("fit_adam.record"), torch.no_grad():
                rows.append(torch.stack([_device_scalar(comps[k], dev)
                                         for k in keys]))
                # best iterate: the params after this step, kept when the
                # step's loss improves — a device-side select, no host sync
                total = total.detach().reshape(())
                improved = total < best_loss
                for bp, p in zip(best_params, params):
                    bp.copy_(torch.where(improved, p, bp))
                best_loss = torch.where(improved, total, best_loss)
                best_step = torch.where(improved, step_ids[step + i],
                                        best_step)
        hist = torch.stack(rows).cpu().numpy()  # one host copy per chunk
        for row in hist:
            result.losses.append({k: float(v) for k, v in zip(keys, row)})
        prev, step = step, step + n
        if (state_hook is not None and state_hook_every > 0
                and prev // state_hook_every != step // state_hook_every):
            state_hook(step, (best_params, best_loss, best_step))
        if verbose:
            print(f"Adam epoch {step}/{tf_iter}: total loss "
                  f"{result.losses[-1]['Total Loss']:.6e}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.wall_time["adam"] = time.time() - t0
    result.best_params["adam"] = best_params
    result.min_loss["adam"] = float(best_loss)
    result.best_epoch["adam"] = int(best_step)
    return result
