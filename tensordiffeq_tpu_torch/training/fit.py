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

Adaptive collocation (``resample_fn``, ``resample_every``;
:mod:`..ops.resampling`) redraws the collocation set at chunk boundaries.
A redraw is written INTO the step's buffers (:meth:`AdamStep.adopt`), so
the graph, which is keyed on their storage, is replayed on the new points
without a new capture.  A pipelined redraw runs on a stream of its own
(:func:`dispatch_redraw`) over a snapshot of the parameters of its dispatch
boundary, while the next chunk's replays update the live ones.

Learning-rate schedules (:mod:`.schedules`) run on the device: a
scheduled rate is a 0-d tensor the step rewrites from the Adam's own
device step count before each update (:func:`optimizer_step`).  NTK weighting
(``lambda_update_fn``) rewrites the frozen λ between chunks with ``copy_``,
and a causal ε ladder ends a phase early (``stop_fn``): neither replaces a
tensor the step's graph is keyed on.

Not ported yet (ROADMAP queue 1): the mesh branch of ``make_batches``,
telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.resampling import carry_rows
from ..utils import span, tree_copy
from .graphs import StepGraph
from .schedules import DeviceLR


def adam(groups, device: torch.device, b1: float = 0.99,
         maximize: bool = False) -> torch.optim.Adam:
    """A ``torch.optim.Adam`` over ``groups = [(params, rate), ...]``, one
    param group each, β = (``b1``, 0.999).  A float rate is the plain
    float path.  A callable rate is a schedule (:mod:`.schedules`): the
    group's ``lr`` is then the 0-d device tensor of a
    :class:`~.schedules.DeviceLR`, which :func:`optimizer_step` advances
    before each update, so a CUDA graph that holds the step evaluates the
    schedule on the group's Adam step count.  On a CUDA device the Adam is
    ``capturable`` (its step counts live on the device)."""
    pgs, scheds = [], {}
    for i, (params, rate) in enumerate(groups):
        if callable(rate):
            scheds[i] = DeviceLR(rate, device)
            rate = scheds[i].lr
        else:
            rate = float(rate)
        pgs.append({"params": list(params), "lr": rate})
    floats = [g["lr"] for g in pgs if not isinstance(g["lr"], torch.Tensor)]
    opt = torch.optim.Adam(pgs, lr=floats[0] if floats else pgs[0]["lr"],
                           betas=(b1, 0.999), maximize=maximize,
                           capturable=device.type == "cuda")
    opt.tdq_schedules = scheds
    return opt


def relink_schedules(opt):
    """Point each scheduled group's ``lr`` at its :class:`DeviceLR` again:
    ``load_state_dict`` replaces the groups' hyperparameters with copies
    (the count rides the restored Adam step counts)."""
    for i, sched in getattr(opt, "tdq_schedules", {}).items():
        opt.param_groups[i]["lr"] = sched.lr


def step_count(opt, group: dict) -> torch.Tensor:
    """The updates ``opt`` has applied to ``group``: its Adam step count
    as a 0-d int32 tensor on the step's device (0 before the first)."""
    for p in group["params"]:
        st = opt.state.get(p)
        if st and "step" in st:
            return st["step"].to(torch.int32)
    return torch.zeros((), dtype=torch.int32,
                       device=group["params"][0].device)


def schedule_tensors(opt) -> list:
    """The device tensors of ``opt``'s schedules (a graph's storage
    key)."""
    return [s.lr for s in getattr(opt, "tdq_schedules", {}).values()]


def optimizer_step(opt):
    """``opt.step()``, each schedule's rate written first at its group's
    step count."""
    for i, sched in getattr(opt, "tdq_schedules", {}).items():
        sched.advance(step_count(opt, opt.param_groups[i]))
    opt.step()


def make_optimizer(params, lambdas: dict, lr=0.005, lr_weights=0.005,
                   b1: float = 0.99, freeze_lambdas: bool = False):
    """``(opt_net, opt_lam)``: Adam descent on ``params`` and Adam ascent on
    every λ tensor in ``lambdas`` (``opt_lam`` is ``None`` without any, or
    under ``freeze_lambdas``: the JAX package's ``set_to_zero`` for λ that
    NTK weighting recomputes between chunks).  ``lr`` and ``lr_weights``
    are floats or schedules (:func:`adam`)."""
    params = list(params)
    dev = params[0].device
    opt_net = adam([(params, lr)], dev, b1)
    lams = [lam for terms in lambdas.values() for lam in terms
            if lam is not None]
    opt_lam = (adam([(lams, lr_weights)], dev, b1, maximize=True)
               if lams and not freeze_lambdas else None)
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
                 verbose: bool = True, permute: bool = False):
    """``(X_batched [n_b, bsz, d], idx_batched [n_b, bsz], n_batches)``, the
    single-device branch of the JAX package's ``make_batches``:
    ``idx_batched`` maps each batch row to its row of ``X_f`` (for the
    per-point λ gather).  Every row trains: when ``batch_sz`` does not
    divide the point count, the tail batch wraps to the front of the set.

    ``permute=True``: the rows are shuffled by ``np.random.RandomState(0)``
    before batching (the JAX package's permutation, row for row), so a
    batch of an ordered set (an observation grid) covers the domain
    instead of being a thin slab of it."""
    n_f = int(X_f.shape[0])
    if batch_sz is None or batch_sz >= n_f:
        idx = torch.arange(n_f, device=X_f.device)[None]
        return X_f[None], idx, 1
    bsz = int(batch_sz)
    n_batches = -(-n_f // bsz)  # ceil: keep every row
    take = np.arange(n_batches * bsz) % n_f
    if take.size != n_f and verbose:
        print(f"[fit] tail batch wraps {take.size - n_f} rows so "
              f"{bsz}-point batches cover every point", flush=True)
    if permute:
        take = np.random.RandomState(0).permutation(n_f)[take]
    take = torch.as_tensor(take, device=X_f.device)
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
    # one record per redraw (dispatched, adopted or discarded), see fit_adam
    redraws: list = field(default_factory=list)
    # host seconds of each chunk, from its first step to its history read
    chunk_seconds: list = field(default_factory=list)


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
        scheds = [t for opt in self.optimizers if opt is not None
                  for t in schedule_tensors(opt)]
        bufs = [self.X_f, self.X_batched, self.idx_batched, self.counter,
                self.row, self.best_loss, self.best_step]
        if self.hist is not None:
            bufs.append(self.hist)
        return (self.params + lams + state + scheds + bufs
                + self.best_params)

    def adopt(self, X_new: torch.Tensor, swap=None):
        """Adopt a redrawn collocation set: written into ``X_f`` and the
        batch buffers with ``copy_`` (the graph's storage key holds, so the
        graph replays on the new points without a new capture), and the
        running best's loss reset to +inf (losses on different point sets
        do not compare; the JAX package's ``_adopt_points``).  With the
        redraw's ``swap`` (:class:`~..ops.resampling.ResampleSwap`), each
        per-point residual λ rides :func:`~..ops.resampling.carry_rows`
        (kept rows gathered, fresh rows at the kept mean) and its λ-ascent
        Adam moments follow the same map with fresh rows at zero
        (``_carry_point_state``).  Returns the largest λ drift (a 0-d
        tensor), or ``None`` when nothing was carried."""
        if tuple(X_new.shape) != tuple(self.X_f.shape):
            raise ValueError(
                f"resample redraw changed the collocation shape "
                f"{tuple(self.X_f.shape)} -> {tuple(X_new.shape)}; the "
                "redraw must keep N_f so the step and its graph are reused")
        drift = None
        opt_lam = self.optimizers[1]
        with torch.no_grad():
            if swap is not None:
                for lam, pp in zip(self.lambdas["residual"], self.per_point):
                    if not pp:
                        continue
                    new, d = carry_rows(lam, swap.idx, swap.kept)
                    state = opt_lam.state.get(lam, {}) if opt_lam else {}
                    for key in ("exp_avg", "exp_avg_sq"):
                        if key in state:
                            state[key].copy_(carry_rows(
                                state[key], swap.idx, swap.kept,
                                fresh_zero=True)[0])
                    lam.copy_(new)
                    drift = d if drift is None else torch.maximum(drift, d)
            self.X_f.copy_(X_new)
            if self.n_batches > 1:
                self.X_batched.copy_(self.X_f.index_select(
                    0, self.idx_batched.reshape(-1)).reshape(
                        self.X_batched.shape))
            self.best_loss.fill_(float("inf"))
        return drift

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
            total, comps = self.loss_fn(
                self.layers, self.lambdas["BCs"], lam_res, X_b,
                lam_data=self.lambdas.get("data", [None])[0])
        with span("fit_adam.backward"):
            total.backward()
        with span("fit_adam.adam"):
            if self.grad_clip is not None:
                clip_by_global_norm(self.params, self.grad_clip)
                if opt_lam is not None:
                    clip_by_global_norm(opt_lam.param_groups[0]["params"],
                                        self.grad_clip)
            optimizer_step(opt_net)
            if opt_lam is not None:
                optimizer_step(opt_lam)
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


_redraw_streams: dict = {}


def redraw_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream pipelined redraws run on, one per device: not the
    graphs' warm-up and capture stream (:func:`.graphs.side_stream`)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _redraw_streams:
        _redraw_streams[index] = torch.cuda.Stream(index)
    return _redraw_streams[index]


class PendingRedraw:
    """A redraw dispatched at a chunk boundary and not adopted yet: its
    :class:`~..ops.resampling.ResampleSwap` (device tensors), its epoch and
    the host seconds its dispatch took; on a CUDA device also the events
    that bracket it on the redraw stream."""

    def __init__(self, swap, epoch: int, dispatch_s: float, start=None,
                 done=None):
        self.swap, self.epoch, self.dispatch_s = swap, epoch, dispatch_s
        self.start, self.done = start, done

    def join(self, device: torch.device):
        """Make the current stream wait for the redraw (on the device; the
        host does not wait) and hand its tensors over to that stream, so
        their memory is not reused before the stream is done with them."""
        if self.done is None:
            return
        stream = torch.cuda.current_stream(device)
        stream.wait_event(self.done)
        sw = self.swap
        for t in (sw.X_new, sw.idx, sw.kept, *sw.stats.values()):
            t.record_stream(stream)

    def device_ms(self) -> Optional[float]:
        """Device milliseconds of the redraw on its stream, by its CUDA
        events (``None`` off the card); call after a synchronisation."""
        if self.done is None:
            return None
        return self.start.elapsed_time(self.done)


def dispatch_redraw(redraw: Callable, params: list, X_f: torch.Tensor,
                    epoch: int) -> PendingRedraw:
    """Dispatch ``redraw(layers, X_f, epoch) -> ResampleSwap`` at a chunk
    boundary.  On a CUDA device: the parameters are snapshot on the current
    stream (the next chunk's replays update the live ones in place), the
    redraw stream waits for that and runs the redraw, and the snapshot is
    marked as used there, so the host returns as soon as the redraw is
    issued.  ``X_f`` is read there too; it is written only at the swap,
    after :meth:`PendingRedraw.join`.  On the CPU the redraw runs now."""
    t0 = time.perf_counter()
    dev = X_f.device
    if dev.type != "cuda":
        layers = list(zip(params[0::2], params[1::2]))
        swap = redraw([(W.detach(), b.detach()) for W, b in layers], X_f,
                      epoch)
        return PendingRedraw(swap, epoch, time.perf_counter() - t0)
    main = torch.cuda.current_stream(dev)
    side = redraw_stream(dev)
    with torch.no_grad():
        snap = [p.detach().clone() for p in params]
    side.wait_stream(main)
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record(side)
        swap = redraw(list(zip(snap[0::2], snap[1::2])), X_f, epoch)
        done.record(side)
    for t in snap:
        t.record_stream(side)
    return PendingRedraw(swap, epoch, time.perf_counter() - t0, start, done)


def _redraw_record(pending: PendingRedraw, adopted, stall_s, drift) -> dict:
    return {"epoch": pending.epoch, "adopted": adopted,
            "dispatch_s": pending.dispatch_s, "stall_s": stall_s,
            "pending": pending, "drift": drift}


def _finish_records(records: list):
    """Fill each record's device numbers in (after a synchronisation)."""
    for rec in records:
        pending = rec.pop("pending", None)
        if pending is None:
            continue
        rec["device_ms"] = pending.device_ms()
        stats = {k: float(v) for k, v in pending.swap.stats.items()}
        drift = rec.pop("drift", None)
        if drift is not None:
            stats["lambda_drift"] = float(drift)
        rec["stats"] = stats


def _write_lambdas(step: AdamStep, new: dict):
    """Write recomputed λ (0-d tensors) into the step's λ in place."""
    with torch.no_grad():
        for key, vals in new.items():
            for lam, v in zip(step.lambdas.get(key, []), vals):
                if lam is not None:
                    lam.copy_(v.reshape(lam.shape))


def fit_adam(step: AdamStep, tf_iter: int, chunk: int = 100,
             verbose: bool = True, result: Optional[FitResult] = None,
             state_hook: Optional[Callable] = None,
             state_hook_every: int = 0,
             resample_fn: Optional[Callable] = None,
             resample_every: int = 0,
             lambda_update_fn: Optional[Callable] = None,
             stop_fn: Optional[Callable] = None,
             epoch_offset: int = 0) -> FitResult:
    """Run ``tf_iter`` Adam(+SA) epochs of ``step`` in place on its
    parameters and λ: ``tf_iter · n_batches`` steps in chunks of ``chunk ·
    n_batches``, so the batch index restarts at each chunk as in the JAX
    package.  Returns the record with one loss-component dict per epoch
    (its last batch's) and the best iterate (``best_epoch`` counts epochs).

    ``state_hook(epoch, best)`` + ``state_hook_every``: called at a chunk
    boundary that crosses a ``state_hook_every`` boundary (``epoch`` counts
    this call's epochs), with the live parameters and optimizers as they
    are then and ``best = (best_params, best_loss, best_epoch)``, the
    running best as device tensors: the mid-run checkpoint path.

    ``resample_fn`` + ``resample_every``: adaptive collocation at the chunk
    boundaries that cross a ``resample_every`` boundary, never at the last.
    A pipelined hook (``resample_fn.pipelined``, with ``redraw(layers,
    X_f, epoch) -> ResampleSwap``) is dispatched there
    (:func:`dispatch_redraw`) and adopted at the NEXT boundary, λ carried
    (:meth:`AdamStep.adopt`), so its work runs behind the chunk between
    them; a redraw still pending when the phase ends is discarded (it
    trained no step), after it has finished on its stream.  Any other hook
    is called as ``resample_fn(layers, epoch) -> X_new`` and adopted at
    once.  Each redraw adds a record to ``result.redraws``: ``epoch``
    (dispatched), ``adopted`` (the epoch, or ``None`` if discarded),
    ``dispatch_s`` and ``stall_s`` (host seconds to issue it and to swap it
    in), ``device_ms`` (CUDA events on its stream; ``None`` off the card)
    and ``stats`` (kept fraction, score gain, λ drift).  The JAX package
    calls the host seconds ``data_s``; its telemetry is not ported.

    ``lambda_update_fn(layers) -> {"BCs": [...], "residual": [...][,
    "data": [...]]}`` (NTK weighting, :mod:`..ops.ntk`): called before the
    first step and at every chunk boundary with steps left (after any
    redraw, so the balance follows the points being trained); its 0-d
    weights are written into the step's λ with ``copy_``, so the step's
    graph replays on without a new capture.

    ``stop_fn(result) -> bool``: checked at every chunk boundary; true ends
    the phase there (the causal ε ladder hands the rest of the budget to
    its next stage).

    ``epoch_offset`` is added to every epoch the hooks are handed (and the
    redraw records keep): the epochs earlier stages of a causal ε ladder
    trained.  The boundaries stay counted from this call's start."""
    result = result or FitResult()
    n_b = step.n_batches
    total_steps = tf_iter * n_b
    step.begin(chunk * n_b)
    pipelined = bool(getattr(resample_fn, "pipelined", False))
    pending = None
    records = []
    t0 = time.time()
    done = 0
    if lambda_update_fn is not None and total_steps > 0:
        _write_lambdas(step, lambda_update_fn(step.layers))
    while done < total_steps:
        n = min(chunk * n_b, total_steps - done)
        t_chunk = time.perf_counter()
        step.graph.check()
        step.row.zero_()
        for _ in range(n):
            with span("fit_adam.step"):
                step.graph()
        with span("fit_adam.read"):
            hist = step.hist[:n].cpu().numpy()  # one host copy per chunk
        result.chunk_seconds.append(time.perf_counter() - t_chunk)
        # one entry per epoch: its last batch's
        for row in hist[n_b - 1::n_b]:
            result.losses.append({k: float(v)
                                  for k, v in zip(step.keys, row)})
        prev = done // n_b
        done += n
        epochs = done // n_b
        if pending is not None and done >= total_steps:
            # the phase is over: the pending redraw trained no step
            pending.join(step.device)
            records.append(_redraw_record(pending, None, None, None))
            pending = None
        if pending is not None:
            with span("fit_adam.swap"):
                t_sw = time.perf_counter()
                pending.join(step.device)
                drift = step.adopt(pending.swap.X_new, pending.swap)
                records.append(_redraw_record(
                    pending, epochs + epoch_offset,
                    time.perf_counter() - t_sw, drift))
            pending = None
        if (resample_fn is not None and resample_every > 0
                and done < total_steps
                and prev // resample_every != epochs // resample_every):
            with span("fit_adam.redraw"):
                at = epochs + epoch_offset
                if pipelined:
                    pending = dispatch_redraw(resample_fn.redraw, step.params,
                                              step.X_f, at)
                else:
                    t_rd = time.perf_counter()
                    layers = [(W.detach(), b.detach()) for W, b in
                              zip(step.params[0::2], step.params[1::2])]
                    step.adopt(resample_fn(layers, at))
                    records.append({"epoch": at, "adopted": at,
                                    "dispatch_s": time.perf_counter() - t_rd,
                                    "stall_s": 0.0, "device_ms": None,
                                    "stats": {}})
        if lambda_update_fn is not None and done < total_steps:
            _write_lambdas(step, lambda_update_fn(step.layers))
        if (state_hook is not None and state_hook_every > 0
                and prev // state_hook_every != epochs // state_hook_every):
            state_hook(epochs + epoch_offset,
                       (step.best_params, step.best_loss,
                        torch.div(step.best_step, n_b, rounding_mode="floor")
                        + epoch_offset))
        if verbose:
            print(f"Adam epoch {epochs}/{tf_iter}: total loss "
                  f"{result.losses[-1]['Total Loss']:.6e}", flush=True)
        if stop_fn is not None and done < total_steps and stop_fn(result):
            if pending is not None:
                pending.join(step.device)
                records.append(_redraw_record(pending, None, None, None))
                pending = None
            break
    if step.device.type == "cuda":
        torch.cuda.synchronize(step.device)
    _finish_records(records)
    result.redraws.extend(records)
    result.wall_time["adam"] = time.time() - t0
    result.best_params["adam"] = tree_copy(step.best_params)
    result.min_loss["adam"] = float(step.best_loss)
    result.best_epoch["adam"] = int(step.best_step) // n_b
    return result
