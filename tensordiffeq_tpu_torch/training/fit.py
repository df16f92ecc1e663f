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

Telemetry (``telemetry=``, :mod:`..telemetry.hooks`) and the evaluation
hook (``callback``) run at chunk boundaries, around the chunk's one host
read: they add no synchronisation inside a chunk.  A subscriber that asks
for the gradient norm gets a step that records it (``grad_norm=True``, a
step and a capture of its own); without one the step is the plain one.

The resilience boundary (:mod:`..resilience`) runs at every chunk boundary
but the last, after the chunk's one host read, in the JAX loop's order: the
cluster heartbeat (:func:`~..resilience.cluster.beat`), the telemetry, the
redraws and ``state_hook``, then the active chaos plan's
``on_train_boundary`` (which may fill the live parameters with NaN, in
place, so the next replay reads them) and the preemption check: a pending
request flushes the state through ``state_hook`` and raises
:class:`~..resilience.Preempted`.  None of it synchronises with the card.

Data parallelism (``mesh``, :mod:`..parallel`): each rank runs the step
on its block of the points and per-point λ, with the loss divided by the
world size; between the backward pass and the optimizer the gradients of
the parameters and of the replicated λ, the loss components and (for the
global norm) the per-point λ gradient's squared norm are summed over the
ranks by one all-reduce.  A CUDA graph holds it under NCCL; under gloo the
step runs eagerly.  ``make_batches`` batches each rank's own block with
the JAX package's per-shard index map.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.resampling import carry_rows, carry_rows_family
from ..parallel import all_gather_rows, sum_components
from ..resilience.chaos import active_chaos
from ..resilience.cluster import beat
from ..resilience.preemption import (Preempted, note_final_flush,
                                     preemption_requested)
from ..telemetry import log_event
from ..telemetry.tracing import active_tracer
from ..utils import device_scalar, span, tree_copy
from .graphs import StepGraph, host_bound
from .progress import progress_bar
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


def init_adam_state(opt):
    """Make the state ``torch.optim.Adam`` makes at its first step now, so
    a member-stacked step can hold a frozen member's moments from its
    first step on."""
    if opt is None:
        return
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            st["step"] = (torch.zeros((), dtype=torch.float32,
                                      device=p.device)
                          if group["capturable"] or group["fused"]
                          else torch.tensor(0.0, dtype=torch.float32))
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)


def set_rates(opts, lr, lr_weights):
    """Give a :func:`make_optimizer` pair new rates in place, its moments
    and step counts kept (the JAX solver rebuilds its optax chain from the
    solver's rates at every ``fit`` over the state it keeps).  A float rate
    is read when a step is captured, so a captured step must be captured
    anew; a schedule gets a new :class:`DeviceLR`, whose tensor moves the
    step's storage key."""
    for opt, rate in zip(opts, (lr, lr_weights)):
        if opt is None:
            continue
        group = opt.param_groups[0]
        if callable(rate):
            opt.tdq_schedules[0] = DeviceLR(rate, group["params"][0].device)
            group["lr"] = opt.tdq_schedules[0].lr
        else:
            opt.tdq_schedules.pop(0, None)
            group["lr"] = float(rate)


def clip_by_global_norm(tensors, max_norm: float):
    """``optax.clip_by_global_norm(max_norm)`` on the gradients of
    ``tensors``, in place: each becomes ``g / ‖g‖ · max_norm`` unless the
    global norm ``‖g‖`` is below ``max_norm``.  Device arithmetic only (the
    norm is never read on the host), so a CUDA graph can hold it."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if grads:
        clip_to_norm(tensors, max_norm, torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))))


def clip_to_norm(tensors, max_norm: float, norm: torch.Tensor):
    """:func:`clip_by_global_norm` at a given global ``norm`` (a 0-d device
    tensor): the norm over more than ``tensors``, such as every rank's
    per-point λ under data parallelism."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    keep = norm < max_norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, float(max_norm))
    for g, c in zip(grads, clipped):
        g.copy_(torch.where(keep, g, c))


def batch_index_map(n_f: int, batch_sz: int, n_dev: int,
                    permute: bool = False, verbose: bool = True):
    """The JAX package's per-shard index map (its ``make_batches(mesh=)``)
    of ``n_f`` global rows over ``n_dev`` ranks: ``[n_b, bsz]`` global
    rows, batch ``b`` taking ``bsz/n_dev`` rows of EVERY rank's contiguous
    block ``[k·n_f/n_dev, (k+1)·n_f/n_dev)`` (wrapping within the block),
    so each rank's part of a batch is rows of its own block.  ``batch_sz``
    is rounded down to a multiple of ``n_dev`` (logged).  ``permute``:
    every rank's block is shuffled by the k-th of ``n_dev`` permutations
    that ``np.random.RandomState(0)`` draws in order, as JAX does."""
    bsz = int(batch_sz)
    if bsz % n_dev:
        orig = bsz
        bsz = max(bsz - bsz % n_dev, n_dev)
        log_event("fit", f"batch_sz {orig} -> {bsz} so each of the {n_dev} "
                  "devices gets equal batch rows", verbose=verbose)
    shard_rows = n_f // n_dev
    bsz_local = bsz // n_dev
    n_batches = -(-shard_rows // bsz_local)  # ceil: keep every row
    if permute:
        rs = np.random.RandomState(0)
        base = np.stack([rs.permutation(shard_rows) for _ in range(n_dev)])
    else:
        base = np.tile(np.arange(shard_rows), (n_dev, 1))
    take = np.arange(n_batches * bsz_local) % shard_rows
    if take.size != shard_rows:
        log_event("fit", f"tail batch wraps {take.size - shard_rows} rows "
                  f"per shard so {bsz}-point batches cover every point",
                  verbose=verbose)
    idx = base[:, take] + (np.arange(n_dev) * shard_rows)[:, None]
    idx = idx.reshape(n_dev, n_batches, bsz_local)
    return np.swapaxes(idx, 0, 1).reshape(n_batches, bsz)


def make_batches(X_f: torch.Tensor, batch_sz: Optional[int],
                 verbose: bool = True, permute: bool = False, mesh=None):
    """``(X_batched [n_b, bsz, d], idx_batched [n_b, bsz], n_batches)``, the
    JAX package's ``make_batches``: ``idx_batched`` maps each batch row to
    its row of ``X_f`` (for the per-point λ gather).  Every row trains:
    when ``batch_sz`` does not divide the point count, the tail batch
    wraps to the front of the set.

    ``permute=True``: the rows are shuffled by ``np.random.RandomState(0)``
    before batching (the JAX package's permutation, row for row), so a
    batch of an ordered set (an observation grid) covers the domain
    instead of being a thin slab of it.

    ``mesh`` (:class:`~..parallel.DataMesh`): ``X_f`` is this rank's block
    of a global set of ``w·len(X_f)`` rows, and the batches are this
    rank's columns of :func:`batch_index_map`, as local rows: ``[n_b,
    bsz/w, d]``."""
    n_f = int(X_f.shape[0])
    w = 1 if mesh is None else mesh.size
    if batch_sz is None or batch_sz >= n_f * w:
        idx = torch.arange(n_f, device=X_f.device)[None]
        return X_f[None], idx, 1
    if w > 1:
        glob = batch_index_map(n_f * w, batch_sz, w, permute=permute,
                               verbose=verbose)
        k = glob.shape[1] // w
        local = glob[:, mesh.rank * k:(mesh.rank + 1) * k] - mesh.rank * n_f
        take = torch.as_tensor(local.reshape(-1), device=X_f.device)
        n_batches = local.shape[0]
        X_batched = X_f.index_select(0, take).reshape(n_batches, k, -1)
        return X_batched, take.reshape(n_batches, k), n_batches
    bsz = int(batch_sz)
    n_batches = -(-n_f // bsz)  # ceil: keep every row
    take = np.arange(n_batches * bsz) % n_f
    if take.size != n_f:
        log_event("fit", f"tail batch wraps {take.size - n_f} rows so "
                  f"{bsz}-point batches cover every point", verbose=verbose)
    if permute:
        take = np.random.RandomState(0).permutation(n_f)[take]
    take = torch.as_tensor(take, device=X_f.device)
    X_batched = X_f.index_select(0, take).reshape(n_batches, bsz, -1)
    return X_batched, take.reshape(n_batches, bsz), n_batches


def _masked(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A member mask ``[M]`` shaped to broadcast over ``t [M, ...]``."""
    return mask.reshape((-1,) + (1,) * (t.ndim - 1))


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


class AdamStep:
    """One Adam(+SA) step over static buffers, the JAX chunk runner's
    ``step(carry, i)``: the batch ``b = i % n_batches`` (a device index into
    the batches and the per-point λ), the loss and its backward, the
    optional global-norm clipping, Adam on the network, Adam ascent on the
    λ, the step's loss components into row ``row`` of the chunk's history,
    and the best-iterate select.  ``grad_norm=True`` adds the global norm
    of the gradients (network and λ, before clipping) to the history as
    ``"Grad_norm"``, the JAX chunk runner's ``with_grad_norm``.
    :attr:`graph` runs it (captured and replayed on a CUDA device,
    :mod:`.graphs`).

    ``loss_fn(params, lam_bcs, lam_res, X) -> (total, components)``;
    ``params`` is the network's live flat parameter list (its
    ``params()``: ``[W_0, b_0, ...]`` for an MLP), which the loss takes,
    ``optimizers`` the :func:`make_optimizer` pair (kept by the caller so
    the moments persist).  A solver keeps its step across ``fit`` calls, so
    its graph is captured once.

    ``alive`` (a ``[M]`` bool device mask) gives the step a leading
    **member axis** (the surrogate factory, :mod:`..factory`): every
    parameter, λ, moment and ``X_f`` is stacked over ``M`` independent
    members, ``loss_fn`` returns ``(totals [M], components {name: [M]})``
    and the members' totals are summed before the one backward pass (a
    member's gradient is its own loss's).  ``Grad_norm`` is then each
    member's norm; a member whose total or norm is non-finite is frozen
    (its parameters, λ and moments selected back after Adam, a
    ``torch.where`` on ``alive``, no host read) and the history records
    ``Alive``; the best iterate is per member, and persists across fits
    with the counter at the global epoch (:meth:`begin`).  Under a
    ``mesh`` each rank holds whole members: no collective runs in the
    step, and :meth:`read` gathers the chunk's history."""

    def __init__(self, loss_fn: Callable, params: list, lambdas: dict,
                 X_f: torch.Tensor, optimizers: tuple,
                 batch_sz: Optional[int] = None,
                 grad_clip: Optional[float] = None, verbose: bool = True,
                 eager: bool = False, make_graph: Optional[Callable] = None,
                 grad_norm: bool = False, mesh=None,
                 alive: Optional[torch.Tensor] = None):
        self.loss_fn = loss_fn
        self.alive = alive
        self.members = None if alive is None else int(alive.shape[0])
        self.grad_norm = bool(grad_norm) or alive is not None
        self.params = list(params)
        self.lambdas = lambdas
        self.X_f = X_f
        self.optimizers = optimizers
        self.batch_sz = batch_sz
        self.eager = eager
        self.mesh = mesh
        self.grad_clip = None if grad_clip is None else float(grad_clip)
        self.X_batched, self.idx_batched, self.n_batches = make_batches(
            X_f, batch_sz, verbose, mesh=mesh)
        ax = 0 if alive is None else 1  # the rows' axis
        n_f = int(X_f.shape[ax])
        # per-point λ ride the batch's rows; scalar (type-2) λ apply to the
        # whole term and pass through untouched
        self.per_point = [lam is not None and lam.ndim > ax
                          and lam.shape[ax] == n_f
                          for lam in lambdas["residual"]]
        pp = {id(lam) for lam, p in zip(lambdas["residual"],
                                        self.per_point) if p}
        opt_lam = optimizers[1]
        lam_params = opt_lam.param_groups[0]["params"] if opt_lam else []
        # under data parallelism the per-point λ gradient stays local and
        # the replicated λ's is summed with the parameters'
        self._lam_local = [t for t in lam_params if id(t) in pp]
        self._lam_shared = [t for t in lam_params if id(t) not in pp]
        dev = self.device = X_f.device
        if host_bound(mesh, dev) and not eager and alive is None:
            log_event("parallel", f"the {mesh.backend} backend's all-reduce "
                      "cannot be captured in a CUDA graph; the "
                      "data-parallel Adam step runs eagerly",
                      verbose=verbose, backend=mesh.backend)
            eager = True
        self.graph_eager = eager
        self.counter = torch.zeros((), dtype=torch.long, device=dev)
        self.row = torch.zeros((), dtype=torch.long, device=dev)
        m_shape = () if alive is None else (self.members,)
        self.best_params = tree_copy(self.params)
        self.best_loss = torch.full(m_shape, float("inf"), device=dev)
        self.best_step = torch.full(m_shape, -1, dtype=torch.long,
                                    device=dev)
        self.tracked = []
        if alive is not None:
            for opt in optimizers:
                init_adam_state(opt)
            # what a frozen member keeps: its leaves and their moments
            self.tracked = [t for opt in optimizers if opt is not None
                            for p in opt.param_groups[0]["params"]
                            for t in (p, opt.state[p]["exp_avg"],
                                      opt.state[p]["exp_avg_sq"])]
        self.keys = None
        self.hist = None
        self.rows = 0
        self.graph = StepGraph(self._step, self._keyed, dev,
                               "Adam step" if alive is None
                               else "family step",
                               eager=eager, make_graph=make_graph)

    def matches(self, loss_fn, optimizers, X_f, batch_sz, grad_clip,
                eager, grad_norm: bool = False) -> bool:
        """Whether this step serves a ``fit`` with these inputs."""
        return (self.loss_fn is loss_fn and self.optimizers is optimizers
                and self.X_f is X_f and self.batch_sz == batch_sz
                and self.grad_clip == (None if grad_clip is None
                                       else float(grad_clip))
                and self.eager == eager
                and self.grad_norm == bool(grad_norm))

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
        if self.alive is not None:
            bufs.append(self.alive)
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
        (``_carry_point_state``).  A swap with a ``block`` (the group's
        global selection under data parallelism) carries the λ and moments
        gathered over the ranks and keeps this rank's block of the result,
        so a kept row that changed owner brings its λ along.  With a member
        axis each member's rows ride its own map
        (:func:`~..ops.resampling.carry_rows_family`) and the per-member
        best is kept (the JAX package's family does not reset it).
        Returns the largest λ drift (a 0-d tensor), or ``None`` when
        nothing was carried."""
        if tuple(X_new.shape) != tuple(self.X_f.shape):
            raise ValueError(
                f"resample redraw changed the collocation shape "
                f"{tuple(self.X_f.shape)} -> {tuple(X_new.shape)}; the "
                "redraw must keep N_f so the step and its graph are reused")
        drift = None
        opt_lam = self.optimizers[1]
        with torch.no_grad():
            if swap is not None:
                block = slice(*swap.block) if swap.block is not None \
                    else slice(None)

                def carry(rows, fresh_zero=False):
                    if self.members is not None:
                        new, d = carry_rows_family(rows, swap.idx, swap.kept,
                                                   fresh_zero=fresh_zero)
                        return new, torch.max(d)
                    if swap.block is not None:
                        rows = all_gather_rows(rows, self.mesh)
                    new, d = carry_rows(rows, swap.idx, swap.kept,
                                        fresh_zero=fresh_zero)
                    return new[block], d

                for lam, pp in zip(self.lambdas["residual"], self.per_point):
                    if not pp:
                        continue
                    new, d = carry(lam)
                    state = opt_lam.state.get(lam, {}) if opt_lam else {}
                    for key in ("exp_avg", "exp_avg_sq"):
                        if key in state:
                            state[key].copy_(carry(state[key],
                                                   fresh_zero=True)[0])
                    lam.copy_(new)
                    drift = d if drift is None else torch.maximum(drift, d)
            self.X_f.copy_(X_new)
            if self.n_batches > 1:
                self.X_batched.copy_(self.X_f.index_select(
                    0, self.idx_batched.reshape(-1)).reshape(
                        self.X_batched.shape))
            if self.members is None:
                self.best_loss.fill_(float("inf"))
        return drift

    def begin(self, rows: int, epoch0: int = 0):
        """Start a ``fit``: step counter 0, the best reset to the current
        parameters, room for ``rows`` history rows per chunk (a chunk's
        worth, so shorter fits keep the buffer and the graph).  With a
        member axis the counter starts at the global epoch ``epoch0`` and
        the per-member best carries on."""
        with torch.no_grad():
            if self.members is not None:
                self.counter.fill_(int(epoch0))
            else:
                self.counter.zero_()
                for bp, p in zip(self.best_params, self.params):
                    bp.copy_(p)
                self.best_loss.fill_(float("inf"))
                self.best_step.fill_(-1)
        if self.hist is not None and self.hist.shape[0] < rows:
            # a new buffer: the graph's key moves and it is captured again
            self.hist = torch.zeros((rows,) + tuple(self.hist.shape[1:]),
                                    device=self.device)
        self.rows = max(self.rows, rows)

    def read(self, n: int) -> np.ndarray:
        """The chunk's first ``n`` history rows on the host, one copy
        (``[n, K]``, or ``[n, K, M]`` with a member axis: under a mesh the
        ranks' member blocks gathered, a collective at the boundary)."""
        h = self.hist[:n]
        if (self.members is not None and self.mesh is not None
                and self.mesh.size > 1):
            h = all_gather_rows(h.permute(2, 0, 1).contiguous(),
                                self.mesh).permute(1, 2, 0)
        return h.cpu().numpy()  # tdq: allow[host-sync-in-hot-path] the chunk's one history read: one copy per chunk, not per step

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
                self.params, self.lambdas["BCs"], lam_res, X_b,
                lam_data=self.lambdas.get("data", [None])[0])
        M = self.members
        with span("fit_adam.backward"):
            # the members' totals summed: each gradient is its own loss's
            (total if M is None else torch.sum(total)).backward()
        lam_norm = None
        if (self.mesh is not None and self.mesh.group is not None
                and M is None):
            total, comps, lam_norm = self._all_reduce(total, comps)
        if self.grad_norm:
            # optax.global_norm of the step's gradients, before clipping;
            # with the λ group's norm over the ranks, beside the network's
            trained = self.params + (opt_lam.param_groups[0]["params"]
                                     if opt_lam is not None and lam_norm is
                                     None else [])
            grads = [t.grad for t in trained if t.grad is not None]
            if M is not None:
                with torch.no_grad():
                    sq = torch.zeros(M, device=self.device)
                    for g in grads:
                        sq = sq + torch.sum(torch.square(g.reshape(M, -1)), 1)
                    norm = torch.sqrt(sq)
            else:
                norm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)))
            if lam_norm is not None:
                norm = torch.sqrt(torch.square(norm) + torch.square(lam_norm))
            comps = dict(comps, Grad_norm=norm)
        ok = None
        if M is not None:
            with torch.no_grad():
                total = total.detach()
                ok = self.alive & torch.isfinite(total) & torch.isfinite(norm)
                old = [t.detach().clone() for t in self.tracked]
        with span("fit_adam.adam"):
            if self.grad_clip is not None:
                clip_by_global_norm(self.params, self.grad_clip)
                if opt_lam is not None and lam_norm is None:
                    clip_by_global_norm(opt_lam.param_groups[0]["params"],
                                        self.grad_clip)
                elif opt_lam is not None:
                    clip_to_norm(opt_lam.param_groups[0]["params"],
                                 self.grad_clip, lam_norm)
            optimizer_step(opt_net)
            if opt_lam is not None:
                optimizer_step(opt_lam)
        with span("fit_adam.record"), torch.no_grad():
            if ok is not None:
                # the frozen members keep their parameters, λ and moments
                for t, o in zip(self.tracked, old):
                    t.copy_(torch.where(_masked(ok, t), t, o))
                self.alive.copy_(ok)
                comps = dict(comps, Alive=ok.to(torch.float32))
            if self.hist is None:  # the first step, always an eager one
                self.keys = list(comps)
                self.hist = torch.zeros(
                    (self.rows, len(self.keys)) + (() if M is None else (M,)),
                    device=self.device)
            vals = torch.stack([device_scalar(comps[k], self.device)
                                if M is None else comps[k].detach().reshape(M)
                                for k in self.keys])
            self.hist.index_copy_(0, self.row.reshape(1), vals[None])
            # best iterate: the params after this step, kept when the
            # step's loss improves — a device-side select, no host sync
            if M is None:
                total = total.detach().reshape(())
                improved = total < self.best_loss
            else:
                improved = ok & (total < self.best_loss)
            for bp, p in zip(self.best_params, self.params):
                bp.copy_(torch.where(improved if M is None
                                     else _masked(improved, p), p, bp))
            self.best_loss.copy_(torch.where(improved, total,
                                             self.best_loss))
            self.best_step.copy_(torch.where(improved, self.counter,
                                             self.best_step))
            self.counter.add_(1)
            self.row.add_(1)

    def _all_reduce(self, total, comps):
        """Sum the rank's shares over the group (:mod:`..parallel`), in
        one all-reduce: the gradients of the parameters and of the
        replicated λ, the loss components and, when a norm is needed (the
        ``Grad_norm`` record, λ clipping) at a world size above 1, the
        per-point λ gradient's squared norm.  Returns the global ``(total,
        components, λ norm)``; the λ norm is ``None`` when the λ group's
        own norm is the global one (no per-point λ, or world 1, where the
        step stays bit for bit the non-dist one)."""
        dev = self.device
        want_norm = (self.grad_norm or self.grad_clip is not None) \
            and self._lam_local and self.mesh.size > 1
        local_sq = None
        if want_norm:
            local = [t.grad for t in self._lam_local if t.grad is not None]
            local_sq = torch.square(torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(local)))).reshape(1) \
                if local else torch.zeros(1, device=dev)
        comps = sum_components(
            comps, self.mesh, dev, [t.grad for t in self.params]
            + [t.grad for t in self._lam_shared] + [local_sq])
        lam_norm = None
        if want_norm:
            shared = [t.grad for t in self._lam_shared if t.grad is not None]
            sq = local_sq[0]
            if shared:
                sq = sq + torch.square(torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(shared))))
            lam_norm = torch.sqrt(sq)
        return comps["Total Loss"], comps, lam_norm

    def gathered_lambdas(self) -> dict:
        """The λ as the whole group holds them: each per-point residual λ
        gathered over the ranks (a collective: every rank calls it), the
        rest as they are."""
        if self.mesh is None or self.mesh.group is None:
            return self.lambdas
        res = [all_gather_rows(lam, self.mesh) if pp else lam
               for lam, pp in zip(self.lambdas["residual"], self.per_point)]
        return dict(self.lambdas, residual=res)


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
                    epoch: int, same_stream: bool = False) -> PendingRedraw:
    """Dispatch ``redraw(params, X_f, epoch) -> ResampleSwap`` (``params``
    the flat parameter list, detached) at a chunk
    boundary.  On a CUDA device: the parameters are snapshot on the current
    stream (the next chunk's replays update the live ones in place), the
    redraw stream waits for that and runs the redraw, and the snapshot is
    marked as used there, so the host returns as soon as the redraw is
    issued.  ``X_f`` is read there too; it is written only at the swap,
    after :meth:`PendingRedraw.join`.  On the CPU the redraw runs now.
    ``same_stream``: the redraw runs on the current stream, behind the
    chunk and ahead of the next (a redraw that holds collectives: two
    streams could order them differently on different ranks); its events
    still time it."""
    t0 = time.perf_counter()
    dev = X_f.device
    if dev.type != "cuda":
        swap = redraw([p.detach() for p in params], X_f, epoch)
        return PendingRedraw(swap, epoch, time.perf_counter() - t0)
    if same_stream:
        # ahead of the next chunk's updates on this stream: no snapshot
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            swap = redraw([p.detach() for p in params], X_f, epoch)
        done.record()
        return PendingRedraw(swap, epoch, time.perf_counter() - t0, start,
                             done)
    main = torch.cuda.current_stream(dev)
    side = redraw_stream(dev)
    with torch.no_grad():
        snap = [p.detach().clone() for p in params]
    side.wait_stream(main)
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record(side)
        swap = redraw(snap, X_f, epoch)
        done.record(side)
    for t in snap:
        t.record_stream(side)
    return PendingRedraw(swap, epoch, time.perf_counter() - t0, start, done)


def _redraw_record(pending: PendingRedraw, adopted, stall_s, drift) -> dict:
    return {"epoch": pending.epoch, "adopted": adopted,
            "dispatch_s": pending.dispatch_s, "stall_s": stall_s,
            "pipelined": True, "pending": pending, "drift": drift}


def _finish_records(records: list):
    """Fill each record's device numbers in (after a synchronisation)."""
    for rec in records:
        pending = rec.pop("pending", None)
        if pending is None:
            continue
        rec["device_ms"] = pending.device_ms()
        # a family's statistics are per member: their means
        stats = {k: float(v) if v.numel() == 1
                 else float(v.to(torch.float32).mean())
                 for k, v in pending.swap.stats.items()}
        drift = rec.pop("drift", None)
        if drift is not None:
            stats["lambda_drift"] = float(drift)
        rec["stats"] = stats


def _report_redraws(telemetry, records: list, epoch_offset: int,
                    flops_info: Optional[Callable]):
    """``telemetry.on_resample`` for each adopted redraw, after the phase's
    synchronisation: the stall is the host's (dispatch plus swap; the pool
    scoring ran behind a chunk), the statistics are read without waiting.
    Epochs are handed call-relative (the telemetry adds its own offset)."""
    flops = flops_info() if flops_info is not None else (None, None)
    for rec in records:
        if rec["adopted"] is None:
            continue
        telemetry.on_resample(
            "adam", rec["adopted"] - epoch_offset,
            rec["dispatch_s"] + rec["stall_s"],
            stats=rec["stats"] or None, pipelined=rec["pipelined"],
            dispatched_epoch=(rec["epoch"] - epoch_offset
                              if rec["pipelined"] else None),
            flops=flops)


def _write_lambdas(step: AdamStep, new: dict):
    """Write recomputed λ (0-d tensors) into the step's λ in place."""
    with torch.no_grad():
        for key, vals in new.items():
            for lam, v in zip(step.lambdas.get(key, []), vals):
                if lam is not None:
                    lam.copy_(v.reshape(lam.shape))


def _resilience_boundary(step: AdamStep, absolute: int,
                         flush: Optional[Callable], pending, pbar,
                         verbose: bool):
    """The chaos hook, then the preemption check, at a chunk boundary with
    steps left (module docstring).  ``absolute`` is the run's epoch (the
    chaos triggers' and :class:`~..resilience.Preempted`'s); ``flush()``
    writes the final state through ``state_hook``."""
    chaos = active_chaos()
    if chaos is not None:
        chaos.on_train_boundary("adam", absolute, {"params": step.params,
                                                   "lambdas": step.lambdas})
    if not preemption_requested():
        return
    if pending is not None:
        # the flush's state is the chunk's: the redraw trained no step
        pending.join(step.device)
    t_flush = time.perf_counter()
    if flush is not None:
        flush()
    flush_s = time.perf_counter() - t_flush
    note_final_flush("adam", absolute, flush_s, verbose=verbose)
    if pbar is not None:
        pbar.close()
    raise Preempted("adam", absolute,
                    flush_s=flush_s if flush is not None else None)


def fit_adam(step: AdamStep, tf_iter: int, chunk: int = 100,
             verbose: bool = True, result: Optional[FitResult] = None,
             state_hook: Optional[Callable] = None,
             state_hook_every: int = 0,
             resample_fn: Optional[Callable] = None,
             resample_every: int = 0,
             lambda_update_fn: Optional[Callable] = None,
             stop_fn: Optional[Callable] = None,
             epoch_offset: int = 0,
             callback: Optional[Callable] = None, callback_every: int = 0,
             telemetry=None, epoch0: int = 0,
             chunk_fn: Optional[Callable] = None) -> FitResult:
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
    A pipelined hook (``resample_fn.pipelined``, with ``redraw(params,
    X_f, epoch) -> ResampleSwap``) is dispatched there
    (:func:`dispatch_redraw`) and adopted at the NEXT boundary, λ carried
    (:meth:`AdamStep.adopt`), so its work runs behind the chunk between
    them; a redraw still pending when the phase ends is discarded (it
    trained no step), after it has finished on its stream.  Any other hook
    is called as ``resample_fn(params, epoch) -> X_new`` and adopted at
    once.  Each redraw adds a record to ``result.redraws``: ``epoch``
    (dispatched), ``adopted`` (the epoch, or ``None`` if discarded),
    ``dispatch_s`` and ``stall_s`` (host seconds to issue it and to swap it
    in), ``pipelined``, ``device_ms`` (CUDA events on its stream; ``None``
    off the card) and ``stats`` (kept fraction, score gain, λ drift, ascent
    steps).

    ``lambda_update_fn(params) -> {"BCs": [...], "residual": [...][,
    "data": [...]]}`` (NTK weighting, :mod:`..ops.ntk`): called before the
    first step and at every chunk boundary with steps left (after any
    redraw, so the balance follows the points being trained); its 0-d
    weights are written into the step's λ with ``copy_``, so the step's
    graph replays on without a new capture.

    ``stop_fn(result) -> bool``: checked at every chunk boundary; true ends
    the phase there (the causal ε ladder hands the rest of the budget to
    its next stage).

    ``callback(epoch, params)`` + ``callback_every``: called at a chunk
    boundary that crosses a ``callback_every`` boundary, after
    ``state_hook``, with the live flat parameter list: periodic evaluation
    (rel-L2 timelines) inside one continuous run.

    ``telemetry``: a :class:`~..telemetry.TrainingTelemetry`.  Each chunk
    reports its step-time split (``dispatch_s``, the host's time to issue
    the chunk's steps, against ``device_s``, its one history read, which
    waits for the card; the redraws' host seconds as ``data_s``), its
    per-epoch rows, the SA-λ summaries, and runs the NaN/Inf sentinel,
    which may raise :class:`~..telemetry.TrainingDiverged`; each adopted
    redraw is reported (``on_resample``, with its dispatch and swap host
    seconds as the stall) once the phase has synchronised, so reading its
    statistics waits for nothing.  The step records ``Grad_norm`` only if
    it was built with ``grad_norm=True``.

    ``epoch_offset`` is added to every epoch the hooks are handed (and the
    redraw records keep): the epochs earlier stages of a causal ε ladder
    trained.  The boundaries stay counted from this call's start; so are
    the epochs handed to ``telemetry``, which adds its own
    ``epoch_offset``.

    ``epoch0``: the absolute epoch of this call's first step (the history
    already on record), used only by the resilience boundary (module
    docstring): the heartbeat, the chaos plan's triggers and the epoch a
    :class:`~..resilience.Preempted` carries.  With a tracer active, two
    CUDA events around the chunk's replays give the ``train.device``
    span the card's time, read after the chunk's host read.

    ``chunk_fn(rows, prev, t_disp, t_dev)``: called after each chunk's
    host read with its new per-epoch rows, the epochs trained before it
    and its dispatch and read seconds; what it raises ends the phase (a
    pending redraw joined first).  A step with a member axis (the
    surrogate factory) records each epoch's components as ``[M]`` arrays
    and keeps no best in the result: its owner reads them per member."""
    result = result or FitResult()
    n_b = step.n_batches
    total_steps = tf_iter * n_b
    step.begin(chunk * n_b, epoch0)
    pipelined = bool(getattr(resample_fn, "pipelined", False))
    pending = None
    records = []
    t0 = time.time()
    done = 0
    data_s = 0.0  # redraw host seconds, reported with the next chunk
    if telemetry is not None and total_steps > 0:
        # the analytic basis the solver set prices the step (no measured
        # count: telemetry.costmodel)
        telemetry.on_step_program("adam")
    if lambda_update_fn is not None and total_steps > 0:
        _write_lambdas(step, lambda_update_fn(step.params))
    pbar = progress_bar(tf_iter, desc="Adam") if verbose else None
    while done < total_steps:
        n = min(chunk * n_b, total_steps - done)
        t_chunk = time.perf_counter()
        step.graph.check()
        step.row.zero_()
        events = None
        if step.device.type == "cuda" and active_tracer() is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        for _ in range(n):
            with span("fit_adam.step"):
                step.graph()
        if events is not None:
            events[1].record()
        t_disp = time.perf_counter() - t_chunk
        with span("fit_adam.read"):
            hist = step.read(n)  # one host copy per chunk
        result.chunk_seconds.append(time.perf_counter() - t_chunk)
        # one entry per epoch: its last batch's
        for row in hist[n_b - 1::n_b]:
            result.losses.append({k: float(v) if step.members is None
                                  else v.copy()
                                  for k, v in zip(step.keys, row)})
        prev = done // n_b
        done += n
        epochs = done // n_b
        # cluster heartbeat: the host read above waited for the card, so
        # this beat certifies forward progress (no-op without a supervisor)
        beat("adam", epoch0 + epochs)
        if telemetry is not None:
            rows = result.losses[len(result.losses) - (epochs - prev):]
            # the events completed before the host read returned: reading
            # them waits for nothing
            card_s = (None if events is None
                      else events[0].elapsed_time(events[1]) / 1e3)
            telemetry.on_step_time("adam", n, t_disp,
                                   result.chunk_seconds[-1] - t_disp, data_s,
                                   card_s=card_s)
            data_s = 0.0
            telemetry.on_epoch_rows("adam", prev, rows)
            telemetry.on_lambda_stats(epochs, step.gathered_lambdas())
            telemetry.check_rows("adam", prev, rows)
        if chunk_fn is not None:
            try:
                chunk_fn(result.losses[len(result.losses) - (epochs - prev):],
                         prev, t_disp, result.chunk_seconds[-1] - t_disp)
            except Exception:
                if pending is not None:
                    pending.join(step.device)
                raise
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
                stall = time.perf_counter() - t_sw
                records.append(_redraw_record(
                    pending, epochs + epoch_offset, stall, drift))
                data_s += stall
            pending = None
        if (resample_fn is not None and resample_every > 0
                and done < total_steps
                and prev // resample_every != epochs // resample_every):
            with span("fit_adam.redraw"):
                at = epochs + epoch_offset
                if pipelined:
                    flops_info = getattr(resample_fn, "flops_info", None)
                    if telemetry is not None and flops_info is not None:
                        telemetry.note_resample_flops(flops_info()[0])
                    pending = dispatch_redraw(
                        resample_fn.redraw, step.params, step.X_f, at,
                        same_stream=getattr(resample_fn, "same_stream",
                                            False))
                    data_s += pending.dispatch_s
                else:
                    t_rd = time.perf_counter()
                    step.adopt(resample_fn([p.detach() for p in step.params],
                                           at))
                    records.append({"epoch": at, "adopted": at,
                                    "dispatch_s": time.perf_counter() - t_rd,
                                    "stall_s": 0.0, "pipelined": False,
                                    "device_ms": None, "stats": {}})
                    data_s += records[-1]["dispatch_s"]
        if lambda_update_fn is not None and done < total_steps:
            _write_lambdas(step, lambda_update_fn(step.params))
        flush = None
        if state_hook is not None:
            def flush(_e=epochs + epoch_offset):
                state_hook(_e, (step.best_params, step.best_loss,
                                torch.div(step.best_step, n_b,
                                          rounding_mode="floor")
                                + epoch_offset))
        if (flush is not None and state_hook_every > 0
                and prev // state_hook_every != epochs // state_hook_every):
            flush()
        if (callback is not None and callback_every > 0
                and prev // callback_every != epochs // callback_every):
            callback(epochs + epoch_offset, step.params)
        if pbar is not None:
            pbar.update(epochs - prev)
            pbar.set_postfix(loss=result.losses[-1]["Total Loss"])
        if stop_fn is not None and done < total_steps and stop_fn(result):
            if pending is not None:
                pending.join(step.device)
                records.append(_redraw_record(pending, None, None, None))
                pending = None
            break
        if done < total_steps:
            _resilience_boundary(step, epoch0 + epochs, flush, pending, pbar,
                                 verbose)
    if pbar is not None:
        pbar.close()
    if step.device.type == "cuda":
        # tdq: allow[host-sync-in-hot-path] phase-final fence: the wall clock includes the last chunk's device time
        torch.cuda.synchronize(step.device)
    _finish_records(records)
    if telemetry is not None:
        _report_redraws(telemetry, records, epoch_offset,
                        getattr(resample_fn, "flops_info", None))
    result.redraws.extend(records)
    result.wall_time["adam"] = time.time() - t0
    if step.members is not None:
        return result
    result.best_params["adam"] = tree_copy(step.best_params)
    result.min_loss["adam"] = float(step.best_loss)
    result.best_epoch["adam"] = int(step.best_step) // n_b
    return result
