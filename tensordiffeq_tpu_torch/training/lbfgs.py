"""L-BFGS refinement.

Counterpart of the JAX package's ``training/lbfgs.py`` (``lbfgs_minimize``,
``fit_lbfgs``).  The JAX package runs ``optax.lbfgs`` inside a jitted
``lax.scan`` chunk; this module computes the same algorithm as optax 0.2.6
without importing it:

* the compact two-loop recursion of ``optax.scale_by_lbfgs`` (memory ring of
  ``memory_size`` difference pairs kept as two ``[m, n]`` tensors, ρ = 1/(y·s)
  or 0, identity scale γ = (y·s)/(y·y) or min(1, 1/‖g‖) at the first step);
* ``optax.scale_by_zoom_linesearch(max_linesearch_steps=30)`` with its
  defaults, ``initial_guess_strategy="keep"`` among them (the first step tried
  is the previous accepted step size): the interval search, the zoom with
  cubic, quadratic and bisection candidates, and the safe step on failure;
* ``optax.value_and_grad_from_state``: the value and gradient at the accepted
  point serve the next iteration, so an iteration costs its line-search
  evaluations (the first one, one more);
* the fixed-step rule (``eager=True``): ``optax.lbfgs(learning_rate=0.8,
  linesearch=None)``, one evaluation per iteration.

The vectors (iterate, direction, gradients, the memory, the best iterate)
stay on the iterate's device, in static buffers, and the device work runs
as CUDA graphs on a CUDA device (:mod:`.graphs`, the counterpart of the JAX
package's jitted ``run_chunk``): one graph for an evaluation of the loss
and its gradient at a trial point, one for the two-loop sweep, and for the
fixed-step rule one for a whole iteration.  The line search stays on the
host: its branches read each trial's value and slope, one host
synchronisation per line-search evaluation.  The fixed-step rule has none
inside a chunk: its losses and gradient norms come back in one copy per
chunk, as ``fit_adam``'s do.  :func:`lbfgs_minimize` counts the
objective's evaluations and its host synchronisations in
``lbfgs_minimize.evaluations`` and ``lbfgs_minimize.host_syncs`` (as the
kernel wrappers count their launches), and marks the evaluations, the
two-loop products, the fixed-step iterations and the host reads as the
profiler ranges ``lbfgs.evaluate``, ``lbfgs.direction``, ``lbfgs.step`` and
``lbfgs.read`` (entered only while a profiler records).

L-BFGS optimizes the network parameters only; SA λ stay frozen (reference
``models.py:283-295``).

``telemetry`` gets each chunk's step-time split as the JAX loop reports
it: ``device_s`` is the host's time in its reads of the device (the line
search's per-trial reads, or the fixed step's one read per chunk), which
wait for the card, and ``dispatch_s`` the rest of the chunk's wall.

Data parallelism (``mesh``, :mod:`..parallel`): every evaluation sums the
rank's share of the loss and its gradient over the ranks in one
all-reduce, inside the evaluation's graph under NCCL (eagerly under gloo),
so the values, slopes and norms every branch of the line search, the
stops, the retreat and the best select read are the global ones, alike on
every rank, and the ranks' iterates stay equal.

At each chunk boundary, after the chunk's host reads, the loop beats the
cluster heartbeat (:func:`~..resilience.cluster.beat`) and checks for a
preemption request: the JAX loop's ``iter0``/``preempt_flush`` contract
(:func:`lbfgs_minimize`).

Not ported yet: the line search on the device (JAX's ``while_loop``, which
needs conditional graph nodes; ROADMAP, queue 1's performance items).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import ieee_f32  # noqa: F401  (the scope callers give a
#   bare lbfgs_minimize: IEEE float32, as fit_lbfgs at precision HIGHEST)
from ..parallel import all_reduce_
from ..resilience.cluster import beat
from ..resilience.preemption import (Preempted, note_final_flush,
                                     preemption_requested)
from ..telemetry import log_event
from ..utils import matmul_precision, param_leaves, span
from .graphs import StepGraph, host_bound
from .progress import progress_bar

# optax.scale_by_zoom_linesearch's defaults, as the JAX package calls it
MAX_LINESEARCH_STEPS = 30
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5  # the zoom's interval threshold
TOL = 0.0


def _log_stop(msg: str) -> None:
    """Early stops print to stderr unconditionally, as in the JAX loop: a
    silent stop inside a long run reads like a completed phase; the stop
    is mirrored into any active run log."""
    log_event("l-bfgs", msg, level="warning")


def _read(*tensors) -> np.ndarray:
    """Scalars and vectors from the device in one copy (one host
    synchronisation), concatenated; its host seconds add to
    ``lbfgs_minimize.read_s``."""
    lbfgs_minimize.host_syncs += 1
    t0 = time.perf_counter()
    with span("lbfgs.read"):
        # tdq: allow[host-sync-in-hot-path] the declared read, counted in lbfgs_minimize.host_syncs: the line search's per trial, the fixed step's per chunk
        got = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    lbfgs_minimize.read_s += time.perf_counter() - t0
    return got


class _Evaluator:
    """One evaluation of the objective over static buffers: the value and
    gradient at ``x + s·d`` and the slope ``∇f·d`` there (the line search's
    trial), run by :attr:`graph` (captured and replayed on a CUDA device,
    :mod:`.graphs`).  :meth:`aim` sets ``x`` and ``d`` once per line search;
    a call sets the step size ``s`` with a fill on the device (a graph
    cannot take a new Python number) and runs the evaluation.  Without a
    direction ``d`` is zero, so the evaluation is at ``x`` itself."""

    def __init__(self, fun: Callable, x: torch.Tensor, eager: bool = False,
                 mesh=None):
        self.fun = fun
        self.mesh = mesh if mesh is not None and mesh.group is not None \
            else None
        self.x = torch.zeros_like(x)
        self.d = torch.zeros_like(x)
        self.s = torch.zeros((), dtype=x.dtype, device=x.device)
        self.value = self.grad = self.slope = None
        self.graph = StepGraph(self._run, self._keyed, x.device,
                               "L-BFGS evaluation",
                               eager=eager or host_bound(mesh, x.device))

    def _keyed(self) -> list:
        return [self.x, self.d, self.s] + list(getattr(self.fun, "tensors",
                                                       ()))

    def _run(self):
        with torch.enable_grad():
            xt = (self.x + self.s * self.d).requires_grad_(True)
            value = self.fun(xt)
            # a parameter the objective does not read gets a zero gradient,
            # as in JAX (the head's bias under a residual that never reads u)
            (grad,) = torch.autograd.grad(value, xt, materialize_grads=True)
        self.value = value.detach().reshape(())
        if self.mesh is not None:
            self.value = self.value.clone()
            with torch.no_grad():
                all_reduce_([grad, self.value], self.mesh)
        self.grad = grad
        self.slope = torch.dot(grad, self.d)

    def aim(self, x: torch.Tensor, d: Optional[torch.Tensor] = None):
        self.x.copy_(x)
        if d is None:
            self.d.zero_()
        else:
            self.d.copy_(d)

    def __call__(self, s=0.0):
        """``(value, grad, slope)`` at ``x + s·d``: the value and gradient
        as fresh tensors (the line search keeps them past the next trial),
        the slope as the static output, to be read before the next call."""
        with span("lbfgs.evaluate"):
            self.s.fill_(float(s))
            self.graph()
            lbfgs_minimize.evaluations += 1
            return self.value.clone(), self.grad.clone(), self.slope


class _Memory:
    """``optax.scale_by_lbfgs`` with ``scale_init_precond=True``: the ring of
    parameter and gradient differences and its two-loop product, over static
    buffers, run by :attr:`graph`.  The slot each pair goes to and the
    sweep's order come from a device counter of the sweeps done, so one
    graph serves every iteration.  The sweep runs over all ``m`` slots, as
    optax does: an unfilled slot (ρ = 0, zero vectors) changes nothing, bit
    for bit on finite data.  A host flag tells the first sweep (no pair
    yet; always an eager warm-up run, never captured) from the rest."""

    def __init__(self, x: torch.Tensor, m: int, eager: bool = False):
        self.m = m
        self.first = True
        self.S = torch.zeros((m,) + x.shape, dtype=x.dtype, device=x.device)
        self.Y = torch.zeros_like(self.S)
        self.rho = torch.zeros(m, dtype=x.dtype, device=x.device)
        self.prev_x = torch.zeros_like(x)
        self.prev_g = torch.zeros_like(x)
        self.x_in = torch.zeros_like(x)
        self.g_in = torch.zeros_like(x)
        self.n = torch.zeros((), dtype=torch.long, device=x.device)
        self.slots = torch.arange(m, device=x.device)
        self.out = None
        self.graph = StepGraph(self._sweep, self._keyed, x.device,
                               "two-loop sweep", eager=eager)

    def _keyed(self) -> list:
        return [self.S, self.Y, self.rho, self.prev_x, self.prev_g,
                self.x_in, self.g_in, self.n, self.slots]

    def precondition(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Store the pair ``(x - x_prev, g - g_prev)`` (nothing at the first
        call) and return ``P·g``, a static buffer under a graph: use it
        before the next call."""
        with span("lbfgs.direction"):
            self.x_in.copy_(x)
            self.g_in.copy_(g)
            self.graph()
            return self.out

    def _sweep(self):
        m, x, g = self.m, self.x_in, self.g_in
        if not self.first:
            s = x - self.prev_x
            y = g - self.prev_g
            ys = torch.dot(y, s)
            slot = torch.remainder(self.n - 1, m).reshape(1)
            self.S.index_copy_(0, slot, s[None])
            self.Y.index_copy_(0, slot, y[None])
            self.rho.index_copy_(0, slot, torch.where(
                ys == 0, torch.zeros_like(ys), 1.0 / ys).reshape(1))
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0, ys / yy, torch.ones_like(yy))
        else:
            # the first step's identity scale: a capped reciprocal of ‖g‖
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        self.prev_x.copy_(x)
        self.prev_g.copy_(g)
        self.first = False
        # the slots oldest to newest: the next slot to write comes first
        order = torch.remainder(self.n + self.slots, m)
        self.n.add_(1)
        S = self.S.index_select(0, order)
        Y = self.Y.index_select(0, order)
        rho = self.rho.index_select(0, order)
        v = g.clone()
        alphas = []
        for i in reversed(range(m)):
            a = rho[i] * torch.dot(S[i], v)
            v.addcmul_(Y[i], a, value=-1.0)
            alphas.append(a)
        v = gamma * v
        for i, a in zip(range(m), reversed(alphas)):
            b = rho[i] * torch.dot(Y[i], v)
            v.addcmul_(S[i], a - b)
        self.out = v


class _Best:
    """The running best iterate as static buffers: a device-side select per
    iteration that never adopts a non-finite value, keyed by a device
    iteration counter."""

    def __init__(self, x0: torch.Tensor):
        self.x = x0.detach().clone()
        self.f = torch.full((), float("inf"), dtype=x0.dtype,
                            device=x0.device)
        self.i = torch.full((), -1, dtype=torch.long, device=x0.device)
        self.it = torch.zeros((), dtype=torch.long, device=x0.device)

    def select(self, x_at: torch.Tensor, value: torch.Tensor):
        with torch.no_grad():
            improved = torch.isfinite(value) & (value < self.f)
            self.x.copy_(torch.where(improved, x_at, self.x))
            self.f.copy_(torch.where(improved, value, self.f))
            self.i.copy_(torch.where(improved, self.it, self.i))
            self.it.add_(1)


class _FixedStep:
    """One iteration of the fixed-step rule over static buffers: the
    evaluation at the iterate (the evaluator's ``x``), the two-loop sweep,
    the best select, the value and ‖g‖ into row ``row`` of the chunk's
    history, and the update ``x ← x - learning_rate·P·g``; one graph per
    iteration."""

    def __init__(self, ev: _Evaluator, memory: _Memory, best: _Best,
                 learning_rate: float, rows: int, eager: bool = False):
        self.ev, self.memory, self.best = ev, memory, best
        self.lr = learning_rate
        x = ev.x
        self.values = torch.zeros(rows, dtype=x.dtype, device=x.device)
        self.gnorms = torch.zeros(rows, dtype=x.dtype, device=x.device)
        self.row = torch.zeros((), dtype=torch.long, device=x.device)
        self.graph = StepGraph(self._run, self._keyed, x.device,
                               "fixed-step L-BFGS iteration",
                               eager=eager or host_bound(ev.mesh, x.device))

    def _keyed(self) -> list:
        return (self.ev._keyed() + self.memory._keyed()
                + [self.best.x, self.best.f, self.best.i, self.best.it,
                   self.values, self.gnorms, self.row])

    def _run(self):
        ev, mem = self.ev, self.memory
        ev._run()
        mem.x_in.copy_(ev.x)
        mem.g_in.copy_(ev.grad)
        mem._sweep()
        with torch.no_grad():
            self.best.select(ev.x, ev.value)
            at = self.row.reshape(1)
            self.values.index_copy_(0, at, ev.value.reshape(1))
            self.gnorms.index_copy_(
                0, at, torch.linalg.vector_norm(ev.grad).reshape(1))
            ev.x.copy_(ev.x + (-self.lr) * mem.out)
            self.row.add_(1)


def _cubicmin(a, fa, fpa, b, fb, c, fc, dt):
    """Critical point of the cubic through (a, fa) with slope fpa, (b, fb)
    and (c, fc); NaN when there is none (optax ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], dt)
    A, B = np.dot(d1, np.array([fb - fa - C * db, fc - fa - C * dc], dt)) \
        / denom
    radical = B * B - dt(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (dt(3.0) * A)


def _quadmin(a, fa, fpa, b, fb, dt):
    """Critical point of the quadratic through (a, fa) with slope fpa and
    (b, fb) (optax ``_quadmin``)."""
    C = fpa
    db = b - a
    B = (fb - fa - C * db) / (db ** 2)
    return a - C / (dt(2.0) * B)


class _ZoomLinesearch:
    """``optax.zoom_linesearch`` with the defaults above, one trial per turn
    of :meth:`run`'s loop, each trial one call of the :class:`_Evaluator`
    ``ev`` aimed at ``x`` along ``d``.  Scalars live on the host in the
    iterate's dtype; the gradients (and the values, for the best-iterate
    select) at the trials stay on the device.

    The starting value and slope are read from the device together with
    the first trial's (one host synchronisation for both): ``init`` holds
    the device scalars ``[slope_init, ‖g‖, value_init?]``, the last only
    when the caller does not know the value on the host yet."""

    def __init__(self, ev, x, d, value, grad, guess, dt, init,
                 value_h=None):
        self.ev, self.dt = ev, dt
        ev.aim(x, d)
        self.guess = guess
        self.init = init
        self.count = 0
        self.stepsize = dt(0.0)
        self.grad = self.safe_grad = grad
        self.value_dev = self.safe_value_dev = value
        self.value_init = value_h
        self.decrease_error = self.curvature_error = dt(np.inf)
        self.interval_found = self.done = self.failed = False
        self.gnorm = None

    def _bind(self, vals):
        """The line search's initial state, once its scalars are here."""
        dt = self.dt
        slope, self.gnorm = dt(vals[0]), float(vals[1])
        if self.value_init is None:
            self.value_init = dt(vals[2])
        value = self.value_init
        self.slope_init = self.slope = slope
        self.value = value
        z = dt(0.0)
        self.low, self.value_low, self.slope_low = z, value, slope
        self.high, self.value_high, self.slope_high = z, value, slope
        self.cubic_ref, self.value_cubic_ref = z, value
        self.safe_stepsize, self.safe_value = z, value

    def _trial(self, stepsize):
        value, grad, slope = self.ev(stepsize)
        got = _read(value, slope, *self.init)
        if self.init:
            self._bind(got[2:])
            self.init = []
        return self.dt(got[0]), value, grad, self.dt(got[1])

    def _decrease_error(self, stepsize, value, slope):
        dt = self.dt
        armijo = value - self.value_init - dt(SLOPE_RTOL) * stepsize \
            * self.slope_init
        approx = slope - (dt(2 * SLOPE_RTOL) - dt(1.0)) * self.slope_init
        delta = value - self.value_init - dt(APPROX_DEC_RTOL) \
            * np.abs(self.value_init)
        err = np.minimum(np.maximum(approx, delta), armijo)
        err = np.maximum(err, dt(0.0))
        return dt(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope):
        err = np.maximum(np.abs(slope) - self.dt(CURV_RTOL)
                         * np.abs(self.slope_init), self.dt(0.0))
        return self.dt(np.inf) if np.isnan(err) else err

    def _set_safe(self, stepsize, value, value_dev, grad):
        self.safe_stepsize, self.safe_value = stepsize, value
        self.safe_value_dev, self.safe_grad = value_dev, grad

    def _search_interval(self):
        """Algorithm 3.5 of Nocedal and Wright (optax
        ``_search_interval``)."""
        it = self.count
        new = self.guess if it == 0 else self.dt(INCREASE_FACTOR) \
            * self.stepsize
        value, value_dev, grad, slope = self._trial(new)
        prev_step, prev_value, prev_slope = self.stepsize, self.value, \
            self.slope
        dec = self._decrease_error(new, value, slope)
        curv = self._curvature_error(slope)
        error = np.maximum(dec, curv)
        if dec <= TOL:
            self._set_safe(new, value, value_dev, grad)
        set_high = bool(dec > 0.0) or (bool(value >= prev_value) and it > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            self.low, self.value_low, self.slope_low = new, value, slope
            self.high, self.value_high, self.slope_high = \
                prev_step, prev_value, prev_slope
        else:
            self.low, self.value_low, self.slope_low = \
                prev_step, prev_value, prev_slope
            self.high, self.value_high, self.slope_high = new, value, slope
        self.interval_found = set_high or set_low or bool(error <= TOL)
        self.done = bool(error <= TOL)
        self.failed = it + 1 >= MAX_LINESEARCH_STEPS and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.stepsize, self.value, self.slope = new, value, slope
        self.value_dev, self.grad = value_dev, grad
        self.decrease_error, self.curvature_error = dec, curv

    def _zoom_into_interval(self):
        """Algorithm 3.6 of Nocedal and Wright (optax
        ``_zoom_into_interval``)."""
        dt = self.dt
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = self.high, self.value_high, \
            self.slope_high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        too_small = bool(delta <= STEPSIZE_PRECISION)
        with np.errstate(all="ignore"):  # NaN candidates are not taken
            cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                              self.cubic_ref, self.value_cubic_ref, dt)
            quad = _quadmin(low, value_low, slope_low, high, value_high, dt)
        use_cubic = bool(cubic > left + dt(0.2) * delta) and \
            bool(cubic < right - dt(0.2) * delta)
        use_quad = not use_cubic and bool(quad > left + dt(0.1) * delta) \
            and bool(quad < right - dt(0.1) * delta)
        if use_cubic:
            middle = dt(cubic)
        elif use_quad:
            middle = dt(quad)
        else:
            middle = (low + high) / dt(2.0)
        value, value_dev, grad, slope = self._trial(middle)
        dec = self._decrease_error(middle, value, slope)
        curv = self._curvature_error(slope)
        error = np.maximum(dec, curv)
        if dec <= TOL and bool(value < self.safe_value):
            self._set_safe(middle, value, value_dev, grad)
        self.done = bool(error <= TOL)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and \
            not set_high_to_middle
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        elif set_high_to_low:
            self.high, self.value_high, self.slope_high = \
                low, value_low, slope_low
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        # the old high when high moved, else the old low
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = high, value_high
        else:
            self.cubic_ref, self.value_cubic_ref = low, value_low
        presumably_failed = self.count + 1 >= MAX_LINESEARCH_STEPS or (
            too_small and bool(self.safe_stepsize > 0.0))
        self.failed = presumably_failed and not self.done
        self.stepsize, self.value, self.slope = middle, value, slope
        self.value_dev, self.grad = value_dev, grad
        self.decrease_error, self.curvature_error = dec, curv

    def _try_safe_step(self):
        """The best step with sufficient decrease; with none, the last trial,
        or the safe step 0 when that trial left the domain (optax
        ``_try_safe_step``)."""
        outside_domain = bool(np.isinf(self.decrease_error))
        if self.safe_stepsize > 0.0 or outside_domain:
            self.stepsize, self.value = self.safe_stepsize, self.safe_value
            self.value_dev, self.grad = self.safe_value_dev, self.safe_grad

    def run(self):
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            self.count += 1
            if self.failed:
                self._try_safe_step()
        return self


def lbfgs_minimize(fun: Callable, x0: torch.Tensor, maxiter: int = 1000,
                   memory_size: int = 50, tol_fun: float = 1e-12,
                   tol_grad: float = 1e-12, chunk: int = 100,
                   eager: bool = False, learning_rate: float = 0.8,
                   callback: Optional[Callable] = None,
                   callback_every: int = 0, iter0: int = 0,
                   fun_fallback: Optional[Callable] = None,
                   on_retreat: Optional[Callable] = None,
                   verbose: bool = False, telemetry=None, mesh=None,
                   preempt_flush: Optional[Callable] = None,
                   _graphs: bool = True):
    """Minimise ``fun(x) -> scalar tensor`` over a 1-D tensor ``x``.

    Returns ``(x_final, x_best, f_best, best_iter, history)`` as the JAX
    function does: ``history`` is the per-iteration loss as a Python list;
    ``f_best`` and ``best_iter`` are 0-d tensors on ``x0``'s device.  The
    line-search rule records the value at each accepted iterate, the
    fixed-step rule (``eager=True``: the update ``-learning_rate·P·g``) the
    value at the iterate it just evaluated.  The best iterate is a
    device-side select that never adopts a non-finite value.

    On a CUDA device the evaluations, the two-loop sweeps and (fixed step)
    whole iterations are replayed CUDA graphs (:mod:`.graphs`); the line
    search runs on the host between evaluations.  ``_graphs=False`` runs
    them eagerly instead: the referee the graphs are held to.

    Stops run at chunk boundaries, in the JAX order: a non-finite loss, then
    ``|f_prev - f_now| < tol_fun``, then ``‖g‖ < tol_grad``.
    ``callback(done, x, (x_best, f_best, best_iter))`` fires when a chunk
    boundary crosses a ``callback_every`` boundary.

    ``fun_fallback``: the precision retreat.  A non-finite or stagnation
    stop with budget left restarts, once, from the best iterate with fresh
    memory (and its own graphs) on ``fun_fallback``, after re-measuring the
    incumbent under it.  ``on_retreat(iteration)`` is then called with the
    absolute iteration (``iter0`` counted) after which it retreated.

    ``iter0`` / ``preempt_flush``: the preemption contract (the Adam
    loop's ``epoch0``/``state_hook``): a pending preemption request is
    noticed at the next chunk boundary with iterations left,
    ``preempt_flush(done, x, (x_best, f_best, best_iter))`` writes the
    final checkpoint unconditionally (the cadence-gated ``callback`` may
    have skipped this boundary), and :class:`~..resilience.Preempted` is
    raised with the absolute iteration ``iter0 + done``; the heartbeat and
    the stop messages count from ``iter0`` too.  ``telemetry``: each chunk's
    ``on_step_time("l-bfgs", ...)`` (module docstring).  ``mesh``: ``fun``
    is the rank's share of a data-parallel loss, summed over the ranks at
    every evaluation (module docstring)."""
    x = x0.detach().clone()
    dt = np.dtype(str(x.dtype).replace("torch.", "")).type
    best = _Best(x0)

    def fresh(fn):
        # the L-BFGS memory and the line search's carried state (optax's
        # ScaleByZoomLinesearchState: step size 1, value inf)
        ev = _Evaluator(fn, x, eager=not _graphs, mesh=mesh)
        memory = _Memory(x, memory_size,
                         eager=not _graphs or host_bound(mesh, x.device))
        return dict(ev=ev, memory=memory, value=None, value_h=dt(np.inf),
                    grad=None, learning_rate=dt(1.0),
                    fixed=_FixedStep(ev, memory, best, learning_rate,
                                     min(chunk, maxiter), eager=not _graphs)
                    if eager else None)

    run = fresh(fun)
    history: list[float] = []
    f_prev = np.inf
    done = 0
    retreated = fun_fallback is None
    pbar = progress_bar(maxiter, desc="L-BFGS") if verbose else None
    while done < maxiter:
        n = int(min(chunk, maxiter - done))
        t_chunk, read0 = time.perf_counter(), lbfgs_minimize.read_s
        if eager:
            fixed = run["fixed"]
            run["ev"].aim(x)
            fixed.row.zero_()
            for _ in range(n):
                with span("lbfgs.step"):
                    fixed.graph()
                lbfgs_minimize.evaluations += 1
            x = run["ev"].x
            got = _read(fixed.values[:n], fixed.gnorms[:n])
            values, gnorms = list(got[:n]), list(got[n:])
        else:
            values, gnorms = [], []
            for i in range(n):
                value, grad, value_h = run["value"], run["grad"], \
                    run["value_h"]
                fresh_eval = not np.isfinite(value_h)
                if fresh_eval:  # value_and_grad_from_state: nothing stored
                    run["ev"].aim(x)
                    value, grad, _ = run["ev"]()
                d = -run["memory"].precondition(x, grad)
                init = [torch.dot(d, grad), torch.linalg.vector_norm(grad)]
                if fresh_eval:
                    init.append(value)
                ls = _ZoomLinesearch(
                    run["ev"], x, d, value, grad, run["learning_rate"], dt,
                    init, value_h=None if fresh_eval else value_h).run()
                x = x + float(ls.stepsize) * d
                best.select(x, ls.value_dev)
                run.update(value=ls.value_dev, grad=ls.grad,
                           value_h=ls.value, learning_rate=ls.stepsize)
                values.append(float(ls.value))
                gnorms.append(ls.gnorm)
        history.extend(float(v) for v in values)
        if telemetry is not None:
            t_dev = lbfgs_minimize.read_s - read0
            telemetry.on_step_time("l-bfgs", n,
                                   time.perf_counter() - t_chunk - t_dev,
                                   t_dev)
        prev_done = done
        done += n
        # cluster heartbeat (no-op without a supervisor): the chunk's reads
        # above waited for the card, so this certifies forward progress
        beat("l-bfgs", iter0 + done)
        if (callback is not None and callback_every > 0
                and prev_done // callback_every != done // callback_every):
            callback(done, x, (best.x, best.f, best.i))
        if preemption_requested() and done < maxiter:
            t_flush = time.perf_counter()
            if preempt_flush is not None:
                preempt_flush(done, x, (best.x, best.f, best.i))
            flush_s = time.perf_counter() - t_flush
            note_final_flush("l-bfgs", iter0 + done, flush_s,
                             verbose=verbose)
            if pbar is not None:
                pbar.close()
            raise Preempted("l-bfgs", iter0 + done,
                            flush_s=(flush_s if preempt_flush is not None
                                     else None))
        f_now = float(values[-1])
        if pbar is not None:
            pbar.update(n)
            pbar.set_postfix(loss=f_now)
        stop = None
        if not np.isfinite(f_now):
            stop = "non-finite"
        elif abs(f_prev - f_now) < tol_fun:
            stop = "stagnation"
        if stop is not None and not retreated and done < maxiter:
            retreated = True
            if on_retreat is not None:
                on_retreat(iter0 + done)
            _log_stop(f"{stop} on the reduced-precision loss at iter "
                      f"{iter0 + done}; retreating to the full-precision "
                      f"objective for the remaining {maxiter - done} iters")
            # the best finite iterate, or x0 when nothing improved: never
            # the possibly poisoned last one
            x = best.x.clone()
            run = fresh(fun_fallback)
            with torch.no_grad():
                f_best = fun_fallback(best.x).detach().reshape(())
                all_reduce_([f_best], run["ev"].mesh)
                best.f.copy_(f_best)
            lbfgs_minimize.evaluations += 1
            f_prev = np.inf
            continue
        if stop == "non-finite":
            _log_stop(f"non-finite loss at iter {iter0 + done}; stopping, "
                      "keeping the best iterate")
            break
        if stop == "stagnation":
            _log_stop(f"tolerance stop at iter {iter0 + done}: "
                      f"|f_prev-f_now|={abs(f_prev - f_now):.3e} < "
                      f"tol_fun={tol_fun:g} (f={f_now:.6e})")
            break
        if float(gnorms[-1]) < tol_grad:
            _log_stop(f"gradient stop at iter {iter0 + done}: "
                      f"|g|={float(gnorms[-1]):.3e} < tol_grad={tol_grad:g}")
            break
        f_prev = f_now
    if pbar is not None:
        pbar.close()
    return x.clone(), best.x, best.f, best.i, history


lbfgs_minimize.evaluations = 0
lbfgs_minimize.host_syncs = 0
lbfgs_minimize.read_s = 0.0


def flatten_layers(params) -> torch.Tensor:
    """The parameters (the network's flat list, or ``[(W, b), ...]``) as
    one contiguous 1-D copy."""
    return torch.cat([t.detach().reshape(-1) for t in param_leaves(params)])


def _is_pair(s) -> bool:
    return len(s) == 2 and all(isinstance(e, tuple) for e in s)


def unflatten_layers(x: torch.Tensor, shapes) -> list:
    """The parameters as views of the 1-D ``x``, in the structure of
    ``shapes`` (:func:`layer_shapes`: a flat list, or ``[(W, b), ...]``;
    contiguous pieces, so the kernel wrappers take them as they are;
    autograd through the views gives ``x``'s gradient in one piece)."""
    pairs = bool(shapes) and _is_pair(shapes[0])
    leaf_shapes = [s for pair in shapes for s in pair] if pairs \
        else list(shapes)
    pieces = x.split([int(np.prod(s)) for s in leaf_shapes])
    flat = [p.view(s) for p, s in zip(pieces, leaf_shapes)]
    return list(zip(flat[0::2], flat[1::2])) if pairs else flat


def layer_shapes(params) -> list:
    """The shapes of the parameters in their structure: one per tensor of
    a flat list, ``(W, b)`` pairs of ``[(W, b), ...]``."""
    params = list(params)
    if params and isinstance(params[0], (list, tuple)):
        return [(tuple(W.shape), tuple(b.shape)) for W, b in params]
    return [tuple(t.shape) for t in params]


def lbfgs_objective(loss_fn: Callable, lambdas: dict, X_f: torch.Tensor,
                    shapes) -> Callable:
    """``fun(x)``: the total of ``loss_fn`` at the flat parameters ``x``
    (in the structure of ``shapes``, :func:`unflatten_layers`), with the λ
    entering
    detached (frozen: no gradient is computed for them)."""
    lam_bcs = [None if lam is None else lam.detach()
               for lam in lambdas["BCs"]]
    lam_res = [None if lam is None else lam.detach()
               for lam in lambdas["residual"]]
    # NTK weighting's scalar weight on the assimilation term
    lam_data = lambdas.get("data", [None])[0]
    lam_data = None if lam_data is None else lam_data.detach()

    def fun(x):
        return loss_fn(unflatten_layers(x, shapes), lam_bcs, lam_res, X_f,
                       lam_data=lam_data)[0]
    # what a graph over the objective reads besides x (graphs.StepGraph)
    fun.tensors = [X_f] + [lam for lam in lam_bcs + lam_res + [lam_data]
                           if lam is not None]
    return fun


def fit_lbfgs(loss_fn: Callable, params, lambdas: dict, X_f: torch.Tensor,
              maxiter: int = 1000, memory_size: int = 50,
              verbose: bool = True, chunk: int = 100, eager: bool = False,
              callback: Optional[Callable] = None, callback_every: int = 0,
              iter0: int = 0, loss_fn_fallback: Optional[Callable] = None,
              telemetry=None, precision="highest", mesh=None,
              preempt_flush: Optional[Callable] = None,
              _graphs: bool = True):
    """L-BFGS phase over the network parameters with the SA λ frozen
    (reference ``fit.py:60-89``).

    ``params`` is the network's flat parameter list (or ``[(W, b),
    ...]``); ``loss_fn(params, lam_bcs, lam_res, X) -> (total,
    components)``.  The λ enter detached (no gradient is computed for
    them); the objective runs at ``precision`` (the network's: IEEE
    float32 unless ``"default"``).  The parameters travel as one flat
    buffer whose views are the parameters, in ``params``' structure.
    ``callback(done, params, (best_params, f_best, best_iter))`` receives
    the live iterate and best so.  ``loss_fn_fallback``: the
    full-precision objective of :func:`lbfgs_minimize`'s retreat.
    ``telemetry``: the chunks' step-time split (:func:`lbfgs_minimize`).
    ``iter0`` / ``preempt_flush(done, params, best)``: the preemption
    contract of :func:`lbfgs_minimize`, with ``params`` and ``best`` as
    ``callback`` takes them.  ``mesh``: data parallelism (:func:`lbfgs_minimize`); ``loss_fn`` is
    then the rank's share.  ``_graphs=False``: the eager referee of
    :func:`lbfgs_minimize`.

    Returns ``(params_final, params_best, best_loss, best_iter,
    loss_dicts, retreat)``: parameters of fresh tensors, the best loss and
    its iteration within this call as Python numbers, one ``{"Total Loss":
    v}`` per iteration, and the absolute iteration after which the leg
    retreated to ``loss_fn_fallback`` (``None``: it did not)."""
    shapes = layer_shapes(params)
    fun = lbfgs_objective(loss_fn, lambdas, X_f, shapes)
    fun_fallback = None
    if loss_fn_fallback is not None and loss_fn_fallback is not loss_fn:
        fun_fallback = lbfgs_objective(loss_fn_fallback, lambdas, X_f,
                                       shapes)

    def structured(fn):
        if fn is None:
            return None

        def call(done, x, best):
            fn(done, unflatten_layers(x, shapes),
               (unflatten_layers(best[0], shapes), best[1], best[2]))
        return call

    retreat = []
    t0 = time.time()
    with matmul_precision(precision):
        x, x_best, f_best, i_best, history = lbfgs_minimize(
            fun, flatten_layers(params), maxiter=maxiter,
            memory_size=memory_size, chunk=chunk, eager=eager,
            callback=structured(callback), callback_every=callback_every,
            iter0=iter0, fun_fallback=fun_fallback,
            on_retreat=retreat.append, verbose=verbose, telemetry=telemetry,
            mesh=mesh, preempt_flush=structured(preempt_flush),
            _graphs=_graphs)
    f_best, i_best = float(f_best), int(i_best)
    log_event("l-bfgs", f"{len(history)} iters in {time.time() - t0:.1f}s, "
              f"best loss {f_best:.3e} @ iter {i_best}", verbose=verbose)
    return (unflatten_layers(x, shapes), unflatten_layers(x_best, shapes),
            f_best, i_best, [{"Total Loss": v} for v in history],
            retreat[0] if retreat else None)
