"""Residual-based adaptive collocation: the pool redraw and the PACMANN
ascent mover.

Counterpart of the single-process part of the JAX package's
``ops/resampling.py``.  Every ``resample_every`` Adam epochs (at a chunk
boundary) the collocation set is redrawn with ``N_f`` kept constant, so the
training step, its CUDA graph and the optimizer state carry on; only the
buffers' contents change.

* **Pool redraw** (:class:`DeviceResampler`): the pool is ``[current X_f ;
  (pool_factor - 1)·N_f stratified fresh points]``, scored by the solver's
  residual (on ``fused="cuda"`` one K1 launch over the whole pool), and
  ``N_f`` rows are kept by importance sampling ``p ∝ |f|^temp`` mixed with
  a ``uniform_frac`` floor, drawn without replacement by the Gumbel top-k
  trick.  Kept rows (pool index < ``N_f``) carry their per-point λ
  (:func:`carry_rows`).
* **Ascent mover** (:class:`AscentResampler`, arXiv:2411.19632): every
  current point takes K normalized-gradient steps up the squared-residual
  landscape, clipped to the domain box, and the ``fresh_frac`` lowest-score
  rows are replaced by a stratified coverage draw.  With the fused minimax
  step adopted, scores and direction come from one K3 launch at w ≡ 1
  (``∂/∂w = f²``, ``∂/∂X`` the direction), else from autograd over the
  residual.
* **Host path** (:func:`make_residual_resampler`): a NumPy LHS pool, host
  scores and a NumPy Gumbel top-k, synchronous; the cross-implementation
  reference, identical to the JAX package's draw for draw.

The device paths draw from a ``torch.Generator`` on the solver's device
seeded from ``(seed, epoch)`` (:func:`redraw_generator`), the counterpart
of ``fold_in(PRNGKey(seed), epoch)``: a redraw is reproducible, but its
stream is not JAX's.  So the draws are injectable (``_stratified_pool``'s
``perms``/``uniforms``, the top-k's ``gumbel``), which is how the tests feed
JAX's own draws through these functions.

Not ported (ROADMAP queue 1): multi-host scoring and gathering (item 6) and
the surrogate-factory family resamplers (item 7); they raise
:class:`~..utils.NotPortedError`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..sampling import LatinHypercubeSample
from ..utils import not_ported

_TINY = float(np.finfo(np.float32).tiny)
_MULTIHOST_ITEM = "queue 1 item 6, multi-GPU and multi-host"
_FAMILY_ITEM = "queue 1 item 7, factory/"


def importance_select(scores: np.ndarray, n_keep: int, temp: float = 1.0,
                      uniform_frac: float = 0.1,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Indices of ``n_keep`` rows drawn without replacement with probability
    ``∝ (1-u)·|s|^temp/Σ + u/N``: Gumbel top-k in float64 on the host
    (the JAX package's function, draw for draw).  Scores are normalised by
    their maximum first, so ``s**temp`` cannot overflow; a zero row keeps a
    tiny floor so it stays reachable."""
    rng = rng or np.random.default_rng(0)
    s = np.abs(np.asarray(scores, np.float64)).ravel()
    if n_keep >= s.size:
        return np.arange(s.size)
    smax = s.max()
    if smax > 0.0 and np.isfinite(smax):
        s = s / smax
    p = s ** temp
    tot = p.sum()
    if not np.isfinite(tot) or tot <= 0.0:
        p = np.full(s.size, 1.0 / s.size)
    else:
        p = (1.0 - uniform_frac) * p / tot + uniform_frac / s.size
    gumbel = rng.gumbel(size=s.size)
    keys = np.log(np.maximum(p, np.finfo(np.float64).tiny)) + gumbel
    return np.argpartition(-keys, n_keep)[:n_keep]


def _row_scores(values) -> np.ndarray:
    """Per-row |f| in float64, summed over output columns."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    a = np.abs(np.asarray(values, np.float64))
    return a.reshape(a.shape[0], -1).sum(axis=1)


def residual_scores(residual_fn: Callable, params, X) -> np.ndarray:
    """``[N]`` host importance scores: |residual| summed over outputs and
    equations, in float64."""
    with torch.no_grad():
        f = residual_fn(params, X)
    parts = f if isinstance(f, tuple) else (f,)
    s = None
    for part in parts:
        a = _row_scores(part)
        s = a if s is None else s + a
    return s


class ResampleSwap(NamedTuple):
    """One device redraw's results, on the device.

    ``X_new``: the ``[n_f, d]`` new collocation set.  ``idx``: each new
    row's pool index; a value ``< n_f`` is a kept current point and IS its
    old row (the λ-carry gather map).  ``kept``: ``idx < n_f``.  ``stats``:
    0-d device tensors ``kept_fraction`` and ``score_gain`` (read them only
    after the redraw has finished)."""

    X_new: torch.Tensor
    idx: torch.Tensor
    kept: torch.Tensor
    stats: dict


def redraw_generator(seed: int, epoch: int,
                     device: torch.device) -> torch.Generator:
    """The ``torch.Generator`` of one redraw: on ``device``, seeded from
    ``(seed, epoch)`` through NumPy's ``SeedSequence`` so that neighbouring
    epochs draw decorrelated streams."""
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _stratified_pool(gen: Optional[torch.Generator], n: int, xlimits,
                     device=None, perms=None, uniforms=None) -> torch.Tensor:
    """``[n, d]`` float32 LHS-like draw: each dimension splits its range
    into ``n`` strata, places one sample per stratum and shuffles the
    strata independently per dimension.  ``perms``/``uniforms`` (``d``
    arrays of ``n``) replace the generator's draws (the tests inject the
    JAX package's); else each dimension draws a permutation, then its
    uniforms, from ``gen``."""
    xl = np.asarray(xlimits, np.float64)
    dev = torch.device(device) if device is not None else gen.device
    cols = []
    for j in range(xl.shape[0]):
        lo, hi = float(xl[j, 0]), float(xl[j, 1])
        if perms is not None:
            strata = torch.as_tensor(np.array(perms[j]), device=dev)
            u = torch.as_tensor(np.array(uniforms[j], np.float32),
                                device=dev)
        else:
            strata = torch.randperm(n, generator=gen, device=dev)
            u = torch.rand(n, generator=gen, device=dev)
        cols.append(lo + (strata.to(torch.float32) + u) / n * (hi - lo))
    return torch.stack(cols, 1)


def _gumbel(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))``, U uniform on [tiny, 1)."""
    u = torch.rand(n, generator=gen, device=device).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def _gumbel_topk_device(scores: torch.Tensor, n_keep: int, temp: float,
                        uniform_frac: float, gen=None,
                        gumbel: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Device Gumbel top-k over ``p ∝ (1-u)·|s|^temp/Σ + u/N`` in float32:
    :func:`importance_select`'s distribution with its fallbacks (overflow or
    zero sum → uniform; zero rows floored).  Returns the selected indices
    sorted ascending (``torch.topk`` and ``jax.lax.top_k`` may order ties
    differently; the sort makes the set the result).  ``gumbel`` replaces
    the noise drawn from ``gen``."""
    s = torch.abs(scores)
    n = s.shape[0]
    smax = torch.max(s)
    s = torch.where((smax > 0.0) & torch.isfinite(smax), s / smax, s)
    p = s ** temp
    tot = torch.sum(p)
    p = torch.where(torch.isfinite(tot) & (tot > 0.0),
                    (1.0 - uniform_frac) * p / tot + uniform_frac / n,
                    torch.full_like(p, 1.0 / n))
    p = torch.clamp_min(p, _TINY)
    if gumbel is None:
        gumbel = _gumbel(gen, n, s.device)
    keys = torch.log(p) + gumbel
    idx = torch.topk(keys, n_keep, sorted=False).indices
    return torch.sort(idx).values


def _score_and_select(pool: torch.Tensor, f, n_f: int, temp: float,
                      uniform_frac: float, gen=None,
                      gumbel: Optional[torch.Tensor] = None) -> ResampleSwap:
    """Score → select → stats, the block every pool redraw shares:
    |residual| summed over equations and columns (float32), Gumbel top-k,
    the kept mask and the ``kept_fraction``/``score_gain`` diagnostics."""
    parts = f if isinstance(f, tuple) else (f,)
    scores = None
    for part in parts:
        a = torch.abs(part.to(torch.float32))
        a = torch.sum(a.reshape(a.shape[0], -1), 1)
        scores = a if scores is None else scores + a
    idx = _gumbel_topk_device(scores, n_f, temp, uniform_frac, gen, gumbel)
    X_new = pool.index_select(0, idx)
    kept = idx < n_f
    sel_mean = torch.mean(scores.index_select(0, idx))
    stats = {"kept_fraction": torch.mean(kept.to(torch.float32)),
             "score_gain": sel_mean / torch.clamp_min(torch.mean(scores),
                                                      _TINY)}
    return ResampleSwap(X_new, idx, kept, stats)


class DeviceResampler:
    """The device pool redraw: pool → score → select on the solver's
    device, no host copy of pool or scores (module docstring).

    ``redraw(params, X_cur, epoch)`` draws ``n_fresh = max(pool_factor - 1,
    1)·n_f`` stratified candidates, scores ``[X_cur ; fresh]`` with
    ``residual_fn(params, pool)`` under ``no_grad`` and keeps ``n_f`` rows.
    The fit loop dispatches it at one chunk boundary and swaps it in at the
    next (:mod:`..training.fit`)."""

    pipelined = True

    def __init__(self, residual_fn: Callable, xlimits: np.ndarray, n_f: int,
                 *, pool_factor: int = 4, temp: float = 1.0,
                 uniform_frac: float = 0.1, seed: int = 0):
        self.residual_fn = residual_fn
        self.xlimits = np.asarray(xlimits, np.float64)
        self.n_f = int(n_f)
        self.temp = float(temp)
        self.uniform_frac = float(uniform_frac)
        self.seed = int(seed)
        self.n_fresh = max(int(pool_factor) - 1, 1) * self.n_f

    def redraw(self, params, X_cur: torch.Tensor, epoch: int) -> ResampleSwap:
        gen = redraw_generator(self.seed, epoch, X_cur.device)
        fresh = _stratified_pool(gen, self.n_fresh, self.xlimits)
        pool = torch.cat([X_cur, fresh], 0)
        with torch.no_grad():
            f = self.residual_fn(params, pool)
            return _score_and_select(pool, f, self.n_f, self.temp,
                                     self.uniform_frac, gen)


def _ascent_move(score_grad: Callable, X: torch.Tensor, xlimits,
                 n_steps: int, step_frac: float):
    """Move every row ``n_steps`` normalized-gradient-ascent steps up the
    residual landscape, clipped to the domain box after each step.
    ``score_grad(X) -> (s [N], g [N, d])`` gives the per-point scores
    ``Σ_e f_e²`` and their point gradient; each dimension steps
    ``step_frac`` of its extent.  Returns ``(X_new, s_first, s_last)``."""
    xl = np.asarray(xlimits, np.float64)

    def column(vals):  # fills, not a host-to-device copy that would wait
        return torch.stack([torch.full((), float(v), device=X.device)
                            for v in vals])

    lo, hi = column(xl[:, 0]), column(xl[:, 1])
    step = step_frac * (hi - lo)
    s_first = None
    for _ in range(max(int(n_steps), 0)):
        s, g = score_grad(X)
        if s_first is None:
            s_first = s
        gn = torch.sqrt(torch.sum(g * g, 1, keepdim=True))
        X = torch.clamp(X + step * g / torch.clamp_min(gn, _TINY), lo, hi)
    s_last, _ = score_grad(X)
    if s_first is None:  # n_steps=0: a scoring pass and nothing else
        s_first = s_last
    return X, s_first, s_last


class AscentResampler:
    """The PACMANN ascent mover (module docstring), with
    :class:`DeviceResampler`'s contract: ``redraw(params, X_cur, epoch) ->
    ResampleSwap``, pipelined by the fit loop.  A moved row keeps its row
    (``idx = row``, ``kept``), so its per-point λ and λ moments ride the
    move untouched; the ``fresh_frac·n_f`` lowest-score rows after the move
    are replaced by a stratified draw and index past ``n_f``.

    ``score_grad_fn(params, X) -> (scores [N], gX [N, d])`` plugs in the
    solver's fused minimax step (one K3 launch at w ≡ 1 on the card); the
    default differentiates ``Σ f²`` of ``residual_fn`` by autograd."""

    pipelined = True

    def __init__(self, residual_fn: Callable, xlimits: np.ndarray, n_f: int,
                 *, n_steps: int = 5, step_frac: float = 0.005,
                 fresh_frac: float = 0.1, seed: int = 0,
                 score_grad_fn: Optional[Callable] = None):
        self.residual_fn = residual_fn
        self.xlimits = np.asarray(xlimits, np.float64)
        self.n_f = int(n_f)
        self.n_steps = int(n_steps)
        self.step_frac = float(step_frac)
        self.seed = int(seed)
        self.n_fresh = int(round(max(min(float(fresh_frac), 1.0), 0.0)
                                 * self.n_f))
        self.score_grad_fn = score_grad_fn

    def _score_grad(self, params, X: torch.Tensor):
        if self.score_grad_fn is not None:
            return self.score_grad_fn(params, X)
        with torch.enable_grad():
            Xg = X.detach().requires_grad_(True)
            f = self.residual_fn(params, Xg)
            parts = f if isinstance(f, tuple) else (f,)
            s = None
            for p in parts:
                a = torch.sum(torch.square(p.reshape(X.shape[0], -1)), 1)
                s = a if s is None else s + a
            (g,) = torch.autograd.grad(s.sum(), Xg)
        return s.detach(), g

    def redraw(self, params, X_cur: torch.Tensor, epoch: int) -> ResampleSwap:
        X, s_first, s_last = _ascent_move(
            lambda Xv: self._score_grad(params, Xv), X_cur, self.xlimits,
            self.n_steps, self.step_frac)
        n_f = self.n_f
        row = torch.arange(n_f, device=X.device)
        if self.n_fresh:
            gen = redraw_generator(self.seed, epoch, X.device)
            fresh = _stratified_pool(gen, self.n_fresh, self.xlimits)
            # the lowest-score rows contribute least where they stand:
            # recycle them as the coverage draw
            worst = torch.topk(-s_last, self.n_fresh, sorted=True).indices
            # index_fill_/index_copy_, not item assignment: assigning a
            # Python bool copies it to the device from pageable memory,
            # which waits for the redraw stream and stalls the dispatch
            is_fresh = torch.zeros(n_f, dtype=torch.bool,
                                   device=X.device).index_fill_(0, worst, True)
            X = X.index_copy(0, worst, fresh)
            rank = torch.cumsum(is_fresh.to(torch.int64), 0) - 1
            idx = torch.where(is_fresh, n_f + rank, row)
            kept = ~is_fresh
        else:
            idx, kept = row, torch.ones(n_f, dtype=torch.bool,
                                        device=X.device)
        stats = {"kept_fraction": torch.mean(kept.to(torch.float32)),
                 "score_gain": torch.mean(s_last) / torch.clamp_min(
                     torch.mean(s_first), _TINY),
                 "ascent_steps": torch.full((), float(self.n_steps),
                                            device=X.device)}
        return ResampleSwap(X.detach(), idx, kept, stats)


def carry_rows(rows: torch.Tensor, idx: torch.Tensor, kept: torch.Tensor,
               fresh_zero: bool = False):
    """Carry per-point state through a redraw.

    ``rows`` is any ``[n_f, ...]`` tensor row-aligned with the OLD
    collocation set (per-point λ or its λ-ascent Adam moments).  Kept rows
    gather their values; fresh rows take the kept rows' mean (the adaptive
    SA-λ schedule, arXiv:2207.04084; with no kept row, the old set's mean),
    or zero with ``fresh_zero=True`` (the moment rule: a fresh point has no
    ascent history).  Returns ``(new_rows, drift)``, ``drift`` the relative
    change of the mean as a 0-d tensor."""
    rows = rows.detach()
    n_f = rows.shape[0]
    g = rows.index_select(0, torch.clamp(idx, 0, n_f - 1))
    k = kept.reshape((-1,) + (1,) * (g.ndim - 1))
    if fresh_zero:
        fresh0 = torch.zeros(g.shape[1:], dtype=g.dtype, device=g.device)
    else:
        n_kept = torch.sum(kept)
        mean_kept = (torch.sum(torch.where(k, g, torch.zeros_like(g)), 0)
                     / torch.clamp_min(n_kept, 1).to(g.dtype))
        fresh0 = torch.where(n_kept > 0, mean_kept, torch.mean(rows, 0))
    new = torch.where(k, g, fresh0)
    mean_old = torch.mean(rows)
    drift = torch.abs(torch.mean(new) - mean_old) / torch.clamp_min(
        torch.abs(mean_old), _TINY)
    return new, drift


def make_residual_resampler(residual_fn: Callable, xlimits: np.ndarray,
                            n_f: int, *, pool_factor: int = 4,
                            temp: float = 1.0, uniform_frac: float = 0.1,
                            seed: int = 0, device="cpu") -> Callable:
    """``resample(params, epoch) -> X_new`` on ``device``, the host path:
    a NumPy LHS pool of ``pool_factor·n_f`` points (seeded from
    ``SeedSequence([seed, epoch])``, as in the JAX package), its residual
    scores pulled to the host, :func:`importance_select`, and the selected
    rows in pool order.  Synchronous; the pool is all fresh, so there is no
    row to carry per-point λ through."""
    n_pool = max(int(pool_factor) * n_f, n_f)
    dev = torch.device(device)

    def resample(params, epoch: int) -> torch.Tensor:
        pool, rng = _host_pool(n_pool, xlimits, seed, epoch)
        pool_t = torch.as_tensor(np.asarray(pool, np.float32), device=dev)
        scores = residual_scores(residual_fn, params, pool_t)
        idx = importance_select(scores, n_f, temp=temp,
                                uniform_frac=uniform_frac, rng=rng)
        X_np = np.ascontiguousarray(pool[np.sort(idx)], np.float32)
        return torch.as_tensor(X_np, device=dev)

    return resample


def _host_pool(n_pool: int, xlimits, seed: int, epoch: int):
    """The host path's ``(pool, selection rng)`` of one redraw: two streams
    spawned from ``SeedSequence([seed, epoch])``, an LHS pool from the
    first and the Gumbel noise's generator from the second."""
    pool_ss, sel_ss = np.random.SeedSequence([int(seed), int(epoch)]).spawn(2)
    pool = LatinHypercubeSample(n_pool, xlimits, criterion="c",
                                seed=int(pool_ss.generate_state(1)[0]))
    return pool, np.random.default_rng(sel_ss)


# --------------------------------------------------------------------- #
# not ported: multi-host scoring (item 6) and the factory families (item 7)
# --------------------------------------------------------------------- #
def _scores_multihost(*args, **kwargs):
    raise not_ported("multi-host resample scoring", _MULTIHOST_ITEM)


def _allgather_by_row(*args, **kwargs):
    raise not_ported("the multi-host row allgather", _MULTIHOST_ITEM)


def gather_rows_multihost(*args, **kwargs):
    raise not_ported("gather_rows_multihost", _MULTIHOST_ITEM)


def carry_rows_family(*args, **kwargs):
    raise not_ported("carry_rows_family", _FAMILY_ITEM)


class FamilyResampler:
    def __init__(self, *args, **kwargs):
        raise not_ported("FamilyResampler", _FAMILY_ITEM)


class FamilyAscentResampler:
    def __init__(self, *args, **kwargs):
        raise not_ported("FamilyAscentResampler", _FAMILY_ITEM)
