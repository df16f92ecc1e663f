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

Under data parallelism (``mesh``, :mod:`..parallel`) every rank holds its
block of the set.  The pool redraw keeps the JAX package's GLOBAL
selection: every rank draws the same fresh pool and the same Gumbel noise
from the seed, scores its own rows of the pool, the scores are gathered,
and every rank takes the same top-k; the new set is laid out in rank
blocks again, so a kept row may change owner, and its λ and λ moments
travel with it (:meth:`~..training.fit.AdamStep.adopt` gathers them).
The ascent mover moves each rank's rows where they are and replaces each
rank's share of the lowest-score rows with its slice of one fresh draw
every rank makes alike.  The host path scores each rank's slice of the
pool (:func:`_scores_multihost`).  :func:`_allgather_by_row` assembles a
global host array from row slices through one float64 lane that carries
each row's index, so the result is bit-identical on every rank.

The surrogate factory's members redraw one by one
(:class:`FamilyResampler`, :class:`FamilyAscentResampler`): each member
scores with its own residual (its θ bound) and draws its own stream
``(seed, epoch, member)``; :func:`carry_rows_family` carries their λ.  On
the minimax step the ascent mover moves every member at once, each step
one member-axis score (one K3 launch over the members per tape group on
the card).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel import all_gather_rows, all_reduce_value
from ..sampling import LatinHypercubeSample
from ..utils import resolve_device

_TINY = float(np.finfo(np.float32).tiny)


def importance_select(scores: np.ndarray, n_keep: int, temp: float = 1.0,
                      uniform_frac: float = 0.1,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Indices of ``n_keep`` rows drawn without replacement with probability
    ``∝ (1-u)·|s|^temp/Σ + u/N``: Gumbel top-k in float64 on the host
    (the JAX package's function, draw for draw).  Scores are normalised by
    their maximum first, so ``s**temp`` cannot overflow; a zero row keeps a
    tiny floor so it stays reachable."""
    rng = rng or np.random.default_rng(0)
    # tdq: allow[dtype-discipline] host-side selection math (the host path): float64 keeps the Gumbel keys exact and never reaches the card
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
    # tdq: allow[dtype-discipline] host-side float64 tiny-floor keeps zero-score rows reachable without log(0)
    keys = np.log(np.maximum(p, np.finfo(np.float64).tiny)) + gumbel
    return np.argpartition(-keys, n_keep)[:n_keep]


def _row_scores(values) -> np.ndarray:
    """Per-row |f| in float64, summed over output columns."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    # tdq: allow[dtype-discipline] host-side score accumulation in float64 so summed |f| never saturates
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
    after the redraw has finished).  ``block``: under data parallelism with
    a global selection, ``(start, stop)`` of this rank's rows of the new
    set: ``X_new`` is that block, ``idx``/``kept`` are the whole group's
    (global rows), and the λ are carried over the gathered set; ``None``:
    everything is this rank's (the ascent mover, one process)."""

    X_new: torch.Tensor
    idx: torch.Tensor
    kept: torch.Tensor
    stats: dict
    block: Optional[tuple] = None


def redraw_generator(seed: int, epoch: int, device: torch.device,
                     member: Optional[int] = None) -> torch.Generator:
    """The ``torch.Generator`` of one redraw: on ``device``, seeded from
    ``(seed, epoch)`` through NumPy's ``SeedSequence`` so that neighbouring
    epochs draw decorrelated streams; a surrogate-factory ``member`` draws
    its own stream, from ``(seed, epoch, member)`` (the JAX package's
    ``fold_in(fold_in(seed, epoch), member)``)."""
    entropy = [int(seed), int(epoch)] + ([] if member is None
                                         else [int(member)])
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
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
    # tdq: allow[dtype-discipline] domain limits held in float64 on the host; each bound enters the device draw as a Python float
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


def _pool_scores(f) -> torch.Tensor:
    """|residual| summed over equations and columns, per row (float32)."""
    parts = f if isinstance(f, tuple) else (f,)
    scores = None
    for part in parts:
        a = torch.abs(part.to(torch.float32))
        a = torch.sum(a.reshape(a.shape[0], -1), 1)
        scores = a if scores is None else scores + a
    return scores


def _score_and_select(pool: torch.Tensor, f, n_f: int, temp: float,
                      uniform_frac: float, gen=None,
                      gumbel: Optional[torch.Tensor] = None,
                      scores: Optional[torch.Tensor] = None) -> ResampleSwap:
    """Score → select → stats, the block every pool redraw shares:
    |residual| summed over equations and columns (float32; ``scores``
    given instead of ``f`` when the group gathered them), Gumbel top-k,
    the kept mask and the ``kept_fraction``/``score_gain`` diagnostics."""
    if scores is None:
        scores = _pool_scores(f)
    idx = _gumbel_topk_device(scores, n_f, temp, uniform_frac, gen, gumbel)
    X_new = pool.index_select(0, idx)
    kept = idx < n_f
    sel_mean = torch.mean(scores.index_select(0, idx))
    stats = {"kept_fraction": torch.mean(kept.to(torch.float32)),
             "score_gain": sel_mean / torch.clamp_min(torch.mean(scores),
                                                      _TINY)}
    return ResampleSwap(X_new, idx, kept, stats)


def _check_tiles(n_f: int, mesh) -> None:
    if mesh is not None and n_f % mesh.size:
        raise ValueError(f"n_f={n_f} must be divisible by the group's "
                         f"{mesh.size} ranks for resampling under dist")


class DeviceResampler:
    """The device pool redraw: pool → score → select on the solver's
    device, no host copy of pool or scores (module docstring).

    ``redraw(params, X_cur, epoch)`` draws ``n_fresh = max(pool_factor - 1,
    1)·n_f`` stratified candidates, scores ``[X_cur ; fresh]`` with
    ``residual_fn(params, pool)`` under ``no_grad`` and keeps ``n_f`` rows.
    The fit loop dispatches it at one chunk boundary and swaps it in at the
    next (:mod:`..training.fit`).  ``mesh``: ``n_f`` counts the group's
    rows and ``X_cur`` is this rank's block; the selection is global
    (module docstring)."""

    pipelined = True

    def __init__(self, residual_fn: Callable, xlimits: np.ndarray, n_f: int,
                 *, pool_factor: int = 4, temp: float = 1.0,
                 uniform_frac: float = 0.1, seed: int = 0, mesh=None):
        self.residual_fn = residual_fn
        # tdq: allow[dtype-discipline] domain limits held in float64 on the host; the pool draw takes each bound as a Python float
        self.xlimits = np.asarray(xlimits, np.float64)
        self.n_f = int(n_f)
        self.temp = float(temp)
        self.uniform_frac = float(uniform_frac)
        self.seed = int(seed)
        self.n_fresh = max(int(pool_factor) - 1, 1) * self.n_f
        _check_tiles(self.n_f, mesh)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None

    def redraw(self, params, X_cur: torch.Tensor, epoch: int,
               member: Optional[int] = None) -> ResampleSwap:
        gen = redraw_generator(self.seed, epoch, X_cur.device, member)
        fresh = _stratified_pool(gen, self.n_fresh, self.xlimits)
        if self.mesh is None:
            pool = torch.cat([X_cur, fresh], 0)
            with torch.no_grad():
                f = self.residual_fn(params, pool)
                return _score_and_select(pool, f, self.n_f, self.temp,
                                         self.uniform_frac, gen)
        return self._redraw_global(params, X_cur, fresh, gen)

    def _redraw_global(self, params, X_cur, fresh, gen) -> ResampleSwap:
        """The group's redraw: this rank scores its current rows and its
        slice of the fresh ones, the scores are gathered into the pool's
        order (every rank's current rows, then every rank's fresh slices),
        and every rank selects the same rows with the same noise."""
        mesh, w = self.mesh, self.mesh.size
        n_l, k_l = self.n_f // w, self.n_fresh // w
        mine = fresh[mesh.rank * k_l:(mesh.rank + 1) * k_l]
        with torch.no_grad():
            s_local = _pool_scores(self.residual_fn(
                params, torch.cat([X_cur, mine], 0)))
            got = all_gather_rows(s_local, mesh).reshape(w, n_l + k_l)
            scores = torch.cat([got[:, :n_l].reshape(-1),
                                got[:, n_l:].reshape(-1)])
            pool = torch.cat([all_gather_rows(X_cur, mesh), fresh], 0)
            sw = _score_and_select(pool, None, self.n_f, self.temp,
                                   self.uniform_frac, gen, scores=scores)
        start, stop = mesh.block(self.n_f)
        return sw._replace(X_new=sw.X_new[start:stop].contiguous(),
                           block=(start, stop))


def _ascent_move(score_grad: Callable, X: torch.Tensor, xlimits,
                 n_steps: int, step_frac: float):
    """Move every row ``n_steps`` normalized-gradient-ascent steps up the
    residual landscape, clipped to the domain box after each step.
    ``score_grad(X) -> (s [N], g [N, d])`` gives the per-point scores
    ``Σ_e f_e²`` and their point gradient; each dimension steps
    ``step_frac`` of its extent.  Returns ``(X_new, s_first, s_last)``.
    Members' sets ``X [M, N, d]`` move at once, each row on its own, with
    ``score_grad`` over the member axis (``s [M, N]``, ``g [M, N, d]``)."""
    # tdq: allow[dtype-discipline] domain limits held in float64 on the host; the ascent move fills each bound into a float32 scalar
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
        gn = torch.sqrt(torch.sum(g * g, -1, keepdim=True))
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
    default differentiates ``Σ f²`` of ``residual_fn`` by autograd.

    ``mesh``: ``n_f`` counts the group's rows and ``X_cur`` is this rank's
    block, which moves where it is; the rank's ``fresh_frac`` share of its
    lowest-score rows takes its slice of one fresh draw that every rank
    makes alike from the seed, and the statistics are the group's."""

    pipelined = True

    def __init__(self, residual_fn: Callable, xlimits: np.ndarray, n_f: int,
                 *, n_steps: int = 5, step_frac: float = 0.005,
                 fresh_frac: float = 0.1, seed: int = 0,
                 score_grad_fn: Optional[Callable] = None, mesh=None):
        self.residual_fn = residual_fn
        # tdq: allow[dtype-discipline] domain limits held in float64 on the host; the ascent move fills each bound into a float32 scalar
        self.xlimits = np.asarray(xlimits, np.float64)
        _check_tiles(int(n_f), mesh)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        w = 1 if self.mesh is None else self.mesh.size
        # this rank's rows
        self.n_f = int(n_f) // w
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

    def redraw(self, params, X_cur: torch.Tensor, epoch: int,
               member: Optional[int] = None) -> ResampleSwap:
        X, s_first, s_last = _ascent_move(
            lambda Xv: self._score_grad(params, Xv), X_cur, self.xlimits,
            self.n_steps, self.step_frac)
        return self.swap(X, s_first, s_last, epoch, member)

    def swap(self, X: torch.Tensor, s_first: torch.Tensor,
             s_last: torch.Tensor, epoch: int,
             member: Optional[int] = None) -> ResampleSwap:
        """The redraw's swap after the move (``X`` moved, its scores before
        and after): the fresh coverage draw into the lowest-score rows, and
        the statistics."""
        n_f = self.n_f
        row = torch.arange(n_f, device=X.device)
        if self.n_fresh:
            gen = redraw_generator(self.seed, epoch, X.device, member)
            if self.mesh is None:
                fresh = _stratified_pool(gen, self.n_fresh, self.xlimits)
            else:
                k, r = self.n_fresh, self.mesh.rank
                fresh = _stratified_pool(gen, k * self.mesh.size,
                                         self.xlimits)[r * k:(r + 1) * k]
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
        means = torch.stack([torch.mean(kept.to(torch.float32)),
                             torch.mean(s_last), torch.mean(s_first)])
        if self.mesh is not None:
            # equal blocks: the group's means are the ranks' means averaged
            means = all_reduce_value(means, self.mesh) / self.mesh.size
        stats = {"kept_fraction": means[0],
                 "score_gain": means[1] / torch.clamp_min(means[2], _TINY),
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
                            seed: int = 0, device="cuda",
                            mesh=None) -> Callable:
    """``resample(params, epoch) -> X_new`` on ``device`` (the card unless
    the caller passes ``device="cpu"``, :func:`~..utils.resolve_device`),
    the host path:
    a NumPy LHS pool of ``pool_factor·n_f`` points (seeded from
    ``SeedSequence([seed, epoch])``, as in the JAX package), its residual
    scores pulled to the host, :func:`importance_select`, and the selected
    rows in pool order.  Synchronous; the pool is all fresh, so there is no
    row to carry per-point λ through.  ``mesh``: ``n_f`` counts the
    group's rows; every rank draws the same pool, scores its slice of it
    (:func:`_scores_multihost`), selects the same rows and returns its
    block of them."""
    _check_tiles(int(n_f), mesh)
    n_pool = max(int(pool_factor) * n_f, n_f)
    dev = resolve_device(device)
    multi = mesh is not None and mesh.size > 1

    def resample(params, epoch: int) -> torch.Tensor:
        pool, rng = _host_pool(n_pool, xlimits, seed, epoch)
        if multi:
            start, stop = (mesh.rank * n_pool // mesh.size,
                           (mesh.rank + 1) * n_pool // mesh.size)
            pool_t = torch.as_tensor(np.asarray(pool[start:stop], np.float32),
                                     device=dev)
            scores = _scores_multihost(residual_fn, params, pool_t, start,
                                       n_pool, mesh)
        else:
            pool_t = torch.as_tensor(np.asarray(pool, np.float32), device=dev)
            scores = residual_scores(residual_fn, params, pool_t)
        idx = importance_select(scores, n_f, temp=temp,
                                uniform_frac=uniform_frac, rng=rng)
        X_np = np.ascontiguousarray(pool[np.sort(idx)], np.float32)
        if multi:
            X_np = X_np[slice(*mesh.block(n_f))]
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
# the group's host arrays (data parallelism)
# --------------------------------------------------------------------- #
def _allgather_by_row(local: dict, n: int, mesh) -> np.ndarray:
    """The whole ``[n, w]`` float64 array every rank agrees on, from each
    rank's row slices (``local``: global start row → this rank's values for
    that slice, ``[k]`` or ``[k, w]``).  The (row, values) pairs ride ONE
    all-gather in a float64 lane (row indices exact up to 2^53) and each
    block scatters back into place, so the result is bit-identical on
    every rank; the JAX package's packing."""
    rows = np.concatenate([np.arange(s, s + v.shape[0])
                           for s, v in sorted(local.items())])
    # tdq: allow[dtype-discipline] the multi-rank row-lane packing contract: one float64 all-gather lane, exact to 2^53 (the JAX package's)
    vals = np.concatenate([np.asarray(v, np.float64).reshape(v.shape[0], -1)
                           for _, v in sorted(local.items())])
    # tdq: allow[dtype-discipline] row indices ride the same float64 lane (exact integers up to 2^53)
    packed = np.concatenate([rows[:, None].astype(np.float64), vals], 1)
    if mesh is None or mesh.group is None:
        packed_all = packed
    else:
        dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        t = torch.as_tensor(packed, device=dev)
        # the ranks' slices may differ in length: gather the lengths, pad
        sizes = all_gather_rows(torch.tensor([t.shape[0]], device=dev), mesh)
        k = int(sizes.max())
        pad = torch.zeros((k, t.shape[1]), dtype=t.dtype, device=dev)
        pad[:t.shape[0]] = t
        got = all_gather_rows(pad, mesh).reshape(mesh.size, k, -1)
        packed_all = torch.cat([got[r, :int(sizes[r])]
                                for r in range(mesh.size)]).cpu().numpy()
    # tdq: allow[dtype-discipline] host-side scatter target of the float64 all-gather lane
    out = np.zeros((n, vals.shape[1]), np.float64)
    out[packed_all[:, 0].astype(np.int64)] = packed_all[:, 1:]
    return out


def _scores_multihost(residual_fn: Callable, params, X_local: torch.Tensor,
                      start: int, n_pool: int, mesh) -> np.ndarray:
    """``[n_pool]`` global scores of a pool spread over the group: this
    rank scores its rows ``[start, start + len(X_local))`` and
    :func:`_allgather_by_row` assembles the whole vector, so the seeded
    selection after it is bit-identical on every rank."""
    return _allgather_by_row(
        {int(start): residual_scores(residual_fn, params, X_local)},
        n_pool, mesh)[:, 0]


def gather_rows_multihost(X_local: torch.Tensor, mesh) -> np.ndarray:
    """The group's whole ``[N, ...]`` array on the host from each rank's
    contiguous block ``X_local`` (rank ``r`` holds rows ``[r·k, (r+1)·k)``),
    through :func:`_allgather_by_row`: float64, identical on every
    rank."""
    k = int(X_local.shape[0])
    w = 1 if mesh is None else mesh.size
    r = 0 if mesh is None else mesh.rank
    # tdq: allow[dtype-discipline] feeds the float64 row-lane packing contract of _allgather_by_row
    host = X_local.detach().cpu().numpy().astype(np.float64)
    out = _allgather_by_row({r * k: host}, k * w, mesh)
    return out.reshape((k * w,) + tuple(X_local.shape[1:]))


# --------------------------------------------------------------------- #
# the surrogate factory's families (factory/family.py)
# --------------------------------------------------------------------- #
def _stack_swaps(swaps: list) -> ResampleSwap:
    """Members' redraws stacked on a leading member axis: ``X_new [M, n_f,
    d]``, ``idx``/``kept`` ``[M, n_f]``, each statistic ``[M]``."""
    return ResampleSwap(
        torch.stack([sw.X_new for sw in swaps]),
        torch.stack([sw.idx for sw in swaps]),
        torch.stack([sw.kept for sw in swaps]),
        {k: torch.stack([sw.stats[k] for sw in swaps])
         for k in swaps[0].stats})


class FamilyResampler:
    """:class:`DeviceResampler` over a surrogate factory's members: each
    member redraws its own collocation set, the pool of ``[its X_f ;
    fresh]`` scored by its own residual (``residual_fn(m, params_m, X)``:
    the member's engine with its θ bound; on ``fused="cuda"`` one K1
    launch per member), from its own stream ``(seed, epoch, m)``
    (:func:`redraw_generator`).  ``redraw(params, X_cur, members, epoch)``
    takes the stacked parameter leaves ``[M_local, ...]``, the stacked
    ``X_cur [M_local, n_f, d]`` and the members' global indices, and
    returns the members' :class:`ResampleSwap` stacked on the member axis
    (:func:`carry_rows_family` carries λ through it).  The factory
    dispatches it on the redraw stream behind the next chunk, as the solo
    solver does (``training.fit.dispatch_redraw``)."""

    pipelined = True

    def __init__(self, residual_fn: Callable, xlimits: np.ndarray, n_f: int,
                 n_members: int, *, pool_factor: int = 4, temp: float = 1.0,
                 uniform_frac: float = 0.1, seed: int = 0):
        self.residual_fn = residual_fn
        self.n_members = int(n_members)
        self._one = DeviceResampler(None, xlimits, n_f,
                                    pool_factor=pool_factor, temp=temp,
                                    uniform_frac=uniform_frac, seed=seed)
        self.n_f, self.n_fresh = self._one.n_f, self._one.n_fresh

    def redraw(self, params, X_cur: torch.Tensor, members, epoch: int
               ) -> ResampleSwap:
        swaps = []
        for i, m in enumerate(members):
            self._one.residual_fn = (
                lambda p, X, _m=m: self.residual_fn(_m, p, X))
            swaps.append(self._one.redraw([t[i] for t in params], X_cur[i],
                                          epoch, member=m))
        return _stack_swaps(swaps)


class FamilyAscentResampler:
    """:class:`AscentResampler` over a surrogate factory's members: each
    member moves its own points up its own residual landscape and takes
    its own fresh coverage draw from ``(seed, epoch, m)``.
    ``family_score_grad_fn(params, X) -> (scores [M, N], gX [M, N, d])``
    plugs in the members' minimax step over the member axis (the stacked
    parameter leaves and sets; one K3 launch over the members per tape
    group and ascent step on the card): every member moves at once, then
    each takes its swap.  Without one, each member moves on its own by
    autograd over ``residual_fn(m, params_m, X)``.
    :class:`FamilyResampler`'s contract and layout."""

    pipelined = True

    def __init__(self, residual_fn: Callable, xlimits: np.ndarray, n_f: int,
                 n_members: int, *, n_steps: int = 5,
                 step_frac: float = 0.005, fresh_frac: float = 0.1,
                 seed: int = 0,
                 family_score_grad_fn: Optional[Callable] = None):
        self.residual_fn = residual_fn
        self.family_score_grad_fn = family_score_grad_fn
        self.n_members = int(n_members)
        self._one = AscentResampler(None, xlimits, n_f, n_steps=n_steps,
                                    step_frac=step_frac,
                                    fresh_frac=fresh_frac, seed=seed)
        self.n_f, self.n_fresh = self._one.n_f, self._one.n_fresh

    def redraw(self, params, X_cur: torch.Tensor, members, epoch: int
               ) -> ResampleSwap:
        one = self._one
        if self.family_score_grad_fn is not None:
            X, s_first, s_last = _ascent_move(
                lambda Xv: self.family_score_grad_fn(params, Xv), X_cur,
                one.xlimits, one.n_steps, one.step_frac)
            return _stack_swaps([
                one.swap(X[i], s_first[i], s_last[i], epoch, member=m)
                for i, m in enumerate(members)])
        swaps = []
        for i, m in enumerate(members):
            one.residual_fn = lambda p, X, _m=m: self.residual_fn(_m, p, X)
            swaps.append(one.redraw([t[i] for t in params], X_cur[i], epoch,
                                    member=m))
        return _stack_swaps(swaps)


def carry_rows_family(rows: torch.Tensor, idx: torch.Tensor,
                      kept: torch.Tensor, fresh_zero: bool = False):
    """:func:`carry_rows` over the member axis: ``rows [M, n_f, ...]``
    row-aligned with each member's OLD set, gathered through that member's
    ``idx [M, n_f]``.  Returns ``(new_rows, drift)``, ``drift [M]``."""
    from torch.func import vmap
    return vmap(lambda r, i, k: carry_rows(r, i, k, fresh_zero=fresh_zero)
                )(rows, idx, kept)
