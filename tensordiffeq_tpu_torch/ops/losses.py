"""Loss primitives for collocation training.

Counterpart of the JAX package's ``ops/losses.py`` (reference
``tensordiffeq/utils.py:38-48``); full means, exactly the reference
semantics:

* ``MSE(pred, actual)``                     -> ``mean((pred-actual)**2)``
* ``MSE(..., weights, outside_sum=False)``  -> ``mean((w*(pred-actual))**2)``
  (SA-PINN "type 1" per-point weighting, McClenny et al. arXiv:2009.04544)
* ``MSE(..., weights, outside_sum=True)``   -> ``w * mean((pred-actual)**2)``
  ("type 2" scalar per-loss weighting)
* ``g_MSE(pred, actual, g_lam)``            -> ``mean(g_lam*(pred-actual)**2)``

and the temporal-causality weighting of the residual
(:func:`causal_residual_loss`).
"""

from __future__ import annotations

from typing import Optional

import torch


def MSE(pred, actual=0.0, weights: Optional[torch.Tensor] = None,
        outside_sum: bool = False):
    """Weighted mean-squared error (reference: ``utils.py:38-44``)."""
    diff = pred - actual
    if weights is not None:
        if outside_sum:
            return weights * torch.mean(torch.square(diff))
        return torch.mean(torch.square(weights * diff))
    return torch.mean(torch.square(diff))


def g_MSE(pred, actual, g_lam):
    """``mean(g_lam * (pred-actual)**2)`` (reference ``utils.py:47-48``):
    the loss for the optional ``g(lambda)`` transform of SA weights."""
    return torch.mean(g_lam * torch.square(pred - actual))


def default_g(lam):
    """Default SA-weight transform ``g(lam) = lam**2``."""
    return torch.square(lam)


def causal_residual_loss(sq_errors, t_column, t_bounds, eps, n_bins: int,
                         mesh=None):
    """Temporal-causality-weighted residual loss (Wang, Sankaran &
    Perdikaris, arXiv:2203.07404; the JAX package's
    ``causal_residual_loss``): the points are binned uniformly along time,
    bin ``b``'s mean squared residual ``L_b`` is weighted by ``w_b =
    exp(-eps · Σ_{b' < b} L_b')`` (no gradient through ``w``), so later
    times train once earlier ones are resolved.  Returns ``(loss,
    w_last)``; ``w_last → 1`` when the whole horizon trains.

    ``eps`` is a number or a 0-d tensor (the solver keeps it in a device
    scalar, so one captured step serves every stage of an ε ladder).  The
    bin sums are a one-hot mask and a column sum, not ``index_add_``: on
    CUDA that scatters by atomics, whose order changes from run to run,
    and a replayed graph would then not equal the eager step bit for bit.
    The mask depends only on the time column, so it also follows a
    minibatch or a redraw without any state.

    ``mesh`` (a :class:`~..parallel.DataMesh` with a process group: the
    points are split over ranks): the bins' sums and counts span the ranks,
    so their detached values are summed over the group by one all-reduce
    (inside the step, and so inside its CUDA graph under NCCL), ``w`` comes
    from the global bin means, and the rank's term is ``Σ_b w_b ·
    local_sum_b / max(global_count_b, 1) / n_bins``, which sums over the
    ranks to the global loss; ``w_last`` is the global one on every rank.
    At world 1 this is bit for bit the single-process loss."""
    t0, t1 = t_bounds
    sq = sq_errors.reshape(-1)
    pos = (t_column.reshape(-1) - t0) / (t1 - t0)
    bins = torch.clamp((pos * n_bins).to(torch.int32), 0, n_bins - 1)
    onehot = (bins[:, None] == torch.arange(
        n_bins, dtype=torch.int32, device=sq.device)[None, :]).to(sq.dtype)
    counts = torch.sum(onehot, 0)
    sums = torch.sum(sq[:, None] * onehot, 0)
    means = None
    if mesh is not None and mesh.group is not None:
        from ..parallel import all_reduce_
        glob = torch.cat([sums.detach(), counts])
        all_reduce_([glob], mesh)
        counts = glob[n_bins:]
        means = glob[:n_bins] / torch.clamp(counts, min=1.0)
    per_bin = sums / torch.clamp(counts, min=1.0)
    if means is None:
        means = per_bin
    cum = torch.cat([torch.zeros(1, dtype=per_bin.dtype, device=sq.device),
                     torch.cumsum(means, 0)[:-1]])
    w = torch.exp(-eps * cum).detach()
    return torch.mean(w * per_bin), w[-1]


def relative_l2(pred, ref):
    """Relative L2 error ``||ref - pred||_2 / ||ref||_2``."""
    pred = torch.ravel(torch.as_tensor(pred))
    ref = torch.ravel(torch.as_tensor(ref))
    return torch.linalg.norm(ref - pred) / torch.linalg.norm(ref)
