"""Visualization helpers (parity: reference ``tensordiffeq/plotting.py``,
itself credited to Raissi et al.; the JAX package's ``plotting.py``):
solution heatmap with time-slice cuts vs the exact solution, SA-weight
scatter, residual plots, and grid interpolation, on NumPy.

Matplotlib is imported lazily with the ``Agg`` backend as fallback so the
library stays importable on headless hosts.  The solvers' tensors (λ, the
collocation set) are read as NumPy copies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (any device, with or without autograd) or array-like as a
    NumPy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    try:
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    return plt


def figsize(scale: float, nplots: float = 1.0):
    """Golden-ratio figure size (reference ``plotting.py:12-22``)."""
    fig_width_pt = 390.0
    inches_per_pt = 1.0 / 72.27
    golden_mean = (np.sqrt(5.0) - 1.0) / 2.0
    fig_width = fig_width_pt * inches_per_pt * scale
    fig_height = nplots * fig_width * golden_mean
    return [fig_width, fig_height]


def newfig(width: float, nplots: float = 1.0):
    """New figure + axis (reference ``plotting.py:25-28``)."""
    plt = _plt()
    fig = plt.figure(figsize=figsize(width, nplots))
    ax = fig.add_subplot(111)
    return fig, ax


def get_griddata(grid, data, dims):
    """Interpolate scattered predictions onto a plot grid
    (reference ``plotting.py:156-157``)."""
    from scipy.interpolate import griddata
    return griddata(grid, data, dims, method="cubic")


def plot_solution_domain1D(model, domain: Sequence[np.ndarray], ub, lb,
                           Exact_u=None, u_values=None,
                           save_path: Optional[str] = None, component=0,
                           best_model: bool = False):
    """Heatmap of u(x,t) plus three time-slice cuts vs the exact solution
    (reference ``plotting.py:31-127``).

    ``domain`` is ``[x_linspace, t_linspace]``; ``model`` must expose
    ``predict(X_star) -> (u, f_u)``; pass ``save_path`` to write a PNG
    instead of showing the window.  For multi-output networks ``component``
    selects the output column, or ``"abs"`` plots the vector magnitude
    (e.g. |h| for a complex field split into real/imaginary outputs).
    ``best_model=True`` plots the best-checkpoint parameters — matching the
    error every example reports — instead of the last iterate.
    """
    plt = _plt()
    x, t = domain
    X, T = np.meshgrid(x, t)
    X_star = np.hstack((X.flatten()[:, None], T.flatten()[:, None]))
    if u_values is None:
        kw = {"best_model": True} if best_model else {}
        u_values, _ = model.predict(X_star, **kw)
    u_values = _np(u_values).reshape(X_star.shape[0], -1)
    if component == "abs":
        u_values = np.sqrt((u_values ** 2).sum(axis=1))
    else:
        u_values = u_values[:, component]
    U_pred = get_griddata(X_star, u_values.flatten(), (X, T))

    fig = plt.figure(figsize=figsize(1.5, 0.9))
    ax = fig.add_subplot(211)
    h = ax.imshow(U_pred.T, interpolation="nearest", cmap="rainbow",
                  extent=[t.min(), t.max(), x.min(), x.max()],
                  origin="lower", aspect="auto")
    fig.colorbar(h, ax=ax)
    ax.set_xlabel("$t$")
    ax.set_ylabel("$x$")
    ax.set_title("$u(x,t)$", fontsize=10)

    slice_times = [len(t) // 4, len(t) // 2, (3 * len(t)) // 4]
    for i, it in enumerate(slice_times):
        ax = fig.add_subplot(2, 3, 4 + i)
        if Exact_u is not None:
            ax.plot(x, _np(Exact_u)[:, it], "b-", linewidth=2,
                    label="Exact")
        ax.plot(x, U_pred[it, :], "r--", linewidth=2, label="Prediction")
        ax.set_xlabel("$x$")
        ax.set_ylabel("$u(x,t)$")
        ax.set_title(f"$t = {t[it]:.2f}$", fontsize=10)
        ax.set_xlim([lb[0] - 0.1, ub[0] + 0.1])
        if i == 1:
            ax.legend(loc="upper center", bbox_to_anchor=(0.5, -0.35),
                      ncol=2, frameon=False)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()
    return fig


def plot_weights(model, scale: float = 1.0, save_path: Optional[str] = None):
    """Scatter of SA collocation weights over the domain
    (reference ``plotting.py:130-132``).  Accepts the forward solver
    (per-point residual λ over ``X_f``) AND the DiscoveryModel (SA
    ``col_weights`` over the observation grid — the reference's
    ``AC-inference.py:69`` calls this on a DiscoveryModel and its own
    implementation 'doesnt work quite yet'; this one does)."""
    plt = _plt()
    lam = None
    if getattr(model, "col_weights", None) is not None:  # DiscoveryModel
        lam = _np(model.col_weights)
        X_f = _np(model.X)
    elif hasattr(model, "lambdas"):  # forward solver
        for cand in model.lambdas.get("residual", []):
            if cand is not None:
                lam = _np(cand)
                break
        X_f = _np(model.X_f)
    if lam is None:
        raise ValueError("model has no adaptive residual weights to plot")
    fig, ax = plt.subplots()
    sc = ax.scatter(X_f[:, 1], X_f[:, 0], c=lam.ravel() * scale, s=2,
                    cmap="viridis")
    fig.colorbar(sc, ax=ax, label=r"$\lambda$")
    ax.set_xlabel("$t$")
    ax.set_ylabel("$x$")
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()
    return fig


def plot_glam_values(model, scale: float = 1.0, save_path: Optional[str] = None):
    """Scatter of g(λ) values (reference ``plotting.py:135-137``)."""
    g = model.g if getattr(model, "g", None) is not None else (lambda x: x ** 2)
    import types

    proxy = types.SimpleNamespace(
        lambdas={"residual": [None if lam is None else g(lam)
                              for lam in model.lambdas["residual"]]},
        X_f=model.X_f)
    return plot_weights(proxy, scale=scale, save_path=save_path)


def plot_residuals(X_star, f_u_pred, dims, save_path: Optional[str] = None):
    """Heatmap of the PDE residual over the domain
    (reference ``plotting.py:141-153``)."""
    plt = _plt()
    X, T = dims
    FU_pred = get_griddata(X_star, _np(f_u_pred).flatten(), (X, T))
    fig, ax = plt.subplots()
    h = ax.imshow(np.abs(FU_pred.T), interpolation="nearest", cmap="rainbow",
                  extent=[T.min(), T.max(), X.min(), X.max()],
                  origin="lower", aspect="auto")
    fig.colorbar(h, ax=ax, label="|f(x,t)|")
    ax.set_xlabel("$t$")
    ax.set_ylabel("$x$")
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()
    return fig
