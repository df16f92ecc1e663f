"""High-accuracy reference solutions for the canonical benchmark PDEs.

The same generators as the JAX package's ``exact.py`` (NumPy only, so the
arrays agree bit for bit):

* :func:`allen_cahn_solution` — Fourier pseudo-spectral discretisation +
  ETDRK4 exponential time integrator (Kassam & Trefethen 2005) for
  ``u_t = 1e-4 u_xx + 5(u - u^3)`` with periodic BCs on x in [-1, 1].
* :func:`burgers_solution` — the Cole–Hopf closed form for
  ``u_t + u u_x = nu u_xx``, ``u(x,0) = -sin(pi x)``, evaluated with
  Gauss–Hermite quadrature.
* :func:`schrodinger_solution` — split-step Fourier (Strang splitting) for
  the focusing NLS ``i h_t + 0.5 h_xx + |h|^2 h = 0``, ``h(x,0) = 2 sech x``.

The PDE zoo's closed forms (:mod:`.zoo`), evaluated directly:
:func:`taylor_green_solution` (the decaying Taylor–Green vortex),
:func:`reaction_diffusion_solution` (a rotation-coupled linear system),
:func:`heat3d_solution` (a separable 3D heat mode) and
:func:`convection_solution` (periodic advection).

The integrators' solutions are memoised to ``.npz`` files under this
package's own ``_fixture_cache/`` directory (git-ignored), so tests and
``chip_smoke.py`` pay the seconds-scale CPU cost once per checkout.
"""

from __future__ import annotations

import os

import numpy as np

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "_fixture_cache")


def _cache_path(name: str) -> str:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    return os.path.join(_CACHE_DIR, name + ".npz")


def _memoise(name, builder):
    path = _cache_path(name)
    if os.path.exists(path):
        with np.load(path) as z:
            return z["x"], z["t"], z["u"]
    x, t, u = builder()
    # write-then-rename: concurrent test workers never read a torn file
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, x=x, t=t, u=u)
    os.replace(tmp, path)
    return x, t, u


def _etdrk4_allen_cahn(nx: int, nt: int, t_final: float, eps: float,
                       dt: float):
    """Integrate u_t = eps*u_xx + 5u - 5u^3, periodic on [-1, 1)."""
    x = -1.0 + 2.0 * np.arange(nx) / nx           # periodic grid (no endpoint)
    u = x ** 2 * np.cos(np.pi * x)                # reference IC (AC-SA paper)
    v = np.fft.fft(u)

    k = np.fft.fftfreq(nx, d=1.0 / nx) * np.pi    # 2*pi*m/L with L=2
    L = -eps * k ** 2 + 5.0                       # linear operator symbol
    E = np.exp(dt * L)
    E2 = np.exp(dt * L / 2.0)

    # ETDRK4 scalar coefficients via complex contour integral (Kassam-Trefethen)
    M = 32
    r = np.exp(1j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    LR = dt * L[:, None] + r[None, :]
    Q = dt * np.real(np.mean((np.exp(LR / 2) - 1) / LR, axis=1))
    f1 = dt * np.real(np.mean(
        (-4 - LR + np.exp(LR) * (4 - 3 * LR + LR ** 2)) / LR ** 3, axis=1))
    f2 = dt * np.real(np.mean(
        (2 + LR + np.exp(LR) * (-2 + LR)) / LR ** 3, axis=1))
    f3 = dt * np.real(np.mean(
        (-4 - 3 * LR - LR ** 2 + np.exp(LR) * (4 - LR)) / LR ** 3, axis=1))

    def N(vhat):
        uu = np.real(np.fft.ifft(vhat))
        return np.fft.fft(-5.0 * uu ** 3)

    n_steps = int(round(t_final / dt))
    save_every = max(1, n_steps // (nt - 1))
    if n_steps % (nt - 1):
        raise ValueError("choose dt dividing t_final/(nt-1)")

    out = np.empty((nx, nt))
    out[:, 0] = u
    j = 1
    for n in range(1, n_steps + 1):
        Nv = N(v)
        a = E2 * v + Q * Nv
        Na = N(a)
        b = E2 * v + Q * Na
        Nb = N(b)
        c = E2 * a + Q * (2 * Nb - Nv)
        Nc = N(c)
        v = E * v + Nv * f1 + 2 * (Na + Nb) * f2 + Nc * f3
        if n % save_every == 0:
            out[:, j] = np.real(np.fft.ifft(v))
            j += 1
    return x, out


def allen_cahn_solution(nx: int = 512, nt: int = 201, t_final: float = 1.0,
                        eps: float = 1e-4):
    """Allen-Cahn benchmark solution on a ``(nx, nt)`` grid.

    Returns ``(x, t, usol)`` with ``x`` shape (nx,), ``t`` shape (nt,),
    ``usol`` shape (nx, nt) — the layout of the reference's ``AC.mat``.
    """
    def build():
        substeps = 10  # 2000 total steps: well inside ETDRK4's stability
        dt = t_final / ((nt - 1) * substeps)
        x, u = _etdrk4_allen_cahn(nx, nt, t_final, eps, dt)
        t = np.linspace(0.0, t_final, nt)
        return x, t, u

    return _memoise(f"allen_cahn_{nx}x{nt}_{eps:g}", build)


def burgers_solution(nx: int = 256, nt: int = 100, nu: float = 0.01 / np.pi,
                     n_quad: int = 100):
    """Exact viscous-Burgers solution ``u_t + u u_x = nu u_xx`` with
    ``u(x, 0) = -sin(pi x)`` on [-1, 1] (homogeneous Dirichlet by symmetry),
    by Cole–Hopf with Gauss–Hermite quadrature.  Returns ``(x, t, usol)``
    with ``usol`` shape (nx, nt); t starts at 0 (IC row exact).
    """
    def build():
        x = np.linspace(-1.0, 1.0, nx)
        t = np.linspace(0.0, 1.0, nt)
        s_nodes, s_weights = np.polynomial.hermite.hermgauss(n_quad)
        u = np.empty((nx, nt))
        u[:, 0] = -np.sin(np.pi * x)
        c = 1.0 / (2.0 * np.pi * nu)
        for j, tj in enumerate(t[1:], start=1):
            a = np.sqrt(4.0 * nu * tj)
            y = x[:, None] - a * s_nodes[None, :]
            f = np.exp(-c * np.cos(np.pi * y))
            num = -(np.sin(np.pi * y) * f) @ s_weights
            den = f @ s_weights
            u[:, j] = num / den
        return x, t, u

    return _memoise(f"burgers_{nx}x{nt}_{nu:g}_{n_quad}", build)


# --------------------------------------------------------------------------- #
# Nonlinear Schrödinger: split-step Fourier (Strang splitting)
# --------------------------------------------------------------------------- #
def schrodinger_solution(nx: int = 256, nt: int = 201,
                         t_final: float = np.pi / 2, substeps: int = 20):
    """Focusing NLS benchmark ``i h_t + 0.5 h_xx + |h|^2 h = 0`` with
    ``h(x, 0) = 2 sech(x)``, periodic on x in [-5, 5) — the classical
    2-output (real/imaginary) PINN benchmark (Raissi et al. 2019 §3.1.1;
    the reference framework handles 2-output residual tuples at
    ``models.py:189-191`` but ships no such example).

    Strang split-step Fourier: the nonlinear phase rotation
    ``h <- exp(i |h|^2 dt) h`` is exact (|h| invariant), the linear step is
    exact in Fourier space, so the scheme is spectrally accurate in x and
    O(dt^2) in t.  Returns ``(x, t, h)`` with complex ``h`` of shape
    ``(nx, nt)``.
    """
    def build():
        x = -5.0 + 10.0 * np.arange(nx) / nx      # periodic grid, L = 10
        t = np.linspace(0.0, t_final, nt)
        k = np.fft.fftfreq(nx, d=1.0 / nx) * (2.0 * np.pi / 10.0)
        dt = t_final / ((nt - 1) * substeps)
        half_lin = np.exp(-0.5j * k ** 2 * (dt / 2.0))

        h = (2.0 / np.cosh(x)).astype(np.complex128)
        out = np.empty((nx, nt), dtype=np.complex128)
        out[:, 0] = h
        for j in range(1, nt):
            for _ in range(substeps):
                h = np.fft.ifft(half_lin * np.fft.fft(h))
                h = h * np.exp(1j * np.abs(h) ** 2 * dt)
                h = np.fft.ifft(half_lin * np.fft.fft(h))
            out[:, j] = h
        return x, t, out

    return _memoise(f"schrodinger_{nx}x{nt}_{t_final:g}_{substeps}", build)


# --------------------------------------------------------------------------- #
# Closed-form references for the PDE zoo (no memoisation: evaluation is
# vectorised NumPy over the requested grid, milliseconds even in 3D+t)
# --------------------------------------------------------------------------- #
def taylor_green_solution(nx: int = 32, ny: int = 32, nt: int = 11,
                          nu: float = 0.1, t_final: float = 1.0):
    """Decaying Taylor–Green vortex on ``[0, pi]^2`` — the classical exact
    solution of the unsteady incompressible Navier–Stokes equations::

        u(x,y,t) = -cos(x) sin(y) e^{-2 nu t}
        v(x,y,t) =  sin(x) cos(y) e^{-2 nu t}
        p(x,y,t) = -(cos(2x) + cos(2y))/4 e^{-4 nu t}

    Returns ``(x, y, t, uvp)`` with ``uvp`` of shape ``(nx, ny, nt, 3)``
    (components stacked last: u, v, p).
    """
    x = np.linspace(0.0, np.pi, nx)
    y = np.linspace(0.0, np.pi, ny)
    t = np.linspace(0.0, t_final, nt)
    X, Y, T = np.meshgrid(x, y, t, indexing="ij")
    decay = np.exp(-2.0 * nu * T)
    u = -np.cos(X) * np.sin(Y) * decay
    v = np.sin(X) * np.cos(Y) * decay
    p = -0.25 * (np.cos(2.0 * X) + np.cos(2.0 * Y)) * decay ** 2
    return x, y, t, np.stack([u, v, p], axis=-1)


def reaction_diffusion_solution(nx: int = 64, nt: int = 33, d: float = 0.1,
                                a: float = np.pi, t_final: float = 1.0):
    """Rotation-coupled linear reaction–diffusion system on ``[0, pi]``::

        u_t = d u_xx + a v        u(x,0) = sin(x)
        v_t = d v_xx - a u        v(x,0) = 0

    with homogeneous Dirichlet BCs.  For equal diffusivities the matrix
    exponential of the single ``k=1`` Fourier mode is exact::

        u = e^{-d t} cos(a t) sin(x),   v = -e^{-d t} sin(a t) sin(x)

    Returns ``(x, t, uv)`` with ``uv`` of shape ``(nx, nt, 2)``.
    """
    x = np.linspace(0.0, np.pi, nx)
    t = np.linspace(0.0, t_final, nt)
    X, T = np.meshgrid(x, t, indexing="ij")
    decay = np.exp(-d * T)
    u = decay * np.cos(a * T) * np.sin(X)
    v = -decay * np.sin(a * T) * np.sin(X)
    return x, t, np.stack([u, v], axis=-1)


def heat3d_solution(n: int = 12, nt: int = 9, kappa: float = 0.05,
                    t_final: float = 1.0):
    """Separable 3D heat-equation mode ``u_t = kappa lap(u)`` on the unit
    cube with homogeneous Dirichlet BCs::

        u = sin(pi x) sin(pi y) sin(pi z) e^{-3 pi^2 kappa t}

    Returns ``(x, y, z, t, u)`` with ``u`` of shape ``(n, n, n, nt)``.
    """
    x = y = z = np.linspace(0.0, 1.0, n)
    t = np.linspace(0.0, t_final, nt)
    X, Y, Z, T = np.meshgrid(x, y, z, t, indexing="ij")
    u = (np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
         * np.exp(-3.0 * np.pi ** 2 * kappa * T))
    return x, y, z, t, u


def convection_solution(nx: int = 128, nt: int = 65, beta: float = 10.0,
                        t_final: float = 1.0):
    """Pure advection ``u_t + beta u_x = 0`` of ``u(x,0) = sin(x)``,
    periodic on ``[0, 2 pi)`` — the convection-dominated benchmark where
    vanilla PINNs famously stall as ``beta`` grows (arXiv:2109.01050)::

        u(x, t) = sin(x - beta t)

    Returns ``(x, t, u)`` with ``u`` of shape ``(nx, nt)``.
    """
    x = 2.0 * np.pi * np.arange(nx) / nx
    t = np.linspace(0.0, t_final, nt)
    X, T = np.meshgrid(x, t, indexing="ij")
    return x, t, np.sin(X - beta * T)
