"""The port's reference solutions (``tensordiffeq_tpu_torch/exact.py``) held
to the JAX package's ``exact.py``.

Both are NumPy and the code is the same, so every array must be equal bit
for bit: the split-step Fourier NLS solution, the Taylor-Green vortex, the
reaction-diffusion system, the 3D heat mode and the periodic advection, each
at its default grid and at one smaller grid (and other parameters), plus
the two references the port already had at a small grid.
"""

import numpy as np
import pytest

from tensordiffeq_tpu import exact as jexact
from tensordiffeq_tpu_torch import exact as texact

CASES = {
    "schrodinger_solution": [{}, dict(nx=64, nt=11, t_final=0.5,
                                      substeps=4)],
    "taylor_green_solution": [{}, dict(nx=24, ny=24, nt=9, nu=0.1)],
    "reaction_diffusion_solution": [{}, dict(nx=48, nt=17, d=0.1,
                                             a=float(np.pi))],
    "heat3d_solution": [{}, dict(n=10, nt=5, kappa=0.05)],
    "convection_solution": [{}, dict(nx=64, nt=21, beta=30.0)],
    "burgers_solution": [dict(nx=32, nt=9, n_quad=40)],
    "allen_cahn_solution": [dict(nx=32, nt=11)],
}


@pytest.mark.parametrize("name,kw", [(n, kw) for n, kws in CASES.items()
                                     for kw in kws],
                         ids=lambda v: v if isinstance(v, str) else
                         ("default" if not v else "small"))
def test_reference_equals_the_jax_packages(name, kw):
    want = getattr(jexact, name)(**kw)
    got = getattr(texact, name)(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_closed_forms_solve_their_equations():
    """The closed forms are the solutions they name: the advection profile
    moves at speed beta, the NLS modulus starts at 2 sech x, and the
    Taylor-Green velocity is divergence free at t = 0 (central
    differences on the grid)."""
    x, t, u = texact.convection_solution(nx=128, nt=11, beta=30.0)
    np.testing.assert_allclose(u[:, 0], np.sin(x), atol=1e-15)
    x, _, h = texact.schrodinger_solution(nx=64, nt=3, t_final=0.1,
                                          substeps=2)
    np.testing.assert_allclose(np.abs(h[:, 0]), 2.0 / np.cosh(x), rtol=1e-12)
    x, y, _, uvp = texact.taylor_green_solution(nx=65, ny=65, nt=2)
    dx = x[1] - x[0]
    div = (uvp[2:, 1:-1, 0, 0] - uvp[:-2, 1:-1, 0, 0]) / (2 * dx) \
        + (uvp[1:-1, 2:, 0, 1] - uvp[1:-1, :-2, 0, 1]) / (2 * dx)
    assert np.abs(div).max() < 1e-3
