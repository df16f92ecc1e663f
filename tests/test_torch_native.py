"""The port's native ESE sampler (``tensordiffeq_tpu_torch/native/``: its own
copy of ``ese.cpp`` built with ``g++`` at first use) against the JAX
package's (``tests/test_native.py``).

Both libraries compile the same algorithm with the same generator, so on
the same design and seed the port's optimized design equals the JAX
package's bit for bit, and the PhiP criterion agrees with the NumPy one at
rtol 1e-10.  The ``"ese"`` LHS criterion of both samplers then gives the
same points; with the native library off (``TDQ_NO_NATIVE=1``) both fall
back to their NumPy optimizers and still agree.
"""

import numpy as np
import pytest

from tensordiffeq_tpu import native as jnative
from tensordiffeq_tpu import sampling as jsampling
from tensordiffeq_tpu_torch import native, sampling

pytestmark = pytest.mark.skipif(
    not native.available() or not jnative.available(),
    reason="C++ toolchain unavailable")


def test_builds_into_the_ignored_build_dir():
    lib = native.load()
    assert lib is not None
    assert native._library_path().startswith(native.BUILD_DIR)


@pytest.mark.parametrize("shape", [(50, 3), (40, 2)])
def test_phi_p_matches_jax_and_numpy(shape):
    X = np.random.RandomState(0).rand(*shape)
    assert native.phi_p(X) == pytest.approx(sampling._phi_p(X), rel=1e-10)
    assert native.phi_p(X) == jnative.phi_p(X)


@pytest.mark.parametrize("n,nx,seed", [(60, 2, 7), (48, 3, 3), (30, 4, 0)])
def test_ese_matches_the_jax_native_optimizer(n, nx, seed):
    X = sampling.LHS(xlimits=np.array([[0.0, 1.0]] * nx),
                     random_state=seed)(n)
    X0 = X.copy()
    got = native.ese_optimize(X, seed=seed)
    np.testing.assert_array_equal(got, jnative.ese_optimize(X, seed=seed))
    np.testing.assert_array_equal(X, X0)  # the input is not modified
    assert native.phi_p(got) <= native.phi_p(X) + 1e-12
    for k in range(nx):  # column swaps keep the Latin hypercube
        np.testing.assert_array_equal(np.sort(got[:, k]), np.sort(X[:, k]))


def test_ese_is_deterministic_per_seed():
    X = np.random.RandomState(4).rand(40, 2)
    a, b = native.ese_optimize(X, seed=11), native.ese_optimize(X, seed=11)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, native.ese_optimize(X, seed=12))


def test_lhs_ese_uses_native_and_matches_jax(monkeypatch):
    hits = []
    real = native.ese_optimize

    def spy(X, **kw):
        hits.append(kw)
        return real(X, **kw)

    monkeypatch.setattr(native, "ese_optimize", spy)
    xl = np.array([[-1.0, 1.0], [0.0, 1.0]])
    got = sampling.LHS(xlimits=xl, criterion="ese", random_state=0)(40)
    want = jsampling.LHS(xlimits=xl, criterion="ese", random_state=0)(40)
    assert hits and got.shape == (40, 2)
    np.testing.assert_array_equal(got, want)


def test_numpy_fallback_when_native_is_off(monkeypatch):
    monkeypatch.setenv("TDQ_NO_NATIVE", "1")
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_failed", False)
    assert not native.available() and not jnative.available()
    with pytest.raises(native.NativeUnavailable):
        native.phi_p(np.zeros((3, 2)))
    xl = np.array([[-1.0, 1.0], [0.0, 1.0]])
    got = sampling.LHS(xlimits=xl, criterion="ese", random_state=1)(24)
    want = jsampling.LHS(xlimits=xl, criterion="ese", random_state=1)(24)
    np.testing.assert_array_equal(got, want)
