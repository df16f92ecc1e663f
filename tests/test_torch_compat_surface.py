"""MIGRATION.md's "same path" table in the port, as a regression test: the
counterpart of ``tests/test_api_surface.py``.

* every symbol of the table (``tests/test_api_surface.py::SAME_PATH``, read
  from there so the two stay one table) resolves at the same dotted path
  under ``tensordiffeq_tpu_torch``, and each re-export is the port's own
  object (``utils.MSE`` is ``ops.losses.MSE``, ...);
* the reference helpers compute what the JAX package's compute on the same
  inputs: ``constant``/``tensor``/``convertTensor`` (float32, values
  equal), ``get_weights`` (the flat vector, bit for bit on the same
  parameters), ``set_weights`` (its inverse, and into a network),
  ``get_sizes``; ``utils.resolve_precision`` takes ``None`` and the JAX
  ``Precision`` names;
* ``plotting`` writes its figures under ``tmp_path`` with the Agg backend
  from a solver trained on the CPU, a ``DiscoveryModel`` with SA weights,
  and NumPy inputs; ``output.print_screen`` prints the banner and the
  parameter count; ``training.progress.progress_bar`` counts.
"""

import importlib

import matplotlib
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu_torch import utils
from test_api_surface import SAME_PATH
from test_torch_checkpoint import make_solver
from test_torch_discovery import heat_data, make_f

matplotlib.use("Agg")
torch.set_num_threads(1)


@pytest.mark.parametrize("module", sorted(SAME_PATH))
def test_same_path_symbols_resolve_in_the_port(module):
    mod = getattr(tdqt, module)
    missing = [f"tdqt.{module}.{name}" for name in SAME_PATH[module]
               if not hasattr(mod, name)]
    assert not missing, f"MIGRATION 'same path' missing in the port: {missing}"


def test_reexports_are_the_ports_own():
    assert utils.MSE is tdqt.ops.losses.MSE
    assert utils.g_MSE is tdqt.ops.losses.g_MSE
    assert utils.multimesh is tdqt.ops.meshes.multimesh
    assert utils.flatten_and_stack is tdqt.ops.meshes.flatten_and_stack
    assert utils.LatinHypercubeSample is tdqt.sampling.LatinHypercubeSample
    assert tdqt.helpers.find_L2_error is tdqt.find_L2_error
    # the modules of the table are the port's, not the JAX package's
    for module in SAME_PATH:
        assert getattr(tdqt, module).__name__.startswith(
            "tensordiffeq_tpu_torch.")


@pytest.mark.parametrize("name", ["constant", "tensor", "convertTensor"])
def test_tensor_helpers_match_jax(name):
    val = [[1.5, -2.0], [0.25, 3.0]]
    got = getattr(utils, name)(val, device="cpu")
    want = np.asarray(getattr(tdq.utils, name)(val))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if not torch.cuda.is_available():
        with pytest.raises(utils.CudaUnavailableError):
            getattr(utils, name)(val)


def test_weights_helpers_match_jax():
    jnet = tdq.neural_net([2, 8, 8, 1])
    params = tdq.networks.init_params(jnet, 2, __import__("jax").random
                                      .PRNGKey(0))
    tnet = tdqt.neural_net([2, 8, 8, 1], device="cpu")
    tnet.load_layers(tdqt.params_from_jax(
        __import__("jax").tree_util.tree_map(np.asarray, params),
        device="cpu"))
    # the flat vector over the parameter list, W_0, b_0, W_1, ... (the
    # reference's order; JAX's ravel of the flax dict sorts bias before
    # kernel): JAX's get_weights over the same list, and the same values
    # as its ravel of the tree
    want = np.asarray(tdq.utils.get_weights(
        [np.asarray(t.detach()) for t in tnet.params()]))
    np.testing.assert_array_equal(
        np.sort(want), np.sort(np.asarray(tdq.utils.get_weights(params))))
    for source in (tnet, tnet.params(), tnet.layers()):
        np.testing.assert_array_equal(utils.get_weights(source).numpy(),
                                      want)
    flat = torch.arange(want.size, dtype=torch.float32)
    back = utils.set_weights(tnet.layers(), flat)
    assert [tuple(t.shape) for pair in back for t in pair] == \
        [tuple(t.shape) for t in tnet.params()]
    np.testing.assert_array_equal(utils.get_weights(back).numpy(),
                                  flat.numpy())
    jback = tdq.utils.set_weights(params, np.asarray(flat))
    np.testing.assert_array_equal(np.asarray(tdq.utils.get_weights(jback)),
                                  flat.numpy())
    utils.set_weights(tnet, flat)  # a network: copied into its parameters
    np.testing.assert_array_equal(utils.get_weights(tnet).numpy(),
                                  flat.numpy())
    with pytest.raises(ValueError):
        utils.set_weights(tnet.params(), flat[:-1])
    assert utils.get_sizes([2, 8, 8, 1]) == tdq.utils.get_sizes([2, 8, 8, 1])


@pytest.mark.parametrize("given,want", [
    (None, "default"), ("DEFAULT", "default"), ("Precision.HIGH", "high"),
    ("highest", "highest"), ("float32", "highest"),
    ("tensorfloat32", "high"), ("bfloat16", "default")])
def test_resolve_precision(given, want):
    assert utils.resolve_precision(given) == want


def test_resolve_precision_takes_a_jax_precision_and_refuses_the_rest():
    import jax
    for p in jax.lax.Precision:
        assert utils.resolve_precision(p) == p.name.lower()
    with pytest.raises(ValueError, match="precision"):
        utils.resolve_precision("fp8")


def test_plotting_writes_figures(tmp_path):
    plotting = importlib.import_module("tensordiffeq_tpu_torch.plotting")
    s = make_solver()
    s.fit(tf_iter=3, chunk=3)
    x = np.linspace(-1, 1, 16)
    t = np.linspace(0, 1, 8)
    exact = np.sin(np.pi * x)[:, None] * np.exp(-t)[None, :]
    files = {"solution.png": lambda p: plotting.plot_solution_domain1D(
                 s, [x, t], ub=[1.0], lb=[-1.0], Exact_u=exact,
                 save_path=p),
             "best.png": lambda p: plotting.plot_solution_domain1D(
                 s, [x, t], ub=[1.0], lb=[-1.0], save_path=p,
                 best_model=True),
             "weights.png": lambda p: plotting.plot_weights(s, save_path=p),
             "glam.png": lambda p: plotting.plot_glam_values(s, save_path=p)}
    X, T = np.meshgrid(x, t)
    X_star = np.hstack([X.reshape(-1, 1), T.reshape(-1, 1)])
    _, f = s.predict(X_star)
    files["residual.png"] = lambda p: plotting.plot_residuals(
        X_star, f, (X, T), save_path=p)
    xd, td, ud = heat_data(64)
    m = tdqt.DiscoveryModel(device="cpu")
    m.compile([2, 8, 1], make_f(tdqt), [xd, td], ud, var=[0.1, 0.5],
              col_weights=np.random.RandomState(0).rand(64, 1),
              varnames=["x", "t"], verbose=False)
    files["disc_weights.png"] = lambda p: plotting.plot_weights(
        m, save_path=p)
    for name, draw in files.items():
        draw(str(tmp_path / name))
        assert (tmp_path / name).stat().st_size > 1000, name
    assert plotting.figsize(1.0) == tdq.plotting.figsize(1.0)
    grid = plotting.get_griddata(X_star, f.reshape(-1), (X, T))
    assert grid.shape == X.shape


def test_print_screen_and_progress_bar(capsys):
    s = make_solver()
    tdqt.output.print_screen(s)
    out = capsys.readouterr().out
    n = sum(p.numel() for p in s.net.params())
    assert "CollocationSolverND" in out and f"{n:,} parameters" in out
    assert "Backend: cpu" in out
    from tensordiffeq_tpu_torch.training.progress import progress_bar
    bar = progress_bar(5, desc="Adam")
    bar.update(2)
    bar.set_postfix(loss=1.0)
    bar.update(3)
    assert bar.n == 5
    bar.close()
