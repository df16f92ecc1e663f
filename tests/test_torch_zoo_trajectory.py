"""The zoo's fixed arm raced in both packages from the same start.

``reaction-diffusion`` and ``taylor-green`` at size ``micro`` (their
declared ``n_f``, widths and grid) are built on both packages, the JAX
solver's initial parameters are carried into the port's
(``weights.params_from_jax``), so both start from the same ``X_f``, the
same λ and the same weights, and each runs its first 300 Adam steps of the
fixed arm (no redraw) on the CPU.  The loss histories must agree step by
step within the f32 cross-check band (rtol 5e-3,
``ops/fused.py::crosscheck_residuals``) over all 300 steps: the port
assembles the same loss, updates λ and the parameters with the same Adam
(ε, bias correction, β) at the same constant rates, in another summation
order.  The JAX solver runs its generic engine (the fused engines'
referee, within about 1e-4 of them); the port its adopted minimax step,
as the race does.  Measured on the CPU: the histories stay within 4e-5
relative of each other for all 300 steps of both entries, against either
JAX engine.

So a port that ends a micro race above the JAX baseline's metric from its
own seed (ROADMAP queue 3) starts from other initial weights; it does not
train otherwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tensordiffeq_tpu import CollocationSolverND as JaxSolver
from tensordiffeq_tpu import zoo as jzoo
from tensordiffeq_tpu_torch import zoo
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
STEPS = 300
RTOL = 5e-3


@pytest.mark.parametrize("entry_id", ["reaction-diffusion", "taylor-green"])
def test_fixed_arm_tracks_the_jax_trajectory(entry_id):
    spec = zoo.get(entry_id).spec("micro")
    jentry, tentry = jzoo.get(entry_id), zoo.get(entry_id)
    jp, tp = jentry.build(spec), tentry.build(spec)
    np.testing.assert_array_equal(np.asarray(tp.domain.X_f),
                                  np.asarray(jp.domain.X_f))
    # the JAX side on its generic engine: its fused engines' compile-time
    # cross-checks cost about 15 s of XLA compiles on this CPU, and the
    # generic engine is the reference's own referee for them (they agree
    # within about 1e-4, ops/fused.py:22-26)
    js = JaxSolver(verbose=False, seed=0)
    js.compile(list(jp.layer_sizes), jp.f_model, jp.domain, list(jp.bcs),
               fused=False, **jp.compile_kw)
    ts = zoo.build_solver(dataclasses.replace(tentry, build=lambda s: tp),
                          spec=spec, device="cpu", verbose=False)
    ts.net.load_layers(params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu"))
    js.fit(tf_iter=STEPS, chunk=100)
    ts.fit(tf_iter=STEPS, chunk=100)
    want = np.array([float(r["Total Loss"]) for r in js.losses])
    got = np.array([r["Total Loss"] for r in ts.losses])
    assert got.shape == want.shape == (STEPS,)
    rel = np.abs(got - want) / np.abs(want)
    assert np.all(rel <= RTOL), (int(np.argmax(rel)), float(rel.max()))
    # the loss falls in both: the race trains
    assert got[-1] < 0.2 * got[0] and want[-1] < 0.2 * want[0]
