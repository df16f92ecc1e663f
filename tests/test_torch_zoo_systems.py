"""The port's PDE zoo, its multi-component systems (``reaction-diffusion``,
``schrodinger``, ``taylor-green``, ``burgers2d``) built on both packages at a
reduced size and held to the JAX entries as ``test_torch_zoo.py`` holds the
scalar ones: points, BC data and λ init bit for bit, the plain minimax
flavor with E = ``n_components`` equations, and the step-0 loss components
from the JAX parameters within 1e-5 scale-relative."""

import pytest
import torch

from tensordiffeq_tpu_torch import zoo
from test_torch_zoo import check_entry_against_jax

torch.set_num_threads(1)
SYSTEMS = [e.id for e in zoo.entries() if e.system]


def test_the_zoo_declares_four_systems():
    assert sorted(SYSTEMS) == ["burgers2d", "reaction-diffusion",
                               "schrodinger", "taylor-green"]


@pytest.mark.parametrize("entry_id", SYSTEMS)
def test_system_entry_builds_like_the_jax_entry(entry_id):
    check_entry_against_jax(entry_id)
