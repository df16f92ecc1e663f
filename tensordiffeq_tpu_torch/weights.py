"""Weight carry between the JAX package's flax parameter trees and the port.

A flax :class:`~tensordiffeq_tpu.networks.MLP` keeps its parameters as
``{"params": {"Dense_i": {"kernel": [in, out], "bias": [out]}}}``; the port's
:class:`~tensordiffeq_tpu_torch.networks.MLP` keeps the same ``[in, out]``
kernels, so the conversion is one copy per array.  The trees cross as plain
NumPy arrays: neither side imports the other.  The embedding families keep
the same ``Dense_i`` tree for their dense stack; a ``FourierMLP`` also
needs its frequency matrix ``B``, which the JAX package draws from its own
random stream at every call, so ``B`` crosses too, computed on the JAX
side (:func:`fourier_net_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .networks import FourierMLP
from .utils import resolve_device


def params_from_jax(tree, device="cuda") -> list:
    """``[(W, b), ...]`` float32 tensors on ``device`` from a flax MLP tree
    whose leaves are NumPy arrays (``jax.tree_util.tree_map(np.asarray,
    params)`` on the JAX side)."""
    dev = resolve_device(device)
    try:
        inner = tree["params"]
        names = [f"Dense_{i}" for i in range(len(inner))]
        pairs = [(inner[n]["kernel"], inner[n]["bias"]) for n in names]
    except (KeyError, TypeError) as e:
        raise ValueError(
            "expected a flax MLP tree {'params': {'Dense_i': {'kernel', "
            "'bias'}}}") from e
    return [(torch.from_numpy(np.array(W, np.float32)).to(dev),
             torch.from_numpy(np.array(b, np.float32)).to(dev))
            for W, b in pairs]


def params_to_numpy(layers) -> dict:
    """The flax-layout tree of NumPy arrays for ``[(W, b), ...]`` (or an
    :class:`~tensordiffeq_tpu_torch.networks.MLP`)."""
    if hasattr(layers, "layers"):
        layers = layers.layers()
    return {"params": {
        f"Dense_{i}": {"kernel": W.detach().cpu().numpy().astype(np.float32),
                       "bias": b.detach().cpu().numpy().astype(np.float32)}
        for i, (W, b) in enumerate(layers)}}


def fourier_net_from_jax(tree, B, layer_sizes, sigma: float = 1.0,
                         feature_seed: int = 0, device="cuda") -> FourierMLP:
    """A :class:`~tensordiffeq_tpu_torch.networks.FourierMLP` that computes
    what a JAX ``FourierMLP`` computes: its dense tree (NumPy leaves) and
    its frequency matrix ``B [n_in, n_frequencies]`` as a NumPy array (on
    the JAX side: ``sigma * jax.random.normal(PRNGKey(feature_seed), (n_in,
    n_frequencies))``)."""
    B = np.array(B, np.float32)
    net = FourierMLP(layer_sizes, n_frequencies=B.shape[1], sigma=sigma,
                     feature_seed=feature_seed, B=torch.from_numpy(B),
                     device=device)
    net.load_layers(params_from_jax(tree, device=device))
    return net
