"""Weight carry between the JAX package's flax parameter trees and the port.

A flax :class:`~tensordiffeq_tpu.networks.MLP` keeps its parameters as
``{"params": {"Dense_i": {"kernel": [in, out], "bias": [out]}}}``; the port's
:class:`~tensordiffeq_tpu_torch.networks.MLP` keeps the same ``[in, out]``
kernels, so the conversion is one copy per array.  The trees cross as plain
NumPy arrays: neither side imports the other.  The embedding families keep
the same ``Dense_i`` tree for their dense stack; a ``FourierMLP`` also
needs its frequency matrix ``B``, which the JAX package draws from its own
random stream at every call, so ``B`` crosses too, computed on the JAX
side (:func:`fourier_net_from_jax`).  The knobs' MLPs (another activation,
precision or dtype) keep the same tree.  A custom Flax module's tree
crosses into a torch module through an explicit ``{flax path: torch
name}`` map (:func:`params_from_jax` with ``module=`` and ``name_map=``).
"""

from __future__ import annotations

import numpy as np
import torch

from .networks import FourierMLP
from .utils import resolve_device


def _flax_leaves(tree, prefix="") -> dict:
    """``{"A/B/leaf": array}`` for a nest of dicts of arrays."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flax_leaves(v, path + "/"))
        else:
            out[path] = v
    return out


def params_from_jax(tree, device="cuda", module=None,
                    name_map=None) -> list:
    """``[(W, b), ...]`` float32 tensors on ``device`` from a flax MLP tree
    whose leaves are NumPy arrays (``jax.tree_util.tree_map(np.asarray,
    params)`` on the JAX side).

    With ``module=`` (a torch ``nn.Module``, or its
    :class:`~.networks.ModuleNet`) and ``name_map={flax path: torch name}``
    (paths under ``"params"``, ``"/"``-joined, e.g. ``"Dense_0/kernel"``;
    a torch name ending in ``".T"`` takes the array transposed, as an
    ``nn.Linear`` weight needs), a custom Flax module's tree instead: the
    flat list of tensors in the module's ``named_parameters()`` order, what
    :meth:`~.networks.ModuleNet.load_params` takes.  Every parameter of the
    module must be named by the map, with the array's shape."""
    dev = resolve_device(device)
    if module is not None or name_map is not None:
        if module is None or name_map is None:
            raise ValueError("a custom module's tree needs both module= "
                             "and name_map=")
        inner = getattr(module, "module", module)
        leaves = _flax_leaves(tree.get("params", tree))
        by_name = {}
        for path, name in name_map.items():
            if path not in leaves:
                raise ValueError(f"flax path {path!r} is not in the tree "
                                 f"(it has {sorted(leaves)})")
            arr = np.array(leaves[path], np.float32)
            if name.endswith(".T"):
                name, arr = name[:-2], arr.T
            by_name[name] = arr
        out = []
        for name, p in inner.named_parameters():
            if name not in by_name:
                raise ValueError(f"name_map names no flax array for the "
                                 f"module's parameter {name!r}")
            if tuple(by_name[name].shape) != tuple(p.shape):
                raise ValueError(
                    f"parameter {name!r} has shape {tuple(p.shape)}, the "
                    f"mapped array {tuple(by_name[name].shape)}")
            out.append(torch.from_numpy(
                np.ascontiguousarray(by_name[name])).to(dev))
        return out
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
