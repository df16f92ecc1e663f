"""Neural networks for PINN solvers.

Counterpart of the JAX package's ``networks.py`` (``MLP``, ``neural_net``,
``init_params``, ``net_metadata``/``net_from_metadata``): a fully-connected
tanh MLP with glorot-normal kernels and a linear head (reference
``tensordiffeq/networks.py:10-20``), and the architecture record that the
solver's ``save`` and the serving artifact share.

Weights are stored as ``[in, out]`` matrices — the flax ``Dense`` layout —
so a JAX parameter tree converts layer for layer
(:mod:`tensordiffeq_tpu_torch.weights`), and a layer computes
``x @ W + b``.  Float32 only: derivatives through tanh are
precision-sensitive, and the JAX package's default is
``precision=HIGHEST`` (full float32 matmuls), which is what PyTorch's
float32 matmul does with TF32 off.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .utils import not_ported, resolve_device

# flax's glorot_normal is a variance-scaling truncated normal on [-2σ, 2σ];
# σ is divided by the std of a unit normal truncated there so the variance
# comes out at 1/fan_avg (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def mlp_forward(layers, x: torch.Tensor) -> torch.Tensor:
    """Apply ``[(W [in, out], b [out]), ...]`` as a tanh MLP with a linear
    head; ``x`` is ``[..., in]``."""
    *hidden, (W_out, b_out) = layers
    for W, b in hidden:
        x = torch.tanh(x @ W + b)
    return x @ W_out + b_out


class MLP(nn.Module):
    """``layer_sizes = [n_in, h1, ..., hk, n_out]`` tanh MLP.

    ``weights[i]`` is layer ``i``'s ``[in, out]`` kernel, ``biases[i]`` its
    bias; :meth:`layers` returns them as the ``[(W, b), ...]`` list the
    Taylor propagation and the kernels consume."""

    def __init__(self, layer_sizes: Sequence[int], device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        if len(self.layer_sizes) < 2:
            raise ValueError("layer_sizes needs at least [n_in, n_out]")
        dev = resolve_device(device)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fan_in, fan_out in zip(self.layer_sizes[:-1], self.layer_sizes[1:]):
            self.weights.append(nn.Parameter(
                torch.empty(fan_in, fan_out, device=dev)))
            self.biases.append(nn.Parameter(torch.zeros(fan_out, device=dev)))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-normal kernels (flax's truncated-normal flavor), zero
        biases.  ``generator`` must live on the CPU; the draw is made there
        and copied, so a seed gives the same weights on every device."""
        for W in self.weights:
            fan_in, fan_out = W.shape
            std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
            w = torch.empty(fan_in, fan_out)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            W.copy_(w)
        for b in self.biases:
            b.zero_()

    def layers(self) -> list:
        """``[(W, b), ...]`` — the live parameters, not copies."""
        return list(zip(self.weights, self.biases))

    @torch.no_grad()
    def load_layers(self, layers) -> "MLP":
        """Copy ``[(W, b), ...]`` values (any device) into the parameters."""
        if len(layers) != len(self.weights):
            raise ValueError(f"expected {len(self.weights)} layers, got "
                             f"{len(layers)}")
        for (W, b), (W_new, b_new) in zip(self.layers(), layers):
            if tuple(W_new.shape) != tuple(W.shape) \
                    or tuple(b_new.shape) != tuple(b.shape):
                raise ValueError(
                    f"layer shape {tuple(W_new.shape)}/{tuple(b_new.shape)} "
                    f"does not match {tuple(W.shape)}/{tuple(b.shape)}")
            W.copy_(W_new)
            b.copy_(b_new)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self.layers(), x)


def neural_net(layer_sizes: Sequence[int], device="cuda",
               seed: Optional[int] = None) -> MLP:
    """Build the standard PINN MLP (parity: reference ``networks.py:10``);
    ``seed`` makes the init reproducible."""
    return MLP(layer_sizes, device=device, generator=init_generator(seed))


def init_generator(seed: Optional[int]) -> Optional[torch.Generator]:
    """A CPU ``torch.Generator`` seeded with ``seed`` (``None`` -> None:
    PyTorch's global generator)."""
    if seed is None:
        return None
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


# The architecture record shared by the solver's self-describing save
# (models/collocation.py::save) and the serving artifact
# (serving/surrogate.py): a net persisted by either is rebuilt in a fresh
# process with no solver around.  The names are the JAX package's; only the
# MLP is ported (FourierMLP and PeriodicMLP: ROADMAP queue 1 item 5).
REBUILDABLE_NETS = ("MLP", "FourierMLP", "PeriodicMLP")


def net_metadata(net: nn.Module, layer_sizes: Sequence[int],
                 n_out: int) -> dict:
    """JSON-serialisable architecture record for ``net`` (the JAX
    package's keys; the port's MLP is always tanh)."""
    act = "tanh" if type(net) is MLP else getattr(
        getattr(net, "activation", None), "__name__", "None")
    return {"format": 1,
            "layer_sizes": list(layer_sizes),
            "activation": act,
            "network_type": type(net).__name__,
            "n_out": int(n_out)}


def net_from_metadata(meta: dict, device="cuda") -> MLP:
    """Rebuild a network from a :func:`net_metadata` record, on ``device``.

    Only the standard tanh families can be rebuilt without user code
    (:data:`REBUILDABLE_NETS`), and of them only the MLP is ported; a custom
    module must be rebuilt by the caller and handed in directly."""
    ntype = meta.get("network_type")
    if ntype not in REBUILDABLE_NETS \
            or "tanh" not in str(meta.get("activation", "")):
        raise ValueError(
            f"only tanh networks of type {REBUILDABLE_NETS} can be "
            f"reconstructed from metadata (file has {ntype}/"
            f"{meta.get('activation')}); build the custom network "
            "yourself and pass it in explicitly")
    if ntype != "MLP":
        raise not_ported(f"rebuilding a {ntype}",
                         "queue 1 item 5, FourierMLP/PeriodicMLP")
    return neural_net(tuple(meta["layer_sizes"]), device=device)
