"""Neural networks for PINN solvers.

Counterpart of the JAX package's ``networks.py`` (``MLP``, ``neural_net``,
``FourierMLP``, ``PeriodicMLP``, ``fourier_net``, ``periodic_net``,
``net_metadata``/``net_from_metadata``): a fully-connected tanh MLP with
glorot-normal kernels and a linear head (reference
``tensordiffeq/networks.py:10-20``), the two embedding families that
transform the coordinates ahead of the same dense stack, and the
architecture record that the solver's ``save`` and the serving artifact
share.

Every network applies its ``[(W, b), ...]`` dense layers through
:meth:`MLP.apply` (``apply(layers, x)``): the solver, the residual engines
and the serving engine call that, so an embedding family runs wherever the
MLP does.  Only the plain :class:`MLP` qualifies for the fused engines
(``ops/fused.py::mlp_qualifies`` gates on ``type(net) is MLP``, as in the
JAX package); the families train on the generic engine.

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

from .utils import resolve_device

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
        # the first dense layer reads the embedding's width
        widths = (self.embed_width(),) + self.layer_sizes[1:]
        for fan_in, fan_out in zip(widths[:-1], widths[1:]):
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

    def embed_width(self) -> int:
        """Width of :meth:`embed`'s output: the first dense layer's
        fan-in."""
        return self.layer_sizes[0]

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The coordinates' transform ahead of the dense stack (the JAX
        package's ``_embed``); the identity for the MLP."""
        return x

    def apply(self, layers, x: torch.Tensor) -> torch.Tensor:
        """The network at ``x [..., n_in]`` with the dense layers
        ``layers`` (the live ones, or any others of the same shapes)."""
        return mlp_forward(layers, self.embed(x))

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
        return self.apply(self.layers(), x)


def neural_net(layer_sizes: Sequence[int], device="cuda",
               seed: Optional[int] = None) -> MLP:
    """Build the standard PINN MLP (parity: reference ``networks.py:10``);
    ``seed`` makes the init reproducible."""
    return MLP(layer_sizes, device=device, generator=init_generator(seed))


class FourierMLP(MLP):
    """Random-Fourier-feature MLP (the JAX package's ``FourierMLP``; Tancik
    et al. 2020): the coordinates enter as ``[cos(2π·xB), sin(2π·xB)]``
    with a fixed Gaussian frequency matrix ``B [n_in, n_frequencies]`` ahead
    of the tanh stack.  ``layer_sizes`` keeps the solver's ``[n_coords,
    h…, n_out]``.

    ``B`` is a registered buffer: given, or drawn as ``sigma · N(0, 1)`` from
    a ``torch.Generator`` seeded with ``feature_seed``.  The JAX package
    draws it from ``jax.random.normal(PRNGKey(feature_seed))``, a stream
    PyTorch cannot reproduce, so the same seed gives another ``B`` here;
    the port's checkpoints, saved models and surrogate artifacts carry
    ``B`` itself, and :func:`~.weights.fourier_net_from_jax` carries a JAX
    net's."""

    def __init__(self, layer_sizes: Sequence[int], n_frequencies: int = 64,
                 sigma: float = 1.0, feature_seed: int = 0,
                 B: Optional[torch.Tensor] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.n_frequencies = int(n_frequencies)
        self.sigma = float(sigma)
        self.feature_seed = int(feature_seed)
        super().__init__(layer_sizes, device=device, generator=generator)
        n_in = self.layer_sizes[0]
        if B is None:
            g = torch.Generator()
            g.manual_seed(self.feature_seed)
            B = self.sigma * torch.randn(n_in, self.n_frequencies,
                                         generator=g)
        B = torch.as_tensor(B, dtype=torch.float32)
        if tuple(B.shape) != (n_in, self.n_frequencies):
            raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                             f"{(n_in, self.n_frequencies)}")
        self.register_buffer("B", B.to(self.weights[0].device).clone())

    def embed_width(self) -> int:
        return 2 * self.n_frequencies

    def embed(self, x):
        z = (2.0 * math.pi) * (x @ self.B)
        return torch.cat([torch.cos(z), torch.sin(z)], dim=-1)


class PeriodicMLP(MLP):
    """MLP with an exactly periodic input embedding (the JAX package's
    ``PeriodicMLP``): each coordinate named in ``periodic`` (``(dim_index,
    lower_bound, period)`` triples, indices in the domain's declaration
    order) is replaced by ``n_harmonics`` harmonics ``cos(kθ), sin(kθ)``,
    ``θ = 2π(x − lb)/P``; the other coordinates pass through.  The network
    is then periodic in those coordinates to every derivative order."""

    def __init__(self, layer_sizes: Sequence[int], periodic=(),
                 n_harmonics: int = 4, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.periodic = tuple((int(d), float(lb), float(p))
                              for d, lb, p in periodic)
        self.n_harmonics = int(n_harmonics)
        super().__init__(layer_sizes, device=device, generator=generator)
        self.register_buffer("ks", torch.arange(
            1, self.n_harmonics + 1, dtype=torch.float32,
            device=self.weights[0].device))

    def embed_width(self) -> int:
        n_per = len({d for d, _, _ in self.periodic})
        return self.layer_sizes[0] + n_per * (2 * self.n_harmonics - 1)

    def embed(self, x):
        spec = {d: (lb, p) for d, lb, p in self.periodic}
        feats = []
        for j in range(self.layer_sizes[0]):
            xj = x[..., j:j + 1]
            if j in spec:
                lb, period = spec[j]
                theta = (2.0 * math.pi / period) * (xj - lb)
                feats += [torch.cos(theta * self.ks),
                          torch.sin(theta * self.ks)]
            else:
                feats.append(xj)
        return torch.cat(feats, dim=-1)


def fourier_net(layer_sizes: Sequence[int], n_frequencies: int = 64,
                sigma: float = 1.0, seed: int = 0, device="cuda",
                **kw) -> FourierMLP:
    """A random-Fourier-feature MLP (:class:`FourierMLP`); ``seed`` seeds
    ``B``."""
    return FourierMLP(layer_sizes, n_frequencies=n_frequencies, sigma=sigma,
                      feature_seed=seed, device=device, **kw)


def periodic_net(layer_sizes: Sequence[int], domain, periodic_vars,
                 n_harmonics: int = 4, device="cuda", **kw) -> PeriodicMLP:
    """An exactly periodic MLP (:class:`PeriodicMLP`) from a
    :class:`~.domains.DomainND`: ``periodic_vars`` names the variables to
    embed; their bounds and periods are read off the domain, and their
    indices follow the domain's declaration order (the column order of
    ``X_f`` and ``predict``), not the order of ``add()``."""
    spec = []
    for var in periodic_vars:
        if var not in domain.vars:
            raise ValueError(
                f"periodic var {var!r} not in domain vars {domain.vars}")
        if var not in domain.domain_ids:
            raise ValueError(
                f"periodic var {var!r} declared but never add()ed to the "
                "domain; call domain.add(...) before periodic_net")
        lo, hi = domain.bounds(var)
        spec.append((domain.var_index(var), lo, hi - lo))
    return PeriodicMLP(layer_sizes, periodic=tuple(spec),
                       n_harmonics=n_harmonics, device=device, **kw)


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
# process with no solver around.  The names are the JAX package's.
REBUILDABLE_NETS = ("MLP", "FourierMLP", "PeriodicMLP")


def net_metadata(net: nn.Module, layer_sizes: Sequence[int],
                 n_out: int) -> dict:
    """JSON-serialisable architecture record for ``net`` (the JAX
    package's keys; the port's networks are always tanh).  The embedding
    families add ``net_config``: loading weights into another embedding
    would be another function."""
    act = "tanh" if isinstance(net, MLP) else getattr(
        getattr(net, "activation", None), "__name__", "None")
    meta = {"format": 1,
            "layer_sizes": list(layer_sizes),
            "activation": act,
            "network_type": type(net).__name__,
            "n_out": int(n_out)}
    if type(net) is FourierMLP:
        meta["net_config"] = {"n_frequencies": net.n_frequencies,
                              "sigma": net.sigma,
                              "feature_seed": net.feature_seed}
    elif type(net) is PeriodicMLP:
        meta["net_config"] = {"periodic": [list(s) for s in net.periodic],
                              "n_harmonics": net.n_harmonics}
    return meta


def net_buffers(net: nn.Module) -> dict:
    """The arrays a network's function depends on beyond its dense layers
    (a :class:`FourierMLP`'s ``B``), for checkpoints and artifacts."""
    return {"B": net.B} if type(net) is FourierMLP else {}


def net_from_metadata(meta: dict, device="cuda") -> MLP:
    """Rebuild a network from a :func:`net_metadata` record, on ``device``.

    Only the standard tanh families can be rebuilt without user code
    (:data:`REBUILDABLE_NETS`); a custom module must be rebuilt by the
    caller and handed in directly.  A :class:`FourierMLP` comes back with
    the ``B`` its seed draws here; the caller restores the saved ``B``
    (:func:`net_buffers`) over it."""
    ntype = meta.get("network_type")
    if ntype not in REBUILDABLE_NETS \
            or "tanh" not in str(meta.get("activation", "")):
        raise ValueError(
            f"only tanh networks of type {REBUILDABLE_NETS} can be "
            f"reconstructed from metadata (file has {ntype}/"
            f"{meta.get('activation')}); build the custom network "
            "yourself and pass it in explicitly")
    layer_sizes = tuple(meta["layer_sizes"])
    if ntype == "FourierMLP":
        return FourierMLP(layer_sizes, device=device, **meta["net_config"])
    if ntype == "PeriodicMLP":
        cfg = meta["net_config"]
        return PeriodicMLP(layer_sizes,
                           periodic=tuple(tuple(s) for s in cfg["periodic"]),
                           n_harmonics=cfg["n_harmonics"], device=device)
    return neural_net(layer_sizes, device=device)
