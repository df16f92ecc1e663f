"""Neural networks for PINN solvers.

Counterpart of the JAX package's ``networks.py`` (``MLP``, ``neural_net``,
``FourierMLP``, ``PeriodicMLP``, ``fourier_net``, ``periodic_net``,
``net_metadata``/``net_from_metadata``): a fully-connected tanh MLP with
glorot-normal kernels and a linear head (reference
``tensordiffeq/networks.py:10-20``), the two embedding families that
transform the coordinates ahead of the same dense stack, and the
architecture record that the solver's ``save`` and the serving artifact
share.

The network protocol.  The solver, its training loops, the checkpoints
and the serving path see a network through these:

* ``params()``: the flat list of its parameter tensors (the live ones);
* ``apply(params, x)``: the network at ``x [..., n_in]`` with those
  parameters (the live ones, or any others of the same shapes);
* ``load_params(params)``: copy values into the parameters;
* ``param_tree(params)``: the structure the solver hands its users and
  writes to disk (``[(W, b), ...]`` for the MLP family, the flat list for
  any other module), and :func:`net_buffers`, the arrays its function
  depends on beyond the parameters.

The MLP family keeps ``layers()`` (``[(W, b), ...]``) for the Taylor
propagation and the kernels; its ``apply`` takes either form.  Any other
``nn.Module`` that maps ``[N, n_in]`` to ``[N, n_out]`` is adapted by
:class:`ModuleNet` through ``torch.func.functional_call`` over its
``named_parameters()`` (registration order; a tied parameter once), with
its buffers carried.  Only the plain float32 tanh :class:`MLP` qualifies for
the fused engines (``ops/fused.py::mlp_qualifies`` gates on ``type(net) is
MLP``, the activation and both dtypes, as in the JAX package); the
families, the other knobs and custom modules train on the generic engine.

The MLP's knobs are the JAX package's: ``activation`` (any callable,
default ``torch.tanh``), ``precision`` (default ``"highest"``;
:func:`~.utils.resolve_precision`: its products run at it on the card, and
``None``/``"default"`` takes the single-pass TF32 flavor of the kernels),
``param_dtype`` (the parameters' storage) and ``dtype`` (flax ``Dense``
semantics: each layer casts its input, kernel and bias to ``dtype`` and
computes there; the network's output comes back as float32 for the loss).
Weights are stored as ``[in, out]`` matrices — the flax ``Dense`` layout —
so a JAX parameter tree converts layer for layer
(:mod:`tensordiffeq_tpu_torch.weights`), and a layer computes ``x @ W +
b``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .utils import matmul_precision, resolve_device, resolve_precision

# flax's glorot_normal is a variance-scaling truncated normal on [-2σ, 2σ];
# σ is divided by the std of a unit normal truncated there so the variance
# comes out at 1/fan_avg (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


# the tanh the fused engines' Taylor propagation differentiates
TANH = (torch.tanh, F.tanh)


def as_layers(params) -> list:
    """``[(W, b), ...]`` from an MLP-family network, its ``[(W, b), ...]``
    or its flat parameter list ``[W_0, b_0, W_1, ...]``."""
    if hasattr(params, "layers") and callable(params.layers):
        return params.layers()
    params = list(params)
    if params and isinstance(params[0], torch.Tensor):
        return list(zip(params[0::2], params[1::2]))
    return [tuple(p) for p in params]


def mlp_forward(layers, x: torch.Tensor, activation: Callable = torch.tanh,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply ``[(W [in, out], b [out]), ...]`` (or the flat list) as an MLP
    with ``activation`` between the layers and a linear head; ``x`` is
    ``[..., in]``.  ``dtype`` other than float32: each layer casts its
    input, W and b to it and computes there (flax ``Dense``), and the
    output comes back as float32."""
    *hidden, (W_out, b_out) = as_layers(layers)
    if dtype is None or dtype == torch.float32:
        for W, b in hidden:
            x = activation(x @ W + b)
        return x @ W_out + b_out
    for W, b in hidden:
        x = activation(x.to(dtype) @ W.to(dtype) + b.to(dtype))
    out = x.to(dtype) @ W_out.to(dtype) + b_out.to(dtype)
    return out.to(torch.float32)


def _dtype(d) -> torch.dtype:
    """A ``dtype=``/``param_dtype=`` argument as a torch dtype: a torch
    dtype or its name (``"bfloat16"``, ``"float32"``)."""
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str) and isinstance(getattr(torch, d, None),
                                         torch.dtype):
        return getattr(torch, d)
    raise ValueError(f"dtype {d!r}: expected a torch dtype or its name")


class MLP(nn.Module):
    """``layer_sizes = [n_in, h1, ..., hk, n_out]`` MLP (tanh by default).

    ``weights[i]`` is layer ``i``'s ``[in, out]`` kernel, ``biases[i]`` its
    bias; :meth:`layers` returns them as the ``[(W, b), ...]`` list the
    Taylor propagation and the kernels consume, :meth:`params` as the flat
    list of the network protocol.  ``activation``, ``precision``,
    ``param_dtype`` and ``dtype`` are the JAX package's knobs (module
    docstring)."""

    def __init__(self, layer_sizes: Sequence[int], device="cuda",
                 generator: Optional[torch.Generator] = None,
                 activation: Callable = torch.tanh, precision="highest",
                 param_dtype=torch.float32, dtype=torch.float32):
        super().__init__()
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        if len(self.layer_sizes) < 2:
            raise ValueError("layer_sizes needs at least [n_in, n_out]")
        if not callable(activation):
            raise ValueError(f"activation {activation!r} is not callable")
        self.activation = activation
        self.precision = resolve_precision(precision)
        self.param_dtype = _dtype(param_dtype)
        self.dtype = _dtype(dtype)
        dev = resolve_device(device)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        # the first dense layer reads the embedding's width
        widths = (self.embed_width(),) + self.layer_sizes[1:]
        for fan_in, fan_out in zip(widths[:-1], widths[1:]):
            self.weights.append(nn.Parameter(torch.empty(
                fan_in, fan_out, device=dev, dtype=self.param_dtype)))
            self.biases.append(nn.Parameter(torch.zeros(
                fan_out, device=dev, dtype=self.param_dtype)))
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

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """The network at ``x [..., n_in]`` with the dense layers
        ``params`` (the flat list or ``[(W, b), ...]``; the live ones, or
        any others of the same shapes), its products at the network's
        precision."""
        with matmul_precision(self.precision):
            return mlp_forward(params, self.embed(x), self.activation,
                               self.dtype)

    def layers(self) -> list:
        """``[(W, b), ...]`` — the live parameters, not copies."""
        return list(zip(self.weights, self.biases))

    def params(self) -> list:
        """The flat parameter list ``[W_0, b_0, W_1, ...]`` (the live
        tensors): the network protocol's."""
        return [t for pair in self.layers() for t in pair]

    def param_tree(self, params) -> list:
        """``[(W, b), ...]`` from the flat list (or the pairs): the
        structure the solver hands out and checkpoints."""
        return as_layers(params)

    def load_params(self, params) -> "MLP":
        """Copy the flat list's (or the pairs') values into the
        parameters."""
        return self.load_layers(as_layers(params))

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


def neural_net(layer_sizes: Sequence[int], activation: Callable = torch.tanh,
               precision="highest", dtype=torch.float32, device="cuda",
               seed: Optional[int] = None,
               param_dtype=torch.float32) -> MLP:
    """Build the standard PINN MLP (parity: reference ``networks.py:10``;
    the JAX package's ``neural_net(layer_sizes, activation, precision,
    dtype)``); ``seed`` makes the init reproducible."""
    return MLP(layer_sizes, device=device, generator=init_generator(seed),
               activation=activation, precision=precision,
               param_dtype=param_dtype, dtype=dtype)


class ModuleNet(nn.Module):
    """Any ``nn.Module`` mapping ``[N, n_in]`` to ``[N, n_out]``, adapted to
    the network protocol (module docstring): ``params()`` is the module's
    ``named_parameters()`` in registration order (a tied or shared
    parameter once, under its first name), ``apply(params, x)`` runs the
    module through ``torch.func.functional_call`` with those tensors and
    its own buffers (tied names follow their first), and a point ``x
    [n_in]`` is taken as ``[1, n_in]``.  The module is held, not copied:
    training updates its parameters in place.  ``precision`` (or the
    module's own ``precision`` attribute) is its products' matmul
    precision on the card."""

    def __init__(self, module: nn.Module, precision="highest"):
        super().__init__()
        if not isinstance(module, nn.Module):
            raise TypeError(f"network must be a torch.nn.Module, got "
                            f"{type(module).__name__}")
        self.module = module
        self.precision = resolve_precision(
            getattr(module, "precision", precision))
        self.names = [n for n, _ in module.named_parameters()]
        if not self.names:
            raise ValueError(f"{type(module).__name__} has no parameters "
                             "to train")

    def params(self) -> list:
        return [p for _, p in self.module.named_parameters()]

    def param_tree(self, params) -> list:
        return list(params)

    @torch.no_grad()
    def load_params(self, params) -> "ModuleNet":
        params = list(params)
        live = self.params()
        if len(params) != len(live):
            raise ValueError(f"expected {len(live)} parameter tensors, got "
                             f"{len(params)}")
        for name, p, new in zip(self.names, live, params):
            if tuple(new.shape) != tuple(p.shape):
                raise ValueError(f"parameter {name!r} has shape "
                                 f"{tuple(p.shape)}, got {tuple(new.shape)}")
            p.copy_(new)
        return self

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        mapping = dict(zip(self.names, params))
        mapping.update(self.module.named_buffers())
        lead = x.shape[:-1]
        with matmul_precision(self.precision):
            y = torch.func.functional_call(
                self.module, mapping, (x.reshape(-1, x.shape[-1]),))
        return y.reshape(*lead, y.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params(), x)


def as_network(network: nn.Module) -> nn.Module:
    """``network`` under the protocol: the MLP family (and a
    :class:`ModuleNet`) as it is, any other ``nn.Module`` wrapped in a
    :class:`ModuleNet`."""
    if isinstance(network, (MLP, ModuleNet)):
        return network
    return ModuleNet(network)


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
                 generator: Optional[torch.Generator] = None, **knobs):
        self.n_frequencies = int(n_frequencies)
        self.sigma = float(sigma)
        self.feature_seed = int(feature_seed)
        super().__init__(layer_sizes, device=device, generator=generator,
                         **knobs)
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
                 generator: Optional[torch.Generator] = None, **knobs):
        self.periodic = tuple((int(d), float(lb), float(p))
                              for d, lb, p in periodic)
        self.n_harmonics = int(n_harmonics)
        super().__init__(layer_sizes, device=device, generator=generator,
                         **knobs)
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
    package's keys: the activation's name, the network's type — a
    :class:`ModuleNet`'s is its module's).  The embedding families add
    ``net_config``: loading weights into another embedding would be
    another function."""
    inner = net.module if isinstance(net, ModuleNet) else net
    act = getattr(inner, "activation", None)
    meta = {"format": 1,
            "layer_sizes": list(layer_sizes),
            "activation": getattr(act, "__name__", str(act)),
            "network_type": type(inner).__name__,
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
    """The arrays a network's function depends on beyond its parameters (a
    :class:`FourierMLP`'s ``B``, a :class:`ModuleNet`'s module buffers by
    name), the live tensors, for checkpoints and artifacts."""
    if isinstance(net, ModuleNet):
        return dict(net.module.named_buffers())
    return {"B": net.B} if type(net) is FourierMLP else {}


def net_from_metadata(meta: dict, device="cuda") -> MLP:
    """Rebuild a network from a :func:`net_metadata` record, on ``device``.

    Only the standard tanh families can be rebuilt without user code
    (:data:`REBUILDABLE_NETS`); a custom module must be rebuilt by the
    caller and handed in directly.  A :class:`FourierMLP` comes back with
    the ``B`` its seed draws here; the caller restores the saved ``B``
    (:func:`net_buffers`) over it.  The knobs take their defaults, as in
    the JAX package (a tanh float32 net at precision HIGHEST)."""
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
