"""Shared utilities: the device rule, the precision rule, the reference's
helpers, the self-adaptive λ containers and the profiler ranges of the
training step.

Counterpart of the JAX package's ``utils.py``: the reference's helpers at
the same path (``constant``/``tensor``/``convertTensor`` as float32
tensors, ``get_weights``/``set_weights`` as one flat vector over a
parameter list, ``get_sizes``, and the re-exports ``MSE``, ``g_MSE``,
``multimesh``, ``flatten_and_stack`` and ``LatinHypercubeSample``),
``initialize_lambdas`` and ``tree_copy``; plus :func:`resolve_device`, the
one place the port's entry points turn their ``device=`` argument into a
``torch.device``, and :func:`resolve_precision` with its scoped helper
:func:`matmul_precision`, the one place a ``precision=`` becomes a matmul
mode.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .ops.losses import MSE, g_MSE  # noqa: F401  (re-exported for parity)
from .ops.meshes import flatten_and_stack, multimesh  # noqa: F401
from .sampling import LatinHypercubeSample  # noqa: F401


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not have yet; the
    message names its ROADMAP item.  Raised instead of ignoring the
    option."""


def not_ported(what: str, item: str) -> NotPortedError:
    return NotPortedError(f"{what} is not ported to tensordiffeq_tpu_torch "
                          f"yet (ROADMAP: {item})")


# The three matmul precisions of the JAX package's ``precision=`` (its
# ``jax.lax.Precision``), by name.  What each means here:
#   "default" — one TF32 pass per product on the card (XLA's f32 DEFAULT
#       product on a GPU): torch's TF32 matmuls outside the kernels, the
#       single-pass TF32 flavor of K1, K2 and K3 inside them;
#   "high", "highest" — float32-grade products: IEEE float32 matmuls
#       outside the kernels, the kernels' 3xTF32 flavor inside them (the
#       nearest to a TPU's bf16x3).
# On the CPU every precision computes IEEE float32, as the JAX package
# does on its CPU.
PRECISIONS = ("default", "high", "highest")
# the names of jax.lax.Precision's string forms
_PRECISION_ALIASES = {"bfloat16": "default", "fastest": "default",
                      "tensorfloat32": "high", "float32": "highest"}


def resolve_precision(precision) -> str:
    """``"default"``, ``"high"`` or ``"highest"`` for a ``precision=``
    argument: ``None`` (the backend's fast product, as in JAX), one of those
    names in any case, a JAX ``Precision`` name as a string
    (``"Precision.HIGHEST"``, ``"HIGHEST"``, ``"tensorfloat32"``...), or an
    object with such a ``name``.  Anything else raises
    :class:`ValueError`."""
    if precision is None:
        return "default"
    name = getattr(precision, "name", precision)
    if isinstance(name, str):
        key = name.strip().lower().rsplit(".", 1)[-1]
        key = _PRECISION_ALIASES.get(key, key)
        if key in PRECISIONS:
            return key
    raise ValueError(f"precision={precision!r}: expected None, 'default', "
                     "'high' or 'highest' (or a JAX Precision name)")


@contextlib.contextmanager
def matmul_precision(precision="highest"):
    """Run float32 matmuls and convolutions at ``precision``
    (:func:`resolve_precision`): TF32 for ``"default"``, IEEE float32 (TF32
    off) for ``"high"``/``"highest"``; restores the caller's settings
    afterwards.  One API throughout (the ``allow_tf32`` flags): PyTorch
    refuses some mixes of those with its ``fp32_precision`` settings.  A
    CUDA graph keeps the cuBLAS math mode it was captured under, so a
    step is captured inside the scope it replays for."""
    tf32 = resolve_precision(precision) == "default"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def ieee_f32():
    """Run float32 matmuls and convolutions in IEEE float32 (TF32 off) —
    the JAX package's ``precision=HIGHEST`` — restoring the caller's
    settings afterwards (:func:`matmul_precision` at ``"highest"``)."""
    return matmul_precision("highest")


# the kernels' single-pass TF32 flavor, beside None (3xTF32) and
# torch.bfloat16: the flavor of precision "default" (resolve_flavor)
TF32 = "tf32"


def resolve_flavor(compute_dtype=None, precision="highest"):
    """The kernels' flavor for a ``fused_dtype=``/``compute_dtype=`` and a
    network's ``precision=``: ``torch.bfloat16`` when a bf16 compute dtype
    is asked for (it overrides the precision, as the JAX package's
    ``compute_dtype`` does), else :data:`TF32` for precision
    ``"default"``, else ``None`` (the 3xTF32 float32 flavor)."""
    dtype = resolve_compute_dtype(compute_dtype)
    if dtype is not None:
        return dtype
    return TF32 if resolve_precision(precision) == "default" else None


def resolve_compute_dtype(dtype) -> Optional[torch.dtype]:
    """``None`` or ``torch.bfloat16`` for a ``fused_dtype=`` /
    ``compute_dtype=`` argument (``None``, ``"bfloat16"`` or
    ``torch.bfloat16``): the kernels' two flavors.  Anything else raises
    :class:`ValueError`."""
    if dtype is None:
        return None
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"compute dtype {dtype!r}: expected None, 'bfloat16' "
                     "or torch.bfloat16 (the mixed-precision flavor of the "
                     "kernels)")


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else a no-op: a range entered with no profiler still costs a dispatcher
    call per step."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class CudaUnavailableError(RuntimeError):
    """An entry point was asked for (or defaulted to) a CUDA device on a
    machine where ``torch.cuda.is_available()`` is false.  The port never
    carries on quietly on the CPU: pass ``device="cpu"`` to ask for it."""


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    CUDA is the default everywhere; the CPU runs only when the caller says
    so.  Raises :class:`CudaUnavailableError` for a CUDA device without a
    usable card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def initialize_lambdas(init_weights: Optional[dict],
                       dict_adaptive: Optional[dict],
                       device="cuda") -> dict[str, list[Optional[torch.Tensor]]]:
    """Build the self-adaptive λ containers from the user's
    ``init_weights`` / ``dict_adaptive`` contract (reference
    ``utils.py:102-115``; JAX package ``utils.py::initialize_lambdas``).

    Returns ``{"residual": [λ|None, ...], "BCs": [λ|None, ...]}`` with one
    entry per loss term, ``None`` where the term is non-adaptive.  Each λ is
    a float32 leaf tensor on ``device`` that requires grad (the ascent
    optimizer trains it); per-point vectors take column shape ``[n, 1]``.
    """
    dev = resolve_device(device)
    lambdas: dict[str, list[Optional[torch.Tensor]]] = {"residual": [],
                                                         "BCs": []}
    if init_weights is None or dict_adaptive is None:
        return lambdas
    for key in ("residual", "BCs"):
        flags = dict_adaptive.get(key, [])
        inits = init_weights.get(key, [])
        if len(flags) != len(inits):
            raise ValueError(
                f"dict_adaptive[{key!r}] and init_weights[{key!r}] must have "
                f"the same length, got {len(flags)} vs {len(inits)}")
        for flag, init in zip(flags, inits):
            if flag and init is None:
                raise ValueError(
                    f"Loss term in {key!r} marked adaptive but init weight is None")
            if not flag:
                lambdas[key].append(None)
                continue
            lam = torch.as_tensor(init, dtype=torch.float32).to(dev).clone()
            # column shape [n, 1]: a 1-D (n,) λ would broadcast against
            # (n, 1) errors into an (n, n) outer product inside MSE
            if lam.ndim == 1 and lam.shape[0] > 1:
                lam = lam.reshape(-1, 1)
            lambdas[key].append(lam.requires_grad_(True))
    return lambdas


def tree_copy(tree: Any) -> Any:
    """Detached deep copy of a nest of lists/tuples/dicts of tensors (the
    reference's best-model tracking aliases instead of copying — the JAX
    package's ``tree_copy`` is the same fix)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_copy(v) for v in tree)
    return tree


# ---------------------------------------------------------------------- #
# The reference's helpers (reference ``utils.py:7-69``), at the JAX
# package's path.  Values are float32 tensors on ``device``: the card unless
# the caller passes ``device="cpu"``, as at every entry point.
# ---------------------------------------------------------------------- #
def constant(val, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Parity: reference ``utils.py:51-52``."""
    return torch.as_tensor(np.asarray(val), dtype=dtype,
                           device=resolve_device(device))


def convertTensor(val, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Parity: reference ``utils.py:55-56``."""
    return constant(val, dtype=dtype, device=device)


def tensor(x, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Parity: reference ``utils.py:68-69``."""
    return constant(x, dtype=dtype, device=device)


def param_leaves(params) -> list:
    """The arrays of ``params``: a network (its ``params()``), a flat list,
    or a nest of lists/tuples such as ``[(W, b), ...]``, in order."""
    if hasattr(params, "params") and callable(params.params):
        params = params.params()
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in param_leaves(p)]
    return [params]


def params_like(template, leaves) -> list:
    """``leaves`` in the nesting of ``template`` (a flat list, or ``[(W,
    b), ...]``): :func:`param_leaves` undone."""
    it = iter(leaves)

    def go(p):
        if isinstance(p, (list, tuple)):
            return type(p)(go(q) for q in p)
        return next(it)

    return go(list(template))


def get_weights(params) -> torch.Tensor:
    """The parameters as one flat vector, in their order (reference
    ``utils.py:20-29``; the JAX package's ``ravel_pytree``): ``params`` is a
    network (the solver's ``net``), its flat ``params()`` list, or ``[(W,
    b), ...]``."""
    leaves = param_leaves(params)
    return torch.cat([t.detach().reshape(-1) for t in leaves])


def set_weights(params_template, flat: torch.Tensor):
    """Rebuild ``params_template``'s structure (a flat list, or a nest of
    lists/tuples) from the flat vector ``flat`` (reference ``utils.py:
    7-17``); a network as template gets the values copied into its
    parameters and is returned."""
    flat = torch.as_tensor(flat)
    if hasattr(params_template, "params") and \
            callable(params_template.params):
        leaves = params_template.params()
        if flat.numel() != sum(t.numel() for t in leaves):
            raise ValueError(f"flat vector holds {flat.numel()} values, the "
                             "network's parameters "
                             f"{sum(t.numel() for t in leaves)}")
        params_template.load_params(set_weights(list(leaves), flat))
        return params_template
    pos = 0

    def rebuild(t):
        nonlocal pos
        if isinstance(t, torch.Tensor):
            n = t.numel()
            if pos + n > flat.numel():
                raise ValueError("flat vector is shorter than the template")
            out = flat[pos:pos + n].reshape(t.shape).to(t.dtype)
            pos += n
            return out
        return type(t)(rebuild(v) for v in t)

    out = rebuild(params_template)
    if pos != flat.numel():
        raise ValueError(f"flat vector holds {flat.numel()} values, the "
                         f"template {pos}")
    return out


def get_sizes(layer_sizes: Sequence[int]):
    """Per-layer weight and bias sizes (reference ``utils.py:32-35``)."""
    sizes_w = [layer_sizes[i] * layer_sizes[i - 1]
               for i in range(1, len(layer_sizes))]
    sizes_b = list(layer_sizes[1:])
    return sizes_w, sizes_b
