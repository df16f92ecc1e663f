"""Shared utilities: the device rule, the self-adaptive λ containers and
the profiler ranges of the training step.

Counterpart of the JAX package's ``utils.py`` (``initialize_lambdas``,
``tree_copy``), plus :func:`resolve_device`, the one place the port's
entry points turn their ``device=`` argument into a ``torch.device``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not have yet; the
    message names its ROADMAP item.  Raised instead of ignoring the
    option."""


def not_ported(what: str, item: str) -> NotPortedError:
    return NotPortedError(f"{what} is not ported to tensordiffeq_tpu_torch "
                          f"yet (ROADMAP: {item})")


@contextlib.contextmanager
def ieee_f32():
    """Run float32 matmuls and convolutions in IEEE float32 (TF32 off) —
    the JAX package's ``precision=HIGHEST`` — restoring the caller's
    settings afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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
