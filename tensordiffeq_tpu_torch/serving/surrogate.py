"""The deployable surrogate artifact: the train/infer split.

Counterpart of the JAX package's ``serving/surrogate.py``.  A
:class:`Surrogate` is the inference-only extract of a trained solver: the
network, its parameters and the ``u``/derivative/residual closures, with no
training state (no optimizer moments, no λ, no collocation set).  It saves
through :mod:`tensordiffeq_tpu_torch.checkpoint`, whose state tree is
``{"params": ...}`` and nothing else, and restores in a fresh process with
no solver around.

The residual ``f_model`` is user code and is not serialised: the loader
passes it to :meth:`Surrogate.load` again, as in the reference's
``AC-inference.py`` flow.  The payload is the port's ``.npz``, so an
artifact of the JAX package (orbax) does not load here; parameters cross
between the packages through :func:`~tensordiffeq_tpu_torch.weights.
params_from_jax`.

Typical flow::

    solver.fit(...)
    solver.export_surrogate().save("runs/ac_surrogate")

    # -- fresh process, no solver, no domain, no training state ----------
    from tensordiffeq_tpu_torch.serving import Surrogate
    sur = Surrogate.load("runs/ac_surrogate", f_model=f_model)  # the card
    engine = sur.engine()                 # bucketed, one CUDA graph a rung
    u = engine.u(X)                       # [N, n_out]
    u_x = engine.derivative(X, "x")       # [N]
    f = engine.residual(X)                # [N] (tuple for systems)

A ``DiscoveryModel`` exports through :meth:`Surrogate.from_discovery`
(the ``"discovery"`` contract): its learned coefficients are frozen into
the artifact's meta, and the residual the engine serves is the loader's
``f_model(u, var, *coords)`` with them bound in.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import (resolve_checkpoint_dir, restore_checkpoint,
                          save_checkpoint)
from ..networks import (MLP, as_network, net_buffers, net_from_metadata,
                        net_metadata)
from ..utils import param_leaves, resolve_device

_FORMAT = 1
# Artifact schema version (distinct from _FORMAT, the original marker
# field).  v1: no version field (absent reads as 1); v2 adds the optional
# fleet warm-start block.  Every version <= ARTIFACT_VERSION loads; a newer
# one fails loudly with ArtifactVersionMismatch instead of mis-restoring
# fields this build has never heard of.
ARTIFACT_VERSION = 2
# which f_model signature the artifact's residual expects:
#   forward    f_model(u, *coords)            (CollocationSolverND)
#   discovery  f_model(u, var, *coords)       (DiscoveryModel)
_CONTRACTS = ("forward", "discovery")


class ArtifactVersionMismatch(ValueError):
    """The artifact's schema version is newer than this build supports:
    loading would drop or mis-read fields the producer relied on.  Upgrade
    the serving build, or re-export the artifact."""

    def __init__(self, path: str, found: int, supported: int):
        self.path = path
        self.found = int(found)
        self.supported = int(supported)
        super().__init__(
            f"{path} is a v{found} surrogate artifact but this build "
            f"supports up to v{supported}; upgrade tensordiffeq_tpu_torch "
            "or re-export the artifact with this version")


class Surrogate:
    """Inference-only extract of a trained solver: net + params + closures.

    ``params`` are the parameters the engine serves, in the network's
    structure (``[(W, b), ...]`` for the MLP family, a custom module's flat
    list; their device is the engine's); ``net`` is the architecture they
    belong to (any network of the protocol in :mod:`..networks`).  Build
    one with :meth:`from_solver` (or the solver's ``export_surrogate()``)
    or :meth:`load`; evaluate through :meth:`engine`.
    """

    def __init__(self, net, params, varnames: Sequence[str], n_out: int = 1,
                 f_model: Optional[Callable] = None,
                 coefficients: Optional[Sequence] = None,
                 contract: str = "forward"):
        if contract not in _CONTRACTS:
            raise ValueError(f"contract must be one of {_CONTRACTS}, "
                             f"got {contract!r}")
        self.net = net = as_network(net)
        self.params = list(net.param_tree(param_leaves(params)))
        self.varnames = tuple(varnames)
        self.ndim = len(self.varnames)
        self.n_out = int(n_out)
        self.contract = contract
        self.coefficients = (None if coefficients is None else
                             [np.array(c, np.float32)
                              for c in coefficients])
        self.f_model = f_model
        self._bound = None  # the discovery residual with its coefficients
        self.layer_sizes = list(getattr(net, "layer_sizes",
                                        (self.ndim, self.n_out)))
        # set by load(): the artifact's meta and its on-disk directory
        self.artifact_meta: dict = {}
        self.artifact_dir: Optional[str] = None

    # ------------------------------------------------------------------ #
    @property
    def apply_fn(self) -> Callable:
        """The forward contract: ``apply_fn(params, x[..., ndim]) ->
        [..., n_out]`` (the network's own, with its embedding)."""
        return self.net.apply

    @property
    def device(self) -> torch.device:
        return param_leaves(self.params)[0].device

    def _tree(self) -> list:
        """The parameters in the artifact's layout: ``[[W, b], ...]`` for
        the MLP family, the flat list of a custom module's."""
        return ([list(p) for p in self.params]
                if isinstance(self.net, MLP) else list(self.params))

    @property
    def point_residual(self) -> Optional[Callable]:
        """The per-point residual ``r(u, *coords)`` with any learned
        coefficients bound in (as 0-d tensors on the surrogate's device),
        or ``None`` when no ``f_model`` is attached (u and derivative
        queries still work; residual queries raise)."""
        if self.f_model is None:
            return None
        if self.contract == "discovery":
            if self.coefficients is None:
                raise ValueError(
                    "discovery surrogate has no coefficient values; the "
                    "artifact is corrupt or was built without vars")
            if self._bound is None:  # one copy to the device, not per query
                f = self.f_model
                coeffs = [torch.as_tensor(c, device=self.device)
                          for c in self.coefficients]
                self._bound = lambda u, *coords: f(u, coeffs, *coords)
            return self._bound
        return self.f_model

    # ------------------------------------------------------------------ #
    @classmethod
    def from_solver(cls, solver, best_model: bool = False) -> "Surrogate":
        """Extract from a :class:`CollocationSolverND` (compiled, or
        ``load_model``-restored).  ``best_model=True`` exports the best
        iterate seen in training instead of the last one (the selection
        ``predict(best_model=True)`` makes).  The parameters are copied:
        the surrogate does not follow later training."""
        params = solver.params
        if best_model and solver.best_model.get("overall") is not None:
            params = solver.best_model["overall"]
        params = [t.detach().clone() for t in param_leaves(params)]
        if getattr(solver, "_compiled", False):
            varnames = tuple(solver.domain.vars)
            f_model = solver.f_model
        else:  # load_model-only solver: the net exists, the residual not
            varnames = tuple(f"x{i}"
                             for i in range(int(solver.layer_sizes[0])))
            f_model = None
        return cls(solver.net, params, varnames, n_out=solver.n_out,
                   f_model=f_model, contract="forward")

    @classmethod
    def from_discovery(cls, model) -> "Surrogate":
        """Extract from a :class:`~..models.DiscoveryModel`: a copy of the
        network's parameters, with the learned coefficient values frozen
        into the artifact, so the surrogate evaluates the *learned* PDE's
        residual."""
        params = [t.detach().clone() for t in model.net.params()]
        return cls(model.net, params, model.varnames, n_out=model.n_out,
                   f_model=model.f_model, coefficients=model.vars,
                   contract="discovery")

    # ------------------------------------------------------------------ #
    def engine(self, **kwargs):
        """An :class:`~tensordiffeq_tpu_torch.serving.InferenceEngine` over
        this surrogate (see there for the bucket ladder)."""
        from .engine import InferenceEngine
        return InferenceEngine(self, **kwargs)

    # ------------------------------------------------------------------ #
    def save(self, path: str, extra_meta: Optional[dict] = None,
             extra_files: Optional[dict] = None) -> None:
        """Persist under the directory ``path`` through the checkpoint
        protocol (``.tmp``, fsync, atomic swap, sha256).  The state is
        ``{"params": ...}``, and a FourierMLP's frequency matrix
        (``{"net_buffers": {"B": ...}}``): the port draws ``B`` from another
        random stream than the JAX package, so the artifact carries it.  ``extra_meta`` merges JSON fields into
        the artifact meta; ``extra_files`` maps artifact-relative paths to
        raw bytes saved and checksummed beside the state."""
        meta = net_metadata(self.net, self.layer_sizes, self.n_out)
        meta.update(surrogate_format=_FORMAT,
                    artifact_version=ARTIFACT_VERSION,
                    varnames=list(self.varnames),
                    contract=self.contract)
        if self.coefficients is not None:
            meta["coefficients"] = [c.tolist() for c in self.coefficients]
        if extra_meta:
            meta.update(extra_meta)
        state = {"params": self._tree()}
        buffers = net_buffers(self.net)
        if buffers:
            state["net_buffers"] = buffers
        save_checkpoint(path, state, meta, extra_files=extra_files)

    @classmethod
    def load(cls, path: str, f_model: Optional[Callable] = None, net=None,
             device="cuda") -> "Surrogate":
        """Restore an artifact written by :meth:`save` onto ``device`` (the
        card unless the caller asks for ``"cpu"``); needs no solver, no
        domain and no training state.  ``f_model`` re-attaches the residual
        (user code is never serialised); omit it to serve ``u`` and
        derivatives only.  ``net`` re-attaches a network built by the
        caller, with the architecture the training run used: needed for
        anything but the standard tanh MLP family (a custom module, another
        activation), as in the JAX package; its type must be the
        artifact's."""
        dev = resolve_device(device)
        artifact_dir = resolve_checkpoint_dir(path)
        with open(os.path.join(artifact_dir, "tdq_meta.json")) as fh:
            meta = json.load(fh)["meta"]
        if "surrogate_format" not in meta:
            raise ValueError(
                f"{path} is not a surrogate artifact (it has no "
                "surrogate_format field — a full training checkpoint "
                "belongs to solver.restore_checkpoint)")
        # the schema gate comes before any other field is read
        version = int(meta.get("artifact_version", 1))
        if version > ARTIFACT_VERSION:
            raise ArtifactVersionMismatch(path, version, ARTIFACT_VERSION)
        if net is None:
            try:
                net = net_from_metadata(meta, device=dev)
            except ValueError as e:
                raise ValueError(
                    f"{e}; here: Surrogate.load(path, f_model=..., "
                    "net=<the network module the training run compiled "
                    "with>)") from None
        else:
            net = as_network(net)
            mine = net_metadata(net, meta["layer_sizes"], meta["n_out"])
            if mine["network_type"] != meta.get("network_type"):
                raise ValueError(
                    f"{path} holds a {meta.get('network_type')} network; "
                    f"net= is a {mine['network_type']}")
        net = net.to(dev)
        tree = net.param_tree(net.params())
        template = {"params": ([list(p) for p in tree]
                               if isinstance(net, MLP) else list(tree))}
        buffers = net_buffers(net)
        if buffers:
            template["net_buffers"] = buffers
        state, _ = restore_checkpoint(path, template)
        net.load_params([torch.from_numpy(np.asarray(a))
                         for a in param_leaves(state["params"])])
        with torch.no_grad():
            live = net_buffers(net)
            for name, saved in state.get("net_buffers", {}).items():
                live[name].copy_(torch.from_numpy(np.asarray(saved)))
        # the served tensors share the net's storage
        params = [t.detach() for t in net.params()]
        sur = cls(net, params, meta["varnames"], n_out=int(meta["n_out"]),
                  f_model=f_model, coefficients=meta.get("coefficients"),
                  contract=meta.get("contract", "forward"))
        sur.artifact_meta = meta
        sur.artifact_dir = artifact_dir
        return sur
