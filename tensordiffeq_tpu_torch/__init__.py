"""tensordiffeq_tpu_torch — the PyTorch/CUDA port of tensordiffeq_tpu.

A second package beside the JAX one, with the same module layout and names:
the forward SA-PINN solve (``DomainND`` → BCs → ``CollocationSolverND.
compile`` → ``fit`` → ``predict``) in PyTorch, with the fused residual
engine's Taylor-table kernels (``compile(fused="cuda")``,
:mod:`.ops.cuda_taylor`) and the fused minimax training step
(``compile(minimax=None)``, the default, :mod:`.ops.minimax`) hand-written
in CUDA for the H100, and the serving path (``solver.export_surrogate()``
→ :class:`~.serving.Surrogate` → its bucketed engine, one CUDA graph per
rung, → :class:`~.serving.RequestBatcher`), adaptive collocation
(``fit(resample_every=...)``, :mod:`.ops.resampling`), the inverse
problem (:class:`~.models.DiscoveryModel`), training telemetry
(``fit(telemetry=, eval_fn=, profile_dir=)``, :mod:`.telemetry`) and the
PDE zoo with its scorecard (:mod:`.zoo`).  Entry points run on
the card unless the caller passes ``device="cpu"``.  ``network=`` takes any
``nn.Module`` and the MLP takes the JAX package's knobs (``activation``,
``precision`` — ``None`` runs the kernels' single-pass TF32 flavor —
``dtype``, ``param_dtype``); the reference's helpers resolve at their
paths (:mod:`.utils`, :mod:`.plotting`, :mod:`.output`).  Of the JAX
solver only ``dist=`` and ``save_checkpoint(sharded=True)`` still raise
:class:`~.utils.NotPortedError`.  The port imports nothing of JAX and
nothing of ``tensordiffeq_tpu``.
"""

from . import boundaries, domains, exact, helpers, networks  # noqa: F401
from . import models, ops, output, plotting, profiling  # noqa: F401
from . import resilience, sampling  # noqa: F401
from . import serving, telemetry, training, utils, weights  # noqa: F401
from . import zoo  # noqa: F401
from .boundaries import (  # noqa: F401
    BC, IC, FunctionDirichletBC, FunctionNeumannBC, dirichletBC, periodicBC)
from .domains import DomainND  # noqa: F401
from .helpers import find_L2_error  # noqa: F401
from .models import (  # noqa: F401
    CollocationSolverND, DiscoveryModel, NotCompiledError)
from .networks import (MLP, FourierMLP, ModuleNet,  # noqa: F401
                       PeriodicMLP, fourier_net, neural_net, periodic_net)
from .ops import MSE, UFn, d, g_MSE, grad, laplacian  # noqa: F401
from .ops import set_default_grad_mode  # noqa: F401
from .resilience import CircuitBreaker, RetryPolicy  # noqa: F401
from .serving import (ArtifactVersionMismatch, InferenceEngine,  # noqa: F401
                      RequestBatcher, Surrogate)
from .telemetry import (MetricsRegistry, RunLogger,  # noqa: F401
                        TrainingDiverged, TrainingTelemetry)
from .utils import CudaUnavailableError, NotPortedError  # noqa: F401
from .weights import params_from_jax, params_to_numpy  # noqa: F401

__version__ = "0.1.0"
