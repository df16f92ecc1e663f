"""tensordiffeq_tpu_torch — the PyTorch/CUDA port of tensordiffeq_tpu.

A second package beside the JAX one, with the same module layout and names:
the forward SA-PINN solve (``DomainND`` → BCs → ``CollocationSolverND.
compile`` → ``fit`` → ``predict``) in PyTorch, with the fused residual
engine's Taylor-table kernels (``compile(fused="cuda")``,
:mod:`.ops.cuda_taylor`) and the fused minimax training step
(``compile(minimax=None)``, the default, :mod:`.ops.minimax`) hand-written
in CUDA for the H100.  Entry points run on
the card unless the caller passes ``device="cpu"``.  The port imports
nothing of JAX and nothing of ``tensordiffeq_tpu``.
"""

from . import boundaries, domains, exact, helpers, networks  # noqa: F401
from . import models, ops, sampling, training, utils, weights  # noqa: F401
from .boundaries import (  # noqa: F401
    BC, IC, FunctionDirichletBC, FunctionNeumannBC, dirichletBC, periodicBC)
from .domains import DomainND  # noqa: F401
from .helpers import find_L2_error  # noqa: F401
from .models import CollocationSolverND, NotCompiledError  # noqa: F401
from .networks import MLP, neural_net  # noqa: F401
from .ops import MSE, UFn, d, g_MSE, grad, laplacian  # noqa: F401
from .ops import set_default_grad_mode  # noqa: F401
from .utils import CudaUnavailableError, NotPortedError  # noqa: F401
from .weights import params_from_jax, params_to_numpy  # noqa: F401

__version__ = "0.1.0"
