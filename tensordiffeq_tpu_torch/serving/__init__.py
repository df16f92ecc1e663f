"""Batch-inference serving: deploy a trained PINN as a surrogate.

Counterpart of the JAX package's ``serving/``.  Training produces a
:class:`Surrogate` artifact (net + params + residual closure, no training
state), which restores in a fresh process and serves batched ``u`` /
derivative / residual queries through an :class:`InferenceEngine` (a
power-of-two bucket ladder, one CUDA graph per (kind, bucket) rung on the
card) fed by a :class:`RequestBatcher` (max-batch / max-latency coalescing
with QPS and latency percentiles)::

    sur = solver.export_surrogate()
    sur.save("runs/ac_surrogate")
    # fresh process:
    engine = Surrogate.load("runs/ac_surrogate", f_model=f_model).engine()
    u, f = engine.predict(X_grid)
"""

from .batcher import (PendingQuery, RequestBatcher,  # noqa: F401
                      RequestTimeout)
from .engine import EngineDegraded, InferenceEngine  # noqa: F401
from .surrogate import (ARTIFACT_VERSION,  # noqa: F401
                        ArtifactVersionMismatch, Surrogate)
