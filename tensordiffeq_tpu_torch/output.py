"""Console banner and model summary at training start (parity: reference
``tensordiffeq/output.py:5-11``; the JAX package's ``output.py``, a static
banner instead of the pyfiglet dependency).

:func:`print_screen` narrates through :func:`~.telemetry.log_event`, so an
active run logger records the structured ``banner`` event beside the
printed text.  The solvers call it under ``verbose`` at the start of
``fit``.
"""

from __future__ import annotations

import torch

_BANNER = r"""
 _____                       ___  _  __  __ ___       _____ ___ _   _
|_   _|__ _ _  ___ ___ _ _ |   \(_)/ _|/ _| __|__ _ |_   _| _ \ | | |
  | |/ -_) ' \(_-</ _ \ '_|| |) | |  _|  _| _|/ _` |  | | |  _/ |_| |
  |_|\___|_||_/__/\___/_|  |___/|_|_| |_| |___\__, |  |_| |_|  \___/
                                                 |_|
"""


def print_screen(solver, discovery_model: bool = False):
    """Print the banner, the solver's device and the parameter count (and
    log the structured equivalent to any active telemetry run sink)."""
    from .telemetry import log_event
    device = getattr(solver, "device", torch.device("cpu"))
    platform = "gpu" if device.type == "cuda" else device.type
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    n_params = sum(int(t.numel()) for t in solver.net.params())
    kind = "DiscoveryModel" if discovery_model else type(solver).__name__
    layer_sizes = getattr(solver, "layer_sizes", "?")
    log_event(
        "banner",
        f"{_BANNER}\nBackend: {platform} | devices: {n_devices}\n{kind}: "
        f"layer_sizes={layer_sizes} ({n_params:,} parameters)",
        prefix=False, backend=platform, devices=n_devices, solver=kind,
        n_params=n_params)
