"""The in-library FLOP/MFU cost model.

Counterpart of the JAX package's ``telemetry/costmodel.py``: the analytic
per-step FLOP counts, the basis rules and the live ``cost.*`` gauges of a
telemetry-attached fit.  The JAX package reads a lowered XLA program's cost
analysis first and falls back to the analytic counts where a custom call
blinds it; the port has no compiled program to ask (its steps are CUDA
graphs of hand-written kernels and PyTorch ops), so every count here is
analytic and discloses its basis (``flops_basis``):

* ``"analytic-minimax"`` — the channel-exact count of a fused minimax
  step (:func:`analytic_minimax_flops`), the basis the JAX package's
  scorecard quotes on every arm;
* another fallback label the caller supplies (e.g. ``"analytic-resample"``);
* ``"analytic-floor"`` — the generic floor (:func:`analytic_step_floor`),
  a disclosed **lower bound**, so the MFU quoted on it is one too;
* ``None`` — nothing to quote: no basis, no MFU.

Peaks (:func:`peak_flops_for`) are the H100 SXM's dense figures from
NVIDIA's data sheet, the ones ``chip_smoke.py::bound_ms`` prices the
kernels with: 67 TFLOP/s FP32 on the CUDA cores, 495 TF32 and 989 bf16 on
the tensor cores.  The MFU denominator is the dense bf16 peak, the JAX
package's convention.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

from .registry import MetricsRegistry, default_registry

# dense peak FLOP/s per card by number format (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = {
    "h100": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12},
}

#: minimum forward-equivalent passes in one SA train step: forward +
#: backward over params and λ cost at least 3 forward passes of MACs
STEP_FORWARD_PASSES = 3.0


def peak_flops_for(device_kind: str, kind: str = "bf16") -> Optional[float]:
    """The card's dense peak in the number format ``kind`` (``"fp32"``,
    ``"tf32"`` or ``"bf16"``) for a ``torch.cuda.get_device_name`` string,
    or ``None`` (an unknown card, and always on the CPU)."""
    dk = str(device_kind).lower()
    for key, peaks in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if key in dk:
            return peaks.get(kind)
    return None


def default_peak() -> Optional[float]:
    """The live-instrumentation MFU denominator: ``TDQ_PEAK_FLOPS`` (a
    float; lets a CPU test or an unlisted card quote MFU), else the dense
    bf16 peak of the current CUDA device, else ``None``."""
    env = os.environ.get("TDQ_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        return peak_flops_for(torch.cuda.get_device_name(0))
    except Exception:
        return None


# -------------------------------------------------------------------------- #
# analytic floor + basis substitution
# -------------------------------------------------------------------------- #
def analytic_mlp_flops(dims: Sequence[int], n_points: int,
                       passes: float = 1.0) -> float:
    """Model FLOPs of ``passes`` forward-equivalent passes of a dense MLP
    (``2 * sum(d_i * d_{i+1})`` per point per pass) over ``n_points``
    rows."""
    dims = list(dims)
    per_pt = 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(passes) * per_pt * int(n_points)


def analytic_step_floor(n_points: int, dims: Sequence[int]) -> float:
    """Lower bound on model FLOPs for one SA train step: forward +
    backward over the collocation batch (>= 3 forward-equivalent
    passes)."""
    return analytic_mlp_flops(dims, n_points, passes=STEP_FORWARD_PASSES)


def analytic_step_bytes(dims: Sequence[int], n_points: int,
                        n_lambdas: int = 1, n_outputs: int = 1) -> float:
    """Bytes one float32 training step must move at least: each point's
    inputs, its ``n_lambdas`` per-point λ columns and its ``n_outputs``
    outputs (the residual of each equation) read or written once, plus one
    read of the weights and biases — the per-point count of
    :func:`analytic_serving_cost`, over the step's points."""
    dims = list(dims)
    weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    per_point = dims[0] + int(n_lambdas) + int(n_outputs)
    return 4.0 * (int(n_points) * per_point + weights)


def per_point_lambda_columns(lambdas, n_rows: int) -> int:
    """The per-point λ columns among a term's ``lambdas``: a λ of ``n_rows``
    rows (``[n_rows]`` or ``[n_rows, E]``) counts its columns, a scalar λ
    none — what a step reads once per point (:func:`analytic_step_bytes`'s
    ``n_lambdas``)."""
    cols = 0
    for lam in lambdas:
        if lam is None or lam.ndim == 0 or int(lam.shape[0]) != n_rows:
            continue
        n = 1
        for s in lam.shape[1:]:
            n *= int(s)
        cols += n
    return cols


def analytic_minimax_flops(dims: Sequence[int], n_points: int,
                           n_channels: int,
                           passes: float = STEP_FORWARD_PASSES,
                           n_equations: int = 1) -> float:
    """Channel-exact analytic model FLOPs of one fused minimax step (K3):
    the wavefront carries ``n_channels`` derivative channels
    (:func:`~..ops.minimax.n_channels`) through every layer product, over
    >= 3 forward-equivalent passes, plus the residual boundary's square,
    weight-multiply and accumulate (3 FLOPs per point per equation per
    pass).  The wavefront is shared by the ``n_equations`` of a system, so
    E does not multiply the product term."""
    boundary = float(passes) * 3.0 * int(n_equations) * int(n_points)
    return (float(n_channels) * analytic_mlp_flops(dims, n_points,
                                                   passes=passes)
            + boundary)


def analytic_serving_cost(dims: Optional[Sequence[int]],
                          n_channels: Optional[int],
                          io_bytes_per_point: float, param_bytes: float,
                          bucket: int) -> Tuple[Optional[float], float]:
    """``(flops, bytes)`` per query point of a serving rung of ``bucket``
    rows (the engine's ``serving.engine.{flops,bytes}_per_point``): the
    ``n_channels`` Taylor channels of the query kind through the MLP's
    products (``None`` where the widths or the channels are unknown), and
    the point's own input and output bytes plus its share of one read of
    the parameters."""
    flops = (None if not dims or n_channels is None
             else float(n_channels) * analytic_mlp_flops(dims, 1))
    return flops, float(io_bytes_per_point) + float(param_bytes) / int(bucket)


def resolve_flop_basis(measured: Optional[float], floor: float,
                       fallback: Optional[Callable[[], Tuple[
                           Optional[float], Optional[str]]]] = None,
                       ) -> Tuple[Optional[float], Optional[str]]:
    """``(flops, basis)``: a measured count at or above ``floor`` is kept
    (``"compiled"``); anything else substitutes ``fallback()``, which
    returns its own ``(flops, label)``; with neither, ``(None, None)``."""
    if measured is not None and measured >= floor:
        return measured, "compiled"
    if fallback is not None:
        flops, label = fallback()
        if flops is not None:
            return flops, label
    return None, None


def mfu(flops_per_step: Optional[float], steps_per_sec: float,
        n_chips: int = 1, peak: Optional[float] = None) -> Optional[float]:
    """Achieved FLOP/s over the card's peak, or ``None`` when either side is
    unknown."""
    if flops_per_step is None or not peak or n_chips < 1:
        return None
    return flops_per_step * steps_per_sec / n_chips / peak


# -------------------------------------------------------------------------- #
# live instrumentation
# -------------------------------------------------------------------------- #
class StepCostModel:
    """Live per-step cost gauges for a training loop.

    Price the step once (:meth:`observe_program`) and feed every timed
    chunk (:meth:`observe_steps`); it publishes ``cost.flops_per_step``
    (labeled ``phase=``), then ``cost.achieved_flops_per_s`` and, with a
    known peak (:func:`default_peak`), ``cost.mfu`` per chunk.  The price
    is ``fallback = (flops, label)`` when given (the minimax step's
    channel-exact count), else the analytic ``floor`` itself
    (``"analytic-floor"``); ``bytes_per_step`` (:func:`analytic_step_bytes`)
    sets ``cost.bytes_per_step`` beside it."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 phase: str = "train", floor: Optional[float] = None,
                 peak: Optional[float] = None, n_chips: int = 1,
                 fallback: Optional[Tuple[float, str]] = None,
                 bytes_per_step: Optional[float] = None):
        self.registry = registry if registry is not None else default_registry()
        self.phase = str(phase)
        self.floor = floor
        self.fallback = fallback
        self.peak = peak if peak is not None else default_peak()
        self.n_chips = max(int(n_chips), 1)
        self.bytes_per_step = bytes_per_step
        self.flops_per_step: Optional[float] = None
        self.basis: Optional[str] = None
        self._extra_flops = 0.0

    def _scope(self):
        return self.registry.scope(phase=self.phase)

    def observe_program(self) -> dict:
        """Price the step analytically (the JAX package prices a lowered
        program here and falls back to the same analytic counts; the port
        has no program to ask) and set the per-step gauges.  Returns
        ``{"flops_per_step", "bytes_per_step", "basis"}``."""
        self.flops_per_step, self.basis = resolve_flop_basis(
            None, 0.0, fallback=lambda: (self.fallback
                                         if self.fallback is not None
                                         else (self.floor, "analytic-floor")))
        scope = self._scope()
        if self.flops_per_step is not None:
            scope.gauge("cost.flops_per_step").set(self.flops_per_step)
        if self.bytes_per_step is not None:
            scope.gauge("cost.bytes_per_step").set(self.bytes_per_step)
        return {"flops_per_step": self.flops_per_step,
                "bytes_per_step": self.bytes_per_step, "basis": self.basis}

    def note_extra_flops(self, flops: Optional[float]):
        """Credit off-step device work that runs inside the next timed
        chunk's wall (a pipelined redraw's scoring pass): its FLOPs join
        that chunk's numerator once."""
        if flops:
            self._extra_flops += float(flops)

    def observe_steps(self, n_steps: int, wall_s: float) -> Optional[float]:
        """Update the live throughput gauges from one timed chunk.  Returns
        the MFU (``None`` when unquotable)."""
        if self.flops_per_step is None or wall_s <= 0 or n_steps < 1:
            return None
        extra, self._extra_flops = self._extra_flops, 0.0
        total = self.flops_per_step * n_steps + extra
        rate = total / wall_s / self.n_chips
        scope = self._scope()
        scope.gauge("cost.achieved_flops_per_s").set(rate)
        m = mfu(total / n_steps, n_steps / wall_s, self.n_chips, self.peak)
        if m is not None:
            scope.gauge("cost.mfu").set(m)
        return m
