"""Learning-rate schedules evaluated on the device.

The port's copies of the optax schedules the JAX package's users and tests
pass as ``lr``/``lr_weights``/``lr_vars`` (``optax.constant_schedule``,
``optax.exponential_decay``, ``optax.cosine_decay_schedule``, optax 0.2.6),
with the same arguments and the same float32 arithmetic.  A schedule is a
function of a 0-d integer tensor ``count`` (the number of updates already
applied, optax's count: the first update reads ``schedule(0)``) that
returns a 0-d float32 tensor on ``count``'s device and never reads the
host, so a replayed CUDA graph can evaluate it on a device count.  Any
user callable with that contract is accepted as well (one that returns a
plain number is a constant).

:class:`DeviceLR` holds the 0-d rate tensor an Adam param group reads
(:func:`..fit.make_optimizer`); the count is the group's own Adam step
count.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _value(v: float, count: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=torch.float32, device=count.device)


def constant_schedule(value: float) -> Callable:
    """``optax.constant_schedule``: ``value`` at every count."""
    def schedule(count):
        return _value(value, count)
    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False,
                      end_value: Optional[float] = None) -> Callable:
    """``optax.exponential_decay``: ``init_value · decay_rate ** ((count -
    transition_begin) / transition_steps)`` from ``transition_begin`` on
    (the exponent floored under ``staircase``), ``init_value`` before it,
    clipped at ``end_value`` (a lower bound when ``decay_rate < 1``, an
    upper one otherwise).  A non-positive ``transition_steps`` or a zero
    ``decay_rate`` gives the constant ``init_value``, as in optax."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    begin = max(int(transition_begin), 0)

    def schedule(count):
        dc = count.to(torch.int32) - begin
        p = dc.to(torch.float32) / float(transition_steps)
        if staircase:
            p = torch.floor(p)
        decayed = torch.where(
            dc <= 0, _value(init_value, count),
            float(init_value) * torch.pow(float(decay_rate), p))
        if end_value is not None:
            bound = _value(end_value, count)
            decayed = (torch.maximum(decayed, bound) if decay_rate < 1.0
                       else torch.minimum(decayed, bound))
        return decayed
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable:
    """``optax.cosine_decay_schedule``: ``init_value · ((1 - alpha) ·
    (½(1 + cos(π·min(count, T)/T))) ** exponent + alpha)``, ``T =
    decay_steps``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")
    steps = float(decay_steps)

    def schedule(count):
        c = torch.clamp(count.to(torch.float32), max=steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / steps))
        decayed = (1.0 - alpha) * cosine ** exponent + alpha
        return float(init_value) * decayed
    return schedule


class DeviceLR:
    """One schedule's rate on the device: ``lr``, the 0-d float32 tensor an
    Adam param group reads.  :meth:`advance`, called just before the
    optimizer's step with the group's Adam step count (the updates
    applied), writes ``schedule(count)`` into ``lr`` in place, so a CUDA
    graph that holds the step reads the count Adam keeps on the device."""

    def __init__(self, schedule: Callable, device: torch.device):
        self.schedule = schedule
        self.lr = self._eval(
            torch.zeros((), dtype=torch.int32, device=device)).clone()

    def _eval(self, count: torch.Tensor) -> torch.Tensor:
        v = self.schedule(count)
        if not isinstance(v, torch.Tensor):  # a constant: a fill, no copy
            return _value(float(v), count)
        return v.to(torch.float32).reshape(())

    @torch.no_grad()
    def advance(self, count: torch.Tensor):
        self.lr.copy_(self._eval(count))
