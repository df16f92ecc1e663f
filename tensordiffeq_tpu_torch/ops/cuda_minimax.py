"""The fused minimax step's hand-written CUDA kernel K3: its plan, launch
wrapper and work counts.

Counterpart of the Pallas branch of the JAX package's
``ops/pallas_minimax.py::build_minimax_sq_fn`` (``kernel`` :193-231,
``pallas_call`` at :259).  The kernel lives in ``csrc/minimax_step.cu``
(its header note says what it computes, what bounds it on the H100 and how
the design answers it); it shares the Taylor-table device code of K1/K2
through ``csrc/taylor_common.cuh`` and is built into the same shared
library by :func:`.cuda_taylor.build`.

:func:`k3_minimax` launches it for CUDA tensors or raises; nothing here
falls back.  :func:`k3_minimax_bf16` launches its bf16-operand flavor (the
products of ``taylor_derivatives(compute_dtype=torch.bfloat16)``,
``csrc/taylor_common.cuh``) and counts its own launches, and
:func:`k3_minimax_tf32` its single-pass TF32 flavor (precision
``"default"``).  The plain flavor, the CPU path and the kernel's referee, is
``tile_sq`` in :mod:`.minimax`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_taylor as ct
from .residual_tape import ResidualTape


class MinimaxPlan(ct._Plan):
    """:class:`~.cuda_taylor._Plan` (the channel schedule and the packed
    network) plus the residual: its equation count ``E`` and its tape as C
    int and float arrays, in ``csrc/minimax_step.cu``'s layout."""

    def __init__(self, requests: set, layer_shapes: Sequence[tuple],
                 tape: ResidualTape):
        super().__init__(requests, layer_shapes)
        if tape.n_table != self.C * self.n_out:
            raise ValueError(
                f"the tape reads {tape.n_table} table columns; the plan has "
                f"{self.C} channels x {self.n_out} outputs")
        self.tape = tape
        self.E = tape.n_eq
        ints, floats = tape.encode()
        self.tape_h = (ctypes.c_int * len(ints))(*ints)
        self.cst_h = (ctypes.c_float * len(floats))(*floats)


def _check_k3_inputs(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
                     flat: torch.Tensor):
    ct._check_cuda_inputs(plan, X, flat)
    N = X.shape[0]
    if w.device != X.device:
        raise ValueError("the minimax kernel needs w on X's CUDA device")
    if w.dtype != torch.float32:
        raise TypeError("the minimax kernel takes float32 only")
    if tuple(w.shape) != (N, plan.E) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{N}, {plan.E}], got "
                         f"{tuple(w.shape)}")


def _k3(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
        flat: torch.Tensor, bf16: int):
    _check_k3_inputs(plan, X, w, flat)
    lib = ct.build()
    flavor = ct.FLAVOR_OF[bf16]
    _, tp, n_sm = plan.tile_sizes(X.device, flavor)
    N = X.shape[0]
    n_tiles = -(-N // tp)
    G = min(n_tiles, n_sm)
    opts = dict(device=X.device, dtype=torch.float32)
    gw = torch.empty((N, plan.E), **opts)
    gX = torch.empty((N, plan.d), **opts)
    part = torch.empty((G, ct.slot_stride(plan.P_total + 1)), **opts)
    ws = torch.empty((ct.workspace_floats(plan.layer_shapes, tp * plan.C,
                                          plan.ld, G, flavor),), **opts)
    out = torch.empty((plan.P_total + 1,), **opts)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    ct._check(lib.tdq_minimax_step(
        X.data_ptr(), w.data_ptr(), flat.data_ptr(), gw.data_ptr(),
        gX.data_ptr(), part.data_ptr(), ws.data_ptr(), out.data_ptr(), N, tp,
        G, plan.net_h, plan.sched_h, plan.tape_h, plan.cst_h, bf16, stream),
        "minimax_step K3 launch")
    return out[plan.P_total], out[:plan.P_total], gw, gX


def k3_minimax(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
               flat: torch.Tensor):
    """Launch K3 (and its slot-ordered reduction of the per-block
    partials).  Returns ``(value, dflat, gw, gX)``: the scalar ``Σ_e Σ_p
    w[p,e]·f_e(p)²``, its parameter cotangent in the packed layout
    ``[P_total]``, ``gw = f² [N, E]`` and ``gX [N, d]``."""
    out = _k3(plan, X, w, flat, 0)
    k3_minimax.launches += 1
    return out


def k3_minimax_bf16(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
                    flat: torch.Tensor):
    """Launch K3's bf16-operand flavor: :func:`k3_minimax` over the table
    of ``taylor_derivatives(compute_dtype=torch.bfloat16)``, the stack's
    cotangents (the network's share of ``gX`` included) and ``dW`` rounded
    to bf16 as the reference's jaxpr rounds them."""
    out = _k3(plan, X, w, flat, 1)
    k3_minimax_bf16.launches += 1
    return out


def k3_minimax_tf32(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
                    flat: torch.Tensor):
    """Launch K3's single-pass TF32 flavor (precision ``"default"``): every
    product on TF32-rounded operands in one tensor-core pass, f32 sums; its
    referee is the plain flavor over ``taylor_derivatives(emulate_tf32=
    True)``."""
    out = _k3(plan, X, w, flat, 2)
    k3_minimax_tf32.launches += 1
    return out


k3_minimax.launches = 0
k3_minimax_bf16.launches = 0
k3_minimax_tf32.launches = 0
ct.COUNTED.extend([k3_minimax, k3_minimax_bf16, k3_minimax_tf32])
# K3 of each flavor
FLAVORS = {None: k3_minimax, torch.bfloat16: k3_minimax_bf16,
           ct.TF32: k3_minimax_tf32}


def tensor_passes(plan: MinimaxPlan, compute_dtype=None) -> float:
    """Tensor-core passes per product of K3, averaged over its
    ``flop_count`` ``tensor`` share (:func:`.cuda_taylor.tensor_passes`):
    K2's products and the head's forward product, one pass in the bf16
    flavor."""
    k2 = ct.tensor_passes(plan, compute_dtype)["k2"]
    if ct.flavor_of(compute_dtype) != torch.bfloat16:
        return k2
    tc = ct._tensor_products(plan)
    k2_tc = sum(tc[:-1]) + 2 * sum(tc)
    head = tc[-1]
    return (k2 * k2_tc + head) / (k2_tc + head) if k2_tc + head else 1.0


def flop_count(plan: MinimaxPlan, n_points: int) -> dict:
    """Float operations K3's function needs for ``n_points`` points, split
    as :func:`.cuda_taylor.flop_count` splits K2's: K2's (the hidden
    layers' forward once, the weight and input cotangent products, the
    transposed Faà di Bruno lines, the sums), the head's product (on the
    tensor cores only if wider than ``NARROW_N``), and per point the tape
    forward and reverse plus, per equation, ``f²``, ``w·f²`` into the value
    and the seed ``2·w·f``."""
    fi, fo = plan.layer_shapes[-1]
    head = 2 * plan.C * fi * fo
    head_tc = head if fo > ct.NARROW_N else 0
    fwd, rev = plan.tape.flops()
    k2 = ct.flop_count(plan, n_points)["k2"]
    return {"k3": {"tensor": k2["tensor"] + n_points * head_tc,
                   "simt": k2["simt"] + n_points * (head - head_tc + fwd + rev
                                                    + 5 * plan.E)}}


def byte_count(plan: MinimaxPlan, n_points: int) -> dict:
    """Bytes K3 must move at least: X, w and the parameters in; the value,
    the parameter cotangents, gw and gX out.  The table's round trip is
    not counted: K3 exists to remove it (its partials and workspace are
    its own choice and not counted either)."""
    x = 4 * n_points * plan.d
    w = 4 * n_points * plan.E
    params = 4 * plan.P_total
    return {"k3": (x + w + params) + (4 + params + w + x)}
