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
``"default"``).  Every flavor runs on the persistent wgmma route of
``csrc/wg_backward.cuh`` where its shape allows
(:func:`.cuda_taylor.wb_plan`), the f32 and TF32 ones at hidden widths
129-256 on ``csrc/wg_backward_wide.cuh``.  The plain flavor, the CPU path and the
kernel's referee, is ``tile_sq`` in :mod:`.minimax`.

On that route K3 also runs over a member axis: :func:`k3_minimax_family`
(and its bf16 and TF32 flavors) launches it once for ``M`` networks of one
architecture whose residual tapes share their ops (a surrogate factory's
tape group, :func:`.minimax.build_family_sq_fn`), each member's outputs
bit for bit its single launch's (:class:`FamilyLaunch`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

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
    N = X.shape[0]
    wp = plan.wb_route(X.device, ct.FLAVOR_OF[bf16], N, "k3")
    if wp is None:
        return k3_mma(plan, X, w, flat, bf16)
    opts = dict(device=X.device, dtype=torch.float32)
    gw = torch.empty((N, plan.E), **opts)
    gX = torch.empty((N, plan.d), **opts)
    out = torch.empty((plan.P_total + 1,), **opts)
    part = torch.empty((wp.grid, ct.slot_stride(plan.P_total + 1)), **opts)
    ws = torch.empty((max(wp.ws_floats, 1),), **opts)
    ct._check(ct.build().tdq_minimax_wg(
        X.data_ptr(), w.data_ptr(), flat.data_ptr(), gw.data_ptr(),
        gX.data_ptr(), part.data_ptr(), ws.data_ptr(), out.data_ptr(), N,
        plan.net_h, plan.sched_h, plan.tape_h, plan.cst_h, bf16,
        (ctypes.c_int * len(wp))(*wp),
        torch.cuda.current_stream(X.device).cuda_stream),
        "minimax_wg K3 launch")
    return out[plan.P_total], out[:plan.P_total], gw, gX


def k3_mma(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
           flat: torch.Tensor, code: int):
    """K3 in flavor ``code`` on its ``mma.sync`` kernel
    (``csrc/minimax_step.cu``): the launch the wrappers make where the
    wgmma route declines the shape.  ``chip_smoke.py`` also calls it at a
    shape the route takes, to time the kernel the route replaced; it
    counts no launch.  Returns ``(value, dflat, gw, gX)``."""
    N = X.shape[0]
    opts = dict(device=X.device, dtype=torch.float32)
    gw = torch.empty((N, plan.E), **opts)
    gX = torch.empty((N, plan.d), **opts)
    out = torch.empty((plan.P_total + 1,), **opts)
    flavor = ct.FLAVOR_OF[code]
    _, tp, n_sm = plan.tile_sizes(X.device, flavor)
    n_tiles = -(-N // tp)
    G = min(n_tiles, n_sm)
    part = torch.empty((G, ct.slot_stride(plan.P_total + 1)), **opts)
    ws = torch.empty((ct.workspace_floats(plan.layer_shapes, tp * plan.C,
                                          plan.ld, G, flavor),), **opts)
    ct._check(ct.build().tdq_minimax_step(
        X.data_ptr(), w.data_ptr(), flat.data_ptr(), gw.data_ptr(),
        gX.data_ptr(), part.data_ptr(), ws.data_ptr(), out.data_ptr(), N, tp,
        G, plan.net_h, plan.sched_h, plan.tape_h, plan.cst_h, code,
        torch.cuda.current_stream(X.device).cuda_stream),
        "minimax_step K3 launch")
    return out[plan.P_total], out[:plan.P_total], gw, gX


def k3_minimax(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
               flat: torch.Tensor):
    """Launch K3 (and its slot-ordered reduction of the per-block
    partials).  Returns ``(value, dflat, gw, gX)``: the scalar ``Σ_e Σ_p
    w[p,e]·f_e(p)²``, its parameter cotangent in the packed layout
    ``[P_total]``, ``gw = f² [N, E]`` and ``gX [N, d]``.  Its route is
    chosen by shape as K2's (:meth:`~.cuda_taylor._Plan.wb_route`, recorded
    in ``plan.k3_routes[None]``): the persistent wgmma kernel of
    ``csrc/wg_backward.cuh``, or ``minimax_step.cu``'s."""
    out = _k3(plan, X, w, flat, 0)
    k3_minimax.launches += 1
    return out


def k3_minimax_bf16(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
                    flat: torch.Tensor):
    """Launch K3's bf16-operand flavor: :func:`k3_minimax` over the table
    of ``taylor_derivatives(compute_dtype=torch.bfloat16)``, the stack's
    cotangents (the network's share of ``gX`` included) and ``dW`` rounded
    to bf16 as the reference's jaxpr rounds them.  Its route is chosen by
    shape as K2-bf16's (:meth:`~.cuda_taylor._Plan.wb_route`, recorded in
    ``plan.k3_routes[torch.bfloat16]``): the persistent wgmma kernel of
    ``csrc/wg_backward.cuh``, or ``minimax_step.cu``'s."""
    out = _k3(plan, X, w, flat, 1)
    k3_minimax_bf16.launches += 1
    return out


def k3_minimax_tf32(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
                    flat: torch.Tensor):
    """Launch K3's single-pass TF32 flavor (precision ``"default"``): every
    product on TF32-rounded operands in one tensor-core pass, f32 sums; its
    referee is the plain flavor over ``taylor_derivatives(emulate_tf32=
    True)``.  Its route is chosen by shape as K2-TF32's
    (:meth:`~.cuda_taylor._Plan.wb_route`, recorded in
    ``plan.k3_routes``): the persistent wgmma kernel of
    ``csrc/wg_backward.cuh`` (``csrc/wg_backward_wide.cuh`` at hidden
    widths 129-256), or ``minimax_step.cu``'s."""
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


# ------------------------------------------------------------------ #
# K3 over a member axis: one launch for M networks of one architecture
# and one tape's ops (a surrogate factory's tape group)
# ------------------------------------------------------------------ #
class FamilyLaunch(NamedTuple):
    """The member-axis launch of K3's wgmma route (``csrc/wg_backward.cuh``,
    ``wb_body_k3``): each member keeps the single launch's partition into
    ``G`` virtual blocks (its :class:`~.cuda_taylor.WbPlan`'s ``grid``);
    ``grid`` persistent blocks walk the ``items = M·G`` work items (member
    ``j // G``, virtual block ``j % G``), block ``k`` the items ``k, k +
    grid, ...``; item ``j`` writes slot ``j``."""
    G: int          # virtual blocks a member (the single launch's grid)
    items: int      # work items: M·G, one partial slot each
    grid: int       # persistent blocks: min(items, SMs)
    ws_floats: int  # the blocks' Q slices, then the M members' planes


def family_launch(plan: MinimaxPlan, wp: ct.WbPlan, M: int,
                  n_sm: int) -> FamilyLaunch:
    """:class:`FamilyLaunch` of ``M`` members at the route's plan ``wp``
    on a card of ``n_sm`` SMs."""
    grid = min(M * wp.grid, n_sm)
    L = len(plan.layer_shapes)
    return FamilyLaunch(wp.grid, M * wp.grid, grid,
                        grid * (L - 1) * ct.wb_tile_rows(wp.NP) * wp.NP
                        + M * wp.P * wp.stage_bytes // 4)


def family_items(fl: FamilyLaunch, block: int) -> list:
    """The work items ``(member, virtual block)`` persistent block
    ``block`` runs, in its order."""
    return [divmod(j, fl.G) for j in range(block, fl.items, fl.grid)]


def _k3_family(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
               flat: torch.Tensor, cst: torch.Tensor, code: int):
    if X.device.type != "cuda" or any(t.device != X.device
                                      for t in (w, flat, cst)):
        raise ValueError("the member-axis minimax kernel needs X, w, the "
                         "parameters and the constants on one CUDA device")
    if any(t.dtype != torch.float32 for t in (X, w, flat, cst)):
        raise TypeError("the minimax kernel takes float32 only")
    if X.ndim != 3 or X.shape[0] == 0 or X.shape[1] == 0 \
            or X.shape[2] != plan.d:
        raise ValueError(f"X must be [M>0, N>0, {plan.d}], got "
                         f"{tuple(X.shape)}")
    M, N = int(X.shape[0]), int(X.shape[1])
    for name, t, shape in (("w", w, (M, N, plan.E)),
                           ("the parameters", flat, (M, plan.P_total)),
                           ("the constants", cst,
                            (M, ct.MAX_TAPE_CONSTS))):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(shape)}, "
                             f"got {tuple(t.shape)}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    flavor = ct.FLAVOR_OF[code]
    wp = plan.wb_route(X.device, flavor, N, "k3")
    if wp is None:
        raise ct.KernelLaunchError(
            "the member-axis minimax kernel runs on the wgmma route only; "
            f"{plan.layer_shapes} with {plan.C} channels is off it (launch "
            "each member's K3)")
    fl = family_launch(plan, wp, M, plan.card(X.device)[1])
    lib = ct.build()
    opts = dict(device=X.device, dtype=torch.float32)
    gw = torch.empty((M, N, plan.E), **opts)
    gX = torch.empty((M, N, plan.d), **opts)
    out = torch.empty((M, plan.P_total + 1), **opts)
    part = torch.empty((fl.items, ct.slot_stride(plan.P_total + 1)), **opts)
    ws = torch.empty((max(fl.ws_floats, 1),), **opts)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    ct._check(lib.tdq_minimax_wg_family(
        X.data_ptr(), w.data_ptr(), flat.data_ptr(), gw.data_ptr(),
        gX.data_ptr(), part.data_ptr(), ws.data_ptr(), out.data_ptr(), N, M,
        fl.grid, plan.net_h, plan.sched_h, plan.tape_h, cst.data_ptr(), code,
        (ctypes.c_int * len(wp))(*wp), stream),
        "minimax_wg member-axis K3 launch")
    return out[:, plan.P_total], out[:, :plan.P_total], gw, gX


def k3_minimax_family(plan: MinimaxPlan, X: torch.Tensor, w: torch.Tensor,
                      flat: torch.Tensor, cst: torch.Tensor):
    """Launch K3 over a member axis (:class:`FamilyLaunch`): ``M``
    networks of ``plan``'s architecture whose tapes share ``plan``'s ops,
    on ``X [M, N, d]``, ``w [M, N, E]``, their packed parameters ``flat
    [M, P_total]`` and tape constants ``cst [M, MAX_TAPE_CONSTS]`` (each
    member's ``ResidualTape.encode()`` floats), all on the card.  Returns
    ``(value [M], dflat [M, P_total], gw [M, N, E], gX [M, N, d])``, each
    member's bit for bit :func:`k3_minimax`'s on its slice.  The wgmma
    route's shapes only: elsewhere it raises
    :class:`~.cuda_taylor.KernelLaunchError`."""
    out = _k3_family(plan, X, w, flat, cst, 0)
    k3_minimax_family.launches += 1
    return out


def k3_minimax_family_bf16(plan: MinimaxPlan, X: torch.Tensor,
                           w: torch.Tensor, flat: torch.Tensor,
                           cst: torch.Tensor):
    """:func:`k3_minimax_family` in K3's bf16-operand flavor: each member's
    outputs bit for bit :func:`k3_minimax_bf16`'s."""
    out = _k3_family(plan, X, w, flat, cst, 1)
    k3_minimax_family_bf16.launches += 1
    return out


def k3_minimax_family_tf32(plan: MinimaxPlan, X: torch.Tensor,
                           w: torch.Tensor, flat: torch.Tensor,
                           cst: torch.Tensor):
    """:func:`k3_minimax_family` in K3's single-pass TF32 flavor: each
    member's outputs bit for bit :func:`k3_minimax_tf32`'s."""
    out = _k3_family(plan, X, w, flat, cst, 2)
    k3_minimax_family_tf32.launches += 1
    return out


k3_minimax_family.launches = 0
k3_minimax_family_bf16.launches = 0
k3_minimax_family_tf32.launches = 0
ct.COUNTED.extend([k3_minimax_family, k3_minimax_family_bf16,
                   k3_minimax_family_tf32])
# the member-axis K3 of each flavor
FAMILY_FLAVORS = {None: k3_minimax_family,
                  torch.bfloat16: k3_minimax_family_bf16,
                  ct.TF32: k3_minimax_family_tf32}


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
