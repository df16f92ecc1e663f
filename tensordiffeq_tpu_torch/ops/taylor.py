"""Stacked Taylor-mode derivative propagation for tanh MLPs — the plain flavor.

Counterpart of the JAX package's ``ops/taylor.py``.  ONE wavefront goes
through the MLP carrying the primal together with every requested
directional derivative — first, second, arbitrary (mixed) third, and
unmixed fourth order.  Per layer all channels share one matmul, and the
tanh derivative chain ``d1 = 1-z², d2 = -2·z·d1, d3 = -2·d1·(1-3z²),
d4 = -2·d2·(1-3z²) + 12·z·d1²`` combines the channels by Faà di Bruno (the
collapsing recurrence of arXiv:2505.13644: each order is built from the
already-propagated lower orders of the same layer).

This module is the plain PyTorch version of the Taylor-table kernels
(:mod:`.cuda_taylor`): the CPU path, and the referee the kernels are held
against on the card.  Its loss gradient is ordinary autograd through the
propagation.

``compute_dtype=torch.bfloat16`` is the mixed-precision flavor of the JAX
package's ``taylor_derivatives(compute_dtype=jnp.bfloat16)``: each layer's
product takes the channel stack and ``W`` rounded to bf16 and sums in f32
(``preferred_element_type=float32`` there).  Written as a round trip
through bf16 and an f32 product under IEEE f32: the product of two bf16
values is exact in f32, and autograd of the round-trip casts rounds the
stack's cotangent and each ``dW`` to bf16 exactly where the JAX jaxpr's
casts do.  (A product of bf16 tensors would round the *output* to bf16,
which the JAX flavor never does.)

``precision=`` is the network's (:func:`~..utils.resolve_precision`):
on CUDA tensors the products run at it (TF32 for ``"default"``, IEEE
float32 for ``"high"``/``"highest"``); on the CPU every precision computes
IEEE float32, as the JAX package does on its CPU.  ``emulate_tf32=True`` is
the TF32-emulating mode, the referee of the kernels' single-pass TF32
flavor: every product (the forward's, and in the backward pass the
cotangent's products) takes both operands rounded as ``cvt.rna.tf32.f32``
rounds them (:func:`rna_tf32`) and sums in float32; the product of two
TF32 values is exact in float32, so it computes the same on any device.
``emulate_tf32="float64"`` sums the same products in float64: the order
witness.  Rounding every layer's input to TF32 is discontinuous, so two
sum orders of the same semantics (the kernels', this mode's, the
witness's) round a few operands that sit on a TF32 rounding boundary to
neighbouring values, a TF32 unit apart; the witness measures how far that
alone takes two tables apart on given inputs.

Derivative requests are canonical multi-indices: sorted tuples of coordinate
positions, e.g. ``()`` primal, ``(0,)`` = u_x, ``(0, 1)`` = u_xt,
``(0, 0, 1)`` = u_xxt, ``(0, 0, 0, 0)`` = u_xxxx.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import matmul_precision

MultiIndex = tuple  # sorted tuple of coordinate indices


def canonical(idx: Sequence[int]) -> MultiIndex:
    """Canonical (sorted) multi-index — mixed partials commute for the smooth
    networks we differentiate."""
    return tuple(sorted(idx))


def supported(idx: Sequence[int]) -> bool:
    """Orders handled by the propagation: everything to 3rd order (mixed
    included), plus unmixed 4th order."""
    idx = canonical(idx)
    if len(idx) <= 3:
        return True
    return len(idx) == 4 and len(set(idx)) == 1


def closure(requests: set) -> tuple[list, list, list, list]:
    """Ingredient closure: every channel a requested derivative needs (each
    order's Faà di Bruno recurrence consumes every lower-order channel over
    the same index subsets).  Returns ``(firsts, seconds, thirds, fourths)``
    as sorted canonical lists."""
    firsts, seconds, thirds, fourths = set(), set(), set(), set()
    for idx in requests:
        idx = canonical(idx)
        if len(idx) == 1:
            firsts.add(idx)
        elif len(idx) == 2:
            seconds.add(idx)
        elif len(idx) == 3:
            thirds.add(idx)
        elif len(idx) == 4:
            fourths.add(idx)
    for (k, _, _, _) in fourths:  # unmixed: one lower-order chain
        thirds.add((k, k, k))
    for (i, j, k) in thirds:  # all pairwise seconds feed the recurrence
        seconds.update({canonical((i, j)), canonical((i, k)),
                        canonical((j, k))})
    for (i, j) in seconds:
        firsts.update({(i,), (j,)})
    return sorted(firsts), sorted(seconds), sorted(thirds), sorted(fourths)


def channel_order(requests: set) -> list:
    """The wavefront's channels in stacking order: primal, then the
    closure's firsts, seconds, thirds, fourths."""
    firsts, seconds, thirds, fourths = closure(set(map(canonical, requests)))
    return [()] + firsts + seconds + thirds + fourths


def extract_mlp_layers(params) -> Optional[list]:
    """``[(W, b), ...]`` from an :class:`~..networks.MLP`, a list of ``(W,
    b)`` pairs, or the MLP's flat parameter list ``[W_0, b_0, W_1, ...]``
    (what its ``params()`` gives and ``apply`` takes); ``None`` if the
    structure doesn't match."""
    if hasattr(params, "layers") and callable(params.layers):
        return params.layers()
    if not isinstance(params, (list, tuple)) or not params:
        return None
    if all(isinstance(p, (list, tuple)) and len(p) == 2
           and all(isinstance(a, torch.Tensor) for a in p) for p in params):
        return [tuple(p) for p in params]
    if len(params) % 2 == 0 and all(
            isinstance(a, torch.Tensor) for a in params) and all(
            W.ndim == 2 and b.ndim == 1 and b.shape[0] == W.shape[1]
            for W, b in zip(params[0::2], params[1::2])):
        return list(zip(params[0::2], params[1::2]))
    return None


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to its dtype: a
    product operand of the mixed-precision flavor."""
    return t.to(torch.bfloat16).to(t.dtype)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 ``x``: the magnitude rounded half
    away from zero to 10 mantissa bits (half of the 13 dropped bits' unit
    added to the magnitude bits, then those bits cleared; the sign bit is
    untouched), as the kernels' ``tf32_bits``/``split_tf32`` do."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register given as a TF32
    operand: its low 13 bits cleared (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded by :func:`rna_tf32`, the sums in
    ``sums`` (IEEE float32, or float64 for the order witness); its backward
    takes the cotangent rounded too, against the rounded operands (a TF32
    product's transposes are TF32 products)."""

    @staticmethod
    def forward(ctx, a, b, sums):
        ar, br = rna_tf32(a), rna_tf32(b)
        ctx.save_for_backward(ar, br)
        ctx.sums = sums
        with matmul_precision("highest"):
            return (ar.to(sums) @ br.to(sums)).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        s = ctx.sums
        gr = rna_tf32(g).to(s)
        da = db = None
        with matmul_precision("highest"):
            if ctx.needs_input_grad[0]:
                da = (gr @ br.to(s).transpose(-1, -2)).to(g.dtype)
            if ctx.needs_input_grad[1]:
                db = (ar.reshape(-1, ar.shape[-1]).to(s).t()
                      @ gr.reshape(-1, gr.shape[-1])).to(g.dtype)
        return da, db, None


def tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                sums: torch.dtype = torch.float32) -> torch.Tensor:
    """``a [..., k] @ b [k, n]`` as one TF32 pass takes it: both operands
    rounded to TF32, float32 sums (``sums=torch.float64``: the same
    products summed in float64, the witness of how far two sum orders of
    the same TF32 semantics fall apart), and the same rule for the
    cotangent's products (the TF32-emulating mode of
    :func:`taylor_derivatives`)."""
    return _Tf32Matmul.apply(a, b, sums)


def taylor_derivatives(layers: list, X: torch.Tensor, requests: set,
                       flat_matmul: bool = False,
                       compute_dtype: Optional[torch.dtype] = None,
                       precision="highest",
                       emulate_tf32: bool = False) -> dict:
    """Evaluate the MLP and all ``requests`` derivatives in one propagation.

    Args:
      layers: ``[(W [in, out], b [out]), ...]``; tanh between layers, linear
        head.
      X: ``[N, d]`` evaluation points.
      requests: set of canonical multi-indices (see :func:`supported`).
      flat_matmul: collapse the channel stack into the point axis for each
        layer matmul (``[C·N, in] @ W`` instead of the batched
        ``[C, N, in] @ W``) — the layout the kernels use.
      compute_dtype: ``None`` (float32 products) or ``torch.bfloat16``:
        the mixed-precision flavor (module docstring); every pointwise op
        stays float32.  Its products run in IEEE float32 whatever the
        precision (TF32 would round them a second time).
      precision: the network's matmul precision (module docstring); it
        matters only for CUDA tensors.
      emulate_tf32: the TF32-emulating mode (module docstring), the
        referee of the kernels' TF32 flavor; ``"float64"``: its products
        summed in float64 (the order witness).  Not with
        ``compute_dtype``.

    Returns ``{multi_index: [N, n_out] tensor}`` for every channel of the
    closure, including the primal ``()``.
    """
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype={compute_dtype!r}: expected None "
                         "or torch.bfloat16")
    if emulate_tf32 and compute_dtype is not None:
        raise ValueError("emulate_tf32 is the float32 products' TF32 "
                         "flavor; it does not combine with compute_dtype")
    if compute_dtype is not None or emulate_tf32:
        precision = "highest"  # the operands carry the rounding
    with matmul_precision(precision):
        return _propagate(layers, X, requests, flat_matmul, compute_dtype,
                          emulate_tf32)


def _propagate(layers, X, requests, flat_matmul, compute_dtype,
               emulate_tf32) -> dict:
    N, d = X.shape
    firsts, seconds, thirds, fourths = closure(set(map(canonical, requests)))

    Z = X
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    T = {idx: eye[idx[0]].expand(N, d) for idx in firsts}
    zero = torch.zeros_like(X)
    S = {idx: zero for idx in seconds}
    U = {idx: zero for idx in thirds}
    F = {idx: zero for idx in fourths}

    order = [("z", ())] + [("t", i) for i in firsts] + \
            [("s", i) for i in seconds] + [("u", i) for i in thirds] + \
            [("f", i) for i in fourths]

    n_layers = len(layers)
    for li, (W, b) in enumerate(layers):
        stacked = torch.stack(
            [Z] + [T[i] for i in firsts] + [S[i] for i in seconds]
            + [U[i] for i in thirds] + [F[i] for i in fourths],
            dim=0)  # [C, N, w_in]
        if compute_dtype is not None:
            stacked, W = bf16_round(stacked), bf16_round(W)
        if emulate_tf32:
            C = stacked.shape[0]
            # tdq: allow[dtype-discipline] the float64-summed twin of the TF32 flavor's referee (the order witness); never a kernel's path
            sums = torch.float64 if emulate_tf32 == "float64" \
                else torch.float32
            out = tf32_matmul(stacked.reshape(C * N, -1), W,
                              sums).reshape(C, N, -1)
        elif flat_matmul:
            C = stacked.shape[0]
            out = (stacked.reshape(C * N, -1) @ W).reshape(C, N, -1)
        else:
            out = torch.matmul(stacked, W)
        chunks = dict(zip(order, out.unbind(0)))
        P = chunks[("z", ())] + b
        Q = {i: chunks[("t", i)] for i in firsts}
        R = {i: chunks[("s", i)] for i in seconds}
        V = {i: chunks[("u", i)] for i in thirds}
        G = {i: chunks[("f", i)] for i in fourths}

        if li == n_layers - 1:  # linear head: channels pass through
            Z, T, S, U, F = P, Q, R, V, G
            break

        Z = torch.tanh(P)
        d1 = 1.0 - Z * Z
        d2 = -2.0 * Z * d1
        d3 = -2.0 * d1 * (1.0 - 3.0 * Z * Z)
        T = {i: d1 * Q[i] for i in firsts}
        S = {(i, j): d1 * R[(i, j)] + d2 * Q[(i,)] * Q[(j,)]
             for (i, j) in seconds}

        def q(k):
            return Q[(k,)]

        def r(i, j):
            return R[canonical((i, j))]

        # Faà di Bruno, third order over directions (i, j, k):
        # (tanh∘g)_ijk = d3·gᵢgⱼg_k + d2·(g_ij·g_k + g_ik·g_j + g_jk·g_i)
        #               + d1·g_ijk
        U = {(i, j, k): (d3 * q(i) * q(j) * q(k)
                         + d2 * (r(i, j) * q(k) + r(i, k) * q(j)
                                 + r(j, k) * q(i))
                         + d1 * V[(i, j, k)])
             for (i, j, k) in thirds}
        if fourths:
            d4 = -2.0 * d2 * (1.0 - 3.0 * Z * Z) + 12.0 * Z * d1 * d1
            # unmixed fourth order along k:
            # (tanh∘g)_kkkk = d1·g_kkkk + 4·d2·g_kkk·g_k + 3·d2·g_kk²
            #                + 6·d3·g_kk·g_k² + d4·g_k⁴
            F = {(k, _k2, _k3, _k4): (d1 * G[(k, k, k, k)]
                                      + 4.0 * d2 * V[(k, k, k)] * q(k)
                                      + 3.0 * d2 * r(k, k) * r(k, k)
                                      + 6.0 * d3 * r(k, k) * q(k) * q(k)
                                      + d4 * q(k) ** 4)
                 for (k, _k2, _k3, _k4) in fourths}
        else:
            F = {}

    table = {(): Z}
    table.update({i: T[i] for i in firsts})
    table.update({i: S[i] for i in seconds})
    table.update({i: U[i] for i in thirds})
    table.update({i: F[i] for i in fourths})
    return table
