"""K2's and K3's persistent wgmma route (``csrc/wg_backward.cuh``) in its
TF32, f32 (3xTF32) and bf16 flavors, the parts that live on the host and
the algorithm it runs, on the CPU:

* the plan's mirror (``ops/cuda_taylor.py::wb_plan``): tile rows, stages,
  shared memory, workspace, and the choice of route by shape and flavor;
* the plain mirror of the weight planes (``wb_prepare``): the forward
  planes are K1's chunks of the flavor (W^T), the backward planes W in the
  sweep's order, in core-matrix and k-slot order; TF32 (``cvt.rna``), or
  the f32 flavor's hi and lo planes, which sum back to W; the bf16
  flavor's W rounded to bf16 in natural k order;
* the route's K2 step for step in PyTorch (tiles of 128 rows with the
  channels padded, the operands of dW written K-major as the kernel writes
  them, the block's slot added to in tile order, the slots summed in slot
  order): in float64 it is autograd's gradient to 1e-10; with TF32
  operands and float32 sums it stays within the TF32 flavor's band of the
  TF32-emulating referee, and the JAX package's float32 (HIGHEST) result is
  printed beside it; in the f32 flavor's order (three passes a product:
  split_tf32 for the forward and dH, the truncating split of dW's in-place
  lo planes) it is within the f32 band (1e-4 scale-relative) of the float64
  referee and within the cross-check's rtol 5e-3 of the JAX package;
* K3 on the route in the f32 flavor (the route's forward, the tape's
  epilogue, the route's K2 on the tape's cotangents): within the f32 band
  of the float64 plain flavor and within rtol 5e-3 of the JAX package's
  ``build_minimax_sq_fn`` (XLA) on the same weights;
* K2 and K3 on the route in the bf16 flavor's order (one bf16 pass a
  forward product; the f32 cotangent's three bf16 pieces for dH and dW;
  dH, dX's network share and, after the slot sum, dW rounded to bf16):
  within the reference's bf16 bands of the plain bf16 flavor and of the
  JAX package's (``compute_dtype=bfloat16``) on the same weights, and
  nearer each than its f32 flavor by RMS;
* the register VJP's in-place order (``wb_act_vjp``) against the
  activation pass's autograd;
* the TF32 flavor at NP = 256 (``csrc/wg_backward_wide.cuh``): its plan,
  and K2 and K3 in its order (64-row tiles, one rounded pass a product,
  each 32 k rows summed apart) within the TF32 band of the emulation and
  its float64-summed twin, nearer them than the JAX package's IEEE
  float32 result, and over a member axis bit for bit each member's.

The kernels run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phases 3-5 and 14-17.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensordiffeq_tpu as tdq
from tensordiffeq_tpu.networks import neural_net as jax_net
from tensordiffeq_tpu.ops import pallas_minimax as jmm
from tensordiffeq_tpu.ops.fused import analyze_f_model as jax_analyze
from tensordiffeq_tpu.ops.taylor import extract_mlp_layers
from tensordiffeq_tpu.ops.taylor import taylor_derivatives as jax_table
from tensordiffeq_tpu_torch import grad
from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
from tensordiffeq_tpu_torch.ops import minimax
from tensordiffeq_tpu_torch.ops.fused import analyze_f_model, crosscheck_grads
from tensordiffeq_tpu_torch.ops.taylor import (channel_order, rna_tf32,
                                                taylor_derivatives)
from tensordiffeq_tpu_torch.weights import params_from_jax

SMEM, SMS = 232_448, 132  # an H100's opt-in shared memory a block, SMs
AC = {(), (1,), (0, 0)}
MIXED = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}
# the TF32 flavor's band (tests/test_torch_cuda.py, chip_smoke.py)
TF32_SPREAD, TF32_FLOOR = 3.0, 1e-4
# the f32 flavor's band against the IEEE plain flavor, scale-relative
# (chip_smoke.py's K2_RTOL/K3_RTOL), and the engines' cross-check rtol
F32_BAND, CROSSCHECK_RTOL = 1e-4, 5e-3
F32, TF32 = ct.FLAVOR_CODE[None], ct.FLAVOR_CODE[ct.TF32]
BF16 = ct.FLAVOR_CODE[torch.bfloat16]
# the reference's bf16 bands (the JAX solver's cross-check under
# fused_dtype; chip_smoke.py's BF16_VALUE_BAND, BF16_GRAD_BAND),
# scale-relative
BF16_VALUES, BF16_GRADS = 5e-2, 1.5e-1


def _plan(reqs, widths, N=50_000, smem=SMEM, n_sm=SMS, code=TF32):
    plan = ct.build_cuda_table_fn(reqs, list(zip(widths[:-1], widths[1:])),
                                  device="cpu").plan
    return plan, ct.wb_plan(plan.layer_shapes, plan.orders, code, smem, n_sm,
                            N)


def test_plan_at_the_slice_and_at_burgers():
    _, ac = _plan(AC, [2, 128, 128, 128, 128, 1])
    # tiles of 32 points at C = 4; two 32 KB chunks a hidden layer and
    # direction, twelve a tile through two stages; four staged Q slices
    assert ac == ct.WbPlan(NP=128, CP=4, KC=64, S=2, P=12, stage_bytes=32_768,
                           n_tiles=1563, grid=132, smem=205_600, bulk=1,
                           ws_floats=132 * 4 * 128 * 128 + 12 * 128 * 64)
    _, bu = _plan(AC, [2] + [20] * 8 + [1])
    assert (bu.NP, bu.CP, bu.P, bu.S, bu.stage_bytes, bu.bulk) \
        == (64, 4, 14, 8, 16_384, 1)
    assert bu.ws_floats == 132 * 8 * 128 * 64 + 14 * 64 * 64
    # the mixed request set: 8 channels, 16 points a tile
    _, mx = _plan(MIXED, [2, 128, 128, 128, 128, 1])
    assert (mx.CP, mx.n_tiles) == (8, 3125)
    # few points: one tile, one block; a net with no hidden product: no ring
    assert _plan(AC, [2, 64, 64, 1], N=5)[1][6:8] == (1, 1)
    assert _plan(AC, [2, 16, 1])[1][3:5] == (0, 0)
    # slot rows that are not 16-byte pieces: dW added from the SMs
    assert _plan(AC, [3, 50, 50, 50, 1])[1].bulk == 0
    assert _plan(AC, [2, 20, 30, 20, 1])[1].bulk == 0


def test_route_choice_by_shape():
    assert _plan(AC, [2, 128, 128, 128, 128, 1])[1] is not None
    assert _plan(AC, [2] + [20] * 8 + [1])[1] is not None
    # past 128 wide the TF32 flavor takes the NP = 256 design
    # (csrc/wg_backward_wide.cuh), as the f32 one does
    # (test_tf32_plan_at_256 holds it field for field)
    assert _plan(AC, [2, 256, 256, 256, 256, 1])[1].NP == 256
    # the mma.sync route: a hidden layer over 256, more than 8 channels,
    # more than 16 inputs or outputs, a card with room for one stage
    assert _plan(AC, [2, 257, 256, 1])[1] is None
    assert _plan({(), (0,), (2,), (1, 1), (0, 1, 2)}, [3, 64, 64, 1])[1] \
        is None
    assert _plan(AC, [17, 64, 64, 1])[1] is None
    assert _plan(AC, [2, 64, 64, 17])[1] is None
    assert _plan(AC, [2, 128, 128, 128, 1], smem=190_000)[1] is None
    # every plan fits the card it was made for
    for reqs in (AC, MIXED):
        for widths in ([2, 128, 128, 128, 128, 1], [2, 64, 64, 1],
                       [2] + [32] * 14 + [1], [16, 128, 128, 16]):
            wp = _plan(reqs, widths, 200_000)[1]
            assert wp.smem <= SMEM and 2 <= wp.S <= ct.WG_MAX_STAGES
            assert wp.P == 2 * (len(widths) - 3) * wp.NP // wp.KC


def _layers(widths, seed=0):
    g = torch.Generator().manual_seed(seed)
    flat = []
    for a, b in zip(widths[:-1], widths[1:]):
        flat += [torch.randn(a, b, generator=g) / a ** 0.5,
                 0.1 * torch.randn(b, generator=g)]
    return flat


def _cm(n, k, KC, epc=4):
    """``wg_cm_offset`` (csrc/wgmma.cuh)."""
    return ((n // 8) * (KC // epc) + k // epc) * (8 * epc) + (n % 8) * epc \
        + k % epc


@pytest.mark.parametrize("widths", [[2, 128, 128, 128, 1], [2, 37, 53, 1],
                                    [3, 20, 20, 20, 20, 2],
                                    [2, 256, 200, 256, 1]],
                         ids=["ac", "odd", "burgers-like", "wide-256"])
def test_weight_planes_round_trip(widths):
    flat = _layers(widths)
    _, wp = _plan(AC, widths)
    if wp.NP == 256:  # the NP = 256 design's chunks: 32 k rows, hi plane
        assert (wp.KC, wp.stage_bytes) == (32, 256 * 32 * 4)
    raw = ct.wb_prepare(flat, wp, ct.TF32)
    assert raw.numel() == wp.P * wp.stage_bytes
    chunks = raw.view(torch.float32).numpy().reshape(wp.P, wp.NP * wp.KC)
    assert not (chunks.view(np.uint32) & 0x1FFF).any()  # TF32
    slots = np.array(ct.wg_kslots(wp.KC, False))
    n, kq = np.arange(wp.NP)[:, None], np.arange(wp.KC)[None, :]
    off = _cm(n, kq, wp.KC)
    nch, L = wp.NP // wp.KC, len(widths) - 1
    hidden = list(range(1, L - 1))
    planes = [flat[2 * l].t() for l in hidden] \
        + [flat[2 * l] for l in reversed(hidden)]
    # the forward half is K1-TF32's chunks, byte for byte
    wg = ct.WgPlan(wp.NP, wp.CP, wp.KC, 0, wp.P // 2, 0, wp.stage_bytes, 0,
                   0, 0)
    assert torch.equal(raw[:wp.P // 2 * wp.stage_bytes],
                       ct.wg_prepare(flat, wg, ct.TF32))
    for q in range(wp.P):
        M = planes[q // nch]
        pad = np.zeros((wp.NP, wp.NP), np.float32)
        pad[:M.shape[0], :M.shape[1]] = rna_tf32(M.contiguous()).numpy()
        # k slot j of the chunk holds column h * KC + slots[j]
        want = pad[:, (q % nch) * wp.KC + slots]
        np.testing.assert_array_equal(chunks[q][off], want)


# ------------------------------------------------------------------ #
# the route's K2, step for step
# ------------------------------------------------------------------ #
def _chain(u):
    z = torch.tanh(u)
    d1 = 1 - z * z
    d2 = -2 * z * d1
    d3 = -2 * d1 * (1 - 3 * z * z)
    d4 = -2 * d2 * (1 - 3 * z * z) + 12 * z * d1 * d1
    z2 = z * z
    return z, d1, d2, d3, d4, d1 * (16 - z2 * (120 - 120 * z2))


def _act(P, rows):
    """k1w_act on [points, CP, width]: channels past len(rows) zero."""
    z, d1, d2, d3, d4, _ = _chain(P[:, 0])
    H = torch.zeros_like(P)
    for c in range(len(rows) - 1, 0, -1):
        o, ix = rows[c]
        Pc = P[:, c]
        if o == 1:
            h = d1 * Pc
        elif o == 2:
            h = d1 * Pc + d2 * P[:, ix[0]] * P[:, ix[1]]
        elif o == 3:
            qi, qj, qk, rij, rik, rjk = (P[:, i] for i in ix)
            h = (d3 * qi * qj * qk + d2 * (rij * qk + rik * qj + rjk * qi)
                 + d1 * Pc)
        else:
            q, r, v = (P[:, i] for i in ix)
            h = (d1 * Pc + 4 * d2 * v * q + 3 * d2 * r * r
                 + 6 * d3 * r * q * q + d4 * q ** 4)
        H[:, c] = h
    H[:, 0] = z
    return H


def _act_vjp_in_place(P, dH, rows):
    """``wb_act_vjp``: the cotangents overwritten channel by channel in
    ascending order (a channel's own read before any line writes it);
    channel 0 closes the chain last; pad channels zero."""
    z, d1, d2, d3, d4, d5 = _chain(P[:, 0])
    G = dH.clone()
    gz, g1, g2, g3, g4 = G[:, 0].clone(), 0, 0, 0, 0
    for c in range(1, G.shape[1]):
        if c >= len(rows):
            G[:, c] = 0
            continue
        o, ix = rows[c]
        g = G[:, c].clone()
        g1 = g1 + g * P[:, c]
        G[:, c] = g * d1
        if o == 2:
            a, b = P[:, ix[0]], P[:, ix[1]]
            g2 = g2 + g * a * b
            G[:, ix[0]] += g * d2 * b
            G[:, ix[1]] += g * d2 * a
        elif o == 3:
            qi, qj, qk, rij, rik, rjk = (P[:, i] for i in ix)
            g3 = g3 + g * qi * qj * qk
            g2 = g2 + g * (rij * qk + rik * qj + rjk * qi)
            G[:, ix[0]] += g * (d3 * qj * qk + d2 * rjk)
            G[:, ix[1]] += g * (d3 * qi * qk + d2 * rik)
            G[:, ix[2]] += g * (d3 * qi * qj + d2 * rij)
            G[:, ix[3]] += g * d2 * qk
            G[:, ix[4]] += g * d2 * qj
            G[:, ix[5]] += g * d2 * qi
        elif o == 4:
            q, r, v = (P[:, i] for i in ix)
            g2 = g2 + g * (4 * v * q + 3 * r * r)
            g3 = g3 + g * 6 * r * q * q
            g4 = g4 + g * q ** 4
            G[:, ix[0]] += g * (4 * d2 * v + 12 * d3 * r * q + 4 * d4 * q ** 3)
            G[:, ix[1]] += g * (6 * d2 * r + 6 * d3 * q * q)
            G[:, ix[2]] += g * 4 * d2 * q
    G[:, 0] = gz * d1 + g1 * d2 + g2 * d3 + g3 * d4 + g4 * d5
    return G


@pytest.mark.parametrize("reqs", [AC, MIXED], ids=["ac", "mixed"])
def test_register_vjp_in_place_is_the_activation_pass_transpose(reqs):
    _, rows = ct.channel_schedule(reqs)
    CP = 1
    while CP < len(rows):
        CP *= 2
    g = torch.Generator().manual_seed(1)
    P = torch.randn(9, CP, 5, generator=g, dtype=torch.float64)
    P[:, len(rows):] = 0
    dH = torch.randn(9, CP, 5, generator=g, dtype=torch.float64)
    Pg = P.clone().requires_grad_(True)
    want = torch.autograd.grad((_act(Pg, rows) * dH).sum(), Pg)[0]
    got = _act_vjp_in_place(P, dH, rows)
    want[:, len(rows):] = 0  # pad channels carry nothing
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _kmajor(M):
    """A tile's [R rows, NP] operand as wb_put_kmajor (R = 128) or
    wbw_put_pt (R = 64, NP = 256) writes it (feature n's rows r at
    wg_cm_offset(n, r, R, 4)), read back as [NP, R]."""
    R, NP = M.shape
    buf = torch.zeros(NP * R, dtype=M.dtype)
    r, n = np.meshgrid(np.arange(R), np.arange(NP), indexing="ij")
    off = torch.from_numpy(_cm(n, r, R).reshape(-1))
    buf[off] = M.reshape(-1)
    back = torch.from_numpy(_cm(np.arange(NP)[:, None],
                                np.arange(R)[None, :], R))
    return buf[back.reshape(-1)].view(NP, R)


def _wbw_ht_offset(f, r):
    """``wbw_ht_offset`` (csrc/wg_backward_wide.cuh): element (f, r) of the
    NP = 256 route's H^T, feature f's 64 rows in float4s of rows t, t + 4,
    t + 8, t + 12 of each 16, swizzled by f."""
    q = 4 * (r >> 4) + (r & 3)
    sw = 4 * ((f ^ (f >> 1)) & 1)
    return f * 64 + 4 * (q ^ sw) + ((r >> 2) & 3)


def _ht_wide(M):
    """A tile's [64 rows, 256] layer input as wbw_put_ht writes H^T and
    wbw_load_a reads dW's A fragments back (the float4 at feature f's
    offset of row 16 s + t holds rows 16 s + t + 4 v), as [256, 64]."""
    R, NP = M.shape
    buf = torch.zeros(NP * R, dtype=M.dtype)
    r, f = np.meshgrid(np.arange(R), np.arange(NP), indexing="ij")
    buf[torch.from_numpy(_wbw_ht_offset(f, r).reshape(-1))] = M.reshape(-1)
    out = torch.empty(NP, R, dtype=M.dtype)
    for sg in range(R // 16):
        for t in range(4):
            base = _wbw_ht_offset(np.arange(NP), 16 * sg + t) & ~3
            for v in range(4):
                out[:, 16 * sg + t + 4 * v] = buf[torch.from_numpy(base + v)]
    return out


def test_wide_operand_layouts_feed_the_products():
    """NP = 256 (csrc/wg_backward_wide.cuh): H^T's swizzled layout is a
    permutation of the 256 x 64 elements and dW's A loads read each
    feature's rows back; the exchange buffer's k slots (wbw_put_rows) are
    the weight planes' (wg_kslot), so register i of lane t lands on the k
    row that holds its column."""
    f, r = np.meshgrid(np.arange(256), np.arange(64), indexing="ij")
    off = _wbw_ht_offset(f, r).reshape(-1)
    assert sorted(off.tolist()) == list(range(256 * 64))
    M = torch.randn(64, 256, generator=torch.Generator().manual_seed(5))
    assert torch.equal(_ht_wide(M), M.t())
    slots = ct.wg_kslots(128, False)
    for i in range(64):
        for t in range(4):
            col = 8 * (i >> 2) + 2 * t + (i & 1)  # acc_col
            k = 8 * (i >> 2) + (t + 4 if i & 1 else t)
            assert slots[k] == col


def _tc(t):
    """A float32 operand as the tensor cores read it: its low 13 bits
    dropped (``tf32_trunc`` in ``csrc/wg_backward.cuh``)."""
    return (t.view(torch.int32) & -8192).view(torch.float32)


def _mm3(A, B, split):
    """A B as the f32 flavor's three TF32 passes, lo hi + hi lo + hi hi,
    each lo read by the tensor cores (``_tc``)."""
    (ah, al), (bh, bl) = split(A), split(B)
    return _tc(al) @ bh + ah @ _tc(bl) + ah @ bh


def _rna_split(t):  # split_tf32: the forward's and dH's operands
    hi = rna_tf32(t)
    return hi, t - hi


def _trunc_split(t):  # dW's operands: f32 values, lo made in place
    hi = _tc(t)
    return hi, t - hi


def _mm3s(A, B, split_a, split_b):
    """``_mm3`` with A and B split each its own way: the NP = 256 route's
    dW, A (H^T) split in registers (split_tf32), B (dP^T) its f32 values
    and their lo parts made in place."""
    (ah, al), (bh, bl) = split_a(A), split_b(B)
    return _tc(al) @ bh + ah @ _tc(bl) + ah @ bh


def _mm3_by32(A, B):
    """The NP = 256 route's forward in the f32 flavor: each 32 k rows (two
    chunks of 16) in an accumulator of its own (``_mm3``), the sums added
    in order."""
    out = None
    for k0 in range(0, A.shape[-1], 32):
        p = _mm3(A[..., k0:k0 + 32], B[k0:k0 + 32], _rna_split)
        out = p if out is None else out + p
    return out


def _bf(t):
    """t rounded to bf16 (to nearest even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _pieces(t):
    """``split_pieces`` (csrc/taylor_common.cuh): the bf16 pieces lo, mid,
    hi of float32 ``t`` (hi = rn(t), mid = rn(t - hi), lo = rn(t - hi -
    mid); their sum is t)."""
    hi = _bf(t)
    mid = _bf(t - hi)
    return _bf(t - hi - mid), mid, hi


def _arith(mode, wide=False):
    """``(rnd, grnd, mm, dh, dw, out)`` of the route in a mode: the SIMT
    operands' rounding (X, the weights, the head's input), a cotangent's as
    a SIMT operand, the forward's product, dH's product (its sums rounded
    as the next cotangent), dW's product (A the K-major H, rounded by
    ``rnd``; B dP), and the rounding of dX and the head's dH.  ``"f64"``:
    exact; ``"tf32"``: every operand ``cvt.rna``-rounded, one pass;
    ``"f32"``: IEEE SIMT, three passes on the tensor cores; ``"bf16"``:
    products on bf16-rounded operands with float32 sums, the cotangent as
    its three bf16 pieces (smallest first), dH, dX and the head's dH
    rounded to bf16.  ``wide``: the NP = 256 design (f32: the forward's
    32-row accumulators, dW's A split by split_tf32; TF32: the forward's and
    dH's chunks of 32 k rows summed apart, then added in order)."""
    keep = lambda t: t  # noqa: E731
    if mode == "tf32":
        mm = lambda A, B: rna_tf32(A) @ rna_tf32(B)  # noqa: E731
        if wide:  # each chunk of K (32 rows) summed alone, then added
            def chunks(A, B):
                out = mm(A[..., :32], B[:32])
                for k0 in range(32, A.shape[-1], 32):
                    out = out + mm(A[..., k0:k0 + 32], B[k0:k0 + 32])
                return out

            return rna_tf32, rna_tf32, chunks, chunks, mm, keep
        return rna_tf32, rna_tf32, mm, mm, mm, keep
    if mode == "f32":
        mm = lambda A, B: _mm3(A, B, _rna_split)  # noqa: E731
        if wide:
            return keep, keep, _mm3_by32, mm, \
                (lambda A, B: _mm3s(A, B, _rna_split, _trunc_split)), keep
        return keep, keep, mm, mm, \
            (lambda A, B: _mm3(A, B, _trunc_split)), keep
    if mode == "bf16":
        def dh(A, B):
            lo, mid, hi = _pieces(A)
            Bb = _bf(B)
            return _bf(lo @ Bb + mid @ Bb + hi @ Bb)

        def dw(A, B):
            lo, mid, hi = _pieces(B)
            return A @ lo + A @ mid + A @ hi

        return _bf, keep, (lambda A, B: _bf(A) @ _bf(B)), dh, dw, _bf
    return keep, keep, torch.matmul, torch.matmul, torch.matmul, keep


def _route_k2(flat, X, g, reqs, n_sm, mode, visit=None):
    """The route's K2 for layers ``flat``, points ``X [N, d]`` and table
    cotangents ``g [C, N, n_out]``: ``(dflat, dX)``.  Tiles of 128 rows
    (point p's channel c at row (p % TP) * CP + c), blocks walking tiles b,
    b + G, ...; the arithmetic of ``mode`` (:func:`_arith`) where the
    kernel rounds or splits: every product operand, the bias sums not; in
    the bf16 flavor each dW rounded to bf16 after the slots' sum.
    ``visit``: the tiles in the order the kernel's blocks run them (each
    once; tile t adds to slot t % G), tile order by default.  At NP = 256
    (the f32 flavor past 128 wide) tiles of 64 rows, H^T through its
    swizzled layout and ``_arith``'s wide order."""
    _, rows = ct.channel_schedule(reqs)
    C, N, d = len(rows), X.shape[0], X.shape[1]
    L = len(flat) // 2
    Ws, bs = flat[0::2], flat[1::2]
    shapes = [tuple(W.shape) for W in Ws]
    wp = ct.wb_plan(shapes, [o for o, _ in rows],
                    {"f32": F32, "bf16": BF16}.get(mode, TF32), SMEM, n_sm,
                    N)
    NP, CP = wp.NP, wp.CP
    R = ct.wb_tile_rows(NP)
    TP = R // CP
    rnd, grnd, mm, dh_mm, dw, out = _arith(mode, wide=NP == 256)
    ht = _ht_wide if NP == 256 else _kmajor
    dt = X.dtype
    # the small operands as the kernel holds them, NP wide
    Wp = [torch.zeros(NP if l else d, NP, dtype=dt) for l in range(L - 1)]
    for l in range(L - 1):
        Wp[l][:Ws[l].shape[0], :Ws[l].shape[1]] = rnd(Ws[l])
    bp = [torch.zeros(NP, dtype=dt) for _ in range(L - 1)]
    for l in range(L - 1):
        bp[l][:bs[l].shape[0]] = bs[l]
    Wh = torch.zeros(NP, Ws[-1].shape[1], dtype=dt)
    Wh[:Ws[-1].shape[0]] = rnd(Ws[-1])
    slots = [[torch.zeros_like(t) for t in flat] for _ in range(wp.grid)]
    dX = torch.zeros_like(X)

    def layer0(p0):
        pts = torch.arange(p0, p0 + TP)
        x = torch.zeros(TP, d, dtype=dt)
        x[pts < N] = rnd(X[pts[pts < N]])
        P = torch.zeros(TP, CP, NP, dtype=dt)
        P[:, 0] = x @ Wp[0] + bp[0]
        for c, (o, ix) in enumerate(rows):
            if o == 1:
                P[:, c] = Wp[0][ix[0]]
        return P, x

    def add(blk, i, v, first):
        slots[blk][i] = v.clone() if first else slots[blk][i] + v

    tiles = range(wp.n_tiles) if visit is None else list(visit)
    assert sorted(tiles) == list(range(wp.n_tiles))
    for tile in tiles:
        blk, first = tile % wp.grid, tile < wp.grid
        p0 = tile * TP
        P0, x = layer0(p0)
        Ps, H = [P0], _act(P0, rows)
        for l in range(1, L - 1):
            P = mm(H, Wp[l])
            P[:, 0] += bp[l]
            Ps.append(P)
            H = _act(P, rows)
        # the head's cotangents: the table cotangents, zero past N and C
        T = torch.zeros(TP, CP, g.shape[2], dtype=dt)
        live = torch.arange(p0, p0 + TP) < N
        T[live, :C] = g[:, p0:p0 + int(live.sum())].transpose(0, 1)
        Tr = T.reshape(R, -1)
        Ht = ht(rnd(H).reshape(R, NP))
        add(blk, 2 * L - 1, T[:, 0].sum(0), first)
        add(blk, 2 * L - 2, (Ht @ grnd(Tr))[:Ws[-1].shape[0]], first)
        dH = out(grnd(Tr) @ Wh.t()).reshape(TP, CP, NP)
        for l in range(L - 2, 0, -1):
            dP = _act_vjp_in_place(Ps[l], dH, rows)
            Ht = ht(rnd(_act(Ps[l - 1], rows)).reshape(R, NP))
            dPt = _kmajor(grnd(dP).reshape(R, NP))
            fi, fo = shapes[l]
            add(blk, 2 * l + 1, dP[:, 0].sum(0)[:fo], first)
            add(blk, 2 * l, dw(Ht, dPt.t())[:fi, :fo], first)
            dH = dh_mm(dP, Wp[l].t())
        dP = _act_vjp_in_place(Ps[0], dH, rows)
        w0 = shapes[0][1]
        gW = x.t() @ grnd(dP[:, 0])
        for c, (o, ix) in enumerate(rows):
            if o == 1:
                gW[ix[0]] += grnd(dP[:, c]).sum(0)
        add(blk, 1, dP[:, 0].sum(0)[:w0], first)
        add(blk, 0, gW[:, :w0], first)
        dx = out(grnd(dP[:, 0]) @ Wp[0].t())
        n_live = int(live.sum())
        dX[p0:p0 + n_live] = dx[:n_live]
    total = []  # reduce_partials: the slots in slot order
    for i in range(len(flat)):
        acc = slots[0][i].clone()
        for s in slots[1:]:
            acc = acc + s[i]
        total.append(_bf(acc) if mode == "bf16" and i % 2 == 0 else acc)
    return total, dX


def _case(widths, N, seed=3):
    flat = _layers(widths, seed)
    rng = np.random.RandomState(seed)
    X = torch.from_numpy(rng.uniform(-1, 1, (N, widths[0])).astype(np.float32))
    return flat, X


def _referee(flat, X, g, reqs, **kw):
    params = [t.clone().requires_grad_(True) for t in flat]
    Xg = X.clone().requires_grad_(True)
    table = taylor_derivatives(list(zip(params[0::2], params[1::2])), Xg,
                               reqs, flat_matmul=True, **kw)
    chans = channel_order(reqs)
    loss = sum((table[mi] * g[c]).sum() for c, mi in enumerate(chans))
    return [t.detach() for t in torch.autograd.grad(loss, params + [Xg])]


@pytest.mark.parametrize("reqs", [AC, MIXED], ids=["ac", "mixed"])
def test_route_k2_is_autograds_gradient_in_float64(reqs):
    widths = [2, 24, 24, 24, 1]
    flat, X = _case(widths, 77)
    flat = [t.double() for t in flat]
    X = X.double()
    C = len(channel_order(reqs))
    g = torch.randn(C, 77, 1, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    got, dX = _route_k2(flat, X, g, reqs, n_sm=2, mode="f64")
    want = _referee(flat, X, g, reqs)
    for a, b in zip(got + [dX], want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def _rms_rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / max(float(torch.sqrt(torch.mean(b ** 2))), 1e-30))


def test_route_k2_dw_order_within_the_tf32_band_of_the_referee():
    """The route's dW order (tiles of 128 rows, K-major TF32 operands,
    float32 sums, slot adds in tile order, slots in slot order) against
    ``taylor_derivatives(emulate_tf32=True)``, within TF32_SPREAD times the
    referee's own order spread (its float64-summed twin) by RMS, at least
    TF32_FLOOR, and nearer it than the JAX package's float32 result."""
    reqs, widths, N = AC, [2, 48, 48, 48, 1], 300
    flat, X = _case(widths, N)
    C = len(channel_order(reqs))
    rng = np.random.RandomState(4)
    g = torch.from_numpy(rng.randn(C, N, 1).astype(np.float32))
    got, dX = _route_k2(flat, X, g, reqs, n_sm=3, mode="tf32")
    got = got + [dX]
    emu = _referee(flat, X, g, reqs, emulate_tf32=True)
    twin = _referee(flat, X, g, reqs, emulate_tf32="float64")
    # the JAX package's table and its gradient (HIGHEST: IEEE float32)
    jl = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
          for W, b in zip(flat[0::2], flat[1::2])]
    chans = channel_order(reqs)

    def loss(layers, x):
        t = jax_table(layers, x, reqs)
        return sum(jnp.sum(t[mi] * jnp.asarray(g[c].numpy()))
                   for c, mi in enumerate(chans))

    gl, gx = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(X.numpy()))
    ieee = [torch.from_numpy(np.array(a)) for pair in gl for a in pair] \
        + [torch.from_numpy(np.array(gx))]
    spread = max(_rms_rel(t, e) for t, e in zip(twin, emu))
    band = max(TF32_FLOOR, TF32_SPREAD * spread)
    for i, (a, e, t, j) in enumerate(zip(got, emu, twin, ieee)):
        near = min(_rms_rel(a, e), _rms_rel(a, t))
        print(f"leaf {i}: to the TF32 referee {_rms_rel(a, e):.3e} (nearer "
              f"{near:.3e}, band {band:.3e}); to JAX HIGHEST "
              f"{_rms_rel(a, j):.3e}")
        assert near <= band, (i, near, band)
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
    assert _rms_rel(cat(got), cat(emu)) < _rms_rel(cat(got), cat(ieee))


# ------------------------------------------------------------------ #
# the f32 flavor (3xTF32) on the route
# ------------------------------------------------------------------ #
def test_f32_plan_at_the_slice_and_at_burgers():
    """The f32 flavor's chunks carry the hi and lo planes at KC = 32: the
    TF32 flavor's 32 KB a stage, twice its chunks, the same shared memory
    (dW's lo planes are made in place over H^T and dP^T)."""
    _, ac = _plan(AC, [2, 128, 128, 128, 128, 1], code=F32)
    assert ac == ct.WbPlan(NP=128, CP=4, KC=32, S=2, P=24, stage_bytes=32_768,
                           n_tiles=1563, grid=132, smem=205_600, bulk=1,
                           ws_floats=132 * 4 * 128 * 128 + 24 * 128 * 32 * 2)
    assert ac.smem == _plan(AC, [2, 128, 128, 128, 128, 1])[1].smem
    _, bu = _plan(AC, [2] + [20] * 8 + [1], code=F32)
    assert (bu.NP, bu.CP, bu.KC, bu.P, bu.S, bu.stage_bytes, bu.bulk) \
        == (64, 4, 32, 28, 8, 16_384, 1)
    assert bu.ws_floats == 132 * 8 * 128 * 64 + 28 * 64 * 32 * 2
    for wp in (ac, bu):
        assert wp.smem <= SMEM and wp.S >= 2
        assert wp.stage_bytes == wp.NP * wp.KC * 8  # hi and lo planes
    # past 128 wide the f32 flavor takes the NP = 256 design
    # (csrc/wg_backward_wide.cuh): tiles of 64 rows, chunks of 16 k rows
    # (hi and lo planes, 32 KB), four stages; the region (64 KB + dP^T's
    # 64 KB + two warpgroups' staging of 64 rows x 132 floats) and the
    # rest: rows 4,096, X's rows 512, the small operands 7,232, 32 + 64 +
    # 128
    _, wide = _plan(AC, [2, 256, 256, 256, 256, 1], code=F32)
    assert wide == ct.WbPlan(NP=256, CP=4, KC=16, S=4, P=96,
                             stage_bytes=32_768, n_tiles=3125, grid=132,
                             smem=210_720, bulk=1,
                             ws_floats=132 * 4 * 64 * 256 + 96 * 256 * 16 * 2)
    assert wide.smem == 65_536 + 65_536 + 2 * 64 * 132 * 4 + 4_096 + 512 \
        + 7_232 + 32 + 64 + 128
    _, ragged = _plan(AC, [2, 200, 256, 1], N=517, code=F32)
    assert ragged == ct.WbPlan(NP=256, CP=4, KC=16, S=4, P=32,
                               stage_bytes=32_768, n_tiles=33, grid=33,
                               smem=208_672, bulk=1,
                               ws_floats=33 * 2 * 64 * 256 + 32 * 256 * 16 * 2)
    assert _plan(AC, [2, 150, 201, 1], code=F32)[1].bulk == 0
    # a tile of 64 rows: N * CP / 64 tiles
    assert _plan(MIXED, [2, 256, 256, 1], N=1000, code=F32)[1].n_tiles == 125
    # the mma.sync kernels: widths over 256, more than 8 channels, a card
    # without room for the region and two stages
    assert _plan(AC, [2, 257, 256, 1], code=F32)[1] is None
    assert _plan({(), (0,), (2,), (1, 1), (0, 1, 2)}, [3, 256, 64, 1],
                 code=F32)[1] is None
    assert _plan(AC, [2, 256, 256, 1], smem=200_000, code=F32)[1] is None
    assert _plan(AC, [2, 128, 128, 128, 1], smem=190_000, code=F32)[1] \
        is None
    bf = _plan(AC, [2, 128, 128, 128, 128, 1], code=1)[1]
    assert bf is not None and (bf.KC, bf.stage_bytes) == (64, 16_384)
    assert _plan(AC, [2, 256, 256, 256, 256, 1], code=1)[1] is None
    assert _plan(AC, [2, 200, 256, 1], code=1)[1] is None
    # the TF32 flavor: the NP = 256 design, chunks of 32 k rows of the hi
    # plane (test_tf32_plan_at_256)
    assert _plan(AC, [2, 200, 256, 1], N=517)[1] == ragged._replace(
        KC=32, S=3, P=16, ws_floats=33 * 2 * 64 * 256 + 16 * 256 * 32)


@pytest.mark.parametrize("widths", [[2, 128, 128, 128, 1], [2, 37, 53, 1],
                                    [3, 20, 20, 20, 20, 2],
                                    [2, 256, 200, 256, 1]],
                         ids=["ac", "odd", "burgers-like", "wide-256"])
def test_f32_weight_planes_sum_back_to_w(widths):
    flat = _layers(widths)
    _, wp = _plan(AC, widths, code=F32)
    raw = ct.wb_prepare(flat, wp, None)
    assert raw.numel() == wp.P * wp.stage_bytes
    per = wp.NP * wp.KC
    chunks = raw.view(torch.float32).reshape(wp.P, 2, per)
    hi, lo = chunks[:, 0], chunks[:, 1]
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()  # TF32
    # the forward half is K1's f32 chunks of the same depth, byte for byte
    wg = ct.WgPlan(wp.NP, wp.CP, wp.KC, 0, wp.P // 2, 0, wp.stage_bytes, 0,
                   0, 0)
    assert torch.equal(raw[:wp.P // 2 * wp.stage_bytes],
                       ct.wg_prepare(flat, wg, None))
    slots = np.array(ct.wg_kslots(wp.KC, False))
    n, kq = np.arange(wp.NP)[:, None], np.arange(wp.KC)[None, :]
    off = torch.from_numpy(_cm(n, kq, wp.KC).reshape(-1))
    nch, L = wp.NP // wp.KC, len(widths) - 1
    hidden = list(range(1, L - 1))
    planes = [flat[2 * l].t() for l in hidden] \
        + [flat[2 * l] for l in reversed(hidden)]
    for q in range(wp.P):
        M = planes[q // nch]
        pad = torch.zeros(wp.NP, wp.NP)
        pad[:M.shape[0], :M.shape[1]] = M
        want = pad[:, (q % nch) * wp.KC + torch.from_numpy(slots)].reshape(-1)
        h, lw = hi[q][off], lo[q][off]
        assert torch.equal(h + lw, want)  # lo = W - hi, exact
        # what the tensor cores read of the two planes: W within 2^-21
        err = (h + _tc(lw) - want).abs()
        assert bool((err <= 2.0 ** -21 * want.abs()).all())


def _crosscheck(got, want):
    ok, why = crosscheck_grads([t.double() for t in want],
                               [t.double() for t in got],
                               rtol=CROSSCHECK_RTOL)
    assert ok, why


def test_route_k2_f32_order_within_the_f32_band():
    """The route's K2 in the f32 flavor's order (three passes a product,
    dW's truncating split, float32 sums, the slot order) against autograd
    of the float64 plain flavor: every leaf within F32_BAND scale-relative;
    and within the cross-check's rtol of the JAX package's float32
    (HIGHEST) gradient on the same numpy-seeded inputs."""
    _k2_f32_case([2, 48, 48, 48, 1], 300, n_sm=3)


def test_route_k2_f32_at_256_within_the_f32_band():
    """The same at NP = 256 (csrc/wg_backward_wide.cuh, 2-256-256-1, N =
    517: tiles of 64 rows, the forward's 32-row accumulators, dW's A split
    by split_tf32 and B truncated, 9 tiles over 4 blocks)."""
    _, wp = _plan(AC, [2, 256, 256, 1], N=517, n_sm=4, code=F32)
    assert (wp.NP, wp.n_tiles, wp.grid) == (256, 33, 4)
    _k2_f32_case([2, 256, 256, 1], 517, n_sm=4)


def _k2_f32_case(widths, N, n_sm):
    reqs = AC
    flat, X = _case(widths, N)
    C = len(channel_order(reqs))
    g = torch.from_numpy(np.random.RandomState(4).randn(C, N, 1)
                         .astype(np.float32))
    got, dX = _route_k2(flat, X, g, reqs, n_sm=n_sm, mode="f32")
    got = got + [dX]
    ref = _referee([t.double() for t in flat], X.double(), g.double(), reqs)
    for i, (a, r) in enumerate(zip(got, ref)):
        err = float((a.double() - r).abs().max() / r.abs().max())
        print(f"leaf {i}: to the float64 referee {err:.3e}")
        assert err <= F32_BAND, (i, err)
    jl = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
          for W, b in zip(flat[0::2], flat[1::2])]
    chans = channel_order(reqs)

    def loss(layers, x):
        t = jax_table(layers, x, reqs)
        return sum(jnp.sum(t[mi] * jnp.asarray(g[c].numpy()))
                   for c, mi in enumerate(chans))

    gl, gx = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(X.numpy()))
    ieee = [torch.from_numpy(np.array(a)) for pair in gl for a in pair] \
        + [torch.from_numpy(np.array(gx))]
    _crosscheck(got, ieee)


VARS = ("x", "t")


def _residuals(g):
    def ac(u, x, t):
        return (g(u, "t")(x, t) - 0.05 * g(g(u, "x"), "x")(x, t)
                + u(x, t) ** 3 - u(x, t))

    def system(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        f_u = g(u[0], "t")(x, t) + 0.5 * g(g(u[1], "x"), "x")(x, t) + sq * vv
        f_v = g(u[1], "t")(x, t) - 0.5 * g(g(u[0], "x"), "x")(x, t) - sq * uv
        return f_u, f_v

    return dict(ac=ac, system=system)


T_RES, J_RES = _residuals(grad), _residuals(tdq.grad)
N_OUT = dict(ac=1, system=2)


def _route_k3(sq, flat, X, w, n_sm, mode="f32", visit=None):
    """K3 on the route in the flavor ``mode`` ("f32", "tf32" or "bf16"): the
    route's forward gives the head's rows (per point: its rows do not
    depend on the tile), the tape runs on them per point
    (``minimax_tape.cuh``'s interpreter, mirrored by ``ResidualTape``), and
    its cotangents (seeds 2 w f) go through the route's K2, whose dX the
    tape's direct coordinate adjoints are added to (``visit``: its tiles'
    order, :func:`_route_k2`).  Returns ``(value, [dW_0, db_0, ...], gw,
    gX)``."""
    plan = sq.plan
    _, rows = ct.channel_schedule(set(plan.mis))
    wp = ct.wb_plan(plan.layer_shapes, plan.orders,
                    {"f32": F32, "bf16": BF16}.get(mode, TF32), SMEM, n_sm,
                    X.shape[0])
    wide = wp is not None and wp.NP == 256
    rnd, _, mm, _, _, _ = _arith(mode, wide)
    Ws, bs = flat[0::2], flat[1::2]
    H = torch.zeros(X.shape[0], len(rows), Ws[0].shape[1])
    H[:, 0] = rnd(X) @ rnd(Ws[0]) + bs[0]
    for c, (o, ix) in enumerate(rows):
        if o == 1:
            H[:, c] = rnd(Ws[0])[ix[0]]
    H = _act(H, rows)
    for l in range(1, len(Ws) - 1):
        P = mm(H, Ws[l])
        P[:, 0] += bs[l]
        H = _act(P, rows)
    if wide:  # each warpgroup's 128 columns, the two sums added
        Hp = torch.zeros(*H.shape[:2], 256)
        Hp[..., :H.shape[2]] = rnd(H)
        Wp = torch.zeros(256, Ws[-1].shape[1])
        Wp[:Ws[-1].shape[0]] = rnd(Ws[-1])
        table = Hp[..., :128] @ Wp[:128] + Hp[..., 128:] @ Wp[128:]
    else:
        table = rnd(H) @ rnd(Ws[-1])
    table[:, 0] += bs[-1]
    cols = [table[:, c, o] for c in range(plan.C) for o in range(plan.n_out)]
    coords = [X[:, k] for k in range(plan.d)]
    regs = plan.tape.forward(cols, coords)
    f = [regs[r] for r in plan.tape.outputs]
    value = sum((w[:, e] * f[e] ** 2).sum() for e in range(plan.E))
    gw = torch.stack([fe ** 2 for fe in f], 1)
    g_tab, g_coord = plan.tape.reverse(regs, [2 * w[:, e] * f[e]
                                              for e in range(plan.E)])
    g = torch.zeros(plan.C, X.shape[0], plan.n_out)
    for s, gs in g_tab.items():
        g[s // plan.n_out, :, s % plan.n_out] = gs
    dflat, dX = _route_k2(flat, X, g, set(plan.mis), n_sm, mode, visit)
    for k, gc in g_coord.items():
        dX[:, k] += gc
    return value, dflat, gw, dX


@pytest.mark.parametrize("case", ["ac", "system"])
def test_route_k3_f32_within_the_f32_band_and_jax(case):
    """K3 on the route in the f32 flavor against the float64 plain flavor
    (within F32_BAND scale-relative, every leaf) and against the JAX
    package's ``build_minimax_sq_fn`` (XLA) on the same weights
    (``weights.params_from_jax``) and numpy-seeded points and weights
    (within the cross-check's rtol)."""
    _k3_f32_case(case, [2, 40, 40, 40], 300, n_sm=3)


@pytest.mark.parametrize("case", ["ac", "system"])
def test_route_k3_f32_at_256_within_the_f32_band_and_jax(case):
    """The same at NP = 256 (2-256-256-n_out, N = 517; the head's row sums
    each warpgroup's 128 columns, the two added)."""
    _k3_f32_case(case, [2, 256, 256], 517, n_sm=4)


def _k3_f32_case(case, hidden, N, n_sm):
    n_out = N_OUT[case]
    net = jax_net(hidden + [n_out])
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    rng = np.random.RandomState(0)
    X = (rng.randn(N, 2) * 0.5).astype(np.float32)
    E = 2 if case == "system" else 1
    w = rng.rand(N, E).astype(np.float32)
    tl = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    flat = [t.detach().float() for p in tl for t in p]
    shapes = [tuple(W.shape) for W, _ in tl]
    f = T_RES[case]
    sq = minimax.build_minimax_sq_fn(f, VARS, n_out,
                                     analyze_f_model(f, VARS, n_out), shapes,
                                     device="cpu")
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    val, dflat, gw, gX = _route_k3(sq, flat, Xt, wt, n_sm=n_sm)
    got = [val.reshape(1)] + [t.reshape(-1) for t in dflat] + [gw, gX]
    pv, pflat, pgw, pgX = sq.plain([t.double() for t in flat], wt.double(),
                                   Xt.double())
    ref = [pv.reshape(1)] + [t.reshape(-1) for t in pflat] + [pgw, pgX]
    for i, (a, r) in enumerate(zip(got, ref)):
        err = float((a.double() - r).abs().max()
                    / r.abs().max().clamp_min(1e-30))
        print(f"{case} leaf {i}: to the float64 plain flavor {err:.3e}")
        assert err <= F32_BAND, (i, err)
    jf = J_RES[case]
    jl = extract_mlp_layers(params)
    jsq = jmm.build_minimax_sq_fn(jf, VARS, n_out,
                                  jax_analyze(jf, VARS, n_out), shapes)
    jv, vjp = jax.vjp(jsq, jl, jnp.asarray(w), jnp.asarray(X))
    jg, jgw, jgx = vjp(jnp.ones((), jv.dtype))
    jax_leaves = [np.asarray(jv).reshape(1)] + \
        [np.asarray(a).reshape(-1) for p in jg for a in p] + \
        [np.asarray(jgw), np.asarray(jgx)]
    _crosscheck(got, [torch.from_numpy(np.array(a)) for a in jax_leaves])


def _route_k3_members(sqs, flats, Xs, ws, n_sm, mode="f32"):
    """K3 over a member axis on the route: the launch's persistent blocks
    (:func:`~cuda_minimax.family_launch`) walk the work items (member m,
    virtual block b) in turn, each running member m's tiles b, b + G, ...
    into its slot; each member's tiles are visited in the order that walk
    reaches them.  Returns each member's :func:`_route_k3` outputs."""
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    plan = sqs[0].plan
    N = Xs[0].shape[0]
    wp = ct.wb_plan(plan.layer_shapes, plan.orders, {"f32": F32,
                    "bf16": BF16}.get(mode, TF32), SMEM, n_sm, N)
    fl = cm.family_launch(plan, wp, len(sqs), n_sm)
    visits = [[] for _ in sqs]
    for blk in range(fl.grid):
        for m, b in cm.family_items(fl, blk):
            visits[m] += list(range(b, wp.n_tiles, fl.G))
    return [_route_k3(sq, flat, X, w, n_sm, mode, visit=v)
            for sq, flat, X, w, v in zip(sqs, flats, Xs, ws, visits)]


def test_route_k3_member_axis_is_each_members_route_bit_for_bit():
    """The route's K3 over 3 members in the f32 order (their θ differ; one
    tape group) equals each member's single-launch mirror bit for bit."""
    _members_case([2, 40, 40, 40, 1], 300, (0.05, 0.02, 0.11), n_sm=4)


def test_route_k3_member_axis_at_256_is_each_members_route_bit_for_bit():
    """The same at NP = 256 (2-256-256-1, 2 members, N = 517): the member
    axis walks 2 x 9 items of 64-row tiles over 5 blocks."""
    _members_case([2, 256, 256, 1], 517, (0.05, 0.02), n_sm=5)


def _members_case(widths, N, thetas, n_sm, mode="f32"):
    shapes = list(zip(widths[:-1], widths[1:]))
    rng = np.random.RandomState(1)
    sqs, flats, Xs, ws = [], [], [], []
    for m, th in enumerate(thetas):
        def f(u, x, t, _th=th):
            return (grad(u, "t")(x, t) - _th * grad(grad(u, "x"), "x")(x, t)
                    + u(x, t) ** 3 - u(x, t))
        sqs.append(minimax.build_minimax_sq_fn(
            f, VARS, 1, analyze_f_model(f, VARS, 1), shapes, device="cpu"))
        flats.append(_layers(widths, seed=m))
        Xs.append(torch.from_numpy((rng.randn(N, 2) * 0.5).astype(
            np.float32)))
        ws.append(torch.from_numpy(rng.rand(N, 1).astype(np.float32)))
    assert minimax.tape_groups(sqs) == [list(range(len(thetas)))]
    got = _route_k3_members(sqs, flats, Xs, ws, n_sm, mode)
    for sq, flat, X, w, out in zip(sqs, flats, Xs, ws, got):
        want = _route_k3(sq, flat, X, w, n_sm, mode)
        assert torch.equal(out[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(out[1], want[1]))
        assert torch.equal(out[2], want[2]) and torch.equal(out[3], want[3])


# ------------------------------------------------------------------ #
# the bf16 flavor on the route
# ------------------------------------------------------------------ #
def test_bf16_plan_at_the_slice_and_at_burgers():
    """The bf16 flavor's chunks are KC = 64 k rows of bf16: 16 KB a stage
    at NP = 128, five stages beside the f32 flavor's fixed bytes (its H
    and dP's three pieces take the bytes of H^T and dP^T)."""
    _, ac = _plan(AC, [2, 128, 128, 128, 128, 1], code=BF16)
    assert ac == ct.WbPlan(NP=128, CP=4, KC=64, S=5, P=12, stage_bytes=16_384,
                           n_tiles=1563, grid=132, smem=221_984, bulk=1,
                           ws_floats=132 * 4 * 128 * 128 + 12 * 128 * 64 // 2)
    f32 = _plan(AC, [2, 128, 128, 128, 128, 1], code=F32)[1]
    assert ac.smem - ac.S * ac.stage_bytes == f32.smem - f32.S * f32.stage_bytes
    _, bu = _plan(AC, [2] + [20] * 8 + [1], code=BF16)
    assert (bu.NP, bu.CP, bu.KC, bu.P, bu.S, bu.stage_bytes, bu.bulk) \
        == (64, 4, 64, 14, 8, 8_192, 1)
    assert bu.ws_floats == 132 * 8 * 128 * 64 + 14 * 64 * 64 // 2
    # the edges the card tests hold: the route to 128 wide, not past it
    for widths in ([2, 40, 24, 1], [2, 16, 16, 1], [2, 128, 128, 1],
                   [2, 24, 40, 1]):
        wp = _plan(AC, widths, code=BF16)[1]
        assert wp is not None and wp.smem <= SMEM and wp.S >= 2
    assert _plan(AC, [2, 256, 256, 1], code=BF16)[1] is None
    assert _plan(MIXED, [2, 16, 16, 1], code=BF16)[1].CP == 8


@pytest.mark.parametrize("widths", [[2, 128, 128, 128, 1], [2, 37, 53, 1],
                                    [3, 20, 20, 20, 20, 2]],
                         ids=["ac", "odd", "burgers-like"])
def test_bf16_weight_planes_are_w_rounded(widths):
    """The bf16 chunks: W rounded to bf16 (to nearest even), the k rows in
    their natural order, in core-matrix order (8 bf16 a core-matrix row);
    read back, each is the layer's rounded W^T (forward) or W (backward)."""
    flat = _layers(widths)
    _, wp = _plan(AC, widths, code=BF16)
    raw = ct.wb_prepare(flat, wp, torch.bfloat16)
    assert raw.numel() == wp.P * wp.stage_bytes
    chunks = raw.view(torch.bfloat16).reshape(wp.P, wp.NP * wp.KC)
    n, kq = np.arange(wp.NP)[:, None], np.arange(wp.KC)[None, :]
    off = torch.from_numpy(_cm(n, kq, wp.KC, 8).reshape(-1))
    nch, L = wp.NP // wp.KC, len(widths) - 1
    hidden = list(range(1, L - 1))
    planes = [flat[2 * l].t() for l in hidden] \
        + [flat[2 * l] for l in reversed(hidden)]
    if wp.KC == wp.NP:  # the forward half is K1-bf16's chunks
        wg = ct.WgPlan(wp.NP, wp.CP, wp.KC, 0, wp.P // 2, 0, wp.stage_bytes,
                       0, 0, 0)
        assert torch.equal(raw[:wp.P // 2 * wp.stage_bytes],
                           ct.wg_prepare(flat, wg, torch.bfloat16))
    for q in range(wp.P):
        M = planes[q // nch]
        pad = torch.zeros(wp.NP, wp.NP)
        pad[:M.shape[0], :M.shape[1]] = M
        want = pad[:, (q % nch) * wp.KC:(q % nch + 1) * wp.KC].reshape(-1)
        got = chunks[q][off].float()
        assert torch.equal(got, _bf(want))
        assert bool(((got - want).abs() <= 2.0 ** -8 * want.abs()).all())


def _cat(ts):
    return torch.cat([t.reshape(-1).double() for t in ts])


def _scaled(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bf16_check(label, got, refs, bands):
    """Each leaf of ``got`` within its band (scale-relative) of the bf16
    referee of each pair in ``refs`` (name -> (bf16 leaves, f32 leaves)),
    and nearer it than the f32 one by RMS over every leaf together."""
    for name, (want, want32) in refs.items():
        for i, (a, b, band) in enumerate(zip(got, want, bands)):
            err = _scaled(a, b)
            assert err <= band, (label, name, i, err, band)
        r16 = _rms_rel(_cat(got), _cat(want))
        r32 = _rms_rel(_cat(got), _cat(want32))
        print(f"{label}: RMS to {name} bf16 {r16:.3e}, f32 {r32:.3e}")
        assert r16 < r32, (label, name, r16, r32)


@pytest.mark.parametrize("reqs", [AC, MIXED], ids=["ac", "mixed"])
def test_route_k2_bf16_order_within_the_bf16_bands(reqs):
    """The route's K2 in the bf16 flavor's order against the plain bf16
    flavor (``taylor_derivatives(compute_dtype=torch.bfloat16)``'s
    autograd) and the JAX package's (``compute_dtype=jnp.bfloat16``) on the
    same numpy-seeded inputs: every leaf within the bf16 gradient band,
    nearer each than its f32 flavor by RMS."""
    widths, N = [2, 48, 48, 48, 1], 300
    flat, X = _case(widths, N)
    C = len(channel_order(reqs))
    g = torch.from_numpy(np.random.RandomState(4).randn(C, N, 1)
                         .astype(np.float32))
    got, dX = _route_k2(flat, X, g, reqs, n_sm=3, mode="bf16")
    got = got + [dX]
    plain = _referee(flat, X, g, reqs, compute_dtype=torch.bfloat16)
    plain32 = _referee(flat, X, g, reqs)
    jl = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
          for W, b in zip(flat[0::2], flat[1::2])]
    chans = channel_order(reqs)

    def jgrads(**kw):
        def loss(layers, x):
            t = jax_table(layers, x, reqs, flat_matmul=True, **kw)
            return sum(jnp.sum(t[mi] * jnp.asarray(g[c].numpy()))
                       for c, mi in enumerate(chans))
        gl, gx = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(X.numpy()))
        return [torch.from_numpy(np.array(a, np.float32)) for pair in gl
                for a in pair] + [torch.from_numpy(np.array(gx, np.float32))]

    _bf16_check("K2-bf16 route", got,
                {"plain": (plain, plain32),
                 "jax": (jgrads(compute_dtype=jnp.bfloat16), jgrads())},
                [BF16_GRADS] * len(got))


@pytest.mark.parametrize("case", ["ac", "system"])
def test_route_k3_bf16_within_the_bf16_bands_and_jax(case):
    """K3 on the route in the bf16 flavor's order against the plain bf16
    flavor (``build_minimax_sq_fn(compute_dtype=torch.bfloat16)``) and the
    JAX package's ``build_minimax_sq_fn(compute_dtype=jnp.bfloat16)`` on
    the same weights and numpy-seeded points and weights: the value and gw
    within the bf16 value band, every gradient within the gradient band,
    nearer each than its f32 flavor by RMS."""
    n_out, N = N_OUT[case], 300
    net = jax_net([2, 40, 40, 40, n_out])
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    rng = np.random.RandomState(0)
    X = (rng.randn(N, 2) * 0.5).astype(np.float32)
    E = 2 if case == "system" else 1
    w = rng.rand(N, E).astype(np.float32)
    tl = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    flat = [t.detach().float() for p in tl for t in p]
    shapes = [tuple(W.shape) for W, _ in tl]
    f = T_RES[case]
    reqs = analyze_f_model(f, VARS, n_out)
    sq32 = minimax.build_minimax_sq_fn(f, VARS, n_out, reqs, shapes,
                                       device="cpu")
    sq = minimax.build_minimax_sq_fn(f, VARS, n_out, reqs, shapes,
                                     device="cpu",
                                     compute_dtype=torch.bfloat16)
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    val, dflat, gw, gX = _route_k3(sq, flat, Xt, wt, n_sm=3, mode="bf16")

    def leaves(v, fl, gw_, gx_):
        return [v.reshape(1)] + [t.reshape(-1) for t in fl] + [gw_, gx_]

    got = leaves(val, dflat, gw, gX)
    jf = J_RES[case]
    jl = extract_mlp_layers(params)

    def jax_leaves(**kw):
        jsq = jmm.build_minimax_sq_fn(jf, VARS, n_out,
                                      jax_analyze(jf, VARS, n_out), shapes,
                                      **kw)
        jv, vjp = jax.vjp(jsq, jl, jnp.asarray(w), jnp.asarray(X))
        jg, jgw, jgx = vjp(jnp.ones((), jv.dtype))
        return [torch.from_numpy(np.array(a, np.float32)) for a in
                [np.asarray(jv).reshape(1)]
                + [np.asarray(a).reshape(-1) for p in jg for a in p]
                + [np.asarray(jgw), np.asarray(jgx)]]

    bands = [BF16_VALUES] + [BF16_GRADS] * (len(got) - 3) \
        + [BF16_VALUES, BF16_GRADS]
    _bf16_check(f"K3-bf16 route {case}", got,
                {"plain": (leaves(*sq.plain(flat, wt, Xt)),
                           leaves(*sq32.plain(flat, wt, Xt))),
                 "jax": (jax_leaves(compute_dtype=jnp.bfloat16),
                         jax_leaves())},
                bands)


# ------------------------------------------------------------------ #
# the TF32 flavor past 128 wide (NP = 256, csrc/wg_backward_wide.cuh)
# ------------------------------------------------------------------ #
def test_tf32_plan_at_256():
    """The TF32 flavor at NP = 256: the f32 flavor's layout (64-row tiles,
    the same region and shared memory) with chunks of 32 k rows of the hi
    plane alone (32 KB a stage, half the f32 flavor's chunks) and three
    stages (the fourth's bytes park warpgroup 1's running sums), field for
    field in the C plan's order; the bf16 flavor, widths over 256, more
    than 8 channels and a card without room for two stages decline."""
    _, wide = _plan(AC, [2, 256, 256, 256, 256, 1])
    assert wide == ct.WbPlan(NP=256, CP=4, KC=32, S=3, P=48,
                             stage_bytes=32_768, n_tiles=3125, grid=132,
                             smem=210_720, bulk=1,
                             ws_floats=132 * 4 * 64 * 256 + 48 * 256 * 32)
    f32 = _plan(AC, [2, 256, 256, 256, 256, 1], code=F32)[1]
    assert (wide.smem, wide.S + 1, 2 * wide.P) == (f32.smem, f32.S, f32.P)
    # the parked running sums: warpgroup 0's in the exchange buffer's second 32 KB,
    # warpgroup 1's past the three stages, inside the region
    assert 65_536 + wide.S * wide.stage_bytes + 32_768 \
        <= 65_536 + 65_536 + 2 * 64 * ct.WBW_LDS * 4
    _, ragged = _plan(AC, [2, 200, 256, 1], N=517)
    assert ragged == ct.WbPlan(NP=256, CP=4, KC=32, S=3, P=16,
                               stage_bytes=32_768, n_tiles=33, grid=33,
                               smem=208_672, bulk=1,
                               ws_floats=33 * 2 * 64 * 256 + 16 * 256 * 32)
    assert _plan(MIXED, [2, 256, 256, 1], N=1000)[1].n_tiles == 125
    assert _plan(AC, [2, 150, 201, 1])[1].bulk == 0
    assert _plan(AC, [2, 256, 256, 256, 256, 1], code=BF16)[1] is None
    assert _plan(AC, [2, 257, 256, 1])[1] is None
    assert _plan({(), (0,), (2,), (1, 1), (0, 1, 2)}, [3, 256, 64, 1])[1] \
        is None
    assert _plan(AC, [2, 256, 256, 1], smem=200_000)[1] is None


def _tf32_case_check(label, got, emu, twin, ieee):
    """Each leaf's RMS scale-relative distance to the nearer TF32 referee
    (the emulation, its float64-summed twin) within TF32_SPREAD times their
    spread (at least TF32_FLOOR), and the whole nearer the emulation than
    the JAX package's IEEE float32 leaves: the TF32 band, since the JAX
    side rounds no operand."""
    spread = max(_rms_rel(t, e) for t, e in zip(twin, emu))
    band = max(TF32_FLOOR, TF32_SPREAD * spread)
    for i, (a, e, t, j) in enumerate(zip(got, emu, twin, ieee)):
        near = min(_rms_rel(a, e), _rms_rel(a, t))
        print(f"{label} leaf {i}: to the TF32 referee {_rms_rel(a, e):.3e} "
              f"(nearer {near:.3e}, band {band:.3e}); to JAX "
              f"{_rms_rel(a, j):.3e}")
        assert near <= band, (label, i, near, band)
    assert _rms_rel(_cat(got), _cat(emu)) < _rms_rel(_cat(got), _cat(ieee))


def test_route_k2_tf32_at_256_within_the_tf32_band():
    """The route's K2 in the TF32 flavor at NP = 256 (2-256-256-1, N =
    517, 9 tiles of 64 rows over 4 blocks; one rounded pass a product, H^T
    through its swizzled layout) against
    ``taylor_derivatives(emulate_tf32=True)``'s autograd and its
    float64-summed twin, and against the JAX package's
    ``taylor_derivatives`` and ``jax.grad`` on the same numpy-seeded
    inputs (``_tf32_case_check``)."""
    reqs, widths, N = AC, [2, 256, 256, 1], 517
    _, wp = _plan(reqs, widths, N=N, n_sm=4)
    assert (wp.NP, wp.KC, wp.n_tiles, wp.grid) == (256, 32, 33, 4)
    flat, X = _case(widths, N)
    C = len(channel_order(reqs))
    g = torch.from_numpy(np.random.RandomState(4).randn(C, N, 1)
                         .astype(np.float32))
    got, dX = _route_k2(flat, X, g, reqs, n_sm=4, mode="tf32")
    jl = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
          for W, b in zip(flat[0::2], flat[1::2])]
    chans = channel_order(reqs)

    def loss(layers, x):
        t = jax_table(layers, x, reqs)
        return sum(jnp.sum(t[mi] * jnp.asarray(g[c].numpy()))
                   for c, mi in enumerate(chans))

    gl, gx = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(X.numpy()))
    ieee = [torch.from_numpy(np.array(a)) for pair in gl for a in pair] \
        + [torch.from_numpy(np.array(gx))]
    _tf32_case_check("K2-TF32 at 256", got + [dX],
                     _referee(flat, X, g, reqs, emulate_tf32=True),
                     _referee(flat, X, g, reqs, emulate_tf32="float64"),
                     ieee)


@pytest.mark.parametrize("case", ["ac", "system"])
def test_route_k3_tf32_at_256_within_the_tf32_band_and_jax(case):
    """K3 on the route in the TF32 flavor at NP = 256 (2-256-256-n_out, N
    = 517; the head's two halves of 128 columns added) against the plain
    flavor's TF32 emulation and its float64-summed twin, and against the
    JAX package's ``build_minimax_sq_fn`` (XLA, IEEE float32) on the same
    weights and numpy-seeded points and weights (``_tf32_case_check``)."""
    n_out, N = N_OUT[case], 517
    net = jax_net([2, 256, 256, n_out])
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    rng = np.random.RandomState(0)
    X = (rng.randn(N, 2) * 0.5).astype(np.float32)
    E = 2 if case == "system" else 1
    w = rng.rand(N, E).astype(np.float32)
    tl = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    flat = [t.detach().float() for p in tl for t in p]
    shapes = [tuple(W.shape) for W, _ in tl]
    f = T_RES[case]
    sq = minimax.build_minimax_sq_fn(f, VARS, n_out,
                                     analyze_f_model(f, VARS, n_out), shapes,
                                     device="cpu", precision=None)
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    val, dflat, gw, gX = _route_k3(sq, flat, Xt, wt, n_sm=4, mode="tf32")

    def leaves(v, fl, gw_, gx_):
        return [v.reshape(1)] + [t.reshape(-1) for t in fl] + [gw_, gx_]

    jf = J_RES[case]
    jsq = jmm.build_minimax_sq_fn(jf, VARS, n_out,
                                  jax_analyze(jf, VARS, n_out), shapes)
    jv, vjp = jax.vjp(jsq, extract_mlp_layers(params), jnp.asarray(w),
                      jnp.asarray(X))
    jg, jgw, jgx = vjp(jnp.ones((), jv.dtype))
    jax_leaves = [np.asarray(jv).reshape(1)] + \
        [np.asarray(a).reshape(-1) for p in jg for a in p] + \
        [np.asarray(jgw), np.asarray(jgx)]
    _tf32_case_check(f"K3-TF32 at 256 {case}", leaves(val, dflat, gw, gX),
                     leaves(*sq.plain(flat, wt, Xt, emulate_tf32=True)),
                     leaves(*sq.plain(flat, wt, Xt,
                                      emulate_tf32="float64")),
                     [torch.from_numpy(np.array(a)) for a in jax_leaves])


def test_route_k3_member_axis_at_256_tf32_is_each_members_route_bit_for_bit():
    """The member axis at NP = 256 in the TF32 flavor's order (2-256-256-1,
    2 members, N = 517, 5 blocks): each member's outputs equal its
    single-launch mirror bit for bit."""
    _members_case([2, 256, 256, 1], 517, (0.05, 0.02), n_sm=5, mode="tf32")
