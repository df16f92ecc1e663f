"""K1's persistent wgmma route (``csrc/taylor_fwd_wg.cuh``), the parts that
live on the host and the arithmetic it relies on, on the CPU:

* the plain mirror of the weight preparation (``ops/cuda_taylor.py::
  wg_prepare``): the f32 flavor's two planes add up to W exactly, the hi
  plane is TF32 (its low 13 bits zero, W rounded to nearest), the bf16
  plane is W rounded to nearest even, and reading the planes back through
  the core-matrix layout and the k-slot order gives W^T, zero-padded;
* the register chaining of ``csrc/wgmma.cuh``: the accumulator registers
  a lane holds, taken in the order the route takes them, are the A
  fragment that ``wgmma`` reads for the next product, tf32 (with the k-slot
  permutation) and bf16 (in k's natural order);
* a float64 emulation of the three TF32 passes (A_lo B_hi + A_hi B_lo +
  A_hi B_hi, lo truncated to TF32 as the tensor cores read it) against
  the exact product of the f32 operands: within 2^-20 relative per product;
* the host's choice of route by shape (``wg_plan``), and the shared memory,
  stages and grid it gives the slice's shapes.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

SMEM, SMS = 232_448, 132  # an H100's opt-in shared memory a block, SMs
AC = {(), (1,), (0, 0)}
MIXED = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}


def _layers(widths, seed=0):
    g = torch.Generator().manual_seed(seed)
    flat = []
    for a, b in zip(widths[:-1], widths[1:]):
        flat += [torch.randn(a, b, generator=g) / a ** 0.5,
                 0.1 * torch.randn(b, generator=g)]
    return flat


def _plan(reqs, widths, bf16, N=1000):
    plan = ct.build_cuda_table_fn(reqs, list(zip(widths[:-1], widths[1:])),
                                  device="cpu").plan
    return plan, ct.wg_plan(plan.layer_shapes, plan.orders, bf16, SMEM, SMS,
                            N)


def _unpack(chunks, wp, bf16):
    """The prepared chunks read back: per chunk the (NP, KC) plane(s) in
    k-slot order, through the core-matrix offsets."""
    NP, KC = wp.NP, wp.KC
    epc = 8 if bf16 else 4
    n = np.arange(NP)[:, None]
    kq = np.arange(KC)[None, :]
    off = ((n // 8) * (KC // epc) + kq // epc) * (8 * epc) + (n % 8) * epc \
        + kq % epc
    out = []
    for q in range(wp.P):
        raw = chunks[q * wp.stage_bytes:(q + 1) * wp.stage_bytes]
        if bf16:
            plane = raw.view(torch.bfloat16).float().numpy()
            out.append((plane[off],))
        else:
            planes = raw.view(torch.float32).numpy().reshape(2, NP * KC)
            out.append((planes[0][off], planes[1][off]))
    return out


@pytest.mark.parametrize("widths", [[2, 128, 128, 128, 1], [2, 37, 53, 1],
                                    [3, 64, 64, 64, 2]],
                         ids=["ac", "odd", "deep"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_weight_prep_mirror_is_exact_and_round_trips(widths, bf16):
    flat = _layers(widths)
    _, wp = _plan(AC, widths, bf16)
    chunks = ct.wg_prepare(flat, wp, bf16)
    assert chunks.numel() == wp.P * wp.stage_bytes
    slots = np.array(ct.wg_kslots(wp.KC, bf16))
    assert sorted(slots) == list(range(wp.KC))  # a permutation of k
    per_layer = wp.NP // wp.KC
    for q, planes in enumerate(_unpack(chunks, wp, bf16)):
        W = flat[2 * (1 + q // per_layer)]
        fi, fo = W.shape
        pad = np.zeros((wp.NP, wp.NP), np.float32)
        pad[:fo, :fi] = W.t().numpy()
        # k slot j of the chunk holds input column k0 + slots[j]
        want = pad[:, (q % per_layer) * wp.KC + slots]
        if bf16:
            expect = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(planes[0], expect)
            continue
        hi, lo = planes
        np.testing.assert_array_equal(hi + lo, want)  # exactly, in f32
        assert not (hi.view(np.uint32) & 0x1FFF).any()  # hi is TF32
        # rounded to nearest: lo is at most half of hi's last TF32 place
        ulp = np.ldexp(1.0, np.frexp(np.abs(hi))[1] - 11)
        assert (np.abs(lo) <= ulp / 2 + 1e-45).all()


def _lanes():
    for w in range(4):
        for lane in range(32):
            yield w, lane // 4, lane % 4


def _acc(H, w, g, t, NP):
    """The accumulator registers of lane 4g + t of warp w holding H (64 x
    NP): n8 block i // 4, columns 2t and 2t + 1, rows g and g + 8."""
    return [H[16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)]
            for i in range(NP // 2)]


@pytest.mark.parametrize("NP", [64, 128])
def test_accumulator_registers_are_the_next_products_a_fragments(NP):
    H = np.arange(64 * NP, dtype=np.float64).reshape(64, NP)
    slots = ct.wg_kslots(NP, False)
    for w, g, t in _lanes():
        acc = _acc(H, w, g, t, NP)
        r0, r1 = 16 * w + g, 16 * w + g + 8
        for s in range(NP // 8):
            # tf32 m64nNk8, as the route takes them: d[4s], d[4s+2],
            # d[4s+1], d[4s+3]; wgmma's A fragment: (g, t), (g+8, t),
            # (g, t+4), (g+8, t+4) of the step's k slots
            got = [acc[4 * s], acc[4 * s + 2], acc[4 * s + 1],
                   acc[4 * s + 3]]
            k = [slots[8 * s + t], slots[8 * s + t + 4]]
            assert got == [H[r0, k[0]], H[r1, k[0]], H[r0, k[1]],
                           H[r1, k[1]]]
        for s in range(NP // 16):
            # bf16 m64nNk16: d[8s .. 8s+7] in pairs; wgmma's A fragment:
            # (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..9), (g+8, 2t+8..9)
            got = acc[8 * s:8 * s + 8]
            c = 16 * s + 2 * t
            assert got == [H[r0, c], H[r0, c + 1], H[r1, c], H[r1, c + 1],
                           H[r0, c + 8], H[r0, c + 9], H[r1, c + 8],
                           H[r1, c + 9]]


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read an f32 operand as TF32: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def test_three_tf32_passes_within_2_to_the_minus_20_per_product():
    rng = np.random.RandomState(0)
    for scale in (1e-3, 1.0, 1e3):
        a = torch.from_numpy((rng.randn(4096) * scale).astype(np.float32))
        b = torch.from_numpy(rng.randn(4096).astype(np.float32))
        ah, al = ct.split_tf32(a)
        bh, bl = ct.split_tf32(b)
        al, bl = _tf32_truncated(al), _tf32_truncated(bl)
        assert torch.equal(_tf32_truncated(ah), ah)
        f64 = lambda t: t.double()  # noqa: E731
        three = f64(al) * f64(bh) + f64(ah) * f64(bl) + f64(ah) * f64(bh)
        exact = f64(a) * f64(b)
        rel = ((three - exact).abs() / exact.abs().clamp_min(1e-300)).max()
        assert float(rel) <= 2.0 ** -20, (scale, float(rel))
        # a 128-deep dot product: the same bound on the sum of |a b|
        a2, b2 = a.view(32, 128), b.view(32, 128)
        dots = (three.view(32, 128)).sum(1)
        want = (f64(a2) * f64(b2)).sum(1)
        mag = (f64(a2) * f64(b2)).abs().sum(1)
        assert float(((dots - want).abs() / mag).max()) <= 2.0 ** -20


def test_route_choice_by_shape():
    # the slice: f32 streams six 64 KB chunks through three stages, bf16
    # keeps its three 32 KB layers resident; one block per SM
    f32 = _plan(AC, [2, 128, 128, 128, 128, 1], False, 50_000)[1]
    assert f32 == ct.WgPlan(NP=128, CP=4, KC=64, S=3, P=6, resident=0,
                            stage_bytes=65_536, n_tiles=1563, grid=132,
                            smem=200_384)
    bf = _plan(AC, [2, 128, 128, 128, 128, 1], True, 50_000)[1]
    assert (bf.S, bf.P, bf.resident, bf.stage_bytes, bf.smem, bf.n_tiles) \
        == (3, 3, 1, 32_768, 102_080, 1042)  # tiles of 48 points
    # the mixed request set: 8 channels, 16 points a tile
    mixed = _plan(MIXED, [2, 128, 128, 128, 128, 1], False, 50_000)[1]
    assert (mixed.CP, mixed.n_tiles) == (8, 3125)
    # channels pad to a power of two; narrow layers pad to 64
    odd = _plan({(), (1,), (1, 1)}, [2, 37, 53, 1], False, 1003)[1]
    assert (odd.CP, odd.NP, odd.P, odd.resident) == (4, 64, 1, 1)
    assert _plan({()}, [2, 16, 16, 1], False, 5)[1].CP == 1
    assert _plan({(), (0,)}, [2, 16, 16, 1], True, 5)[1].CP == 2
    # a net with no hidden product: no stages
    assert _plan(MIXED, [2, 16, 1], True, 1)[1][3:6] == (0, 0, 1)
    # few points: one tile, one block
    assert _plan(AC, [2, 64, 64, 1], False, 5)[1][7:9] == (1, 1)
    # the other route: a layer over 128, more than 8 channels, more than 16
    # inputs or outputs
    assert _plan(AC, [2, 200, 40, 1], False)[1] is None
    assert _plan({(), (0,), (2,), (1, 1), (0, 1, 2)}, [3, 64, 64, 1],
                 False)[1] is None
    assert _plan(AC, [17, 64, 64, 1], False)[1] is None
    assert _plan(AC, [2, 64, 64, 17], False)[1] is None
    # a card with too little shared memory for two f32 stages
    plan, _ = _plan(AC, [2, 128, 128, 128, 1], False)
    assert ct.wg_plan(plan.layer_shapes, plan.orders, False, 100_000, SMS,
                      1000) is None
    # every plan fits the card it was made for
    for reqs in (AC, MIXED):
        for widths in ([2, 128, 128, 128, 128, 1], [2, 64, 64, 1],
                       [2] + [32] * 14 + [1]):
            for bf16 in (False, True):
                wp = _plan(reqs, widths, bf16, 200_000)[1]
                assert wp.smem <= SMEM and wp.S <= ct.WG_MAX_STAGES
                assert wp.resident == (wp.P <= wp.S)
