"""The bf16 flavor's products on the bf16 tensor cores, emulated on the CPU.

K2-bf16 and K3-bf16 (``csrc/taylor_common.cuh``: ``split_pieces``,
``bmma_steps``) take their products on bf16 operands in shared memory:
the stack and W rounded to bf16 (to nearest even, as
``__float2bfloat16_rn`` and torch's ``to(torch.bfloat16)`` round), and the
f32 cotangent x cut once into three bf16 pieces, hi = rn(x), mid = rn(x -
hi), lo = rn(x - hi - mid), whose sum is x exactly.  A bf16 x bf16 product
is exact in f32, and each k16 step adds one m16n8k16 pass per piece,
smallest first, straight into the running f32 sum.  Here that route is
emulated bit for bit on the operands, with the sums in f32, at the slice's
depth 128 for its three product kinds (the forward H·W, dH = dP·Wᵀ, dW =
Hᵀ·dP), and held to a float64 product of the operands as the plain bf16
flavor rounds them (``ops/taylor.py``: the stack and W rounded, the
cotangent not), and beside the flavor's earlier route: TF32 passes, the
cotangent split
as hi = x rounded to TF32 and lo = x - hi truncated to TF32 as the tensor
core reads it (22 bits), each k8 step into a fresh accumulator added to
the running one.  The kernels are held to the plain bf16 flavor within the
reference's bands (``chip_smoke.py``); the emulated route must sit far
inside them, and at least as close as the TF32-pass route.
"""

import numpy as np
import pytest
import torch


def rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split3(x: torch.Tensor):
    """The kernels' three pieces of an f32 x: (hi, mid, lo), each a bf16
    value, the subtractions exact in f32."""
    hi = rn(x)
    mid = rn(x - hi)
    lo = rn(x - hi - mid)
    return hi, mid, lo


def rna_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x):
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_bf16_route(a_pieces, b_pieces) -> torch.Tensor:
    """``sum_p A_p @ B_p`` as the kernels take it: per k16 step, one pass
    per piece (the pieces smallest first; the operand without pieces
    repeats), each added straight into the running f32 sum."""
    n = max(len(a_pieces), len(b_pieces))
    a_pieces = list(a_pieces) * (n // len(a_pieces))
    b_pieces = list(b_pieces) * (n // len(b_pieces))
    acc = torch.zeros(a_pieces[0].shape[0], b_pieces[0].shape[1])
    for k in range(0, a_pieces[0].shape[1], 16):
        s = slice(k, k + 16)
        for a, b in zip(a_pieces, b_pieces):
            acc = acc + a[:, s] @ b[s]
    return acc


def mm_tf32_route(a, b, split_a: bool, split_b: bool) -> torch.Tensor:
    """The earlier route's TF32 passes: rounded operands as they are, the cotangent as
    rna_tf32 + the rest truncated, per k8 step lo*b + hi*b into a fresh
    accumulator added to the running one."""
    def parts(x, split):
        if not split:
            return [x]
        hi = rna_tf32(x)
        return [trunc_tf32(x - hi), hi]
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        fresh = torch.zeros_like(acc)
        for pa in parts(a[:, s], split_a):
            for pb in parts(b[s], split_b):
                fresh = fresh + pa @ pb
        acc = acc + fresh
    return acc


def _operands(kind, rng):
    """The slice's three product kinds at depth 128 (as
    ``tests/test_torch_tf32.py``), the stack and W rounded to bf16 as the
    plain bf16 flavor rounds them; the cotangent f32.  Returns (A, B,
    which side is the cotangent)."""
    H = rn(torch.from_numpy(np.tanh(rng.randn(128, 128)).astype(np.float32)))
    W = rn(torch.from_numpy((rng.randn(128, 128) / np.sqrt(128))
                            .astype(np.float32)))
    dP = torch.from_numpy((rng.randn(128, 128) * 1e-2).astype(np.float32))
    return {"forward": (H, W, None), "dH": (dP, W.T.contiguous(), "a"),
            "dW": (H.T.contiguous(), dP, "b")}[kind]


def test_split_is_exact_in_three_bf16_pieces():
    rng = np.random.RandomState(0)
    mags = 10.0 ** rng.uniform(-30, 30, 20_000)
    x = torch.from_numpy((rng.randn(20_000) * mags).astype(np.float32))
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0, -3.0, 2.0 ** -126,
                                    np.float32(np.pi)])])
    hi, mid, lo = split3(x)
    for piece in (hi, mid, lo):
        assert torch.equal(rn(piece), piece)
    # 8 + 8 + 8 significant bits: every f32 of normal range, exactly
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal((hi + mid) + lo, x)
    # each piece is at most half a bf16 unit of the one before
    nz = hi != 0
    assert bool((mid[nz].abs() <= hi[nz].abs() * 2.0 ** -8).all())
    assert bool((lo[nz].abs() <= hi[nz].abs() * 2.0 ** -16).all())
    # two TF32 pieces (the earlier route) leave up to 2^-22 of x out
    two = rna_tf32(x) + trunc_tf32(x - rna_tf32(x))
    assert float(((two.double() - x.double()).abs()
                  / x.double().abs().clamp_min(1e-38)).max()) > 2.0 ** -25


def test_bf16_products_are_exact_in_f32():
    rng = np.random.RandomState(1)
    a = rn(torch.from_numpy(rng.randn(100_000).astype(np.float32)))
    b = rn(torch.from_numpy((rng.randn(100_000) * 1e-3).astype(np.float32)))
    assert torch.equal((a * b).double(), a.double() * b.double())


@pytest.mark.parametrize("kind", ["forward", "dH", "dW"])
def test_bf16_route_holds_the_plain_flavors_rounding_at_depth_128(kind):
    rng = np.random.RandomState(2)
    a, b, side = _operands(kind, rng)
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    if side is None:
        got = mm_bf16_route([a], [b])
    elif side == "a":
        got = mm_bf16_route(split3(a)[::-1], [b])
    else:
        got = mm_bf16_route([a], split3(b)[::-1])
    err = float((got.double() - ref).abs().max()) / scale
    rms = float((got.double() - ref).pow(2).mean().sqrt()) / scale
    tf32 = mm_tf32_route(a, b, side == "a", side == "b")
    err_tf32 = float((tf32.double() - ref).abs().max()) / scale
    rms_tf32 = float((tf32.double() - ref).pow(2).mean().sqrt()) / scale
    # the route is the f32 sum of exact products: f32 grade, four decades
    # inside bf16's own rounding (2^-9) and the kernels' bands
    assert err <= 1e-6, err
    # at least as close as the two TF32 passes (whose cotangent lost up to
    # 2^-22 of itself) by RMS; its worst element within the f32 sums'
    # spread of theirs (three passes per k16 step add to the running sum
    # where the TF32 route added one fresh sum per k8 step)
    assert rms <= rms_tf32, (rms, rms_tf32)
    assert err <= 1.5 * err_tf32, (err, err_tf32)
    # and the plain f32 product (the cotangent against the unrounded
    # operand) is far: rounding where the reference rounds is what counts
    f32 = {"forward": None, "dH": "W", "dW": "H"}[kind]
    if f32 is not None:
        raw = np.random.RandomState(2)
        H32 = torch.from_numpy(np.tanh(raw.randn(128, 128)).astype(np.float32))
        W32 = torch.from_numpy((raw.randn(128, 128) / np.sqrt(128))
                               .astype(np.float32))
        want32 = (a.double() @ W32.T.double() if kind == "dH"
                  else H32.T.double() @ b.double())
        assert float((got.double() - want32).abs().max()) / scale > 100 * err


def test_pieces_smallest_first_in_k16_steps():
    """The order the kernels take: per k16 step lo, mid, hi.  Summed in
    another order (hi first, or all of a piece's steps before the next
    piece's) the f32 result differs in its last bits, so the emulation
    pins the one the kernels run."""
    rng = np.random.RandomState(3)
    a, b, _ = _operands("dH", rng)
    lo_first = mm_bf16_route(split3(a)[::-1], [b])
    hi_first = mm_bf16_route(split3(a), [b])
    assert not torch.equal(lo_first, hi_first)
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    for got in (lo_first, hi_first):
        assert float((got.double() - ref).abs().max()) / scale <= 1e-6
