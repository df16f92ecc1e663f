"""The 3xTF32 numerics of the kernels' tensor-core products, emulated on
the CPU.

K1-K3 take their hidden-layer products on the tensor cores as three TF32
passes (``csrc/taylor_common.cuh``: ``split_tf32``, ``mma_steps``): each
operand x is split as hi = x rounded to TF32 as ``cvt.rna.tf32.f32``
rounds it (to nearest, ties away from zero, 10 mantissa bits; the kernels
do it with two integer operations on the bits) and lo = x - hi, which the
tensor core truncates to TF32 as it reads it; each k8 step adds lo·hi' +
hi·lo' + hi·hi' into a fresh f32 accumulator, added to the running sum.
The card runs that; here it is emulated bit for bit on the operands (the
int32 view) and in f32 for the sums, at the slice's depth K = 128, and
held to a float64 product of the same f32 inputs.  The kernels are held to
their plain versions at 1e-4 scale-relative (``chip_smoke.py``); the
emulation must sit well inside that.
"""

import numpy as np
import pytest
import torch

from tensordiffeq_tpu_torch.ops.taylor import rna_tf32, trunc_tf32


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels take it: per k8 step, lo·hi', hi·lo', hi·hi'
    into a fresh f32 accumulator, added to the running one.  Products of
    TF32 values are exact in f32, so an f32 matmul of the split operands is
    the tensor core's sum up to its order inside one step."""
    ah = rna_tf32(a)
    al = trunc_tf32(a - ah)
    bh = rna_tf32(b)
    bl = trunc_tf32(b - bh)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + (al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s])
    return acc


def mm_1xtf32(a, b):
    return rna_tf32(a) @ rna_tf32(b)


def test_rna_rounds_half_away_from_zero_to_ten_bits():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(rna_tf32(x), want)
    # the low 13 bits are clear, and hi + lo carries x to 2^-21 or better,
    # with lo rounded or, as the tensor core reads it, truncated
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(10_000).astype(np.float32) * 10.0)
    hi = rna_tf32(v)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    for lo in (rna_tf32(v - hi), trunc_tf32(v - hi)):
        rel = ((hi.double() + lo.double() - v.double()).abs()
               / v.double().abs()).max()
        assert float(rel) <= 2.0 ** -21


def _operands(kind, rng):
    """The three product kinds of the slice at K = 128: the forward H·W
    (tanh values times glorot weights), dH = dP·Wᵀ and dW = Hᵀ·dP (a sum
    over 128 wavefront rows)."""
    H = np.tanh(rng.randn(128, 128)).astype(np.float32)
    W = (rng.randn(128, 128) / np.sqrt(128)).astype(np.float32)
    dP = (rng.randn(128, 128) * 1e-2).astype(np.float32)
    return {"forward": (H, W), "dH": (dP, W.T.copy()),
            "dW": (H.T.copy(), dP)}[kind]


@pytest.mark.parametrize("kind", ["forward", "dH", "dW"])
def test_3xtf32_product_is_f32_grade_at_depth_128(kind):
    rng = np.random.RandomState(1)
    a, b = _operands(kind, rng)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    three = mm_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).double()
    err3 = float(np.abs(three.numpy() - ref).max() / scale)
    f32 = (torch.from_numpy(a) @ torch.from_numpy(b)).double().numpy()
    err32 = float(np.abs(f32 - ref).max() / scale)
    one = mm_1xtf32(torch.from_numpy(a), torch.from_numpy(b)).double()
    err1 = float(np.abs(one.numpy() - ref).max() / scale)
    # 3xTF32 sits with plain f32, two decades inside the kernels' 1e-4
    assert err3 <= 1e-6, err3
    assert err3 <= 4 * max(err32, 2.0 ** -24), (err3, err32)
    # a single TF32 pass would not: that is why the kernels take three
    assert err1 >= 30 * err3, (err1, err3)
