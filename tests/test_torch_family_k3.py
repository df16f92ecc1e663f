"""The minimax step over a surrogate factory's member axis
(``ops/minimax.py::build_family_sq_fn`` and ``make_minimax_residual_loss``
over it; on the card ``ops/cuda_minimax.py::k3_minimax_family``, one K3
launch over the members per tape group) on the CPU, at micro widths.

* The member-axis unit's plain flavor (the CPU path and the kernel's
  referee) is each member's ``sq.plain`` on its slice, stacked, bit for
  bit: the value and every leaf; through autograd each member's gradients
  are its own unit's scaled by its entry of the incoming ``[M]``; the
  residual loss over the member axis equals each member's single-network
  loss bit for bit under every λ mode and for a 2-equation system.
* The factory's step 0 on the minimax engine (the member-axis call)
  against the JAX package's ``SurrogateFactory`` on its fused-minimax
  engine (the vmapped XLA minimax step) from the same weights
  (``weights.params_from_jax``), draw and λ: the loss components within
  rtol 5e-3 and the gradients within ``crosscheck_grads``' rtol 5e-3.
* Tape groups: the AC sweep is one group; a member whose θ equals a
  constant of its residual (θ = 5.0 beside ``5u³``) lowers to other ops
  and takes a group of its own; a group's constant table is its members'
  ``ResidualTape.encode()`` floats.
* The launch's work items and slots at the factory benchmark's shape (64
  members, N = 2,048) and at AC-SA full (2 members, N = 50,000), on a
  132-SM card: every member's slots written once each, in the single
  launch's tile order.
* The family's ascent mover, one member-axis score per step, is bit for
  bit each member moved on its own by its own K3 function.
"""

import numpy as np
import pytest
import torch

import jax

import tensordiffeq_tpu as tdq
import tensordiffeq_tpu_torch as tdqt
from tensordiffeq_tpu.factory import member_slice as jax_member_slice
from tensordiffeq_tpu_torch.factory import SurrogateFactory
from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
from tensordiffeq_tpu_torch.ops import resampling as trs
from tensordiffeq_tpu_torch.ops.fused import crosscheck_grads
from tensordiffeq_tpu_torch.ops.minimax import (build_family_sq_fn,
                                                build_minimax_sq_fn,
                                                make_minimax_residual_loss,
                                                tape_groups)
from tensordiffeq_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
AC = {(), (1,), (0, 0)}
VARS = ("x", "t")
WIDTHS = [2, 12, 12, 1]
SHAPES = list(zip(WIDTHS[:-1], WIDTHS[1:]))
THETAS = [1e-4, 5e-3, 5.0, 2e-2]  # member 2: θ equal to 5u³'s constant
N = 96
RTOL = 5e-3


def _ac(th, pkg=tdqt):
    grad = pkg.grad

    def f(u, x, t):
        uv = u(x, t)
        return (grad(u, "t")(x, t) - th * grad(grad(u, "x"), "x")(x, t)
                + 5.0 * uv ** 3 - 5.0 * uv)
    return f


def _system(th):
    grad = tdqt.grad

    def f(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        return (grad(u[0], "t")(x, t) + th * grad(grad(u[1], "x"), "x")(x, t)
                + sq * vv,
                grad(u[1], "t")(x, t) - th * grad(grad(u[0], "x"), "x")(x, t)
                - sq * uv)
    return f


def _members(thetas, make=_ac, n_out=1):
    shapes = SHAPES[:-1] + [(WIDTHS[-2], n_out)]
    reqs = AC if n_out == 1 else {(), (1,), (0, 0)}
    return [build_minimax_sq_fn(make(th), VARS, n_out, reqs, shapes,
                                device="cpu") for th in thetas]


def _inputs(M, n_out=1, E=1, seed=0):
    """Seeded numpy inputs: stacked 2-D layers, X [M, N, 2], w [M, N, E]."""
    rng = np.random.RandomState(seed)
    widths = WIDTHS[:-1] + [n_out]
    flat = []
    for a, b in zip(widths[:-1], widths[1:]):
        flat.append(torch.from_numpy(
            (rng.randn(M, a, b) / np.sqrt(a)).astype(np.float32)))
        flat.append(torch.from_numpy(
            (0.1 * rng.randn(M, 1, b)).astype(np.float32)))
    X = torch.from_numpy(np.stack(
        [rng.uniform(-1, 1, (M, N)), rng.uniform(0, 1, (M, N))],
        2).astype(np.float32))
    w = torch.from_numpy(rng.rand(M, N, E).astype(np.float32))
    return flat, X, w


def _params(flat):
    """The factory's stacked leaves: W [M, in, out], b [M, out]."""
    return [t if i % 2 == 0 else t.reshape(t.shape[0], -1)
            for i, t in enumerate(flat)]


def test_family_plain_is_each_members_plain_bit_for_bit():
    sqs = _members(THETAS)
    fam = build_family_sq_fn(sqs, device="cpu")
    flat, X, w = _inputs(len(sqs))
    val, gflat, gw, gX = fam.plain(flat, w, X)
    assert val.shape == (len(sqs),) and gw.shape == w.shape
    for m, sq in enumerate(sqs):
        v, g, gwm, gXm = sq.plain([t[m] for t in flat], w[m], X[m])
        assert torch.equal(val[m], v)
        assert torch.equal(gw[m], gwm) and torch.equal(gX[m], gXm)
        for a, b in zip(gflat, g):
            assert torch.equal(a[m], b)
    # through autograd: member m's gradients are its unit's, scaled by its
    # entry of the incoming [M]
    leaves = [t.clone().requires_grad_(True) for t in flat]
    scale = torch.tensor([1.0, -2.0, 0.5, 3.0])
    vals = fam(list(zip(leaves[0::2], leaves[1::2])), w, X)
    assert torch.equal(vals.detach(), val)
    grads = torch.autograd.grad(torch.sum(scale * vals), leaves)
    for m, sq in enumerate(sqs):
        ml = [t[m].detach().clone().requires_grad_(True) for t in flat]
        v = sq(list(zip(ml[0::2], ml[1::2])), w[m], X[m])
        want = torch.autograd.grad(scale[m] * v, ml)
        for a, b in zip(grads, want):
            assert torch.equal(a[m], b)


def _lam_cases(M):
    rng = np.random.RandomState(5)
    per_point = torch.from_numpy(rng.rand(M, N, 1).astype(np.float32))
    scalar = torch.from_numpy(rng.rand(M, 1).astype(np.float32))
    return {"none": (dict(), [None]),
            "per-point": (dict(), [per_point]),
            "g": (dict(g=lambda lam: lam ** 2 + 0.5), [per_point]),
            "type-2": (dict(weight_outside_sum=True), [scalar])}


@pytest.mark.parametrize("mode", ["none", "per-point", "g", "type-2"])
def test_family_residual_loss_is_each_members_loss_bit_for_bit(mode):
    sqs = _members(THETAS)
    kw, lams = _lam_cases(len(sqs))[mode]
    fam = build_family_sq_fn(sqs, device="cpu")
    loss = make_minimax_residual_loss(fam, **kw)
    flat, X, _ = _inputs(len(sqs))
    params = _params(flat)
    got = loss(params, lams, X)
    for m, sq in enumerate(sqs):
        one = make_minimax_residual_loss(sq, **kw)
        want = one([t[m] for t in params],
                   [None if lam is None else lam[m] for lam in lams], X[m])
        assert torch.equal(got[m], want), m


def test_family_residual_loss_system_is_each_members_loss_bit_for_bit():
    thetas = [0.5, 0.25, 1.0]
    sqs = _members(thetas, make=_system, n_out=2)
    assert sqs[0].n_equations == 2
    fam = build_family_sq_fn(sqs, device="cpu")
    M = len(sqs)
    rng = np.random.RandomState(2)
    lams = [torch.from_numpy(rng.rand(M, N, 1).astype(np.float32)), None]
    flat, X, _ = _inputs(M, n_out=2, E=2)
    params = _params(flat)
    got = make_minimax_residual_loss(fam)(params, lams, X)
    for m, sq in enumerate(sqs):
        want = make_minimax_residual_loss(sq)(
            [t[m] for t in params], [lams[0][m], None], X[m])
        assert torch.equal(got[m], want), m


@pytest.mark.parametrize("flavor", ["f32", "bf16", "tf32"])
def test_member_axis_wrappers_by_flavor_and_the_cpu_path(flavor):
    """Each flavor's member-axis K3 has its own counted wrapper
    (``k3_minimax_family``, ``k3_minimax_family_bf16``,
    ``k3_minimax_family_tf32``), reset with the others; CPU tensors take the
    plain flavor (each member's own, bit for bit) and launch nothing, and
    the wrapper itself refuses them."""
    kw = {"f32": {}, "bf16": dict(compute_dtype="bfloat16"),
          "tf32": dict(precision="default")}[flavor]
    wrapper = {"f32": cm.k3_minimax_family,
               "bf16": cm.k3_minimax_family_bf16,
               "tf32": cm.k3_minimax_family_tf32}[flavor]
    sqs = [build_minimax_sq_fn(_ac(th), VARS, 1, AC, SHAPES, device="cpu",
                               **kw) for th in THETAS[:2]]
    fam = build_family_sq_fn(sqs, device="cpu")
    assert cm.FAMILY_FLAVORS[fam.flavor] is wrapper
    assert cm.FLAVORS[fam.flavor] is cm.FLAVORS[sqs[0].flavor]
    assert wrapper in ct.COUNTED
    wrapper.launches = 5
    ct.reset_launch_counts()
    assert wrapper.launches == 0
    flat, X, w = _inputs(2)
    val, gflat, gw, gX = fam.value_and_grads(flat, w, X)
    for m, sq in enumerate(sqs):
        v, g, gwm, gXm = sq.plain([t[m] for t in flat], w[m], X[m])
        assert torch.equal(val[m], v) and torch.equal(gX[m], gXm)
        assert all(torch.equal(a[m], b) for a, b in zip(gflat, g))
    assert wrapper.launches == 0 and fam.k3_routes == {}
    packed = torch.cat([t.reshape(2, -1) for t in flat], 1)
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(sqs[0].plan, X, w, packed, fam.constants[0])


def test_tape_groups_and_constant_tables():
    """The AC sweep is one group; θ = 5.0 (equal to 5u³'s constant) folds
    into that constant's slot, so its ops differ: a group of its own; each
    group's table is its members' encode() floats."""
    sweep = _members([1e-4 * (0.5 + m / 7) for m in range(8)])
    assert tape_groups(sweep) == [list(range(8))]
    sqs = _members(THETAS)
    fam = build_family_sq_fn(sqs, device="cpu")
    assert fam.groups == [[0, 1, 3], [2]]
    assert sqs[2].plan.tape.consts == (5.0, 3.0)
    for group, table in zip(fam.groups, fam.constants):
        assert table.shape == (len(group), ct.MAX_TAPE_CONSTS)
        assert table.dtype == torch.float32
        for row, m in zip(table, group):
            want = torch.tensor(sqs[m].plan.tape.encode()[1],
                                dtype=torch.float32)
            assert torch.equal(row, want)
    with pytest.raises(ValueError, match="share"):
        build_family_sq_fn([sqs[0]] + _members([1e-3], make=_system,
                                               n_out=2), device="cpu")


# the factory benchmark's shape and AC-SA full, on an H100 (132 SMs and
# 232,448 bytes of opt-in shared memory a block)
H100_SMS, H100_SMEM = 132, 232_448
PLANS = {"factory": ([2, 64, 64, 1], 64, 2_048),
         "ac-sa-full": ([2, 128, 128, 128, 128, 1], 2, 50_000)}


@pytest.mark.parametrize("case", list(PLANS))
def test_family_launch_work_items_and_slots(case):
    widths, M, n = PLANS[case]
    shapes = list(zip(widths[:-1], widths[1:]))
    sq = build_minimax_sq_fn(_ac(1e-4), VARS, 1, AC, shapes, device="cpu")
    plan = sq.plan
    wp = ct.wb_plan(plan.layer_shapes, plan.orders, 0, H100_SMEM, H100_SMS,
                    n)
    fl = cm.family_launch(plan, wp, M, H100_SMS)
    want = {"factory": dict(n_tiles=64, G=64, items=4096, grid=132),
            "ac-sa-full": dict(n_tiles=1563, G=132, items=264, grid=132)}
    w = want[case]
    assert (wp.n_tiles, fl.G, fl.items, fl.grid) == (
        w["n_tiles"], w["G"], w["items"], w["grid"])
    L = len(shapes)
    assert fl.ws_floats == (fl.grid * (L - 1) * ct.WB_ROWS * wp.NP
                            + M * wp.P * wp.stage_bytes // 4)
    # every slot j = m·G + b written by one block, its tiles b, b + G, ...
    slots = {}
    per_block = []
    for blk in range(fl.grid):
        items = cm.family_items(fl, blk)
        per_block.append(len(items))
        for m, b in items:
            assert (m, b) not in slots
            slots[(m, b)] = list(range(b, wp.n_tiles, fl.G))
    assert sorted(slots) == [(m, b) for m in range(M) for b in range(fl.G)]
    for m in range(M):
        tiles = sorted(t for b in range(fl.G) for t in slots[(m, b)])
        assert tiles == list(range(wp.n_tiles))
    if case == "factory":
        # 4,096 one-tile items over 132 blocks: 31 or 32 each
        assert sorted(set(per_block)) == [31, 32]
        assert sum(per_block) == 4096
    else:
        # each block one item of each member: the single launch's share
        assert per_block == [2] * 132
        assert cm.family_items(fl, 5) == [(0, 5), (1, 5)]


def test_family_ascent_move_is_each_members_move_bit_for_bit():
    """One member-axis score per mover step: the redraw equals each member
    moved by its own K3 function's scores and swapped on its own stream."""
    sqs = _members([1e-4, 5e-3, 2e-2])
    fam = build_family_sq_fn(sqs, device="cpu")
    flat, X, _ = _inputs(len(sqs))
    params = _params(flat)
    xl = np.array([[-1.0, 1.0], [0.0, 1.0]])

    def fam_score(p, Xv):
        fl = [a if a.ndim == 3 else a.reshape(a.shape[0], 1, -1) for a in p]
        w = torch.ones(tuple(Xv.shape[:2]) + (1,))
        _, _, gw, gX = fam.value_and_grads(fl, w, Xv.contiguous())
        return torch.sum(gw, 2), gX

    kw = dict(n_steps=3, step_frac=0.01, fresh_frac=0.25, seed=4)
    famr = trs.FamilyAscentResampler(None, xl, N, len(sqs),
                                     family_score_grad_fn=fam_score, **kw)
    got = famr.redraw(params, X, [0, 1, 2], epoch=7)
    for m, sq in enumerate(sqs):
        def score(p, Xv, _sq=sq):
            fl = [a if a.ndim == 2 else a.reshape(1, -1) for a in p]
            _, _, gw, gX = _sq.value_and_grads(
                fl, torch.ones((Xv.shape[0], 1)), Xv.contiguous())
            return torch.sum(gw, 1), gX
        one = trs.AscentResampler(None, xl, N, score_grad_fn=score, **kw)
        want = one.redraw([t[m] for t in params], X[m], 7, member=m)
        assert torch.equal(got.X_new[m], want.X_new)
        assert torch.equal(got.idx[m], want.idx)
        assert torch.equal(got.kept[m], want.kept)
        for k in want.stats:
            assert torch.equal(got.stats[k][m], want.stats[k])


# --------------------------------------------------------------------------- #
# the factory's step 0 against the JAX package's fused-minimax family
# --------------------------------------------------------------------------- #
N_F = 256
FAC_THETAS = [0.001, 0.01, 0.02]
SA_KW = dict(
    Adaptive_type=1,
    dict_adaptive={"residual": [True], "BCs": [False] * 3},
    init_weights={"residual": [np.ones((N_F, 1))], "BCs": [None] * 3})


def _domain(pkg):
    d = pkg.DomainND(["x", "t"], time_var="t")
    d.add("x", [-1.0, 1.0], 32)
    d.add("t", [0.0, 1.0], 8)
    d.generate_collocation_points(N_F, seed=0)
    return d


def _bcs(pkg, d):
    return [pkg.IC(d, [lambda x: x ** 2 * np.cos(np.pi * x)], var=[["x"]]),
            pkg.dirichletBC(d, val=0.0, var="x", target="upper"),
            pkg.dirichletBC(d, val=0.0, var="x", target="lower")]


def _fam_model(pkg):
    grad = pkg.grad

    def f(u, x, t, th):
        return grad(u, "t")(x, t) - th * grad(grad(u, "x"), "x")(x, t) \
            + 5.0 * u(x, t) ** 3 - 5.0 * u(x, t)
    return f


def test_factory_step0_matches_jax_fused_minimax_family():
    d = _domain(tdq)
    jfac = tdq.SurrogateFactory(WIDTHS, _fam_model(tdq), d, _bcs(tdq, d),
                                thetas=FAC_THETAS, verbose=False, **SA_KW)
    assert jfac.engine == "fused-minimax"
    M = len(FAC_THETAS)
    init = [params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_member_slice(jfac.params, m)), device="cpu")
        for m in range(M)]
    dt = _domain(tdqt)
    fac = SurrogateFactory(WIDTHS, _fam_model(tdqt), dt, _bcs(tdqt, dt),
                           thetas=FAC_THETAS, verbose=False, device="cpu",
                           init_params=init, **SA_KW)
    assert fac.engine == "fused-minimax"
    assert fac._family_res.family.groups == [[0, 1, 2]]
    trainables = {"params": jfac.params, "lambdas": jfac.lambdas}
    jt, jc, jg, _ = jax.vmap(jfac._member_vg)(trainables, jfac.X_f,
                                                jfac.thetas)
    _, comps = fac._family_loss(fac.params, fac.lambdas["BCs"],
                                fac.lambdas["residual"], fac.X_f)
    for key, got in comps.items():
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jc[key]),
                                   rtol=RTOL, err_msg=key)
    totals, g_params, g_lam = fac._family_value_and_grads(
        fac.params, fac.lambdas, fac.X_f)
    np.testing.assert_allclose(totals.numpy(), np.asarray(jt), rtol=RTOL)
    for m in range(M):
        want = [t for pair in params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_member_slice(jg["params"], m)), device="cpu")
            for t in pair]
        want.append(torch.from_numpy(np.array(
            jg["lambdas"]["residual"][0][m])))
        got = [g[m] for g in g_params] + [g_lam[0][m]]
        ok, why = crosscheck_grads(want, got)
        assert ok, (m, why)
