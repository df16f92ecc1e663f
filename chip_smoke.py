"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py

Phases (each failure is fatal; exit code != 0, no result line):

1. the card's name and power limit, torch/CUDA versions; TF32 off.
2. build the CUDA kernels from ``tensordiffeq_tpu_torch/csrc`` (nvcc).
3. K1 (Taylor-table forward) against the plain flavor at the slice's full
   shapes (N = 50,000 points, net 2-128x4-1) for the Allen-Cahn request set
   and for a mixed-3rd / unmixed-4th request set.
4. K2 (Taylor-table backward: dW, db, dX) against autograd of the plain
   flavor, same shapes.
5. K3 (the fused minimax step: value, dW/db, gw, gX) against its plain
   flavor, for the Allen-Cahn residual (E = 1, N = 50,000, 2-128x4-1), the
   coupled 2-equation system (E = 2, 2-128x4-2) and a ``1/x`` residual at a
   ragged N = 50,001 (everything finite).
6. the minimax slice, the main path: the Allen-Cahn SA-PINN at its full
   size trained through ``compile(fused="cuda")`` with the default
   ``minimax``, which adopts K3; ``fit(tf_iter=200)`` and ``predict`` on the
   512x201 grid, with the kernels' launch counts read around compile, fit
   and predict (K3 once in compile's cross-check and once per step; K1 and
   K2 not in ``fit``).
7. the unfused path of the first slice, ``compile(fused="cuda",
   minimax=False)``: K1 and K2 once each per step, the same 200 steps, so
   the two paths' ms/step compare within one call.
8. a ``{"kernels": [...]}`` line, the card line again, and the result line.

``--profile`` adds, after phase 7, an A/B of the two trained solvers (50
more steps per turn in eight turns: minimax, unfused, unfused, minimax,
twice), so their ms/step compare within one stretch of the host's load;
then four windows of 20 Adam steps under ``torch.profiler``, the paths in
turns (minimax, unfused, unfused, minimax): the host's time in each of
``fit_adam``'s ranges, device time by kernel group, the device's busy and
idle share, and the top host ops.  The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12       # FP32 on the CUDA cores, no tensor cores
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes/s

# K1/K2 vs their plain flavor: scale-relative max error (max |kernel - plain|
# over max |plain|, per table channel / gradient leaf).  Both sides are IEEE
# f32; they differ only in summation order (128-term dot products per layer
# for K1; K2's weight cotangents also sum 50,000 points x C channels).
# Measured on an H100 at these shapes: <= 2.5e-6 for both.
K1_RTOL = 1e-4
K2_RTOL = 1e-4
# K3 vs its plain flavor, the same measure over the value, every dW/db leaf,
# gw and gX: both sides are IEEE f32 and differ in summation order (the
# value and dW/db sum 50,000 points)
K3_RTOL = 1e-4

AC_REQUESTS = {(), (1,), (0, 0)}
MIXED_REQUESTS = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}
WIDTHS = [2, 128, 128, 128, 128, 1]
N_POINTS = 50_000
TF_ITER = 200  # Adam steps of the slice
AB_STEPS = 50  # steps per turn of the paths' A/B
# the profiler ranges of one Adam step (training/fit.py, models/assembly.py)
HOST_SPANS = ("fit_adam.loss", "loss.residual", "fit_adam.backward",
              "fit_adam.adam", "fit_adam.record")


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call, by CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def scaled_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def phase_kernels(dev) -> dict:
    """Phases 3-4: each kernel against its plain flavor, at the slice's
    shapes.  Returns the measurements of the Allen-Cahn request set."""
    import torch
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    rng = np.random.RandomState(0)
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, N_POINTS),
                                  rng.uniform(0, 1, N_POINTS)], 1),
                        dtype=torch.float32, device=dev)
    layers = neural_net(WIDTHS, device=dev, seed=0).layers()
    shapes = [tuple(W.shape) for W, _ in layers]
    flat_layers = [t.detach() for pair in layers for t in pair]
    params = [t.clone().requires_grad_(True) for t in flat_layers]
    pairs = list(zip(params[0::2], params[1::2]))
    out = {}
    for label, reqs in (("ac", AC_REQUESTS), ("mixed", MIXED_REQUESTS)):
        plan = ct.build_cuda_table_fn(reqs, shapes).plan
        flat = plan.pack(flat_layers)
        channels = plan.channels

        def plain_table():
            t = taylor_derivatives(pairs, X, set(channels), flat_matmul=True)
            return torch.stack([t[mi] for mi in channels])

        table = ct.k1_forward(plan, X, flat)
        torch.cuda.synchronize()
        with torch.no_grad():
            ref = plain_table()
        k1_abs, k1_rel = 0.0, 0.0
        for c in range(plan.C):
            a, r = scaled_err(table[c], ref[c])
            k1_abs, k1_rel = max(k1_abs, a), max(k1_rel, r)
        print(f"[K1 {label}] C={plan.C} N={N_POINTS} max_abs_err={k1_abs:.3e}"
              f" scale_rel_err={k1_rel:.3e} (tol {K1_RTOL:g} on it)",
              flush=True)
        if not k1_rel <= K1_RTOL:
            fail(f"K1 disagrees with the plain flavor ({label})")

        g = torch.as_tensor(rng.randn(plan.C, N_POINTS, 1),
                            dtype=torch.float32, device=dev)
        dX, dflat = ct.k2_backward(plan, X, flat, g)
        torch.cuda.synchronize()
        Xg = X.clone().requires_grad_(True)

        def plain_grads():
            t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True)
            loss = sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels))
            return torch.autograd.grad(loss, params + [Xg])

        ref_g = plain_grads()
        mine = plan.unpack(dflat) + [dX]
        k2_abs, k2_rel = 0.0, 0.0
        for a_k, a_p in zip(mine, ref_g):
            a, r = scaled_err(a_k, a_p)
            k2_abs, k2_rel = max(k2_abs, a), max(k2_rel, r)
        print(f"[K2 {label}] max_abs_err={k2_abs:.3e} "
              f"scale_rel_err={k2_rel:.3e} (tol {K2_RTOL:g} on it)",
              flush=True)
        if not k2_rel <= K2_RTOL:
            fail(f"K2 disagrees with autograd of the plain flavor ({label})")

        before = (ct.k1_forward.launches, ct.k2_backward.launches)
        k1_ms = cuda_ms(lambda: ct.k1_forward(plan, X, flat))
        with torch.no_grad():
            k1_plain_ms = cuda_ms(plain_table)
        k2_ms = cuda_ms(lambda: ct.k2_backward(plan, X, flat, g))
        k2_plain_ms = cuda_ms(plain_grads, reps=5)
        # comparison launches are not the main path's: restore the counts
        ct.k1_forward.launches, ct.k2_backward.launches = before
        flops = ct.flop_count(plan, N_POINTS)
        nbytes = ct.byte_count(plan, N_POINTS)
        print(f"[time {label}] K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.3f} ms)"
              f"  K2 {k2_ms:.3f} ms (plain fwd+bwd {k2_plain_ms:.3f} ms)",
              flush=True)
        out[label] = dict(
            k1=dict(max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms,
                    bound=bound_ms(flops["k1"], nbytes["k1"])),
            k2=dict(max_abs_err=k2_abs, ms=k2_ms, plain_ms=k2_plain_ms,
                    bound=bound_ms(flops["k2"], nbytes["k2"])))
    return out["ac"]


def _ac_residual(u, x, t):
    from tensordiffeq_tpu_torch import grad
    uv = u(x, t)
    return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
            + 5.0 * uv ** 3 - 5.0 * uv)


def _coupled_residual(u, x, t):
    """The Schrodinger-type coupled pair of the JAX package's
    ``tests/test_solver.py::make_coupled_system``."""
    from tensordiffeq_tpu_torch import grad
    uv, vv = u[0](x, t), u[1](x, t)
    sq = uv ** 2 + vv ** 2
    f_u = (grad(u[0], "t")(x, t) + 0.5 * grad(grad(u[1], "x"), "x")(x, t)
           + sq * vv)
    f_v = (grad(u[1], "t")(x, t) - 0.5 * grad(grad(u[0], "x"), "x")(x, t)
           - sq * uv)
    return f_u, f_v


def _singular_residual(u, x, t):
    """A cylindrical-Laplacian-style ``1/x`` term: NaN at the origin."""
    from tensordiffeq_tpu_torch import grad
    return grad(u, "t")(x, t) + grad(u, "x")(x, t) / x


def phase_k3(dev) -> dict:
    """Phase 5: K3 against its plain flavor.  Returns the measurements of
    the Allen-Cahn case (the slice's shapes)."""
    import torch
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn

    cases = (  # label, residual, widths, N, x range
        ("ac", _ac_residual, WIDTHS, N_POINTS, (-1.0, 1.0)),
        ("system", _coupled_residual, WIDTHS[:-1] + [2], N_POINTS,
         (-1.0, 1.0)),
        ("singular", _singular_residual, WIDTHS, N_POINTS + 1, (0.5, 1.5)))
    rng = np.random.RandomState(1)
    out = {}
    for label, f_model, widths, n, (lo, hi) in cases:
        n_out = widths[-1]
        reqs = analyze_f_model(f_model, ("x", "t"), n_out)
        if reqs is None:
            fail(f"K3 {label}: the residual does not analyse")
        layers = neural_net(widths, device=dev, seed=0).layers()
        sq = build_minimax_sq_fn(f_model, ("x", "t"), n_out, reqs,
                                 [tuple(W.shape) for W, _ in layers])
        plan = sq.plan
        X = torch.as_tensor(np.stack([rng.uniform(lo, hi, n),
                                      rng.uniform(0, 1, n)], 1),
                            dtype=torch.float32, device=dev)
        # w = lambda^2, lambda ~ U[0, 1] per point and equation
        w = torch.as_tensor(rng.rand(n, plan.E) ** 2, dtype=torch.float32,
                            device=dev)
        flat_layers = [a.detach() if a.ndim == 2 else
                       a.detach().reshape(1, -1)
                       for pair in layers for a in pair]
        flat = plan.pack(flat_layers)
        before = cm.k3_minimax.launches
        val, dflat, gw, gX = cm.k3_minimax(plan, X, w, flat)
        torch.cuda.synchronize()
        p_val, p_flat, p_gw, p_gX = sq.plain(flat_layers, w, X)
        got = [val.reshape(1)] + [g.reshape(-1) for g in plan.unpack(dflat)] \
            + [gw, gX]
        want = [p_val.reshape(1)] + [g.reshape(-1) for g in p_flat] \
            + [p_gw, p_gX]
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"K3 {label}: non-finite output")
        k3_abs, k3_rel = 0.0, 0.0
        for a_k, a_p in zip(got, want):
            a, r = scaled_err(a_k, a_p)
            k3_abs, k3_rel = max(k3_abs, a), max(k3_rel, r)
        print(f"[K3 {label}] C={plan.C} E={plan.E} N={n} tape "
              f"{len(plan.tape.ops)} ops, value {float(val):.6e} (plain "
              f"{float(p_val):.6e}) max_abs_err={k3_abs:.3e} "
              f"scale_rel_err={k3_rel:.3e} (tol {K3_RTOL:g} on it)",
              flush=True)
        if not k3_rel <= K3_RTOL:
            fail(f"K3 disagrees with its plain flavor ({label})")
        ms = cuda_ms(lambda: cm.k3_minimax(plan, X, w, flat))
        plain_ms = cuda_ms(lambda: sq.plain(flat_layers, w, X), reps=5)
        # comparison launches are not the main path's: restore the count
        cm.k3_minimax.launches = before
        bound = bound_ms(cm.flop_count(plan, n)["k3"],
                         cm.byte_count(plan, n)["k3"])
        print(f"[time K3 {label}] K3 {ms:.3f} ms (plain fwd+bwd "
              f"{plain_ms:.3f} ms), bound {bound[0]:.3f} ms ({bound[1]})",
              flush=True)
        out[label] = dict(max_abs_err=k3_abs, ms=ms, plain_ms=plain_ms,
                          bound=bound)
    return out["ac"]


def ac_sa_problem(n_f: int = N_POINTS, grid=(512, 201), seed: int = 0):
    """The Allen-Cahn SA-PINN at its full size (the JAX package's zoo entry
    ``allen-cahn-sa``, size ``full``): u_t - 1e-4 u_xx + 5u^3 - 5u = 0 on
    [-1, 1] x [0, 1], IC x^2 cos(pi x), periodic (u, u_x) in x; per-point
    lambda_res ~ U[0,1] and lambda_IC ~ 100 U[0,1], Adaptive_type=1."""
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import grad

    nx, nt = grid
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)

    def func_ic(x):
        return x ** 2 * np.cos(np.pi * x)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [tdqt.IC(domain, [func_ic], var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        u_xx = grad(grad(u, "x"), "x")
        u_t = grad(u, "t")
        uv = u(x, t)
        return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv

    rng = np.random.RandomState(seed)
    compile_kw = dict(
        Adaptive_type=1,
        dict_adaptive={"residual": [True], "BCs": [True, False]},
        init_weights={"residual": [rng.rand(n_f, 1)],
                      "BCs": [100.0 * rng.rand(nx, 1), None]})
    return domain, bcs, f_model, compile_kw


def _counts() -> dict:
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    return {"k1": ct.k1_forward.launches, "k2": ct.k2_backward.launches,
            "k3": cm.k3_minimax.launches}


def phase_slice(tf_iter: int, minimax) -> dict:
    """Phases 6 and 7: compile + fit + predict through fused="cuda" with
    ``minimax`` (None: the default, which adopts K3; False: the unfused
    loss), with the kernels' launch counts set to 0 just before and read
    after compile, fit and predict."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    tag = "minimax" if minimax is None else "unfused"
    want_engine = "fused-minimax-cuda" if minimax is None else "fused-cuda"
    domain, bcs, f_model, kw = ac_sa_problem()
    lam0 = {"residual": kw["init_weights"]["residual"][0].astype(np.float32),
            "IC": kw["init_weights"]["BCs"][0].astype(np.float32)}
    x, t, usol = allen_cahn_solution()
    X_star = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)

    ct.reset_launch_counts()
    solver = tdqt.CollocationSolverND(verbose=False, seed=0)
    t0 = time.perf_counter()
    if minimax is None:  # the default
        solver.compile(WIDTHS, f_model, domain, bcs, fused="cuda", **kw)
    else:
        solver.compile(WIDTHS, f_model, domain, bcs, fused="cuda",
                       minimax=minimax, **kw)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    if solver.engine != want_engine:
        fail(f"solver engine is {solver.engine}, expected {want_engine} "
             f"(minimax not adopted: {solver._minimax_fail_reason!r})")
    at_compile = _counts()
    t0 = time.perf_counter()
    solver.fit(tf_iter=tf_iter)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    at_fit = _counts()
    t0 = time.perf_counter()
    u_pred, f_pred = solver.predict(X_star)
    t_pred = time.perf_counter() - t0
    launches = _counts()
    in_fit = {k: at_fit[k] - at_compile[k] for k in launches}

    total = np.array([r["Total Loss"] for r in solver.losses])
    lam_res = solver.lambdas["residual"][0].detach().cpu().numpy()
    lam_ic = solver.lambdas["BCs"][0].detach().cpu().numpy()
    rel_l2 = tdqt.find_L2_error(u_pred, usol.reshape(-1, 1))
    ms_step = 1e3 * t_fit / tf_iter
    print(f"[slice {tag}] engine {solver.engine}; compile {t_compile:.2f} s,"
          f" fit {tf_iter} epochs {t_fit:.2f} s = {ms_step:.3f} ms/step, "
          f"predict {X_star.shape[0]} pts {t_pred:.3f} s", flush=True)
    print(f"[slice {tag}] loss epoch 0 {total[0]:.6e} -> epoch {tf_iter - 1}"
          f" {total[-1]:.6e} (min {total.min():.6e}); rel-L2 vs ETDRK4 "
          f"{rel_l2:.4f}; |d lambda_res| max "
          f"{np.abs(lam_res - lam0['residual']).max():.3e}, |d lambda_IC| "
          f"max {np.abs(lam_ic - lam0['IC']).max():.3e}", flush=True)
    print(f"[slice {tag}] launches after compile {at_compile}, in fit "
          f"{in_fit}, in all {launches}", flush=True)
    if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
        fail("the loss did not fall (or is not finite)")
    if not (np.abs(lam_res - lam0["residual"]).max() > 0
            and np.abs(lam_ic - lam0["IC"]).max() > 0):
        fail("the SA lambdas did not move")
    if u_pred.shape != (X_star.shape[0], 1) or not (
            np.all(np.isfinite(u_pred)) and np.all(np.isfinite(f_pred))):
        fail("predict is not finite / has the wrong shape")
    if minimax is None:
        # K3: once in compile's cross-check, once per Adam step; K1 and K2
        # only outside fit (compile's fused-residual check and predict)
        if solver._minimax_kind != "cuda":
            fail(f"_minimax_kind is {solver._minimax_kind!r}, not 'cuda'")
        if not (at_compile["k3"] == 1 and in_fit["k3"] == tf_iter
                and launches["k3"] == 1 + tf_iter):
            fail(f"K3 launches {launches['k3']} != the cross-check + "
                 f"{tf_iter} steps")
        if in_fit["k1"] or in_fit["k2"] or not (launches["k1"]
                                                and launches["k2"]):
            fail(f"K1/K2 ran in the minimax fit or not at all: {in_fit}")
    elif not (in_fit["k1"] == in_fit["k2"] == tf_iter and not launches["k3"]):
        fail(f"the unfused path did not go through K1/K2 per step: {in_fit}")
    return dict(launches=launches, ms_step=ms_step, rel_l2=rel_l2,
                solver=solver)


def phase_ab(paths: dict, steps: int = AB_STEPS) -> dict:
    """``--profile``: ``steps`` more Adam steps of each trained solver per
    turn, in the order minimax, unfused, unfused, minimax, twice; ms/step
    per turn."""
    import torch
    turns = {tag: [] for tag in paths}
    for tag in ("minimax", "unfused", "unfused", "minimax") * 2:
        solver = paths[tag]["solver"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit(tf_iter=steps, chunk=steps)
        torch.cuda.synchronize()
        turns[tag].append(1e3 * (time.perf_counter() - t0) / steps)
    print("[A/B] ms/step of each path's turns (run in the order minimax, "
          "unfused, unfused, minimax, twice): "
          + "; ".join(f"{tag} " + ", ".join(f"{ms:.3f}" for ms in v)
                      + f" (mean {np.mean(v):.3f})"
                      for tag, v in turns.items()), flush=True)
    return turns


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "taylor_fwd" in low:
        return "K1 taylor_fwd_kernel"
    if "taylor_bwd" in low:
        return "K2 taylor_bwd_kernel"
    if "minimax_step" in low:
        return "K3 minimax_step_kernel"
    if "reduce_partials" in low:
        return "reduce_partials (K2's or K3's slot-ordered sum)"
    if "gemm" in low or "gemv" in low or "cutlass" in low:
        return "cuBLAS matmuls (BC terms, generic engine)"
    if "adam" in low or "multi_tensor" in low:
        return "Adam updates"
    return "other PyTorch kernels (pointwise, reductions, copies)"


def phase_profile(solver, tag: str, n_steps: int = 20):
    """``--profile``: ``n_steps`` Adam steps of the trained slice under
    ``torch.profiler``: the host's time in each of ``fit_adam``'s ranges,
    device time by kernel group, the device's busy and idle share of the
    wall, the top kernels and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    solver.fit(tf_iter=5)  # warm
    torch.cuda.synchronize()
    # the profiler's first window carries its own start-up; keep it out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        solver.fit(tf_iter=2)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.fit(tf_iter=n_steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, by_group, n_launch = {}, {}, 0
    host = dict.fromkeys(HOST_SPANS, 0.0)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name in host:
                host[evt.name] += evt.time_range.elapsed_us()
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        grp = _kernel_group(evt.name)
        by_group[grp] = by_group.get(grp, 0.0) + us
        n_launch += 1
    busy_ms = sum(by_group.values()) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    if not all(host.values()):
        fail(f"the profiler missed a range of fit_adam: {host}")
    print(f"[host {tag}] {n_steps} steps, host ms/step in fit_adam's ranges "
          "(under the profiler; loss.residual lies inside fit_adam.loss): "
          + ", ".join(f"{k} {us / 1e3 / n_steps:.3f}"
                      for k, us in host.items()), flush=True)
    print(f"[profile {tag}] {n_steps} steps: wall {wall_ms / n_steps:.3f} "
          f"ms/step, device busy {busy_ms / n_steps:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle), "
          f"{n_launch / n_steps:.0f} kernel launches/step", flush=True)
    for grp, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {us / 1e3 / n_steps:8.3f} ms/step  {grp}",
              flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]     {us / 1e3 / n_steps:8.3f} ms/step  {name[:90]}",
              flush=True)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:8]:
        print(f"[profile] host {e.self_cpu_time_total / 1e3 / n_steps:8.3f} "
              f"ms/step self, {e.count / n_steps:6.1f} calls/step  "
              f"{e.key[:70]}", flush=True)


def kernels_line(meas: dict, paths: dict) -> str:
    """``launches`` sums a kernel's launches over the runs of both paths
    (``launches_by_path`` splits them)."""
    entries = []
    for key, name, source, replaces in (
            ("k1", "taylor_table_fwd (K1)", "csrc/taylor_table.cu",
             "pallas_taylor.py:154"),
            ("k2", "taylor_table_bwd (K2)", "csrc/taylor_table.cu",
             "pallas_taylor.py:171"),
            ("k3", "minimax_step (K3)", "csrc/minimax_step.cu",
             "pallas_minimax.py:259")):
        m = meas[key]
        by_path = {tag: int(res["launches"][key])
                   for tag, res in paths.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"tensordiffeq_tpu_torch/{source}",
            "replaces": f"tensordiffeq_tpu/ops/{replaces}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1],
            # no single PyTorch call computes the Taylor table or the
            # fused minimax step
            "library_ms": None})
    return json.dumps({"kernels": entries})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the slices, an A/B of the two paths in "
                    "eight turns of 50 steps, then profile 20 Adam steps of "
                    "each path, twice, in turns")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    t0 = time.perf_counter()
    ct.build()
    nvcc_s = ct.build_seconds or 0.0  # 0 when this checkout had the build
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {nvcc_s:.2f} s)", flush=True)

    meas = phase_kernels(dev)
    meas["k3"] = phase_k3(dev)
    paths = {"minimax": phase_slice(TF_ITER, minimax=None),
             "unfused": phase_slice(TF_ITER, minimax=False)}
    print(f"[paths] ms/step minimax {paths['minimax']['ms_step']:.3f}, "
          f"unfused {paths['unfused']['ms_step']:.3f}", flush=True)
    if args.profile:
        phase_ab(paths)
        # in turns, so a slower stretch of the host does not land on one
        # path's window only
        for tag in ("minimax", "unfused", "unfused", "minimax"):
            phase_profile(paths[tag]["solver"], tag)
    print(kernels_line(meas, paths), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
