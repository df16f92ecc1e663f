"""The seeded zoo: nine declared benchmark problems.

Counterpart of the JAX package's ``zoo/entries.py``: the same domains, BCs,
residuals, widths, sizes, budgets, gates and notes, built from the port's
modules.  Breadth after the PINNs-TF2 bar (arXiv:2311.03626):
scalar shocks (Burgers), the SA flagship (Allen-Cahn), three true
multi-component systems on the fused system minimax engine (Schrödinger,
reaction–diffusion, Taylor–Green Navier–Stokes, plus 2D Burgers), a 3D
problem (heat), a stiff convection-dominated entry, and an
inverse/assimilation variant (Burgers with sparse observations).

Every entry declares a ``micro`` size — the CPU-scale point the JAX
package's scorecard baseline (``SCORECARD.json``) races — and a ``full``
size at the paper-scale config.  Micro gates were calibrated by the JAX
package on its CPU host at ~1.15x the best arm's final error; full gates
carry the accuracy its CONVERGENCE.md records where a full run exists, the
paper's bar otherwise.

``burgers-assim``'s IC subsample (``n_values=60``) is drawn unseeded, as in
the JAX package (``RandomState(None)``): each build draws other IC rows.
"""

from __future__ import annotations

import numpy as np

from ..boundaries import IC, FunctionDirichletBC, dirichletBC, periodicBC
from ..domains import DomainND
from ..exact import (allen_cahn_solution, burgers_solution,
                     convection_solution, heat3d_solution,
                     reaction_diffusion_solution, schrodinger_solution,
                     taylor_green_solution)
from ..ops import grad
from .registry import (Budget, Reference, SizeSpec, ZooEntry, ZooProblem,
                       register)

__all__ = []  # the registry, not this module's namespace, is the surface


def _mesh(*axes):
    """Row-major flattened meshgrid -> ``[M, len(axes)]`` float32."""
    return np.stack(np.meshgrid(*axes, indexing="ij"),
                    -1).reshape(-1, len(axes)).astype(np.float32)


# --------------------------------------------------------------------------- #
# burgers — scalar shock benchmark
# --------------------------------------------------------------------------- #
def _burgers_domain(spec, seed=0):
    nx, nt = spec.grid
    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=seed)
    return domain


def _burgers_f_model(u, x, t):
    u_x, u_t = grad(u, "x"), grad(u, "t")
    u_xx = grad(u_x, "x")
    return u_t(x, t) + u(x, t) * u_x(x, t) - (0.01 / np.pi) * u_xx(x, t)


def _burgers_build(spec):
    domain = _burgers_domain(spec)
    bcs = [IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]]),
           dirichletBC(domain, val=0.0, var="x", target="upper"),
           dirichletBC(domain, val=0.0, var="x", target="lower")]
    return ZooProblem(domain, bcs, _burgers_f_model,
                      (2, *spec.widths, 1))


def _burgers_ref(spec):
    x, t, usol = burgers_solution()
    return Reference(_mesh(x, t), usol.reshape(-1, 1))


register(ZooEntry(
    id="burgers", title="Viscous Burgers shock",
    equation="u_t + u u_x = (0.01/pi) u_xx",
    n_inputs=2, n_components=1,
    build=_burgers_build, reference=_burgers_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(20, 20, 20, 20),
                          grid=(256, 100), budget=Budget(1000, 500),
                          gate_rel_l2=0.16),
        "full": SizeSpec(n_f=10_000, widths=(20,) * 8, grid=(256, 100),
                         budget=Budget(10_000, 10_000), gate_rel_l2=5e-3),
    },
    tags=("scalar", "shock"),
    notes="Cole-Hopf exact reference; the adaptive-resampling ablation's "
          "home problem (runs/resample_ablation.json)."))


# --------------------------------------------------------------------------- #
# allen-cahn-sa — the SA-PINN flagship
# --------------------------------------------------------------------------- #
def _ac_build(spec, seed=0):
    # ``seed`` drives all three RNG consumers (collocation draw here, λ
    # init below, net init via build_solver)
    nx, nt = spec.grid
    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=seed)

    def func_ic(x):
        return x ** 2 * np.cos(np.pi * x)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [IC(domain, [func_ic], var=[["x"]]),
           periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        u_xx = grad(grad(u, "x"), "x")
        u_t = grad(u, "t")
        uv = u(x, t)
        return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv

    # the flagship SA config (reference AC-SA.py:12,55-56,64): per-point
    # lambda_res ~ U[0,1], lambda_IC ~ 100*U[0,1], minimax ascent
    rng = np.random.RandomState(seed)
    compile_kw = dict(
        Adaptive_type=1,
        dict_adaptive={"residual": [True], "BCs": [True, False]},
        init_weights={"residual": [rng.rand(spec.n_f, 1)],
                      "BCs": [100.0 * rng.rand(nx, 1), None]})
    return ZooProblem(domain, bcs, f_model, (2, *spec.widths, 1),
                      compile_kw=compile_kw)


def _ac_ref(spec):
    x, t, usol = allen_cahn_solution()
    return Reference(_mesh(x, t), usol.reshape(-1, 1))


register(ZooEntry(
    id="allen-cahn-sa", title="Allen-Cahn, self-adaptive weights",
    equation="u_t - 1e-4 u_xx + 5u^3 - 5u = 0",
    n_inputs=2, n_components=1,
    build=_ac_build, reference=_ac_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(32, 32), grid=(64, 21),
                          budget=Budget(1000, 500), gate_rel_l2=0.95),
        "full": SizeSpec(n_f=50_000, widths=(128,) * 4, grid=(512, 201),
                         budget=Budget(10_000, 10_000),
                         gate_rel_l2=2.1e-2),
    },
    tags=("scalar", "self-adaptive", "metastable"),
    notes="ETDRK4 spectral reference; full gate is the 2.1e-2 bar "
          "bench.py --full times to (CONVERGENCE.md)."))


# --------------------------------------------------------------------------- #
# schrodinger — 2-component NLS system
# --------------------------------------------------------------------------- #
def _nls_build(spec):
    nx, nt = spec.grid
    t_final = float(np.pi / 2)
    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-5.0, 5.0], nx)
    domain.add("t", [0.0, t_final], nt)
    domain.generate_collocation_points(spec.n_f, seed=0)

    ics = IC(domain,
             [lambda x: 2.0 / np.cosh(x), lambda x: 0.0 * x],
             var=[["x"], ["x"]])

    def deriv_model(u, x, t):
        return (u[0](x, t), u[1](x, t),
                grad(u[0], "x")(x, t), grad(u[1], "x")(x, t))

    per = periodicBC(domain, ["x"], [deriv_model])

    def f_model(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        sq = uv ** 2 + vv ** 2
        f_u = grad(u[0], "t")(x, t) \
            + 0.5 * grad(grad(u[1], "x"), "x")(x, t) + sq * vv
        f_v = grad(u[1], "t")(x, t) \
            - 0.5 * grad(grad(u[0], "x"), "x")(x, t) - sq * uv
        return f_u, f_v

    return ZooProblem(domain, [ics, per], f_model, (2, *spec.widths, 2))


def _nls_ref(spec):
    x, t, h = schrodinger_solution()
    return Reference(
        _mesh(x, t), np.abs(h).reshape(-1, 1),
        transform=lambda p: np.sqrt(p[:, :1] ** 2 + p[:, 1:2] ** 2))


register(ZooEntry(
    id="schrodinger", title="Nonlinear Schrodinger (2-component)",
    equation="i h_t + 0.5 h_xx + |h|^2 h = 0,  h = u + iv",
    n_inputs=2, n_components=2,
    build=_nls_build, reference=_nls_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(32, 32), grid=(64, 21),
                          budget=Budget(1000, 500), gate_rel_l2=0.40),
        "full": SizeSpec(n_f=20_000, widths=(100,) * 4, grid=(256, 201),
                         budget=Budget(10_000, 10_000), gate_rel_l2=5e-3),
    },
    tags=("system", "periodic", "complex"),
    notes="Split-step Fourier reference; gate on rel-L2 of |h|.  The "
          "tuple residual adopts the fused TWO-equation minimax engine."))


# --------------------------------------------------------------------------- #
# reaction-diffusion — rotation-coupled linear 2-component system
# --------------------------------------------------------------------------- #
_RD_D, _RD_A = 0.1, float(np.pi)


def _rd_build(spec):
    nx, nt = spec.grid
    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [0.0, float(np.pi)], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=0)

    ics = IC(domain, [lambda x: np.sin(x), lambda x: 0.0 * x],
             var=[["x"], ["x"]])
    zero = [lambda t: 0.0 * t, lambda t: 0.0 * t]
    bcs = [ics,
           FunctionDirichletBC(domain, zero, var="x", target="lower",
                               func_inputs=[["t"], ["t"]]),
           FunctionDirichletBC(domain, zero, var="x", target="upper",
                               func_inputs=[["t"], ["t"]])]

    def f_model(u, x, t):
        uv, vv = u[0](x, t), u[1](x, t)
        f_u = grad(u[0], "t")(x, t) \
            - _RD_D * grad(grad(u[0], "x"), "x")(x, t) - _RD_A * vv
        f_v = grad(u[1], "t")(x, t) \
            - _RD_D * grad(grad(u[1], "x"), "x")(x, t) + _RD_A * uv
        return f_u, f_v

    return ZooProblem(domain, bcs, f_model, (2, *spec.widths, 2))


def _rd_ref(spec):
    x, t, uv = reaction_diffusion_solution(d=_RD_D, a=_RD_A)
    return Reference(_mesh(x, t), uv.reshape(-1, 2))


register(ZooEntry(
    id="reaction-diffusion", title="Coupled reaction-diffusion "
                                   "(2-component)",
    equation="u_t = 0.1 u_xx + pi v;  v_t = 0.1 v_xx - pi u",
    n_inputs=2, n_components=2,
    build=_rd_build, reference=_rd_ref,
    sizes={
        "micro": SizeSpec(n_f=1536, widths=(24, 24), grid=(48, 17),
                          budget=Budget(800, 400), gate_rel_l2=0.03),
        "full": SizeSpec(n_f=10_000, widths=(64,) * 3, grid=(128, 65),
                         budget=Budget(5_000, 5_000), gate_rel_l2=1e-3),
    },
    tags=("system",),
    notes="Equal diffusivities make the coupled mode's matrix "
          "exponential analytic (exact.py) — a system entry whose truth "
          "costs nothing."))


# --------------------------------------------------------------------------- #
# taylor-green — unsteady incompressible Navier-Stokes (u, v, p)
# --------------------------------------------------------------------------- #
_TG_NU = 0.1


def _tg_exact_fns():
    dec = lambda t: np.exp(-2.0 * _TG_NU * t)  # noqa: E731

    def u_fn(x, y, t):
        return -np.cos(x) * np.sin(y) * dec(t)

    def v_fn(x, y, t):
        return np.sin(x) * np.cos(y) * dec(t)

    def p_fn(x, y, t):
        return -0.25 * (np.cos(2.0 * x) + np.cos(2.0 * y)) * dec(t) ** 2

    return u_fn, v_fn, p_fn


def _tg_build(spec):
    nx, ny, nt = spec.grid
    hi = float(np.pi)
    domain = DomainND(["x", "y", "t"], time_var="t")
    domain.add("x", [0.0, hi], nx)
    domain.add("y", [0.0, hi], ny)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=0)

    u_fn, v_fn, p_fn = _tg_exact_fns()
    bcs = [IC(domain,
              [lambda x, y: u_fn(x, y, 0.0), lambda x, y: v_fn(x, y, 0.0),
               lambda x, y: p_fn(x, y, 0.0)],
              var=[["x", "y"]] * 3)]
    # the exact solution supplies all three fields on every face (the
    # pressure face values pin the gauge constant)
    for var, face in (("x", "lower"), ("x", "upper"),
                      ("y", "lower"), ("y", "upper")):
        val = 0.0 if face == "lower" else hi
        if var == "x":
            funs = [lambda y, t, f=f: f(val, y, t)
                    for f in (u_fn, v_fn, p_fn)]
            inputs = [["y", "t"]] * 3
        else:
            funs = [lambda x, t, f=f: f(x, val, t)
                    for f in (u_fn, v_fn, p_fn)]
            inputs = [["x", "t"]] * 3
        bcs.append(FunctionDirichletBC(domain, funs, var=var, target=face,
                                       func_inputs=inputs))

    def f_model(u, x, y, t):
        uu, vv = u[0](x, y, t), u[1](x, y, t)
        u_x, u_y = grad(u[0], "x"), grad(u[0], "y")
        v_x, v_y = grad(u[1], "x"), grad(u[1], "y")
        lap_u = grad(u_x, "x")(x, y, t) + grad(u_y, "y")(x, y, t)
        lap_v = grad(v_x, "x")(x, y, t) + grad(v_y, "y")(x, y, t)
        f_u = grad(u[0], "t")(x, y, t) + uu * u_x(x, y, t) \
            + vv * u_y(x, y, t) + grad(u[2], "x")(x, y, t) - _TG_NU * lap_u
        f_v = grad(u[1], "t")(x, y, t) + uu * v_x(x, y, t) \
            + vv * v_y(x, y, t) + grad(u[2], "y")(x, y, t) - _TG_NU * lap_v
        f_c = u_x(x, y, t) + v_y(x, y, t)
        return f_u, f_v, f_c

    return ZooProblem(domain, bcs, f_model, (3, *spec.widths, 3))


def _tg_ref(spec):
    x, y, t, uvp = taylor_green_solution(nx=24, ny=24, nt=9, nu=_TG_NU)
    return Reference(_mesh(x, y, t), uvp.reshape(-1, 3))


register(ZooEntry(
    id="taylor-green", title="Taylor-Green vortex (Navier-Stokes, "
                             "3-component)",
    equation="u_t + (u.grad)u = -grad p + nu lap u;  div u = 0",
    n_inputs=3, n_components=3,
    build=_tg_build, reference=_tg_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(24, 24), grid=(16, 16, 9),
                          budget=Budget(800, 400), gate_rel_l2=0.014),
        "full": SizeSpec(n_f=20_000, widths=(64,) * 4, grid=(32, 32, 21),
                         budget=Budget(10_000, 10_000), gate_rel_l2=5e-3),
    },
    tags=("system", "navier-stokes", "2d"),
    notes="The exact decaying-vortex NS solution (exact.py): two "
          "momentum equations + continuity as a fused 3-equation "
          "system."))


# --------------------------------------------------------------------------- #
# heat3d — the 3D entry
# --------------------------------------------------------------------------- #
_H3_KAPPA = 0.05


def _h3_build(spec):
    n, nt = spec.grid[0], spec.grid[-1]
    domain = DomainND(["x", "y", "z", "t"], time_var="t")
    for v in ("x", "y", "z"):
        domain.add(v, [0.0, 1.0], n)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=0)

    bcs = [IC(domain,
              [lambda x, y, z: np.sin(np.pi * x) * np.sin(np.pi * y)
               * np.sin(np.pi * z)],
              var=[["x", "y", "z"]])]
    for v in ("x", "y", "z"):
        bcs.append(dirichletBC(domain, val=0.0, var=v, target="lower"))
        bcs.append(dirichletBC(domain, val=0.0, var=v, target="upper"))

    def f_model(u, x, y, z, t):
        lap = (grad(grad(u, "x"), "x")(x, y, z, t)
               + grad(grad(u, "y"), "y")(x, y, z, t)
               + grad(grad(u, "z"), "z")(x, y, z, t))
        return grad(u, "t")(x, y, z, t) - _H3_KAPPA * lap

    return ZooProblem(domain, bcs, f_model, (4, *spec.widths, 1))


def _h3_ref(spec):
    x, y, z, t, u = heat3d_solution(n=10, nt=5, kappa=_H3_KAPPA)
    return Reference(_mesh(x, y, z, t), u.reshape(-1, 1))


register(ZooEntry(
    id="heat3d", title="3D heat equation",
    equation="u_t = 0.05 (u_xx + u_yy + u_zz)",
    n_inputs=4, n_components=1,
    build=_h3_build, reference=_h3_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(24, 24), grid=(8, 8, 8, 7),
                          budget=Budget(600, 300), gate_rel_l2=0.20),
        "full": SizeSpec(n_f=30_000, widths=(64,) * 4,
                         grid=(16, 16, 16, 11),
                         budget=Budget(10_000, 5_000), gate_rel_l2=1e-2),
    },
    tags=("3d",),
    notes="Separable single mode: the cheapest honest 3D+time entry "
          "(face meshes stay small at micro fidelity)."))


# --------------------------------------------------------------------------- #
# convection-stiff — convection-dominated transport (arXiv:2109.01050)
# --------------------------------------------------------------------------- #
_CONV_BETA = 30.0


def _conv_build(spec):
    nx, nt = spec.grid
    two_pi = float(2.0 * np.pi)
    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [0.0, two_pi], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=0)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [IC(domain, [lambda x: np.sin(x)], var=[["x"]]),
           periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        return grad(u, "t")(x, t) + _CONV_BETA * grad(u, "x")(x, t)

    return ZooProblem(domain, bcs, f_model, (2, *spec.widths, 1))


def _conv_ref(spec):
    x, t, u = convection_solution(beta=_CONV_BETA)
    return Reference(_mesh(x, t), u.reshape(-1, 1))


register(ZooEntry(
    id="convection-stiff", title="Stiff convection (beta=30)",
    equation="u_t + 30 u_x = 0",
    n_inputs=2, n_components=1,
    build=_conv_build, reference=_conv_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(32, 32, 32), grid=(128, 33),
                          budget=Budget(1200, 600), gate_rel_l2=0.95),
        "full": SizeSpec(n_f=20_000, widths=(50,) * 4, grid=(256, 101),
                         budget=Budget(20_000, 10_000), gate_rel_l2=5e-2),
    },
    tags=("scalar", "stiff"),
    notes="The convection-dominated failure-mode benchmark "
          "(arXiv:2109.01050): at beta=30 a fixed-draw PINN famously "
          "stalls — the entry exists to race the adaptive arms against "
          "exactly that."))


# --------------------------------------------------------------------------- #
# burgers-assim — the inverse/assimilation variant
# --------------------------------------------------------------------------- #
def _assim_build(spec):
    domain = _burgers_domain(spec)
    bcs = [IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]],
              n_values=60),
           dirichletBC(domain, val=0.0, var="x", target="upper"),
           dirichletBC(domain, val=0.0, var="x", target="lower")]

    # sparse observations of the exact solution at one interior time
    # slice (t ~ 0.76), drawn reproducibly; the Data loss term is what
    # makes this the assimilation variant
    x, t, usol = burgers_solution()
    ns = 60 if spec.n_f <= 4096 else 200
    rng = np.random.RandomState(0)
    idx = rng.choice(x.shape[0], ns, replace=False)
    it = 75
    x_s = x[idx].reshape(-1, 1).astype(np.float32)
    t_s = np.full_like(x_s, t[it])
    y_s = usol[idx, it].reshape(-1, 1).astype(np.float32)
    return ZooProblem(domain, bcs, _burgers_f_model,
                      (2, *spec.widths, 1), data=(x_s, t_s, y_s))


register(ZooEntry(
    id="burgers-assim", title="Burgers, sparse-data assimilation",
    equation="u_t + u u_x = (0.01/pi) u_xx  +  data(t=0.76)",
    n_inputs=2, n_components=1,
    build=_assim_build, reference=_burgers_ref,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(20, 20, 20, 20),
                          grid=(256, 100), budget=Budget(1000, 500),
                          gate_rel_l2=0.16),
        "full": SizeSpec(n_f=10_000, widths=(20,) * 8, grid=(256, 100),
                         budget=Budget(10_000, 1_000), gate_rel_l2=5e-3),
    },
    tags=("inverse", "assimilation"),
    notes="Same PDE and exact reference as 'burgers' (nu=0.01/pi so the "
          "Cole-Hopf fixture IS the truth, unlike the example's 0.05/pi "
          "variant) plus a real Data loss over sparse observations."))


# --------------------------------------------------------------------------- #
# burgers2d — residual-only 2-component system
# --------------------------------------------------------------------------- #
_B2_NU = 0.05


def _b2_build(spec):
    nx, ny, nt = spec.grid
    domain = DomainND(["x", "y", "t"], time_var="t")
    domain.add("x", [0.0, 1.0], nx)
    domain.add("y", [0.0, 1.0], ny)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(spec.n_f, seed=0)

    def ic_u(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    def ic_v(x, y):
        return np.sin(np.pi * x) * np.sin(2.0 * np.pi * y)

    bcs = [IC(domain, [ic_u, ic_v], var=[["x", "y"]] * 2)]
    zero2 = [lambda a, t: 0.0 * a, lambda a, t: 0.0 * a]
    for var, other in (("x", "y"), ("y", "x")):
        for face in ("lower", "upper"):
            bcs.append(FunctionDirichletBC(
                domain, zero2, var=var, target=face,
                func_inputs=[[other, "t"]] * 2))

    def f_model(u, x, y, t):
        uu, vv = u[0](x, y, t), u[1](x, y, t)
        lap_u = grad(grad(u[0], "x"), "x")(x, y, t) \
            + grad(grad(u[0], "y"), "y")(x, y, t)
        lap_v = grad(grad(u[1], "x"), "x")(x, y, t) \
            + grad(grad(u[1], "y"), "y")(x, y, t)
        f_u = grad(u[0], "t")(x, y, t) + uu * grad(u[0], "x")(x, y, t) \
            + vv * grad(u[0], "y")(x, y, t) - _B2_NU * lap_u
        f_v = grad(u[1], "t")(x, y, t) + uu * grad(u[1], "x")(x, y, t) \
            + vv * grad(u[1], "y")(x, y, t) - _B2_NU * lap_v
        return f_u, f_v

    return ZooProblem(domain, bcs, f_model, (3, *spec.widths, 2))


register(ZooEntry(
    id="burgers2d", title="2D coupled Burgers (residual-only)",
    equation="u_t + u u_x + v u_y = nu lap u;  v_t + u v_x + v v_y = "
             "nu lap v",
    n_inputs=3, n_components=2,
    build=_b2_build, reference=None,
    sizes={
        "micro": SizeSpec(n_f=2048, widths=(24, 24), grid=(12, 12, 9),
                          budget=Budget(800, 400), gate_residual=0.11),
        "full": SizeSpec(n_f=20_000, widths=(64,) * 3, grid=(32, 32, 21),
                         budget=Budget(10_000, 5_000),
                         gate_residual=1e-3),
    },
    tags=("system", "2d", "residual-only"),
    notes="No closed form for this IC: the declared gate is RMS PDE "
          "residual on a held-out uniform grid — the zoo's "
          "residual-only reference kind."))
