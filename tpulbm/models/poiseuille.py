"""Poiseuille channel flow: body-force driven, periodic in x, walls in y.

The reference developed this on a separate branch (README.md:77-81, not in
the snapshot) and left its machinery behind as dead code — the forced
equilibrium (LBMUtils.h:15-19, 68-121) and `periodic_x` (LBMUtils.h:124-126).
Here it is a first-class model; the analytic parabola is the fast physics
gate (RMSE < 0.005, SURVEY §4).
"""
from __future__ import annotations

import numpy as np

from ..config import SimulationParams
from ..lattice import D2Q9
from .base import Problem


def make_problem(params: SimulationParams) -> Problem:
    if params.is_3d:
        # 3-D square/rectangular duct: periodic in x, no-slip walls in y
        # AND z (a mixed-periodicity duct). Gate: the analytic
        # rectangular-duct series (analytic_profile_duct),
        # tests/test_duct3d.py.
        from ..lattice import D3Q19, D3Q27
        lat = D3Q27 if params.lattice3d == "d3q27" else D3Q19
        force = tuple(params.body_force) or (1e-5, 0.0)
        force = tuple(force) + (0.0,) * (3 - len(force))
        return Problem(
            params=params,
            lattice=lat,
            solid=None,
            init_rho=1.0,
            init_u=(0.0, 0.0, 0.0),
            inlet_zou_he=False,
            outlet_zou_he=False,
            walls_y=True,
            walls_z=True,
            periodic_x=True,
            body_force=force,
            obstacle_bc=params.obstacle_bc,
            collision=params.collision,
            smagorinsky=params.smagorinsky,
            power_law=params.power_law() or (),
            trt_magic=params.trt_magic,
            mrt_rates=params.mrt_rates,
        )
    force = tuple(params.body_force) or (1e-5, 0.0)
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=None,
        init_rho=1.0,
        init_u=(0.0, 0.0),
        inlet_zou_he=False,
        outlet_zou_he=False,
        walls_y=True,
        periodic_x=True,
        body_force=force,
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
    )


def analytic_profile(params: SimulationParams) -> np.ndarray:
    """Steady-state analytic ux(y) for the body-force driven channel.

    The reference-style wall BC rewrites *all* inward populations at the
    boundary nodes (LBMSolver.h:153-176), pinning u ≈ 0 at the nodes
    themselves (measured wall position: node ± 0.01 of a cell), so the
    no-slip walls sit at y=0 and y=ny-1 and the channel width is ny-1:
    u(y) = F/(2 nu) * y * (ny-1 - y).
    """
    ny = params.ny
    nu = params.nu()
    F = params.body_force[0] if params.body_force else 1e-5
    y = np.arange(ny, dtype=np.float64)
    return F / (2.0 * nu) * y * (ny - 1 - y)


def analytic_profile_power_law(params: SimulationParams) -> np.ndarray:
    """Steady-state analytic ux(y) for the power-law (Ostwald-de Waele)
    channel, nu(γ̇) = k γ̇^(n-1) (no reference analog — the C++ code is
    strictly Newtonian). Same wall convention as analytic_profile (no-slip
    at the nodes y = 0 and y = ny-1, half-width h = (ny-1)/2):

        sigma(y) = F (h - |y - h|)  =>  |du/dy| = (F s / k)^(1/n)
        u(s) = n/(n+1) (F/k)^(1/n) (h^(1+1/n) - s^(1+1/n)),  s = |y - h|

    n = 1 reduces to the parabola above."""
    plaw = params.power_law()
    k, n = plaw if plaw else (params.nu(), 1.0)
    ny = params.ny
    F = params.body_force[0] if params.body_force else 1e-5
    h = (ny - 1) / 2.0
    s = np.abs(np.arange(ny, dtype=np.float64) - h)
    e = 1.0 + 1.0 / n
    return n / (n + 1.0) * (F / k) ** (1.0 / n) * (h ** e - s ** e)


def analytic_profile_duct(params: SimulationParams) -> np.ndarray:
    """Steady-state analytic ux(z, y) for the body-force driven
    RECTANGULAR DUCT (3-D: periodic x, no-slip walls in y and z) — the
    classical Fourier series (e.g. White, *Viscous Fluid Flow*, eq. 3.48;
    no reference analog — the C++ code is strictly 2-D):

        u(ŷ, ẑ) = (16 a² F)/(ν π³) Σ_{n odd} (−1)^((n−1)/2) / n³
                   · [1 − cosh(nπẑ/(2a)) / cosh(nπb/(2a))]
                   · cos(nπŷ/(2a))

    with ŷ ∈ [−a, a], ẑ ∈ [−b, b]. Same node-pinned wall convention as
    analytic_profile: u ≈ 0 at the wall NODES, so a = (ny−1)/2,
    b = (nz−1)/2, centered coordinates. Returns (nz, ny) to match the
    solver's ux[:, :, x] slice layout.
    """
    ny, nz = params.ny, params.nz
    nu = params.nu()
    F = params.body_force[0] if params.body_force else 1e-5
    a = (ny - 1) / 2.0
    b = (nz - 1) / 2.0
    yh = np.arange(ny, dtype=np.float64) - a     # ŷ, (ny,)
    zh = np.arange(nz, dtype=np.float64) - b     # ẑ, (nz,)
    u = np.zeros((nz, ny))
    for n in range(1, 100, 2):
        k = n * np.pi / (2.0 * a)
        sign = -1.0 if (n - 1) // 2 % 2 else 1.0
        term_z = 1.0 - np.cosh(k * zh) / np.cosh(k * b)   # (nz,)
        term_y = np.cos(k * yh)                           # (ny,)
        u += sign / n ** 3 * term_z[:, None] * term_y[None, :]
    return 16.0 * a * a * F / (nu * np.pi ** 3) * u
