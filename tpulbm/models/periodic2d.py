"""Fully periodic 2-D model families: Taylor-Green vortex + double shear
layer. New capability — the reference has no periodic-box mode at all
(its y rows are always bounce-back walls, LBMSolver.h:150-176).

* problem="taylor-green" — the classic decaying vortex lattice with an
  exact Navier-Stokes solution: u decays as exp(−ν k² t) with
  k² = kx² + ky². This is the sharpest viscosity gate available to an
  LBM code: the measured energy-decay rate recovers ν = (τ − ½)/3 to a
  fraction of a percent (tests/test_periodic.py), independent of any
  boundary treatment.

* problem="shear-layer" — Minion & Brown's thin doubly-periodic double
  shear layer, the canonical stability benchmark for collision
  operators: at Re = 30,000 on 128² plain BGK diverges while the
  regularized operator (--collision regularized) runs it stably.

* problem="kolmogorov" — forced (Kolmogorov) flow: a stationary body
  force F_x(y) = F0·cos(κy), κ = 2π·n/ny, drives n shear bands; above
  Re = u0/(νκ) ≈ √2 the bands destabilize into sustained 2-D
  turbulence. The force is a Problem.force_fn evaluated in-step from
  global coordinates (no stored field, shards for free); pairs with
  --stats-from Reynolds statistics and scripts/spectra.py. With nz > 0
  the same problem name gives the 3-D variant — F_x(z) = F0·cos(κz),
  κ = 2π·n/nz on D3Q19/D3Q27 — the classic monochromatic forcing for
  sustained box turbulence with a k^-5/3 inertial range.

Both initialize via Problem.init_fields (equilibrium at an analytic
(rho, u) field) and run with periodic_y=True — the halo machinery wraps
the y rings (parallel/halo.py), so no shard has a physical y edge.
"""
from __future__ import annotations

import numpy as np

from ..config import SimulationParams
from ..lattice import D2Q9
from .base import Problem


def _grids(params: SimulationParams):
    x = np.arange(params.nx, dtype=np.float64)
    y = np.arange(params.ny, dtype=np.float64)
    return np.meshgrid(x, y)            # X, Y each (ny, nx)


def taylor_green_fields(params: SimulationParams, t: float = 0.0):
    """Analytic (rho, u) of the decaying Taylor-Green vortex at time t
    (lattice units), one full period per box axis."""
    nx, ny = params.nx, params.ny
    u0 = params.inlet_velocity or 0.04
    kx = 2.0 * np.pi / nx
    ky = 2.0 * np.pi / ny
    nu = params.nu()
    damp = np.exp(-nu * (kx * kx + ky * ky) * t)
    X, Y = _grids(params)
    ux = -u0 * np.sqrt(ky / kx) * np.cos(kx * X) * np.sin(ky * Y) * damp
    uy = u0 * np.sqrt(kx / ky) * np.sin(kx * X) * np.cos(ky * Y) * damp
    # consistent pressure: p = -(u0²/4)[(ky/kx)cos2kx·x + (kx/ky)cos2ky·y]
    p = -0.25 * u0 * u0 * ((ky / kx) * np.cos(2 * kx * X)
                           + (kx / ky) * np.cos(2 * ky * Y)) * damp * damp
    rho = 1.0 + 3.0 * p                  # cs² = 1/3
    return rho, np.stack([ux, uy])


def shear_layer_fields(params: SimulationParams, k: float = 80.0,
                       delta: float = 0.05):
    """Minion & Brown (1997) thin double shear layer: two tanh layers at
    y = L/4 and 3L/4 with a sinusoidal transverse perturbation."""
    nx, ny = params.nx, params.ny
    u0 = params.inlet_velocity or 0.04
    X, Y = _grids(params)
    xr, yr = X / nx, Y / ny
    ux = np.where(yr <= 0.5, u0 * np.tanh(k * (yr - 0.25)),
                  u0 * np.tanh(k * (0.75 - yr)))
    uy = delta * u0 * np.sin(2.0 * np.pi * (xr + 0.25))
    rho = np.ones((ny, nx))
    return rho, np.stack([ux, uy])


def kolmogorov_kappa(params: SimulationParams) -> float:
    """Forcing wavenumber κ = 2π·n/ny (lattice units)."""
    return 2.0 * np.pi * params.kolmogorov_n / params.ny


def kolmogorov_f0(params: SimulationParams) -> float:
    """Forcing amplitude F0 = u0·ν·κ² — chosen so the LAMINAR fixed point
    u_x(y) = F0/(ν κ²)·cos(κ y) peaks exactly at u0 = inlet_velocity.
    The Kolmogorov Reynolds number is then Re = u0/(ν·κ); the n-band flow
    destabilizes for Re ≳ √2·(corrections in n), giving sustained 2-D
    turbulence — the canonical forced-turbulence benchmark."""
    u0 = params.inlet_velocity or 0.04
    kappa = kolmogorov_kappa(params)
    return u0 * params.nu() * kappa * kappa


def kolmogorov_force_fn(params: SimulationParams):
    """Problem.force_fn for Kolmogorov forcing: F(y) = (F0·cos(κy), 0).
    Evaluated in-step from global y indices (models/base.force_fn
    contract); cos(κy) has period ny/n with integer n, so halo cells at
    y = −1 / ny wrap automatically."""
    import jax.numpy as jnp
    kappa = kolmogorov_kappa(params)
    f0 = kolmogorov_f0(params)

    def force(coords):
        return (f0 * jnp.cos(kappa * coords["yy"]), 0.0)

    return force


def kolmogorov_fields(params: SimulationParams, perturb: float = 0.01):
    """Initial (rho, u): the laminar profile plus a small deterministic
    transverse seed (breaks translation symmetry so the instability can
    grow past the critical Re without waiting on round-off)."""
    u0 = params.inlet_velocity or 0.04
    kappa = kolmogorov_kappa(params)
    X, Y = _grids(params)
    ux = u0 * np.cos(kappa * Y)
    uy = perturb * u0 * np.sin(2.0 * np.pi * X / params.nx)
    return np.ones((params.ny, params.nx)), np.stack([ux, uy])


def passive_scalar_T0(params: SimulationParams):
    """Initial scalar: one sinusoidal stripe along x, T = t_ref +
    ½ΔT·sin(2πx/nx) — the cleanest mode for diffusion/advection gates
    (its amplitude decays at exactly exp(−α q² t) in a quiescent box)."""
    t_ref = 0.5 * (params.t_hot + params.t_cold)
    amp = 0.5 * (params.t_hot - params.t_cold)
    x = np.arange(params.nx, dtype=np.float64)[None, :]
    return (t_ref + amp * np.sin(2.0 * np.pi * x / params.nx)
            ) * np.ones((params.ny, 1))


def kolmogorov3d_kappa(params: SimulationParams) -> float:
    """3-D forcing wavenumber κ = 2π·n/nz (the force varies along z)."""
    return 2.0 * np.pi * params.kolmogorov_n / params.nz


def kolmogorov3d_force_fn(params: SimulationParams):
    """Problem.force_fn for 3-D Kolmogorov forcing: F = (F0·cos(κz), 0, 0)
    with the same F0 = u0·ν·κ² laminar-peak calibration as 2-D. The
    classic monochromatic forcing for sustained 3-D box turbulence —
    above Re = u0/(νκ) ~ O(1) the shear bands destabilize and cascade."""
    import jax.numpy as jnp
    kappa = kolmogorov3d_kappa(params)
    u0 = params.inlet_velocity or 0.04
    f0 = u0 * params.nu() * kappa * kappa

    def force(coords):
        return (f0 * jnp.cos(kappa * coords["zz"]), 0.0, 0.0)

    return force


def kolmogorov3d_fields(params: SimulationParams, perturb: float = 0.01):
    """Initial (rho, u): laminar profile u_x(z) = u0·cos(κz) plus small
    deterministic transverse seeds along the other two axes (breaks both
    translation symmetries so secondary instabilities can grow)."""
    nx, ny, nz = params.nx, params.ny, params.nz
    u0 = params.inlet_velocity or 0.04
    kappa = kolmogorov3d_kappa(params)
    z = np.arange(nz, dtype=np.float64)[:, None, None]
    y = np.arange(ny, dtype=np.float64)[None, :, None]
    x = np.arange(nx, dtype=np.float64)[None, None, :]
    ux = u0 * np.cos(kappa * z) * np.ones((1, ny, nx))
    uy = perturb * u0 * np.sin(2.0 * np.pi * x / nx) * np.ones((nz, ny, 1))
    uz = perturb * u0 * np.sin(2.0 * np.pi * y / ny) * np.ones((nz, 1, nx))
    return np.ones((nz, ny, nx)), np.stack([ux, uy, uz])


def taylor_green_3d_fields(params: SimulationParams):
    """Classic 3-D Taylor-Green vortex (one period per axis):
    u = u0 ( sin x cos y cos z, −cos x sin y cos z, 0 ) with the matching
    pressure field. Unlike 2-D there is no closed-form solution for all
    time (vortex stretching) — the canonical transition/DNS benchmark."""
    nx, ny, nz = params.nx, params.ny, params.nz
    u0 = params.inlet_velocity or 0.04
    kx, ky, kz = (2 * np.pi / nx, 2 * np.pi / ny, 2 * np.pi / nz)
    z = np.arange(nz, dtype=np.float64)[:, None, None] * kz
    y = np.arange(ny, dtype=np.float64)[None, :, None] * ky
    x = np.arange(nx, dtype=np.float64)[None, None, :] * kx
    ux = u0 * np.sin(x) * np.cos(y) * np.cos(z)
    uy = -u0 * np.cos(x) * np.sin(y) * np.cos(z)
    uz = np.zeros_like(ux)
    p = (u0 * u0 / 16.0) * (np.cos(2 * x) + np.cos(2 * y)) \
        * (np.cos(2 * z) + 2.0)
    rho = 1.0 + 3.0 * p
    return rho, np.stack([ux, uy, uz])


def make_problem(params: SimulationParams) -> Problem:
    if params.is_3d:
        if params.problem not in ("taylor-green", "kolmogorov"):
            raise ValueError(f"{params.problem} is 2-D only")
        from ..lattice import D3Q19, D3Q27
        lat = D3Q27 if params.lattice3d == "d3q27" else D3Q19
        if params.problem == "kolmogorov":
            fields3 = kolmogorov3d_fields(params)
            force3 = kolmogorov3d_force_fn(params)
        else:
            fields3 = taylor_green_3d_fields(params)
            force3 = None
        return Problem(
            params=params, lattice=lat, solid=None,
            init_rho=1.0, init_u=(0.0, 0.0, 0.0),
            walls_y=False, walls_z=False,
            periodic_x=True, periodic_y=True, periodic_z=True,
            body_force=tuple(params.body_force),
            force_fn=force3,
            obstacle_bc=params.obstacle_bc,
            collision=params.collision,
            smagorinsky=params.smagorinsky,
            power_law=params.power_law() or (),
            trt_magic=params.trt_magic,
            mrt_rates=params.mrt_rates,
            init_fields=fields3,
        )
    force_fn = None
    if params.problem == "taylor-green":
        fields = taylor_green_fields(params)
    elif params.problem == "kolmogorov":
        fields = kolmogorov_fields(params)
        force_fn = kolmogorov_force_fn(params)
    elif params.problem == "passive-scalar":
        pass  # handled below (thermal config)
    else:
        fields = shear_layer_fields(params)
    thermal = None
    init_T = None
    if params.problem == "passive-scalar":
        # Passive scalar transport in a fully periodic box: the D2Q5
        # scalar advects/diffuses with ZERO back-coupling (buoyancy=0) in
        # a decaying Taylor-Green flow (inlet_velocity > 0 — the stirrer)
        # or a quiescent box (inlet_velocity = 0 — pure diffusion). The
        # whole double-population machinery (stacked state, rings,
        # sharding) carries over from the thermal models; only the y-wall
        # BCs are skipped (walls_y=False + periodic_y, step_thermal).
        # New capability — the reference is isothermal and wall-bounded.
        from ..lattice import D2Q5
        from .base import ThermalConfig
        if params.thermal_tau <= 0.5:
            raise ValueError(
                f"passive-scalar needs thermal_tau > 0.5 (diffusivity "
                f"alpha = (thermal_tau - 1/2)/3 > 0), got "
                f"{params.thermal_tau}")
        u0 = params.inlet_velocity
        if u0:
            fields = taylor_green_fields(params)
        else:
            fields = (np.ones((params.ny, params.nx)),
                      np.zeros((2, params.ny, params.nx)))
        init_T = passive_scalar_T0(params)
        thermal = ThermalConfig(
            lattice=D2Q5,
            tau_g=params.thermal_tau,
            t_bottom=params.t_hot,
            t_top=params.t_cold,
            buoyancy=0.0,
            perturb=0.0,
        )
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=None,
        init_rho=1.0,
        init_u=(0.0, 0.0),
        walls_y=False,
        periodic_x=True,
        periodic_y=True,
        body_force=tuple(params.body_force),
        force_fn=force_fn,
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
        init_fields=fields,
        thermal=thermal,
        init_T=init_T,
    )
