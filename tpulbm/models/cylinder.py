"""Flagship model: 2-D flow around a cylinder (von Kármán vortex street).

A rebuild of the reference's one hard-coded setup:
channel with bounce-back walls (top/bottom), Zou-He velocity inlet (left),
Zou-He pressure outlet (right), solid cylinder (LBMSolver.h:147-265,
LBMGrid.h:152-183).
"""
from __future__ import annotations

from ..config import SimulationParams
from ..geometry import cylinder_mask
from ..lattice import D2Q9
from .base import Problem


def _cylinder_sdf(params: SimulationParams):
    """Analytic circle surface for the Bouzidi curved-wall mode: positive
    outside the cylinder, matching geometry.cylinder_mask's inclusive
    dist^2 <= r^2 voxelization (solid cells have sdf <= 0)."""
    import numpy as np
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    r = float(params.get_cylinder_radius_cells())

    def sdf(pts):
        d = np.hypot(pts[..., 0] - cx, pts[..., 1] - cy)
        return d - r

    return sdf


def _cylinder_spin(params: SimulationParams):
    """Rigid-rotation wall velocity u_w = ω × (x − c) for a spinning
    cylinder (cylinder_omega, rad/step; bouzidi mode only — the voxel
    modes have no moving-wall machinery)."""
    import numpy as np
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    om = float(params.cylinder_omega)

    def uw(pts):
        return np.stack([-om * (pts[..., 1] - cy),
                         om * (pts[..., 0] - cx)], axis=-1)

    return uw


def make_problem(params: SimulationParams) -> Problem:
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=cylinder_mask(params),
        obstacle_sdf=_cylinder_sdf(params),
        obstacle_velocity=(_cylinder_spin(params)
                           if params.cylinder_omega else None),
        init_rho=1.0,
        init_u=(params.inlet_velocity, 0.0),
        inlet_zou_he=True,
        outlet_zou_he=True,
        walls_y=True,
        periodic_x=False,
        body_force=tuple(params.body_force),
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
        clean_corners=params.zou_he_corners == "clean",
    )
