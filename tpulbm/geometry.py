"""Obstacle geometry: solid-cell masks.

The equivalent of the reference's per-cell cylinder rasterization
(LBMGrid.h:152-183): instead of an OpenMP loop over local cells with global
coordinates, we build the full boolean mask with one broadcasted expression;
sharding later slices it per device.
"""
from __future__ import annotations

import numpy as np

from .config import SimulationParams


def cylinder_mask(params: SimulationParams) -> np.ndarray:
    """Boolean (ny, nx) mask, True on solid cells.

    Parity with LBMGrid.h:164-168: integer center/radius
    (LBMConfig.h:61-65) and inclusive dist^2 <= r^2 test.
    """
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    r = params.get_cylinder_radius_cells()
    # open grids: (ny,1) + (1,nx) broadcast — no full-size index temporaries
    yy, xx = np.ogrid[0:params.ny, 0:params.nx]
    dx = xx.astype(np.float64) - cx
    dy = yy.astype(np.float64) - cy
    return (dx * dx + dy * dy) <= float(r) * float(r)


def sphere_mask(params: SimulationParams) -> np.ndarray:
    """Boolean (nz, ny, nx) mask for a sphere (3-D extension; new capability).

    Center fractions reuse cylinder_{x,y}; z is centered; radius is
    cylinder_radius * ny, as in 2-D.
    """
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    cz = params.nz // 2
    r = params.get_cylinder_radius_cells()
    # open grids: three 1-D axes broadcast at the final add — at 256³,
    # np.mgrid's three full int64 index cubes took ~a minute on a slow host
    zz, yy, xx = np.ogrid[0:params.nz, 0:params.ny, 0:params.nx]
    d2 = ((xx - cx).astype(np.float64) ** 2 + (yy - cy).astype(np.float64) ** 2
          + (zz - cz).astype(np.float64) ** 2)
    return d2 <= float(r) * float(r)


def solid_cell_count(mask: np.ndarray) -> int:
    """Global solid-cell count (reference prints this at setup, LBMGrid.h:174-182)."""
    return int(mask.sum())
