"""Boundary conditions as masked per-population ("plane") updates.

The equivalent of the reference's edge loops (LBMSolver.h:147-265):
instead of rank-guarded OpenMP loops over boundary rows/columns, every BC is
a `jnp.where` over coordinate masks, applied identically on every shard (the
masks are empty away from the global edges), which keeps the program SPMD —
no divergent control flow across the device mesh.

All functions operate on a mutable *list* of Q population planes so that the
sequential read-after-write semantics of the reference (bottom wall, then top
wall, then inlet, then outlet, then obstacle — LBMSolver.h:150-263) carry
over verbatim, including the corner-cell interactions (e.g. the inlet's
Zou-He reads f6 *after* the bottom wall rewrote it).

D2Q9 index convention (= reference LBMConfig.h:13-25):
    0:(0,0) 1:(1,0) 2:(0,1) 3:(-1,0) 4:(0,-1) 5:(1,1) 6:(-1,1) 7:(-1,-1) 8:(1,-1)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice
from ..models.base import Problem


def _not_solid(mask, solid):
    return mask if solid is None else mask & ~solid


def apply_walls(lat: Lattice, planes: list, wall_mask, axis_component: int,
                sign: int, solid) -> None:
    """Bounce-back at a flat wall: for every direction i whose velocity
    component along `axis_component` has the given sign, f_i <- f_opposite(i).

    For D2Q9 bottom (sign=+1 on y): f2<-f4, f5<-f7, f6<-f8 — exactly
    LBMSolver.h:158-162; top (sign=-1): f4<-f2, f7<-f5, f8<-f6
    (LBMSolver.h:170-174). Generic over lattice so D3Q19 walls come free.
    """
    m = _not_solid(wall_mask, solid)
    opp = lat.opposite
    for i in range(lat.Q):
        if int(np.sign(lat.c[i, axis_component])) == sign:
            planes[i] = jnp.where(m, planes[int(opp[i])], planes[i])


def apply_moving_wall(lat: Lattice, planes: list, wall_mask,
                      axis_component: int, sign: int,
                      u_wall: tuple[float, ...], solid) -> None:
    """Bounce-back at a flat wall moving tangentially with velocity u_wall
    (lid-driven cavity lid; no reference analog — the reference's walls are
    all stationary, LBMSolver.h:153-176).

    Standard momentum-corrected reflection: for every direction i whose
    velocity component along `axis_component` has the given sign (pointing
    INTO the domain), f_i <- f_opposite(i) + 2 w_i rho_w (c_i . u_w)/c_s^2
    with c_s^2 = 1/3, i.e. + 6 w_i rho_w (c_i . u_w). rho_w is the
    Zou-He-style wall density estimated from KNOWN populations only
    (rho_w = sum_{c.n=0} f + 2 sum_{outgoing} f, exact at a resting wall):
    the unknown inward populations hold ghost constants at this point, and
    summing them would both bias rho_w and break the degree-1 homogeneity
    the closed-box mass gauge relies on. With u_wall = 0 this is exactly
    apply_walls.
    """
    m = _not_solid(wall_mask, solid)
    opp = lat.opposite
    rho_w = None
    for i in range(lat.Q):
        s = int(np.sign(lat.c[i, axis_component]))
        if s == sign:
            continue  # unknown inward population
        term = planes[i] if s == 0 else 2.0 * planes[i]
        rho_w = term if rho_w is None else rho_w + term
    uw = np.zeros(lat.D)
    uw[:len(u_wall)] = u_wall
    snap = list(planes)
    for i in range(lat.Q):
        if int(np.sign(lat.c[i, axis_component])) == sign:
            cu = float(lat.c[i].astype(np.float64) @ uw)
            val = snap[int(opp[i])]
            if cu:
                val = val + (6.0 * float(lat.w[i]) * cu) * rho_w
            planes[i] = jnp.where(m, val, planes[i])


def apply_thermal_wall(lat_g: Lattice, planes_g: list, wall_mask,
                       axis_component: int, sign: int, t_wall: float,
                       solid) -> None:
    """Fixed-temperature (Dirichlet) wall for the advection-diffusion
    scalar: anti-bounce-back. For every direction i pointing INTO the
    domain (sign of its `axis_component` velocity matches `sign`):

        g_i <- (w_i + w_opp(i)) · T_wall − g_opp(i)

    so the half-link-interpolated temperature between g_i and g_opp is
    exactly T_wall (the standard second-order Dirichlet closure for
    scalar LBM). New capability — no reference analog.
    """
    m = _not_solid(wall_mask, solid)
    opp = lat_g.opposite
    snap = list(planes_g)
    for i in range(lat_g.Q):
        if int(np.sign(lat_g.c[i, axis_component])) == sign:
            val = (float(lat_g.w[i] + lat_g.w[int(opp[i])]) * t_wall
                   - snap[int(opp[i])])
            planes_g[i] = jnp.where(m, val, planes_g[i])


def apply_zou_he_inlet(planes: list, inlet_mask, u_in: float, solid) -> None:
    """Zou-He velocity inlet on the x=0 column. Parity: LBMSolver.h:179-207.

    rho_bc = (f0+f2+f4 + 2(f3+f6+f7)) / (1 - u_in)
    f1 = f3 + 2/3 rho u;  f5 = f7 - (f2-f4)/2 + rho u/6;  f8 = f6 + (f2-f4)/2 + rho u/6
    """
    m = _not_solid(inlet_mask, solid)
    p = planes
    rho_bc = (p[0] + p[2] + p[4] + 2.0 * (p[3] + p[6] + p[7])) / (1.0 - u_in)
    ru = rho_bc * u_in
    half_trans = 0.5 * (p[2] - p[4])
    planes[1] = jnp.where(m, p[3] + (2.0 / 3.0) * ru, p[1])
    new5 = p[7] - half_trans + (1.0 / 6.0) * ru
    new8 = p[6] + half_trans + (1.0 / 6.0) * ru
    planes[5] = jnp.where(m, new5, p[5])
    planes[8] = jnp.where(m, new8, p[8])


def apply_zou_he_outlet(planes: list, outlet_mask, solid) -> None:
    """Zou-He pressure outlet (rho=1) on the x=nx-1 column.
    Parity: LBMSolver.h:210-236.

    u_out = -1 + (f0+f2+f4 + 2(f1+f5+f8)) / rho_out
    f3 = f1 - 2/3 u; f6 = f8 - (f2-f4)/2 - u/6; f7 = f5 + (f2-f4)/2 - u/6
    """
    m = _not_solid(outlet_mask, solid)
    p = planes
    u_out = -1.0 + (p[0] + p[2] + p[4] + 2.0 * (p[1] + p[5] + p[8]))  # rho_out = 1
    half_trans = 0.5 * (p[2] - p[4])
    new3 = p[1] - (2.0 / 3.0) * u_out
    new6 = p[8] - half_trans - (1.0 / 6.0) * u_out
    new7 = p[5] + half_trans - (1.0 / 6.0) * u_out
    planes[3] = jnp.where(m, new3, p[3])
    planes[6] = jnp.where(m, new6, p[6])
    planes[7] = jnp.where(m, new7, p[7])


def apply_equilibrium_inlet(lat: Lattice, planes: list, inlet_mask,
                            eq_in: np.ndarray, solid) -> None:
    """Simple equilibrium inlet (used by the 3-D model; no reference analog —
    the reference is 2-D only)."""
    m = _not_solid(inlet_mask, solid)
    for i in range(lat.Q):
        planes[i] = jnp.where(m, jnp.asarray(eq_in[i], planes[i].dtype), planes[i])


def apply_zero_gradient_outlet(lat: Lattice, planes: list, outlet_mask, solid) -> None:
    """Zero-gradient outlet: copy the neighbor column (3-D model)."""
    m = _not_solid(outlet_mask, solid)
    for i in range(lat.Q):
        shifted = jnp.roll(planes[i], 1, axis=-1)  # value from x-1
        planes[i] = jnp.where(m, shifted, planes[i])


def apply_zou_he_corners(planes: list, yy, xx, ny: int, nx: int,
                         solid) -> None:
    """Optional clean corner closure (Zou & He 1997 corner nodes) at the
    four wall∩inlet/outlet cells — an opt-in alternative to the reference's
    emergent corner chain (PARITY.md; config zou_he_corners="clean").

    Each corner enforces u = v = 0: the three wall-tangential unknowns
    bounce back, the remaining diagonal pair splits the density residual
    equally. rho* is the adjacent inlet-column node's density at the inlet
    corners (post-inlet-update) and the outlet's fixed rho = 1 at the
    outlet corners. No reference analog — the reference leaves corners to
    whatever the sequential edge updates compose to (LBMSolver.h:150-263).
    """
    p = planes
    rho = sum(p)
    # adjacent node one row into the domain on the same column
    rho_above = jnp.roll(rho, -1, axis=-2)   # value at y+1
    rho_below = jnp.roll(rho, 1, axis=-2)    # value at y-1

    def set_corner(mask, assigns, pair, rho_star):
        m = _not_solid(mask, solid)
        known = sum(p[i] for i in ([0] + [src for _, src in assigns]))
        resid = 0.5 * (rho_star - p[0]) - (known - p[0])
        for dst, src in assigns:
            planes[dst] = jnp.where(m, p[src], planes[dst])
        for i in pair:
            planes[i] = jnp.where(m, resid, planes[i])

    bl = (yy == 0) & (xx == 0)
    br = (yy == 0) & (xx == nx - 1)
    tl = (yy == ny - 1) & (xx == 0)
    tr = (yy == ny - 1) & (xx == nx - 1)
    # (dst <- src) bounce-backs; the leftover diagonal pair gets the residual
    one = jnp.asarray(1.0, rho.dtype)  # outlet corners: fixed rho_out = 1
    set_corner(bl, [(1, 3), (2, 4), (5, 7)], (6, 8), rho_above)
    set_corner(br, [(3, 1), (2, 4), (6, 8)], (5, 7), one)
    set_corner(tl, [(1, 3), (4, 2), (8, 6)], (5, 7), rho_below)
    set_corner(tr, [(3, 1), (4, 2), (7, 5)], (6, 8), one)


def apply_cavity_corners(planes: list, yy, xx, ny: int, nx: int,
                         solid) -> None:
    """Corner closure for fully wall-bounded (cavity) domains.

    At a wall∩wall corner node the two edge-diagonal populations are
    MUTUALLY-unknown opposites (both source from ghost cells), so the
    sequential wall reflections copy ghost garbage into each other — at
    rest that drains exactly 2 w_diag per corner per step (measured:
    0.222/step on an 8x8 box) and collapses the closed box's density.
    Closure (same structure as the Zou-He corner nodes,
    apply_zou_he_corners): the three unknowns with known opposites bounce
    back; the diagonal pair splits the density residual against rho* of
    the diagonally-inward neighbor, which pins the corner density to the
    local field instead of integrating the leak. Rest state (f = w) is an
    exact fixed point. Runs AFTER the wall passes and overwrites every
    corner unknown they mis-set. The moving lid's momentum correction is
    not applied at the top corners (the standard stationary-corner
    treatment of the lid singularity; Ghia-gated in tests/test_cavity.py).
    """
    p = planes
    rho = sum(p)

    def set_corner(mask, assigns, pair, rho_star):
        m = _not_solid(mask, solid)
        known = sum(p[i] for i in ([0] + [src for _, src in assigns]))
        resid = 0.5 * (rho_star - p[0]) - (known - p[0])
        for dst, src in assigns:
            planes[dst] = jnp.where(m, p[src], planes[dst])
        for i in pair:
            planes[i] = jnp.where(m, resid, planes[i])

    # diagonally-inward neighbor density per corner
    rho_ne = jnp.roll(rho, (-1, -1), axis=(-2, -1))  # value at (y+1, x+1)
    rho_nw = jnp.roll(rho, (-1, 1), axis=(-2, -1))   # value at (y+1, x-1)
    rho_se = jnp.roll(rho, (1, -1), axis=(-2, -1))   # value at (y-1, x+1)
    rho_sw = jnp.roll(rho, (1, 1), axis=(-2, -1))    # value at (y-1, x-1)
    bl = (yy == 0) & (xx == 0)
    br = (yy == 0) & (xx == nx - 1)
    tl = (yy == ny - 1) & (xx == 0)
    tr = (yy == ny - 1) & (xx == nx - 1)
    set_corner(bl, [(1, 3), (2, 4), (5, 7)], (6, 8), rho_ne)
    set_corner(br, [(3, 1), (2, 4), (6, 8)], (5, 7), rho_nw)
    set_corner(tl, [(1, 3), (4, 2), (8, 6)], (5, 7), rho_se)
    set_corner(tr, [(3, 1), (4, 2), (7, 5)], (6, 8), rho_sw)


def apply_obstacle(lat: Lattice, planes: list, solid, mode: str,
                   rest: np.ndarray) -> None:
    """Obstacle treatment at solid cells, applied after all edge BCs.

    mode="equilibrium" (default — reference parity): pin solid cells to rest
    equilibrium w_i. This reproduces the reference's *effective* dynamics: its
    collision skips solids and streaming reads f_next, so f_next at solid
    cells keeps the rest equilibrium written at init forever and fluid
    neighbors always pull w_i from the cylinder (LBMSolver.h:91, 128-145,
    LBMGrid.h:223-243). The reference's in-place bounce-back loop
    (LBMSolver.h:240-263) writes f_current at solids, which nothing
    dynamically reads — dead for the physics (SURVEY §2 C20 note).

    mode="bounce_back": correct full-way bounce-back — solid cells store the
    populations streamed in this step, reversed; collision skips solids (see
    step builders), so next step's streaming releases them back. A deliberate,
    documented improvement over the reference.
    """
    if solid is None:
        return
    if mode == "equilibrium":
        for i in range(lat.Q):
            planes[i] = jnp.where(solid, jnp.asarray(rest[i], planes[i].dtype),
                                  planes[i])
    elif mode == "bounce_back":
        snapshot = list(planes)
        opp = lat.opposite
        for i in range(lat.Q):
            planes[i] = jnp.where(solid, snapshot[int(opp[i])], planes[i])
    else:
        raise ValueError(f"unknown obstacle_bc mode: {mode}")


def apply_all(problem: Problem, planes: list, coords: dict) -> list:
    """Apply the problem's full BC stack in reference order.

    `coords` maps axis name -> broadcastable global-coordinate arrays and
    global extents: {'yy','xx',('zz'),'ny','nx',('nz'),'solid'} where solid is
    the (local) solid mask or None. Order parity: LBMSolver.h:150-263.
    """
    lat = problem.lattice
    solid = coords.get("solid")
    yy, xx = coords["yy"], coords["xx"]
    ny, nx = coords["ny"], coords["nx"]

    # Velocity components are stored (x, y[, z]) per the reference; the array
    # layout of f is (Q, [z,] y, x). Component indices below: x=0, y=1, z=2.
    if problem.walls_y:
        apply_walls(lat, planes, yy == 0, 1, +1, solid)
        if problem.lid_u:
            apply_moving_wall(lat, planes, yy == ny - 1, 1, -1,
                              (problem.lid_u,), solid)
        else:
            apply_walls(lat, planes, yy == ny - 1, 1, -1, solid)
    if problem.walls_z and lat.D == 3:
        zz, nz = coords["zz"], coords["nz"]
        apply_walls(lat, planes, zz == 0, 2, +1, solid)
        apply_walls(lat, planes, zz == nz - 1, 2, -1, solid)
    if problem.walls_x:
        apply_walls(lat, planes, xx == 0, 0, +1, solid)
        apply_walls(lat, planes, xx == nx - 1, 0, -1, solid)
        if problem.walls_y and lat.D == 2:
            apply_cavity_corners(planes, yy, xx, ny, nx, solid)
    if problem.inlet_zou_he:
        apply_zou_he_inlet(planes, xx == 0, problem.init_u[0], solid)
    if problem.inlet_equilibrium:
        apply_equilibrium_inlet(lat, planes, xx == 0, problem.ghost_ring_values(),
                                solid)
    if problem.outlet_zou_he:
        apply_zou_he_outlet(planes, xx == nx - 1, solid)
    if problem.outlet_zero_grad:
        apply_zero_gradient_outlet(lat, planes, xx == nx - 1, solid)
    if getattr(problem, "clean_corners", False) and lat.D == 2:
        apply_zou_he_corners(planes, yy, xx, ny, nx, solid)
    from .. import physics
    if problem.obstacle_bc == "bouzidi" and solid is not None:
        # curved-wall interpolated bounce-back on the cut links (needs the
        # pre-stream post-collision planes and the q table the step builder
        # put in coords), then rest-eq pin on the solid interior — nothing
        # dynamical reads it once every cut link is rewritten
        from . import bouzidi
        bouzidi.apply_bouzidi(lat, planes, coords["f_post"],
                              coords["bz_q"],
                              active=bouzidi.active_directions(problem))
        apply_obstacle(lat, planes, solid, "equilibrium",
                       physics.rest_equilibrium(lat))
    else:
        apply_obstacle(lat, planes, solid, problem.obstacle_bc,
                       physics.rest_equilibrium(lat))
    return planes
