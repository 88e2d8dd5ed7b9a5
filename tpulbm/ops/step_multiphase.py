"""Shan-Chen single-component multiphase step — jax tier.

Pseudopotential two-phase flow (liquid-vapor coexistence, droplets,
Laplace pressure jumps) per Shan & Chen (1993): an interaction force

    F(x) = −g ψ(x) Σ_{i>0} w_i ψ(x + c_i) c_i,   ψ = ρ0 (1 − e^(−ρ/ρ0))

enters the BGK collision through the velocity-shift forcing
(physics.collide_shan_chen). g < −4 (with ρ0 = 1) separates phases; the
bulk EOS is physics.shan_chen_pressure. No reference analog — the
reference is strictly single-phase.

Geometry: x-periodic channel with exact-mass full-way bounce-back walls
in y (the thermal models' wall scheme — mass drift would swamp a long
coexistence measurement). The ψ stencil beyond a wall reads the frozen
ghost density ρ = init_rho (a neutral-wetting phantom fluid; this matches
the sharded tier, whose physical-edge pad rows hold the frozen eq ring).

Unlike every other model, collision here has a 1-cell STENCIL (ψ of the
neighbors), so the sharded chunk body exchanges halos TWICE per step:
refresh → collide (interior only) → refresh (pads now hold the
neighbors' post-collision edges) → pull-stream. Both sub-steps are built
by make_local_steps_multiphase; parallel/sharded_step.py wires the
double-refresh body. A fused GPU kernel is future work.
"""
from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from .. import physics
from ..models.base import Problem


def _mp_parts(problem: Problem):
    if not problem.shan_chen:
        raise ValueError("step_multiphase needs problem.shan_chen = (g, rho0)")
    g, rho0 = problem.shan_chen
    return problem.lattice, float(g), float(rho0)


def shan_chen_force(lat, psi: jnp.ndarray, g: float, wall_psi: float,
                    is_bottom=True, is_top=True) -> jnp.ndarray:
    """(D, ny, nx) interaction force from a ψ field.

    Rolls wrap in both axes; x is physically periodic, while y pulls that
    crossed a physical wall (only when this block holds that wall row) are
    replaced by the phantom wall ψ. On padded blocks the pad rows/cols
    already hold valid neighbor ψ, so is_bottom/is_top apply only to the
    physical walls.
    """
    ny = psi.shape[0]
    yy = jnp.arange(ny)[:, None]
    comps = [None, None]
    for i in range(1, lat.Q):
        cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
        nb = jnp.roll(psi, (-cy, -cx), (0, 1))
        if cy > 0:  # reads row y+1: invalid at the physical top row
            nb = jnp.where(jnp.logical_and(is_top, yy == ny - 1),
                           wall_psi, nb)
        elif cy < 0:
            nb = jnp.where(jnp.logical_and(is_bottom, yy == 0),
                           wall_psi, nb)
        w = float(lat.w[i])
        for d, cd in ((0, cx), (1, cy)):
            if cd == 0:
                continue
            term = (w * cd) * nb
            comps[d] = term if comps[d] is None else comps[d] + term
    return (-g) * psi * jnp.stack(comps)


def make_step_multiphase(problem: Problem) -> Callable[[jnp.ndarray],
                                                       jnp.ndarray]:
    """Single-device oracle step on the unpadded global state."""
    lat, g, rho0 = _mp_parts(problem)
    ny, nx = problem.spatial_shape
    if not problem.periodic_x:
        raise NotImplementedError("multiphase v1 is an x-periodic channel")
    inv_tau = 1.0 / problem.params.tau
    wall_psi = float(np.asarray(
        physics.shan_chen_psi(jnp.asarray(float(problem.init_rho)), rho0)))
    opp = lat.opposite

    def step(f: jnp.ndarray) -> jnp.ndarray:
        rho = jnp.sum(f, axis=0)
        psi = physics.shan_chen_psi(rho, rho0)
        F = shan_chen_force(lat, psi, g, wall_psi)
        f_post = physics.collide_shan_chen(lat, f, inv_tau, F)
        yy = jnp.arange(ny)[:, None]
        planes = []
        for i in range(lat.Q):
            cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
            planes.append(jnp.roll(f_post[i], (cy, cx), (0, 1)))
        # exact-mass walls: incoming populations at a wall row are the
        # node's OWN post-collision outward values (wrapped pulls there are
        # fully overwritten)
        for i in range(lat.Q):
            cy = int(lat.c[i, 1])
            if cy > 0:
                planes[i] = jnp.where(yy == 0, f_post[int(opp[i])],
                                      planes[i])
            elif cy < 0:
                planes[i] = jnp.where(yy == ny - 1, f_post[int(opp[i])],
                                      planes[i])
        return jnp.stack(planes)

    return step


def make_local_steps_multiphase(problem: Problem,
                                local_shape: tuple[int, ...]):
    """(collide_fn, stream_fn) on a 1-cell halo-padded local block, for the
    double-refresh sharded body (see module docstring).

    collide_fn(spad, offsets): ψ/force from the padded block (pads hold
    valid pre-collision neighbor f after refresh #1), post-collision
    written to the INTERIOR only.
    stream_fn(spad, offsets): pull-stream from the padded post-collision
    block (pads refreshed again) + exact-mass walls on physical wall rows.
    """
    lat, g, rho0 = _mp_parts(problem)
    nyl, nxl = local_shape
    p = problem.params
    if not problem.periodic_x:
        raise NotImplementedError("multiphase v1 is an x-periodic channel")
    inv_tau = 1.0 / p.tau
    wall_psi = float(np.asarray(
        physics.shan_chen_psi(jnp.asarray(float(problem.init_rho)), rho0)))
    opp = lat.opposite

    def collide_fn(spad, offsets):
        rho = jnp.sum(spad, axis=0)
        psi = physics.shan_chen_psi(rho, rho0)
        # force valid on the interior (the pad ring's own neighbors are
        # out of reach, but only interior cells are written back). The
        # physical-edge pad rows hold the frozen eq ring (rho = init_rho),
        # which IS the phantom wall fluid, so no extra masking is needed
        # there beyond the oracle-matching wall rows.
        F = shan_chen_force(lat, psi, g, wall_psi,
                            is_bottom=jnp.asarray(False),
                            is_top=jnp.asarray(False))
        # the oracle replaces wall-crossing ψ pulls with wall_psi; on the
        # padded block those pulls land in the pad rows, which at physical
        # edges hold eq-ring rho = init_rho -> psi == wall_psi already.
        f_post = physics.collide_shan_chen(lat, spad, inv_tau, F)
        return spad.at[:, 1:-1, 1:-1].set(f_post[:, 1:-1, 1:-1])

    def stream_fn(spad, offsets):
        y0 = offsets[-2]
        is_bottom, is_top = y0 == 0, y0 + nyl == p.ny
        planes = []
        for i in range(lat.Q):
            cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
            slicer = (slice(1 - cy, 1 - cy + nyl),
                      slice(1 - cx, 1 - cx + nxl))
            planes.append(spad[(i,) + slicer])
        bot = jnp.zeros((nyl, 1), bool).at[0, 0].set(is_bottom)
        top = jnp.zeros((nyl, 1), bool).at[-1, 0].set(is_top)
        center = (slice(1, -1), slice(1, -1))
        for i in range(lat.Q):
            cy = int(lat.c[i, 1])
            if cy > 0:
                planes[i] = jnp.where(bot, spad[int(opp[i])][center],
                                      planes[i])
            elif cy < 0:
                planes[i] = jnp.where(top, spad[int(opp[i])][center],
                                      planes[i])
        return spad.at[:, 1:-1, 1:-1].set(jnp.stack(planes))

    return collide_fn, stream_fn


def physical_velocity(problem: Problem, f: jnp.ndarray):
    """(rho, u_phys): the half-step-corrected velocity u + F/(2ρ) — the
    measurable momentum of the forced system (Shan & Chen 1993)."""
    lat, g, rho0 = _mp_parts(problem)
    rho, u = physics.moments(lat, f)
    psi = physics.shan_chen_psi(rho, rho0)
    # host-side constant (this function is called under jit)
    wall_psi = rho0 * (1.0 - float(np.exp(-problem.init_rho / rho0)))
    F = shan_chen_force(lat, psi, g, wall_psi)
    return rho, u + F / (2.0 * rho)
