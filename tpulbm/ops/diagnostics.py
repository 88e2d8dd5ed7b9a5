"""On-device diagnostics: macroscopic fields, stability, max velocity.

Equivalents of the reference's reductions (LBMGrid.h:285-344) and
the macroscopic-field bookkeeping its collision loop does on the side
(LBMSolver.h:111-114 + BC overrides at LBMSolver.h:203-205, 232-234,
260-261): we recompute moments from the current state once per output frame
instead of storing three extra field arrays every step — the extra flops
cost little next to the saved memory traffic.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import physics
from ..models.base import Problem


def fields_fn(problem: Problem):
    """Jittable f -> (rho, ux, uy[, uz]) with the reference's solid-cell
    overrides: u=0 and rho=1 at solids (LBMSolver.h:260-261; rho at solids is
    never updated from its 1.0 init in the reference)."""
    lat = problem.lattice
    solid_np = problem.solid

    def fn(f):
        if problem.shan_chen:
            # multiphase: the measurable momentum of the forced system is
            # the half-step-corrected u + F/(2rho) (Shan & Chen 1993) —
            # bare moments would be off by F/(2rho) at every interface cell
            from .step_multiphase import physical_velocity
            rho, u = physical_velocity(problem, f)
        else:
            rho, u = physics.moments(lat, f[:lat.Q])  # thermal stacks g under f
        if solid_np is not None:
            solid = jnp.asarray(solid_np)
            rho = jnp.where(solid, jnp.asarray(1.0, rho.dtype), rho)
            u = jnp.where(solid[None], jnp.asarray(0.0, u.dtype), u)
        return rho, u

    return fn


def stats_sample_fn(problem: Problem):
    """Jittable f -> (rho, u, uu) one Reynolds-statistics sample: the
    macroscopic fields plus the packed second-moment products
    u_i·u_j (upper triangle, row-major: 2-D [uu, uv, vv]; 3-D
    [uu, uv, uw, vv, vw, ww]).

    Accumulated on device inside the super-chunk scan
    (parallel/sharded_step.make_super_chunk_fn with_stats=True) so a
    time-averaged turbulence run (mean fields + Reynolds stresses
    <u_i'u_j'> = <u_i u_j> - <u_i><u_j>) costs no extra host round trips.
    New capability — the reference has no flow statistics at all."""
    base = fields_fn(problem)
    D = problem.lattice.D
    pairs = [(i, j) for i in range(D) for j in range(i, D)]

    def fn(f):
        rho, u = base(f)
        uu = jnp.stack([u[i] * u[j] for i, j in pairs])
        return rho, u, uu

    return fn


def stats_pair_names(D: int) -> list[str]:
    """Component labels matching stats_sample_fn's uu packing."""
    ax = "xyz"[:D]
    return [f"u{ax[i]}u{ax[j]}" for i in range(D) for j in range(i, D)]


def stability_fn(problem: Problem):
    """Jittable f -> bool scalar (reference check_stability,
    LBMGrid.h:285-317, evaluated per chunk — see physics.is_stable)."""
    def fn(f):
        return physics.is_stable(f)
    return fn


def max_velocity_fn(problem: Problem):
    """Jittable f -> max |u| (reference max_velocity, LBMGrid.h:319-344)."""
    solid_np = problem.solid

    def fn(f):
        solid = None if solid_np is None else jnp.asarray(solid_np)
        lat = problem.lattice
        return physics.max_velocity(lat, f[:lat.Q], solid)

    return fn


def probe_cells(problem: Problem) -> tuple:
    """Absolute ([z,] y, x) cell indices for params.probe_points (domain
    fractions, (x, y[, z]) order — same convention as cylinder_x/y)."""
    p = problem.params
    cells = []
    for pt in p.probe_points:
        if len(pt) != (3 if p.is_3d else 2):
            raise ValueError(f"probe point {pt} has wrong dimensionality")
        if any(not (0.0 <= v <= 1.0) for v in pt):
            # a negative fraction would Python-wrap and silently sample
            # the opposite edge of the domain
            raise ValueError(f"probe point {pt} must be domain fractions "
                             f"in [0, 1]")
        x = min(int(pt[0] * p.nx), p.nx - 1)
        y = min(int(pt[1] * p.ny), p.ny - 1)
        idx = (min(int(pt[2] * p.nz), p.nz - 1), y, x) if p.is_3d else (y, x)
        cells.append(idx)
    return tuple(cells)


def probes_fn(problem: Problem):
    """Jittable f -> (n_probes, 1 + D [+ 1]) of [rho, u..., (T)] at the
    probe cells (thermal problems append the local temperature).

    Static single-cell indexing — a slice on the sharded array, no
    gather/collective; rides the super-chunk diagnostics round trip
    (parallel/sharded_step.make_super_chunk_fn) so a probe trace costs no
    extra host syncs. The standard instrument for extracting shedding
    frequencies from a wake point signal (probes.csv; scripts/lift.py
    accepts either signal). New capability — the reference has no probes.
    """
    lat = problem.lattice
    c = jnp.asarray(lat.c.astype("float64"))
    cells = probe_cells(problem)
    thermal = problem.thermal is not None

    def fn(f):
        rows = []
        for idx in cells:
            col = f[(slice(None),) + idx]               # (state_q,)
            fcol = col[:lat.Q]
            rho = jnp.sum(fcol)
            # precision=HIGHEST: a default-precision product may run in TF32
            mom = jnp.matmul(jnp.asarray(c, fcol.dtype).T, fcol,
                             precision=jax.lax.Precision.HIGHEST)  # (D,)
            parts = [rho[None], mom / rho]
            if thermal:
                parts.append(jnp.sum(col[lat.Q:])[None])
            rows.append(jnp.concatenate(parts))
        return jnp.stack(rows)

    return fn
