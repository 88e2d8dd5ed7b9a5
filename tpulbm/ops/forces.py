"""Momentum-exchange force evaluation on the obstacle.

The equivalent of IOManager::record_forces (LBMIO.h:114-192): the
reference loops over solid cells, finds in-rank fluid neighbors, and sums
2*c_i*f_next(fluid, i). Here the same sum is a handful of masked rolls:

    F = Σ_i 2 c_i Σ_x f_post_i(x) · fluid(x) · solid(x + c_i)

evaluated on the post-collision populations (reference calls it after
collision, before streaming — LBMSolver.h:51-54). Being expressed on global
arrays it is halo-correct by construction, fixing the reference's silent
undercounting at rank boundaries (bounds check LBMIO.h:143-145; SURVEY §5
deviation #2).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..models.base import Problem


def momentum_exchange(problem: Problem, f_post: jnp.ndarray,
                      solid: jnp.ndarray) -> jnp.ndarray:
    """Force vector (D,) on the obstacle from post-collision populations."""
    lat = problem.lattice
    c = lat.c
    ndim = f_post.ndim - 1
    fluid = ~solid
    comps = []
    for d in range(lat.D):
        total = jnp.zeros((), f_post.dtype)
        for i in range(1, lat.Q):
            cid = int(c[i, d])
            if cid == 0:
                continue
            # solid neighbor at x + c_i → roll solid by -c_i (array axes are
            # ([z,] y, x), velocity components are (x, y[, z])).
            shifts = tuple(-int(c[i, k]) for k in range(lat.D))[::-1]
            solid_shift = jnp.roll(solid, shifts, tuple(range(ndim)))
            # jnp.roll wraps; on non-periodic axes a solid cell touching a
            # domain edge must not pair with fluid on the opposite edge
            # (the reference bounds-checks instead, LBMIO.h:143-145).
            for axis, s in enumerate(shifts):
                if s == 0:
                    continue
                if axis == ndim - 1 and problem.periodic_x:
                    continue
                idx = [slice(None)] * ndim
                idx[axis] = 0 if s > 0 else -1
                solid_shift = solid_shift.at[tuple(idx)].set(False)
            contrib = jnp.sum(jnp.where(fluid & solid_shift, f_post[i], 0.0))
            total = total + 2.0 * cid * contrib
        comps.append(total)
    return jnp.stack(comps)


def force_coefficients(problem: Problem, force: np.ndarray) -> tuple[float, float]:
    """C_D, C_L.

    2-D: the reference normalization q = ½ ρ U² D per unit span,
    D = 2 * int(cylinder_radius * ny) cells (LBMIO.h:171-178 — note this
    uses the integer cell radius, the reference's quirk #4).

    3-D (sphere — no reference analog, the C++ code is strictly 2-D): the
    standard aerodynamic convention q = ½ ρ U² A with the frontal area
    A = π r², so the reported C_D is comparable to the sphere drag-curve
    literature (Schiller-Naumann et al.) rather than to the 2-D cylinder
    convention."""
    p = problem.params
    U = p.inlet_velocity
    r = float(p.get_cylinder_radius_cells())
    if problem.lattice.D == 3:
        area = np.pi * r * r
    else:
        area = 2.0 * r
    q = 0.5 * 1.0 * U * U * area
    if q <= 1e-12:
        return 0.0, 0.0
    return float(force[0] / q), float(force[1] / q)


def bouzidi_momentum_exchange_fn(problem: Problem):
    """Jittable (f_post, q) -> force: Ladd-style momentum exchange over the
    CUT links of the Bouzidi closure, F = Σ_links c_i · (f̂_i + f_j^new),
    where f_j^new is the very population ops/bouzidi.py will write (the
    staircase form 2 c_i f̂_i is recovered exactly when every q = 1/2).
    The q table is a real (traced) argument sharded like f, so the whole
    sum is masked rolls/selects — SPMD-safe on any mesh, and no grid-sized
    constant bakes into the program."""
    lat = problem.lattice
    opp = lat.opposite
    ndim = len(problem.spatial_shape)

    def fn(f_post, q):
        dt = f_post.dtype
        moving = q.shape[0] == 2 * lat.Q
        comps = [jnp.zeros((), dt) for _ in range(lat.D)]
        for j in range(1, lat.Q):
            i = int(opp[j])
            qj = q[j].astype(dt)
            has = qj >= 0.0
            ltm = qj < 0.5
            inv2q = 1.0 / (2.0 * jnp.maximum(qj, 0.5))
            a = jnp.where(ltm, 2.0 * qj, inv2q)
            b = jnp.where(ltm, 1.0 - 2.0 * qj, 0.0)
            cc = jnp.where(ltm, 0.0, 1.0 - inv2q)
            fi = f_post[i]
            # upstream node x_f + c_j; where b > 0 link_q guaranteed it is
            # in-domain fluid, so any non-periodic wrap garbage is b=0-masked
            per_axis = tuple(-int(v) for v in lat.c[j])[::-1]
            fup = jnp.roll(fi, per_axis, tuple(range(ndim)))
            fj_new = a * fi + b * fup + cc * f_post[j]
            if moving:
                tw = q[lat.Q + j].astype(dt)
                fj_new = fj_new + jnp.where(ltm, 6.0 * tw,
                                            (6.0 * inv2q) * tw)
            flux = jnp.where(has, fi + fj_new, 0.0)
            s = jnp.sum(flux)
            for d in range(lat.D):
                cid = int(lat.c[i, d])
                if cid:
                    comps[d] = comps[d] + cid * s
        return jnp.stack(comps)

    return fn


def forces_fn(problem: Problem):
    """Jittable f -> force vector: collide then momentum-exchange, matching
    the reference's call point (post-collision, pre-streaming). The bouzidi
    obstacle mode swaps in the cut-link form (bouzidi_momentum_exchange_fn)
    so the reported drag sees the wall where the flow does; its returned fn
    then takes (f, q) — callers thread the same sharded q table the chunk
    steppers use."""
    from .step_jax import _collide_block
    solid_np = problem.solid
    bz_fn = (bouzidi_momentum_exchange_fn(problem)
             if problem.obstacle_bc == "bouzidi" else None)

    def fn(f, q=None):
        solid = jnp.asarray(solid_np)
        f_post = _collide_block(
            problem, f, solid if problem.obstacle_bc == "bounce_back" else None)
        if bz_fn is not None:
            if q is None:
                raise TypeError("bouzidi forces need the q table: fn(f, q)")
            return bz_fn(f_post, q)
        return momentum_exchange(problem, f_post, solid)

    return fn
