"""Pure-JAX timestep implementations.

Two tiers (SURVEY §7 build plan):

  * `make_step_rolled`  — the readable oracle. Unpadded state (Q, *spatial);
    streaming = per-population `jnp.roll` (pull scheme) followed by explicit
    "ghost sanitize" at non-periodic edges. This is the ground truth every
    other tier (padded JAX, the GPU kernel, sharded) is tested against.

  * `make_local_step_padded` — the production building block. Operates on a
    halo-padded local block (Q, ny+2, nx+2): pointwise BGK collision on the
    whole block (halo included — collision is pointwise, so neighbors' post-
    collision edge values never need to travel), then pull-streaming as nine
    static shifted slices (no roll, no gather — pure XLA slices), then masked
    BCs on the center. Used directly under `shard_map` (parallel/) as the
    XLA tier; the fused GPU kernel (ops/step_triton.py) runs the same
    per-cell operations.

Step order parity with the reference loop (LBMSolver.h:48-76):
collision → [halo exchange] → streaming → boundary conditions.

Ghost semantics parity: out-of-domain pulls yield the frozen
equilibrium(rho=1, u=init_u) that the reference's never-updated physical-edge
ghost cells hold (LBMGrid.h:185-213) — see Problem.ghost_ring_values().
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import physics
from ..models.base import Problem
from . import boundaries


def _collide_block(problem: Problem, f: jnp.ndarray,
                   solid: jnp.ndarray | None) -> jnp.ndarray:
    """Post-collision populations, with obstacle handling.

    obstacle_bc="equilibrium": no special-casing needed — solid cells hold
    rest equilibrium (an exact BGK fixed point), so collide() maps them to
    themselves; the invariant is re-asserted by apply_obstacle each step.
    obstacle_bc="bounce_back": collision skips solids (parity with
    LBMSolver.h:91); their stored reversed populations stream out unchanged.
    """
    inv_tau = 1.0 / problem.params.tau
    if problem.collision == "trt":
        f_post = physics.collide_trt(problem.lattice, f, inv_tau,
                                     problem.body_force, problem.trt_magic)
    elif problem.collision == "mrt":
        f_post = physics.collide_mrt(problem.lattice, f, inv_tau,
                                     problem.body_force,
                                     overrides=dict(problem.mrt_rates) or None)
    elif problem.collision == "regularized":
        f_post = physics.collide_regularized(problem.lattice, f, inv_tau,
                                             problem.body_force)
    elif problem.collision == "kbc":
        f_post = physics.collide_kbc(problem.lattice, f, inv_tau,
                                     problem.body_force)
    elif problem.power_law:
        f_post = physics.collide_power_law(problem.lattice, f,
                                           problem.power_law[0],
                                           problem.power_law[1],
                                           problem.body_force)
    elif problem.smagorinsky:
        f_post = physics.collide_smagorinsky(problem.lattice, f, inv_tau,
                                             problem.smagorinsky,
                                             problem.body_force)
    else:
        f_post = physics.collide(problem.lattice, f, inv_tau, problem.body_force)
    if solid is not None and problem.obstacle_bc == "bounce_back":
        f_post = jnp.where(solid[None], f, f_post)
    return f_post


def _add_force_field(problem: Problem, f_post: jnp.ndarray,
                     coords: dict) -> jnp.ndarray:
    """Add the spatially-varying Guo-lite source S_i(x) = 3 w_i (c_i·F(x))
    post-relaxation (same scheme as the constant-force path in
    physics.collide — injects exactly momentum F(x) per step at every
    cell). F comes from problem.force_fn evaluated at the block's GLOBAL
    coordinates, so sharded halo cells compute the same values their
    owners do and no force data ever travels. New capability — the
    reference's (dead-code) forcing is a uniform constant, LBMUtils.h:15-19.
    """
    if problem.force_fn is None:
        return f_post
    lat = problem.lattice
    shape = f_post.shape[1:]
    dt = f_post.dtype
    comps = problem.force_fn(coords)
    F = jnp.stack([jnp.broadcast_to(jnp.asarray(c_, dt), shape)
                   for c_ in comps])                       # (D, *block)
    # precision=HIGHEST: a default-precision contraction may run in TF32
    cu = jnp.tensordot(jnp.asarray(lat.c, dt), F, axes=(1, 0),
                       precision=jax.lax.Precision.HIGHEST)  # (Q, *block)
    w = jnp.asarray(3.0 * lat.w, dt).reshape((lat.Q,) + (1,) * len(shape))
    return f_post + w * cu


def _coords(problem: Problem, offsets=None, shape=None):
    """Global-coordinate arrays (broadcastable against a spatial block) and
    extents, for BC masks. `shape` is the local block shape (defaults to the
    global spatial shape); `offsets` are (traced or static) global offsets of
    the local block per spatial axis; None means offset 0 (unsharded)."""
    p = problem.params
    shape = shape or problem.spatial_shape
    ndim = len(shape)
    if offsets is None:
        offsets = (0,) * ndim
    axes = {}
    names = ("zz", "yy", "xx")[-ndim:]
    for d, (name, n_loc) in enumerate(zip(names, shape)):
        idx = jnp.arange(n_loc) + offsets[d]
        bshape = [1] * ndim
        bshape[d] = n_loc
        axes[name] = idx.reshape(bshape)
    axes["ny"], axes["nx"] = p.ny, p.nx
    if p.is_3d:
        axes["nz"] = p.nz
    return axes


def make_step_rolled(problem: Problem) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Oracle step on unpadded global state (Q, *spatial)."""
    lat = problem.lattice
    c = lat.c  # (Q, D), components ordered (x, y[, z])
    ndim = len(problem.spatial_shape)
    eq_ring = problem.ghost_ring_values()
    solid_np = problem.solid
    p = problem.params
    bz_q = None
    if problem.obstacle_bc == "bouzidi" and solid_np is not None:
        from .bouzidi import link_tables
        bz_q = link_tables(problem)

    def step(f: jnp.ndarray) -> jnp.ndarray:
        solid = None if solid_np is None else jnp.asarray(solid_np)
        f_post = _collide_block(problem, f, solid)
        coords = _coords(problem)
        f_post = _add_force_field(problem, f_post, coords)
        coords["solid"] = solid
        if bz_q is not None:
            coords["f_post"] = [f_post[i] for i in range(lat.Q)]
            coords["bz_q"] = jnp.asarray(bz_q)
        planes = []
        for i in range(lat.Q):
            cix, ciy = int(c[i, 0]), int(c[i, 1])
            ciz = int(c[i, 2]) if lat.D == 3 else 0
            # Pull: f_new(x) = f_post(x - c_i) → roll by +c_i per axis.
            shifts = (ciz, ciy, cix)[-ndim:]
            axes = tuple(range(ndim))
            plane = jnp.roll(f_post[i], shifts, axes)
            # Ghost sanitize — pulls that crossed a non-periodic global edge
            # read the reference's ghost values, which are NOT uniform
            # (verified against the compiled reference, validation/):
            #   * x-edge ghost columns are ZERO: unpack_ghost_cells copies
            #     the east/west recv buffers unconditionally even with no
            #     neighbor (LBMGrid.h:448-466), and an Irecv from
            #     MPI_PROC_NULL never writes, so the zero-initialized
            #     vectors wipe those ghosts every step;
            #   * y-edge ghost rows keep the frozen initial equilibrium
            #     (their unpack is neighbor-guarded, LBMGrid.h:469-490);
            #   * corner ghosts keep the frozen initial equilibrium
            #     (no unpack loop ever touches them).
            x_out = None
            if not problem.periodic_x:
                if cix > 0:
                    x_out = coords["xx"] == 0
                elif cix < 0:
                    x_out = coords["xx"] == p.nx - 1
            y_out = None
            if not problem.periodic_y:
                if ciy > 0:
                    y_out = coords["yy"] == 0
                elif ciy < 0:
                    y_out = coords["yy"] == p.ny - 1
            if lat.D == 3 and not problem.periodic_z:
                if ciz > 0:
                    y_out = (coords["zz"] == 0) if y_out is None \
                        else y_out | (coords["zz"] == 0)
                elif ciz < 0:
                    y_out = (coords["zz"] == p.nz - 1) if y_out is None \
                        else y_out | (coords["zz"] == p.nz - 1)
            eq_i = jnp.asarray(eq_ring[i], plane.dtype)
            if x_out is not None:
                only_x = x_out if y_out is None else (x_out & ~y_out)
                plane = jnp.where(only_x, jnp.asarray(0.0, plane.dtype), plane)
            if y_out is not None:
                plane = jnp.where(y_out, eq_i, plane)
            planes.append(plane)
        planes = boundaries.apply_all(problem, planes, coords)
        return jnp.stack(planes)

    return step


def make_local_step_padded(problem: Problem,
                           local_shape: tuple[int, ...] | None = None):
    """Step on a halo-padded local block.

    Returns step(fpad, solid_local, offsets) -> fpad_new where
      fpad:        (Q, *[n+2 per spatial axis]) — ring must hold valid halo
                   values (neighbor edges / frozen ghost eq / periodic wrap);
      solid_local: local unpadded bool mask or None;
      offsets:     global offsets of the local block per spatial axis
                   (traced values under shard_map; 0s when unsharded).

    The returned fpad_new has a correct center; its ring is a copy of the
    input ring (the caller refreshes it before the next step).
    """
    lat = problem.lattice
    c = lat.c
    shape = local_shape or problem.spatial_shape
    ndim = len(shape)

    eq_ring = problem.ghost_ring_values()
    p = problem.params

    def _overwrite_physical_ghosts(f_post, offsets):
        """Reference ghost semantics at physical domain edges (see the
        sanitize note in make_step_rolled): x-edge ghost columns are ZERO
        (LBMGrid.h:448-466 unconditional unpack of never-received buffers),
        y-edge ghost rows and corner ghosts hold the frozen initial
        equilibrium. Interior (shard-boundary) ring cells keep the real
        neighbor data already in fpad."""
        if ndim != 2:
            return f_post  # 3-D models overwrite all x-edge pops via BCs
        if problem.periodic_y:
            # fully periodic box: the ring holds real wrapped neighbor
            # data (halo.refresh_ring periodic_y) — nothing to overwrite
            return f_post
        nyl, nxl = shape
        Q = lat.Q
        dt = f_post.dtype
        y0, x0 = offsets
        is_bottom, is_top = y0 == 0, y0 + nyl == p.ny
        is_left, is_right = x0 == 0, x0 + nxl == p.nx
        eq = jnp.asarray(eq_ring, dt)                       # (Q,)
        eq_rows = jnp.broadcast_to(eq[:, None], (Q, nxl + 2))
        f_post = f_post.at[:, 0, :].set(
            jnp.where(is_bottom, eq_rows, f_post[:, 0, :]))
        f_post = f_post.at[:, -1, :].set(
            jnp.where(is_top, eq_rows, f_post[:, -1, :]))
        if not problem.periodic_x:
            cb = jnp.where(is_bottom, eq, jnp.zeros((Q,), dt))
            ct = jnp.where(is_top, eq, jnp.zeros((Q,), dt))
            cols = jnp.zeros((Q, nyl + 2), dt)
            cols = cols.at[:, 0].set(cb).at[:, -1].set(ct)
            f_post = f_post.at[:, :, 0].set(
                jnp.where(is_left, cols, f_post[:, :, 0]))
            f_post = f_post.at[:, :, -1].set(
                jnp.where(is_right, cols, f_post[:, :, -1]))
        return f_post

    def step(fpad, solid_local, offsets, solid_pad=None, bz_q=None):
        # Collide the whole padded block (pointwise; halo cells produce the
        # same post-collision values their owner computes).
        if problem.obstacle_bc == "bounce_back" and solid_local is not None:
            f_post = _collide_block(problem, fpad, solid_pad)
        else:
            f_post = _collide_block(problem, fpad, None)
        if problem.force_fn is not None:
            # source on the whole padded block at its global coordinates
            # (halo cells: offset−1 … n, periodic force_fn wraps them)
            f_post = _add_force_field(
                problem, f_post,
                _coords(problem, tuple(o - 1 for o in offsets),
                        tuple(n + 2 for n in shape)))
        f_post = _overwrite_physical_ghosts(f_post, offsets[-2:])
        center = (slice(1, -1),) * ndim
        planes = []
        for i in range(lat.Q):
            comps = tuple(int(c[i, d]) for d in range(lat.D))  # (cx, cy[, cz])
            per_axis = comps[::-1]  # shift per array axis in ([z,] y, x) order
            slicer = tuple(slice(1 - s, 1 - s + n) for s, n in zip(per_axis, shape))
            planes.append(f_post[(i,) + slicer])
        coords = _coords(problem, offsets, shape)
        coords["solid"] = solid_local
        if bz_q is not None:
            # bouzidi curved-wall mode: the pre-stream post-collision center
            # planes + the local q table (ops/bouzidi.py)
            coords["f_post"] = [f_post[(i,) + center] for i in range(lat.Q)]
            coords["bz_q"] = bz_q
        planes = boundaries.apply_all(problem, planes, coords)
        center = jnp.stack(planes)
        pad_slicer = (slice(None),) + (slice(1, -1),) * ndim
        return fpad.at[pad_slicer].set(center)

    return step
