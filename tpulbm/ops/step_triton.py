"""Fused D2Q9 step for NVIDIA GPUs: one Pallas kernel through Triton.

One launch per timestep reads every population once and writes it once.
Each program owns a 2-D tile of cells and runs, in registers:

    pull-stream -> boundary conditions -> collision

so the state carried between steps is the POST-collision population g. A
chunk of n reference steps (collide -> stream -> BCs, ops/step_jax.py) is
regrouped as

    collide, (stream -> BCs -> collide) x (n-1), stream -> BCs

which runs the same operations per cell in the same order; the first
collide is plain XLA and the last launch skips its collision.

Layout: g lives in a halo-padded block (Q, ny+2, nx+2). Its 1-wide ring
holds what a pull from outside the block must read: the neighbour shard's
edge (or the periodic wrap), refreshed between launches by
parallel/halo.refresh_ring_2d, and at physical domain edges the
reference's ghost values (ops/step_jax.make_step_rolled): zero in the
x-edge columns, the frozen inlet equilibrium in the y-edge rows and
corners. Every load window therefore lies inside the padded array. Tiles
are powers of two; when the block is not a multiple of the tile, the last
tile along an axis is moved back to end at the block edge and recomputes
a few cells with identical results.

`covers` is the list of what the kernel implements; everything else runs
the XLA tier (parallel/sharded_step.choose_tier).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..models.base import Problem
from . import boundaries

# (rows, columns) of one program's tile, and its launch shape.
TILE = (1, 1024)
NUM_WARPS = 4
NUM_STAGES = 1


def covers(problem: Problem) -> bool:
    """True when the kernel implements this problem: D2Q9 f32 BGK (optional
    constant body force), Zou-He inlet/outlet, y walls, the equilibrium and
    bounce_back obstacle modes, periodic x and/or y."""
    return (problem.lattice.D == 2
            and problem.dtype == np.float32
            and problem.thermal is None
            and not problem.shan_chen
            and problem.collision == "bgk"
            and not problem.smagorinsky
            and not problem.power_law
            and problem.force_fn is None
            and not (problem.solid is not None
                     and problem.obstacle_bc == "bouzidi")
            and not problem.walls_x
            and not problem.lid_u
            and not problem.clean_corners
            and not problem.inlet_equilibrium
            and not problem.outlet_zero_grad)


def collide_planes(problem: Problem, f: list) -> list:
    """BGK collision on a list of Q population planes; the same arithmetic
    as physics.collide, written per plane because a Triton tile cannot
    stack nine planes (its dimensions are powers of two)."""
    lat = problem.lattice
    c = lat.c
    inv_tau = 1.0 / problem.params.tau
    rho = f[0]
    for fi in f[1:]:
        rho = rho + fi
    u = []
    for d in range(lat.D):
        acc = None
        for i in range(lat.Q):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = f[i] if cid > 0 else -f[i]
            acc = term if acc is None else acc + term
        u.append(acc / rho)
    base = 1.0 - 1.5 * (u[0] * u[0] + u[1] * u[1])
    src = np.zeros(lat.Q)
    if problem.body_force:
        src = 3.0 * lat.w * (c.astype(np.float64)
                             @ np.asarray(problem.body_force, np.float64))
    out = []
    for i in range(lat.Q):
        cu = None
        for d in range(lat.D):
            cid = int(c[i, d])
            if cid:
                term = u[d] if cid > 0 else -u[d]
                cu = term if cu is None else cu + term
        wr = float(lat.w[i]) * rho
        feq = wr * base if cu is None else wr * (base + 3.0 * cu
                                                 + 4.5 * cu * cu)
        post = f[i] - inv_tau * (f[i] - feq)
        if src[i]:
            post = post + float(src[i])
        out.append(post)
    return out


def _tile(n: int, t: int) -> int:
    """Largest power of two <= min(n, t)."""
    return 1 << (min(n, t).bit_length() - 1)


def make_local_step_triton(problem: Problem, local_shape: tuple[int, int],
                           collide: bool = True, interpret: bool = False):
    """Build step(offsets, gpad, solid, dst) for one (nyl, nxl) shard.

      offsets: int32 (2,) global (y, x) of the shard's first cell;
      gpad:    (Q, nyl+2, nxl+2) post-collision state with a valid ring;
      solid:   int8 (nyl, nxl) obstacle mask, or None without an obstacle;
      dst:     with collide=True, a padded buffer whose centre is
               overwritten and returned (ring untouched); ignored with
               collide=False, which returns the unpadded (Q, nyl, nxl)
               populations after stream and BCs (the chunk's last step).

    interpret=True runs the kernel in the Pallas interpreter (CPU tests).
    """
    if not covers(problem):
        raise ValueError("the Triton kernel does not cover this problem")
    lat = problem.lattice
    Q = lat.Q
    nyl, nxl = local_shape
    by, bx = _tile(nyl, TILE[0]), _tile(nxl, TILE[1])
    bounce = problem.obstacle_bc == "bounce_back"
    p = problem.params
    shifts = [(int(lat.c[i, 1]), int(lat.c[i, 0])) for i in range(Q)]

    def kernel(off_ref, g_ref, *refs):
        solid_ref = refs[0] if problem.solid is not None else None
        o_ref = refs[-1]
        y0 = jnp.minimum(pl.program_id(0) * by, nyl - by)
        x0 = jnp.minimum(pl.program_id(1) * bx, nxl - bx)
        # int32 plane indices: the tile starts are int32 under x64 too
        planes = [plt.load(g_ref.at[np.int32(i), pl.ds(y0 + 1 - cy, by),
                                    pl.ds(x0 + 1 - cx, bx)])
                  for i, (cy, cx) in enumerate(shifts)]
        solid = None
        if solid_ref is not None:
            solid = plt.load(solid_ref.at[pl.ds(y0, by), pl.ds(x0, bx)]) != 0
        coords = {
            "yy": off_ref[0] + y0 + lax.broadcasted_iota(jnp.int32,
                                                         (by, 1), 0),
            "xx": off_ref[1] + x0 + lax.broadcasted_iota(jnp.int32,
                                                         (1, bx), 1),
            "ny": p.ny, "nx": p.nx, "solid": solid}
        planes = boundaries.apply_all(problem, planes, coords)
        if collide:
            post = collide_planes(problem, planes)
            if bounce and solid is not None:
                post = [jnp.where(solid, f, g) for f, g in zip(planes, post)]
            planes, oy, ox = post, y0 + 1, x0 + 1
        else:
            oy, ox = y0, x0
        for i in range(Q):
            plt.store(o_ref.at[np.int32(i), pl.ds(oy, by), pl.ds(ox, bx)],
                      planes[i])

    pad_shape = (Q, nyl + 2, nxl + 2)
    out_shape = pad_shape if collide else (Q, nyl, nxl)
    n_in = 2 + (problem.solid is not None)
    call = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(nyl, by), pl.cdiv(nxl, bx)),
        out_shape=jax.ShapeDtypeStruct(out_shape, problem.dtype),
        input_output_aliases={n_in: 0} if collide else {},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="d2q9_stream_collide" if collide else "d2q9_stream",
    )

    def step(offsets, gpad, solid, dst=None):
        args = (offsets, gpad) + ((solid,) if problem.solid is not None
                                  else ())
        return call(*args, dst) if collide else call(*args)

    return step
