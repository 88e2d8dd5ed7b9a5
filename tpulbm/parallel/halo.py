"""Halo ("ghost ring") exchange over the device mesh.

The equivalent of the reference's MPI halo machinery (LBMGrid.h:249-283
pack/Isend/Irecv/Waitall/unpack): each step the 1-wide ring of a locally
padded block is refreshed with neighbor edge data moved by
`jax.lax.ppermute` — no pack/unpack buffers, no request handles.

Two-phase exchange (x first, then y including the just-filled x-ring
columns) fills corner ghosts with diagonal-neighbor data for free, fixing
the reference's never-filled corner ghosts (SURVEY §5 deviation #1). At
*physical* domain edges the ring holds the frozen equilibrium(1, u_init)
ghost values, matching the reference's never-updated boundary ghosts
(LBMGrid.h:185-213) — so single-device and multi-device runs agree exactly.

A design note on WHAT travels: the reference exchanges post-collision
populations. The XLA tier's ring holds *pre-collision* populations and each
shard re-collides its halo cells locally — collision is pointwise, so a
recompute of a 1-wide strip costs little (the payload is the same 1-wide
strip either way), and the exchange can happen at step start. The GPU
kernel tier (ops/step_triton.py) carries post-collision populations, so its
ring holds the neighbours' post-collision edges.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


def _perm_fwd(n: int, periodic: bool):
    """dest i receives from i-1 (shift toward +index)."""
    if periodic:
        return [(i, (i + 1) % n) for i in range(n)]
    return [(i, i + 1) for i in range(n - 1)]


def _perm_bwd(n: int, periodic: bool):
    if periodic:
        return [(i, (i - 1) % n) for i in range(n)]
    return [(i, i - 1) for i in range(1, n)]


def refresh_ring_2d(fpad: jnp.ndarray, *, eq_ring: np.ndarray,
                    mesh_shape: tuple[int, int], periodic_x: bool,
                    periodic_y: bool = False, periodic_z: bool = False,
                    x_ghost: np.ndarray | None = None,
                    axis_names: tuple[str, str] = ("y", "x")) -> jnp.ndarray:
    """Refresh the 1-wide ring of a local padded block (Q, nyl+2, nxl+2).

    Must run inside shard_map over a mesh with the given axis names.
    eq_ring is the (Q,) frozen ghost equilibrium used at physical edges;
    periodic_y wraps the y ring instead (fully periodic boxes). x_ghost,
    when given, replaces eq_ring in the physical x-edge columns (corners
    keep eq_ring).
    """
    my, mx = mesh_shape
    ay, ax = axis_names
    Q, nylp, nxlp = fpad.shape
    dtype = fpad.dtype
    eq = jnp.asarray(eq_ring, dtype)
    col = eq if x_ghost is None else jnp.asarray(x_ghost, dtype)
    edge_col = jnp.broadcast_to(col[:, None], (Q, nylp - 2))
    eq_row = jnp.broadcast_to(eq[:, None], (Q, nxlp))

    # --- phase X: fill west/east ring columns (rows 1..nyl only) ---
    left_edge = fpad[:, 1:-1, 1]
    right_edge = fpad[:, 1:-1, -2]
    if mx == 1:
        west = right_edge if periodic_x else edge_col
        east = left_edge if periodic_x else edge_col
    else:
        from_west = lax.ppermute(right_edge, ax, _perm_fwd(mx, periodic_x))
        from_east = lax.ppermute(left_edge, ax, _perm_bwd(mx, periodic_x))
        if periodic_x:
            west, east = from_west, from_east
        else:
            ix = lax.axis_index(ax)
            west = jnp.where(ix > 0, from_west, edge_col)
            east = jnp.where(ix < mx - 1, from_east, edge_col)
    fpad = fpad.at[:, 1:-1, 0].set(west)
    fpad = fpad.at[:, 1:-1, -1].set(east)

    # --- phase Y: full padded-width rows (including x-ring → corners) ---
    bottom_edge = fpad[:, 1, :]
    top_edge = fpad[:, -2, :]
    if my == 1:
        if periodic_y:
            south, north = top_edge, bottom_edge
        else:
            south = north = eq_row
    else:
        from_south = lax.ppermute(top_edge, ay, _perm_fwd(my, periodic_y))
        from_north = lax.ppermute(bottom_edge, ay, _perm_bwd(my, periodic_y))
        if periodic_y:
            south, north = from_south, from_north
        else:
            iy = lax.axis_index(ay)
            south = jnp.where(iy > 0, from_south, eq_row)
            north = jnp.where(iy < my - 1, from_north, eq_row)
    fpad = fpad.at[:, 0, :].set(south)
    fpad = fpad.at[:, -1, :].set(north)
    return fpad


def refresh_ring_3d(fpad: jnp.ndarray, *, eq_ring: np.ndarray,
                    mesh_shape: tuple[int, int], periodic_x: bool,
                    periodic_y: bool = False, periodic_z: bool = False,
                    axis_names: tuple[str, str] = ("y", "x")) -> jnp.ndarray:
    """3-D variant: (Q, nz+2, nyl+2, nxl+2); mesh shards (y, x); z is
    unsharded, its ring holds the frozen ghost equilibrium — or, under
    periodic_z, the wrapped opposite planes (copied AFTER the x/y phases,
    so they carry the just-refreshed x/y rings: diagonal wraps for free)."""
    my, mx = mesh_shape
    ay, ax = axis_names
    Q, nzp, nylp, nxlp = fpad.shape
    dtype = fpad.dtype
    eq = jnp.asarray(eq_ring, dtype)

    # phase X (slabs exclude z/y rings)
    left_edge = fpad[:, 1:-1, 1:-1, 1]
    right_edge = fpad[:, 1:-1, 1:-1, -2]
    eq_slab = jnp.broadcast_to(eq[:, None, None], left_edge.shape)
    if mx == 1:
        west = right_edge if periodic_x else eq_slab
        east = left_edge if periodic_x else eq_slab
    else:
        from_west = lax.ppermute(right_edge, ax, _perm_fwd(mx, periodic_x))
        from_east = lax.ppermute(left_edge, ax, _perm_bwd(mx, periodic_x))
        if periodic_x:
            west, east = from_west, from_east
        else:
            ix = lax.axis_index(ax)
            west = jnp.where(ix > 0, from_west, eq_slab)
            east = jnp.where(ix < mx - 1, from_east, eq_slab)
    fpad = fpad.at[:, 1:-1, 1:-1, 0].set(west)
    fpad = fpad.at[:, 1:-1, 1:-1, -1].set(east)

    # phase Y (rows include x-ring → x/y corner edges)
    bottom_edge = fpad[:, 1:-1, 1, :]
    top_edge = fpad[:, 1:-1, -2, :]
    eq_row = jnp.broadcast_to(eq[:, None, None], bottom_edge.shape)
    if my == 1:
        if periodic_y:
            south, north = top_edge, bottom_edge
        else:
            south = north = eq_row
    else:
        from_south = lax.ppermute(top_edge, ay, _perm_fwd(my, periodic_y))
        from_north = lax.ppermute(bottom_edge, ay, _perm_bwd(my, periodic_y))
        if periodic_y:
            south, north = from_south, from_north
        else:
            iy = lax.axis_index(ay)
            south = jnp.where(iy > 0, from_south, eq_row)
            north = jnp.where(iy < my - 1, from_north, eq_row)
    fpad = fpad.at[:, 1:-1, 0, :].set(south)
    fpad = fpad.at[:, 1:-1, -1, :].set(north)

    # phase Z: unsharded — frozen equilibrium ring (covers all corners),
    # or the wrapped opposite padded planes for fully periodic boxes
    if periodic_z:
        fpad = fpad.at[:, 0, :, :].set(fpad[:, -2, :, :])
        fpad = fpad.at[:, -1, :, :].set(fpad[:, 1, :, :])
        return fpad
    eq_plane = jnp.broadcast_to(eq[:, None, None], (Q, nylp, nxlp))
    fpad = fpad.at[:, 0, :, :].set(eq_plane)
    fpad = fpad.at[:, -1, :, :].set(eq_plane)
    return fpad


def refresh_ring(fpad, **kw):
    return (refresh_ring_3d if fpad.ndim == 4 else refresh_ring_2d)(fpad, **kw)


def make_padded(f_local: jnp.ndarray, eq_ring: np.ndarray) -> jnp.ndarray:
    """Allocate a padded local block with ring pre-filled with the frozen
    ghost equilibrium and center = f_local."""
    Q = f_local.shape[0]
    spatial = f_local.shape[1:]
    ndim = len(spatial)
    ring = jnp.asarray(eq_ring, f_local.dtype).reshape((Q,) + (1,) * ndim)
    fpad = jnp.broadcast_to(ring, (Q,) + tuple(n + 2 for n in spatial))
    center = (slice(None),) + (slice(1, -1),) * ndim
    return fpad.at[center].set(f_local)


def pad_mask(solid_local: jnp.ndarray, *, mesh_shape: tuple[int, int],
             periodic_x: bool,
             axis_names: tuple[str, str] = ("y", "x")) -> jnp.ndarray:
    """Pad a local solid mask with its neighbors' edge values (physical edges
    padded False/fluid). Needed by the bounce_back obstacle mode so that a
    shard skips collision on halo cells owned by a neighbor's solid region.
    Runs the same two-phase exchange on a single plane, via f32 (collectives
    on bool are unreliable)."""
    m = solid_local.astype(jnp.float32)[None]  # (1, *spatial)
    zero_ring = np.zeros(1, np.float32)
    mpad = make_padded(m, zero_ring)
    mpad = refresh_ring(mpad, eq_ring=zero_ring, mesh_shape=mesh_shape,
                        periodic_x=periodic_x, axis_names=axis_names)
    return mpad[0] > 0.5
