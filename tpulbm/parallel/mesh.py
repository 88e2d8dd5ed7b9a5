"""Device-mesh construction and decomposition choice.

The equivalent of the reference's MPI Cartesian topology
(LBMGrid.h:347-364) and processor-grid chooser (LBMGrid.h:366-392): an MPI
communicator becomes a `jax.sharding.Mesh` with named axes ('y', 'x');
neighbor ranks become `lax.ppermute` permutation lists (parallel/halo.py).

The chooser reuses the reference's scoring — surface/sqrt(volume) plus an
|log(local_aspect / global_aspect)| penalty over divisor pairs — but, unlike
the reference (which silently truncates the domain when no divisible
decomposition exists, LBMGrid.h:358-359 — SURVEY §5 deviation #5), we raise
a clear error instead.
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def choose_decomposition(n_devices: int, nx: int, ny: int) -> tuple[int, int]:
    """Pick (py, px) with py*px == n_devices minimizing the reference's score.

    Returns mesh shape in (y, x) order (array-axis order)."""
    aspect = nx / ny
    best, best_score = None, math.inf
    for px in range(1, n_devices + 1):
        if n_devices % px:
            continue
        py = n_devices // px
        if nx % px or ny % py:
            continue
        lnx, lny = nx // px, ny // py
        surface = 2.0 * (lnx + lny)
        volume = float(lnx * lny)
        score = surface / math.sqrt(volume) + abs(math.log((lnx / lny) / aspect))
        if score < best_score:
            best_score, best = score, (py, px)
    if best is None:
        raise ValueError(
            f"no decomposition of {n_devices} devices divides grid {nx}x{ny}; "
            f"choose nx, ny divisible by a factor pair of the device count")
    return best


def make_mesh(mesh_shape: tuple[int, int] | None = None,
              nx: int | None = None, ny: int | None = None,
              devices=None) -> Mesh:
    """Build a 2-D Mesh with axes ('y', 'x').

    mesh_shape=(my, mx) explicit, or None to auto-choose from the grid shape
    over all available devices (the `reorder=1` analog: we let jax order
    devices; locality comes from jax.make_mesh's device assignment).
    """
    devices = list(devices if devices is not None else jax.devices())
    if mesh_shape is None:
        if nx is None or ny is None:
            raise ValueError("need nx, ny for automatic decomposition")
        mesh_shape = choose_decomposition(len(devices), nx, ny)
    my, mx = mesh_shape
    if my * mx != len(devices):
        raise ValueError(f"mesh {mesh_shape} needs {my*mx} devices, have {len(devices)}")
    try:
        return jax.make_mesh((my, mx), ("y", "x"), devices=devices)
    except TypeError:
        dev_array = np.asarray(devices).reshape(my, mx)
        return Mesh(dev_array, ("y", "x"))


def field_sharding(mesh: Mesh, ndim_spatial: int = 2,
                   leading: int = 1) -> NamedSharding:
    """Sharding for (…leading, [z,] y, x) arrays: y/x sharded, rest replicated.

    3-D fields shard over (y, x) with z unsharded (v1; z-sharding is a
    straightforward extension of the two-phase halo exchange)."""
    spec = (None,) * leading + (None,) * (ndim_spatial - 2) + ("y", "x")
    return NamedSharding(mesh, P(*spec))


def local_block_shape(mesh: Mesh, spatial_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Per-device block of a (…, ny, nx) spatial shape."""
    my, mx = mesh.devices.shape
    *rest, ny, nx = spatial_shape
    if ny % my or nx % mx:
        raise ValueError(f"grid {spatial_shape} not divisible by mesh {(my, mx)}")
    return (*rest, ny // my, nx // mx)
