"""Bouzidi interpolated (curved-wall) bounce-back.

Second-order-accurate no-slip at obstacle surfaces that cut lattice links
at fractional positions (Bouzidi, Firdaouss & Lallemand 2001, linear
variant) — an accuracy upgrade over the reference's staircase obstacle
treatment (LBMGrid.h:152-183 rasterizes the cylinder to whole cells;
LBMSolver.h:240-263 reflects on the voxel boundary). The voxel mask still
decides WHICH cells are solid; the per-link intersection fraction q moves
the effective wall from the voxel face to the true surface.

Formulation: with pull streaming, every term the closure needs
is already resident at the boundary cell itself after the stream —

  unknown direction j at fluid cell x_f (its pull source x_f − c_j is
  solid), i = opp(j) pointing into the wall, f̂ = post-collision values:

    q < 1/2:  f_j(x_f) ← 2q·f̂_i(x_f) + (1−2q)·f̂_i(x_f − c_i)
    q ≥ 1/2:  f_j(x_f) ← 1/(2q)·f̂_i(x_f) + (1 − 1/(2q))·f̂_j(x_f)

  and f̂_i(x_f − c_i) is exactly the post-STREAM value of plane i at x_f
  (pull: f_i(x) = f̂_i(x − c_i)). So the whole scheme is a per-plane
  SELECT against two resident arrays — no gathers, no index lists, fully
  vectorizable and shardable (the q table shards like f).

The q table is built once on the host from the problem's analytic signed
distance function (Problem.obstacle_sdf) by vectorized bisection along
each cut link; q = 1/2 (exact half-way bounce-back) is substituted where
the q<1/2 branch would need an upstream fluid node that does not exist
(thin gaps / domain edges — the standard fallback).

MOVING walls (Problem.obstacle_velocity — rotating cylinders, stirred
boxes): the standard momentum term rides each cut link, evaluated at the
actual intersection point x_f + q·c_i:

    q < 1/2:  += 6 w_j (c_j · u_w)
    q ≥ 1/2:  += (3/q) w_j (c_j · u_w)

(both reduce to the half-way moving-wall term 6 w_j c_j·u_w at q = 1/2).
The per-link scalar w_j (c_j · u_w) is precomputed into a second table
stacked under q — link_tables returns (2Q, *spatial) then — so the
runtime closure stays a pointwise select; the (3/q) factor is applied
in-step where q is at hand. Verified against the exact fractional-wall
Couette solution (tests/test_bouzidi.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice
from ..models.base import Problem

_BISECT_ITERS = 40      # |interval| = 2^-40 — exact to f32 for unit links
_Q_MIN = 1e-4           # clamp: a wall exactly through a fluid node


def _shift_bool(mask: np.ndarray, shift_xy: np.ndarray,
                periodic_x: bool) -> np.ndarray:
    """mask value at (cell − shift): np.roll by +shift per array axis
    ([z,]y,x order), with the wrapped band forced False on non-periodic
    axes (out-of-domain neighbors are never links)."""
    ndim = mask.ndim
    comps = [int(v) for v in shift_xy]            # (cx, cy[, cz])
    assert len(comps) == ndim
    per_axis = comps[::-1]                        # ([cz,] cy, cx)
    out = np.roll(mask, per_axis, axis=tuple(range(ndim)))
    for ax, s in enumerate(per_axis):
        if s == 0:
            continue
        is_x = ax == ndim - 1
        if is_x and periodic_x:
            continue
        sl = [slice(None)] * ndim
        sl[ax] = slice(0, s) if s > 0 else slice(mask.shape[ax] + s, None)
        out[tuple(sl)] = False
    return out


def link_q(problem: Problem) -> np.ndarray:
    """(Q, *spatial) f32 table of per-link wall-intersection fractions.

    q[j, cell] ∈ (0, 1] where cell is fluid and its pull source cell − c_j
    is solid (the wall cuts that link at fraction q measured FROM the
    fluid cell along opp(j)); −1 everywhere else. Fallback cells whose
    upstream node is unusable carry exactly 0.5.
    """
    lat = problem.lattice
    solid = problem.solid
    if solid is None:
        return np.full((lat.Q,) + tuple(problem.spatial_shape), -1.0,
                       np.float32)
    shape = solid.shape
    if len(shape) != lat.D:
        raise ValueError(f"solid mask rank {len(shape)} != lattice "
                         f"dimension {lat.D}")
    q = np.full((lat.Q,) + tuple(shape), -1.0, np.float32)
    sdf = problem.obstacle_sdf
    if sdf is None:
        raise ValueError(
            "obstacle_bc='bouzidi' needs Problem.obstacle_sdf (analytic "
            "surface geometry); this problem's obstacle has none")
    fluid = ~solid
    ndim = solid.ndim
    grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                        indexing="ij")            # ([z,]y,x) index grids
    for j in range(lat.Q):
        cj = lat.c[j]                              # (x, y[, z]) components
        if not cj.any():
            continue
        src_solid = _shift_bool(solid, cj, problem.periodic_x)
        mask = fluid & src_solid
        if not mask.any():
            continue
        cells = np.nonzero(mask)
        # physical coordinates in (x, y[, z]) order to match c / the sdf
        p0 = np.stack([grids[ndim - 1][cells], grids[ndim - 2][cells]]
                      + ([grids[0][cells]] if ndim == 3 else []), axis=-1)
        ci = -cj.astype(np.float64)                # i = opp(j), into the wall
        lo = np.zeros(len(p0[..., 0]))
        hi = np.ones_like(lo)
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            s = np.asarray(sdf(p0 + mid[:, None] * ci[None, :]),
                           np.float64)
            outside = s > 0.0
            lo = np.where(outside, mid, lo)
            hi = np.where(outside, hi, mid)
        qv = np.clip(0.5 * (lo + hi), _Q_MIN, 1.0)
        # the q<1/2 branch interpolates with f̂_i(x_f − c_i) = the post-
        # stream plane-i value at x_f, valid only if x_f + c_j is an
        # in-domain fluid node; otherwise use the half-way fallback
        up_fluid = _shift_bool(fluid, -cj, problem.periodic_x)
        qv = np.where((qv < 0.5) & ~up_fluid[cells], 0.5, qv)
        q[j][cells] = qv.astype(np.float32)
    return q


def link_tables(problem: Problem) -> np.ndarray:
    """The full per-link table the chunk steppers thread: the q table,
    with a second (Q, *spatial) block of moving-wall momentum scalars
    w_j·(c_j · u_w(x_wall)) stacked under it when the problem's obstacle
    moves (Problem.obstacle_velocity: pts (..., D) -> u (..., D) at the
    wall intersection points). Stationary obstacles get just q — the
    shapes tell apply_bouzidi which convention it received.

    Memoized on the Problem: the runner, the chunk builders and the
    super-chunk each need the table, and the bisection sweep over every
    cut link is worth doing once, not per consumer."""
    cached = getattr(problem, "_bouzidi_tables", None)
    if cached is not None:
        return cached
    q = _link_tables_uncached(problem)
    object.__setattr__(problem, "_bouzidi_tables", q)  # frozen dataclass
    return q


def _link_tables_uncached(problem: Problem) -> np.ndarray:
    q = link_q(problem)
    uw_fn = getattr(problem, "obstacle_velocity", None)
    if uw_fn is None:
        return q
    lat = problem.lattice
    shape = problem.solid.shape
    ndim = len(shape)
    tw = np.zeros_like(q)
    grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                        indexing="ij")
    for j in range(lat.Q):
        cells = np.nonzero(q[j] >= 0)
        if len(cells[0]) == 0:
            continue
        p0 = np.stack([grids[ndim - 1][cells], grids[ndim - 2][cells]]
                      + ([grids[0][cells]] if ndim == 3 else []), axis=-1)
        ci = -lat.c[j].astype(np.float64)          # into the wall
        xw = p0 + q[j][cells][:, None] * ci[None, :]
        uw = np.asarray(uw_fn(xw), np.float64)     # (n, D)
        cj = lat.c[j].astype(np.float64)
        tw[j][cells] = (float(lat.w[j]) * (uw @ cj)).astype(np.float32)
    return np.concatenate([q, tw], axis=0)


def active_directions(problem: Problem) -> tuple:
    """Static per-direction activity: does direction j have ANY cut link
    anywhere in the global domain? Derived from the memoized host table,
    so the fused step skips the full-grid selects of provably link-free
    directions (e.g. a plane-walled channel cuts only the 6 y-moving
    D2Q9 directions)."""
    tbl = link_tables(problem)
    Q = problem.lattice.Q
    return tuple(bool((tbl[j] >= 0).any()) for j in range(Q))


def apply_bouzidi(lat: Lattice, planes: list, f_post: list,
                  q: jnp.ndarray, active: tuple | None = None) -> None:
    """Overwrite every cut-link population in `planes` (post-stream) from
    the link table (see module docstring). `f_post` is the pre-stream
    post-collision plane list at the same cells; both lists are full
    (local) arrays — the update is a pointwise select. A (2Q, ...) table
    carries the moving-wall momentum scalars in its second block.
    `active` (active_directions) statically skips link-free directions —
    computed on the GLOBAL mask, so it is a safe superset for any shard."""
    opp = lat.opposite
    moving = q.shape[0] == 2 * lat.Q
    snap = list(planes)
    for j in range(lat.Q):
        if active is not None and not active[j]:
            continue                               # static: no cut links
        qj = q[j]
        if isinstance(qj, np.ndarray) and not (qj >= 0).any():
            continue
        i = int(opp[j])
        qv = jnp.asarray(qj, planes[j].dtype)
        lt = (qv >= 0.0) & (qv < 0.5)
        ge = qv >= 0.5
        val_lt = 2.0 * qv * f_post[i] + (1.0 - 2.0 * qv) * snap[i]
        inv2q = 1.0 / (2.0 * jnp.maximum(qv, 0.5))
        val_ge = inv2q * f_post[i] + (1.0 - inv2q) * f_post[j]
        if moving:
            tw = jnp.asarray(q[lat.Q + j], planes[j].dtype)
            val_lt = val_lt + 6.0 * tw
            val_ge = val_ge + (6.0 * inv2q) * tw   # = (3/q) w_j c_j·u_w
        planes[j] = jnp.where(lt, val_lt,
                              jnp.where(ge, val_ge, planes[j]))
