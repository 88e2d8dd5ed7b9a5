"""The distributed chunked time-stepper: shard_map + lax.scan.

The equivalent of the reference's Solver::run hot loop (LBMSolver.h:43-78):
the per-step sequence collision → halo exchange → streaming → BCs runs
entirely on-device for `chunk_len` steps under one `lax.scan` inside one
`shard_map` region; host interaction (forces, VTK, stability abort) happens
only at chunk boundaries (runner.py), replacing the reference's every-step
MPI_Allreduce sync (LBMSolver.h:60; SURVEY §6: its scalability ceiling).

Layout: global state f is (Q, [z,] ny, nx) sharded over a ('y','x') device
mesh; inside the region each shard steps a halo-padded local block, with the
ring refreshed by two-phase ppermute (parallel/halo.py).

Two step tiers, chosen by `choose_tier` from the platform and the problem:
  * "triton": the fused GPU kernel (ops/step_triton.py) for the problems
    it covers, on a GPU;
  * "xla": plain JAX (ops/step_jax.py, step_thermal.py,
    step_multiphase.py) everywhere else.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.base import Problem
from ..ops import step_triton
from ..ops.step_jax import _collide_block, make_local_step_padded
from . import halo
from .mesh import local_block_shape


def choose_tier(problem: Problem, platform: str) -> str:
    """The step tier for `problem` on `platform` (jax.default_backend()):
    "triton" on a GPU when the fused kernel covers the problem, else
    "xla"."""
    if platform == "gpu" and step_triton.covers(problem):
        return "triton"
    return "xla"


def make_chunk_fn(problem: Problem, mesh: Mesh, chunk_len: int,
                  _raw: bool = False, tier: str | None = None,
                  interpret: bool = False):
    """Build a jitted fn(f, solid) -> f advanced by chunk_len steps.

    f: global (Q, *spatial) array (sharded or to-be-sharded); donated.
    solid: global bool mask (or None-placeholder of zeros when no obstacle).
    _raw: return the un-jitted shard_map callable (for composition inside a
    larger jit, e.g. make_super_chunk_fn).
    tier: None lets choose_tier pick from the platform; "xla" or "triton"
    forces one (kernel-vs-XLA comparisons, tests). A forced "triton" on a
    problem the kernel does not cover raises ValueError.
    interpret: run the Triton kernel in the Pallas interpreter (CPU tests).

    The returned callable's `tier` attribute names the tier it runs.
    """
    spatial = problem.spatial_shape
    ndim = len(spatial)
    local_shape = local_block_shape(mesh, spatial)
    mesh_shape = tuple(mesh.devices.shape)
    eq_ring = problem.ghost_ring_values()
    has_solid = problem.solid is not None
    tier = tier or choose_tier(problem, jax.default_backend())
    if tier not in ("xla", "triton"):
        raise ValueError(f"unknown step tier {tier!r}")

    bz_q = None
    if problem.obstacle_bc == "bouzidi" and has_solid:
        from ..ops.bouzidi import link_tables
        bz_q = link_tables(problem)
    local_step = mp_steps = None
    if tier == "triton":
        kernel_step = step_triton.make_local_step_triton(
            problem, local_shape, interpret=interpret)
        kernel_last = step_triton.make_local_step_triton(
            problem, local_shape, collide=False, interpret=interpret)
    elif problem.thermal is not None:
        from ..ops.step_thermal import make_local_step_padded_thermal
        local_step = make_local_step_padded_thermal(problem, local_shape)
    elif problem.shan_chen:
        from ..ops.step_multiphase import make_local_steps_multiphase
        mp_steps = make_local_steps_multiphase(problem, local_shape)
    else:
        local_step = make_local_step_padded(problem, local_shape)

    ring_kw = dict(eq_ring=eq_ring, mesh_shape=mesh_shape,
                   periodic_x=problem.periodic_x,
                   periodic_y=problem.periodic_y,
                   periodic_z=problem.periodic_z)

    def body_xla(f_local, solid_local, bz_local=None):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        offsets = (0,) * (ndim - 2) + (iy * local_shape[-2], ix * local_shape[-1])
        solid_arg = solid_local if has_solid else None
        solid_pad = None
        if has_solid and problem.obstacle_bc == "bounce_back":
            # built once per chunk (outside the scan), not once per step
            solid_pad = halo.pad_mask(solid_local, mesh_shape=mesh_shape,
                                      periodic_x=problem.periodic_x)
        fpad = halo.make_padded(f_local, eq_ring)

        if mp_steps is not None:
            collide_mp, stream_mp = mp_steps

            def one_step(fp, _):
                # double exchange: collide needs neighbor psi (pre-
                # collision f), streaming needs the neighbors' POST-
                # collision edges — see ops/step_multiphase.py
                fp = halo.refresh_ring(fp, **ring_kw)
                fp = collide_mp(fp, offsets)
                fp = halo.refresh_ring(fp, **ring_kw)
                fp = stream_mp(fp, offsets)
                return fp, None
        else:
            def one_step(fp, _):
                fp = halo.refresh_ring(fp, **ring_kw)
                if bz_local is None:
                    fp = local_step(fp, solid_arg, offsets, solid_pad)
                else:
                    fp = local_step(fp, solid_arg, offsets, solid_pad,
                                    bz_local)
                return fp, None

        fpad, _ = lax.scan(one_step, fpad, None, length=chunk_len)
        center = (slice(None),) + (slice(1, -1),) * ndim
        return fpad[center]

    def body_triton(f_local, solid_local):
        # The kernel carries post-collision populations (ops/step_triton):
        # collide once here, then chunk_len - 1 fused launches, then one
        # stream + BC launch that writes the unpadded result.
        nyl, nxl = local_shape
        offsets = jnp.stack([lax.axis_index("y") * nyl,
                             lax.axis_index("x") * nxl]).astype(jnp.int32)
        mask = solid_local.astype(jnp.int8) if has_solid else None
        bounce = has_solid and problem.obstacle_bc == "bounce_back"
        g = _collide_block(problem, f_local, solid_local if bounce else None)

        # the reference's physical x-edge ghost columns hold zero
        # (ops/step_jax.make_step_rolled); rows and corners hold eq_ring
        x_ghost = np.zeros(problem.lattice.Q, problem.dtype)

        def refresh(gp):
            return halo.refresh_ring_2d(gp, x_ghost=x_ghost, **ring_kw)

        gpad = refresh(halo.make_padded(g, eq_ring))

        # Two launches per scan iteration, so each buffer keeps its carry
        # slot: swapping the slots every step makes XLA copy both buffers.
        def two_steps(carry, _):
            a, b = carry
            b = refresh(kernel_step(offsets, a, mask, b))
            a = refresh(kernel_step(offsets, b, mask, a))
            return (a, b), None

        n = chunk_len - 1
        (gpad, spare), _ = lax.scan(two_steps, (gpad, gpad), None,
                                    length=n // 2)
        if n % 2:
            gpad = refresh(kernel_step(offsets, gpad, mask, spare))
        return kernel_last(offsets, gpad, mask)

    body = body_triton if tier == "triton" else body_xla
    spec_f = P(*((None,) + (None,) * (ndim - 2) + ("y", "x")))
    spec_m = P(*((None,) * (ndim - 2) + ("y", "x")))
    # check_vma=False: pallas_call out_shapes don't carry vma annotations
    if bz_q is None:
        sharded = shard_map(body, mesh=mesh, in_specs=(spec_f, spec_m),
                            out_specs=spec_f, check_vma=False)
        sharded.tier = tier
        if _raw:
            return sharded
        jitted = jax.jit(sharded, donate_argnums=(0,))

        def chunk_nb(f, solid):
            return jitted(f, solid)

        chunk_nb.tier = tier
        return chunk_nb
    # bouzidi: the q table rides as a third REAL argument sharded like f
    # (passing it by closure would bake a grid-sized constant into the
    # program); raw callers read .bouzidi_q and thread it themselves
    # (make_super_chunk_fn), the jitted wrapper binds it here
    sharded = shard_map(body, mesh=mesh, in_specs=(spec_f, spec_m, spec_f),
                        out_specs=spec_f, check_vma=False)
    q_dev = jax.device_put(bz_q, NamedSharding(mesh, spec_f))
    sharded.bouzidi_q = q_dev
    sharded.tier = tier
    if _raw:
        return sharded
    jitted = jax.jit(sharded, donate_argnums=(0,))

    def chunk(f, solid):
        return jitted(f, solid, q_dev)

    chunk.bouzidi_q = q_dev
    chunk.tier = tier
    return chunk


def make_super_chunk_fn(problem: Problem, mesh: Mesh, interval_len: int,
                        n_intervals: int, with_fields: bool = False,
                        with_stats: bool = False):
    """fn(f, solid) -> (f', diags): advances n_intervals × interval_len steps
    with ONE host round trip, recording per-interval diagnostics on device.

    diags = (forces (n_intervals, D), max_vel (n_intervals,), stable
    (n_intervals,)), each evaluated at the interval-start states — the
    reference's output cadence (LBMSolver.h:52-67) — so a long run needs
    ~n_intervals× fewer host↔device synchronizations.

    with_fields=True appends per-interval macroscopic fields
    (rho (n_intervals, *spatial), u (n_intervals, D, *spatial)) to diags:
    VTK frames then cost ONE batched gather per n_intervals frames instead
    of a per-frame device stall — the fully-async answer to the reference's
    serialized gather+write on the critical path (LBMSolver.h:269-362).
    """
    from ..ops import diagnostics, forces as forces_mod

    chunk = make_chunk_fn(problem, mesh, interval_len, _raw=True)
    has_solid = problem.solid is not None
    forces_fn = forces_mod.forces_fn(problem) if has_solid else None
    maxv_fn = diagnostics.max_velocity_fn(problem)
    stable_fn = diagnostics.stability_fn(problem)
    fields_fn = diagnostics.fields_fn(problem) if with_fields else None
    nu_fn = temp_fn = None
    if problem.thermal is not None:
        from ..ops.step_thermal import nusselt, temperature
        nu_fn = lambda s: nusselt(problem, s)  # noqa: E731
        temp_fn = lambda s: temperature(problem, s)  # noqa: E731
    pr_fn = (diagnostics.probes_fn(problem)
             if getattr(problem.params, "probe_points", ()) else None)

    q_dev = getattr(chunk, "bouzidi_q", None)

    if not with_stats:
        def fn(f, solid, qv=None):
            def interval(fc, _):
                if forces_fn is None:
                    force = jnp.zeros(2)
                elif qv is not None:
                    force = forces_fn(fc, qv)   # bouzidi cut-link form
                else:
                    force = forces_fn(fc)
                diag = (force, maxv_fn(fc), stable_fn(fc))
                if nu_fn is not None:  # thermal: per-interval Nusselt trace
                    diag = diag + (nu_fn(fc),)
                if pr_fn is not None:  # point probes ride the same trip
                    diag = diag + (pr_fn(fc),)
                if fields_fn is not None:
                    diag = diag + tuple(fields_fn(fc))
                    if temp_fn is not None:  # thermal VTK frames carry T
                        diag = diag + (temp_fn(fc),)
                fnext = chunk(fc, solid) if qv is None else chunk(fc, solid, qv)
                return fnext, diag

            return lax.scan(interval, f, None, length=n_intervals)

        jitted = jax.jit(fn, donate_argnums=(0,))
        if q_dev is None:
            return jitted
        return lambda f, solid: jitted(f, solid, q_dev)

    # Reynolds-statistics variant: fn(f, stats, n_skip, solid) ->
    # ((f', stats'), diags). stats = (count, sum_rho, sum_u, sum_uu)
    # accumulates one sample per interval-start state (the same states the
    # diagnostics see), skipping the first n_skip intervals of this window
    # (a TRACED scalar — the runner uses it to honor stats_from without a
    # recompile per window). The sums live sharded on device across super-
    # chunk calls; the host only ever sees the finalized means.
    stats_fn = diagnostics.stats_sample_fn(problem)

    def fn_stats(f, stats, n_skip, solid, qv=None):
        def interval(carry, k):
            fc, (cnt, s_rho, s_u, s_uu) = carry
            if forces_fn is None:
                force = jnp.zeros(2)
            elif qv is not None:
                force = forces_fn(fc, qv)   # bouzidi cut-link form
            else:
                force = forces_fn(fc)
            diag = (force, maxv_fn(fc), stable_fn(fc))
            if nu_fn is not None:
                diag = diag + (nu_fn(fc),)
            if pr_fn is not None:
                diag = diag + (pr_fn(fc),)
            if fields_fn is not None:
                diag = diag + tuple(fields_fn(fc))
                if temp_fn is not None:
                    diag = diag + (temp_fn(fc),)
            rho, u, uu = stats_fn(fc)
            w = (k >= n_skip).astype(s_rho.dtype)
            st = (cnt + w, s_rho + w * rho, s_u + w * u, s_uu + w * uu)
            fnext = chunk(fc, solid) if qv is None else chunk(fc, solid, qv)
            return (fnext, st), diag

        return lax.scan(interval, (f, stats), jnp.arange(n_intervals))

    jitted = jax.jit(fn_stats, donate_argnums=(0, 1))
    if q_dev is None:
        return jitted
    return lambda f, stats, n_skip, solid: jitted(f, stats, n_skip, solid,
                                                  q_dev)


def shard_mask(mesh: Mesh, mask):
    """Place a (…, ny, nx) mask/field with the canonical ('y','x') sharding."""
    spec = P(*((None,) * (mask.ndim - 2) + ("y", "x")))
    return jax.device_put(mask, NamedSharding(mesh, spec))


def shard_state(mesh: Mesh, f, solid=None):
    """Place global arrays with the canonical ('y','x') sharding."""
    ndim = f.ndim - 1
    spec_f = P(*((None,) + (None,) * (ndim - 2) + ("y", "x")))
    f = jax.device_put(f, NamedSharding(mesh, spec_f))
    if solid is not None:
        solid = shard_mask(mesh, solid)
    return f, solid


def shard_initial_state(problem: Problem, mesh: Mesh):
    """Sharded (f, solid) with f BUILT ON DEVICE — numerically identical to
    shard_state(mesh, problem.initial_state(), problem.solid), but only the
    Q-free solid mask crosses host→device. The Q-sized f (1.3 GB at 256³)
    is a broadcast + select the device materializes directly into each
    shard, instead of a host-to-device copy of the whole state.
    """
    from .. import physics

    if (problem.thermal is not None or problem.init_rho_map is not None
            or problem.init_fields is not None):
        # thermal (conductive T profile + seed mode), multiphase
        # (droplet/band rho map) and analytic-field (Taylor-Green /
        # shear-layer init_fields) initial states are not uniform
        # broadcasts (models/base.initial_state) — build on host; those
        # grids are far below the sizes this fast path targets
        return shard_state(mesh, problem.initial_state(), problem.solid)

    ndim = len(problem.spatial_shape)
    spec_f = P(*((None,) + (None,) * (ndim - 2) + ("y", "x")))
    feq = problem.ghost_ring_values()                       # (Q,) host
    shape = (problem.lattice.Q,) + problem.spatial_shape
    bshape = (problem.lattice.Q,) + (1,) * ndim

    solid = None
    if problem.solid is not None:
        solid = shard_mask(mesh, problem.solid)
        rest = physics.rest_equilibrium(problem.lattice, problem.dtype)

        def build(s):
            f = jnp.broadcast_to(jnp.asarray(feq).reshape(bshape), shape)
            return jnp.where(s[None], jnp.asarray(rest).reshape(bshape), f)

        f = jax.jit(build, out_shardings=NamedSharding(mesh, spec_f))(solid)
    else:
        def build():
            return jnp.broadcast_to(jnp.asarray(feq).reshape(bshape), shape)

        f = jax.jit(build, out_shardings=NamedSharding(mesh, spec_f))()
    return f, solid
