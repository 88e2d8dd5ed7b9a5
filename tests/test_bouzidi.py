"""Bouzidi interpolated (curved-wall) bounce-back gates (ops/bouzidi.py).

New capability — the reference voxelizes the cylinder and reflects on the
voxel boundary (LBMGrid.h:152-183, LBMSolver.h:240-263). Gates: the q
table is exact against the closed-form circle-line intersection; a
channel whose walls sit at FRACTIONAL positions between lattice rows
recovers those positions from the flow itself (the staircase scheme
cannot, by construction — it always sees the half-way wall); sharded ==
oracle on every mesh shape, with a moving wall too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.models.base import Problem
from tpulbm.ops.bouzidi import link_q
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _cyl_params(**kw):
    d = dict(nx=64, ny=32, precision="f64", obstacle_bc="bouzidi")
    d.update(kw)
    return SimulationParams(**d)


def test_link_q_matches_closed_form_circle():
    # bisection vs the exact quadratic |p0 + t c_i - center| = r
    params = _cyl_params(nx=128, ny=64)
    pr = make_problem(params)
    q = link_q(pr)
    lat = pr.lattice
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    r = float(params.get_cylinder_radius_cells())
    checked = 0
    for j in range(1, lat.Q):
        for (yy, xx) in np.argwhere(q[j] >= 0):
            ci = -lat.c[j].astype(np.float64)
            px, py = float(xx), float(yy)
            a = ci @ ci
            b = 2.0 * (ci[0] * (px - cx) + ci[1] * (py - cy))
            c0 = (px - cx) ** 2 + (py - cy) ** 2 - r * r
            t = (-b - np.sqrt(b * b - 4 * a * c0)) / (2 * a)
            got = float(q[j, yy, xx])
            if got == 0.5 and abs(t - 0.5) > 1e-6:
                continue  # upstream-solid fallback substitution
            assert abs(got - t) < 1e-6, (j, yy, xx, got, t)
            checked += 1
    assert checked > 30  # the perimeter produced real links
    # links exist exactly where the pull source is solid and the cell fluid
    fluid = ~pr.solid
    for j in range(1, lat.Q):
        cjx, cjy = int(lat.c[j, 0]), int(lat.c[j, 1])
        src_solid = np.roll(pr.solid, (cjy, cjx), (0, 1))
        np.testing.assert_array_equal(q[j] >= 0, fluid & src_solid)


def _channel_problem(qb, qt, bc, ny=24, nx=8, tau=0.8, F_body=2e-6):
    """Body-force channel with solid slabs whose true wall planes sit at
    y = 2-qb and y = ny-3+qt (between the last fluid and first solid
    rows)."""
    params = SimulationParams(nx=nx, ny=ny, tau=tau, problem="poiseuille",
                              periodic_x=True, body_force=(F_body, 0.0),
                              inlet_velocity=0.0, precision="f64",
                              obstacle_bc=bc)
    solid = np.zeros((ny, nx), bool)
    solid[:2] = True
    solid[-2:] = True
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt

    def sdf(p):
        return np.minimum(p[..., 1] - y0, y1 - p[..., 1])

    return Problem(params=params, lattice=D2Q9, solid=solid,
                   obstacle_sdf=sdf, init_u=(0.0, 0.0), walls_y=False,
                   periodic_x=True, body_force=(F_body, 0.0),
                   obstacle_bc=bc)


def _fractional_channel(qb, qt, bc, ny=24, nx=8, tau=0.8, F=2e-6,
                        steps=6000):
    """Run _channel_problem to steady state. Returns (relative RMSE vs the
    analytic parabola, recovered wall roots, true wall positions)."""
    pr = _channel_problem(qb, qt, bc, ny=ny, nx=nx, tau=tau, F_body=F)
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt
    step = jax.jit(make_step_rolled(pr))
    f = pr.initial_state()
    for _ in range(steps):
        f = step(f)
    rho, u = physics.moments(D2Q9, np.asarray(f))
    ux = np.asarray(u[0])[:, 0]
    nu = (tau - 0.5) / 3.0
    yy = np.arange(ny, dtype=np.float64)
    ana = np.where((yy > y0) & (yy < y1),
                   F / (2 * nu) * (yy - y0) * (y1 - yy), 0.0)
    fl = slice(2, ny - 2)
    rel_rmse = np.sqrt(np.mean((ux[fl] - ana[fl]) ** 2)) / ana.max()
    roots = np.sort(np.roots(np.polyfit(yy[4:-4], ux[4:-4], 2)))
    return rel_rmse, roots, (y0, y1)


@pytest.mark.slow
@pytest.mark.parametrize("qb,qt", [(0.25, 0.75), (0.9, 0.1)])
def test_fractional_wall_position_recovered(qb, qt):
    rel, roots, (y0, y1) = _fractional_channel(qb, qt, "bouzidi")
    assert rel < 0.01, rel
    assert abs(roots[0] - y0) < 0.05, (roots[0], y0)
    assert abs(roots[1] - y1) < 0.05, (roots[1], y1)


@pytest.mark.slow
def test_staircase_cannot_resolve_fractional_walls():
    # the full-way scheme sees the wall at the half-way plane regardless of
    # q — Bouzidi's whole point; measured: 14x the profile error
    rel_b, roots_b, (y0, y1) = _fractional_channel(0.25, 0.75, "bouzidi")
    rel_s, roots_s, _ = _fractional_channel(0.25, 0.75, "bounce_back")
    assert rel_s > 5 * rel_b, (rel_s, rel_b)
    assert abs(roots_s[0] - 1.5) < 0.1     # staircase pins at half-way
    assert abs(roots_b[0] - y0) < 0.05     # bouzidi tracks the true wall


def test_bouzidi_force_reduces_to_staircase_at_half():
    # with every q = 1/2 the cut-link momentum exchange must equal the
    # voxel form 2 c_i f̂_i exactly (f_j^new = f̂_i there)
    from tpulbm.ops import forces as F
    from tpulbm.ops.step_jax import _collide_block
    pr = _channel_problem(0.5, 0.5, "bouzidi")
    step = jax.jit(make_step_rolled(pr))
    f = pr.initial_state()
    for _ in range(200):
        f = step(f)
    fp = _collide_block(pr, f, None)
    fb = np.asarray(F.bouzidi_momentum_exchange_fn(pr)(fp, link_q(pr)))
    fv = np.asarray(F.momentum_exchange(pr, fp, np.asarray(pr.solid)))
    np.testing.assert_allclose(fb, fv, atol=1e-14)


@pytest.mark.slow
def test_bouzidi_force_balances_injected_momentum():
    # steady channel: the wall drag must equal the body-force momentum
    # injected per step (G per fluid cell at rho ~ 1) — measured 1 - 2e-9
    from tpulbm.ops import forces as F
    G = 2e-6
    pr = _channel_problem(0.25, 0.75, "bouzidi", F_body=G)
    step = jax.jit(make_step_rolled(pr))
    fn = jax.jit(F.forces_fn(pr))
    f = pr.initial_state()
    for _ in range(8000):
        f = step(f)
    drag = np.asarray(fn(f, link_q(pr)))
    injected = G * (~pr.solid).sum()
    assert abs(drag[0] / injected - 1.0) < 1e-6, (drag[0], injected)
    assert abs(drag[1]) < 1e-12


def test_bouzidi_force_zero_at_rest():
    from tpulbm.ops import forces as F
    from tpulbm.ops.step_jax import _collide_block
    pr = make_problem(_cyl_params())
    f0 = physics.uniform_equilibrium(D2Q9, 1.0, (0.0, 0.0),
                                     dtype=np.float64)
    f0 = np.broadcast_to(f0[:, None, None], (9,) + pr.spatial_shape)
    fp = _collide_block(pr, np.ascontiguousarray(f0), None)
    np.testing.assert_allclose(
        np.asarray(F.bouzidi_momentum_exchange_fn(pr)(fp, link_q(pr))),
        0.0, atol=1e-15)


@pytest.mark.parametrize("mesh_shape,omega", [((2, 1), 0.0), ((2, 2), 0.0),
                                              ((1, 2), 0.0), ((2, 2), 0.004)],
                         ids=["y", "2d", "x", "moving-wall-2d"])
def test_bouzidi_sharded_matches_oracle(mesh_shape, omega):
    pr = make_problem(_cyl_params(cylinder_omega=omega))
    step = jax.jit(make_step_rolled(pr))
    s_ref = pr.initial_state()
    for _ in range(10):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, 5)
    s, solid = shard_state(mesh, pr.initial_state(), pr.solid)
    for _ in range(2):
        s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)), s_ref,
                               rtol=1e-12, atol=1e-14)


def test_super_chunk_and_runner_smoke(tmp_path):
    # end-to-end: the runner's super-chunk path threads the q table
    from tpulbm.runner import Runner
    rp = _cyl_params(precision="f32").replace(
        num_timesteps=200, output_frequency=50, enable_vtk=False,
        output_dir=str(tmp_path))
    res = Runner(rp, verbose=False).run(resume=False)
    assert res.success
    assert (tmp_path / "forces.csv").exists()


def _couette(qb, qt, U=0.05, ny=20, nx=8, tau=0.8, steps=8000):
    """Moving-wall channel: bottom wall at rest at y = 2-qb, top wall
    translating with (U, 0) at y = ny-3+qt — both at FRACTIONAL lattice
    positions. The linear Couette profile is exactly representable, so
    the moving-wall Bouzidi closure must reproduce it to solver
    convergence tolerance."""
    from jax import lax
    params = SimulationParams(nx=nx, ny=ny, tau=tau, problem="poiseuille",
                              periodic_x=True, inlet_velocity=0.0,
                              precision="f64", obstacle_bc="bouzidi")
    solid = np.zeros((ny, nx), bool)
    solid[:2] = True
    solid[-2:] = True
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt

    def sdf(p):
        return np.minimum(p[..., 1] - y0, y1 - p[..., 1])

    def uw(p):
        mov = p[..., 1] > 0.5 * ny
        return np.stack([np.where(mov, U, 0.0),
                         np.zeros_like(p[..., 0])], axis=-1)

    pr = Problem(params=params, lattice=D2Q9, solid=solid,
                 obstacle_sdf=sdf, obstacle_velocity=uw, init_u=(0.0, 0.0),
                 walls_y=False, periodic_x=True, obstacle_bc="bouzidi")
    step = jax.jit(make_step_rolled(pr))
    f = pr.initial_state()
    f = lax.fori_loop(0, steps, lambda i, x: step(x), f)
    rho, u = physics.moments(D2Q9, np.asarray(f))
    ux = np.asarray(u[0])[:, 0]
    yy = np.arange(ny, dtype=np.float64)
    fl = slice(2, ny - 2)
    ana = U * (yy - y0) / (y1 - y0)
    err = np.max(np.abs(ux[fl] - ana[fl])) / U
    co = np.polyfit(yy[fl], ux[fl], 1)
    return err, -co[1] / co[0], (U - co[1]) / co[0], (y0, y1)


@pytest.mark.slow
@pytest.mark.parametrize("qb,qt", [(0.25, 0.75), (0.9, 0.1)])
def test_moving_wall_couette_exact(qb, qt):
    # measured: profile exact to ~2e-8, wall positions to 4 decimals
    err, yz, yU, (y0, y1) = _couette(qb, qt)
    assert err < 1e-6, err
    assert abs(yz - y0) < 1e-3, (yz, y0)
    assert abs(yU - y1) < 1e-3, (yU, y1)


@pytest.mark.slow
def test_rotating_cylinder_magnus_lift():
    # spinning cylinder in a stream: the lift must be nonzero and flip
    # sign with the spin direction (Magnus effect) while the drag stays
    # symmetric; obstacle_velocity rides --cylinder-omega
    from jax import lax
    from tpulbm.ops import forces as F

    def run(omega):
        params = SimulationParams(nx=200, ny=50, tau=0.62,
                                  inlet_velocity=0.05,
                                  cylinder_radius=0.08, cylinder_x=0.25,
                                  cylinder_omega=omega, precision="f32",
                                  obstacle_bc="bouzidi")
        pr = make_problem(params)
        step = jax.jit(make_step_rolled(pr))
        ffn = jax.jit(F.forces_fn(pr))
        from tpulbm.ops.bouzidi import link_tables
        q = jnp.asarray(link_tables(pr))
        f = jnp.asarray(pr.initial_state())
        f = lax.fori_loop(0, 4000, lambda i, x: step(x), f)
        force = np.asarray(ffn(f, q))
        assert np.isfinite(np.asarray(f)).all()
        return F.force_coefficients(pr, force)

    om = 0.05 / 4.0                     # surface speed = inlet speed
    cd_p, cl_p = run(+om)
    cd_m, cl_m = run(-om)
    assert abs(cl_p) > 0.1, cl_p        # real Magnus lift
    assert cl_p * cl_m < 0              # flips with spin direction
    assert abs(cl_p + cl_m) < 0.2 * abs(cl_p - cl_m)   # antisymmetric
    assert abs(cd_p - cd_m) < 0.1 * (cd_p + cd_m)      # drag symmetric


def test_sphere_3d_links_and_smoke():
    # D3Q19 sphere: q table exact vs the closed-form sphere-line
    # intersection; the oracle stays finite under the curved-wall closure
    params = SimulationParams(nx=48, ny=24, nz=24, problem="cylinder3d",
                              precision="f64", obstacle_bc="bouzidi",
                              inlet_velocity=0.05, tau=0.6,
                              cylinder_radius=0.23)  # fractional r: real q
    pr = make_problem(params)
    q = link_q(pr)
    lat = pr.lattice
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    cz = params.nz // 2
    r = float(params.get_cylinder_radius_cells())
    center = np.array([cx, cy, cz], np.float64)
    checked = 0
    for j in range(1, lat.Q):
        for (zz, yy, xx) in np.argwhere(q[j] >= 0)[:8]:
            ci = -lat.c[j].astype(np.float64)
            p0 = np.array([xx, yy, zz], np.float64)
            a = ci @ ci
            b = 2.0 * ci @ (p0 - center)
            c0 = (p0 - center) @ (p0 - center) - r * r
            t = (-b - np.sqrt(b * b - 4 * a * c0)) / (2 * a)
            got = float(q[j, zz, yy, xx])
            if got == 0.5 and abs(t - 0.5) > 1e-6:
                continue
            assert abs(got - t) < 1e-6, (j, zz, yy, xx, got, t)
            checked += 1
    assert checked > 50
    step = jax.jit(make_step_rolled(pr))
    f = pr.initial_state()
    for _ in range(50):
        f = step(f)
    f = np.asarray(f)
    assert np.isfinite(f).all()


def test_missing_sdf_raises():
    import dataclasses
    params = SimulationParams(nx=32, ny=16, precision="f32",
                              obstacle_bc="bouzidi")
    pr = dataclasses.replace(make_problem(params), obstacle_sdf=None)
    with pytest.raises(ValueError, match="obstacle_sdf"):
        link_q(pr)
