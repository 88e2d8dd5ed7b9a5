"""Fully periodic boxes (models/periodic2d.py): Taylor-Green vortex +
double shear layer. New capability — the reference has no periodic-y
mode at all (its y rows are always bounce-back walls, LBMSolver.h:150-176).

The Taylor-Green vortex is the sharpest accuracy gate in the suite: an
exact Navier-Stokes solution, so the simulated field is compared against
the analytic field AND the measured energy-decay rate must recover
nu = (tau - 1/2)/3 to a fraction of a percent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.models.periodic2d import taylor_green_fields
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _params(**kw):
    d = dict(nx=64, ny=64, tau=0.8, problem="taylor-green",
             inlet_velocity=0.04, periodic_x=True, cylinder_radius=0.0,
             precision="f64")
    d.update(kw)
    return SimulationParams(**d)


@pytest.mark.slow
def test_taylor_green_matches_analytic_solution():
    # direct field comparison against the exact NS solution at t = 1200
    params = _params()
    pr = make_problem(params)
    step = jax.jit(make_step_rolled(pr))
    t_end = 1200
    f = jnp.asarray(pr.initial_state())
    f = lax.fori_loop(0, t_end, lambda i, x: step(x), f)
    rho, u = physics.moments(D2Q9, f)
    _, u_ana = taylor_green_fields(params, t=float(t_end))
    u0 = params.inlet_velocity
    err = np.max(np.abs(np.asarray(u) - u_ana)) / u0
    assert err < 5e-3, err
    # mass is conserved exactly in a periodic box (no open boundaries)
    np.testing.assert_allclose(float(jnp.sum(f)), 64.0 * 64.0, rtol=1e-12)


@pytest.mark.slow
def test_taylor_green_recovers_viscosity():
    # energy decay rate -> nu_eff == (tau - 1/2)/3 (measured 4e-5 rel)
    params = _params(tau=0.8)
    pr = make_problem(params)
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())

    def energy(f):
        rho, u = physics.moments(D2Q9, f)
        return float(jnp.sum(rho * (u[0] ** 2 + u[1] ** 2)))

    e, ts = [], []
    for k in range(12):
        f = lax.fori_loop(0, 150, lambda i, x: step(x), f)
        e.append(energy(f))
        ts.append((k + 1) * 150.0)
    slope = np.polyfit(np.asarray(ts), np.log(np.asarray(e)), 1)[0]
    k2 = 2.0 * (2.0 * np.pi / 64.0) ** 2
    nu_eff = -slope / (2.0 * k2)
    assert abs(nu_eff / params.nu() - 1.0) < 0.005, nu_eff


def test_runner_applies_init_fields(tmp_path):
    """Regression: the Runner's device-side fresh-start build
    (shard_initial_state) must honor init_fields — it used to silently
    build the uniform broadcast, running every Runner-driven periodic box
    from a quiescent state. The final field must match the analytic TG
    solution at t = num_timesteps."""
    from tpulbm.runner import Runner
    T = 120
    params = _params(num_timesteps=T, output_frequency=60,
                     output_dir=str(tmp_path), enable_vtk=False)
    res = Runner(params, verbose=False).run(resume=False)
    assert res.success
    import numpy.lib.recfunctions  # noqa: F401  (genfromtxt names path)
    data = np.genfromtxt(tmp_path / "velocity_field.csv", delimiter=",",
                         names=True)
    nx, ny = params.nx, params.ny
    ux = data["ux"].reshape(ny, nx)
    uy = data["uy"].reshape(ny, nx)
    _, u_ana = taylor_green_fields(params, t=float(T))
    err = max(np.max(np.abs(ux - u_ana[0])), np.max(np.abs(uy - u_ana[1])))
    assert err / params.inlet_velocity < 5e-3, err


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)], ids=["y", "2d"])
def test_periodic_sharded_matches_oracle(mesh_shape):
    # the y-wrapping ppermute ring must reproduce the oracle bitwise (f64)
    pr = make_problem(_params(nx=32, ny=32))
    step = jax.jit(make_step_rolled(pr))
    s_ref = pr.initial_state()
    for _ in range(10):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, 5)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros(pr.spatial_shape, bool))
    for _ in range(2):
        s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)), s_ref,
                               rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 1), (1, 2), (2, 2)],
                         ids=["single", "y-sharded", "x-sharded", "2d-mesh"])
def test_periodic_triton_matches_oracle(mesh_shape):
    # the GPU kernel (Pallas interpreter) on a fully periodic box: every
    # shard edge is a wrapped ring, corners included (two-phase exchange)
    pr = make_problem(_params(precision="f32"))
    step = jax.jit(make_step_rolled(pr))
    s_ref = pr.initial_state()
    for _ in range(12):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, 6, tier="triton", interpret=True)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros(pr.spatial_shape, bool))
    for _ in range(2):
        s = chunk(s, solid)
    d = np.max(np.abs(np.asarray(jax.device_get(s)) - s_ref))
    assert d < 1e-5, d


def test_shear_layer_preset_runs(tmp_path):
    # the preset pairs the stability benchmark with the regularized
    # operator; short runner smoke (the full BGK-vs-regularized gate is
    # tests/test_regularized.py)
    from tpulbm.config import PRESETS
    from tpulbm.runner import Runner
    p = PRESETS["shear-layer"].replace(
        nx=64, ny=64, num_timesteps=200, output_frequency=100,
        output_dir=str(tmp_path), precision="f32")
    assert p.collision == "regularized"
    res = Runner(p, verbose=False).run(resume=False)
    assert res.success
    assert (tmp_path / "velocity_field.csv").exists()


# ---------------------------------------------------------------- 3-D ----

def _params3d(**kw):
    d = dict(nx=32, ny=16, nz=16, problem="taylor-green", tau=0.8,
             inlet_velocity=0.04, periodic_x=True, cylinder_radius=0.0,
             precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def _zwave_decay_err(nzv, steps, tau=0.8):
    """Relative error of the z-shear-wave amplitude decay vs the exact
    exp(-nu k^2 t) — the wave u_x = A sin(2 pi z / nz) has (u.grad)u = 0,
    so it is an EXACT Navier-Stokes solution probing the z-periodic
    machinery in isolation."""
    import dataclasses
    from jax import lax
    params = _params3d(nx=8, ny=8, nz=nzv, tau=tau)
    pr = make_problem(params)
    A = 0.01
    z = np.arange(nzv)[:, None, None] * (2.0 * np.pi / nzv)
    ux = A * np.sin(z) * np.ones((nzv, 8, 8))
    u0 = np.stack([ux, np.zeros_like(ux), np.zeros_like(ux)])
    pr = dataclasses.replace(pr, init_fields=(np.ones((nzv, 8, 8)), u0))
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())
    f = lax.fori_loop(0, steps, lambda i, x: step(x), f)
    rho, u = physics.moments(pr.lattice, f)
    amp = np.max(np.abs(np.asarray(u[0])))
    expect = A * np.exp(-params.nu() * (2.0 * np.pi / nzv) ** 2 * steps)
    return abs(amp / expect - 1.0)


@pytest.mark.slow
def test_z_shear_wave_second_order_viscosity():
    # measured: 4.6e-2 / 1.2e-2 / 2.9e-3 at nz = 16/32/64 — clean
    # second-order lattice dispersion converging to the exact decay
    e16 = _zwave_decay_err(16, 300)
    e32 = _zwave_decay_err(32, 1200)
    assert e32 < 0.02, e32
    assert 3.0 < e16 / e32 < 5.5, (e16, e32)     # O(k^2) convergence


def test_taylor_green_3d_energy_and_mass():
    from jax import lax
    pr = make_problem(_params3d())
    assert pr.periodic_x and pr.periodic_y and pr.periodic_z
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())
    m0 = float(jnp.sum(f))

    def energy(f):
        rho, u = physics.moments(pr.lattice, f)
        return float(jnp.sum(rho * sum(u[d] ** 2 for d in range(3))))

    e_prev = energy(f)
    for _ in range(4):
        f = lax.fori_loop(0, 40, lambda i, x: step(x), f)
        e = energy(f)
        assert e < e_prev          # viscous decay, no spurious forcing
        e_prev = e
    assert np.isfinite(np.asarray(f)).all()
    np.testing.assert_allclose(float(jnp.sum(f)), m0, rtol=1e-12)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2), (4, 1)],
                         ids=["y", "2d", "x", "y4"])
def test_periodic3d_sharded_matches_oracle(mesh_shape):
    pr = make_problem(_params3d())
    step = jax.jit(make_step_rolled(pr))
    s_ref = pr.initial_state()
    for _ in range(8):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, 4)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros(pr.spatial_shape, bool))
    for _ in range(2):
        s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)), s_ref,
                               rtol=1e-13, atol=1e-15)

