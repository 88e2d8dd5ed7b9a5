"""Thermal (double-population Boussinesq) model: D2Q5 identities,
advection-diffusion equilibrium, conduction fixed point, diffusivity,
exact wall mass conservation, buoyancy momentum budget, and the
Rayleigh-Bénard physics gates (critical-Ra onset, Nusselt number).

New capability — the reference is strictly isothermal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import PRESETS, SimulationParams
from tpulbm.lattice import D2Q5
from tpulbm.models import make_problem
from tpulbm.models.rayleigh_benard import buoyancy_for_rayleigh
from tpulbm.ops.step_thermal import (collide_thermal, make_step_thermal,
                                     nusselt, temperature)


def _params(ny=33, ra=0.0, nx=None, tau=0.6, tau_g=0.6, **kw):
    kw.setdefault("t_hot", 1.0)
    kw.setdefault("t_cold", 0.0)
    return SimulationParams(nx=nx or 2 * (ny - 1), ny=ny,
                            problem="rayleigh-benard", tau=tau,
                            thermal_tau=tau_g, rayleigh=ra, periodic_x=True,
                            cylinder_radius=0.0, precision="f64", **kw)


def test_d2q5_lattice_identities():
    assert D2Q5.Q == 5 and D2Q5.D == 2
    np.testing.assert_allclose(D2Q5.w.sum(), 1.0)
    np.testing.assert_allclose(D2Q5.w @ D2Q5.c.astype(float), 0.0)
    # second moment = cs2 * I (isotropy of the AD lattice)
    m2 = np.einsum("i,ia,ib->ab", D2Q5.w, D2Q5.c.astype(float),
                   D2Q5.c.astype(float))
    np.testing.assert_allclose(m2, np.eye(2) / 3.0)
    np.testing.assert_array_equal(D2Q5.opposite, [0, 3, 4, 1, 2])


def test_thermal_equilibrium_moments():
    rng = np.random.default_rng(1)
    T = jnp.asarray(np.abs(rng.standard_normal((6, 8))) + 0.5)
    u = jnp.asarray(0.05 * rng.standard_normal((2, 6, 8)))
    geq = physics.thermal_equilibrium(D2Q5, T, u)
    np.testing.assert_allclose(np.asarray(jnp.sum(geq, 0)), np.asarray(T),
                               rtol=1e-13)
    flux = np.einsum("ia,i...->a...", D2Q5.c.astype(float), np.asarray(geq))
    np.testing.assert_allclose(flux, np.asarray(T * u), rtol=1e-12,
                               atol=1e-15)


def test_problem_layout_and_preset():
    prob = make_problem(_params(ra=5000.0))
    assert prob.state_q == 14 and prob.thermal is not None
    assert prob.periodic_x and prob.walls_y and prob.solid is None
    assert prob.thermal.buoyancy > 0
    assert prob.initial_state().shape == (14, 33, 64)
    assert "rayleigh-benard" in PRESETS
    with pytest.raises(ValueError, match="thermal_tau"):
        make_problem(_params().replace(thermal_tau=0.4))


def test_collision_budget():
    # collide_thermal conserves mass and T pointwise, and injects exactly
    # F_y = buoyancy (T - t_ref) of y-momentum per cell per step
    prob = make_problem(_params(ra=5000.0))
    rng = np.random.default_rng(3)
    s = np.asarray(prob.initial_state())
    s[:9] *= 1.0 + 0.01 * rng.standard_normal(s[:9].shape)
    s = jnp.asarray(s)
    out = collide_thermal(prob, s)
    np.testing.assert_allclose(np.asarray(jnp.sum(out[:9], 0)),
                               np.asarray(jnp.sum(s[:9], 0)), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(jnp.sum(out[9:], 0)),
                               np.asarray(jnp.sum(s[9:], 0)), rtol=1e-13)
    cy = prob.lattice.c[:, 1].astype(float)
    dmy = np.einsum("i,i...->...", cy, np.asarray(out[:9] - s[:9]))
    T = np.asarray(jnp.sum(s[9:], 0))
    expect = prob.thermal.buoyancy * (T - prob.thermal.t_ref)
    np.testing.assert_allclose(dmy, expect, rtol=1e-10, atol=1e-15)


def test_conduction_fixed_point():
    # zero buoyancy, zero perturbation: the linear profile is an exact
    # fixed point of T; walls hold exactly t_hot / t_cold; Nu == 1
    prob = make_problem(_params(ny=17, nx=16, tau=0.8, tau_g=0.7))
    prob = dataclasses.replace(
        prob, thermal=dataclasses.replace(prob.thermal, perturb=0.0))
    step = jax.jit(make_step_thermal(prob))
    s = jnp.asarray(prob.initial_state())
    T0 = np.asarray(temperature(prob, s))
    for _ in range(200):
        s = step(s)
    T = np.asarray(temperature(prob, s))
    np.testing.assert_allclose(T, T0, atol=1e-13)
    np.testing.assert_allclose(T[0], 1.0, atol=1e-12)
    np.testing.assert_allclose(T[-1], 0.0, atol=1e-12)
    np.testing.assert_allclose(float(nusselt(prob, s)), 1.0, atol=1e-12)


def test_wall_mass_exact():
    # the thermal walls return the node's own post-collision outward
    # populations, conserving fluid mass EXACTLY (the reference-parity
    # on-node reflection drifts ~2.6e-6/step here — measured)
    prob = make_problem(_params(ny=17, nx=32, ra=5000.0))
    step = jax.jit(make_step_thermal(prob))
    s = jnp.asarray(prob.initial_state())
    m0 = float(jnp.sum(s[:9]))
    s = jax.lax.fori_loop(0, 2000, lambda _, t: step(t), s)
    assert bool(physics.is_stable(s))
    np.testing.assert_allclose(float(jnp.sum(s[:9])) / m0, 1.0, rtol=1e-12)


def test_diffusion_decay_rate():
    # equal wall temperatures, no buoyancy: a sin(pi y / ny) cos(2 pi x/nx)
    # mode decays at alpha (kx^2 + ky^2) with ky = pi/ny (walls half a link
    # outside the boundary nodes); 3.5% measured discrete-dispersion error
    ny, nx = 32, 64
    prob = make_problem(_params(ny=ny, nx=nx, tau=0.7, tau_g=0.8,
                                t_hot=0.5, t_cold=0.5))
    alpha = prob.thermal.alpha
    s = np.asarray(prob.initial_state())
    y = (np.arange(ny) + 0.5)[:, None]
    x = np.arange(nx)[None, :]
    tp = 0.01 * np.sin(np.pi * y / ny) * np.cos(2 * np.pi * x / nx)
    s[9:] = prob.thermal.lattice.w[:, None, None] * (0.5 + tp)[None]
    step = jax.jit(make_step_thermal(prob))

    def amp(state):
        t = np.asarray(temperature(prob, state)) - 0.5
        return np.sqrt(np.mean(t * t))

    s = jnp.asarray(s)
    a0 = amp(s)
    n = 400
    s = jax.lax.fori_loop(0, n, lambda _, t: step(t), s)
    measured = -np.log(amp(s) / a0) / n
    expected = alpha * ((2 * np.pi / nx) ** 2 + (np.pi / ny) ** 2)
    assert abs(measured / expected - 1.0) < 0.08, (measured, expected)


def _energy_ratio(ra, steps=12000):
    prob = make_problem(_params(ra=ra))
    step = jax.jit(make_step_thermal(prob))
    body = lambda _, t: step(t)

    def kinetic(state):
        rho, u = physics.moments(prob.lattice, state[:9])
        return float(jnp.mean(u[0] ** 2 + u[1] ** 2))

    s = jnp.asarray(prob.initial_state())
    s = jax.lax.fori_loop(0, steps // 2, body, s)
    e_mid = kinetic(s)
    s = jax.lax.fori_loop(0, steps // 2, body, s)
    return kinetic(s) / e_mid


def test_convection_onset_brackets_critical_rayleigh():
    """Parameter-free physics gate: the seed perturbation decays below the
    critical Rayleigh number (theory: 1707.76) and grows above it."""
    assert _energy_ratio(1300.0) < 0.9
    assert _energy_ratio(2300.0) > 1.4


@pytest.mark.slow
def test_critical_rayleigh_within_four_percent():
    # measured bracket at H=32: decaying at 1650, growing at 1750
    assert _energy_ratio(1650.0) < 1.0
    assert _energy_ratio(1775.0) > 1.0


@pytest.mark.slow
def test_nusselt_ra5000():
    """Nu(Ra=5000) = 2.116 (Clever & Busse 1974, Pr=0.71). Measured here:
    2.189 steady (Pr=1, H=32 — +3.4% discretization). Gate with a band
    that excludes both the conductive state and runaway."""
    prob = make_problem(_params(ra=5000.0))
    step = jax.jit(make_step_thermal(prob))
    body = lambda _, t: step(t)
    s = jnp.asarray(prob.initial_state())
    s = jax.lax.fori_loop(0, 40000, body, s)
    nu1 = float(nusselt(prob, s))
    s = jax.lax.fori_loop(0, 10000, body, s)
    nu2 = float(nusselt(prob, s))
    assert bool(physics.is_stable(s))
    assert 2.0 < nu2 < 2.35, nu2
    assert abs(nu2 - nu1) < 1e-3, (nu1, nu2)  # steady, not transient


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 1)],
                         ids=["single", "2d-mesh", "y-sharded"])
def test_thermal_sharded_matches_oracle(mesh_shape):
    # the padded thermal local step + generic ring exchange must reproduce
    # the single-device rolled oracle on any mesh
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state

    params = _params(ny=32, nx=32, ra=5000.0)
    prob = make_problem(params)
    step = jax.jit(make_step_thermal(prob))
    s_ref = jnp.asarray(prob.initial_state())
    for _ in range(12):
        s_ref = step(s_ref)

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(prob, mesh, 6)
    s, solid = shard_state(mesh, prob.initial_state(),
                           np.zeros(prob.spatial_shape, bool))
    for _ in range(2):
        s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)),
                               np.asarray(s_ref), rtol=1e-11, atol=1e-14)


def test_thermal_runner_end_to_end(tmp_path):
    # CLI-level integration: --preset rayleigh-benard runs, stays stable,
    # writes the temperature field, and reports Nu
    from tpulbm.runner import Runner
    params = _params(ny=32, nx=32, ra=3000.0).replace(
        num_timesteps=400, output_frequency=100, enable_vtk=False,
        output_dir=str(tmp_path))
    res = Runner(params, verbose=False).run(resume=False)
    assert res.success
    assert res.stats is not None and "nusselt" in res.stats
    assert 0.9 < res.stats["nusselt"] < 3.0
    tf = tmp_path / "temperature_field.csv"
    assert tf.exists()
    header = tf.read_text().splitlines()
    assert header[0] == "x,y,temperature"
    assert len(header) == 1 + 32 * 32
    # per-interval Nusselt trace (the convection analog of forces.csv)
    nu_rows = (tmp_path / "nusselt.csv").read_text().splitlines()
    assert nu_rows[0] == "timestep,nusselt"
    steps = [int(r.split(",")[0]) for r in nu_rows[1:]]
    assert steps == sorted(set(steps)) and steps[0] == 0
    assert all(0.5 < float(r.split(",")[1]) < 5.0 for r in nu_rows[1:])


def test_thermal_vtk_frames_carry_temperature(tmp_path):
    from tpulbm.runner import Runner
    params = _params(ny=16, nx=16, ra=2000.0).replace(
        num_timesteps=150, output_frequency=50, enable_vtk=True,
        output_dir=str(tmp_path))
    assert Runner(params, verbose=False).run(resume=False).success
    frames = sorted((tmp_path / "vtk_output").glob("*.vtk"))
    assert frames, "no VTK frames written"
    body = frames[0].read_text()
    assert "SCALARS temperature double" in body
    assert body.count("LOOKUP_TABLE default") == 3  # |u|, rho, T
    # the temperature block has one value per point, bounded by the walls
    tail = body.split("SCALARS temperature double\nLOOKUP_TABLE default\n")[1]
    vals = [float(v) for v in tail.split()]
    assert len(vals) == 16 * 16
    assert all(-0.05 <= v <= 1.05 for v in vals)


@pytest.mark.parametrize("mesh_shape,cs", [((1, 1), 0.0), ((4, 1), 0.0),
                                           ((2, 2), 0.0), ((1, 2), 0.0),
                                           ((1, 1), 0.17)],
                         ids=["single", "y-sharded", "xy-sharded",
                              "x-sharded", "les"])
def test_thermal_f32_sharded_matches_oracle(mesh_shape, cs):
    # the production f32 state through the chosen tier (XLA on the CPU
    # and the GPU: the fused kernel does not cover thermal) vs the rolled
    # oracle, on every mesh shape and with the LES closure
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state

    params = _params(ny=32, nx=32, ra=5000.0).replace(precision="f32",
                                                      smagorinsky=cs)
    prob = make_problem(params)
    step = jax.jit(make_step_thermal(prob))
    s_ref = jnp.asarray(prob.initial_state())
    for _ in range(12):
        s_ref = step(s_ref)

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(prob, mesh, 6)
    assert chunk.tier == "xla"
    s, solid = shard_state(mesh, prob.initial_state(),
                           np.zeros(prob.spatial_shape, bool))
    for _ in range(2):
        s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)),
                               np.asarray(s_ref), rtol=2e-5, atol=1e-6)


def test_thermal_checkpoint_resume(tmp_path):
    # bitwise-reproducible resume of the stacked 14-plane state
    from tpulbm.runner import Runner

    def run(out, steps, resume):
        p = _params(ny=32, nx=32, ra=3000.0).replace(
            num_timesteps=steps, output_frequency=50, enable_vtk=False,
            checkpoint_every=1, output_dir=out)
        return Runner(p, verbose=False).run(resume=resume)

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert run(a, 200, False).success          # straight 200 steps
    assert run(b, 100, False).success          # 100 …
    assert run(b, 200, True).success           # … resume to 200
    for name in ("velocity_field.csv", "temperature_field.csv",
                 "nusselt.csv"):
        fa = (tmp_path / "a" / name).read_text()
        fb = (tmp_path / "b" / name).read_text()
        assert fa == fb, f"{name} differs after resume"


def test_buoyancy_for_rayleigh_roundtrip():
    p = _params(ra=5000.0)
    b = buoyancy_for_rayleigh(5000.0, p)
    alpha = (p.thermal_tau - 0.5) / 3.0
    ra = b * (p.t_hot - p.t_cold) * float(p.ny) ** 3 / (p.nu() * alpha)
    np.testing.assert_allclose(ra, 5000.0, rtol=1e-12)
