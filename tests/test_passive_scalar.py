"""Passive scalar transport in fully periodic boxes (problem=
"passive-scalar"): the D2Q5 scalar rides the thermal double-population
machinery with buoyancy = 0 and NO walls — periodic halos wrap both
populations (step_thermal walls_y=False path). Gates are closed-form:
pure diffusion decays a sinusoidal stripe at exactly exp(−α q² t),
uniform advection translates it at exactly u0·t while diffusing, and
stirring only ever destroys variance faster. New capability — the
reference is isothermal and wall-bounded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem
from tpulbm.ops.step_thermal import (make_step_thermal, scalar_variance,
                                     temperature)
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _params(**kw):
    d = dict(nx=64, ny=32, tau=0.8, problem="passive-scalar",
             thermal_tau=0.8, inlet_velocity=0.0, periodic_x=True,
             cylinder_radius=0.0, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def _amp_phase(T):
    """(amplitude, phase) of the x-mode-1 stripe from a row-averaged FFT."""
    row = np.asarray(T).mean(axis=0)
    co = np.fft.rfft(row)[1]
    n = row.shape[0]
    return 2.0 * np.abs(co) / n, np.angle(co)


def test_pure_diffusion_decays_at_exact_rate():
    """u = 0: T = t_ref + A sin(qx) decays as exp(−α q² t) with
    α = (τ_g − ½)/3 — the sharpest scalar-diffusivity gate possible."""
    params = _params()
    pr = make_problem(params)
    assert pr.thermal is not None and not pr.walls_y
    step = jax.jit(make_step_thermal(pr))
    s = jnp.asarray(pr.initial_state())
    a0, _ = _amp_phase(temperature(pr, s))
    alpha = pr.thermal.alpha
    q = 2.0 * np.pi / params.nx
    steps = 800
    s = lax.fori_loop(0, steps, lambda i, x: step(x), s)
    a1, _ = _amp_phase(temperature(pr, s))
    expected = np.exp(-alpha * q * q * steps)
    assert abs(a1 / a0 / expected - 1.0) < 1e-3, (a1 / a0, expected)
    # the flow stayed at rest and the scalar mean is conserved exactly
    np.testing.assert_allclose(float(jnp.sum(s[pr.lattice.Q:])),
                               0.5 * params.nx * params.ny, rtol=1e-12)


def test_uniform_advection_translates_the_stripe():
    """A uniform flow u = (u0, 0) is an exact solution of the periodic
    box; the stripe must advect with phase −q·u0·t while decaying at the
    (slightly Galilean-shifted) diffusive rate. Gates the advection term
    of the scalar equilibrium g_eq = w T (1 + 3 c·u)."""
    import dataclasses
    params = _params()
    pr = make_problem(params)
    u0 = 0.02
    rho = np.ones((params.ny, params.nx))
    u = np.zeros((2, params.ny, params.nx))
    u[0] = u0
    pr = dataclasses.replace(pr, init_fields=(rho, u))
    step = jax.jit(make_step_thermal(pr))
    s = jnp.asarray(pr.initial_state())
    a0, p0 = _amp_phase(temperature(pr, s))
    q = 2.0 * np.pi / params.nx
    steps = 500
    s = lax.fori_loop(0, steps, lambda i, x: step(x), s)
    a1, p1 = _amp_phase(temperature(pr, s))
    dphase = (p1 - p0 + np.pi) % (2.0 * np.pi) - np.pi
    np.testing.assert_allclose(dphase, -q * u0 * steps, atol=2e-3)
    # amplitude still decays diffusively (O(u²) Galilean correction)
    alpha = pr.thermal.alpha
    assert abs(a1 / a0 / np.exp(-alpha * q * q * steps) - 1.0) < 5e-3


def test_stirring_accelerates_mixing():
    """Taylor-Green stirring steepens scalar gradients: by stripe-decay
    time the stirred variance must sit clearly below pure diffusion's."""
    params = _params(nx=64, ny=64, inlet_velocity=0.08, tau=0.55,
                     thermal_tau=0.55)
    pr_stir = make_problem(params)
    pr_still = make_problem(_params(nx=64, ny=64, inlet_velocity=0.0,
                                    tau=0.55, thermal_tau=0.55))
    steps = 4000

    def final_var(pr):
        step = jax.jit(make_step_thermal(pr))
        s = jnp.asarray(pr.initial_state())
        s = lax.fori_loop(0, steps, lambda i, x: step(x), s)
        return float(scalar_variance(pr, s))

    v_stir, v_still = final_var(pr_stir), final_var(pr_still)
    assert v_stir < 0.5 * v_still, (v_stir, v_still)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2)],
                         ids=["y", "2d", "x"])
def test_sharded_matches_oracle(mesh_shape):
    """The stacked f+g state through the generic ring/scan body with
    periodic wraps must reproduce the single-device oracle."""
    params = _params(inlet_velocity=0.05)
    pr = make_problem(params)
    step = jax.jit(make_step_thermal(pr))
    s_ref = jnp.asarray(pr.initial_state())
    for _ in range(10):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, 5)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros((params.ny, params.nx), bool))
    s = chunk(s, solid)
    s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)), s_ref,
                               rtol=1e-12, atol=1e-14)


def test_runner_end_to_end_writes_variance_trace(tmp_path):
    """Runner: scalar_variance.csv (monotone decay), temperature_field
    .csv, and the p{k}_T probe column all work for the periodic scalar."""
    from tpulbm.runner import Runner
    params = _params(nx=32, ny=32, inlet_velocity=0.05,
                     num_timesteps=200, output_frequency=50,
                     output_dir=str(tmp_path),
                     enable_vtk=False, precision="f32",
                     probe_points=((0.5, 0.5),))
    res = Runner(params, verbose=False).run()
    assert res.success
    tr = np.genfromtxt(tmp_path / "scalar_variance.csv", delimiter=",",
                       names=True)
    assert tr["scalar_variance"].shape[0] >= 3
    v = tr["scalar_variance"]
    assert np.all(np.diff(v) <= 1e-12)        # mixing destroys variance
    assert (tmp_path / "temperature_field.csv").exists()
    pb = np.genfromtxt(tmp_path / "probes.csv", delimiter=",", names=True)
    assert "p0_T" in pb.dtype.names
