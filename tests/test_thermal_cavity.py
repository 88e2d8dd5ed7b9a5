"""Side-heated (de Vahl Davis 1983) square cavity: the second thermal
benchmark family. Rotated frame (models/rayleigh_benard.py): the hot/cold
Dirichlet walls stay the y walls, x becomes adiabatic no-slip walls, and
buoyancy acts along +x. Gates: exact conduction fixed point, the
benchmark Nusselt number at Ra = 10^4, sharded == single-device
equivalence, config routing."""
import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem
from tpulbm.ops.step_thermal import make_step_thermal, nusselt, temperature
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _params(**kw):
    d = dict(nx=64, ny=64, problem="heated-cavity", tau=0.55,
             thermal_tau=0.5704, rayleigh=1e4, inlet_velocity=0.0,
             cylinder_radius=0.0, periodic_x=False, precision="f32")
    d.update(kw)
    return SimulationParams(**d)


def test_problem_routing_and_geometry():
    pr = make_problem(_params())
    assert pr.walls_x and pr.walls_y and not pr.periodic_x
    assert pr.thermal.buoyancy_axis == 0
    assert pr.thermal.perturb == 0.0
    assert pr.thermal.buoyancy > 0


def test_conduction_steady_state():
    # zero buoyancy: the fluid stays at rest and T stays the linear
    # conduction profile; g relaxes within a few steps to the steady
    # flux-carrying state (its non-equilibrium part holds -alpha dT/dy),
    # which the adiabatic x walls must not disturb
    params = _params(nx=16, ny=17, rayleigh=0.0, buoyancy=0.0,
                     tau=0.8, thermal_tau=0.7, precision="f64")
    pr = make_problem(params)
    step = jax.jit(make_step_thermal(pr))
    s0 = pr.initial_state()
    T0 = np.asarray(temperature(pr, s0))
    s = s0
    for _ in range(400):
        s = step(s)
    s = np.asarray(s)
    np.testing.assert_allclose(np.asarray(temperature(pr, s)), T0,
                               atol=1e-12)
    rho, u = physics.moments(pr.lattice, s[:9])
    assert float(np.max(np.abs(np.asarray(u)))) < 1e-13
    # genuinely steady: one more step is a no-op
    np.testing.assert_allclose(np.asarray(step(s)), s, atol=1e-14)


@pytest.mark.slow
def test_de_vahl_davis_nu_ra1e4():
    """Benchmark gate: Nu(Ra=10^4, Pr~0.71) = 2.243 (de Vahl Davis 1983).
    64^2 converges in ~80k steps (measured Nu = 2.305, +2.8%)."""
    pr = make_problem(_params())
    step = jax.jit(make_step_thermal(pr))
    nu_fn = jax.jit(lambda s: nusselt(pr, s))
    s = pr.initial_state()
    for _ in range(80):
        s = jax.lax.fori_loop(0, 1000, lambda _, x: step(x), s)
    nu = float(nu_fn(s))
    assert abs(nu - 2.243) / 2.243 < 0.04, nu
    T = np.asarray(temperature(pr, s))
    assert -0.01 < T.min() and T.max() < 1.01
    # single convection roll: hot fluid rises (+x) near the hot wall y=0
    rho, u = physics.moments(pr.lattice, np.asarray(s)[:9])
    assert np.asarray(u[0])[:, 10].mean() > 0  # ux averaged over a hot-side column


@pytest.mark.slow
def test_de_vahl_davis_nu_ra1e4_96():
    """Resolution check: 96^2 lands within 3% (measured +1.9%)."""
    pr = make_problem(_params(nx=96, ny=96))
    step = jax.jit(make_step_thermal(pr))
    nu_fn = jax.jit(lambda s: nusselt(pr, s))
    s = pr.initial_state()
    for _ in range(110):
        s = jax.lax.fori_loop(0, 1000, lambda _, x: step(x), s)
    nu = float(nu_fn(s))
    assert abs(nu - 2.243) / 2.243 < 0.03, nu


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2), (4, 1)],
                         ids=["y", "2d", "x", "y4"])
def test_heated_cavity_sharded_matches_oracle(mesh_shape):
    params = _params(nx=32, ny=32, precision="f64")
    pr = make_problem(params)
    step = jax.jit(make_step_thermal(pr))
    s_ref = pr.initial_state()
    for _ in range(10):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(pr, mesh, 5)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros(pr.spatial_shape, bool))
    for _ in range(2):
        s = chunk(s, solid)
    got = np.asarray(jax.device_get(s))
    np.testing.assert_allclose(got, s_ref, rtol=1e-12, atol=1e-14)

