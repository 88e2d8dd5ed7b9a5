"""Fast physics gate: body-force Poiseuille channel vs the analytic parabola
(the reference's branch validation claims RMSE ≈ 0.003, README.md:77-79;
SURVEY §4 sets our gate at RMSE < 0.005)."""
import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.models.poiseuille import analytic_profile
from tpulbm.ops.step_jax import make_step_rolled


def _run_poiseuille(ny=32, tau=0.8, F=2e-6, steps=12000, precision="f64",
                    obstacle_bc="equilibrium"):
    params = SimulationParams(nx=32, ny=ny, tau=tau, problem="poiseuille",
                              periodic_x=True, body_force=(F, 0.0),
                              inlet_velocity=0.0, precision=precision,
                              obstacle_bc=obstacle_bc)
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))

    def many(f, n=500):
        for _ in range(n):
            f = step(f)
        return f

    f = problem.initial_state()
    for _ in range(steps // 500):
        f = many(f)
    rho, u = physics.moments(D2Q9, f)
    return params, np.asarray(u[0])


@pytest.mark.slow
def test_poiseuille_profile_rmse():
    params, ux = _run_poiseuille()
    # x-invariance (periodic channel)
    assert np.abs(ux - ux[:, :1]).max() < 1e-10
    profile = ux[:, 0]
    analytic = analytic_profile(params)
    umax = analytic.max()
    rmse = np.sqrt(np.mean((profile - analytic) ** 2))
    # absolute gate (SURVEY §4) and a relative one so the test is meaningful
    assert rmse < 0.005, (rmse, umax)
    assert rmse / umax < 0.02, (rmse, umax)
    # symmetry about the centerline
    np.testing.assert_allclose(profile, profile[::-1], rtol=1e-8)


@pytest.mark.slow
def test_poiseuille_profile_rmse_f32():
    # the f32 production dtype must pass the same physics gate
    params, ux = _run_poiseuille(precision="f32", steps=12000)
    profile = ux[:, 0].astype(np.float64)
    analytic = analytic_profile(params)
    rmse = np.sqrt(np.mean((profile - analytic) ** 2))
    assert rmse < 0.005
    assert rmse / analytic.max() < 0.02
