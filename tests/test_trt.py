"""TRT collision operator (new capability; the reference is BGK-only)."""
import jax
import jax.numpy as jnp
import numpy as np

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled


def test_trt_conserves_mass_momentum():
    rng = np.random.default_rng(2)
    f = jnp.asarray(np.abs(rng.standard_normal((9, 8, 8))) * 0.1 + 0.05)
    f_post = physics.collide_trt(D2Q9, f, inv_tau=1.0 / 0.55)
    rho0, u0 = physics.moments(D2Q9, f)
    rho1, u1 = physics.moments(D2Q9, f_post)
    np.testing.assert_allclose(np.asarray(rho1), np.asarray(rho0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), atol=1e-12)


def test_trt_reduces_to_bgk_at_lambda_plus_squared():
    # omega- == omega+ exactly when magic = lambda_plus^2
    tau = 0.71
    lam = tau - 0.5
    rng = np.random.default_rng(3)
    f = jnp.asarray(np.abs(rng.standard_normal((9, 6, 6))) * 0.1 + 0.05)
    bgk = physics.collide(D2Q9, f, 1.0 / tau)
    trt = physics.collide_trt(D2Q9, f, 1.0 / tau, magic=lam * lam)
    np.testing.assert_allclose(np.asarray(trt), np.asarray(bgk), rtol=1e-12,
                               atol=1e-15)


def test_trt_rest_equilibrium_fixed_point():
    W = physics.rest_equilibrium(D2Q9)
    f = jnp.asarray(np.broadcast_to(W[:, None, None], (9, 4, 4)).copy())
    f_post = physics.collide_trt(D2Q9, f, inv_tau=1.0 / 0.52)
    np.testing.assert_allclose(np.asarray(f_post), np.asarray(f), atol=1e-15)


def test_trt_poiseuille_viscosity():
    # TRT must reproduce the BGK viscosity nu=(tau-1/2)/3 (the even-moment
    # rate sets it): body-force channel converges to a parabola with
    # curvature F/(2 nu); the wall intercept may shift (that is what the
    # magic parameter controls), so fit with free wall positions.
    params = SimulationParams(nx=32, ny=32, tau=0.8, problem="poiseuille",
                              periodic_x=True, body_force=(2e-6, 0.0),
                              inlet_velocity=0.0, precision="f64",
                              collision="trt")
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    for _ in range(12000):
        f = step(f)
    assert bool(physics.is_stable(f))
    rho, u = physics.moments(D2Q9, f)
    profile = np.asarray(u[0])[:, 0]
    coef = np.polyfit(np.arange(32), profile, 2)
    F, nu = 2e-6, params.nu()
    np.testing.assert_allclose(-coef[0], F / (2 * nu), rtol=1e-3)
    # fit residual tiny → truly parabolic
    resid = profile - np.polyval(coef, np.arange(32))
    assert np.abs(resid).max() < 1e-8

