"""MRT collision operator (new capability; the reference is BGK-only).

The operator is applied population-space as f − R (f − feq) with
R = M⁻¹ S M precomputed (physics.mrt_relax_matrix), in the XLA tier. Key invariant gated here: with
every relaxation rate set to 1/tau, R = (1/tau)·I and MRT IS BGK — which
validates M, M⁻¹ and the rate plumbing in one shot; the Poiseuille gate
then pins the shear rates to the BGK viscosity nu = (tau − 1/2)/3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9, D3Q19
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled


def _uniform_overrides(lat, inv_tau):
    """Every ghost moment forced to 1/tau (shear already is; conserved
    deviations are identically zero) → MRT degenerates to BGK."""
    return {n: inv_tau for n in physics._MRT_GHOST_RATES[lat.D]}


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["d2q9", "d3q19"])
def test_mrt_basis_orthogonal_and_invertible(lat):
    M, names = physics._mrt_basis(lat)
    assert M.shape == (lat.Q, lat.Q)
    assert len(names) == lat.Q
    gram = M @ M.T
    assert np.allclose(gram, np.diag(np.diag(gram)))
    assert np.all(np.diag(gram) > 0)
    # conserved moments are untouched by the relaxation: M_c R = S_c M_c = 0
    inv_tau = 1.0 / 0.63
    R = physics.mrt_relax_matrix(lat, inv_tau)
    cons = [k for k, n in enumerate(names) if n in physics._MRT_CONSERVED]
    np.testing.assert_allclose(M[cons] @ R, 0.0, atol=1e-11)
    # and with uniform rates, R acts as scalar relaxation on every
    # zero-mass/momentum deviation vector (the only vectors it ever sees)
    Ru = physics.mrt_relax_matrix(lat, inv_tau,
                                  overrides=_uniform_overrides(lat, inv_tau))
    rng = np.random.default_rng(11)
    v = rng.standard_normal(lat.Q)
    # project out the conserved components
    Minv = np.linalg.inv(M)
    mv = M @ v
    mv[cons] = 0.0
    d = Minv @ mv
    np.testing.assert_allclose(Ru @ d, inv_tau * d, atol=1e-12)


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["d2q9", "d3q19"])
def test_mrt_uniform_rates_is_bgk(lat):
    tau = 0.71
    rng = np.random.default_rng(5)
    shape = (lat.Q, 6, 6) if lat.D == 2 else (lat.Q, 4, 6, 6)
    f = jnp.asarray(np.abs(rng.standard_normal(shape)) * 0.1 + 0.05)
    bgk = physics.collide(lat, f, 1.0 / tau)
    mrt = physics.collide_mrt(lat, f, 1.0 / tau,
                              overrides=_uniform_overrides(lat, 1.0 / tau))
    np.testing.assert_allclose(np.asarray(mrt), np.asarray(bgk), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["d2q9", "d3q19"])
def test_mrt_conserves_mass_momentum(lat):
    rng = np.random.default_rng(7)
    shape = (lat.Q, 8, 8) if lat.D == 2 else (lat.Q, 4, 8, 8)
    f = jnp.asarray(np.abs(rng.standard_normal(shape)) * 0.1 + 0.05)
    f_post = physics.collide_mrt(lat, f, inv_tau=1.0 / 0.55)
    rho0, u0 = physics.moments(lat, f)
    rho1, u1 = physics.moments(lat, f_post)
    np.testing.assert_allclose(np.asarray(rho1), np.asarray(rho0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), atol=1e-12)


def test_mrt_rest_equilibrium_fixed_point():
    W = physics.rest_equilibrium(D2Q9)
    f = jnp.asarray(np.broadcast_to(W[:, None, None], (9, 4, 4)).copy())
    f_post = physics.collide_mrt(D2Q9, f, inv_tau=1.0 / 0.52)
    np.testing.assert_allclose(np.asarray(f_post), np.asarray(f), atol=1e-15)


def test_mrt_rates_validation():
    with pytest.raises(ValueError, match="unknown MRT moments"):
        physics.mrt_rates(D2Q9, 1.0, overrides={"nope": 1.0})
    # conserved moments pinned to 0, shear to 1/tau
    rates = physics.mrt_rates(D2Q9, 1.7)
    _, names = physics._mrt_basis(D2Q9)
    by_name = dict(zip(names, rates))
    assert by_name["rho"] == by_name["jx"] == by_name["jy"] == 0.0
    assert by_name["pxx"] == by_name["pxy"] == 1.7
    # D2Q9 energy-flux rates default to the shear rate (boundary-feedback
    # stability — see physics._MRT_GHOST_RATES note), and overrides stick
    assert by_name["qx"] == by_name["qy"] == 1.7
    ov = dict(zip(names, physics.mrt_rates(D2Q9, 1.7, {"qx": 1.2})))
    assert ov["qx"] == 1.2 and ov["qy"] == 1.7


def test_mrt_rates_cli_and_problem_plumbing():
    import argparse
    from tpulbm.config import add_cli_args, params_from_args
    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    args = parser.parse_args(["--collision", "mrt",
                              "--mrt-rates", "e=1.5,qx=1.2"])
    params = params_from_args(args)
    assert params.mrt_rates == (("e", 1.5), ("qx", 1.2))
    problem = make_problem(params)
    assert problem.mrt_rates == (("e", 1.5), ("qx", 1.2))
    # the overrides must actually change the population-space matrix
    R0 = physics.mrt_relax_matrix(D2Q9, 1.0 / params.tau)
    R1 = physics.mrt_relax_matrix(D2Q9, 1.0 / params.tau,
                                  overrides=dict(params.mrt_rates))
    assert not np.allclose(R0, R1)
    # JSON round trip keeps the tuple-of-pairs shape
    assert SimulationParams.from_json(params.to_json()).mrt_rates == \
        params.mrt_rates
    # --mrt-rates without collision=mrt is a silent no-op → rejected
    args2 = parser.parse_args(["--mrt-rates", "e=1.5"])
    with pytest.raises(ValueError, match="only applies"):
        params_from_args(args2)


@pytest.mark.slow
def test_mrt_default_rates_stable_on_cylinder_bcs():
    """Regression gate for the boundary-feedback instability: the
    reference-parity BC chain (Zou-He columns over full wall rows + zeroed
    x-ghost columns) re-injects non-equilibrium at the inlet/outlet corners
    every step. With the literature q-rate 1.9 this flow NaNs by t≈420
    (measured, 512x128 f64 tau=0.5768); the shipped default (q = shear
    rate) must ride through it."""
    params = SimulationParams(nx=256, ny=64, tau=0.5768, inlet_velocity=0.05,
                              cylinder_x=0.2, cylinder_y=0.5,
                              cylinder_radius=0.05, precision="f64",
                              collision="mrt")
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    for _ in range(2000):
        f = step(f)
    assert bool(physics.is_stable(f))
    rho, u = physics.moments(D2Q9, f)
    mv = float(jnp.max(jnp.sqrt(u[0] ** 2 + u[1] ** 2)))
    assert mv < 0.25  # bounded flow, not a slowly-growing blow-up


def test_mrt_poiseuille_viscosity():
    # The shear moments relax at 1/tau, so MRT must reproduce the BGK
    # viscosity nu = (tau - 1/2)/3 regardless of the ghost-moment rates:
    # body-force channel converges to a parabola with curvature F/(2 nu).
    params = SimulationParams(nx=32, ny=32, tau=0.8, problem="poiseuille",
                              periodic_x=True, body_force=(2e-6, 0.0),
                              inlet_velocity=0.0, precision="f64",
                              collision="mrt")
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
    resid = profile - np.polyval(coef, np.arange(32))
    assert np.abs(resid).max() < 1e-8

