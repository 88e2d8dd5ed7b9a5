"""Smagorinsky LES closure: closed-form tau_eff, BGK degeneracy, config
validation, and the stabilization gate.

New capability — the reference has no turbulence model (its BGK at
tau -> 1/2 simply diverges; README.md §4 documents the unstable nominal
Re=200 point)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams, validate_params
from tpulbm.lattice import D2Q9, D3Q19
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled


def _random_f(lat, shape, seed=0, eps=0.02):
    rng = np.random.default_rng(seed)
    W = lat.w.reshape((lat.Q,) + (1,) * len(shape))
    return jnp.asarray(W * (1.0 + eps * rng.standard_normal((lat.Q,) + shape)))


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["d2q9", "d3q19"])
def test_tau_eff_closed_form(lat):
    # the helper must satisfy its defining quadratic:
    # cs2 (tau_eff - tau0) == Cs^2 * Qbar / (2 rho cs2 tau_eff)
    shape = (4, 4) if lat.D == 2 else (3, 4, 4)
    f = _random_f(lat, shape, seed=1)
    rho, u = physics.moments(lat, f)
    devs = f - physics.equilibrium(lat, rho, u)
    inv_tau0, cs = 1.0 / 0.53, 0.17
    inv_t = physics.smagorinsky_inv_tau(lat, 1.0 / rho, devs, inv_tau0, cs)
    # independent Qbar via dense einsum
    c = lat.c.astype(np.float64)
    pi = np.einsum("ia,ib,i...->ab...", c, c, np.asarray(devs, np.float64))
    qbar = np.sqrt(2.0 * np.einsum("ab...,ab...->...", pi, pi))
    tau_eff = 1.0 / np.asarray(inv_t, np.float64)
    lhs = (tau_eff - 1.0 / inv_tau0) / 3.0
    rhs = cs * cs * qbar / (2.0 * np.asarray(rho) * (1.0 / 3.0) * tau_eff)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-16)
    # tau_eff >= tau0 everywhere (the model only adds dissipation)
    assert np.all(tau_eff >= 1.0 / inv_tau0 - 1e-12)


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["d2q9", "d3q19"])
def test_zero_cs_or_zero_shear_is_bgk(lat):
    shape = (4, 4) if lat.D == 2 else (3, 4, 4)
    f = _random_f(lat, shape, seed=2)
    bgk = physics.collide(lat, f, 1.0 / 0.6)
    les0 = physics.collide_smagorinsky(lat, f, 1.0 / 0.6, 0.0)
    np.testing.assert_allclose(np.asarray(les0), np.asarray(bgk),
                               rtol=1e-13, atol=1e-16)
    # at exact equilibrium the deviations vanish, so any Cs gives BGK
    rho, u = physics.moments(lat, f)
    feq = physics.equilibrium(lat, rho, u)
    np.testing.assert_allclose(
        np.asarray(physics.collide_smagorinsky(lat, feq, 1.0 / 0.6, 0.17)),
        np.asarray(physics.collide(lat, feq, 1.0 / 0.6)),
        rtol=1e-13, atol=1e-16)


def test_les_conserves_mass_momentum():
    f = _random_f(D2Q9, (6, 6), seed=3)
    rho0, u0 = physics.moments(D2Q9, f)
    f1 = physics.collide_smagorinsky(D2Q9, f, 1.0 / 0.55, 0.17)
    rho1, u1 = physics.moments(D2Q9, f1)
    np.testing.assert_allclose(np.asarray(rho1), np.asarray(rho0), atol=1e-13)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), atol=1e-12)


def test_config_validation():
    validate_params(SimulationParams(smagorinsky=0.17))
    with pytest.raises(ValueError, match="bgk"):
        validate_params(SimulationParams(smagorinsky=0.17, collision="trt"))
    with pytest.raises(ValueError, match=">= 0"):
        validate_params(SimulationParams(smagorinsky=-0.1))


@pytest.mark.slow
def test_les_stabilizes_underresolved_cylinder():
    """The headline property: at tau = 0.503 / u = 0.1 (cylinder Re ~ 1,900
    at 256x64 — far under-resolved) plain BGK diverges; the Smagorinsky
    closure keeps the identical configuration stable. This is a regime the
    reference cannot reach at any setting (README.md §4's Re=200 nominal
    point already diverges for it)."""
    def run(cs):
        params = SimulationParams(nx=256, ny=64, tau=0.503,
                                  inlet_velocity=0.1, precision="f32",
                                  smagorinsky=cs)
        problem = make_problem(params)
        step = jax.jit(make_step_rolled(problem))
        f = jnp.asarray(problem.initial_state())
        f = jax.lax.fori_loop(0, 4000, lambda _, x: step(x), f)
        return bool(physics.is_stable(f))

    assert not run(0.0), "BGK unexpectedly stable — tighten tau in this test"
    assert run(0.17), "LES failed to stabilize the under-resolved cylinder"
