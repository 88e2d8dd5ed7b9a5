"""Non-Newtonian power-law rheology: Newtonian degeneracy, conservation,
the analytic power-law Poiseuille gate (shear-thinning and -thickening),
and config validation.

New capability — the reference is strictly Newtonian (constant tau,
LBMConfig.h:38). nu(γ̇) = k γ̇^(n-1) with the truncated-power-law clamps of
physics.power_law_inv_tau."""
import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams, validate_params
from tpulbm.lattice import D2Q9, D3Q19
from tpulbm.models import make_problem
from tpulbm.models.poiseuille import analytic_profile_power_law
from tpulbm.ops.step_jax import make_step_rolled


def _random_f(lat, shape, seed=0, eps=0.02):
    rng = np.random.default_rng(seed)
    W = lat.w.reshape((lat.Q,) + (1,) * len(shape))
    return np.asarray(W * (1.0 + eps * rng.standard_normal((lat.Q,) + shape)),
                      np.float64)


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["d2q9", "d3q19"])
def test_newtonian_limit_is_bgk(lat):
    # n = 1: nu = k constant, so the collision must equal plain BGK at
    # tau = 1/2 + 3k
    shape = (4, 4) if lat.D == 2 else (3, 4, 4)
    f = _random_f(lat, shape, seed=1)
    k = 0.1 / 3.0
    bgk = physics.collide(lat, f, 1.0 / (0.5 + 3.0 * k))
    plaw = physics.collide_power_law(lat, f, k, 1.0)
    np.testing.assert_allclose(np.asarray(plaw), np.asarray(bgk),
                               rtol=1e-13, atol=1e-16)


def test_power_law_conserves_mass_momentum():
    f = _random_f(D2Q9, (6, 6), seed=3)
    rho0, u0 = physics.moments(D2Q9, f)
    f1 = physics.collide_power_law(D2Q9, f, 0.02, 0.5)
    rho1, u1 = physics.moments(D2Q9, f1)
    np.testing.assert_allclose(np.asarray(rho1), np.asarray(rho0), atol=1e-13)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), atol=1e-12)


def test_fixed_point_satisfied():
    # the Picard iterate must satisfy tau = 1/2 + 3 k gamma(tau)^(n-1)
    # wherever the clamps are inactive
    f = _random_f(D2Q9, (8, 8), seed=4, eps=0.05)
    rho, u = physics.moments(D2Q9, f)
    devs = f - np.asarray(physics.equilibrium(D2Q9, rho, u))
    k, n = 0.03, 0.7
    inv_t = np.asarray(physics.power_law_inv_tau(
        D2Q9, 1.0 / np.asarray(rho), devs, k, n), np.float64)
    tau = 1.0 / inv_t
    c = D2Q9.c.astype(np.float64)
    pi = np.einsum("ia,ib,i...->ab...", c, c, np.asarray(devs, np.float64))
    qbar = np.sqrt(2.0 * np.einsum("ab...,ab...->...", pi, pi))
    gam = 1.5 * qbar / np.asarray(rho) / tau
    resid = tau - (0.5 + 3.0 * k * gam ** (n - 1.0))
    interior = (tau > physics.PLAW_TAU_MIN + 1e-6) & \
               (tau < physics.PLAW_TAU_MAX - 1e-6)
    assert interior.any()
    assert np.max(np.abs(resid[interior])) < 2e-4
    # a clamped cell must be clamped for a reason: the true root has to lie
    # at or beyond the clamp, i.e. h(TAU_MIN) >= 0 on low-clamped cells and
    # h(TAU_MAX) <= 0 on high-clamped cells (h(t) = t - 1/2 - 3k γ̇(t)^(n-1))
    def h_at(t):
        gam_t = np.maximum(1.5 * qbar / np.asarray(rho) / t,
                           physics.PLAW_GAMMA_FLOOR)
        return t - 0.5 - 3.0 * k * gam_t ** (n - 1.0)
    lo = tau <= physics.PLAW_TAU_MIN + 1e-6
    hi = tau >= physics.PLAW_TAU_MAX - 1e-6
    assert np.all(h_at(physics.PLAW_TAU_MIN)[lo] >= -1e-6)
    assert np.all(h_at(physics.PLAW_TAU_MAX)[hi] <= 1e-6)


def _true_tau(gfac, k, n):
    """Reference root of (tau-1/2) tau^(n-1) = 3k gfac^(n-1) by bisection
    (the function is strictly increasing in tau for every n > 0)."""
    g = max(gfac, physics.PLAW_GAMMA_FLOOR)
    lo, hi = physics.PLAW_TAU_MIN, physics.PLAW_TAU_MAX
    def h(t):
        return (t - 0.5) * t ** (n - 1.0) - 3.0 * k * g ** (n - 1.0)
    if h(lo) >= 0:
        return lo
    if h(hi) <= 0:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if h(mid) > 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def test_low_shear_shear_thinning_hits_the_high_clamp():
    """Regression for the tau-space Newton bug: for n < 1 at low shear the
    apparent viscosity DIVERGES, so tau must run to the truncated-power-law
    HIGH clamp (or the interior root), never to TAU_MIN. The original
    tau-space iteration had h' < 0 there and drove every low-shear cell to
    the minimum-viscosity clamp — the exact opposite physics."""
    k, n = 4.04e-3, 0.5
    gfacs = np.array([0.0, 1e-5, 4.9e-5, 1e-3, 1e-1], np.float64)
    got = 1.0 / np.asarray(
        physics.power_law_inv_tau_from_gfac(gfacs, k, n), np.float64)
    want = np.array([_true_tau(g, k, n) for g in gfacs])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(physics.PLAW_TAU_MAX)  # zero shear
    assert got[2] > 3.5  # the reviewer-verified case: root ~3.93, not 0.5005

    # shear-thickening mirror: low shear drives nu -> 0, tau -> TAU_MIN
    k2, n2 = 1.67, 1.5
    gfacs2 = np.array([0.0, 1e-8, 1e-3, 1e-1], np.float64)
    got2 = 1.0 / np.asarray(
        physics.power_law_inv_tau_from_gfac(gfacs2, k2, n2), np.float64)
    want2 = np.array([_true_tau(g, k2, n2) for g in gfacs2])
    np.testing.assert_allclose(got2, want2, rtol=1e-6)


def _run_plaw_poiseuille(ny, n, k, F, steps):
    params = SimulationParams(nx=16, ny=ny, tau=0.8, problem="poiseuille",
                              periodic_x=True, body_force=(F, 0.0),
                              inlet_velocity=0.0, precision="f64",
                              power_law_n=n, power_law_k=k)
    problem = make_problem(params)
    assert problem.power_law == (k, n)
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    for _ in range(steps // 500):
        for _ in range(500):
            f = step(f)
        f = jax.block_until_ready(f)
    rho, u = physics.moments(D2Q9, f)
    return params, np.asarray(u[0])[:, 0]


@pytest.mark.slow
@pytest.mark.parametrize("n,k,F,steps", [
    (0.5, 4.04e-3, 2.84e-5, 12000),   # shear-thinning
    (1.5, 1.67, 3.16e-5, 16000),      # shear-thickening
], ids=["n0.5", "n1.5"])
def test_power_law_poiseuille_profile(n, k, F, steps):
    params, profile = _run_plaw_poiseuille(24, n, k, F, steps)
    analytic = analytic_profile_power_law(params)
    umax = analytic.max()
    assert 0.01 < umax < 0.05  # parameters keep the flow comfortably subsonic
    rmse = np.sqrt(np.mean((profile - analytic) ** 2))
    assert rmse / umax < 0.04, (rmse, umax, n)
    np.testing.assert_allclose(profile, profile[::-1], rtol=1e-8)


# Tolerance note: unlike the closed-form LES root (rtol 5e-6 in
# test_les.py), the Newton solve amplifies last-ulp f32 differences in its
# qbar/moment inputs between the tiers (the root's sensitivity to the
# stress norm is O(tau/qbar)), so a small fraction of cells lands ~1e-5
# apart. 1e-4 is the honest gate for an iterative per-cell solve in f32.
_PLAW_RTOL = 1e-4


def test_config_validation():
    validate_params(SimulationParams(power_law_n=0.5))
    with pytest.raises(ValueError, match="bgk"):
        validate_params(SimulationParams(power_law_n=0.5, collision="mrt"))
    with pytest.raises(ValueError, match="at most one"):
        validate_params(SimulationParams(power_law_n=0.5, smagorinsky=0.17))
    with pytest.raises(ValueError, match="> 0"):
        validate_params(SimulationParams(power_law_n=-1.0))
    with pytest.raises(ValueError, match="thermal"):
        validate_params(SimulationParams(power_law_n=0.5, thermal_tau=0.6))
    # k = 0 derives the consistency index from tau
    p = SimulationParams(tau=0.8, power_law_n=0.5)
    assert p.power_law() == (p.nu(), 0.5)
    assert SimulationParams(power_law_n=1.0).power_law() is None
