"""KBC entropic multi-relaxation collision (physics.collide_kbc; Bösch,
Chikatamarla & Karlin 2015, natural-moment N model). New capability — the
reference is plain BGK (LBMSolver.h:101-123).

Gates: the projector algebra is exact (complementary idempotents,
conservation to machine precision); the operator degenerates EXACTLY to
BGK when the higher-order deviation vanishes and at equilibrium; shear
viscosity is untouched (Taylor-Green ν_eff); the canonical Re = 30,000
double shear layer that diverges under BGK runs stably."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams, validate_params
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled


def test_projector_algebra_and_conservation():
    S, H = physics.kbc_projectors(D2Q9)
    # complementary idempotents spanning the non-conserved subspace
    np.testing.assert_allclose(S @ S, S, atol=1e-13)
    np.testing.assert_allclose(H @ H, H, atol=1e-13)
    np.testing.assert_allclose(S @ H, np.zeros((9, 9)), atol=1e-13)
    rng = np.random.default_rng(1)
    f = jnp.asarray(0.1 + 0.02 * rng.random((9, 6, 8)))
    fp = physics.collide_kbc(D2Q9, f, 1.0 / 0.57)
    r0, u0 = physics.moments(D2Q9, f)
    r1, u1 = physics.moments(D2Q9, fp)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r0), atol=1e-14)
    np.testing.assert_allclose(np.asarray(r1)[None] * np.asarray(u1),
                               np.asarray(r0)[None] * np.asarray(u0),
                               atol=1e-14)


def test_bgk_degeneracy():
    """With no higher-order deviation (Δh = 0) the operator IS BGK; at
    equilibrium it is a fixed point."""
    rng = np.random.default_rng(2)
    rho = jnp.asarray(1.0 + 0.02 * rng.standard_normal((6, 8)))
    u = jnp.asarray(0.04 * rng.standard_normal((2, 6, 8)))
    feq = physics.equilibrium(D2Q9, rho, u)
    inv_tau = 1.0 / 0.6
    S, _ = physics.kbc_projectors(D2Q9)
    dneq = jnp.asarray(1e-3 * rng.standard_normal((9, 6, 8)))
    f_s = feq + jnp.tensordot(jnp.asarray(S), dneq, axes=(1, 0))
    kbc = np.asarray(physics.collide_kbc(D2Q9, f_s, inv_tau))
    r2, u2 = physics.moments(D2Q9, f_s)
    bgk = np.asarray(f_s - inv_tau * (f_s - physics.equilibrium(D2Q9, r2,
                                                                u2)))
    np.testing.assert_allclose(kbc, bgk, atol=1e-13)
    np.testing.assert_allclose(np.asarray(physics.collide_kbc(
        D2Q9, feq, inv_tau)), np.asarray(feq), atol=1e-13)


def test_viscosity_unchanged_taylor_green():
    """The shear part always relaxes at 1/τ, so ν_eff must equal
    (τ − ½)/3 on the exact-NS Taylor-Green decay."""
    from jax import lax
    params = SimulationParams(nx=64, ny=64, tau=0.8,
                              problem="taylor-green", collision="kbc",
                              inlet_velocity=0.04, periodic_x=True,
                              cylinder_radius=0.0, precision="f64")
    pr = make_problem(params)
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())

    def energy(g):
        rho, u = physics.moments(D2Q9, g)
        return float(jnp.sum(rho * (u[0] ** 2 + u[1] ** 2)))

    e0 = energy(f)
    steps = 400
    f = lax.fori_loop(0, steps, lambda i, x: step(x), f)
    e1 = energy(f)
    k2 = 2.0 * (2.0 * np.pi / 64.0) ** 2
    nu_eff = -np.log(e1 / e0) / (2.0 * k2 * steps)
    assert abs(nu_eff / params.nu() - 1.0) < 2e-3, nu_eff


@pytest.mark.slow
def test_kbc_stabilizes_double_shear_layer():
    """Canonical stability probe (same as test_regularized): 128² doubly
    periodic Minion-Brown shear layer at Re = 30,000 — BGK diverges
    within 8k steps, KBC runs it stably with ν untouched."""
    from jax import lax

    def run(collide, steps=8000, n=128, u0=0.04, re=30000.0):
        nu = u0 * n / re
        inv_tau = 1.0 / (3.0 * nu + 0.5)
        xs = (np.arange(n) + 0.5) / n
        X, Y = np.meshgrid(xs, xs)
        k, delta = 80.0, 0.05
        ux = np.where(Y <= 0.5, u0 * np.tanh(k * (Y - 0.25)),
                      u0 * np.tanh(k * (0.75 - Y)))
        uy = delta * u0 * np.sin(2 * np.pi * (X + 0.25))
        u = jnp.asarray(np.stack([ux, uy]), jnp.float32)
        f = physics.equilibrium(D2Q9, jnp.ones((n, n), jnp.float32), u)
        c = D2Q9.c

        def step(f):
            fp = collide(D2Q9, f, inv_tau)
            return jnp.stack([jnp.roll(fp[i], (int(c[i, 1]), int(c[i, 0])),
                                       (0, 1)) for i in range(9)])

        f = lax.fori_loop(0, steps, lambda i, x: step(x), f)
        return bool(physics.is_stable(f))

    assert not run(physics.collide), "BGK unexpectedly stable — raise Re"
    assert run(physics.collide_kbc), \
        "KBC failed to stabilize the shear layer"


def test_kbc_rejected_in_3d():
    with pytest.raises(ValueError, match="D2Q9"):
        validate_params(SimulationParams(nx=32, ny=16, nz=16,
                                         problem="cylinder3d",
                                         collision="kbc", tau=0.6,
                                         inlet_velocity=0.05))
