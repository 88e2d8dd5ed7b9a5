"""Regularized BGK collision (physics.collide_regularized): Hermite-shell
projection of the non-equilibrium before relaxing (Latt & Chopard 2006).
New capability — the reference is plain BGK (LBMSolver.h:101-123).

Gates: exact conservation; exact BGK degeneracy for states whose
non-equilibrium already lies in the shell (the projection is idempotent);
viscosity unchanged (Poiseuille parabola); stabilization of an
under-resolved cylinder that diverges under BGK.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9, D3Q19, D3Q27
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled


@pytest.mark.parametrize("lat", [D2Q9, D3Q19, D3Q27],
                         ids=["d2q9", "d3q19", "d3q27"])
def test_conservation_and_shell_degeneracy(lat):
    rng = np.random.default_rng(0)
    shape = (lat.Q,) + ((6, 8) if lat.D == 2 else (4, 6, 8))
    rho = 1.0 + 0.02 * rng.standard_normal(shape[1:])
    u = 0.05 * rng.standard_normal((lat.D,) + shape[1:])
    feq = np.asarray(physics.equilibrium(lat, jnp.asarray(rho),
                                         jnp.asarray(u)))
    f = feq + 1e-3 * rng.standard_normal(shape)
    inv_tau = 1.0 / 0.6
    fp = np.asarray(physics.collide_regularized(lat, jnp.asarray(f),
                                                inv_tau))
    # mass and momentum preserved to machine precision
    r0, u0 = physics.moments(lat, jnp.asarray(f))
    r1, u1 = physics.moments(lat, jnp.asarray(fp))
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r0), atol=1e-14)
    np.testing.assert_allclose(np.asarray(r1)[None] * np.asarray(u1),
                               np.asarray(r0)[None] * np.asarray(u0),
                               atol=1e-14)
    # a non-equilibrium already in the second Hermite shell is a fixed
    # point of the projection — regularized == plain BGK there, exactly
    c = lat.c.astype(np.float64)
    A = (np.array([[1.0, 0.3], [0.3, -0.5]]) if lat.D == 2 else
         np.array([[1.0, 0.3, 0.1], [0.3, -0.5, 0.2], [0.1, 0.2, -0.5]]))
    Qi = np.einsum("qa,qb->qab", c, c) - np.eye(lat.D) / 3.0
    shell = 4.5 * lat.w * np.einsum("qab,ab->q", Qi, A)
    f2 = feq + 1e-3 * shell.reshape((lat.Q,) + (1,) * lat.D)
    fp_reg = np.asarray(physics.collide_regularized(lat, jnp.asarray(f2),
                                                    inv_tau))
    fp_bgk = np.asarray(physics.collide(lat, jnp.asarray(f2), inv_tau))
    np.testing.assert_allclose(fp_reg, fp_bgk, atol=1e-13)


@pytest.mark.slow
def test_viscosity_unchanged_poiseuille():
    # the projection must not touch the shear viscosity: the analytic
    # parabola gate at the same tolerance as BGK (tests/test_poiseuille.py)
    from tpulbm.models.poiseuille import analytic_profile
    params = SimulationParams(nx=32, ny=32, tau=0.8, problem="poiseuille",
                              periodic_x=True, body_force=(2e-6, 0.0),
                              inlet_velocity=0.0, precision="f64",
                              collision="regularized")
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))
    f = jnp.asarray(problem.initial_state())
    f = jax.lax.fori_loop(0, 12000, lambda _, x: step(x), f)
    rho, u = physics.moments(D2Q9, f)
    profile = np.asarray(u[0])[:, 0]
    analytic = analytic_profile(params)
    rmse = np.sqrt(np.mean((profile - analytic) ** 2))
    assert rmse < 0.005 and rmse / analytic.max() < 0.02, rmse


@pytest.mark.slow
def test_regularized_stabilizes_double_shear_layer():
    # the canonical demonstrator (Latt & Chopard; Minion & Brown's thin
    # double shear layer): doubly-periodic, 128², Re = 30,000 — plain BGK
    # diverges within 8k steps, the regularized operator runs stably with
    # NO eddy viscosity added. (The cylinder benchmark is the wrong probe
    # here: its blow-up at low tau is driven by the open Zou-He edges,
    # which bulk ghost-mode filtering cannot fix — measured: both
    # operators share the same tau edge there.)
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
    assert run(physics.collide_regularized), \
        "regularization failed to stabilize the shear layer"

