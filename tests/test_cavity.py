"""Lid-driven cavity model: moving-wall BC, and
the Ghia, Ghia & Shin (1982) benchmark structure at Re=100.

New capability — the reference hard-codes the cylinder channel
(LBMGrid.h:104-127) and has no moving-wall BC (LBMSolver.h:153-176 are all
stationary reflections)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import PRESETS, SimulationParams
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.models.cavity import tau_for_cavity_reynolds
from tpulbm.ops.step_jax import make_step_rolled


def _params(n=64, re=100.0, u=0.1, **kw):
    return SimulationParams(nx=n, ny=n, inlet_velocity=u,
                            tau=tau_for_cavity_reynolds(re, u, n),
                            problem="cavity", cylinder_radius=0.0, **kw)


def test_cavity_requires_square():
    with pytest.raises(ValueError, match="square"):
        make_problem(_params().replace(nx=32))


def test_cavity_problem_layout():
    p = make_problem(_params())
    assert p.walls_x and p.walls_y and not p.periodic_x
    assert p.lid_u == 0.1 and p.solid is None
    assert not p.inlet_zou_he and not p.outlet_zou_he
    assert "cavity" in PRESETS and PRESETS["cavity"].problem == "cavity"


def test_moving_wall_reduces_to_plain_wall_at_zero_speed():
    from tpulbm.ops import boundaries
    rng = np.random.default_rng(2)
    f = [jnp.asarray(np.abs(rng.standard_normal((8, 8))) + 0.1)
         for _ in range(9)]
    yy = np.arange(8)[:, None]
    a = [x for x in f]
    b = [x for x in f]
    boundaries.apply_walls(D2Q9, a, yy == 7, 1, -1, None)
    boundaries.apply_moving_wall(D2Q9, b, yy == 7, 1, -1, (0.0,), None)
    for pa, pb in zip(a, b):
        np.testing.assert_allclose(np.asarray(pa), np.asarray(pb))


def test_moving_wall_momentum_correction_values():
    # top lid moving +x at U: f4 <- f2 (no correction), f7 <- f5 - rho U/6,
    # f8 <- f6 + rho U/6 (w7 = w8 = 1/36, 6 w cu = U/6)
    from tpulbm.ops import boundaries
    rng = np.random.default_rng(4)
    f = [jnp.asarray(np.abs(rng.standard_normal((4, 4))) + 0.1)
         for _ in range(9)]
    # Zou-He-style wall density from known (cy >= 0) populations only
    rho = np.asarray(f[0] + f[1] + f[3] + 2.0 * (f[2] + f[5] + f[6]))
    yy = np.arange(4)[:, None]
    out = [x for x in f]
    U = 0.07
    boundaries.apply_moving_wall(D2Q9, out, yy == 3, 1, -1, (U,), None)
    np.testing.assert_allclose(np.asarray(out[4])[3], np.asarray(f[2])[3])
    np.testing.assert_allclose(
        np.asarray(out[7])[3],
        np.asarray(f[5])[3] - U / 6.0 * rho[3], rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(out[8])[3],
        np.asarray(f[6])[3] + U / 6.0 * rho[3], rtol=1e-12)
    # rows below the wall untouched
    np.testing.assert_allclose(np.asarray(out[7])[:3], np.asarray(f[7])[:3])


def test_cavity_rest_state_is_fixed_point():
    # closed stationary box at uniform equilibrium must stay there exactly:
    # gates the corner closure (the plain sequential wall reflections leak
    # 2 w_diag per corner per step through the zeroed-ghost chain —
    # measured 0.222/step on an 8x8 box before the closure)
    params = SimulationParams(nx=16, ny=16, inlet_velocity=0.0, tau=0.8,
                              problem="cavity", cylinder_radius=0.0,
                              precision="f64")
    problem = make_problem(params)
    assert problem.closed_box
    step = jax.jit(make_step_rolled(problem))
    f0 = jnp.asarray(problem.initial_state())
    f = f0
    for _ in range(40):
        f = step(f)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f0), atol=1e-14)


def test_cavity_step_homogeneity_and_runner_renorm(tmp_path):
    # step(lam f) = lam step(f): the LBM step is homogeneous degree-1 in f,
    # which is what makes the runner's closed-box mass renormalization an
    # exact gauge operation (u bit-unaffected)
    params = _params(n=24, precision="f64")
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))
    f = jnp.asarray(problem.initial_state())
    for _ in range(30):
        f = step(f)
    lam = 0.7
    np.testing.assert_allclose(np.asarray(step(lam * f)),
                               lam * np.asarray(step(f)),
                               rtol=1e-12, atol=1e-15)
    # end-to-end: the runner holds total mass at m0 (the on-node wall
    # reflections alone drift ~2e-6/step with flow)
    from tpulbm.runner import Runner
    from tpulbm.utils import checkpoint
    rp = _params(n=24, precision="f64").replace(
        num_timesteps=800, output_frequency=100, enable_vtk=False,
        checkpoint_every=1, output_dir=str(tmp_path))
    res = Runner(rp, verbose=False).run(resume=False)
    assert res.success
    found = checkpoint.latest(str(tmp_path / rp.checkpoint_dir))
    assert found is not None
    step_n, ff = checkpoint.load(found)
    assert step_n == 800
    np.testing.assert_allclose(float(np.sum(ff)), 24.0 * 24.0, rtol=1e-10)


def _steady_cavity(n, re, u=0.1, steps=30000, collision="bgk"):
    params = _params(n=n, re=re, u=u, precision="f64", collision=collision)
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))

    def body(_, f):
        return step(f)

    f = jnp.asarray(problem.initial_state())
    f = jax.lax.fori_loop(0, steps, body, f)
    assert bool(physics.is_stable(f))
    rho, uvec = physics.moments(D2Q9, f)
    return np.asarray(uvec[0]), np.asarray(uvec[1])


@pytest.mark.slow
def test_cavity_ghia_re100_benchmark():
    """Steady Re=100 cavity vs the Ghia, Ghia & Shin (1982) table structure:
    centerline velocity extrema and their locations (loose tolerances cover
    the 64^2 discretization vs Ghia's 129^2)."""
    n, U = 64, 0.1
    ux, uy = _steady_cavity(n, 100.0, u=U)
    L = n - 1.0
    # vertical centerline (x = L/2): u_min ~ -0.211 U at y/L ~ 0.458
    ucl = 0.5 * (ux[:, n // 2 - 1] + ux[:, n // 2]) / U
    k = int(np.argmin(ucl))
    assert -0.24 < ucl[k] < -0.17, ucl[k]
    assert 0.35 < k / L < 0.55, k / L
    # lid-adjacent flow follows the lid
    assert ucl[-1] > 0.7
    # horizontal centerline (y = L/2): v_max ~ 0.175 U at x/L ~ 0.23,
    # v_min ~ -0.245 U at x/L ~ 0.81
    vcl = 0.5 * (uy[n // 2 - 1, :] + uy[n // 2, :]) / U
    kmax, kmin = int(np.argmax(vcl)), int(np.argmin(vcl))
    assert 0.14 < vcl[kmax] < 0.21, vcl[kmax]
    assert -0.28 < vcl[kmin] < -0.21, vcl[kmin]
    assert 0.15 < kmax / L < 0.32, kmax / L
    assert 0.72 < kmin / L < 0.90, kmin / L
    # primary vortex center near (x, y) = (0.62, 0.73) (Ghia): locate it as
    # the global streamfunction extremum (psi = integral of ux over y; a
    # speed minimum is NOT robust — corner eddies have stagnation points too)
    psi = np.cumsum(ux, axis=0)
    iy, ix = np.unravel_index(np.argmax(np.abs(psi)), psi.shape)
    cy, cx = iy / L, ix / L
    assert 0.6 < cy < 0.85 and 0.5 < cx < 0.75, (cy, cx)


@pytest.mark.slow
def test_cavity_mrt_matches_bgk_flow_re100():
    # MRT with default ghost rates must reproduce the same steady flow
    # (viscosity set by the shear rate alone)
    ux_b, uy_b = _steady_cavity(48, 100.0, steps=40000)
    ux_m, uy_m = _steady_cavity(48, 100.0, steps=40000, collision="mrt")
    np.testing.assert_allclose(ux_m, ux_b, atol=2.5e-3)
    np.testing.assert_allclose(uy_m, uy_b, atol=2.5e-3)
