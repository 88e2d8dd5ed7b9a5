"""Shan-Chen multiphase (new capability; the reference is single-phase):
forcing degeneracy, phase separation + exact mass conservation, the
Laplace law, sharded == single-device equivalence (the only model whose
sharded body exchanges halos twice per step), and config validation."""
import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams, validate_params
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.ops.step_multiphase import make_step_multiphase
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _params(**kw):
    d = dict(nx=64, ny=32, tau=1.0, problem="multiphase", shan_chen_g=-5.0,
             cylinder_radius=0.0, inlet_velocity=0.0, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def test_zero_force_is_bgk():
    rng = np.random.default_rng(0)
    W = D2Q9.w.reshape((9, 1, 1))
    f = np.asarray(W * (1.0 + 0.02 * rng.standard_normal((9, 6, 8))),
                   np.float64)
    F = np.zeros((2, 6, 8))
    a = physics.collide_shan_chen(D2Q9, f, 1.0 / 0.8, F)
    b = physics.collide(D2Q9, f, 1.0 / 0.8)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-14, atol=1e-16)


def test_phase_separation_and_mass_conservation():
    problem = make_problem(_params())
    step = jax.jit(make_step_multiphase(problem))
    f = problem.initial_state()
    mass0 = float(np.sum(f))
    for _ in range(2000):
        f = step(f)
    f = np.asarray(jax.device_get(f))
    assert np.isfinite(f).all()
    # exact-mass walls + periodic x: total mass is conserved to rounding
    assert abs(np.sum(f) - mass0) / mass0 < 1e-12
    rho = f.sum(axis=0)
    # the band has sharpened into coexisting phases
    assert rho.max() / rho.min() > 5.0
    # liquid interior is flat (no spurious gradients away from interfaces)
    mid = rho[rho.shape[0] // 2]
    liq = mid[28:36]
    assert liq.std() / liq.mean() < 0.01


@pytest.mark.slow
def test_laplace_law():
    """ΔP = σ/R: surface tension from two droplet radii must agree."""
    def run(radius_frac, ny=80, nx=80, steps=6000):
        params = _params(nx=nx, ny=ny, cylinder_radius=radius_frac,
                         cylinder_x=0.5, cylinder_y=0.5)
        problem = make_problem(params)
        step = jax.jit(make_step_multiphase(problem))
        f = problem.initial_state()
        for _ in range(steps):
            f = step(f)
        rho = np.asarray(jax.device_get(f)).sum(axis=0)
        assert np.isfinite(rho).all()
        g = params.shan_chen_g
        P = np.asarray(physics.shan_chen_pressure(rho, g))
        cy, cx = ny // 2, nx // 2
        p_in = P[cy - 1:cy + 2, cx - 1:cx + 2].mean()
        # far field at MID-HEIGHT near the (periodic) x edges: the phantom
        # rho=1 walls are partially wetting, so corner samples sit in the
        # wall film and overestimate the outside pressure
        p_out = np.concatenate([P[cy - 1:cy + 2, 1:4].ravel(),
                                P[cy - 1:cy + 2, -4:-1].ravel()]).mean()
        # effective radius from the liquid area (interfaces relax)
        cut = 0.5 * (rho.max() + rho.min())
        r_eff = np.sqrt((rho > cut).sum() / np.pi)
        return (p_in - p_out), r_eff

    dp1, r1 = run(0.12)   # R ~ 9.6
    dp2, r2 = run(0.20)   # R ~ 16
    assert dp1 > 0 and dp2 > 0          # pressure is higher inside
    assert r2 > r1 > 3.0
    sigma1, sigma2 = dp1 * r1, dp2 * r2
    # one surface tension: sigma from both radii within 20%
    assert abs(sigma1 - sigma2) / max(sigma1, sigma2) < 0.20, \
        (dp1, r1, dp2, r2)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["y", "x", "2d"])
def test_multiphase_sharded_matches_oracle(mesh_shape):
    params = _params(nx=64, ny=32, cylinder_radius=0.2)
    problem = make_problem(params)
    step = jax.jit(make_step_multiphase(problem))
    f_ref = problem.initial_state()
    for _ in range(10):
        f_ref = step(f_ref)
    f_ref = np.asarray(jax.device_get(f_ref))

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(problem, mesh, 5)
    f, solid = shard_state(mesh, problem.initial_state(),
                           np.zeros(problem.spatial_shape, bool))
    for _ in range(2):
        f = chunk(f, solid)
    got = np.asarray(jax.device_get(f))
    np.testing.assert_allclose(got, f_ref, rtol=1e-12, atol=1e-14)


@pytest.mark.slow
def test_wall_wettability_controls_contact_angle():
    """mp_wall_rho sets the phantom fluid the ψ stencil reads beyond the
    walls: a wall denser than the reference fluid attracts the liquid
    (contact angle < 90°, the sessile droplet spreads), a vapor-like wall
    repels it (beads up). Gate: the spread width at the wall orders
    strictly with wall density."""
    def wall_width(wall_rho, steps=4000):
        params = _params(nx=96, ny=48, cylinder_radius=0.25,
                         cylinder_x=0.5, cylinder_y=0.0,
                         mp_wall_rho=wall_rho)
        problem = make_problem(params)
        assert problem.init_rho == wall_rho
        step = jax.jit(make_step_multiphase(problem))
        f = problem.initial_state()
        for _ in range(steps):
            f = step(f)
        rho = np.asarray(jax.device_get(f)).sum(axis=0)
        assert np.isfinite(rho).all()
        cut = 0.5 * (rho.max() + rho.min())
        return int((rho[1] > cut).sum())   # liquid extent one row off the wall

    w_wet = wall_width(1.6)
    w_neutral = wall_width(1.0)
    w_dry = wall_width(0.16)
    assert w_wet > w_neutral > w_dry, (w_wet, w_neutral, w_dry)
    assert w_dry >= 0 and w_wet < 96


def test_fields_report_physical_velocity():
    # runner/VTK output must carry the half-step-corrected u + F/(2rho)
    # (the measurable momentum of the forced system), not bare moments —
    # regression: velocity_field.csv shipped the uncorrected field
    from tpulbm.ops import diagnostics
    from tpulbm.ops.step_multiphase import physical_velocity
    problem = make_problem(_params(cylinder_radius=0.2))
    step = jax.jit(make_step_multiphase(problem))
    f = problem.initial_state()
    for _ in range(20):
        f = step(f)
    rho, u = jax.jit(diagnostics.fields_fn(problem))(f)
    rho_p, u_p = physical_velocity(problem, f)
    # jit-vs-eager fusion rounding only
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_p),
                               rtol=1e-6, atol=1e-9)
    _, u_bare = physics.moments(D2Q9, f)
    # the correction is genuinely active (nonzero at the interfaces)
    assert float(np.max(np.abs(np.asarray(u) - np.asarray(u_bare)))) > 1e-6


def test_shard_initial_state_honors_rho_map():
    # the runner uses the on-device initial-state builder, which must fall
    # back to the host path for non-uniform (rho-map) initial states —
    # regression: it silently built a uniform rho=1 field instead
    from tpulbm.parallel.sharded_step import shard_initial_state
    problem = make_problem(_params(cylinder_radius=0.2))
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    f, _ = shard_initial_state(problem, mesh)
    np.testing.assert_allclose(np.asarray(jax.device_get(f)),
                               problem.initial_state(), atol=0)


def test_config_validation():
    validate_params(_params())
    with pytest.raises(ValueError, match="shan-chen-g"):
        validate_params(_params(shan_chen_g=0.0))
    with pytest.raises(ValueError, match="BGK-only"):
        validate_params(_params(collision="trt"))
    with pytest.raises(ValueError, match="multiphase"):
        validate_params(SimulationParams(problem="cylinder",
                                         shan_chen_g=-5.0))
