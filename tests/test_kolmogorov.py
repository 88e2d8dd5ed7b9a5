"""Kolmogorov flow (problem="kolmogorov"): spatially varying body force
F_x(y) = F0·cos(κy) via Problem.force_fn, evaluated in-step from global
coordinates. Gates: the laminar profile is a fixed point at the analytic
amplitude, spin-up from rest follows the exact linear solution
(validating F0 end-to-end), sharded == oracle (the padded-block force
must wrap correctly at halo cells), and the runner + statistics +
spectrum pipeline runs end-to-end.

New capability — the reference's only forcing is a uniform constant in
dead code (LBMUtils.h:15-19)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9
from tpulbm.models import make_problem
from tpulbm.models.periodic2d import (kolmogorov_fields, kolmogorov_f0,
                                      kolmogorov_kappa)
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _params(**kw):
    d = dict(nx=32, ny=32, tau=0.8, problem="kolmogorov", kolmogorov_n=1,
             inlet_velocity=0.01, periodic_x=True, cylinder_radius=0.0,
             precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def _amplitude(params, u):
    """Projection of ux onto the forcing mode: a = 2·⟨ux·cos(κy)⟩."""
    kappa = kolmogorov_kappa(params)
    y = np.arange(params.ny, dtype=np.float64)[:, None]
    return 2.0 * float(np.mean(np.asarray(u[0]) * np.cos(kappa * y)))


def test_laminar_profile_is_a_fixed_point():
    """At Re = u0/(νκ) ≈ 0.5 ≪ critical, starting AT the laminar profile
    must stay there: u_x(y) = u0·cos(κy) to ~1% after 1000 steps (the 1%
    transverse seed decays in ~260 steps)."""
    params = _params()
    pr = make_problem(params)
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())
    f = lax.fori_loop(0, 1000, lambda i, x: step(x), f)
    _, u = physics.moments(D2Q9, f)
    u0 = params.inlet_velocity
    kappa = kolmogorov_kappa(params)
    y = np.arange(params.ny, dtype=np.float64)[:, None]
    ux_ana = u0 * np.cos(kappa * y) * np.ones((1, params.nx))
    err = np.max(np.abs(np.asarray(u[0]) - ux_ana)) / u0
    assert err < 0.015, err
    # transverse component decayed away
    assert np.max(np.abs(np.asarray(u[1]))) / u0 < 0.005
    # periodic box: mass conserved exactly
    np.testing.assert_allclose(float(jnp.sum(f)), 32.0 * 32.0, rtol=1e-12)


def test_spinup_from_rest_matches_linear_solution():
    """From rest the forcing mode grows as u0·(1 − e^{−νκ²t}) (exact for
    the linearized equation; nonlinear terms are O(u²) here). Validates
    the F0 = u0·ν·κ² amplitude calibration end-to-end."""
    params = _params()
    pr = make_problem(params)
    import dataclasses
    rest = (np.ones((params.ny, params.nx)),
            np.zeros((2, params.ny, params.nx)))
    pr = dataclasses.replace(pr, init_fields=rest)
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())
    nu, kappa = params.nu(), kolmogorov_kappa(params)
    u0 = params.inlet_velocity
    t = 0
    for t_target in (200, 600):
        f = lax.fori_loop(0, t_target - t, lambda i, x: step(x), f)
        t = t_target
        _, u = physics.moments(D2Q9, f)
        a_exp = u0 * (1.0 - np.exp(-nu * kappa * kappa * t))
        a_meas = _amplitude(params, u)
        assert abs(a_meas / a_exp - 1.0) < 0.02, (t, a_meas, a_exp)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2), (4, 2)],
                         ids=["y", "2d", "x", "4x2"])
def test_sharded_matches_oracle(mesh_shape):
    """The padded-block force (global coords offset−1…n, periodic wrap at
    halo cells) must reproduce the oracle."""
    params = _params(kolmogorov_n=2)
    pr = make_problem(params)
    step = jax.jit(make_step_rolled(pr))
    s_ref = pr.initial_state()
    for _ in range(10):
        s_ref = step(s_ref)
    s_ref = np.asarray(jax.device_get(s_ref))
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, 5)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros((params.ny, params.nx), bool))
    s = chunk(s, solid)
    s = chunk(s, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(s)), s_ref,
                               rtol=1e-12, atol=1e-15)


@pytest.mark.slow
def test_band_instability_threshold_signs():
    """Meshalkin–Sinai bifurcation: the transverse large-scale mode must
    DECAY well below the Re_c ≈ √2 threshold and GROW well above it
    (scripts/kolmogorov_threshold.py measures the full λ(Re) curve —
    Re_c = 1.585 at q/κ = 1/8 → 1.521 at 1/16, closing on the analytic
    q→0 asymptote; this gate pins the signs on a small box)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "kolmogorov_threshold",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts",
            "kolmogorov_threshold.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lam_lo, _, _ = mod.growth_rate(1.0, nx=64, ny=64, n_bands=4,
                                   steps=9000)
    lam_hi, _, _ = mod.growth_rate(3.5, nx=64, ny=64, n_bands=4,
                                   steps=9000)
    assert lam_lo < -1e-6, lam_lo       # clearly decaying
    assert lam_hi > 1e-6, lam_hi        # clearly growing


# ---- 3-D Kolmogorov flow (F_x(z) = F0·cos(κz), D3Q19) ----

def _params3(**kw):
    d = dict(nx=16, ny=8, nz=32, tau=0.8, problem="kolmogorov",
             kolmogorov_n=1, inlet_velocity=0.01, periodic_x=True,
             cylinder_radius=0.0, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def test_3d_spinup_from_rest_matches_linear_solution():
    """3-D forcing-mode growth from rest: a(t) = u0·(1 − e^{−νκ²t}) with
    κ = 2π·n/nz — validates the F0 calibration and the zz force
    coordinates end-to-end on D3Q19."""
    import dataclasses
    from tpulbm.models.periodic2d import kolmogorov3d_kappa
    params = _params3()
    pr = make_problem(params)
    rest = (np.ones((params.nz, params.ny, params.nx)),
            np.zeros((3, params.nz, params.ny, params.nx)))
    pr = dataclasses.replace(pr, init_fields=rest)
    step = jax.jit(make_step_rolled(pr))
    f = jnp.asarray(pr.initial_state())
    nu, kappa = params.nu(), kolmogorov3d_kappa(params)
    u0 = params.inlet_velocity
    f = lax.fori_loop(0, 400, lambda i, x: step(x), f)
    _, u = physics.moments(pr.lattice, f)
    z = np.arange(params.nz, dtype=np.float64)[:, None, None]
    a_meas = 2.0 * float(np.mean(np.asarray(u[0]) * np.cos(kappa * z)))
    a_exp = u0 * (1.0 - np.exp(-nu * kappa * kappa * 400))
    assert abs(a_meas / a_exp - 1.0) < 0.02, (a_meas, a_exp)


def test_runner_end_to_end_with_stats_and_spectrum(tmp_path):
    """Runner + --stats-from + spectra on a short laminar Kolmogorov run:
    the energy spectrum must be concentrated at the forcing shell."""
    from tpulbm.runner import Runner
    from tpulbm.utils.analysis import energy_spectrum
    params = _params(nx=64, ny=64, kolmogorov_n=2, num_timesteps=200,
                     output_frequency=50, output_dir=str(tmp_path), enable_vtk=False, stats_from=100,
                     precision="f32")
    res = Runner(params, verbose=False).run()
    assert res.success
    z = np.load(tmp_path / "stats_fields.npz")
    assert int(z["n_samples"]) == 2      # t = 100, 150
    u = np.stack([z["mean_ux"], z["mean_uy"]])
    k, E = energy_spectrum(u)
    assert np.argmax(E) == 2             # forcing wavenumber n = 2
    assert E[2] / E.sum() > 0.99
