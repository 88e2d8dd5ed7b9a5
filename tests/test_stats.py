"""Reynolds-statistics tests: the on-device time-averaging machinery
(--stats-from) — device accumulation == host accumulation, the runner's
super-chunk and scalar sampling paths agree, sharded == single-device, and
the stats_fields.npz artifact is self-describing.

New capability — the reference has no flow statistics (SURVEY §5)."""
import numpy as np
import pytest

from tpulbm.config import SimulationParams, validate_params
from tpulbm.models import make_problem
from tpulbm.ops import diagnostics
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import (make_chunk_fn, make_super_chunk_fn,
                                          shard_state)
from tpulbm.runner import Runner

import jax
import jax.numpy as jnp


def tiny_params(tmp, **kw):
    defaults = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                    num_timesteps=200, output_frequency=50,
                    output_dir=str(tmp), precision="f32",
                    enable_vtk=False, stats_from=0)
    defaults.update(kw)
    return SimulationParams(**defaults)


def test_super_chunk_stats_match_host_accumulation(tmp_path):
    """Device-side accumulation inside the super-chunk scan == stepping the
    same chunks and summing the sampled fields on the host, including the
    n_skip gate."""
    params = tiny_params(tmp_path)
    problem = make_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    interval, n_int, n_skip = 10, 4, 1

    f0 = problem.initial_state()
    solid = problem.solid

    sup = make_super_chunk_fn(problem, mesh, interval, n_int, with_stats=True)
    f_dev, solid_dev = shard_state(mesh, f0, solid)
    dt_ = problem.dtype
    sp = problem.spatial_shape
    D = problem.lattice.D
    stats0 = (jnp.zeros((), dt_), jnp.zeros(sp, dt_),
              jnp.zeros((D,) + sp, dt_),
              jnp.zeros((D * (D + 1) // 2,) + sp, dt_))
    (f_end, stats), diags = sup(f_dev, stats0, np.int32(n_skip), solid_dev)
    cnt, s_rho, s_u, s_uu = jax.device_get(stats)

    # host reference: advance interval-by-interval, sample interval starts
    chunk = make_chunk_fn(problem, mesh, interval)
    sample = jax.jit(diagnostics.stats_sample_fn(problem))
    fc, sd = shard_state(mesh, f0, solid)
    h_cnt = 0
    h_rho = np.zeros(sp)
    h_u = np.zeros((D,) + sp)
    h_uu = np.zeros((D * (D + 1) // 2,) + sp)
    for j in range(n_int):
        if j >= n_skip:
            rho, u, uu = jax.device_get(sample(fc))
            h_cnt += 1
            h_rho += rho
            h_u += u
            h_uu += uu
        fc = chunk(fc, sd)

    assert int(cnt) == h_cnt == n_int - n_skip
    np.testing.assert_allclose(s_rho, h_rho, rtol=1e-6)
    np.testing.assert_allclose(s_u, h_u, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s_uu, h_uu, rtol=1e-6, atol=1e-9)
    # the state advanced identically to the plain chunk path
    np.testing.assert_allclose(jax.device_get(f_end), jax.device_get(fc),
                               rtol=1e-6)


def test_runner_stats_artifact(tmp_path):
    """End-to-end scalar path: samples at every output interval >= stats_from,
    artifact keys present and self-describing."""
    params = tiny_params(tmp_path, stats_from=50)
    result = Runner(params, verbose=False).run()
    assert result.success

    z = np.load(tmp_path / "stats_fields.npz")
    # samples at t = 50, 100, 150 (t=0 < stats_from; t=200 never entered)
    assert int(z["n_samples"]) == 3
    assert int(z["first_step"]) == 50
    assert int(z["sample_interval"]) == 50
    for key in ("mean_rho", "mean_ux", "mean_uy",
                "re_uxux", "re_uxuy", "re_uyuy"):
        assert z[key].shape == (32, 64), key
    # variances are non-negative up to float roundoff
    assert z["re_uxux"].min() > -1e-9
    assert z["re_uyuy"].min() > -1e-9
    # mean density of a near-incompressible run stays near 1
    assert abs(float(z["mean_rho"].mean()) - 1.0) < 0.05


@pytest.mark.slow  # fast stats reps: the single-device artifact tests
def test_runner_stats_super_path_sharded_matches_single(tmp_path):
    """A run long enough for the super-chunk fast path, on a (2,2) mesh,
    produces the same statistics as the single-device scalar-path run."""
    freq, T = 5, 90
    p1 = tiny_params(tmp_path / "a", nx=64, ny=32, num_timesteps=T,
                     output_frequency=freq, stats_from=20)
    r1 = Runner(p1, verbose=False).run()
    assert r1.success
    p2 = p1.replace(output_dir=str(tmp_path / "b"), mesh_shape=(2, 2))
    r2 = Runner(p2, verbose=False).run()
    assert r2.success

    za = np.load(tmp_path / "a" / "stats_fields.npz")
    zb = np.load(tmp_path / "b" / "stats_fields.npz")
    # samples at t = 20, 25, ..., 85
    assert int(za["n_samples"]) == int(zb["n_samples"]) == 14
    assert int(za["first_step"]) == int(zb["first_step"]) == 20
    for key in ("mean_rho", "mean_ux", "mean_uy",
                "re_uxux", "re_uxuy", "re_uyuy"):
        np.testing.assert_allclose(za[key], zb[key], rtol=2e-5, atol=1e-10,
                                   err_msg=key)


def test_runner_stats_artifact_3d(tmp_path):
    """3-D runs produce the full 6-component Reynolds-stress tensor
    (stats_sample_fn is D-generic; keys follow stats_pair_names)."""
    params = SimulationParams(nx=32, ny=16, nz=8, problem="cylinder3d",
                              tau=0.6, inlet_velocity=0.05,
                              num_timesteps=60, output_frequency=20,
                              output_dir=str(tmp_path),
                              precision="f32", enable_vtk=False,
                              cylinder_radius=0.0, stats_from=20)
    result = Runner(params, verbose=False).run()
    assert result.success
    z = np.load(tmp_path / "stats_fields.npz")
    assert int(z["n_samples"]) == 2      # t = 20, 40
    for key in ("mean_rho", "mean_ux", "mean_uy", "mean_uz",
                "re_uxux", "re_uxuy", "re_uxuz",
                "re_uyuy", "re_uyuz", "re_uzuz"):
        assert z[key].shape == (8, 16, 32), key
    assert z["re_uzuz"].min() > -1e-9


def test_stats_from_validation():
    with pytest.raises(ValueError, match="stats_from"):
        validate_params(SimulationParams(stats_from=-3))
    with pytest.raises(ValueError, match="beyond num_timesteps"):
        validate_params(SimulationParams(num_timesteps=100, stats_from=100))
    validate_params(SimulationParams(stats_from=-1))  # off: fine


def test_stats_survive_resume_single_npz(tmp_path):
    """Checkpointed statistics accumulators: an interrupted+resumed run
    must produce bit-identical stats_fields.npz to an uninterrupted one
    (single-.npz format — the accumulators ride the checkpoint and the
    sample window continues instead of restarting)."""
    common = dict(output_frequency=25, stats_from=50, checkpoint_every=1)
    p_full = tiny_params(tmp_path / "full", num_timesteps=200, **common)
    assert Runner(p_full, verbose=False).run().success

    p_half = tiny_params(tmp_path / "resumed", num_timesteps=100, **common)
    assert Runner(p_half, verbose=False).run().success
    z_half = np.load(tmp_path / "resumed" / "stats_fields.npz")
    assert int(z_half["n_samples"]) == 2          # t = 50, 75

    p_res = tiny_params(tmp_path / "resumed", num_timesteps=200, **common)
    assert Runner(p_res, verbose=False).run(resume=True).success

    za = np.load(tmp_path / "full" / "stats_fields.npz")
    zb = np.load(tmp_path / "resumed" / "stats_fields.npz")
    assert int(za["n_samples"]) == int(zb["n_samples"]) == 6
    assert int(za["first_step"]) == int(zb["first_step"]) == 50
    for key in ("mean_rho", "mean_ux", "mean_uy",
                "re_uxux", "re_uxuy", "re_uyuy"):
        np.testing.assert_allclose(zb[key], za[key], rtol=2e-5,
                                   atol=1e-10, err_msg=key)


@pytest.mark.slow  # fast resume rep: the single-npz variant
def test_stats_survive_resume_sharded(tmp_path):
    """Same contract on a (2,2) mesh with the per-shard checkpoint
    format: sharded accumulators restore via the manifest's stats maps,
    never materializing globals on the host."""
    common = dict(output_frequency=25, stats_from=50, checkpoint_every=1,
                  mesh_shape=(2, 2))
    p_full = tiny_params(tmp_path / "full", num_timesteps=200, **common)
    assert Runner(p_full, verbose=False).run().success

    p_half = tiny_params(tmp_path / "resumed", num_timesteps=100, **common)
    assert Runner(p_half, verbose=False).run().success
    p_res = tiny_params(tmp_path / "resumed", num_timesteps=200, **common)
    assert Runner(p_res, verbose=False).run(resume=True).success

    za = np.load(tmp_path / "full" / "stats_fields.npz")
    zb = np.load(tmp_path / "resumed" / "stats_fields.npz")
    assert int(za["n_samples"]) == int(zb["n_samples"]) == 6
    assert int(za["first_step"]) == int(zb["first_step"]) == 50
    for key in ("mean_rho", "mean_ux", "mean_uy", "re_uxux", "re_uyuy"):
        np.testing.assert_allclose(zb[key], za[key], rtol=2e-5,
                                   atol=1e-10, err_msg=key)


def test_resume_without_saved_stats_starts_fresh(tmp_path):
    """A checkpoint written BEFORE statistics existed (no stats keys)
    must resume cleanly and start accumulating from the resume point."""
    p1 = tiny_params(tmp_path, num_timesteps=100, output_frequency=25,
                     checkpoint_every=1)          # stats_from=0 default
    p1 = p1.replace(stats_from=-1)                # no stats in first run
    assert Runner(p1, verbose=False).run().success
    p2 = tiny_params(tmp_path, num_timesteps=200, output_frequency=25,
                     checkpoint_every=1, stats_from=50)
    assert Runner(p2, verbose=False).run(resume=True).success
    z = np.load(tmp_path / "stats_fields.npz")
    # resumed at t=100: samples at 100, 125, 150, 175
    assert int(z["n_samples"]) == 4
    assert int(z["first_step"]) == 100
