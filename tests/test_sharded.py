"""Multi-device equivalence: the shard_map/ppermute chunked stepper must
reproduce the single-device rolled oracle exactly (up to fp reassociation)
on a fake 8-device CPU mesh — the test the reference could never run without
a cluster (SURVEY §4), and which its corner-ghost bug would fail (SURVEY §5
deviation #1)."""
import jax
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import choose_decomposition, make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _reference_states(problem, n_steps):
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    out = []
    for _ in range(n_steps):
        f = step(f)
        out.append(np.asarray(f))
    return out


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4), (8, 1), (1, 8)])
def test_cylinder_sharded_matches_single_device(mesh_shape):
    params = SimulationParams(nx=48, ny=24, tau=0.6, inlet_velocity=0.05,
                              precision="f64")
    problem = make_problem(params)
    refs = _reference_states(problem, 15)

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(problem, mesh, chunk_len=5)
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    for k in range(3):
        f = chunk(f, solid)
        np.testing.assert_allclose(np.asarray(f), refs[5 * (k + 1) - 1],
                                   rtol=1e-12, atol=1e-15,
                                   err_msg=f"mesh {mesh_shape} chunk {k}")


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_poiseuille_periodic_sharded(mesh_shape):
    params = SimulationParams(nx=32, ny=16, tau=0.8, problem="poiseuille",
                              periodic_x=True, body_force=(1e-4, 0.0),
                              inlet_velocity=0.0, precision="f64")
    problem = make_problem(params)
    refs = _reference_states(problem, 12)

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(problem, mesh, chunk_len=4)
    solid = np.zeros((params.ny, params.nx), bool)
    f, solid = shard_state(mesh, problem.initial_state(), solid)
    for k in range(3):
        f = chunk(f, solid)
        np.testing.assert_allclose(np.asarray(f), refs[4 * (k + 1) - 1],
                                   rtol=1e-12, atol=1e-15,
                                   err_msg=f"mesh {mesh_shape} chunk {k}")


def test_bounce_back_mode_sharded_matches_single():
    params = SimulationParams(nx=48, ny=24, tau=0.6, inlet_velocity=0.05,
                              precision="f64", obstacle_bc="bounce_back")
    problem = make_problem(params)
    refs = _reference_states(problem, 10)
    mesh = make_mesh((2, 4))
    chunk = make_chunk_fn(problem, mesh, chunk_len=5)
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    for k in range(2):
        f = chunk(f, solid)
        np.testing.assert_allclose(np.asarray(f), refs[5 * (k + 1) - 1],
                                   rtol=1e-12, atol=1e-15)


def test_choose_decomposition_matches_reference_scoring():
    # 2048x512 over 8 ranks: the reference's score favors (px=4, py=2) →
    # local 512x256 (aspect preserved); we return (py, px).
    py, px = choose_decomposition(8, 2048, 512)
    assert (py, px) == (2, 4)
    with pytest.raises(ValueError):
        choose_decomposition(7, 30, 10)  # 7 divides neither dim


# Operators and boundary closures the GPU kernel does not cover: they run
# the XLA tier on every platform (parallel/sharded_step.choose_tier).
_XLA_ONLY = {
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
    "regularized": dict(collision="regularized"),
    "kbc": dict(collision="kbc"),
    "les": dict(smagorinsky=0.15),
    "power-law": dict(power_law_n=0.8),
    "clean-corners": dict(zou_he_corners="clean"),
}


@pytest.mark.parametrize("name", sorted(_XLA_ONLY))
def test_xla_only_operators_sharded_match_single_device(name):
    params = SimulationParams(nx=48, ny=24, tau=0.6, inlet_velocity=0.05,
                              precision="f64", **_XLA_ONLY[name])
    problem = make_problem(params)
    refs = _reference_states(problem, 8)
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    chunk = make_chunk_fn(problem, mesh, chunk_len=4)
    assert chunk.tier == "xla"
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    for k in range(2):
        f = chunk(f, solid)
    np.testing.assert_allclose(np.asarray(f), refs[-1], rtol=1e-11,
                               atol=1e-13, err_msg=name)


def test_cavity_lid_sharded_matches_single_device():
    params = SimulationParams(nx=32, ny=32, tau=0.8, inlet_velocity=0.1,
                              problem="cavity", cylinder_radius=0.0,
                              precision="f64")
    problem = make_problem(params)
    refs = _reference_states(problem, 8)
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    chunk = make_chunk_fn(problem, mesh, chunk_len=4)
    f, solid = shard_state(mesh, problem.initial_state(),
                           np.zeros(problem.spatial_shape, bool))
    for k in range(2):
        f = chunk(f, solid)
    np.testing.assert_allclose(np.asarray(f), refs[-1], rtol=1e-11,
                               atol=1e-13)
