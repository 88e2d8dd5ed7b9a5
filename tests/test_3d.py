"""D3Q19 3-D model (new capability; BASELINE config 5): sanity + sharded
equivalence on the jax backend."""
import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.lattice import D3Q19
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _params(**kw):
    d = dict(nx=32, ny=16, nz=8, problem="cylinder3d", tau=0.6,
             inlet_velocity=0.05, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def test_3d_force_coefficients_use_frontal_area():
    # 3-D (sphere) drag/lift coefficients normalize by q = 1/2 U^2 pi r^2
    # (standard sphere convention — the 2-D reference normalization
    # q = 1/2 U^2 (2 r) applies only to the cylinder, LBMIO.h:171-178)
    from tpulbm.ops.forces import force_coefficients
    problem = make_problem(_params(ny=64, cylinder_radius=0.1))
    r = problem.params.get_cylinder_radius_cells()
    assert r > 0
    U = problem.params.inlet_velocity
    q = 0.5 * U * U * np.pi * r * r
    cd, cl = force_coefficients(problem, np.array([2.0 * q, -q, 0.5 * q]))
    assert cd == pytest.approx(2.0)
    assert cl == pytest.approx(-1.0)

    problem2d = make_problem(SimulationParams(nx=64, ny=32, tau=0.6,
                                              inlet_velocity=0.05))
    r2 = problem2d.params.get_cylinder_radius_cells()
    q2 = 0.5 * 0.05 * 0.05 * 2.0 * r2
    cd2, _ = force_coefficients(problem2d, np.array([3.0 * q2, 0.0]))
    assert cd2 == pytest.approx(3.0)


def test_3d_step_runs_and_conserves_sanity():
    problem = make_problem(_params())
    assert problem.lattice is D3Q19
    assert problem.solid.shape == (8, 16, 32)
    assert problem.solid.sum() > 0
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    assert f.shape == (19, 8, 16, 32)
    for _ in range(20):
        f = step(f)
    assert bool(physics.is_stable(f))
    rho, u = physics.moments(D3Q19, f)
    rho = np.asarray(rho)
    assert 0.8 < rho.mean() < 1.2
    # flow enters at x=0 with +x velocity
    ux = np.asarray(u[0])
    assert ux[:, :, 2:6].mean() > 0


@pytest.mark.parametrize("mesh_shape,extra", [
    ((2, 4), {}), ((1, 2), {}), ((4, 1), {}),
    ((2, 2), {"obstacle_bc": "bounce_back", "collision": "trt"}),
], ids=["2x4", "x-sharded", "y-sharded", "bounce-back-trt-2x2"])
def test_3d_sharded_matches_single_device(mesh_shape, extra):
    problem = make_problem(_params(**extra))
    step = jax.jit(make_step_rolled(problem))
    f_ref = problem.initial_state()
    for _ in range(8):
        f_ref = step(f_ref)

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(problem, mesh, chunk_len=4)
    assert chunk.tier == "xla"
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    for _ in range(2):
        f = chunk(f, solid)
    np.testing.assert_allclose(np.asarray(jax.device_get(f)),
                               np.asarray(f_ref), rtol=1e-12, atol=1e-15)


def test_3d_runner_end_to_end(tmp_path):
    params = _params(num_timesteps=20, output_frequency=10, precision="f32",
                     output_dir=str(tmp_path),
                     enable_vtk=False)
    from tpulbm.runner import Runner
    result = Runner(params, verbose=False).run()
    assert result.success
    assert (tmp_path / "fields3d.npz").exists()
    data = np.load(tmp_path / "fields3d.npz")
    assert data["ux"].shape == (8, 16, 32)


def test_3d_runner_writes_vtk_frames(tmp_path):
    params = _params(num_timesteps=20, output_frequency=10, precision="f32",
                     output_dir=str(tmp_path),
                     enable_vtk=True)
    from tpulbm.runner import Runner
    result = Runner(params, verbose=False).run()
    assert result.success
    import os as _os
    frames = sorted(_os.listdir(tmp_path / "vtk_output"))
    # frame at t=10 plus the final frame at t=20
    assert frames == ["lbm_000010.vtk", "lbm_000020.vtk"]
    vtk = open(tmp_path / "vtk_output" / "lbm_000010.vtk").read().splitlines()
    assert vtk[3] == "DATASET STRUCTURED_POINTS"
    assert vtk[4] == "DIMENSIONS 32 16 8"
    assert vtk[7] == f"POINT_DATA {32 * 16 * 8}"
    assert vtk[8] == "VECTORS velocity double"
    assert len(vtk[9].split()) == 3          # three vector components
    # duct flow past a sphere develops nonzero uz somewhere in the field
    n_cells = 32 * 16 * 8
    uz_vals = [float(l.split()[2]) for l in vtk[9:9 + n_cells]]
    assert any(abs(v) > 1e-9 for v in uz_vals), "uz is identically zero"
    idx = vtk.index("SCALARS velocity_magnitude double")
    assert vtk[idx + 1] == "LOOKUP_TABLE default"


def test_3d_native_vtk_matches_python(tmp_path):
    import os as _os
    from tpulbm.utils import io as io_mod
    from tpulbm.utils.native import get_native_io
    if get_native_io() is None or not getattr(get_native_io(), "_has_vtk3",
                                              False):
        import pytest
        pytest.skip("native IO unavailable")
    rng = np.random.default_rng(3)
    nz, ny, nx = 4, 6, 10
    ux, uy, uz = (rng.standard_normal((nz, ny, nx)) * 0.1 for _ in range(3))
    rho = 1.0 + rng.standard_normal((nz, ny, nx)) * 0.01
    params = _params(nx=nx, ny=ny, nz=nz)
    _os.environ["TPULBM_NO_NATIVE"] = "1"
    try:
        io_mod.write_vtk_timestep(ux, uy, rho, params, 3,
                                  str(tmp_path / "py"), uz=uz)
        py = open(tmp_path / "py" / "vtk_output" / "lbm_000003.vtk",
                  "rb").read()
    finally:
        del _os.environ["TPULBM_NO_NATIVE"]
    io_mod.write_vtk_timestep(ux, uy, rho, params, 3, str(tmp_path / "nat"),
                              uz=uz)
    nat = open(tmp_path / "nat" / "vtk_output" / "lbm_000003.vtk",
               "rb").read()
    assert nat == py
