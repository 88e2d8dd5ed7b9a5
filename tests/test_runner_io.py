"""End-to-end runner + artifact-format tests: run a tiny cylinder case and
verify every artifact has the reference's exact byte layout (LBMIO.h), that
the native C++ writers match the Python fallback byte-for-byte, and that
checkpoint/resume reproduces an uninterrupted run."""
import os

import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.runner import Runner
from tpulbm.utils import checkpoint as ckpt
from tpulbm.utils import io as io_mod


def tiny_params(tmp, **kw):
    defaults = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                    num_timesteps=60, output_frequency=20,
                    output_dir=str(tmp), precision="f32")
    defaults.update(kw)
    return SimulationParams(**defaults)


def test_end_to_end_artifacts(tmp_path):
    params = tiny_params(tmp_path)
    result = Runner(params, verbose=False).run()
    assert result.success and result.final_step == 60

    # forces.csv: header + rows at t=0,20,40 (cadence parity LBMSolver.h:52)
    forces = open(tmp_path / "forces.csv").read().splitlines()
    assert forces[0] == "timestep,drag_force,lift_force,drag_coeff,lift_coeff"
    assert [r.split(",")[0] for r in forces[1:]] == ["0", "20", "40"]
    # fixed(8) float formatting
    assert all(len(f.split(".")[-1]) == 8 for f in forces[1].split(",")[1:])

    # velocity_field.csv layout (LBMIO.h:312-320)
    vf = open(tmp_path / "velocity_field.csv").read().splitlines()
    assert vf[0] == "x,y,ux,uy,rho,velocity_magnitude"
    assert len(vf) == 1 + 64 * 32
    assert vf[1].startswith("0,0,")
    assert vf[2].startswith("1,0,")  # x fastest, like the reference row loop

    # simulation_params.csv keys + order (LBMIO.h:349-361)
    sp = [l.split(",")[0] for l in open(tmp_path / "simulation_params.csv")]
    assert sp == ["parameter", "nx", "ny", "tau", "nu", "inlet_velocity",
                  "num_timesteps", "reynolds_number", "cylinder_x",
                  "cylinder_y", "cylinder_radius", "max_velocity",
                  "avg_velocity"]

    # VTK frames at t=20, 40 (t>0 cadence, LBMSolver.h:66) with legacy header
    frames = sorted(os.listdir(tmp_path / "vtk_output"))
    assert frames == ["lbm_000020.vtk", "lbm_000040.vtk"]
    vtk = open(tmp_path / "vtk_output" / "lbm_000020.vtk").read().splitlines()
    assert vtk[0] == "# vtk DataFile Version 3.0"
    assert vtk[1] == "LBM Flow Timestep 20"
    assert vtk[2] == "ASCII"
    assert vtk[3] == "DATASET STRUCTURED_POINTS"
    assert vtk[4] == "DIMENSIONS 64 32 1"
    assert vtk[7] == f"POINT_DATA {64*32}"
    assert vtk[8] == "VECTORS velocity double"
    assert vtk[9].endswith(" 0.0")
    idx = vtk.index("SCALARS velocity_magnitude double")
    assert vtk[idx + 1] == "LOOKUP_TABLE default"
    assert "SCALARS density double" in vtk


def test_native_writer_matches_python(tmp_path):
    from tpulbm.utils.native import get_native_io
    native = get_native_io()
    if native is None:
        pytest.skip("native IO unavailable")
    rng = np.random.default_rng(0)
    ny, nx = 13, 17
    ux = rng.standard_normal((ny, nx)) * 0.1
    uy = rng.standard_normal((ny, nx)) * 0.1
    rho = 1.0 + rng.standard_normal((ny, nx)) * 0.01
    params = SimulationParams(nx=nx, ny=ny)

    os.environ["TPULBM_NO_NATIVE"] = "1"
    try:
        io_mod.write_vtk_timestep(ux, uy, rho, params, 7, str(tmp_path / "py"))
        io_mod.write_velocity_field(ux, uy, rho, params, str(tmp_path))
        py_vtk = open(tmp_path / "py" / "vtk_output" / "lbm_000007.vtk", "rb").read()
        py_csv = open(tmp_path / "velocity_field.csv", "rb").read()
    finally:
        del os.environ["TPULBM_NO_NATIVE"]

    io_mod.write_vtk_timestep(ux, uy, rho, params, 7, str(tmp_path / "nat"))
    os.makedirs(tmp_path / "nat2", exist_ok=True)
    io_mod.write_velocity_field(ux, uy, rho, params, str(tmp_path / "nat2"))
    nat_vtk = open(tmp_path / "nat" / "vtk_output" / "lbm_000007.vtk", "rb").read()
    nat_csv = open(tmp_path / "nat2" / "velocity_field.csv", "rb").read()
    assert nat_vtk == py_vtk
    assert nat_csv == py_csv


def test_binary_vtk_matches_ascii_values(tmp_path):
    rng = np.random.default_rng(1)
    ny, nx = 8, 12
    ux = rng.standard_normal((ny, nx)) * 0.1
    uy = rng.standard_normal((ny, nx)) * 0.1
    rho = 1.0 + rng.standard_normal((ny, nx)) * 0.01
    params = SimulationParams(nx=nx, ny=ny)

    io_mod.write_vtk_timestep(ux, uy, rho, params, 3, str(tmp_path),
                              fmt="binary")
    raw = open(tmp_path / "vtk_output" / "lbm_000003.vtk", "rb").read()
    head, _, body = raw.partition(b"VECTORS velocity double\n")
    assert b"BINARY\n" in head
    assert f"DIMENSIONS {nx} {ny} 1".encode() in head
    n = nx * ny
    vec = np.frombuffer(body[:n * 3 * 8], dtype=">f8").reshape(n, 3)
    np.testing.assert_array_equal(vec[:, 0], ux.ravel())
    np.testing.assert_array_equal(vec[:, 1], uy.ravel())
    np.testing.assert_array_equal(vec[:, 2], 0.0)
    rest = body[n * 3 * 8:]
    _, _, rest = rest.partition(b"LOOKUP_TABLE default\n")
    mag = np.frombuffer(rest[:n * 8], dtype=">f8")
    np.testing.assert_array_equal(mag, np.sqrt(ux * ux + uy * uy).ravel())
    _, _, rest = rest.partition(b"LOOKUP_TABLE default\n")
    dens = np.frombuffer(rest[:n * 8], dtype=">f8")
    np.testing.assert_array_equal(dens, rho.ravel())


def test_checkpoint_resume_reproduces_run(tmp_path):
    # uninterrupted run
    p_full = tiny_params(tmp_path / "full", num_timesteps=80,
                         enable_vtk=False, precision="f64")
    Runner(p_full, verbose=False).run()
    full_vf = open(tmp_path / "full" / "velocity_field.csv").read()

    # interrupted at 40, then resumed
    p_half = tiny_params(tmp_path / "resumed", num_timesteps=40,
                         enable_vtk=False, precision="f64",
                         checkpoint_every=1)
    Runner(p_half, verbose=False).run()
    assert ckpt.latest(str(tmp_path / "resumed" / "checkpoints")) is not None
    p_resume = p_half.replace(num_timesteps=80)
    result = Runner(p_resume, verbose=False).run(resume=True)
    assert result.final_step == 80
    resumed_vf = open(tmp_path / "resumed" / "velocity_field.csv").read()
    assert resumed_vf == full_vf

    # forces.csv continues without duplicating rows
    steps = [r.split(",")[0] for r in
             open(tmp_path / "resumed" / "forces.csv").read().splitlines()[1:]]
    assert steps == ["0", "20", "40", "60"]


def test_checkpoint_sharded_resume_on_mesh(tmp_path):
    # multi-device runs write per-shard checkpoint directories (one .npz of
    # addressable shards per process + manifest.json) and resume by
    # device_put-ing each shard straight back — the global f is never
    # materialized on the host (VERDICT r2 #4)
    mesh_shape = (2, 4)
    p_full = tiny_params(tmp_path / "full", num_timesteps=80,
                         enable_vtk=False, precision="f64",
                         mesh_shape=mesh_shape)
    Runner(p_full, verbose=False).run()
    full_vf = open(tmp_path / "full" / "velocity_field.csv").read()

    p_half = tiny_params(tmp_path / "resumed", num_timesteps=40,
                         enable_vtk=False, precision="f64",
                         checkpoint_every=1, mesh_shape=mesh_shape)
    Runner(p_half, verbose=False).run()
    latest = ckpt.latest(str(tmp_path / "resumed" / "checkpoints"))
    assert latest is not None and os.path.isdir(latest)
    assert os.path.exists(os.path.join(latest, "manifest.json"))
    assert os.path.exists(os.path.join(latest, "proc_00000.npz"))
    # 8 shards recorded, all in this single process's file
    import json
    with open(os.path.join(latest, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert len(manifest["files"]) == 8
    with np.load(os.path.join(latest, "proc_00000.npz")) as d:
        assert len(d.files) == 8
        assert d[d.files[0]].shape == (9, 32 // 2, 64 // 4)

    result = Runner(p_half.replace(num_timesteps=80),
                    verbose=False).run(resume=True)
    assert result.final_step == 80
    assert open(tmp_path / "resumed" / "velocity_field.csv").read() == full_vf

    # an incompatible restore mesh is rejected with a clear error (re-query
    # latest: the resumed run's saves pruned the step-40 checkpoint)
    from tpulbm.parallel.mesh import make_mesh
    from jax.sharding import PartitionSpec as P
    latest = ckpt.latest(str(tmp_path / "resumed" / "checkpoints"))
    with pytest.raises(ValueError, match="incompatible mesh"):
        ckpt.load_sharded(latest, make_mesh((8, 1)), P(None, "y", "x"))


def test_checkpoint_rejects_mismatched_params(tmp_path):
    p = tiny_params(tmp_path, checkpoint_every=1, enable_vtk=False)
    Runner(p, verbose=False).run()
    latest = ckpt.latest(str(tmp_path / "checkpoints"))
    with pytest.raises(ValueError):
        ckpt.load(latest, p.replace(tau=0.7))
    # ALL physics-relevant fields are guarded, not just grid/tau/problem
    for change in (dict(inlet_velocity=0.01), dict(collision="trt"),
                   dict(obstacle_bc="bounce_back"), dict(precision="f64"),
                   dict(body_force=(1e-5, 0.0))):
        with pytest.raises(ValueError):
            ckpt.load(latest, p.replace(**change))
    # runtime-only fields may differ freely (extending a run, new mesh, …)
    step, _ = ckpt.load(latest, p.replace(num_timesteps=999, output_dir="/x",
                                          mesh_shape=(2, 1), enable_vtk=False))
    assert step == 60


def test_force_writer_resume_drops_overlapping_rows(tmp_path):
    path = str(tmp_path / "forces.csv")
    with io_mod.ForceWriter(path) as w:
        for t in (0, 20, 40, 60):
            w.record(t, 1.0, 2.0, 3.0, 4.0)
    # resume from a checkpoint at t=40: rows 40, 60 were recorded after it
    # and will be re-recorded — they must be dropped, not duplicated
    with io_mod.ForceWriter(path, append=True, resume_step=40) as w:
        w.record(40, 1.5, 2.5, 3.5, 4.5)
    rows = open(path).read().splitlines()
    assert rows[0] == io_mod.ForceWriter.HEADER.strip()
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "20", "40"]
    assert rows[3].startswith("40,1.50000000")


def test_runner_aborts_on_instability(tmp_path):
    # tau barely above 0.5 with a large impulsive velocity blows up quickly;
    # the runner must abort with success=False and not write final CSVs
    params = tiny_params(tmp_path, tau=0.501, inlet_velocity=0.3,
                         num_timesteps=2000, output_frequency=100,
                         enable_vtk=False)
    result = Runner(params, verbose=False).run()
    assert not result.success
    assert not (tmp_path / "velocity_field.csv").exists()


def test_super_chunk_path_matches_interval_path(tmp_path):
    # long enough that the batched-diagnostics fast path engages
    # (num_timesteps > _SUPER_K * freq); must produce identical forces.csv
    # AND identical VTK frames (frames ride the same batched gather now)
    import tpulbm.runner as runner_mod
    base = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                num_timesteps=400, output_frequency=20, enable_vtk=True,
                precision="f64")
    pa = SimulationParams(output_dir=str(tmp_path / "super"), **base)
    Runner(pa, verbose=False).run()

    orig = runner_mod._SUPER_K
    runner_mod._SUPER_K = 10 ** 9  # force the per-interval path
    try:
        pb = SimulationParams(output_dir=str(tmp_path / "plain"), **base)
        Runner(pb, verbose=False).run()
    finally:
        runner_mod._SUPER_K = orig

    fa = open(tmp_path / "super" / "forces.csv").read()
    fb = open(tmp_path / "plain" / "forces.csv").read()
    assert fa == fb
    va = open(tmp_path / "super" / "velocity_field.csv").read()
    vb = open(tmp_path / "plain" / "velocity_field.csv").read()
    assert va == vb
    frames_a = sorted(os.listdir(tmp_path / "super" / "vtk_output"))
    frames_b = sorted(os.listdir(tmp_path / "plain" / "vtk_output"))
    assert frames_a == frames_b and len(frames_a) == 19  # t=20..380
    for name in (frames_a[0], frames_a[7], frames_a[-1]):
        ba = open(tmp_path / "super" / "vtk_output" / name, "rb").read()
        bb = open(tmp_path / "plain" / "vtk_output" / name, "rb").read()
        assert ba == bb, name


def test_binary_vtk_3d_frame(tmp_path):
    # nz > 1 binary frame: same legacy sections, big-endian doubles, uz in
    # the vector block (ascii 3-D parity is covered by the writer itself)
    rng = np.random.default_rng(5)
    nz, ny, nx = 4, 6, 8
    ux, uy, uz = (rng.standard_normal((nz, ny, nx)) * 0.1 for _ in range(3))
    rho = 1.0 + rng.standard_normal((nz, ny, nx)) * 0.01
    params = SimulationParams(nx=nx, ny=ny, nz=nz, problem="cylinder3d")

    io_mod.write_vtk_timestep(ux, uy, rho, params, 7, str(tmp_path),
                              uz=uz, fmt="binary")
    raw = open(tmp_path / "vtk_output" / "lbm_000007.vtk", "rb").read()
    head, _, body = raw.partition(b"VECTORS velocity double\n")
    assert f"DIMENSIONS {nx} {ny} {nz}".encode() in head
    n = nx * ny * nz
    vec = np.frombuffer(body[:n * 3 * 8], dtype=">f8").reshape(n, 3)
    np.testing.assert_array_equal(vec[:, 0], ux.ravel())
    np.testing.assert_array_equal(vec[:, 2], uz.ravel())
    _, _, rest = body[n * 3 * 8:].partition(b"LOOKUP_TABLE default\n")
    mag = np.frombuffer(rest[:n * 8], dtype=">f8")
    np.testing.assert_allclose(
        mag, np.sqrt(ux * ux + uy * uy + uz * uz).ravel(), rtol=0, atol=0)
