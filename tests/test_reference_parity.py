"""Direct numerical parity vs the COMPILED, UNMODIFIED reference solver.

validation/build.sh compiles /root/reference's headers (read-only) against a
single-rank MPI shim; this test runs both solvers on identical parameters
and compares the artifacts cell-for-cell. This is the strongest possible
parity evidence: not an oracle re-implementation, the actual C++ binary.

Expected agreement: the reference runs f64 with -ffast-math; we run f64
(IEEE). Differences are pure rounding, amplified only mildly over a few
hundred steps of smooth flow.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.runner import Runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(ROOT, "validation", "build", "ref_driver")
DUMP_F = os.path.join(ROOT, "validation", "build", "ref_dump_f")


def _ensure_driver(path=DRIVER):
    if os.path.exists(path):
        return True
    build = os.path.join(ROOT, "validation", "build.sh")
    try:
        subprocess.run(["bash", build], check=True, capture_output=True,
                       timeout=300)
    except Exception:
        return False
    return os.path.exists(path)


@pytest.mark.slow
def test_matches_compiled_reference(tmp_path):
    if not _ensure_driver():
        pytest.skip("reference driver could not be built (no g++ / headers)")

    tau, u, nx, ny, steps, freq = 0.6, 0.05, 256, 64, 420, 140

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    r = subprocess.run([DRIVER, str(tau), str(u), str(nx), str(ny),
                        str(steps), str(freq), "0"],
                       cwd=ref_dir, capture_output=True, text=True,
                       timeout=600)
    assert "REFERENCE_RUN_OK" in r.stdout, r.stdout + r.stderr

    our_dir = tmp_path / "ours"
    params = SimulationParams(nx=nx, ny=ny, tau=tau, inlet_velocity=u,
                              num_timesteps=steps, output_frequency=freq,
                              precision="f64",
                              output_dir=str(our_dir), enable_vtk=False)
    result = Runner(params, verbose=False).run()
    assert result.success

    # forces.csv: same timesteps, same drag/lift to rounding
    ref_f = np.genfromtxt(ref_dir / "forces.csv", delimiter=",", names=True)
    our_f = np.genfromtxt(our_dir / "forces.csv", delimiter=",", names=True)
    np.testing.assert_array_equal(ref_f["timestep"], our_f["timestep"])
    # CSV carries 8 decimals; agreement beyond that is quantization noise
    np.testing.assert_allclose(our_f["drag_force"], ref_f["drag_force"],
                               rtol=1e-7, atol=2e-8)
    np.testing.assert_allclose(our_f["lift_force"], ref_f["lift_force"],
                               rtol=1e-7, atol=2e-8)

    # velocity_field.csv: cell-for-cell
    ref_v = np.genfromtxt(ref_dir / "velocity_field.csv", delimiter=",",
                          names=True)
    our_v = np.genfromtxt(our_dir / "velocity_field.csv", delimiter=",",
                          names=True)
    np.testing.assert_array_equal(ref_v["x"], our_v["x"])
    np.testing.assert_array_equal(ref_v["y"], our_v["y"])
    for col in ("ux", "uy", "rho"):
        np.testing.assert_allclose(our_v[col], ref_v[col], rtol=1e-7,
                                   atol=2e-8, err_msg=col)


def test_raw_f_state_matches_compiled_reference(tmp_path):
    """PARITY.md's strongest claim, as a gate: the raw post-BC f populations
    match the -ffast-math f64 binary (validation/ref_dump_f.cpp) to ~1e-15
    after 60 full steps of the complete pipeline (collision → streaming →
    walls → Zou-He inlet/outlet → obstacle; reference LBMSolver.h:48-76)."""
    if not _ensure_driver(DUMP_F):
        pytest.skip("ref_dump_f could not be built (no g++ / headers)")

    tau, u, nx, ny, steps = 0.6, 0.05, 256, 64, 60
    out_bin = tmp_path / "ref_f.bin"
    r = subprocess.run([DUMP_F, str(tau), str(u), str(nx), str(ny),
                        str(steps), str(out_bin)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=600)
    assert "OK" in r.stdout, r.stdout + r.stderr
    ref_f = np.fromfile(out_bin, dtype=np.float64).reshape(9, ny, nx)

    import jax
    from tpulbm.models import make_problem
    from tpulbm.ops.step_jax import make_step_rolled

    params = SimulationParams(nx=nx, ny=ny, tau=tau, inlet_velocity=u,
                              num_timesteps=steps, precision="f64")
    problem = make_problem(params)
    step = jax.jit(make_step_rolled(problem))
    f = np.asarray(problem.initial_state())
    fj = f
    for _ in range(steps):
        fj = step(fj)
    our_f = np.asarray(fj)

    # Solid cells: the reference's stored populations there are dynamically
    # dead (collision skips solids, LBMSolver.h:91) while ours hold rest
    # equilibrium by construction — compare fluid cells only (same
    # documented deviation as the NumPy oracle test).
    fluid = ~problem.solid
    err = np.abs(our_f[:, fluid] - ref_f[:, fluid]).max()
    assert err < 5e-15, f"max |Δf| over fluid cells after {steps} steps: {err}"
