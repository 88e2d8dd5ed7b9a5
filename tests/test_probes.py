"""Point probes (params.probe_points -> probes.csv): per-interval rho/u
at fixed cells, riding the super-chunk diagnostics round trip. New
capability — the reference has no probes (wake signals require dumping
full fields there)."""
import csv

import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem
from tpulbm.ops import diagnostics
from tpulbm.runner import Runner


def test_probes_fn_matches_moments():
    params = SimulationParams(nx=64, ny=32, precision="f64",
                              probe_points=((0.3, 0.5), (0.8, 0.25)))
    pr = make_problem(params)
    from tpulbm.ops.step_jax import make_step_rolled
    step = jax.jit(make_step_rolled(pr))
    f = pr.initial_state()
    for _ in range(20):
        f = step(f)
    vals = np.asarray(diagnostics.probes_fn(pr)(f))
    rho, u = physics.moments(pr.lattice, np.asarray(f))
    for k, (px, py) in enumerate(params.probe_points):
        x, y = int(px * 64), int(py * 32)
        np.testing.assert_allclose(vals[k, 0], np.asarray(rho)[y, x],
                                   rtol=1e-12)
        np.testing.assert_allclose(vals[k, 1:], np.asarray(u)[:, y, x],
                                   rtol=1e-9, atol=1e-15)


def test_runner_writes_probes_csv(tmp_path):
    params = SimulationParams(
        nx=128, ny=32, precision="f32", num_timesteps=300,
        output_frequency=50, enable_vtk=False,
        output_dir=str(tmp_path), probe_points=((0.5, 0.5), (0.9, 0.3)))
    res = Runner(params, verbose=False).run(resume=False)
    assert res.success
    with open(tmp_path / "probes.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) >= 5
    assert set(rows[0]) == {"timestep", "p0_rho", "p0_ux", "p0_uy",
                            "p1_rho", "p1_ux", "p1_uy"}
    # the wake probe sees the flow: nonzero streamwise velocity, sane rho
    last = rows[-1]
    assert 0.5 < float(last["p0_rho"]) < 1.5
    assert abs(float(last["p0_ux"])) > 1e-4


def test_probe_resume_dedup(tmp_path):
    def run(out, steps, resume):
        p = SimulationParams(
            nx=64, ny=32, precision="f32", num_timesteps=steps,
            output_frequency=50, enable_vtk=False,
            checkpoint_every=1, output_dir=out,
            probe_points=((0.5, 0.5),))
        return Runner(p, verbose=False).run(resume=resume)

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert run(a, 200, False).success
    assert run(b, 100, False).success
    assert run(b, 200, True).success
    fa = (tmp_path / "a" / "probes.csv").read_text()
    fb = (tmp_path / "b" / "probes.csv").read_text()
    assert fa == fb


def test_probe_cli_parsing():
    import argparse
    from tpulbm.config import add_cli_args, params_from_args
    ap = argparse.ArgumentParser()
    add_cli_args(ap)
    args = ap.parse_args(["--probe", "0.3,0.5;0.8,0.25", "--no-vtk"])
    p = params_from_args(args)
    assert p.probe_points == ((0.3, 0.5), (0.8, 0.25))
    # JSON round trip preserves the tuples
    from tpulbm.config import SimulationParams
    assert SimulationParams.from_json(p.to_json()).probe_points \
        == p.probe_points


def test_probe_dimensionality_validation():
    params = SimulationParams(nx=32, ny=16, probe_points=((0.5, 0.5, 0.5),))
    pr = make_problem(params)
    with pytest.raises(ValueError, match="dimensionality"):
        diagnostics.probe_cells(pr)


def test_thermal_probes_carry_temperature(tmp_path):
    params = SimulationParams(
        nx=64, ny=32, problem="rayleigh-benard", tau=0.55,
        thermal_tau=0.5704, rayleigh=3000.0, periodic_x=True,
        cylinder_radius=0.0, inlet_velocity=0.0, precision="f32",
        num_timesteps=200, output_frequency=50, enable_vtk=False, output_dir=str(tmp_path),
        probe_points=((0.5, 0.25),))
    res = Runner(params, verbose=False).run(resume=False)
    assert res.success
    with open(tmp_path / "probes.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert "p0_T" in rows[0]
    # the probe at quarter height sees a conductive-ish temperature
    t_vals = [float(r["p0_T"]) for r in rows]
    assert all(0.0 <= v <= 1.0 for v in t_vals)
    assert t_vals[-1] > 0.5           # lower half is hot (T_bottom = 1)
