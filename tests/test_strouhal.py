"""Vortex-shedding physics gate: Strouhal number of the Kármán street
(SURVEY §4; reference validation scripts/lift.py:112, README.md §4).

The full validated result lives in runs/re200 (120k steps, 2048x512:
St = 0.2177 vs the reference's claimed ≈0.22). This gate runs Re=100 on
1024x256 for 50k steps, calibrated to St ≈ 0.186 (blockage-elevated from
the unconfined 0.164, matching the behavior of the reference's confined
setup).

On a GPU the same check runs as a phase of `python chip_smoke.py`. Here it
runs on the 8-device CPU mesh when TPULBM_RUN_SLOW_PHYSICS=1 is set
(~10 min on 8 cores).
"""
import os

import numpy as np
import pytest

pytestmark = [pytest.mark.slow]


def test_vortex_shedding_strouhal_number():
    if not os.environ.get("TPULBM_RUN_SLOW_PHYSICS"):
        pytest.skip("set TPULBM_RUN_SLOW_PHYSICS=1 for the CPU-mesh run; "
                    "chip_smoke.py runs it on a GPU")

    # opt-in CPU-mesh path (uses this process's 8-device virtual mesh)
    import jax
    from tpulbm.config import SimulationParams, tau_for_reynolds
    from tpulbm.models import make_problem
    from tpulbm.ops import forces as fmod
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state
    from tpulbm.utils.analysis import strouhal_number

    ny, u, re = 256, 0.05, 100.0
    params = SimulationParams(nx=1024, ny=ny, inlet_velocity=u,
                              tau=tau_for_reynolds(re, u, ny),
                              precision="f32")
    problem = make_problem(params)
    mesh = make_mesh((2, 4))
    chunk = make_chunk_fn(problem, mesh, 250)
    ffn = jax.jit(fmod.forces_fn(problem))
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)

    ts, cls = [], []
    for k in range(200):  # 50k steps
        ts.append(k * 250)
        cls.append(float(np.asarray(jax.device_get(ffn(f)))[1]))
        f = chunk(f, solid)

    D = 2.0 * params.get_cylinder_radius_cells()
    q = 0.5 * u * u * D
    res = strouhal_number(np.array(ts), np.array(cls) / q, u, D,
                          start=20000, prominence=0.1)
    assert res is not None, "no vortex shedding detected"
    assert res["n_peaks"] >= 6
    assert 0.16 <= res["strouhal"] <= 0.21, res
