"""3-D rectangular-duct flow: poiseuille with nz > 0.

A mixed-periodicity duct — periodic in x, no-slip walls in y AND z. No
reference analog: the C++ code is strictly 2-D (its Poiseuille machinery
is the dead code at LBMUtils.h:15-19, 68-121); the physics gate is the
classical rectangular-duct Fourier series instead.
"""

import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem
from tpulbm.models.poiseuille import analytic_profile_duct
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state


def _duct_params(**kw):
    d = dict(nx=8, ny=17, nz=17, problem="poiseuille", tau=0.8,
             body_force=(2e-6, 0.0), inlet_velocity=0.0, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def test_duct3d_profile_matches_analytic_series():
    """u_x(z, y) converges to the rectangular-duct Fourier series
    (measured: 0.97% relative RMSE at 17x17 after 6000 steps) and stays
    exactly x-invariant (periodic channel)."""
    pr = make_problem(_duct_params())
    step = jax.jit(make_step_rolled(pr))
    f = pr.initial_state()
    for _ in range(6000):
        f = step(f)
    _, u = physics.moments(pr.lattice, f)
    ux = np.asarray(u[0])                       # (nz, ny, nx)
    assert np.abs(ux - ux[:, :, :1]).max() < 1e-12
    prof = ux[:, :, 0]
    ana = analytic_profile_duct(pr.params)
    rmse = np.sqrt(np.mean((prof - ana) ** 2))
    assert rmse / ana.max() < 0.02, (rmse, ana.max())
    # symmetry about both centerlines
    np.testing.assert_allclose(prof, prof[::-1, :], rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(prof, prof[:, ::-1], rtol=1e-8, atol=1e-14)


def _run_duct(pr, mesh_shape, n_chunks=2, chunk_len=6):
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = make_chunk_fn(pr, mesh, chunk_len)
    s, solid = shard_state(mesh, pr.initial_state(),
                           np.zeros(pr.spatial_shape, bool))
    for _ in range(n_chunks):
        s = chunk(s, solid)
    return np.asarray(jax.device_get(s))


def test_duct3d_sharded_matches_oracle():
    """Sharded jax tier == unsharded single-device oracle (wrapped halo
    exchange in x is exact)."""
    pr = make_problem(_duct_params(nx=16, ny=16, nz=16))
    step = jax.jit(make_step_rolled(pr))
    f_ref = pr.initial_state()
    for _ in range(12):
        f_ref = step(f_ref)
    f_ref = np.asarray(jax.device_get(f_ref))
    got = _run_duct(pr, (2, 2))
    np.testing.assert_allclose(got, f_ref, rtol=1e-12, atol=1e-14)
