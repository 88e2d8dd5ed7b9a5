"""D3Q27 lattice (new capability; the reference is 2-D only): quadrature
identities and step sanity — the steps are generic over the velocity set,
so these gates pin that the full isotropic 27-velocity set runs unchanged
(--lattice3d d3q27)."""
import itertools

import jax
import numpy as np
import pytest

from tpulbm import physics
from tpulbm.config import SimulationParams, validate_params
from tpulbm.lattice import D3Q27
from tpulbm.models import make_problem
from tpulbm.ops.step_jax import make_step_rolled


def test_d3q27_quadrature_identities():
    w, c = D3Q27.w, D3Q27.c.astype(np.float64)
    assert D3Q27.Q == 27
    # every (cx, cy, cz) in {-1,0,1}^3 exactly once
    assert set(map(tuple, D3Q27.c.tolist())) == \
        set(itertools.product((-1, 0, 1), repeat=3))
    assert abs(w.sum() - 1.0) < 1e-15
    np.testing.assert_allclose(np.einsum("i,ia->a", w, c), 0.0, atol=1e-15)
    # second moment: cs2 * I
    np.testing.assert_allclose(np.einsum("i,ia,ib->ab", w, c, c),
                               np.eye(3) / 3.0, atol=1e-15)
    # full fourth-order isotropy: sum w c_a c_b c_c c_d =
    # cs4 (d_ab d_cd + d_ac d_bd + d_ad d_bc) — D3Q19 satisfies this only
    # on-diagonal; D3Q27 exactly (the point of the bigger set)
    m4 = np.einsum("i,ia,ib,ic,id->abcd", w, c, c, c, c)
    d = np.eye(3)
    iso = (np.einsum("ab,cd->abcd", d, d) + np.einsum("ac,bd->abcd", d, d)
           + np.einsum("ad,bc->abcd", d, d)) / 9.0
    np.testing.assert_allclose(m4, iso, atol=1e-15)
    # derived opposite map is an involution with c[opp] == -c
    opp = D3Q27.opposite
    assert (opp[opp] == np.arange(27)).all()
    assert (D3Q27.c[opp] == -D3Q27.c).all()


def test_d3q27_moments_equilibrium_roundtrip():
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.05 * rng.standard_normal((4, 5, 6))
    u = 0.05 * rng.standard_normal((3, 4, 5, 6))
    feq = physics.equilibrium(D3Q27, rho, u)
    rho2, u2 = physics.moments(D3Q27, feq)
    np.testing.assert_allclose(np.asarray(rho2), rho, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(u2), u, rtol=1e-10, atol=1e-14)


def _params(**kw):
    d = dict(nx=32, ny=16, nz=8, problem="cylinder3d", tau=0.6,
             inlet_velocity=0.05, precision="f64", lattice3d="d3q27")
    d.update(kw)
    return SimulationParams(**d)


def test_d3q27_step_runs_and_is_sane():
    problem = make_problem(_params())
    assert problem.lattice is D3Q27
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    assert f.shape == (27, 8, 16, 32)
    for _ in range(20):
        f = step(f)
    assert bool(physics.is_stable(f))
    rho, u = physics.moments(D3Q27, f)
    assert 0.8 < float(np.asarray(rho).mean()) < 1.2
    assert float(np.asarray(u[0])[:, :, 2:6].mean()) > 0


def test_d3q27_config_validation():
    validate_params(_params())
    validate_params(_params(collision="trt"))
    with pytest.raises(ValueError, match="D2Q9/D3Q19"):
        validate_params(_params(collision="mrt"))
    with pytest.raises(ValueError, match="d3q19"):
        validate_params(_params(lattice3d="d3q15"))
