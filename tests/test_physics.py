"""Equilibrium/moment/collision identities against closed forms."""
import jax.numpy as jnp
import numpy as np

from tpulbm import physics
from tpulbm.lattice import D2Q9, D3Q19


def test_equilibrium_scalar_formula():
    # Direct check of f_eq_i = w_i rho (1 + 3 c·u + 4.5 (c·u)^2 - 1.5 u²)
    # against an independent loop (reference LBMUtils.h:9-12 algebra).
    rho = jnp.full((4, 4), 1.1)
    u = jnp.stack([jnp.full((4, 4), 0.03), jnp.full((4, 4), -0.01)])
    feq = np.asarray(physics.equilibrium(D2Q9, rho, u))
    for i in range(9):
        cx, cy = D2Q9.velocities[i]
        cu = cx * 0.03 + cy * -0.01
        expect = D2Q9.w[i] * 1.1 * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * (0.03**2 + 0.01**2))
        np.testing.assert_allclose(feq[i], expect, rtol=1e-12)


def test_equilibrium_moments_roundtrip():
    for lat in (D2Q9, D3Q19):
        rng = np.random.default_rng(0)
        shape = (5, 6) if lat.D == 2 else (3, 4, 5)
        rho = jnp.asarray(1.0 + 0.05 * rng.standard_normal(shape))
        u = jnp.asarray(0.05 * rng.standard_normal((lat.D,) + shape))
        feq = physics.equilibrium(lat, rho, u)
        rho2, u2 = physics.moments(lat, feq)
        np.testing.assert_allclose(np.asarray(rho2), np.asarray(rho), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(u2), np.asarray(u), atol=1e-13)


def test_collision_conserves_mass_momentum():
    rng = np.random.default_rng(1)
    f = jnp.asarray(np.abs(rng.standard_normal((9, 8, 8))) * 0.1 + 0.05)
    f_post = physics.collide(D2Q9, f, inv_tau=1.0 / 0.6)
    rho0, u0 = physics.moments(D2Q9, f)
    rho1, u1 = physics.moments(D2Q9, f_post)
    np.testing.assert_allclose(np.asarray(rho1), np.asarray(rho0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), atol=1e-12)


def test_rest_equilibrium_is_bgk_fixed_point():
    W = physics.rest_equilibrium(D2Q9)
    f = jnp.asarray(np.broadcast_to(W[:, None, None], (9, 4, 4)).copy())
    f_post = physics.collide(D2Q9, f, inv_tau=1.0 / 0.6)
    np.testing.assert_allclose(np.asarray(f_post), np.asarray(f), rtol=1e-14)


def test_uniform_equilibrium_is_fixed_point():
    eq = physics.uniform_equilibrium(D2Q9, 1.0, (0.01333, 0.0))
    f = jnp.asarray(np.broadcast_to(eq[:, None, None], (9, 4, 4)).copy())
    f_post = physics.collide(D2Q9, f, inv_tau=1.0 / 0.6)
    np.testing.assert_allclose(np.asarray(f_post), np.asarray(f), atol=1e-15)


def test_forced_equilibrium_term():
    # +3 w_i (c_i · F), reference LBMUtils.h:15-19.
    rho = jnp.ones((3, 3))
    u = jnp.zeros((2, 3, 3))
    F = (1e-5, 2e-5)
    feq = np.asarray(physics.equilibrium(D2Q9, rho, u))
    feqF = np.asarray(physics.equilibrium_with_force(D2Q9, rho, u, F))
    for i in range(9):
        cx, cy = D2Q9.velocities[i]
        np.testing.assert_allclose(feqF[i] - feq[i],
                                   3 * D2Q9.w[i] * (cx * F[0] + cy * F[1]),
                                   atol=1e-18)


def test_stability_predicate():
    f = jnp.ones((9, 4, 4))
    assert bool(physics.is_stable(f))
    assert not bool(physics.is_stable(f.at[0, 0, 0].set(jnp.nan)))
    assert not bool(physics.is_stable(f.at[0, 0, 0].set(2e5)))


def test_momentum_exchange_no_wrap_at_nonperiodic_edges():
    # A solid column on the x=0 edge must not pair with fluid on the x=nx-1
    # edge through jnp.roll's wraparound (the reference bounds-checks its
    # neighbor lookup instead, LBMIO.h:143-145). Populations are zero except
    # at the far edge, so any nonzero force can only come from wrapping.
    from tpulbm.config import SimulationParams
    from tpulbm.models import make_problem
    from tpulbm.ops.forces import momentum_exchange

    params = SimulationParams(nx=16, ny=8, num_timesteps=1)
    problem = make_problem(params)
    Q, ny, nx = 9, params.ny, params.nx

    for axis, edge_idx in ((1, (slice(None), 0)),    # solid col at x=0
                           (0, (0, slice(None)))):   # solid row at y=0
        solid = np.zeros((ny, nx), bool)
        solid[edge_idx[0], edge_idx[1]] = True
        f = np.zeros((Q, ny, nx), np.float64)
        if axis == 1:
            f[:, :, -1] = 1.0   # fluid populations only at x=nx-1
        else:
            f[:, -1, :] = 1.0   # only at y=ny-1
        force = np.asarray(momentum_exchange(problem, jnp.asarray(f),
                                             jnp.asarray(solid)))
        np.testing.assert_allclose(force, 0.0, atol=0.0)

    # and legitimate interior pairing still contributes: bias the
    # east-moving population so the drag is nonzero and exactly computable
    solid = np.zeros((ny, nx), bool)
    solid[4, 8] = True
    f = np.ones((Q, ny, nx), np.float64)
    f[1] = 2.0  # c_1 = (+1, 0)
    force = np.asarray(momentum_exchange(problem, jnp.asarray(f),
                                         jnp.asarray(solid)))
    # F_x = Σ_i 2 c_ix f_i over the 8 fluid neighbors of the solid cell:
    # the +x and -x columns cancel for f=1 except the f_1=2 excess at the
    # west neighbor: 2*(+1)*(2-1) = 2
    np.testing.assert_allclose(force[0], 2.0, atol=1e-12)
    np.testing.assert_allclose(force[1], 0.0, atol=1e-12)


def test_zou_he_clean_corners_enforce_no_slip():
    # the opt-in Zou & He (1997) corner closure: after the BC chain the four
    # wall∩inlet/outlet cells must carry u = v = 0 exactly, with the inlet
    # corners' density matching the adjacent inlet node and the outlet
    # corners pinned to rho_out = 1
    from tpulbm.config import SimulationParams
    from tpulbm.models import make_problem
    from tpulbm.ops import boundaries

    params = SimulationParams(nx=32, ny=16, tau=0.6, inlet_velocity=0.05,
                              cylinder_radius=0.0, zou_he_corners="clean")
    problem = make_problem(params)
    rng = np.random.default_rng(3)
    planes = [jnp.asarray(0.1 + 0.05 * rng.random((16, 32))) for _ in range(9)]
    yy, xx = np.ogrid[0:16, 0:32]
    coords = {"yy": yy, "xx": xx, "ny": 16, "nx": 32, "solid": None}
    planes = boundaries.apply_all(problem, planes, coords)
    f = np.stack([np.asarray(p) for p in planes])

    c = problem.lattice.c
    for (y, x) in ((0, 0), (0, 31), (15, 0), (15, 31)):
        rho = f[:, y, x].sum()
        ux = (c[:, 0] * f[:, y, x]).sum()
        uy = (c[:, 1] * f[:, y, x]).sum()
        np.testing.assert_allclose([ux, uy], 0.0, atol=1e-12)
        if x == 31:  # outlet corners: fixed density
            np.testing.assert_allclose(rho, 1.0, atol=1e-12)
        else:        # inlet corners: density of the adjacent inlet node
            yn = 1 if y == 0 else 14
            np.testing.assert_allclose(rho, f[:, yn, 0].sum(), atol=1e-12)


def test_clean_corners_run_is_stable_and_matches_away_from_corners():
    # a short f64 cylinder run with the clean-corner mode: stays stable,
    # and only corner-adjacent cells differ from the reference-corner run
    import jax

    from tpulbm.config import SimulationParams
    from tpulbm.models import make_problem
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state

    def run(corners):
        params = SimulationParams(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                                  precision="f64", zou_he_corners=corners)
        problem = make_problem(params)
        mesh = make_mesh((1, 1), devices=jax.devices()[:1])
        chunk = make_chunk_fn(problem, mesh, 4)
        f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
        f = chunk(f, solid)
        return np.asarray(jax.device_get(f))

    ref = run("reference")
    got = run("clean")
    assert np.isfinite(got).all()
    # interior far from the corners is identical after 4 steps: the closure
    # rewrites only the 4 corner cells, whose influence spreads 1 cell/step
    interior = (slice(None), slice(8, 24), slice(8, 56))
    np.testing.assert_allclose(got[interior], ref[interior], rtol=0, atol=0)
    assert not np.allclose(got, ref)  # ...but the corners do change
