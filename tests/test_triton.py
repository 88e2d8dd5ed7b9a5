"""The GPU step tier: the fused Triton kernel (ops/step_triton.py), the
tier chooser (parallel/sharded_step.choose_tier), and the compile-cache
path rule.

On the CPU the kernel runs in the Pallas interpreter (interpret=True is
passed explicitly; the chooser itself never picks it here) through the
same make_chunk_fn body the GPU runs, on every mesh shape, against the
rolled oracle. The `gpu` test runs the compiled kernel on the card."""
import jax
import numpy as np
import pytest

from tpulbm.config import PRESETS, SimulationParams
from tpulbm.models import make_problem
from tpulbm.ops import step_triton
from tpulbm.ops.step_jax import make_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import (choose_tier, make_chunk_fn,
                                          shard_state)
from tpulbm.utils import jaxcache

_CYL = SimulationParams(nx=40, ny=24, tau=0.6, inlet_velocity=0.05,
                        precision="f32")
_POIS = PRESETS["poiseuille"].replace(nx=32, ny=20, body_force=(1e-4, 0.0),
                                      precision="f32")
_TG = PRESETS["taylor-green"].replace(nx=32, ny=32, precision="f32")

# (params, mesh_shape, chunk_len, n_chunks)
_KERNEL_CASES = {
    "cylinder-1x1": (_CYL, (1, 1), 6, 2),
    "cylinder-y": (_CYL, (2, 1), 6, 2),
    "cylinder-y4": (_CYL, (4, 1), 6, 1),
    "cylinder-x": (_CYL, (1, 2), 6, 2),
    "cylinder-xy": (_CYL, (2, 2), 6, 2),
    "cylinder-4x2": (_CYL.replace(nx=48), (4, 2), 4, 1),
    # widths/heights that are not multiples of the tile: the last tile
    # moves back and overlaps its neighbour
    "cylinder-npot": (_CYL.replace(nx=44, ny=22), (1, 1), 6, 1),
    "cylinder-npot-xy": (_CYL.replace(nx=44, ny=22), (2, 2), 6, 1),
    "cylinder-wide": (_CYL.replace(nx=600, ny=8, cylinder_radius=0.2),
                      (1, 1), 3, 1),
    # chunk lengths with an odd remainder and with no fused launch
    "cylinder-odd-chunk": (_CYL, (1, 1), 5, 2),
    "cylinder-one-step": (_CYL, (2, 2), 1, 3),
    "bounce-back-1x1": (_CYL.replace(obstacle_bc="bounce_back"), (1, 1),
                        6, 2),
    "bounce-back-xy": (_CYL.replace(obstacle_bc="bounce_back"), (2, 2),
                       6, 2),
    "poiseuille-1x1": (_POIS, (1, 1), 6, 2),
    "poiseuille-x": (_POIS, (1, 2), 6, 2),
    "taylor-green-xy": (_TG, (2, 2), 6, 2),
}


def _oracle(problem, n_steps):
    step = jax.jit(make_step_rolled(problem))
    f = problem.initial_state()
    for _ in range(n_steps):
        f = step(f)
    return np.asarray(f)


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_triton_matches_rolled(case):
    params, mesh_shape, chunk_len, n_chunks = _KERNEL_CASES[case]
    problem = make_problem(params)
    assert step_triton.covers(problem)
    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(problem, mesh, chunk_len, tier="triton",
                          interpret=True)
    assert chunk.tier == "triton"
    solid = (problem.solid if problem.solid is not None
             else np.zeros(problem.spatial_shape, bool))
    f, s = shard_state(mesh, problem.initial_state(), solid)
    for _ in range(n_chunks):
        f = chunk(f, s)
    ref = _oracle(problem, chunk_len * n_chunks)
    got = np.asarray(jax.device_get(f))
    assert np.isfinite(got).all()
    # f32, a few steps: rounding only (summation order differs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_triton_rejects_uncovered_problem():
    problem = make_problem(_CYL.replace(collision="trt"))
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="does not cover"):
        make_chunk_fn(problem, mesh, 4, tier="triton", interpret=True)
    with pytest.raises(ValueError, match="unknown step tier"):
        make_chunk_fn(problem, mesh, 4, tier="pallas")


# family -> (params, tier the chooser picks on a GPU)
_FAMILIES = {
    "cylinder-bgk": (_CYL, "triton"),
    "cylinder-bounce-back": (_CYL.replace(obstacle_bc="bounce_back"),
                             "triton"),
    "poiseuille": (_POIS, "triton"),
    "taylor-green": (_TG, "triton"),
    "cylinder-f64": (_CYL.replace(precision="f64"), "xla"),
    "cylinder-trt": (_CYL.replace(collision="trt"), "xla"),
    "cylinder-mrt": (_CYL.replace(collision="mrt"), "xla"),
    "cylinder-kbc": (_CYL.replace(collision="kbc"), "xla"),
    "cylinder-les": (_CYL.replace(smagorinsky=0.1), "xla"),
    "cylinder-power-law": (_CYL.replace(power_law_n=0.8), "xla"),
    "cylinder-bouzidi": (_CYL.replace(obstacle_bc="bouzidi"), "xla"),
    "cylinder-clean-corners": (_CYL.replace(zou_he_corners="clean"), "xla"),
    "shear-layer": (PRESETS["shear-layer"].replace(nx=32, ny=32), "xla"),
    "cavity-lid": (PRESETS["cavity"].replace(nx=16, ny=16), "xla"),
    "kolmogorov": (PRESETS["kolmogorov"].replace(nx=32, ny=32), "xla"),
    "thermal": (PRESETS["rayleigh-benard"].replace(nx=32, ny=16), "xla"),
    "multiphase": (SimulationParams(nx=32, ny=32, problem="multiphase",
                                    tau=1.0, shan_chen_g=-5.0,
                                    cylinder_radius=0.15, cylinder_x=0.5,
                                    cylinder_y=0.5, inlet_velocity=0.0),
                   "xla"),
    "sphere-3d": (SimulationParams(nx=16, ny=8, nz=8, problem="cylinder3d",
                                   cylinder_radius=0.2), "xla"),
}


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_choose_tier(family, platform):
    params, on_gpu = _FAMILIES[family]
    problem = make_problem(params)
    expected = on_gpu if platform == "gpu" else "xla"
    assert choose_tier(problem, platform) == expected
    assert step_triton.covers(problem) == (on_gpu == "triton")


@pytest.mark.parametrize("env", ["unset", "set"])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert jaxcache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = jaxcache._REPO
        assert jaxcache.cache_dir() == f"{repo}/.jax_cache"
        assert ".jax_cache/" in open(f"{repo}/.gitignore").read().split()


@pytest.mark.gpu
def test_triton_tier_on_gpu():
    """The compiled kernel, picked by the chooser, against the oracle."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    params = _CYL.replace(nx=256, ny=64)
    problem = make_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    f, s = shard_state(mesh, problem.initial_state(), problem.solid)
    # chunk lengths that take the scan, its odd remainder, and no scan
    for n in (70, 1, 2, 67):
        chunk = make_chunk_fn(problem, mesh, n)
        assert chunk.tier == "triton"
        f = chunk(f, s)
    ref = _oracle(problem, 140)
    got = np.asarray(jax.device_get(f))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
