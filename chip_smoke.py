#!/usr/bin/env python
"""Smoke test of the solver's main path on NVIDIA GPUs.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the sharded path only

One GPU, in this order:
  0. the tests marked `gpu` (pytest, in a child process that exits
     before this process opens the card);
  1. the card's name and power limit (nvidia-smi) and the JAX version;
  2. compile and run `__graft_entry__.entry()`;
  3. `main.py --preset reference-default` in process at 2048x512 for
     2800 steps: one finite forces.csv row per 140-step interval, and
     velocity_field.csv written;
  4. every step tier the chooser can pick on the GPU against the plain
     reference step (ops/step_jax.make_step_rolled, or the thermal and
     multiphase oracles) after 280 steps: f32 max|df| <= 1e-5 max|f|,
     f64 <= 1e-12 max|f|;
  5. Strouhal number at Re=100 on 1024x256 (50k steps): 0.16 <= St <= 0.21;
  6. the fused kernel against the XLA tier through make_chunk_fn
     (chunk_len 140, f32) at 2048x512 and 8192x4096: median MLUPS of
     7 windows each, alternating.

--four runs only the sharded checks: the flagship at 4096x2048 on a 2x2
mesh against the 1x1 run of the same steps, and `main.py --mesh auto`
through the runner on all four cards.

Any failed phase raises, so the process exits non-zero and prints no
result. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 1e-5      # max|df| / max|f| after 280 f32 steps
F64_TOL = 1e-12     # the f64 golden tolerance of the test suite
STEPS = 280


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def run_gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", "tests/"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    print(f"[gpu tests] {summary}", flush=True)
    if proc.returncode != 0 or "skipped" in summary or "passed" not in summary:
        sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError("the gpu-marked tests did not all pass")


def rel_err(got, ref) -> float:
    import numpy as np
    got, ref = np.asarray(got), np.asarray(ref)
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def oracle(step, f0, n):
    import jax
    from jax import lax
    run = jax.jit(lambda f: lax.fori_loop(0, n, lambda i, g: step(g), f))
    return jax.device_get(run(f0))


def run_chunks(problem, mesh, n_steps, chunk_len, tier=None):
    import jax
    import numpy as np
    from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state
    chunk = make_chunk_fn(problem, mesh, chunk_len, tier=tier)
    solid = (problem.solid if problem.solid is not None
             else np.zeros(problem.spatial_shape, bool))
    f, s = shard_state(mesh, problem.initial_state(), solid)
    for _ in range(n_steps // chunk_len):
        f = chunk(f, s)
    return chunk.tier, jax.device_get(f)


def phase_entry() -> None:
    import jax
    import numpy as np
    from __graft_entry__ import entry
    fn, args = entry()
    t = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    out = np.asarray(jax.device_get(compiled(*args)))
    assert out.shape == args[0].shape and np.isfinite(out).all()
    print(f"[entry] compiled and ran in {time.perf_counter() - t:.1f} s, "
          f"out {out.shape}", flush=True)


def phase_main() -> None:
    import numpy as np
    import main as cli
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "local")) as d:
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--preset", "reference-default", "--no-vtk",
                           "--num-timesteps", "2800", "--no-resume",
                           "--output-dir", d])
        log = buf.getvalue()
        print("\n".join(l for l in log.splitlines()
                        if "Device mesh" in l or "Throughput" in l),
              flush=True)
        assert rc == 0, log[-3000:]
        assert "step tier triton" in log, log[:2000]
        rows = open(os.path.join(d, "forces.csv")).read().splitlines()[1:]
        steps = [int(r.split(",")[0]) for r in rows]
        assert steps == list(range(0, 2800, 140)), steps
        vals = np.array([[float(v) for v in r.split(",")[1:]] for r in rows])
        assert np.isfinite(vals).all()
        vf = os.path.join(d, "velocity_field.csv")
        with open(vf) as fh:
            n_lines = sum(1 for _ in fh)
        assert n_lines >= 2048 * 512, n_lines
        print(f"[main] reference-default 2048x512, 2800 steps: rc 0, "
              f"{len(rows)} finite force rows, velocity_field.csv "
              f"{n_lines} lines, {time.perf_counter() - t:.1f} s",
              flush=True)


def phase_tiers() -> None:
    import jax
    import jax.numpy as jnp
    from tpulbm.config import PRESETS, SimulationParams
    from tpulbm.models import make_problem
    from tpulbm.ops.step_jax import make_step_rolled
    from tpulbm.ops.step_multiphase import make_step_multiphase
    from tpulbm.ops.step_thermal import make_step_thermal
    from tpulbm.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    flag = SimulationParams(nx=2048, ny=512, precision="f32")
    cases = [
        # (name, params, forced tier or None for the chooser's, oracle)
        ("cylinder 2048x512", flag, None, make_step_rolled),
        ("cylinder 2048x512", flag, "xla", make_step_rolled),
        ("cylinder bounce-back 2048x512",
         flag.replace(obstacle_bc="bounce_back"), None, make_step_rolled),
        ("poiseuille 1024x256", PRESETS["poiseuille"].replace(
            nx=1024, ny=256, precision="f32"), None, make_step_rolled),
        ("cylinder trt 2048x512", flag.replace(collision="trt"), None,
         make_step_rolled),
        ("cylinder bouzidi 2048x512", flag.replace(obstacle_bc="bouzidi"),
         None, make_step_rolled),
        ("sphere D3Q19 128^3", SimulationParams(
            nx=128, ny=128, nz=128, problem="cylinder3d", precision="f32",
            cylinder_radius=0.1), None, make_step_rolled),
        ("rayleigh-benard 512x256", PRESETS["rayleigh-benard"].replace(
            nx=512, ny=256, precision="f32"), None, make_step_thermal),
        ("multiphase 512x512", SimulationParams(
            nx=512, ny=512, problem="multiphase", tau=1.0,
            shan_chen_g=-5.0, cylinder_radius=0.15, cylinder_x=0.5,
            cylinder_y=0.5, inlet_velocity=0.0, precision="f32"), None,
         make_step_multiphase),
    ]
    for name, params, tier, make_oracle in cases:
        problem = make_problem(params)
        with jax.default_matmul_precision("highest"):
            ref = oracle(make_oracle(problem),
                         jnp.asarray(problem.initial_state()), STEPS)
        got_tier, got = run_chunks(problem, mesh, STEPS, STEPS // 2, tier)
        err = rel_err(got, ref)
        print(f"[tiers] {name} f32 {got_tier}: max|df|/max|f| = {err:.3e} "
              f"(limit {F32_TOL:g})", flush=True)
        assert err <= F32_TOL, (name, got_tier, err)
    jax.config.update("jax_enable_x64", True)
    problem = make_problem(flag.replace(precision="f64"))
    with jax.default_matmul_precision("highest"):
        ref = oracle(make_step_rolled(problem),
                     jnp.asarray(problem.initial_state()), STEPS)
    got_tier, got = run_chunks(problem, mesh, STEPS, STEPS // 2)
    err = rel_err(got, ref)
    print(f"[tiers] cylinder 2048x512 f64 {got_tier}: max|df|/max|f| = "
          f"{err:.3e} (limit {F64_TOL:g})", flush=True)
    assert got_tier == "xla" and err <= F64_TOL, err
    jax.config.update("jax_enable_x64", False)


def phase_strouhal() -> None:
    import jax
    import numpy as np
    from tpulbm.config import SimulationParams, tau_for_reynolds
    from tpulbm.models import make_problem
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import (make_super_chunk_fn,
                                              shard_state)
    from tpulbm.utils.analysis import strouhal_number

    ny, u, re = 256, 0.05, 100.0
    params = SimulationParams(nx=1024, ny=ny, inlet_velocity=u,
                              tau=tau_for_reynolds(re, u, ny),
                              precision="f32")
    problem = make_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    # forces sampled every 250 steps on the device, fetched 8 at a time
    sup = make_super_chunk_fn(problem, mesh, 250, 8)
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    ts, cls = [], []
    t = time.perf_counter()
    for k in range(25):  # 25 x 8 x 250 = 50k steps
        f, (forces_k, _, stable_k) = sup(f, solid)
        forces_k = np.asarray(jax.device_get(forces_k))
        assert bool(np.asarray(jax.device_get(stable_k)).all()), "unstable"
        for j in range(8):
            ts.append((k * 8 + j) * 250)
            cls.append(float(forces_k[j][1]))
    D = 2.0 * params.get_cylinder_radius_cells()
    res = strouhal_number(np.array(ts), np.array(cls) / (0.5 * u * u * D),
                          u, D, start=20000, prominence=0.1)
    print(f"[strouhal] Re=100 1024x256 50k steps: {res} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    assert res is not None and res["n_peaks"] >= 6, res
    assert 0.16 <= res["strouhal"] <= 0.21, res


def phase_timing(card: str) -> None:
    import jax
    import numpy as np
    from tpulbm.config import SimulationParams
    from tpulbm.models import make_problem
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import (make_chunk_fn,
                                              shard_initial_state)

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    L, per_window, windows = 140, 4, 7
    for nx, ny in ((2048, 512), (8192, 4096)):
        problem = make_problem(SimulationParams(nx=nx, ny=ny,
                                                precision="f32"))
        runs = {}
        for tier in ("triton", "xla"):
            chunk = make_chunk_fn(problem, mesh, L, tier=tier)
            f, s = shard_initial_state(problem, mesh)
            for _ in range(2):
                f = chunk(f, s)
            jax.block_until_ready(f)
            runs[tier] = [chunk, f, s, []]
        for _ in range(windows):
            for tier, run in runs.items():
                chunk, f, s, dts = run
                t = time.perf_counter()
                for _ in range(per_window):
                    f = chunk(f, s)
                jax.block_until_ready(f)
                dts.append(time.perf_counter() - t)
                run[1] = f
        for tier, (chunk, f, s, dts) in runs.items():
            assert bool(jax.device_get(jax.numpy.isfinite(f).all()))
            mlups = nx * ny * L * per_window / float(np.median(dts)) / 1e6
            print(f"[timing] {card} | {nx}x{ny} f32 {tier}: median "
                  f"{mlups:.1f} MLUPS over {windows} windows of "
                  f"{L * per_window} steps; {mlups * 72 / 1e3:.1f} GB/s "
                  f"at the 72 B/cell-step floor; "
                  f"{3.35e12 / (mlups * 1e6):.1f} B/cell-step at the "
                  f"published 3.35 TB/s", flush=True)
        del runs
    # bandwidth reference in the same call: one read + one write of a
    # state-sized f32 array
    x = jax.numpy.ones((9, 4096, 8192), jax.numpy.float32)
    scale = jax.jit(lambda a: a * 1.0001, donate_argnums=(0,))
    x = scale(scale(x))
    jax.block_until_ready(x)
    dts = []
    for _ in range(windows):
        t = time.perf_counter()
        for _ in range(10):
            x = scale(x)
        jax.block_until_ready(x)
        dts.append(time.perf_counter() - t)
    copy_gbs = 2 * x.nbytes * 10 / float(np.median(dts)) / 1e9
    print(f"[timing] {card} | read+write of a {x.nbytes / 1e9:.2f} GB f32 "
          f"array: {copy_gbs:.1f} GB/s", flush=True)
    del x
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[timing] peak_bytes_in_use {peak}", flush=True)


def phase_four() -> None:
    import jax
    import numpy as np
    from tpulbm.config import SimulationParams
    from tpulbm.models import make_problem
    from tpulbm.parallel.mesh import choose_decomposition, make_mesh
    import main as cli

    devs = jax.devices()
    assert len(devs) >= 4, devs
    mesh4 = make_mesh((2, 2), devices=devs[:4])
    assert len({d.id for d in mesh4.devices.flat}) == 4, mesh4
    problem = make_problem(SimulationParams(nx=4096, ny=2048,
                                            precision="f32"))
    tier1, one = run_chunks(problem, make_mesh((1, 1), devices=devs[:1]),
                            STEPS, STEPS // 2)
    tier4, four = run_chunks(problem, mesh4, STEPS, STEPS // 2)
    err = rel_err(four, one)
    print(f"[four] 4096x2048 {tier4} on 2x2 vs {tier1} on 1x1 after {STEPS} "
          f"steps: max|df|/max|f| = {err:.3e} (limit {F32_TOL:g})",
          flush=True)
    assert err <= F32_TOL, err

    auto = choose_decomposition(4, 2048, 512)
    assert len({d.id for d in make_mesh(auto, devices=devs[:4])
                .devices.flat}) == 4
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "local")) as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--preset", "reference-default", "--mesh", "auto",
                           "--no-vtk", "--num-timesteps", "1400",
                           "--no-resume", "--output-dir", d])
        log = buf.getvalue()
        print("\n".join(l for l in log.splitlines()
                        if "Device mesh" in l or "Throughput" in l),
              flush=True)
        assert rc == 0, log[-3000:]
        assert f"Device mesh: {auto[0]}×{auto[1]} (gpu)" in log, log[:2000]
        rows = open(os.path.join(d, "forces.csv")).read().splitlines()[1:]
        assert len(rows) == 10 and all(
            np.isfinite([float(v) for v in r.split(",")]).all()
            for r in rows), rows
    print(f"[four] main.py --mesh auto: {auto[0]}x{auto[1]} mesh over 4 "
          f"devices, rc 0, {len(rows)} finite force rows", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded checks")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "tpulbm")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"no NVIDIA GPU found ({e})", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(os.path.join(REPO, "local"), exist_ok=True)
    if not args.four:
        run_gpu_tests()

    import jax
    from tpulbm.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"JAX found no GPU (platform {dev.platform})", file=sys.stderr)
        return 2
    first = card.splitlines()[0]
    print(first, flush=True)
    print(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    if args.four:
        phase_four()
    else:
        phase_entry()
        phase_main()
        phase_tiers()
        phase_strouhal()
        phase_timing(first)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
