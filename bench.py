#!/usr/bin/env python
"""Benchmark harness: MLUPS/device on the D2Q9 cylinder grid.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...extras},
where "device" names the platform, device kind and device count the number
was taken on (the C++ reference publishes no throughput numbers at all).

Times the pure compute path (chunked scan, no host IO) on the default
2048x512 grid — the reference's workload (LBMConfig.h:39-41) — in the f32
production dtype, with the step tier the platform picks
(parallel/sharded_step.choose_tier). The headline is the median of
`--repeats` timed windows, each ended by block_until_ready.

`--nz N` benches the D3Q19 sphere-in-duct problem instead (3-D is a
capability the 2-D-only reference lacks; same JSON contract, cells =
nx*ny*nz).

Scaling modes (BASELINE config 4; the reference only scales via
`mpirun -np N`, README.md:110-112):
  --mesh MYxMX          run on an explicit device mesh
  --sweep weak|strong   one JSON line per device count (weak: grid grows
                        with the mesh; strong: fixed global grid)
  --cpu-devices N       fake an N-device CPU mesh (harness testing without
                        accelerators; perf numbers are then meaningless)
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def bench(nx=2048, ny=512, chunk_len=280, chunks=8,
          warmup=2, precision="f32", mesh_shape=(1, 1), verbose=False,
          reynolds=200.0, repeats=3, nz=0, collision="bgk",
          smagorinsky=0.0, thermal=False, power_law_n=1.0,
          multiphase=False, periodic=False, kolmogorov=False,
          obstacle_bc="equilibrium", zou_he_corners="reference",
          mrt_rates=()):
    import jax
    import numpy as np

    from tpulbm.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()

    from tpulbm.config import SimulationParams, tau_for_reynolds
    from tpulbm.models import make_problem
    from tpulbm.parallel.mesh import make_mesh
    from tpulbm.parallel.sharded_step import (make_chunk_fn,
                                              shard_initial_state)

    if multiphase:
        # Shan-Chen droplet in a channel (psi-stencil collision)
        params = SimulationParams(nx=nx, ny=ny, problem="multiphase",
                                  precision=precision,
                                  mesh_shape=mesh_shape, tau=1.0,
                                  shan_chen_g=-5.0, cylinder_radius=0.15,
                                  cylinder_x=0.5, cylinder_y=0.5,
                                  inlet_velocity=0.0)
    elif thermal:
        # Rayleigh-Benard at Ra=1e4 on an (ny, nx) grid: 14-plane stacked
        # state
        params = SimulationParams(nx=nx, ny=ny, problem="rayleigh-benard",
                                  precision=precision,
                                  mesh_shape=mesh_shape, tau=0.55,
                                  thermal_tau=0.5704, rayleigh=1e4,
                                  periodic_x=True, cylinder_radius=0.0,
                                  inlet_velocity=0.0)
    elif kolmogorov:
        # forced (Kolmogorov) turbulence: periodic box + the spatially
        # varying body force evaluated in-step — the cost of
        # sustained-turbulence production runs. With --nz: 3-D F_x(z)
        # forcing.
        params = SimulationParams(nx=nx, ny=ny, nz=nz, problem="kolmogorov",
                                  precision=precision,
                                  mesh_shape=mesh_shape, tau=0.8,
                                  kolmogorov_n=4, collision=collision,
                                  smagorinsky=smagorinsky,
                                  power_law_n=power_law_n,
                                  inlet_velocity=0.05, periodic_x=True,
                                  cylinder_radius=0.0)
    elif periodic:
        # fully periodic Taylor-Green box: ZERO boundary work (no wall
        # strips, no inlet/outlet algebra, no edge sanitize, no obstacle)
        # — the pure collide-stream ceiling. With --nz: the 3-D TGV.
        params = SimulationParams(nx=nx, ny=ny, nz=nz,
                                  problem="taylor-green",
                                  precision=precision,
                                  mesh_shape=mesh_shape, tau=0.8,
                                  collision=collision,
                                  smagorinsky=smagorinsky,
                                  power_law_n=power_law_n,
                                  inlet_velocity=0.04, periodic_x=True,
                                  cylinder_radius=0.0)
    elif nz:
        # D3Q19 sphere-in-duct at the stable stock parameters (tau=0.6);
        # --obstacle-bc bouzidi uses a fractional radius so the q table
        # carries real cut fractions, not the 0.5 staircase fallback
        params = SimulationParams(nx=nx, ny=ny, nz=nz, problem="cylinder3d",
                                  precision=precision,
                                  mesh_shape=mesh_shape, collision=collision,
                                  smagorinsky=smagorinsky,
                                  power_law_n=power_law_n,
                                  obstacle_bc=obstacle_bc,
                                  **({"cylinder_radius": 0.23,
                                      "cylinder_x": 0.5, "cylinder_y": 0.5}
                                     if obstacle_bc == "bouzidi" else {}),
                                  inlet_velocity=0.05)
    else:
        # the driver metric is at Re=200 (the re200 preset's stable params)
        params = SimulationParams(nx=nx, ny=ny, precision=precision,
                                  mesh_shape=mesh_shape,
                                  inlet_velocity=0.05, collision=collision,
                                  smagorinsky=smagorinsky,
                                  power_law_n=power_law_n,
                                  obstacle_bc=obstacle_bc,
                                  zou_he_corners=zou_he_corners,
                                  mrt_rates=tuple(mrt_rates),
                                  tau=tau_for_reynolds(reynolds, 0.05, ny))
    # reject silently-no-op combinations (e.g. --thermal --power-law, whose
    # thermal branch above never threads power_law_n, or --power-law with
    # --collision trt) so a result never claims physics that didn't run
    from tpulbm.config import validate_params
    if multiphase and (power_law_n != 1.0 or thermal or collision != "bgk"
                       or smagorinsky):
        raise ValueError("--multiphase composes with none of "
                         "--power-law/--thermal/--collision/--smagorinsky")
    if thermal and power_law_n != 1.0:
        raise ValueError("--thermal does not support --power-law "
                         "(power-law rheology is not wired into the "
                         "thermal kernels)")
    if periodic and (multiphase or thermal):
        raise ValueError("--periodic is its own model row; it does not "
                         "compose with --multiphase/--thermal")
    if kolmogorov and (multiphase or thermal or periodic):
        raise ValueError("--kolmogorov is its own model row; it does not "
                         "compose with --multiphase/--thermal/--periodic")
    validate_params(params)
    problem = make_problem(params)
    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    chunk = make_chunk_fn(problem, mesh, chunk_len)
    f, solid = shard_initial_state(problem, mesh)

    for _ in range(warmup):
        f = chunk(f, solid)
    jax.block_until_ready(f)

    steps = chunks * chunk_len
    cells = nx * ny * (nz if nz else 1)
    dts = []
    for r in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(chunks):
            f = chunk(f, solid)
        jax.block_until_ready(f)
        dt = time.perf_counter() - t0
        if verbose:
            print(f"# window {r}: {steps} steps in {dt:.3f}s "
                  f"({cells * steps / dt / 1e6:.0f} MLUPS)", file=sys.stderr)
        dts.append(dt)

    # stability check as an on-device reduction (no full-state fetch)
    import jax.numpy as jnp
    finite = jax.jit(lambda a: jnp.isfinite(a).all())(f)
    if not bool(jax.device_get(finite)):
        raise RuntimeError("the benchmark run went unstable")
    med_dt = float(np.median(dts))
    mlups = cells * steps / med_dt / 1e6
    if verbose:
        grid = f"{nx}x{ny}" + (f"x{nz}" if nz else "")
        print(f"# {chunk.tier} {grid} {precision} mesh {mesh_shape}: median "
              f"{steps} steps in {med_dt:.3f}s → {mlups:.0f} MLUPS",
              file=sys.stderr)
    return mlups, med_dt, steps, chunk.tier


def _parse_mrt_rates(spec):
    """'eps=1.857,e=1.64' → (('eps', 1.857), ('e', 1.64)). See the MRT
    ghost-rate stability note in physics.py: near tau = 1/2 the fixed
    literature e/eps rates amplify the Zou-He corner re-injection loop, so
    the --collision mrt run needs an override to run the Re=200
    defaults (throughput is rate-independent; the override keeps the 2240
    timed steps finite)."""
    if not spec:
        return ()
    return tuple((name.strip(), float(val))
                 for name, _, val in (item.partition("=")
                                      for item in spec.split(",")))


def run_one(args, mesh_shape, nx, ny, label=None):
    import jax
    nz = getattr(args, "nz", 0)
    kw = dict(nx=nx, ny=ny, nz=nz, chunk_len=args.chunk_len,
              chunks=args.chunks, precision=args.precision,
              verbose=args.verbose, mesh_shape=mesh_shape,
              repeats=args.repeats, reynolds=args.reynolds,
              collision=args.collision, smagorinsky=args.smagorinsky,
              thermal=args.thermal, power_law_n=args.power_law,
              multiphase=args.multiphase,
              periodic=getattr(args, "periodic", False),
              obstacle_bc=getattr(args, "obstacle_bc", "equilibrium"),
              zou_he_corners=getattr(args, "zou_he_corners", "reference"),
              mrt_rates=_parse_mrt_rates(getattr(args, "mrt_rates", None)),
              kolmogorov=getattr(args, "kolmogorov", False))
    mlups, dt, steps, tier = bench(**kw)

    n_dev = mesh_shape[0] * mesh_shape[1]
    grid = f"{nx}x{ny}" + (f"x{nz}" if nz else "")
    default_label = (f"MLUPS/device, D3Q19 sphere {grid} {args.precision}"
                     if nz else
                     f"MLUPS/device, D2Q9 cylinder {grid} "
                     f"{args.precision} Re={args.reynolds:g}")
    if args.thermal:
        default_label = (f"MLUPS/device, thermal Rayleigh-Benard Ra=1e4 "
                         f"{grid} {args.precision} (14-plane state)")
    if args.multiphase:
        default_label = (f"MLUPS/device, Shan-Chen multiphase droplet "
                         f"{grid} {args.precision}")
    if getattr(args, "periodic", False):
        default_label = (f"MLUPS/device, periodic Taylor-Green box {grid} "
                         f"{args.precision} (zero boundary work)")
    if getattr(args, "kolmogorov", False):
        default_label = (f"MLUPS/device, Kolmogorov forced turbulence "
                         f"{grid} {args.precision} (in-step force)")
    if args.collision != "bgk":
        default_label += f" {args.collision}"
    if getattr(args, "obstacle_bc", "equilibrium") != "equilibrium":
        default_label += f" obstacle-bc={args.obstacle_bc}"
    if args.smagorinsky:
        default_label += f" les(Cs={args.smagorinsky:g})"
    if args.power_law != 1.0:
        default_label += f" power-law(n={args.power_law:g})"
    dev = jax.devices()[0]
    rec = {
        "metric": label or default_label,
        "value": mlups / n_dev,
        "unit": "MLUPS",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
        "tier": tier,
        "steps": steps,
        "wall_seconds": dt,
        "wall_clock_per_1k_steps_s": dt / steps * 1000,
    }
    if n_dev > 1 or args.mesh or args.sweep:
        rec["mesh"] = f"{mesh_shape[0]}x{mesh_shape[1]}"
        rec["total_mlups"] = mlups
        rec["grid"] = grid
    print(json.dumps(rec))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--nz", type=int, default=0,
                    help="nz > 0 benches the D3Q19 sphere-in-duct problem")
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--chunk-len", type=int, default=280)
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--collision", default="bgk",
                    choices=["bgk", "trt", "mrt", "regularized", "kbc"],
                    help="collision operator")
    ap.add_argument("--obstacle-bc", default="equilibrium",
                    choices=["equilibrium", "bounce_back", "bouzidi"],
                    help="cylinder obstacle BC")
    ap.add_argument("--zou-he-corners", default="reference",
                    choices=["reference", "clean"],
                    help="corner-cell treatment; 'clean' removes the "
                         "corner re-injection loop that destabilizes TRT "
                         "at the Re=200 default tau=0.538 (physics.py)")
    ap.add_argument("--mrt-rates", type=str, default=None,
                    help="MRT ghost-rate overrides 'name=val,...'; "
                         "'eps=1.857' (s_nu at tau=0.538) keeps the "
                         "--collision mrt row finite at Re=200 defaults")
    ap.add_argument("--thermal", action="store_true",
                    help="bench the thermal (Rayleigh-Benard) model "
                         "instead of the cylinder")
    ap.add_argument("--multiphase", action="store_true",
                    help="bench the Shan-Chen multiphase model instead "
                         "of the cylinder")
    ap.add_argument("--kolmogorov", action="store_true",
                    help="bench Kolmogorov forced turbulence (periodic box "
                         "+ spatially varying force)")
    ap.add_argument("--periodic", action="store_true",
                    help="bench the fully periodic Taylor-Green box "
                         "(zero boundary work — pure kernel ceiling)")
    ap.add_argument("--smagorinsky", type=float, default=0.0,
                    help="Smagorinsky Cs (0 = off)")
    ap.add_argument("--power-law", type=float, default=1.0,
                    help="power-law exponent n (1 = Newtonian/off)")
    ap.add_argument("--reynolds", type=float, default=200.0,
                    help="2-D Reynolds number (tau via tau_for_reynolds); "
                         "lower it on small grids where Re=200 BGK is "
                         "unstable (e.g. ny=400 → use 100)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed windows; the median is reported")
    ap.add_argument("--mesh", type=str, default=None,
                    help="device mesh 'MYxMX' (e.g. 4x2)")
    ap.add_argument("--sweep", choices=["weak", "strong"], default=None,
                    help="scaling sweep over device counts; one JSON line "
                         "per point")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="fake an N-device CPU mesh (harness testing)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()

    if args.cpu_devices:
        from tpulbm.utils.hostenv import force_virtual_cpu_devices
        force_virtual_cpu_devices(args.cpu_devices)

    if args.sweep:
        import jax
        n_avail = len(jax.devices())
        d = 1
        counts = []
        while d <= n_avail:
            counts.append(d)
            d *= 2
        lattice = "D3Q19" if args.nz else "D2Q9"
        for n in counts:
            mesh_shape = (n, 1)
            if args.sweep == "weak":
                nx, ny = args.nx, args.ny * n
            else:
                nx, ny = args.nx, args.ny
                if ny % n:
                    print(f"# skipping n={n}: ny={ny} not divisible",
                          file=sys.stderr)
                    continue
            grid = f"{nx}x{ny}" + (f"x{args.nz}" if args.nz else "")
            label = (f"{args.sweep} scaling {n} dev, {lattice} {grid} "
                     f"{args.precision}")
            run_one(args, mesh_shape, nx, ny, label=label)
        return

    mesh_shape = (1, 1)
    if args.mesh:
        my, mx = args.mesh.lower().split("x")
        mesh_shape = (int(my), int(mx))
    run_one(args, mesh_shape, args.nx, args.ny)


if __name__ == "__main__":
    main()
