#!/usr/bin/env python
"""CLI entry point — the equivalent of the reference's main.cpp
(src/main.cpp:7-43), with an actual flag system (the reference ignores argv;
changing anything required editing LBMConfig.h and recompiling).

Examples:
    python main.py --preset cylinder-small --no-vtk
    python main.py --preset re200 --mesh auto
    python main.py --preset poiseuille
    python main.py --nx 1024 --ny 256 --reynolds 100 --num-timesteps 20000
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="tpulbm — Lattice Boltzmann solver on JAX")
    from tpulbm.config import add_cli_args
    add_cli_args(parser)
    parser.add_argument("--cpu", action="store_true",
                        help="force CPU backend (debug)")
    parser.add_argument("--cpu-devices", type=int, default=0,
                        help="with --cpu: number of virtual host devices")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a jax.profiler trace here")
    parser.add_argument("--no-resume", action="store_true",
                        help="ignore existing checkpoints")
    parser.add_argument("--distributed", action="store_true",
                        help="call jax.distributed.initialize() for "
                             "multi-host runs (the MPI_Init analog, "
                             "reference src/main.cpp:8)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from tpulbm.utils.hostenv import add_host_device_count_flag, \
        use_cpu_platform
    if args.cpu_devices:
        add_host_device_count_flag(args.cpu_devices)
    import jax
    from tpulbm.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    if args.cpu:
        use_cpu_platform()
    if args.distributed:
        jax.distributed.initialize()

    from tpulbm.config import params_from_args
    from tpulbm.parallel.mesh import choose_decomposition
    from tpulbm.runner import Runner
    from tpulbm.utils.profiling import trace

    params = params_from_args(args)
    if args.mesh == "auto":
        # the reference's surface-minimizing chooser (LBMGrid.h:366-392)
        params = params.replace(mesh_shape=choose_decomposition(
            len(jax.devices()), params.nx, params.ny))

    runner = Runner(params)
    with trace(args.profile_dir):
        result = runner.run(resume=not args.no_resume)
    return 0 if result.success else 1


if __name__ == "__main__":
    sys.exit(main())
