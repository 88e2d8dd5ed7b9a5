"""Multi-host I/O semantics: real 2-process jax.distributed runs on CPU.

The reference gathers fields to rank 0 over MPI_Gatherv and writes files
there (LBMSolver.h:289-337, LBMIO.h:35-46). Here two OS processes each own
one device of a (2,1) mesh; gathers go through
multihost_utils.process_allgather and process 0 writes forces.csv /
velocity_field.csv / VTK frames / checkpoints. The artifacts must be
byte-identical to the same run executed in one process (the two-phase halo
exchange is exact, so sharded == single in f64).

Each process gets its OWN output directory — simulating hosts without a
shared filesystem — which also exercises the per-shard checkpoint path:
every process persists only its addressable shards plus a manifest, and on
resume process 0 broadcasts only (step, kind) while each process restores
its own shards locally (a divergent decision would desynchronize every
subsequent collective).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

# Every test here launches real OS processes that time-share the host's
# cores — all belong to the slow lane.
pytestmark = [pytest.mark.slow]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import os, sys
    os.environ.pop("XLA_FLAGS", None)
    sys.path.insert(0, __REPO__)
    from tpulbm.utils.hostenv import force_virtual_cpu_devices
    force_virtual_cpu_devices(1)
    import jax
    jax.config.update("jax_enable_x64", True)
    (port, pid, nproc, outdir, steps, resume, my, mx,
     precision, freq) = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         sys.argv[4], int(sys.argv[5]), sys.argv[6] == "1",
                         int(sys.argv[7]), int(sys.argv[8]), sys.argv[9],
                         int(sys.argv[10]))
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                               process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == nproc, jax.devices()
    from tpulbm.config import SimulationParams
    from tpulbm.runner import Runner
    params = SimulationParams(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                              num_timesteps=steps, output_frequency=freq,
                              precision=precision,
                              mesh_shape=(my, mx), output_dir=outdir,
                              enable_vtk=True, checkpoint_every=1)
    res = Runner(params, verbose=False).run(resume=resume)
    assert res.success, "multi-host run went unstable"
""").replace("__REPO__", repr(REPO))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_procs(outdirs, steps, resume, mesh=(2, 1),
               precision="f64", timeout=1800, freq=20):
    # N processes time-share the host's cores; the bound is generous
    # wall-clock headroom, not an expected duration.
    nproc = mesh[0] * mesh[1]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(port), str(pid), str(nproc),
         outdirs[pid], str(steps), "1" if resume else "0",
         str(mesh[0]), str(mesh[1]), precision, str(freq)],
        env=dict(os.environ), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        raise
    for pid, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid} failed:\n{text[-3000:]}"


def test_two_process_run_rank0_artifacts_and_resume(tmp_path):
    out0, out1 = str(tmp_path / "mh0"), str(tmp_path / "mh1")

    # phase A: fresh 40-step run; only process 0's dir receives result
    # artifacts, but checkpoints are PER-SHARD: each process persists its
    # own addressable shards + a (derivable, identical) manifest — the
    # global f is never materialized on any host
    _run_procs((out0, out1), 40, resume=False)
    assert os.path.exists(os.path.join(out0, "forces.csv"))
    assert not os.path.exists(os.path.join(out1, "forces.csv"))
    from tpulbm.utils import checkpoint as ckpt
    l0 = ckpt.latest(os.path.join(out0, "checkpoints"))
    l1 = ckpt.latest(os.path.join(out1, "checkpoints"))
    assert l0 is not None and os.path.isdir(l0)
    assert l1 is not None and os.path.isdir(l1)
    assert sorted(os.listdir(l0)) == ["manifest.json", "proc_00000.npz"]
    assert sorted(os.listdir(l1)) == ["manifest.json", "proc_00001.npz"]

    # phase B: resume to 80 steps; each process restores its own shards
    # from its own filesystem (process 0 broadcasts only (step, kind))
    _run_procs((out0, out1), 80, resume=True)

    # single-process reference on a (2,1) virtual mesh, uninterrupted
    from tpulbm.config import SimulationParams
    from tpulbm.runner import Runner
    import jax
    ref_dir = str(tmp_path / "ref")
    params = SimulationParams(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                              num_timesteps=80, output_frequency=20, precision="f64",
                              mesh_shape=(2, 1), output_dir=ref_dir,
                              enable_vtk=True, checkpoint_every=0)
    res = Runner(params, devices=jax.devices()[:2], verbose=False).run(
        resume=False)
    assert res.success

    for name in ("forces.csv", "velocity_field.csv",
                 "simulation_params.csv", "vtk_output/lbm_000020.vtk",
                 "vtk_output/lbm_000060.vtk"):
        got = open(os.path.join(out0, name), "rb").read()
        ref = open(os.path.join(ref_dir, name), "rb").read()
        assert got == ref, f"{name} differs between 2-process and 1-process"

    # the final checkpoints: manifest step == 80, the two processes' shard
    # files jointly cover the manifest's key→file map, and every shard is
    # finite
    import json
    covered = set()
    for out, proc in ((out0, "proc_00000.npz"), (out1, "proc_00001.npz")):
        latest = ckpt.latest(os.path.join(out, "checkpoints"))
        with open(os.path.join(latest, "manifest.json")) as fh:
            manifest = json.load(fh)
        assert manifest["step"] == 80
        with np.load(os.path.join(latest, proc)) as d:
            for key in d.files:
                assert manifest["files"][key] == proc
                assert np.isfinite(d[key]).all()
                covered.add(key)
    assert covered == set(manifest["files"])


def test_corrupt_checkpoint_fails_cleanly_on_all_processes(tmp_path):
    # a bad checkpoint on process 0 must raise EVERYWHERE (the (step,
    # failed) broadcast), not wedge peers inside broadcast_one_to_all
    out0, out1 = str(tmp_path / "c0"), str(tmp_path / "c1")
    _run_procs((out0, out1), 40, resume=False)
    from tpulbm.utils import checkpoint as ckpt
    latest = ckpt.latest(os.path.join(out0, "checkpoints"))
    with open(os.path.join(latest, "manifest.json"), "w") as fh:
        fh.write("not a manifest")
    with pytest.raises(AssertionError, match="failed"):
        _run_procs((out0, out1), 80, resume=True, timeout=420)

