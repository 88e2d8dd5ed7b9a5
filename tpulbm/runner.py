"""Run orchestration: the equivalent of the reference app layer.

Mirrors main.cpp + Solver::run (src/main.cpp:7-43, LBMSolver.h:43-78):
banners, chunked time stepping, force recording, periodic diagnostics + VTK
frames, the stability abort, and final artifact writing — plus capabilities
the reference lacks: checkpoint/resume, MLUPS accounting, profiler hooks.

Cadence parity (LBMSolver.h:48-76): forces are recorded at every timestep
t ≡ 0 (mod output_frequency) *including t=0* from the post-collision state;
max-velocity prints and VTK frames happen at those t > 0. The per-step
MPI_Allreduce stability sync becomes a per-chunk device-side check (NaN/Inf
persist under LBM arithmetic, so the abort guarantee is unchanged —
SURVEY §7 "hard parts").
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from .config import SimulationParams
from .geometry import solid_cell_count
from .models import make_problem
from .models.base import Problem
from .ops import diagnostics, forces as forces_mod
from .parallel import multihost
from .parallel.mesh import make_mesh
from .parallel.sharded_step import (choose_tier, make_chunk_fn,
                                    make_super_chunk_fn,
                                    shard_initial_state, shard_mask,
                                    shard_state)

# output intervals batched per host round trip when no VTK is needed
_SUPER_K = 8
from .utils import checkpoint as ckpt
from .utils import io as io_mod
from .utils.profiling import ThroughputMeter


@dataclasses.dataclass
class RunResult:
    success: bool
    final_step: int
    mlups: float
    wall_seconds: float
    forces_path: str | None
    stats: dict | None = None


class Runner:
    def __init__(self, params: SimulationParams, devices=None,
                 verbose: bool = True):
        if params.precision == "f64":
            jax.config.update("jax_enable_x64", True)
        self.params = params
        # rank-0 semantics (reference LBMIO.h:35-46, LBMGrid.h:92): banners
        # and files come from process 0 only; collective gathers still run
        # on every process
        self.primary = multihost.is_primary()
        self.verbose = verbose and self.primary
        self.problem: Problem = make_problem(params)
        n_dev = params.mesh_shape[0] * params.mesh_shape[1]
        devices = list(devices if devices is not None else jax.devices())[:n_dev]
        self.mesh = make_mesh(params.mesh_shape, devices=devices)
        self._chunk_cache: dict[int, object] = {}
        self._forces = jax.jit(forces_mod.forces_fn(self.problem)) \
            if self.problem.solid is not None else None
        # bouzidi: the diagnostics force needs the same sharded q table the
        # chunk steppers thread (ops/bouzidi.py); built once per run
        self._bz_q = None
        if (self.problem.obstacle_bc == "bouzidi"
                and self.problem.solid is not None):
            from .ops.bouzidi import link_tables
            from .parallel.sharded_step import shard_mask
            self._bz_q = shard_mask(self.mesh, link_tables(self.problem))
        self._fields = jax.jit(diagnostics.fields_fn(self.problem))
        self._stable = jax.jit(diagnostics.stability_fn(self.problem))
        self._max_vel = jax.jit(diagnostics.max_velocity_fn(self.problem))

        # One fused boundary-diagnostics call per output interval: forces +
        # max-velocity + stability in a single device round trip. The
        # reference pays an MPI_Allreduce EVERY step plus separate force
        # reductions (LBMSolver.h:52-67); host↔device latency makes per-item
        # fetches the analogous tax here.
        forces_fn_ = forces_mod.forces_fn(self.problem) \
            if self.problem.solid is not None else None
        stable_fn_ = diagnostics.stability_fn(self.problem)
        maxv_fn_ = diagnostics.max_velocity_fn(self.problem)

        nu_fn_ = None
        self._temp = None
        if self.problem.thermal is not None:
            from .ops.step_thermal import (nusselt, scalar_variance,
                                           temperature)
            if self.problem.walls_y:
                nu_fn_ = lambda s: nusselt(self.problem, s)  # noqa: E731
            else:
                # periodic passive scalar: the mixing measure rides the
                # Nu diagnostic slot (scalar_variance.csv)
                nu_fn_ = (lambda s:                          # noqa: E731
                          scalar_variance(self.problem, s))
            self._temp = jax.jit(
                lambda s: temperature(self.problem, s))
        pr_fn_ = (diagnostics.probes_fn(self.problem)
                  if params.probe_points else None)
        self._nu_slot = 3 if nu_fn_ is not None else None
        self._probe_slot = ((3 if nu_fn_ is None else 4)
                            if pr_fn_ is not None else None)
        self._n_diag = 3 + (nu_fn_ is not None) + (pr_fn_ is not None)

        def _diag(f, qv=None):
            if forces_fn_ is None:
                force = jnp.zeros(2)
            elif qv is not None:
                force = forces_fn_(f, qv)
            else:
                force = forces_fn_(f)
            out = (force, maxv_fn_(f), stable_fn_(f))
            if nu_fn_ is not None:  # thermal: Nu rides the same round trip
                out = out + (nu_fn_(f),)
            if pr_fn_ is not None:
                out = out + (pr_fn_(f),)
            return out

        self._diag = jax.jit(_diag)
        # Reynolds statistics (--stats-from): on-device accumulators for
        # time-mean fields + Reynolds stresses, sampled at every output
        # interval. The scalar-path updater covers windows the super-chunk
        # fast path doesn't take (short runs, run tails); both sample the
        # same states (t ≡ 0 mod output_frequency, t >= stats_from).
        self._stats_update = None
        if params.stats_from >= 0:
            stats_fn_ = diagnostics.stats_sample_fn(self.problem)

            def _st_update(st, f):
                cnt, s_rho, s_u, s_uu = st
                rho, u, uu = stats_fn_(f)
                one = jnp.asarray(1, s_rho.dtype)
                return (cnt + one, s_rho + rho, s_u + u, s_uu + uu)

            self._stats_update = jax.jit(_st_update, donate_argnums=(0,))
        # Closed-box problems (cavity): on-node wall reflection conserves
        # mass only to O(wall-normal gradients) — measured ~2e-6/step
        # relative drift at Re=100 — and a closed domain has no open BC to
        # absorb it. The LBM step is homogeneous degree-1 in f (collide,
        # stream, reflections, lid term, corner closure are all linear in
        # f at fixed u), so rescaling total mass back to its initial value
        # is an exact gauge operation: u is bit-unaffected, only the
        # arbitrary density scale is pinned (tests/test_cavity.py gates
        # the homogeneity). Applied once per chunk — O(one f pass).
        self._renorm = None
        if self.problem.closed_box:
            m0 = float(np.prod(self.problem.spatial_shape))
            self._renorm = jax.jit(lambda f_: f_ * (m0 / jnp.sum(f_)),
                                   donate_argnums=(0,))
        self._super = {}   # with_fields flag -> jitted super-chunk fn
        os.makedirs(params.output_dir, exist_ok=True)
        # Frame formatting/writing parallelizes across frames (each VTK
        # frame of a 1M-cell grid is ~50 MB of ASCII at ~36 MB/s per core);
        # size the pool to the cores available, min 2 so writes overlap the
        # batched gathers. The pending cap bounds the RAM held by queued
        # frame copies (~13 MB each at the default grid).
        self._io_pool = ThreadPoolExecutor(
            max_workers=max(2, min(8, os.cpu_count() or 1)))
        self._io_futures: list = []
        self._max_pending = 32

    # ---- banners (parity: LBMSolver.h:32-37, LBMGrid.h:92-102, 178-182) ----
    def _print_banner(self):
        p = self.params
        if not self.verbose:
            return
        print("Cylinder Flow LBM Parameters:" if p.problem.startswith("cylinder")
              else f"{p.problem} LBM Parameters:")
        print(f"  Domain: {p.nx}×{p.ny}" + (f"×{p.nz}" if p.is_3d else ""))
        print(f"  tau = {p.tau}, nu = {p.nu()}")
        print(f"  Inlet velocity = {p.inlet_velocity}")
        print(f"  Reynolds number = {p.reynolds()}")
        my, mx = self.mesh.devices.shape
        plat = self.mesh.devices.flat[0].platform
        print(f"  Device mesh: {my}×{mx} ({plat}), local block "
              f"{p.ny // my}×{p.nx // mx}, precision {p.precision}, "
              f"step tier {choose_tier(self.problem, plat)}")
        if self.problem.solid is not None:
            print(f"  Cylinder: center=({p.get_cylinder_x()},{p.get_cylinder_y()}), "
                  f"radius={p.get_cylinder_radius_cells()} cells")
            print(f"  Solid cells: {solid_cell_count(self.problem.solid)}")

    def _chunk_fn(self, length: int):
        if length not in self._chunk_cache:
            self._chunk_cache[length] = make_chunk_fn(
                self.problem, self.mesh, length)
        return self._chunk_cache[length]

    def _drain_io(self):
        """Wait for async VTK writes (formatting a 1M-cell ASCII frame must
        not stall the device; the reference serializes gather+write on the
        critical path, LBMSolver.h:269-362)."""
        for fut in self._io_futures:
            fut.result()
        self._io_futures = []

    def _submit_frame(self, rho, u, t, temp=None):
        """Queue one VTK frame on the writer thread and surface any
        exceptions from already-finished background writes."""
        p = self.params
        uz = u[2] if p.is_3d else None
        self._io_futures.append(self._io_pool.submit(
            io_mod.write_vtk_timestep, u[0], u[1], rho, p, t,
            p.output_dir, uz, p.vtk_format, temp))
        pending = []
        for fut in self._io_futures:
            if fut.done():
                fut.result()  # surface write failures
            else:
                pending.append(fut)
        self._io_futures = pending
        # backpressure: don't hold more than _max_pending frame copies
        while len(self._io_futures) > self._max_pending:
            self._io_futures.pop(0).result()

    def _save_ckpt(self, ckpt_dir: str, t: int, f, stats_dev=None,
                   stats_first=None) -> None:
        """Multi-device runs write per-shard files (every process
        participates; O(local) host RAM — the global f is never
        materialized); single-device runs keep the one-.npz format.
        Reynolds-statistics accumulators ride along so a resumed run
        continues the sample window instead of restarting it."""
        first = -1 if stats_first is None else int(stats_first)
        if self.mesh.devices.size > 1:
            stats = scalars = None
            if stats_dev is not None:
                stats = {"s_rho": stats_dev[1], "s_u": stats_dev[2],
                         "s_uu": stats_dev[3]}
                scalars = {"count": float(jax.device_get(stats_dev[0])),
                           "first": first}
            ckpt.save_sharded(ckpt_dir, t, f, self.params, stats=stats,
                              stats_scalars=scalars)
        else:
            f_host = multihost.fetch_global(f)
            stats = None
            if stats_dev is not None:
                cnt, s_rho, s_u, s_uu = jax.device_get(stats_dev)
                stats = {"count": np.asarray(cnt),
                         "first": np.int64(first),
                         "s_rho": np.asarray(s_rho),
                         "s_u": np.asarray(s_u),
                         "s_uu": np.asarray(s_uu)}
            if self.primary:
                ckpt.save(ckpt_dir, t, f_host, self.params, stats=stats)

    def run(self, resume: bool = True) -> RunResult:
        p = self.params
        problem = self.problem
        self._print_banner()

        t0_wall = time.perf_counter()
        start_step = 0
        f0 = None        # host f (single-.npz checkpoint format)
        f_dev = None     # device-resident sharded f (per-shard format)
        stats_saved = None  # restored statistics accumulators (either fmt)
        ndim = len(problem.spatial_shape)
        if resume and p.checkpoint_every:
            # On resume, process 0 decides and BROADCASTS (step, kind) so
            # processes without a shared filesystem stay in lockstep
            # (divergent start steps would desynchronize every subsequent
            # collective). kind: 0 = fresh, 1 = single .npz (state is
            # broadcast), 2 = per-shard directory (each process loads only
            # its own shards — no broadcast of the Q-sized state).
            load_err = None
            kind = 0
            if self.primary:
                latest = ckpt.latest(os.path.join(p.output_dir,
                                                  p.checkpoint_dir))
                if latest is not None:
                    try:
                        if os.path.isdir(latest):
                            start_step = ckpt.check_manifest(latest, p)
                            kind = 2
                        else:
                            start_step, f0, stats_saved = ckpt.load(
                                latest, p, extras=True)
                            kind = 1
                    except Exception as e:  # defer: peers must hear of it
                        load_err = f"{type(e).__name__}: {e}"
                    if self.verbose and load_err is None:
                        print(f"  Resuming from {latest} at step {start_step}")
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils
                # process 0's load runs before any collective; broadcast a
                # (step, failed, kind) triple so a bad checkpoint raises
                # everywhere instead of wedging peers inside
                # broadcast_one_to_all
                start_step, failed, kind = (
                    int(v) for v in multihost_utils.broadcast_one_to_all(
                        np.array([start_step, load_err is not None, kind],
                                 np.int64)))
                if failed:
                    raise RuntimeError(
                        "checkpoint load failed on process 0"
                        + (f" ({load_err})" if load_err else ""))
                if kind == 1 and start_step > 0:
                    if f0 is None:  # non-primary: placeholder of known shape
                        f0 = np.zeros(
                            (problem.state_q,) + problem.spatial_shape,
                            problem.dtype)
                    f0 = np.asarray(multihost_utils.broadcast_one_to_all(f0))
            elif load_err is not None:
                raise RuntimeError(f"checkpoint load failed ({load_err})")
            if kind == 2:
                from jax.sharding import PartitionSpec as P
                path = os.path.join(p.output_dir, p.checkpoint_dir,
                                    f"ckpt_{start_step:09d}")
                spec = P(*((None,) + (None,) * (ndim - 2) + ("y", "x")))
                # params were validated on process 0 (check_manifest +
                # broadcast); per-process re-checks could raise on only
                # some processes and desynchronize the collectives
                _, f_dev, stats_saved = ckpt.load_sharded(
                    path, self.mesh, spec, extras=True)
        solid = problem.solid if problem.solid is not None else \
            np.zeros(problem.spatial_shape, bool)
        if f_dev is not None:
            f = f_dev
            solid_dev = shard_mask(self.mesh, solid)
        elif f0 is None:
            # fresh start: build f on device (only the Q-free solid mask is
            # transferred — the Q-sized f costs minutes over a slow host
            # link at 3-D sizes)
            f, solid_dev = shard_initial_state(problem, self.mesh)
            if solid_dev is None:  # solid-free problem: keep a zeros mask
                solid_dev = shard_mask(self.mesh, solid)
        else:
            f, solid_dev = shard_state(self.mesh, f0, solid)

        stats_dev = None
        stats_first = None      # first timestep actually sampled
        if p.stats_from >= 0:
            dt_ = self.problem.dtype
            sp = self.problem.spatial_shape
            D = self.problem.lattice.D
            if stats_saved is not None and "s_rho" in stats_saved:
                # continue the checkpointed sample window: sharded restores
                # arrive as correctly-placed device arrays, single-.npz
                # restores as host arrays to re-shard
                def _place(a):
                    import numpy as _np
                    return (shard_mask(self.mesh, jnp.asarray(a, dt_))
                            if isinstance(a, _np.ndarray) else a)
                stats_dev = (jnp.asarray(float(stats_saved["count"]), dt_),
                             _place(stats_saved["s_rho"]),
                             _place(stats_saved["s_u"]),
                             _place(stats_saved["s_uu"]))
                first = int(stats_saved.get("first", -1))
                stats_first = None if first < 0 else first
                if self.verbose:
                    print(f"  Resuming statistics accumulation "
                          f"({int(float(stats_saved['count']))} samples "
                          f"so far)")
            else:
                stats_dev = (
                    jnp.zeros((), dt_),
                    shard_mask(self.mesh, jnp.zeros(sp, dt_)),
                    shard_mask(self.mesh, jnp.zeros((D,) + sp, dt_)),
                    shard_mask(self.mesh,
                               jnp.zeros((D * (D + 1) // 2,) + sp, dt_)))
                if start_step > p.stats_from and self.verbose:
                    print(f"  NOTE: resuming at step {start_step} with no "
                          f"saved statistics accumulators (pre-statistics "
                          f"checkpoint); accumulation starts fresh here")

        force_writer = None
        forces_path = None
        if self._forces is not None:
            forces_path = os.path.join(p.output_dir, "forces.csv")
            if self.primary:
                force_writer = io_mod.ForceWriter(forces_path,
                                                  append=start_step > 0,
                                                  resume_step=start_step)
        nu_writer = None
        if self.problem.thermal is not None and self.primary:
            if self.problem.walls_y:
                nu_writer = io_mod.NusseltWriter(
                    os.path.join(p.output_dir, "nusselt.csv"),
                    append=start_step > 0, resume_step=start_step)
            else:
                nu_writer = io_mod.NusseltWriter(
                    os.path.join(p.output_dir, "scalar_variance.csv"),
                    append=start_step > 0, resume_step=start_step,
                    header="timestep,scalar_variance\n", fmt="{:.8e}")
        probe_writer = None
        if self._probe_slot is not None and self.primary:
            probe_writer = io_mod.ProbeWriter(
                os.path.join(p.output_dir, "probes.csv"),
                n_probes=len(p.probe_points),
                ndim=3 if p.is_3d else 2,
                thermal=self.problem.thermal is not None,
                append=start_step > 0, resume_step=start_step)

        meter = ThroughputMeter(p.num_cells)
        if self.verbose:
            print("Starting LBM simulation...")

        t = start_step
        success = True
        freq = p.output_frequency
        ckpt_dir = os.path.join(p.output_dir, p.checkpoint_dir)
        chunks_done = 0
        last_ckpt = 0
        # The reference's final fields are the macroscopic values stored
        # during the LAST collision (moments of the state before the final
        # step) with the final step's BC overrides at the inlet/outlet
        # columns (LBMSolver.h:111-114, 203-234; LBMIO.h:194-219). To
        # reproduce its velocity_field.csv exactly we stop one step short,
        # snapshot the fields, then advance the last step.
        t_fields = max(p.num_timesteps - 1, start_step)
        fields_prev = None
        try:
            with meter.measure(p.num_timesteps - start_step):
                while t < p.num_timesteps:
                    # Fast path: batch _SUPER_K output intervals into ONE
                    # host round trip — the per-interval diagnostics
                    # (forces/max-vel/stability) are computed on device
                    # inside the scan and fetched as a stack, so a long run
                    # pays one host synchronization per _SUPER_K intervals.
                    # When VTK frames are due, the same scan also stacks the
                    # per-interval macroscopic fields, so frames cost one
                    # batched gather per _SUPER_K frames with the ASCII
                    # formatting on the writer thread — no per-frame device
                    # stall (the reference serializes gather+format+write
                    # every frame, LBMSolver.h:269-362).
                    # fields are materialized+gathered only when the window
                    # actually contains a frame: the last frame of this
                    # window lands at t + (K-1)*freq
                    vtk_window = (p.enable_vtk
                                  and t + (_SUPER_K - 1) * freq
                                  >= p.vtk_start_step)
                    if t % freq == 0 and t + _SUPER_K * freq <= t_fields:
                        if vtk_window not in self._super:
                            self._super[vtk_window] = make_super_chunk_fn(
                                problem, self.mesh, freq, _SUPER_K,
                                with_fields=vtk_window,
                                with_stats=stats_dev is not None)
                        if stats_dev is not None:
                            # skip the leading intervals of this window that
                            # precede stats_from (traced scalar: no recompile)
                            j_skip = min(
                                max(0, -((t - p.stats_from) // freq)),
                                _SUPER_K)
                            (f, stats_dev), diags = self._super[vtk_window](
                                f, stats_dev, np.int32(j_skip), solid_dev)
                            if stats_first is None and j_skip < _SUPER_K:
                                stats_first = t + j_skip * freq
                        else:
                            f, diags = self._super[vtk_window](f, solid_dev)
                        if self._renorm is not None:
                            f = self._renorm(f)
                        # per-interval scalars are replicated → addressable
                        # from every process, no collective gather needed
                        scalars = jax.device_get(diags[:self._n_diag])
                        forces_k, maxv_k, stable_k = scalars[:3]
                        nu_k = (scalars[self._nu_slot]
                                if self._nu_slot is not None else None)
                        probes_k = (scalars[self._probe_slot]
                                    if self._probe_slot is not None else None)
                        rho_k = u_k = temp_k = None
                        if vtk_window:
                            # one collective gather for all K frames
                            rho_k, u_k, *rest = multihost.fetch_tree(
                                diags[self._n_diag:])
                            temp_k = rest[0] if rest else None
                        aborted = False
                        for j in range(_SUPER_K):
                            tj = t + j * freq
                            if force_writer is not None:
                                fv = np.asarray(forces_k[j])
                                cd, cl = forces_mod.force_coefficients(
                                    problem, fv)
                                force_writer.record(tj, float(fv[0]),
                                                    float(fv[1]), cd, cl)
                            if nu_writer is not None:
                                nu_writer.record(tj, float(nu_k[j]))
                            if probe_writer is not None:
                                probe_writer.record(tj,
                                                    np.asarray(probes_k[j]))
                            if tj > 0 and self.verbose:
                                print(f"Timestep {tj}: "
                                      f"max_vel={float(maxv_k[j]):.6f}")
                            if (vtk_window and tj > 0
                                    and tj >= p.vtk_start_step
                                    and self.primary):
                                # np.array COPIES the per-frame slice — a
                                # view would pin the whole K-frame window
                                # stack in RAM while writes drain
                                self._submit_frame(
                                    np.array(rho_k[j]), np.array(u_k[j]), tj,
                                    None if temp_k is None
                                    else np.array(temp_k[j]))
                            if not bool(stable_k[j]):
                                print(f"Simulation unstable at timestep {tj}")
                                success = False
                                aborted = True
                                break
                        if aborted:
                            break
                        t += _SUPER_K * freq
                        chunks_done += _SUPER_K
                        if (p.checkpoint_every and
                                chunks_done - last_ckpt >= p.checkpoint_every):
                            self._save_ckpt(ckpt_dir, t, f, stats_dev, stats_first)
                            last_ckpt = chunks_done
                        continue

                    # One fused diagnostics round trip per output interval
                    # (forces + max-vel + stability) replaces the reference's
                    # per-step MPI_Allreduce plus separate force reductions
                    # (LBMSolver.h:52-67). Fetched before the next chunk is
                    # dispatched, so the chunk that donates f never runs
                    # while the diagnostics still read it; the heavy ASCII
                    # formatting is still pushed off-thread.
                    if t % freq == 0:
                        if stats_dev is not None and t >= p.stats_from:
                            stats_dev = self._stats_update(stats_dev, f)
                            if stats_first is None:
                                stats_first = t
                        dv = jax.device_get(self._diag(f, self._bz_q))
                        fvec, mv, stable = dv[:3]
                        if nu_writer is not None:
                            nu_writer.record(t, float(dv[self._nu_slot]))
                        if probe_writer is not None:
                            probe_writer.record(
                                t, np.asarray(dv[self._probe_slot]))
                        frame = None
                        if t > 0 and p.enable_vtk and t >= p.vtk_start_step:
                            # collective on multi-host — every process joins
                            rho_f, u_f = multihost.fetch_tree(self._fields(f))
                            t_f = None if self._temp is None else \
                                np.asarray(multihost.fetch_global(
                                    self._temp(f)))
                            frame = (np.asarray(rho_f), np.asarray(u_f), t_f)
                        if force_writer is not None:
                            fvec = np.asarray(fvec)
                            cd, cl = forces_mod.force_coefficients(problem, fvec)
                            force_writer.record(t, float(fvec[0]),
                                                float(fvec[1]), cd, cl)
                        if t > 0:
                            if self.verbose:
                                print(f"Timestep {t}: max_vel={float(mv):.6f}")
                            if frame is not None and self.primary:
                                self._submit_frame(frame[0], frame[1], t,
                                                   frame[2])
                        if not bool(stable):
                            print(f"Simulation unstable at timestep {t}")
                            success = False
                            break

                    n = min(freq - (t % freq), p.num_timesteps - t)
                    if t < t_fields:
                        n = min(n, t_fields - t)
                    elif t == t_fields:
                        rho_p, u_p = multihost.fetch_tree(self._fields(f))
                        fields_prev = (np.array(rho_p), np.array(u_p))
                    chunk = self._chunk_fn(n)
                    f = chunk(f, solid_dev)
                    if self._renorm is not None:
                        f = self._renorm(f)
                    t += n
                    chunks_done += 1

                    if (p.checkpoint_every and
                            chunks_done - last_ckpt >= p.checkpoint_every):
                        self._save_ckpt(ckpt_dir, t, f, stats_dev, stats_first)
                        last_ckpt = chunks_done

                # final fence + stability check of the end state
                if success and not bool(jax.device_get(self._stable(f))):
                    print(f"Simulation unstable at timestep {t}")
                    success = False
        finally:
            if force_writer is not None:
                force_writer.close()
            if nu_writer is not None:
                nu_writer.close()
            if probe_writer is not None:
                probe_writer.close()
            self._drain_io()

        if success and stats_dev is not None:
            # collective (fetch_tree) — every process participates
            self._write_stats(stats_dev, stats_first)
        stats = None
        if success:
            stats = self.write_final_results(f, fields_prev)
        wall = time.perf_counter() - t0_wall
        if self.verbose:
            print(f"\nThroughput: {meter.mlups:.1f} MLUPS over "
                  f"{meter.steps} steps ({wall:.1f}s wall total)")
        return RunResult(success, t, meter.mlups, wall, forces_path, stats)

    def _write_stats(self, stats_dev, stats_first) -> None:
        """Finalize the Reynolds statistics: means and stresses computed ON
        DEVICE from the accumulated sums (one small jit), gathered once, and
        written by process 0 as stats_fields.npz."""
        p = self.params
        n = float(jax.device_get(stats_dev[0]))
        if n < 1:
            if self.verbose:
                print("Reynolds statistics: no samples taken "
                      "(stats_from past the sampled window); skipping")
            return
        D = self.problem.lattice.D
        pairs = [(i, j) for i in range(D) for j in range(i, D)]

        def fin(cnt, s_rho, s_u, s_uu):
            mrho = s_rho / cnt
            mu = s_u / cnt
            re = s_uu / cnt - jnp.stack([mu[i] * mu[j] for i, j in pairs])
            return mrho, mu, re

        mrho, mu, re = multihost.fetch_tree(jax.jit(fin)(*stats_dev))
        if not self.primary:
            return
        path = io_mod.write_stats_fields(
            np.asarray(mrho), np.asarray(mu), np.asarray(re),
            diagnostics.stats_pair_names(D), int(n),
            stats_first if stats_first is not None else -1,
            p.output_frequency, p.output_dir)
        if self.verbose:
            print(f"Reynolds statistics: {int(n)} samples -> {path}")

    def write_final_results(self, f, fields_prev=None) -> dict | None:
        """Final artifacts (parity: IOManager::write_final_results,
        LBMIO.h:194-219). With `fields_prev` (the pre-final-step fields),
        reproduces the reference's reporting exactly: interior values from
        the last collision, inlet/outlet columns from the final BC
        application (see run())."""
        p = self.params
        if self.verbose:
            print("\nGathering final results...")
        rho, u = multihost.fetch_tree(self._fields(f))
        rho = np.asarray(rho)
        u = np.asarray(u)
        if fields_prev is not None:
            rho_prev, u_prev = fields_prev
            edge_cols = []
            if self.problem.inlet_zou_he or self.problem.inlet_equilibrium:
                edge_cols.append(0)
            if self.problem.outlet_zou_he or self.problem.outlet_zero_grad:
                edge_cols.append(p.nx - 1)
            for col in edge_cols:
                rho_prev[..., col] = rho[..., col]
                u_prev[..., col] = u[..., col]
            rho, u = rho_prev, u_prev
        stats = None
        if not self.primary:      # rank-0 file semantics (LBMIO.h:35-46)
            return None
        if not p.is_3d:
            io_mod.write_velocity_field(u[0], u[1], rho, p, p.output_dir)
            io_mod.write_simulation_params(u[0], u[1], p, p.output_dir)
            extra = ""
            if self.problem.thermal is not None:
                th = self.problem.thermal
                T = np.asarray(multihost.fetch_global(self._temp(f)))
                io_mod.write_temperature_field(T, p, p.output_dir)
                extra = ", temperature_field.csv"
                if self.problem.walls_y:
                    from .models.rayleigh_benard import effective_height
                    # Nu from the already-gathered host fields (multi-
                    # process safe — no eager op on a non-addressable
                    # sharded array)
                    nu = 1.0 + (np.mean(u[1] * T) * effective_height(p)
                                / (th.alpha * (th.t_bottom - th.t_top)))
                    stats = {"nusselt": float(nu)}
                    if self.verbose:
                        print(f"Nusselt number = {nu:.4f}")
                else:
                    var = float(np.mean((T - T.mean()) ** 2))
                    stats = {"scalar_variance": var}
                    if self.verbose:
                        print(f"Scalar variance = {var:.6e}")
            if self.problem.solid is not None:
                stats = io_mod.calculate_time_averaged_drag(
                    os.path.join(p.output_dir, "forces.csv"),
                    verbose=self.verbose)
            if self.verbose:
                print("Files written: velocity_field.csv, simulation_params.csv, "
                      f"forces.csv{extra}")
        else:
            np.savez(os.path.join(p.output_dir, "fields3d.npz"),
                     rho=rho, ux=u[0], uy=u[1], uz=u[2],
                     params=np.frombuffer(p.to_json().encode(), np.uint8))
            if p.enable_vtk:
                # final ParaView-loadable STRUCTURED_POINTS frame (nz > 1)
                io_mod.write_vtk_timestep(u[0], u[1], rho, p,
                                          p.num_timesteps, p.output_dir,
                                          uz=u[2], fmt=p.vtk_format)
            if self.verbose:
                print("Files written: fields3d.npz"
                      + (", vtk_output/ (final frame)" if p.enable_vtk
                         else ""))
        return stats
