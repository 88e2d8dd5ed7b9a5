"""Artifact writers: forces.csv, velocity_field.csv, simulation_params.csv,
legacy VTK frames.

Byte-compatible with the reference's formats so its analysis scripts run
unchanged on our outputs (SURVEY §7 "keeping the reference scripts working"):
  * forces.csv header + fixed(8) rows      ← LBMIO.h:38-45, 171-191
  * legacy ASCII VTK STRUCTURED_POINTS     ← LBMIO.h:55-111
  * velocity_field.csv                     ← LBMIO.h:302-325
  * simulation_params.csv                  ← LBMIO.h:327-365
  * time-averaged C_D/C_L summary          ← LBMIO.h:367-413

The hot formatting paths (VTK frames, the 1M-row velocity CSV) dispatch to a
small C++ helper (native/fastio.cpp, loaded via ctypes) when available —
the analog of the reference's native IO layer — with a NumPy
fallback that produces identical bytes.
"""
from __future__ import annotations

import os

import numpy as np

from ..config import SimulationParams
from .native import get_native_io


def _open_series(path: str, header: str, append: bool,
                 resume_step: int | None):
    """Open a streaming timestep-keyed CSV. On resume (`append` with a
    `resume_step`), rows at or after the resume step would be re-recorded
    (duplicate timesteps skew time averages and Strouhal peak spacing) —
    keep only rows strictly before it."""
    if append and os.path.exists(path):
        if resume_step is not None:
            with open(path) as fh:
                lines = fh.readlines()
            kept = [header]
            for ln in lines:
                head = ln.split(",", 1)[0]
                try:
                    ts = int(head)
                except ValueError:
                    continue  # header or corrupt tail line
                if ts < resume_step:
                    kept.append(ln)
            with open(path, "w") as fh:
                fh.writelines(kept)
        return open(path, "a")
    fh = open(path, "w")
    fh.write(header)
    return fh


class ForceWriter:
    """Streaming forces.csv writer (reference IOManager ctor + record_forces,
    LBMIO.h:35-46, 171-191). Flushes every 10000 timesteps like the
    reference (LBMIO.h:188-190)."""

    HEADER = "timestep,drag_force,lift_force,drag_coeff,lift_coeff\n"

    def __init__(self, path: str, append: bool = False,
                 resume_step: int | None = None):
        self.path = path
        self._fh = _open_series(path, self.HEADER, append, resume_step)

    def record(self, timestep: int, fx: float, fy: float,
               cd: float, cl: float) -> None:
        self._fh.write(f"{timestep},{fx:.8f},{fy:.8f},{cd:.8f},{cl:.8f}\n")
        if timestep % 10000 == 0:
            self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ProbeWriter:
    """Streaming probes.csv writer: per output interval, rho and u at each
    configured probe point (params.probe_points; ops/diagnostics.probes_fn).
    Same resume-dedup contract as ForceWriter. New capability — the
    reference has no point probes."""

    def __init__(self, path: str, n_probes: int, ndim: int,
                 thermal: bool = False,
                 append: bool = False, resume_step: int | None = None):
        comps = ("ux", "uy", "uz")[:ndim]
        cols = ["timestep"]
        for k in range(n_probes):
            cols.append(f"p{k}_rho")
            cols.extend(f"p{k}_{c}" for c in comps)
            if thermal:
                cols.append(f"p{k}_T")
        self.path = path
        self._fh = _open_series(path, ",".join(cols) + "\n", append,
                                resume_step)

    def record(self, timestep: int, values) -> None:
        """values: (n_probes, 1 + D) of [rho, u...]."""
        flat = ",".join(f"{float(v):.8f}" for row in values for v in row)
        self._fh.write(f"{timestep},{flat}\n")
        if timestep % 10000 == 0:
            self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class NusseltWriter:
    """Streaming nusselt.csv writer for thermal runs (new capability — no
    reference analog; the Nu(t) trace is the convection analog of
    forces.csv). Same resume-dedup contract as ForceWriter."""

    HEADER = "timestep,nusselt\n"

    def __init__(self, path: str, append: bool = False,
                 resume_step: int | None = None, header: str | None = None,
                 fmt: str = "{:.8f}"):
        # header/fmt: the periodic passive-scalar problems reuse this
        # writer for their scalar-variance trace (scalar_variance.csv)
        self.path = path
        self._fmt = fmt
        self._fh = _open_series(path, header or self.HEADER, append,
                                resume_step)

    def record(self, timestep: int, nu: float) -> None:
        self._fh.write(f"{timestep},{self._fmt.format(nu)}\n")
        if timestep % 10000 == 0:
            self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def write_vtk_timestep(ux: np.ndarray, uy: np.ndarray, rho: np.ndarray,
                       params: SimulationParams, timestep: int,
                       out_dir: str = ".",
                       uz: np.ndarray | None = None,
                       fmt: str = "ascii",
                       temp: np.ndarray | None = None) -> str:
    """Legacy VTK frame, file vtk_output/lbm_%06d.vtk
    (format parity: LBMIO.h:55-111). Arrays are (ny, nx), or (nz, ny, nx)
    with `uz` given — STRUCTURED_POINTS generalizes to nz > 1 with the same
    blocks (C-order ravel = x fastest, the VTK point order).

    `temp` (thermal runs) appends a SCALARS temperature block — additive,
    so isothermal frames stay byte-compatible with the reference.
    fmt="ascii" (default) is byte-compatible with the reference writer;
    fmt="binary" emits the legacy BINARY encoding (big-endian float64 blocks,
    same sections) — ~4x fewer bytes and ~30x faster to format, opt-in
    because it deliberately breaks byte parity with the reference."""
    if fmt not in ("ascii", "binary"):
        raise ValueError(f"unknown vtk format {fmt!r}")
    vtk_dir = os.path.join(out_dir, "vtk_output")
    os.makedirs(vtk_dir, exist_ok=True)
    path = os.path.join(vtk_dir, f"lbm_{timestep:06d}.vtk")
    nx, ny = params.nx, params.ny
    nz = params.nz if uz is not None else 1
    header = (
        "# vtk DataFile Version 3.0\n"
        f"LBM Flow Timestep {timestep}\n"
        f"{'BINARY' if fmt == 'binary' else 'ASCII'}\n"
        "DATASET STRUCTURED_POINTS\n"
        f"DIMENSIONS {nx} {ny} {nz}\n"
        "ORIGIN 0 0 0\n"
        "SPACING 1 1 1\n"
        f"POINT_DATA {nx * ny * nz}\n"
    )
    ux = np.ascontiguousarray(ux, dtype=np.float64)
    uy = np.ascontiguousarray(uy, dtype=np.float64)
    rho = np.ascontiguousarray(rho, dtype=np.float64)
    if fmt == "binary":
        # Legacy binary: raw big-endian doubles after each section header.
        # numpy handles the byteswap+interleave; no native path needed.
        uzb = (np.zeros_like(ux) if uz is None
               else np.ascontiguousarray(uz, dtype=np.float64))
        vec = np.stack([ux.ravel(), uy.ravel(), uzb.ravel()], axis=1)
        mag = np.sqrt(ux * ux + uy * uy + uzb * uzb)
        with open(path, "wb") as fh:
            fh.write(header.encode())
            fh.write(b"VECTORS velocity double\n")
            fh.write(vec.astype(">f8").tobytes())
            fh.write(b"\nSCALARS velocity_magnitude double"
                     b"\nLOOKUP_TABLE default\n")
            fh.write(mag.ravel().astype(">f8").tobytes())
            fh.write(b"\nSCALARS density double\nLOOKUP_TABLE default\n")
            fh.write(rho.ravel().astype(">f8").tobytes())
            if temp is not None:
                fh.write(b"\nSCALARS temperature double"
                         b"\nLOOKUP_TABLE default\n")
                fh.write(np.ascontiguousarray(temp, np.float64)
                         .ravel().astype(">f8").tobytes())
            fh.write(b"\n")
        return path
    native = get_native_io()
    if uz is not None:
        uz = np.ascontiguousarray(uz, dtype=np.float64)
        if native is not None and getattr(native, "_has_vtk3", False):
            native.write_vtk3(path, header, ux, uy, uz, rho)
            return path
        mag = np.sqrt(ux * ux + uy * uy + uz * uz)
        with open(path, "w") as fh:
            fh.write(header)
            fh.write("VECTORS velocity double\n")
            fh.writelines(f"{a:.8f} {b:.8f} {c:.8f}\n" for a, b, c in
                          zip(ux.ravel(), uy.ravel(), uz.ravel()))
            fh.write("\nSCALARS velocity_magnitude double\n"
                     "LOOKUP_TABLE default\n")
            fh.writelines(f"{v:.8f}\n" for v in mag.ravel())
            fh.write("\nSCALARS density double\nLOOKUP_TABLE default\n")
            fh.writelines(f"{v:.8f}\n" for v in rho.ravel())
            _append_temp_ascii(fh, temp)
        return path
    if native is not None:
        native.write_vtk(path, header, ux, uy, rho)
        if temp is not None:
            with open(path, "a") as fh:
                _append_temp_ascii(fh, temp)
        return path
    mag = np.sqrt(ux * ux + uy * uy)
    with open(path, "w") as fh:
        fh.write(header)
        fh.write("VECTORS velocity double\n")
        flat_ux, flat_uy = ux.ravel(), uy.ravel()
        fh.writelines(f"{a:.8f} {b:.8f} 0.0\n" for a, b in zip(flat_ux, flat_uy))
        fh.write("\nSCALARS velocity_magnitude double\nLOOKUP_TABLE default\n")
        fh.writelines(f"{v:.8f}\n" for v in mag.ravel())
        fh.write("\nSCALARS density double\nLOOKUP_TABLE default\n")
        fh.writelines(f"{v:.8f}\n" for v in rho.ravel())
        _append_temp_ascii(fh, temp)
    return path


def _append_temp_ascii(fh, temp) -> None:
    if temp is None:
        return
    temp = np.ascontiguousarray(temp, dtype=np.float64)
    fh.write("\nSCALARS temperature double\nLOOKUP_TABLE default\n")
    fh.writelines(f"{v:.8f}\n" for v in temp.ravel())


def write_velocity_field(ux: np.ndarray, uy: np.ndarray, rho: np.ndarray,
                         params: SimulationParams, out_dir: str = ".") -> str:
    """Final per-cell CSV (format parity: LBMIO.h:302-325)."""
    path = os.path.join(out_dir, "velocity_field.csv")
    ux = np.ascontiguousarray(ux, dtype=np.float64)
    uy = np.ascontiguousarray(uy, dtype=np.float64)
    rho = np.ascontiguousarray(rho, dtype=np.float64)
    native = get_native_io()
    if native is not None:
        native.write_velocity_field(path, ux, uy, rho)
        return path
    ny, nx = ux.shape
    mag = np.sqrt(ux * ux + uy * uy)
    with open(path, "w") as fh:
        fh.write("x,y,ux,uy,rho,velocity_magnitude\n")
        for y in range(ny):
            row_ux, row_uy, row_rho, row_mag = ux[y], uy[y], rho[y], mag[y]
            fh.writelines(
                f"{x},{y},{row_ux[x]:.8f},{row_uy[x]:.8f},{row_rho[x]:.8f},{row_mag[x]:.8f}\n"
                for x in range(nx))
    return path


def write_temperature_field(T: np.ndarray, params: SimulationParams,
                            out_dir: str = ".") -> str:
    """Per-cell temperature CSV for thermal problems (same x,y layout as
    velocity_field.csv; new capability — the reference is isothermal)."""
    path = os.path.join(out_dir, "temperature_field.csv")
    T = np.asarray(T, dtype=np.float64)
    ny, nx = T.shape
    with open(path, "w") as fh:
        fh.write("x,y,temperature\n")
        for y in range(ny):
            row = T[y]
            fh.writelines(f"{x},{y},{row[x]:.8f}\n" for x in range(nx))
    return path


def write_stats_fields(mean_rho: np.ndarray, mean_u: np.ndarray,
                       reynolds_stress: np.ndarray, pair_names: list[str],
                       n_samples: int, first_step: int, interval: int,
                       out_dir: str = ".") -> str:
    """Reynolds-statistics artifact: stats_fields.npz with the time-mean
    fields and the Reynolds-stress tensor components
    <u_i'u_j'> = <u_i u_j> - <u_i><u_j> (upper triangle, keys like
    're_uxuy'), plus the sampling metadata (sample count, first sampled
    timestep, sampling interval) so the file is self-describing — a resume
    that restarts accumulation is visible in n_samples/first_step.
    New capability; the reference has no flow statistics."""
    path = os.path.join(out_dir, "stats_fields.npz")
    out = {"mean_rho": mean_rho, "n_samples": np.int64(n_samples),
           "first_step": np.int64(first_step),
           "sample_interval": np.int64(interval)}
    ax = "xyz"[:mean_u.shape[0]]
    for i, a in enumerate(ax):
        out[f"mean_u{a}"] = mean_u[i]
    for k, name in enumerate(pair_names):
        out[f"re_{name}"] = reynolds_stress[k]
    np.savez(path, **out)
    return path


def write_simulation_params(ux: np.ndarray, uy: np.ndarray,
                            params: SimulationParams, out_dir: str = ".") -> str:
    """Run-record CSV (format parity: LBMIO.h:327-365, including the mixed
    int/fixed(8) formatting and row order)."""
    path = os.path.join(out_dir, "simulation_params.csv")
    mag = np.sqrt(np.asarray(ux, np.float64) ** 2 + np.asarray(uy, np.float64) ** 2)
    max_vel = float(mag.max())
    avg_vel = float(mag.mean())
    p = params
    with open(path, "w") as fh:
        fh.write("parameter,value\n")
        fh.write(f"nx,{p.nx}\n")
        fh.write(f"ny,{p.ny}\n")
        fh.write(f"tau,{p.tau:.8f}\n")
        fh.write(f"nu,{p.nu():.8f}\n")
        fh.write(f"inlet_velocity,{p.inlet_velocity:.8f}\n")
        fh.write(f"num_timesteps,{p.num_timesteps}\n")
        fh.write(f"reynolds_number,{p.reynolds():.8f}\n")
        fh.write(f"cylinder_x,{p.get_cylinder_x()}\n")
        fh.write(f"cylinder_y,{p.get_cylinder_y()}\n")
        fh.write(f"cylinder_radius,{p.get_cylinder_radius_cells()}\n")
        fh.write(f"max_velocity,{max_vel:.8f}\n")
        fh.write(f"avg_velocity,{avg_vel:.8f}\n")
    return path


def calculate_time_averaged_drag(forces_path: str, skip_initial: int = 1000,
                                 verbose: bool = True) -> dict | None:
    """Time-averaged C_D/C_L summary re-read from forces.csv
    (parity: LBMIO.h:367-413, including skipping timestep <= 1000)."""
    try:
        data = np.genfromtxt(forces_path, delimiter=",", names=True)
    except OSError:
        return None
    if data.size == 0:
        return None
    data = np.atleast_1d(data)
    sel = data["timestep"] > skip_initial
    if not sel.any():
        return None
    cd, cl = data["drag_coeff"][sel], data["lift_coeff"][sel]
    stats = {
        "mean_cd": float(cd.mean()), "min_cd": float(cd.min()),
        "max_cd": float(cd.max()),
        "mean_cl": float(cl.mean()), "min_cl": float(cl.min()),
        "max_cl": float(cl.max()), "count": int(sel.sum()),
    }
    if verbose:
        print("\n=== Time-Averaged Force Coefficients ===")
        print(f"  Mean C_D = {stats['mean_cd']:.6f}")
        print(f"  C_D range: [{stats['min_cd']:.6f}, {stats['max_cd']:.6f}]")
        print(f"  Mean C_L = {stats['mean_cl']:.6f}")
        print(f"  C_L range: [{stats['min_cl']:.6f}, {stats['max_cl']:.6f}]")
        print(f"  (Averaged over {stats['count']} samples)")
    return stats
