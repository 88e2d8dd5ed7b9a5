"""Problem definition: lattice + geometry + boundary-condition layout.

The reference hard-codes one problem (cylinder in a channel) across
LBMGrid/LBMSolver; here a `Problem` bundles everything the step kernels need,
so cylinder / Poiseuille / 3-D flows share one engine (SURVEY §2 C2, §7).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SimulationParams
from ..lattice import Lattice
from .. import physics


@dataclasses.dataclass(frozen=True)
class ThermalConfig:
    """Double-population thermal coupling (Boussinesq). A second lattice
    (D2Q5) carries temperature as a passive scalar advected by the flow;
    the flow feels buoyancy F_y = buoyancy · (T − t_ref). New capability —
    the reference is strictly isothermal.

    State layout: the scalar populations g are STACKED under the flow
    populations f in one (Q_f + Q_g, ny, nx) array, so every piece of
    streaming/sharding/halo machinery (which is shape-generic) carries
    over unchanged; only collision and the wall BCs treat the two plane
    groups differently.
    """
    lattice: Lattice          # the scalar's lattice (D2Q5)
    tau_g: float              # thermal relaxation time; alpha = (tau_g-1/2)/3
    t_bottom: float = 1.0     # fixed wall temperatures (hot plate below)
    t_top: float = 0.0
    buoyancy: float = 0.0     # beta·g product (Boussinesq)
    perturb: float = 1e-3     # deterministic seed-mode amplitude (×ΔT)
    # Buoyancy axis: 1 = +y (Rayleigh-Bénard — gravity opposes the wall
    # gradient) or 0 = +x (side-heated cavity: the Dirichlet walls still
    # sit in y, but gravity is PERPENDICULAR to the gradient; the domain
    # is then wall-bounded in x too — adiabatic, no-slip — instead of
    # periodic; de Vahl Davis (1983) benchmark geometry, rotated so the
    # existing Dirichlet machinery carries over unchanged)
    buoyancy_axis: int = 1

    @property
    def t_ref(self) -> float:
        return 0.5 * (self.t_bottom + self.t_top)

    @property
    def alpha(self) -> float:
        """Thermal diffusivity in lattice units."""
        return (self.tau_g - 0.5) / 3.0


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static description of one simulation setup.

    Masks are host NumPy (they are compile-time constants for the kernels);
    `solid` may be None when there is no obstacle.
    """

    params: SimulationParams
    lattice: Lattice
    solid: np.ndarray | None          # bool, (*spatial) in (…, ny, nx) order
    init_rho: float = 1.0
    init_u: tuple[float, ...] = (0.0, 0.0)
    # Boundary-condition layout
    inlet_zou_he: bool = False        # Zou-He velocity inlet at x=0 (LBMSolver.h:179-207)
    outlet_zou_he: bool = False       # Zou-He pressure outlet at x=nx-1 (LBMSolver.h:210-236)
    inlet_equilibrium: bool = False   # simple equilibrium inlet (3-D model)
    outlet_zero_grad: bool = False    # zero-gradient outlet (3-D model)
    walls_y: bool = True              # bounce-back walls at y extremes (LBMSolver.h:153-176)
    walls_z: bool = False
    walls_x: bool = False             # bounce-back walls at x extremes (cavity)
    lid_u: float = 0.0                # moving-lid speed (+x) at the top wall (cavity)
    closed_box: bool = False          # no open BCs: runner renormalizes total mass
    periodic_x: bool = False
    periodic_y: bool = False          # fully periodic box (Taylor-Green,
    # shear layer); requires walls_y=False and periodic_x
    periodic_z: bool = False          # 3-D fully periodic box (walls_z off)
    body_force: tuple[float, ...] = ()
    # Spatially varying body force: a callable taking the coords dict from
    # ops/step_jax._coords (global integer index arrays broadcastable over
    # the local block, plus nx/ny[/nz]) and returning a (D,)-tuple of
    # broadcastable force components. Evaluated IN-STEP from global
    # coordinates — zero memory, no threading, shards for free — so it
    # must be analytic and box-periodic along periodic axes (halo cells
    # evaluate it at out-of-range indices like -1 / n, where periodicity
    # makes the wrap automatic). Kolmogorov forcing (models/periodic2d.py).
    # The GPU kernel tier does not cover it (ops/step_triton.covers).
    force_fn: object = None
    obstacle_bc: str = "equilibrium"  # see ops/step_jax.py for semantics
    # analytic signed distance to the obstacle surface (positive in fluid),
    # pts (..., D) in (x, y[, z]) coords -> (...,); required by the
    # "bouzidi" curved-wall mode (ops/bouzidi.py), ignored otherwise
    obstacle_sdf: object = None
    # wall velocity field for MOVING obstacles (rotating cylinder):
    # pts (..., D) -> u (..., D); bouzidi mode only (ops/bouzidi.py)
    obstacle_velocity: object = None
    collision: str = "bgk"            # "bgk" | "trt" | "mrt" (physics.collide_*)
    clean_corners: bool = False       # Zou-He corner closure (2-D; opt-in)
    trt_magic: float = 3.0 / 16.0
    mrt_rates: tuple = ()             # ((moment, rate), ...) ghost overrides
    smagorinsky: float = 0.0          # LES constant Cs (physics.smagorinsky_inv_tau)
    power_law: tuple = ()             # (k, n) rheology (physics.power_law_inv_tau)
    shan_chen: tuple = ()             # (g, rho0) multiphase (ops/step_multiphase.py)
    init_rho_map: np.ndarray | None = None  # spatially varying initial rho (u = 0)
    # general (rho(x), u(x)) initial condition -> equilibrium init
    # (Taylor-Green / shear-layer); overrides init_rho/init_u/init_rho_map
    init_fields: tuple | None = None  # (rho (*spatial), u (D, *spatial))
    thermal: ThermalConfig | None = None  # double-population thermal coupling
    # Initial scalar field T(*spatial) for thermal problems using
    # init_fields (passive-scalar transport); None → the conductive
    # wall-profile default of initial_state.
    init_T: object = None

    @property
    def state_q(self) -> int:
        """Leading (plane) extent of the state array: Q_f, plus Q_g when a
        thermal scalar is stacked underneath (see ThermalConfig)."""
        return self.lattice.Q + (self.thermal.lattice.Q if self.thermal
                                 else 0)

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        p = self.params
        return (p.nz, p.ny, p.nx) if p.is_3d else (p.ny, p.nx)

    @property
    def dtype(self):
        return np.float64 if self.params.precision == "f64" else np.float32

    def ghost_ring_values(self) -> np.ndarray:
        """(Q,) per-direction values held by out-of-domain ghost cells.

        Parity: the reference initializes ghost cells to equilibrium(rho=1,
        u=inlet) and never updates them at physical domain edges
        (LBMGrid.h:185-213), so streaming at domain edges pulls these frozen
        constants forever. We reproduce that as the padded ring / sanitize
        values.
        """
        ring = physics.uniform_equilibrium(
            self.lattice, self.init_rho, self.init_u, dtype=self.dtype)
        if self.thermal is not None:
            # placeholder ring for the stacked scalar planes (the thermal
            # padded step overwrites the physical y rims with the correct
            # per-wall values in-step; x is periodic for thermal models)
            ring = np.concatenate(
                [ring, (self.thermal.lattice.w
                        * self.thermal.t_ref).astype(self.dtype)])
        return ring

    def initial_state(self) -> np.ndarray:
        """(state_q, *spatial) initial populations: uniform
        equilibrium(1, init_u), with solid cells at rest equilibrium
        (parity: LBMGrid.h:185-246). Thermal problems stack the scalar's
        equilibrium at the conductive profile plus a deterministic
        seed-mode perturbation underneath (see ThermalConfig)."""
        Q = self.lattice.Q
        if self.init_fields is not None:
            # general (rho(x), u(x)) equilibrium initialization — pure
            # NumPy (host-side; a jnp version would cost a device compile
            # just to build f0)
            rho0, u0 = self.init_fields
            rho0 = np.asarray(rho0, np.float64)
            u0 = np.asarray(u0, np.float64)
            c = self.lattice.c.astype(np.float64)          # (Q, D)
            w = self.lattice.w.astype(np.float64)
            cu = np.tensordot(c, u0, axes=(1, 0))          # (Q, *spatial)
            u2 = np.sum(u0 * u0, axis=0)
            wq = w.reshape((Q,) + (1,) * u2.ndim)
            f = wq * rho0[None] * (1.0 + 3.0 * cu + 4.5 * cu * cu
                                   - 1.5 * u2[None])
            if self.thermal is not None:
                # stack the scalar at its advection-diffusion equilibrium
                # g_eq_i = w_i T (1 + 3 c_i·u) (physics.thermal_equilibrium
                # algebra, NumPy-side) — passive-scalar problems supply
                # init_T; default: uniform t_ref
                th = self.thermal
                lg = th.lattice
                T = (np.full(self.spatial_shape, th.t_ref, np.float64)
                     if self.init_T is None
                     else np.asarray(self.init_T, np.float64))
                cg = lg.c.astype(np.float64)
                cu_g = np.tensordot(cg, u0, axes=(1, 0))   # (Qg, *spatial)
                wg = lg.w.reshape((lg.Q,) + (1,) * T.ndim)
                g = wg * T[None] * (1.0 + 3.0 * cu_g)
                f = np.concatenate([f, g], axis=0)
            return f.astype(self.dtype)
        if self.init_rho_map is not None:
            # spatially varying rho at u = 0: feq_i = w_i rho (multiphase
            # droplet / band initialization)
            w = self.lattice.w.astype(self.dtype)
            f = (w.reshape((Q,) + (1,) * len(self.spatial_shape))
                 * np.asarray(self.init_rho_map, self.dtype)[None])
            return np.ascontiguousarray(f)
        feq = self.ghost_ring_values()[:Q]
        f = np.broadcast_to(
            feq.reshape((Q,) + (1,) * len(self.spatial_shape)),
            (Q,) + self.spatial_shape).copy()
        if self.solid is not None:
            rest = physics.rest_equilibrium(self.lattice, self.dtype)
            f[:, self.solid] = rest[:, None]
        if self.thermal is None:
            return f
        th = self.thermal
        ny, nx = self.spatial_shape
        # conductive profile between the wall NODES (height ny-1 cells),
        # seeded with one cos(kx)·sin(pi y/H) mode at amplitude
        # perturb·ΔT so the onset is deterministic and mesh-independent
        y = np.arange(ny, dtype=np.float64)[:, None] / max(ny - 1, 1)
        x = np.arange(nx, dtype=np.float64)[None, :]
        dt_wall = th.t_bottom - th.t_top
        T = th.t_bottom - dt_wall * y
        T = T + th.perturb * dt_wall * np.cos(2.0 * np.pi * x / nx) \
            * np.sin(np.pi * y)
        lg = th.lattice
        g = (lg.w.reshape((lg.Q, 1, 1)) * T[None]).astype(self.dtype)
        return np.concatenate([f, g], axis=0)
